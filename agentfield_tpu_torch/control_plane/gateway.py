"""Execution gateway: sync + async invocation of node components.

Reimplements the semantics of the reference's execution controller
(internal/handlers/execute.go): prepare → call agent → 200-direct or
202-ack + status-callback completion; async path through a bounded worker
pool with queue-full backpressure (execute.go:319-367,1302-1439). asyncio
replaces the Go worker goroutines: completion handling is naturally
serialized on the event loop (the reference dedicates a single completion
goroutine for the same reason, execute.go:1404-1429).

Agent wire contract (network boundary):
    POST {base_url}/{reasoners|skills}/{component}  json={"input": ..., "execution_id": ...}
    headers: X-Run-ID, X-Execution-ID, X-Parent-Execution-ID, X-Session-ID, X-Actor-ID
    → 200 {"result": ...}      direct completion
    → 202 {}                   agent later POSTs /api/v1/executions/{id}/status
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import math
import os
import random
import time
from typing import Any

from agentfield_tpu_torch.control_plane import http

from agentfield_tpu_torch import tracing
from agentfield_tpu_torch.branching import validate_branch_spec
from agentfield_tpu_torch.prefix_hash import page_chain_hashes, sketch_digest

from agentfield_tpu_torch.control_plane import faults
from agentfield_tpu_torch.control_plane.dag import infer_expect_followup
from agentfield_tpu_torch.control_plane.channel import (
    ChannelManager,
    ChannelUnavailable,
    ExecutionStreams,
    StreamSubscription,
)
from agentfield_tpu_torch.control_plane.events import EventBus
from agentfield_tpu_torch.control_plane.metrics import Metrics
from agentfield_tpu_torch.control_plane.storage import (
    AsyncStorage,
    SQLiteStorage,
    is_duplicate_key,
)
from agentfield_tpu_torch.control_plane.types import (
    AgentNode,
    Execution,
    ExecutionStatus,
    NodeStatus,
    new_id,
    now,
)

from agentfield_tpu_torch.logging import get_logger

log = get_logger("gateway")

EXEC_TOPIC = "executions"

CONTEXT_HEADERS = (
    "X-Run-ID",
    "X-Execution-ID",
    "X-Parent-Execution-ID",
    "X-Session-ID",
    "X-Actor-ID",
)

# Prefix-affinity routing (docs/PREFIX_CACHING.md "Cluster tier"): cap on
# how many leading prompt tokens the gateway hashes per dispatch — the
# consecutive-prefix score saturates long before this, and hashing must stay
# a negligible slice of the dispatch fast path.
_AFFINITY_MAX_TOKENS = 4096
# Load blend: one queued/active request on a candidate outweighs this many
# cached prefix tokens. Keeps a warm node from absorbing an entire burst
# serially while cold-but-idle capacity sits unused.
_AFFINITY_LOAD_WEIGHT = 32.0


def _spec_gateway_enabled() -> bool:
    """Agent-aware serving master switch, gateway side (docs/OPERATIONS.md
    "Agent-aware serving"): with AGENTFIELD_SPEC_PREFILL=0 the gateway
    injects no expect_followup key at all — declared or inferred — so the
    dispatch wire bodies are bit-compatible with the pre-hint control
    plane, not merely ignored at the engine. Read per dispatch (cheap) so
    tests and operators can flip it without a restart."""
    return os.environ.get("AGENTFIELD_SPEC_PREFILL", "1").strip().lower() not in (
        "0", "false", "no", "off",
    )


class GatewayError(Exception):
    def __init__(self, status: int, message: str, retry_after: float | None = None):
        super().__init__(message)
        self.status = status
        self.message = message
        # Overload hint (429 transient backpressure): seconds the caller
        # should wait before retrying, derived from queue depth and the
        # recent worker drain rate — the server renders it as a Retry-After
        # header and the SDK backoff honors it (docs/FAULT_TOLERANCE.md).
        self.retry_after = retry_after


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Gateway-side retry of NODE-level failures (transport errors, agent
    5xx, node down) — the classification mirrors the SDK's
    ``_doc_node_down`` (sdk/agent.py) so the two layers agree on what is
    worth replaying. Deterministic request failures (agent 4xx, schema
    violations) are never retried: replaying those cluster-wide is useless.

    ``max_attempts`` bounds total agent-call attempts per dispatch (across
    failover targets); backoff between attempts is exponential with FULL
    jitter — sleep ~ U(0, min(max_backoff, base_backoff * 2^(attempt-1))) —
    so a burst of failures against a recovering node does not re-arrive as
    a thundering herd.
    """

    max_attempts: int = 3
    base_backoff: float = 0.2
    max_backoff: float = 5.0

    _FIELDS = ("max_attempts", "base_backoff", "max_backoff")

    @staticmethod
    def validate(d: dict[str, Any]) -> dict[str, Any]:
        """Validate a per-execution override dict (request body / persisted
        row) — unknown keys and non-positive numbers are 400s at ingestion,
        not surprises mid-retry."""
        if not isinstance(d, dict):
            raise GatewayError(400, "retry_policy must be an object")
        unknown = set(d) - set(RetryPolicy._FIELDS)
        if unknown:
            raise GatewayError(
                400,
                f"unknown retry_policy keys {sorted(unknown)}; "
                f"allowed: {list(RetryPolicy._FIELDS)}",
            )
        out: dict[str, Any] = {}
        for k, v in d.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)) or v <= 0:
                raise GatewayError(400, f"retry_policy.{k} must be a positive number")
            if k == "max_attempts":
                if v != int(v) or v < 1:
                    # int() truncation would turn 0.9 into a zero budget
                    raise GatewayError(400, "retry_policy.max_attempts must be an integer >= 1")
                out[k] = int(v)
            else:
                out[k] = float(v)
        return out

    def merged(self, override: dict[str, Any] | None) -> "RetryPolicy":
        if not override:
            return self
        return dataclasses.replace(
            self, **{k: v for k, v in override.items() if k in self._FIELDS}
        )

    def backoff(self, attempt: int, rng: random.Random) -> float:
        cap = min(self.max_backoff, self.base_backoff * (2 ** max(attempt - 1, 0)))
        return rng.uniform(0.0, cap)


class ExecutionGateway:
    def __init__(
        self,
        storage: SQLiteStorage,
        bus: EventBus,
        metrics: Metrics,
        agent_timeout: float = 90.0,  # reference agent-call timeout (execute.go:187)
        sync_wait_timeout: float = 600.0,
        async_workers: int = 8,
        queue_capacity: int = 1024,  # reference default (execute.go:1373)
        webhook_notify=None,  # async callable(execution) -> None
        payloads=None,  # PayloadStore | None — large payloads offload to files
        db: AsyncStorage | None = None,  # shared async facade (built if absent)
        retry_policy: RetryPolicy | None = None,  # default node-failure retry
        # (per-execution "retry_policy" in the request body overrides it)
        node_cache=None,  # registry.NodeSnapshotCache | None — dispatch fast
        # path: node resolution in _prepare/_pick_node served from the
        # registry's in-memory snapshot instead of a SQLite scan per request
        channels: ChannelManager | None = None,  # streaming data plane:
        # persistent multiplexed gateway↔node WebSocket channels. None →
        # built here with defaults ($AGENTFIELD_CHANNEL gates it); nodes
        # that don't advertise metadata.channel keep the POST path.
        prefix_affinity: bool | None = None,  # cluster prefix cache
        # (docs/PREFIX_CACHING.md "Cluster tier"): score model-generate
        # dispatch candidates by expected cached-prefix length (from
        # heartbeat sketches) blended with load, and hint losing nodes at
        # the best-advertising peer for cross-node page transfer. None →
        # $AGENTFIELD_PREFIX_AFFINITY (default on); OFF (or absent/stale
        # sketches) is bit-compatible with today's _pick_node order.
    ):
        self.payloads = payloads
        self.storage = storage
        self._node_cache = node_cache
        # Awaitable storage: Postgres calls hop to a worker thread so a slow
        # database can't stall the event loop (SQLite stays on-loop).
        self.db = db if db is not None else AsyncStorage(storage)
        # Completion serialization: with the thread-offloaded provider the
        # event loop no longer serializes complete()'s read-check-write (the
        # awaits yield), so a status callback racing the sync-wait timeout
        # could double-complete. The reference dedicates one completion
        # goroutine for the same reason (execute.go:1404-1429).
        self._complete_lock = asyncio.Lock()
        self.bus = bus
        self.metrics = metrics
        self.agent_timeout = agent_timeout
        self.sync_wait_timeout = sync_wait_timeout
        self.queue_capacity = queue_capacity
        self.async_workers = async_workers
        self.webhook_notify = webhook_notify
        self._queue: asyncio.Queue[Execution] = asyncio.Queue(maxsize=queue_capacity)
        self._workers: list[asyncio.Task] = []
        self._session: http.ClientSession | None = None
        self.retry_policy = retry_policy or RetryPolicy()
        self._retry_rng = random.Random()  # backoff jitter (tests may reseed)
        # Execution ids with a live _dispatch retry loop on this event loop.
        # The orphan requeue (node marked INACTIVE) must skip these: their
        # own retry loop already owns recovery, and a second enqueue would
        # double-dispatch the work.
        self._dispatching: set[str] = set()
        # Strong refs for fire-and-forget terminal transitions (loop tasks
        # are weakly held): a cancelled sync handler must still get its
        # execution to a terminal state.
        self._bg_completions: set[asyncio.Task] = set()
        # Overload signal (docs/FAULT_TOLERANCE.md overload control):
        # monotonic timestamps of recent async-worker queue drains. A full
        # queue WITH recent drains is transient overload (429 + Retry-After
        # estimated from depth/rate); a full queue with NO drain in the
        # window means nothing is moving — no-capacity 503, same as today.
        self._drained: collections.deque[float] = collections.deque(maxlen=1024)
        self._drain_window_s = 30.0
        # Streaming data plane (docs/ARCHITECTURE.md): client-visible frame
        # streams + the persistent node channels that feed them.
        self.streams = ExecutionStreams()
        self.channels = channels if channels is not None else ChannelManager(metrics)
        self.channels.bind(
            publish=self.streams.publish,
            terminal=self._channel_terminal,
            lost=self._channel_lost,
            # Cross-node KV relay: a node's kv_fetch names a peer by id; the
            # manager resolves it to a live node through the same fast-path
            # getter dispatch uses.
            resolve_node=self._node_get,
        )
        # Prefix-affinity routing (docs/PREFIX_CACHING.md "Cluster tier").
        if prefix_affinity is None:
            prefix_affinity = os.environ.get(
                "AGENTFIELD_PREFIX_AFFINITY", "1"
            ).lower() not in ("0", "false", "no")
        self.prefix_affinity = prefix_affinity
        # Per-dispatch transfer hints: execution_id → {node_id, pages,
        # page_size} of the best-advertising peer, written by _pick_node,
        # injected into the generate input by _agent_input, dropped when the
        # dispatch loop exits.
        self._kv_hints: dict[str, dict] = {}
        # Disaggregated prefill/decode pools (docs/ARCHITECTURE.md
        # "Two-phase dispatch"): execution_id → phase state.
        #   {"phase": 1, "prefill_node": id}           — dispatched to the
        #       prefill pool with handoff_export set; the terminal
        #       interceptors watch for the handoff descriptor
        #   {"phase": 2, "prefill_node", "desc", "t0w", "t0m"} — re-dispatch
        #       to the decode pool with the descriptor + kv_peer hint; t0*
        #       anchor the gateway.handoff span (phase-1 terminal →
        #       phase-2 accepted)
        # Entries are dropped on EVERY terminal/fallback path; a mixed-only
        # fleet never creates one (bit-compatible dispatch, pinned).
        self._handoff: dict[str, dict] = {}
        self._handoff_rr = 0  # round-robin cursor over the decode pool
        # Strong refs for stream-execute tasks (loop tasks are weakly
        # held; a GC'd task would strand a prepared execution).
        self._stream_tasks: set[asyncio.Task] = set()
        # Request-scoped tracing (docs/OBSERVABILITY.md): the gateway mints
        # one trace id per execution (_prepare), records its own spans
        # (root, queue wait, per-attempt dispatch, channel submit) straight
        # into the store, and harvests node-side spans off terminal frames
        # / results. Served at GET /api/v1/executions/{id}/trace.
        self.traces = tracing.TraceStore()
        # execution_id -> (trace_id, t0_wall, t0_mono): the open root span,
        # closed by the terminal transition in complete().
        self._trace_roots: dict[str, tuple[str, float, float]] = {}

    @property
    def queue_depth(self) -> int:
        return self._queue.qsize()

    async def start(self) -> None:
        self._session = http.ClientSession(
            timeout=http.ClientTimeout(total=self.agent_timeout),
            # Even non-channel (POST fallback) nodes stop paying per-request
            # connection setup: keep-alive pooled connections, bounded
            # per-host so one hot node can't starve the rest of the fleet's
            # file descriptors.
            connector=http.TCPConnector(
                limit=256, limit_per_host=32, keepalive_timeout=30.0
            ),
        )
        self._workers = [
            asyncio.create_task(self._worker_loop(i)) for i in range(self.async_workers)
        ]

    async def stop(self) -> None:
        for w in self._workers:
            w.cancel()
        await asyncio.gather(*self._workers, return_exceptions=True)
        if self._bg_completions:  # let cancellation-path completions settle
            await asyncio.gather(*list(self._bg_completions), return_exceptions=True)
        for t in list(self._stream_tasks):
            t.cancel()
        if self._stream_tasks:
            await asyncio.gather(*list(self._stream_tasks), return_exceptions=True)
        await self.channels.stop()
        if self._session:
            await self._session.close()

    # ------------------------------------------------------------------

    async def _node_get(self, node_id: str) -> AgentNode | None:
        if self._node_cache is not None:
            return await self._node_cache.get(node_id)
        return await self.db.get_node(node_id)

    async def _node_list(self) -> list[AgentNode]:
        if self._node_cache is not None:
            return await self._node_cache.list()
        return await self.db.list_nodes()

    async def _prepare(
        self,
        target: str,
        payload: Any,
        headers: dict[str, str],
        webhook_url: str | None,
        status: ExecutionStatus,
        retry_policy: dict[str, Any] | None = None,
        priority: int = 0,
        deadline_s: float | None = None,
        n_branches: int = 1,
        branch_policy: Any = None,
        expect_followup: bool = False,
    ) -> tuple[Execution, AgentNode]:
        """Parse target, resolve node+component, persist the execution record
        (reference: prepareExecution, execute.go:641)."""
        if retry_policy is not None:
            retry_policy = RetryPolicy.validate(retry_policy)
        if isinstance(priority, bool) or not isinstance(priority, int):
            raise GatewayError(400, f"priority must be an integer, got {priority!r}")
        if not isinstance(expect_followup, bool):
            raise GatewayError(
                400, f"expect_followup must be a boolean, got {expect_followup!r}"
            )
        try:
            # Branch decoding (test-time scaling): one shared validation
            # contract with the model node (agentfield_tpu.branching) —
            # reject malformed specs HERE with a 400 instead of burning a
            # dispatch to fail on the node.
            n_branches, branch_policy = validate_branch_spec(
                n_branches, branch_policy
            )
        except ValueError as e:
            raise GatewayError(400, str(e)) from None
        if deadline_s is not None and (
            isinstance(deadline_s, bool)
            or not isinstance(deadline_s, (int, float))
            or not math.isfinite(deadline_s)  # NaN is comparison-inert: it
            # would pass every downstream deadline check (silently meaning
            # "no deadline") and serialize as invalid JSON; Infinity at
            # least degrades, but both are lies — reject them.
            or deadline_s <= 0
        ):
            raise GatewayError(400, "deadline_s must be a positive finite number")
        if "." not in target:
            raise GatewayError(400, f"target {target!r} must be '<node>.<component>'")
        node_id, comp_name = target.split(".", 1)
        node = await self._node_get(node_id)
        if node is None:
            raise GatewayError(404, f"unknown node {node_id!r}")
        found = node.component(comp_name)
        if found is None:
            raise GatewayError(404, f"node {node_id!r} has no component {comp_name!r}")
        _, ttype = found
        if node.status not in (NodeStatus.ACTIVE, NodeStatus.STARTING):
            # The named node is down — but if any other ACTIVE node serves
            # this component, accept the work and let _dispatch fail over to
            # it (a dead target must not 503 callers while capacity exists).
            # With no capable node anywhere, 503 as before.
            alt = None
            for cand in await self._node_list():
                if (
                    cand.node_id != node_id
                    and cand.status == NodeStatus.ACTIVE
                    and self._capable_substitute(cand, comp_name, node)
                ):
                    alt = cand
                    break
            if alt is None:
                raise GatewayError(503, f"node {node_id!r} is {node.status.value}")
            self.metrics.inc("gateway_failovers_total")
            node = alt

        # Normalize header casing (clients may send lowercase).
        headers = {k.title(): v for k, v in headers.items()}
        if self.payloads is not None:
            payload = await asyncio.to_thread(self.payloads.offload, payload)
        caller_supplied_id = bool(headers.get("X-Execution-Id"))
        # One trace per execution (docs/OBSERVABILITY.md): the id is minted
        # here, persisted on the row (operators find the trace FROM the
        # execution), and threaded through dispatch as a TraceContext.
        # Tracing off mints nothing — every downstream layer keys on ctx
        # presence, so the off mode is bit-compatible with today's wire.
        trace_id = tracing.new_trace_id() if tracing.enabled() else None
        ex = Execution(
            execution_id=headers.get("X-Execution-Id") or new_id("exec"),
            target=target,
            target_type=ttype,
            status=status,
            run_id=headers.get("X-Run-Id") or new_id("run"),
            parent_execution_id=headers.get("X-Parent-Execution-Id"),
            session_id=headers.get("X-Session-Id"),
            actor_id=headers.get("X-Actor-Id"),
            input=payload,
            webhook_url=webhook_url,
            started_at=now(),
            retry_policy=retry_policy,
            priority=priority,
            deadline_s=float(deadline_s) if deadline_s is not None else None,
            n_branches=n_branches,
            branch_policy=branch_policy,
            trace_id=trace_id,
            expect_followup=expect_followup,
        )
        try:
            # Freshly-minted ids skip the journal's duplicate table probe
            # (only caller-supplied ids can collide with existing rows).
            await self.db.create_execution(ex, check_duplicate=caller_supplied_id)
        except Exception as e:
            if is_duplicate_key(e):
                raise GatewayError(
                    409, f"execution id {ex.execution_id!r} already exists"
                ) from None
            raise
        self.metrics.inc("gateway_executions_total")
        if trace_id is not None:
            # The open root span: closed by the terminal transition in
            # complete(). Registered only once the row exists (a 409'd
            # duplicate must not leak an open root).
            self._trace_roots[ex.execution_id] = (
                trace_id, time.time(), time.perf_counter()
            )
        return ex, node

    def _agent_url(self, node: AgentNode, ex: Execution) -> str:
        comp = ex.target.split(".", 1)[1]
        kind = {"reasoner": "reasoners", "skill": "skills", "generate": "generate"}[
            ex.target_type.value
        ]
        return f"{node.base_url.rstrip('/')}/{kind}/{comp}"

    async def _call_agent_once(
        self, node: AgentNode, ex: Execution
    ) -> tuple[str, Any]:
        """ONE POST to the agent. Returns an (outcome, data) pair instead of
        completing inline so the retry loop can classify:

        - ``("completed", result)`` — agent answered 200
        - ``("deferred", None)``    — agent answered 202; status callback owns
          completion (node death after this is the orphan-requeue's job)
        - ``("fatal", error)``      — deterministic request failure (agent
          4xx): retrying elsewhere cannot help
        - ``("node_error", error)`` — transport failure / agent 5xx /
          malformed reply: the NODE is suspect; retry/failover applies. The
          error strings keep the exact shapes the SDK's ``_doc_node_down``
          classifies ("agent call failed ...", "agent returned 5xx ...").
        """
        assert self._session is not None
        headers = {
            "X-Run-ID": ex.run_id,
            "X-Execution-ID": ex.execution_id,
            "X-Session-ID": ex.session_id or "",
            "X-Actor-ID": ex.actor_id or "",
        }
        if ex.parent_execution_id:
            headers["X-Parent-Execution-ID"] = ex.parent_execution_id
        # Per-attempt TraceContext (docs/OBSERVABILITY.md): attempt number
        # and target node ride INTO the node so its spans come back
        # attempt-labeled — a failover waterfall must say which node served
        # which attempt.
        trace_ctx = None
        if ex.trace_id is not None:
            trace_ctx = {
                "trace_id": ex.trace_id,
                "attempt": ex.attempts,
                "node": node.node_id,
            }
            headers["X-Trace-ID"] = ex.trace_id
        agent_input = await self._agent_input(node, ex, trace=trace_ctx)
        f = faults.fire("gateway.agent_call.delay")
        if f is not None and f.delay_s > 0:
            await asyncio.sleep(f.delay_s)
        f = faults.fire("gateway.agent_call.fail")
        if f is not None:
            # Degrades by classification: node_error feeds the ordinary
            # retry/failover machinery, counted so chaos runs can pin it.
            self.metrics.inc("gateway_faults_injected_total")
            return "node_error", f"agent call failed: {f.error}"
        if self.channels.supports(node):
            # Streaming data plane: one persistent multiplexed WebSocket per
            # node instead of a POST per execution. ("deferred", None) after
            # the node's `accepted` ack — the terminal frame completes the
            # execution exactly like a 202 status callback; token frames
            # land in self.streams on the way. A channel that cannot carry
            # the submit at all falls back to the POST below for THIS call
            # (and starts a cooldown), so a broken channel endpoint degrades
            # to pre-channel behavior instead of failing dispatch.
            try:
                ho = self._handoff.get(ex.execution_id)
                wants_stream = self.streams.wants(ex.execution_id)
                if ho is not None and ho.get("phase") == 1:
                    # Phase 1 is always unary: its only client-relevant
                    # outcome is the handoff descriptor (one discarded
                    # token otherwise) — token frames start with phase 2.
                    wants_stream = False
                t0w, t0m = time.time(), time.perf_counter()
                out = await self.channels.submit(
                    node, ex.execution_id, ex.target.split(".", 1)[1],
                    agent_input, headers,
                    stream=wants_stream,
                    trace=trace_ctx,
                )
                self.traces.record_span(
                    "channel.submit", ex.trace_id, t0w,
                    (time.perf_counter() - t0m) * 1e3,
                    {"node": node.node_id, "attempt": ex.attempts},
                )
                return out
            except ChannelUnavailable as e:
                self.metrics.inc("channel_fallbacks_total")
                log.warning(
                    "channel unavailable; falling back to POST",
                    node_id=node.node_id, execution_id=ex.execution_id,
                    error=str(e),
                )
        t0 = time.perf_counter()
        try:
            async with self._session.post(
                self._agent_url(node, ex),
                json={"input": agent_input, "execution_id": ex.execution_id},
                headers=headers,
            ) as resp:
                if resp.status == 200:
                    body = await resp.json()
                    if not isinstance(body, dict):
                        raise ValueError(f"agent 200 body must be an object, got {type(body).__name__}")
                    result = body.get("result")
                    if isinstance(result, dict) and "trace" in result:
                        # Node-side spans ride the result on the POST path
                        # (the channel path ships them on the terminal
                        # frame); popped BEFORE the result is persisted or
                        # returned to the caller.
                        self._harvest_trace(result.pop("trace"))
                    return "completed", result
                if resp.status == 202:
                    return "deferred", None  # agent will POST the status callback
                text = (await resp.text())[:500]
                err = f"agent returned {resp.status}: {text}"
                return ("node_error" if resp.status >= 500 else "fatal"), err
        except asyncio.CancelledError:
            raise
        except Exception as e:
            # Transport/parse failure: the node (or the path to it) is the
            # problem — retryable by classification.
            self.metrics.inc("gateway_transport_errors_total")
            return "node_error", f"agent call failed: {e!r}"
        finally:
            self.metrics.observe("gateway_agent_call_seconds", time.perf_counter() - t0)

    async def _agent_input(self, node: AgentNode, ex: Execution, trace: dict | None = None):
        """The payload a node actually receives: offloaded payloads resolve
        to real bytes off the event loop, and overload control rides THROUGH
        dispatch to the engine — the execute body's priority/deadline_s
        become generate() kwargs on the model node. The deadline forwarded
        is the REMAINING budget — queue/retry time already spent counts
        against it, so a request that waited out most of its budget at the
        gateway cannot monopolize a slot for the full original window.
        Clamped above zero: an expired-in-flight deadline becomes an instant
        engine-side deadline_exceeded rather than a 400. Explicit caller-set
        keys in the input win (setdefault). Shared by the POST and channel
        paths so the two transports carry identical inputs."""
        agent_input = ex.input
        if self.payloads is not None:
            # agents get real bytes; file IO runs off the event loop
            agent_input = await asyncio.to_thread(self.payloads.resolve, agent_input)
        if (
            node.kind == "model"
            and ex.target.split(".", 1)[1] == "generate"
            and isinstance(agent_input, dict)
        ):
            # Cross-node transfer hint (docs/PREFIX_CACHING.md "Cluster
            # tier"): a peer advertised more of this prompt's prefix than
            # the node we are dispatching to — tell the node where to pull
            # the missing pages from. Never points at the serving node
            # itself.
            hint = self._kv_hints.get(ex.execution_id)
            if hint is not None and hint.get("node_id") == node.node_id:
                hint = None
            branched = ex.n_branches > 1
            ho = self._handoff.get(ex.execution_id)
            # Agent-aware serving (docs/OPERATIONS.md "Agent-aware serving"):
            # the keep-warm hint is either declared on the execute body or
            # inferred from the execution's DAG position (a non-root step of
            # a session-carrying chain WILL see a follow-up). Gated on the
            # same env knob the engine honors, so AGENTFIELD_SPEC_PREFILL=0
            # injects NOTHING — dispatch is bit-compatible with pre-hint
            # wire bodies.
            ef = _spec_gateway_enabled() and (
                ex.expect_followup
                or infer_expect_followup(ex.parent_execution_id, ex.session_id)
            )
            if (
                ex.priority
                or ex.deadline_s is not None
                or hint is not None
                or branched
                or trace is not None
                or "trace" in agent_input
                or ho is not None
                or ef
            ):
                agent_input = dict(agent_input)
                if ex.priority:
                    agent_input.setdefault("priority", ex.priority)
                if ex.deadline_s is not None:
                    remaining = ex.created_at + ex.deadline_s - now()
                    agent_input.setdefault("deadline_s", max(remaining, 0.001))
                if hint is not None:
                    agent_input.setdefault("kv_peer", hint)
                # Request-scoped tracing rides THROUGH dispatch like
                # priority/deadline — but unlike those, the GATEWAY's value
                # always wins (plain assignment + unconditional strip, NOT
                # setdefault): a caller-supplied "trace" key would otherwise
                # inject this request's spans into an arbitrary victim
                # trace id, and force span recording with tracing off
                # (docs/OBSERVABILITY.md). Callers wanting the trace id get
                # it from the execution row, not by picking their own.
                agent_input.pop("trace", None)
                if trace is not None:
                    agent_input["trace"] = trace
                # Two-phase dispatch keys are gateway-owned (plain assign +
                # unconditional strip, same hygiene as "trace"): a caller
                # injecting handoff_export would burn a dispatch on a
                # 1-token stub, and a forged handoff descriptor could adopt
                # foreign KV into its slot.
                agent_input.pop("handoff_export", None)
                agent_input.pop("handoff", None)
                if ho is not None:
                    if ho.get("phase") == 1:
                        agent_input["handoff_export"] = True
                    elif isinstance(ho.get("desc"), dict):
                        agent_input["handoff"] = ho["desc"]
                if branched:
                    # Branch decoding rides THROUGH dispatch like priority/
                    # deadline: the engine forks KV after one prefill and
                    # the node returns only the winner.
                    agent_input.setdefault("n_branches", ex.n_branches)
                    if ex.branch_policy is not None:
                        agent_input.setdefault("branch_policy", ex.branch_policy)
                if ef:
                    # setdefault: a caller that already set expect_followup
                    # (or set it False explicitly) wins over the inference.
                    agent_input.setdefault("expect_followup", True)
        return agent_input

    # -- streaming data plane hooks (channel.py calls back into these) --

    def _close_trace_root(self, ex: Execution) -> None:
        """Close the execution's open root span: the whole gateway-observed
        lifetime, labeled with the terminal status. Idempotent via the pop
        — requeues and late callbacks find nothing open. EVERY path that
        terminates an execution without complete() (the async queue-full
        rejection) must call this too, or the open root leaks for the
        process lifetime."""
        root = self._trace_roots.pop(ex.execution_id, None)
        if root is not None:
            tid, t0w, t0m = root
            self.traces.record_span(
                "gateway.execute", tid, t0w,
                (time.perf_counter() - t0m) * 1e3,
                {
                    "status": ex.status.value,
                    "target": ex.target,
                    "attempts": ex.attempts,
                },
            )

    def _harvest_trace(self, payload) -> None:
        """Land node-shipped spans in the TraceStore. Best-effort and
        shape-validated (the store drops malformed spans) — a garbled
        trace payload must never fail the execution it rode in on."""
        if isinstance(payload, dict):
            self.traces.extend(payload.get("trace_id"), payload.get("spans"))

    async def _channel_terminal(self, execution_id: str, frame: dict) -> None:
        """Terminal frame from a node channel — the channel's analogue of
        the 202 status callback (handle_status_update)."""
        if "trace" in frame:
            # Node spans ride the terminal frame (success AND failure
            # terminals); harvested before completion so the trace endpoint
            # is complete the moment the caller sees the terminal.
            self._harvest_trace(frame.get("trace"))
        result = frame.get("result")
        if isinstance(result, dict) and "trace" in result:
            # Unary-over-channel results (non-text outputs) carry spans in
            # the result body instead; popped before persistence.
            self._harvest_trace(result.pop("trace"))
        if frame.get("status") == "completed":
            ho = self._handoff.get(execution_id)
            if ho is not None and ho.get("phase") == 1:
                # Disaggregated pools: a phase-1 terminal either carries the
                # handoff descriptor (re-dispatch phase 2; this stub result
                # is discarded) or the prefill node's full single-node
                # answer (export declined — complete with it below).
                if await self._handoff_resume(execution_id, result):
                    return
            await self.complete(execution_id, result=result)
        else:
            if self._handoff.pop(execution_id, None) is not None:
                self.metrics.inc("gateway_handoff_fallback_total")
            await self.complete(
                execution_id, error=frame.get("error") or "agent reported failure"
            )

    async def _channel_lost(
        self, execution_id: str, node_id: str, frames_delivered: int, error: str
    ) -> None:
        """The channel died for good (reconnect + reattach exhausted) with
        this execution still on it. The mid-stream failover rule
        (docs/FAULT_TOLERANCE.md): an execution that delivered ZERO frames
        to the client may replay — requeue it through the async queue for
        normal retry/failover, exactly like an orphan of a dead node. Any
        delivered frame forbids replay (duplicated tokens); dead-letter with
        the count recorded for operator triage."""
        if self._handoff.pop(execution_id, None) is not None:
            # Node died mid-handoff (either phase); the requeue/dead-letter
            # below degrades the execution to plain single-node dispatch.
            self.metrics.inc("gateway_handoff_fallback_total")
        if frames_delivered > 0:
            self.metrics.inc("channel_midstream_dead_letter_total")
            await self.complete(
                execution_id,
                error=f"channel to node {node_id} lost mid-stream after "
                f"{frames_delivered} frame(s) reached the client ({error}); "
                "replay would duplicate streamed tokens",
                dead_letter=True,
            )
            return
        async with self._complete_lock:
            cur = await self.db.get_execution(execution_id)
            if (
                cur is None
                or cur.status != ExecutionStatus.RUNNING
                or cur.execution_id in self._dispatching
            ):
                return  # completed/requeued elsewhere (e.g. node-down hook)
            policy = self.retry_policy.merged(cur.retry_policy)
            exhausted = cur.attempts >= policy.max_attempts
            if not exhausted:
                cur.status = ExecutionStatus.QUEUED
                await self.db.update_execution(cur)
        if exhausted:
            await self.complete(
                cur.execution_id,
                error=f"channel to node {node_id} lost ({error}); retry "
                f"budget exhausted after {cur.attempts} attempt(s) over "
                f"nodes {cur.nodes_tried}",
                dead_letter=True,
            )
            return
        try:
            self._queue.put_nowait(cur)
        except asyncio.QueueFull:
            await self.complete(
                cur.execution_id,
                error=f"channel to node {node_id} lost ({error}) and the "
                "requeue found the async queue at capacity",
                dead_letter=True,
            )
            return
        self._publish(cur)
        self.metrics.inc("channel_orphans_requeued_total")
        log.warning(
            "channel lost pre-stream; execution requeued",
            execution_id=execution_id, node_id=node_id, error=error,
        )

    @staticmethod
    def _capable_substitute(cand: AgentNode, comp: str, own: AgentNode | None) -> bool:
        """Is `cand` a legitimate failover target for `own`'s component
        `comp`? Same component name; and when the original node declares a
        served model (model nodes advertise metadata.model), the substitute
        must serve the SAME model — a.generate failing over to a node
        running a different checkpoint would silently answer with the wrong
        model."""
        if cand.component(comp) is None:
            return False
        own_model = (own.metadata or {}).get("model") if own is not None else None
        if own_model is not None and cand.metadata.get("model") != own_model:
            return False
        return True

    # -- disaggregated prefill/decode pools (docs/ARCHITECTURE.md
    # "Two-phase dispatch") --------------------------------------------

    @staticmethod
    def _node_role(node: AgentNode) -> str:
        """The node's advertised pool role. Absent/unknown is "mixed" —
        the bit-compatible default: a role-less fleet must dispatch
        exactly like the pre-pools gateway (pinned by test)."""
        role = (node.metadata or {}).get("role")
        return role if role in ("prefill", "decode") else "mixed"

    def _handoff_eligible(self, ex: Execution) -> bool:
        """Can this execution ride two-phase dispatch? Token-prompt
        model-generate work only (the same shape the cluster prefix tier
        can transfer), single-branch, session-less (session KV pins work
        to one node), text-only. Ineligible work takes the normal path —
        and the ENGINE independently declines ineligible exports, so this
        is routing policy, not the safety net."""
        if ex.target.split(".", 1)[1] != "generate":
            return False
        if ex.n_branches > 1 or ex.session_id is not None:
            return False
        inp = ex.input
        if not isinstance(inp, dict):
            return False
        toks = inp.get("tokens")
        if not isinstance(toks, list) or len(toks) < 2:
            return False
        if any(
            inp.get(k)
            for k in ("images", "audios", "response_schema", "session_id")
        ):
            return False
        return inp.get("n_branches") in (None, 0, 1)

    def _handoff_transition(
        self, ex: Execution, node: AgentNode, result: Any
    ) -> bool:
        """Classify a phase-1 terminal. True → the caller must re-dispatch
        (phase 2 normally; a plain re-run when the descriptor is missing —
        a 1-token phase-1 result must never complete the execution). False
        → the result is terminal as-is: the prefill node declined the
        export (engine-side ineligibility) and decoded the whole request
        itself, which IS the single-node degradation contract."""
        ho = self._handoff.get(ex.execution_id)
        if ho is None or ho.get("phase") != 1:
            return False
        if not (
            isinstance(result, dict)
            and result.get("finish_reason") == "handoff"
        ):
            self._handoff.pop(ex.execution_id, None)
            self.metrics.inc("gateway_handoff_fallback_total")
            return False
        desc = result.get("handoff")
        if not (
            isinstance(desc, dict)
            and isinstance(desc.get("id"), str)
            and isinstance(desc.get("pages"), int)
            and isinstance(desc.get("page_size"), int)
        ):
            # handoff terminal without a usable descriptor (stash expired/
            # evicted): re-dispatch plain — the pages the prefill published
            # make the re-run a cached prefill, token-exact under greedy
            self._handoff.pop(ex.execution_id, None)
            self.metrics.inc("gateway_handoff_fallback_total")
            return True
        self._handoff[ex.execution_id] = {
            "phase": 2,
            "prefill_node": node.node_id,
            "desc": desc,
            "t0w": time.time(),
            "t0m": time.perf_counter(),
        }
        return True

    def _pick_decode_node(
        self,
        ex: Execution,
        tried: set[str],
        candidates: list[AgentNode],
        ho: dict,
    ) -> AgentNode | None:
        """Phase-2 target selection: a decode-pool node (mixed as backup),
        round-robined so a steady handoff stream spreads over the pool, and
        never the prefill node itself; sets the kv_peer hint that pulls the
        whole prompt's pages PLUS the live tail from the prefill node. An
        empty or fully-failed decode pool degrades to single-node execution
        on the prefill node — its published pages make the re-run a cached
        prefill that re-samples the first token identically under greedy."""
        self._kv_hints.pop(ex.execution_id, None)
        pnode = ho.get("prefill_node")
        desc = ho.get("desc") or {}
        pool = [
            n for n in candidates
            if self._node_role(n) == "decode" and n.node_id != pnode
        ] or [
            n for n in candidates
            if self._node_role(n) == "mixed" and n.node_id != pnode
        ]
        if pool:
            self._handoff_rr = (self._handoff_rr + 1) % len(pool)
            pool = pool[self._handoff_rr:] + pool[: self._handoff_rr]
        if len(pool) > 1 and self._node_cache is not None:
            # Pool-aware placement: score candidates by heartbeat-fresh
            # capacity — free KV pages minus the affinity load blend
            # (active slots + queued), same tradeoff as _affinity_order —
            # so an idle decode node beats a loaded one instead of taking
            # its round-robin turn. Nodes without fresh stats score 0.0;
            # a stats-less fleet therefore sorts into the unchanged
            # round-robin order (stable sort) — bit-compatible with the
            # pre-scoring dispatch.
            scores = []
            for n in pool:
                ps = self._node_cache.get_pool_stats(n.node_id)
                scores.append(
                    0.0 if ps is None else ps[0] - _AFFINITY_LOAD_WEIGHT * ps[1]
                )
            if any(s != 0.0 for s in scores):
                order = sorted(range(len(pool)), key=lambda i: (-scores[i], i))
                pool = [pool[i] for i in order]
        picked = next(
            (n for n in pool if n.node_id not in tried),
            pool[0] if pool else None,
        )
        if picked is not None:
            self._kv_hints[ex.execution_id] = {
                "node_id": pnode,
                "pages": desc.get("pages"),
                "page_size": desc.get("page_size"),
                "handoff": desc.get("id"),
            }
            return picked
        self._handoff.pop(ex.execution_id, None)
        self.metrics.inc("gateway_handoff_fallback_total")
        return next(
            (n for n in candidates if n.node_id == pnode),
            next(
                (n for n in candidates if n.node_id not in tried),
                candidates[0] if candidates else None,
            ),
        )

    async def _handoff_resume(self, execution_id: str, result: Any) -> bool:
        """Channel-path phase transition: the phase-1 terminal frame
        arrives outside the _dispatch loop (channel submits return
        deferred), so dispatch is re-entered from here for phase 2 — as a
        task, because a POST-path decode node would otherwise block the
        channel receive loop for the whole decode. Returns True when the
        re-dispatch owns completion (the phase-1 result is discarded),
        False when the caller should complete with the result it has."""
        ex = await self.db.get_execution(execution_id)
        if (
            ex is None
            or ex.status.terminal
            or execution_id in self._dispatching
        ):
            self._handoff.pop(execution_id, None)
            return False
        node_id = (self._handoff.get(execution_id) or {}).get("prefill_node")
        node = await self._node_get(node_id) if node_id else None
        if node is None:
            # Prefill node vanished between terminal and resume: phase 2
            # cannot pull from it. A non-stub result completes as-is (the
            # node declined and decoded single-node); a handoff stub must
            # re-dispatch plain instead of completing with 1 token.
            self._handoff.pop(execution_id, None)
            self.metrics.inc("gateway_handoff_fallback_total")
            if not (
                isinstance(result, dict)
                and result.get("finish_reason") == "handoff"
            ):
                return False
        elif not self._handoff_transition(ex, node, result):
            return False
        ex.attempts = max(0, ex.attempts - 1)  # the phase switch (or the
        # descriptor-less re-run) costs no retry budget
        t = asyncio.ensure_future(self._dispatch(ex))
        self._bg_completions.add(t)
        t.add_done_callback(self._bg_completions.discard)
        return True

    def _affinity_tokens(self, ex: Execution) -> list | None:
        """The token-id prompt affinity can hash, or None (text prompts have
        no gateway-computable page hashes — the gateway has no tokenizer —
        and payload-offloaded inputs are opaque here; both degrade to
        today's pick order)."""
        if not self.prefix_affinity or self._node_cache is None:
            return None
        # Model-node inference targets: the component is named "generate"
        # (registered as a reasoner — same criterion _agent_input's
        # priority/deadline/kv_peer injection keys on).
        if ex.target.split(".", 1)[1] != "generate":
            return None
        inp = ex.input
        if not isinstance(inp, dict):
            return None
        toks = inp.get("tokens")
        if not isinstance(toks, list) or len(toks) < 2:
            return None
        # Client-supplied content: a non-int (or out-of-int32) entry would
        # raise inside np.asarray(..., np.int32) DEEP in _pick_node, where
        # no completion path catches it — the execution would hang RUNNING.
        # Malformed prompts must instead degrade to today's pick order and
        # fail on the node through the normal fatal-outcome path. Only the
        # slice we would hash is checked (bounded work per dispatch).
        for t in toks[:_AFFINITY_MAX_TOKENS]:
            if isinstance(t, bool) or not isinstance(t, int) or not (
                -(2**31) <= t < 2**31
            ):
                return None
        return toks

    def _affinity_order(
        self, ex: Execution, candidates: list[AgentNode]
    ) -> tuple[list[AgentNode], dict[str, int], tuple | None]:
        """Reorder dispatch candidates by expected cached-prefix length
        blended with load (docs/PREFIX_CACHING.md "Cluster tier"). The
        request's leading chain hashes (same blake2b chaining as
        PrefixPagePool) walk each candidate's heartbeat sketch; consecutive
        hits × page_size is the prefill the node would skip. Returns
        ``(ordered, expected_tokens_by_node_id, best)`` where ``best`` is
        the ``(pages, page_size, node)`` of the strongest advertiser —
        _pick_node uses both to count hits and set the transfer hint
        against the node it ACTUALLY picks (retries may skip the scored
        winner). Degradation ladder: affinity off, a text/opaque prompt, or
        no fresh sketch matching anything → the input order returns
        UNCHANGED (bit-compatible with the pre-affinity pick order, pinned
        by test). Capability/model filtering already happened — this only
        permutes nodes that can all legally serve."""
        toks = self._affinity_tokens(ex)
        if toks is None or len(candidates) < 2:
            return candidates, {}, None
        hashes_by_ps: dict[int, list[bytes]] = {}
        expected: list[int] = []  # cached-prefix tokens per candidate
        scores: list[float] = []
        best = None  # (pages, ps, node) — the best-advertising candidate
        for node in candidates:
            got = self._node_cache.get_sketch(node.node_id)
            if got is None:
                expected.append(0)
                scores.append(0.0)
                continue
            sketch, load = got
            ps = sketch.get("page_size")
            digests = sketch.get("digests")
            if (
                isinstance(ps, bool)
                or not isinstance(ps, int)
                or ps < 1
                or not isinstance(digests, list)
            ):
                expected.append(0)
                scores.append(0.0)
                continue
            hs = hashes_by_ps.get(ps)
            if hs is None:
                # Prompt minus its last token — the engine's own matchable
                # prefix rule (the final token's logits must be computed).
                hs = page_chain_hashes(
                    toks[: len(toks) - 1][:_AFFINITY_MAX_TOKENS], ps
                )
                hashes_by_ps[ps] = hs
            dset = set(digests)
            pages = 0
            for h in hs:
                if sketch_digest(h) not in dset:
                    break  # consecutive-prefix walk: a gap ends the match
                pages += 1
            expected.append(pages * ps)
            scores.append(pages * ps - _AFFINITY_LOAD_WEIGHT * load)
            if pages > 0 and (best is None or pages * ps > best[0] * best[1]):
                best = (pages, ps, node)
        if best is None:
            return candidates, {}, None  # nothing advertised: order untouched
        order = sorted(
            range(len(candidates)), key=lambda i: (-scores[i], i)
        )  # stable: ties keep today's order
        exp_by_id = {
            candidates[i].node_id: expected[i] for i in range(len(candidates))
        }
        return [candidates[i] for i in order], exp_by_id, best

    async def _pick_node(
        self, ex: Execution, tried: set[str]
    ) -> AgentNode | None:
        """Failover target selection: the execution's own node first, then
        any other ACTIVE node exposing a component with the same name (and
        serving the same model, for model nodes — _capable_substitute).
        Nodes in `tried` are deprioritized but NOT forbidden — when every
        capable node has failed once, retrying the original beats giving up
        before the retry budget says so. With prefix affinity on (and a
        fresh sketch matching the request), candidates are re-ordered by
        expected cached-prefix length blended with load first."""
        own_id, comp = ex.target.split(".", 1)
        candidates: list[AgentNode] = []
        own = await self._node_get(own_id)
        # STARTING is dispatchable for the NAMED node (matching _prepare's
        # admission — the old worker called a starting node too); failover
        # substitutes must be fully ACTIVE.
        if own is not None and own.status in (NodeStatus.ACTIVE, NodeStatus.STARTING):
            candidates.append(own)
        for node in await self._node_list():
            if node.node_id == own_id or node.status != NodeStatus.ACTIVE:
                continue
            if self._capable_substitute(node, comp, own):
                candidates.append(node)
        # Disaggregated pools: role-aware routing only engages when the
        # candidate set actually contains a prefill-role node — a mixed
        # fleet takes the unmodified path below, bit-for-bit.
        ho = self._handoff.get(ex.execution_id)
        if ho is not None and ho.get("phase") == 2:
            return self._pick_decode_node(ex, tried, candidates, ho)
        phase1 = False
        roles = {n.node_id: self._node_role(n) for n in candidates}
        if any(r == "prefill" for r in roles.values()):
            if (
                (ho is None or ho.get("phase") == 1)
                and any(r == "decode" for r in roles.values())
                and self._handoff_eligible(ex)
            ):
                # phase 1: the prefill pool owns the long-prompt work
                candidates = [
                    n for n in candidates if roles[n.node_id] == "prefill"
                ]
                phase1 = True
            else:
                # ineligible work in a role-split fleet keeps OFF the
                # prefill pool (that is the pool's whole point: prefill
                # bursts must not inflate anyone's decode ITL) — unless
                # nothing else can serve
                self._handoff.pop(ex.execution_id, None)
                others = [
                    n for n in candidates if roles[n.node_id] != "prefill"
                ]
                if others:
                    candidates = others
        candidates, expected, best = self._affinity_order(ex, candidates)
        picked = next(
            (n for n in candidates if n.node_id not in tried),
            candidates[0] if candidates else None,
        )
        # Hit/hint bookkeeping against the node ACTUALLY picked (a retry
        # may skip the scored winner): a pick with advertised pages is an
        # affinity hit; a peer advertising MORE than the pick becomes the
        # transfer hint the pick's restore path pulls from.
        self._kv_hints.pop(ex.execution_id, None)
        if picked is not None and best is not None:
            picked_exp = expected.get(picked.node_id, 0)
            if picked_exp > 0:
                self.metrics.inc(
                    "prefix_affinity_hits_total",
                    labels={"node": picked.node_id},
                )
            best_pages, best_ps, best_node = best
            if (
                best_node.node_id != picked.node_id
                and best_pages * best_ps > picked_exp
            ):
                self._kv_hints[ex.execution_id] = {
                    "node_id": best_node.node_id,
                    "pages": best_pages,
                    "page_size": best_ps,
                }
        if phase1 and picked is not None:
            self._handoff[ex.execution_id] = {
                "phase": 1,
                "prefill_node": picked.node_id,
            }
        return picked

    async def _dispatch(
        self, ex: Execution, node: AgentNode | None = None
    ) -> Execution | None:
        """Retry/failover loop around ``_call_agent_once`` (the recovery
        the reference leaves to each SDK client — here the orchestration
        layer owns it). Node-level failures retry with full-jitter backoff,
        failing over to the next capable active node; budget exhaustion (or
        no capable node at all) parks the execution in DEAD_LETTER for
        operator triage/requeue instead of FAILED.

        Returns the TERMINAL execution when dispatch itself finished the
        work (completed / fatal / budget exhausted) so callers need no
        re-read, or None when completion was deferred to a status callback.
        Attempt bookkeeping on terminal paths rides the ``complete()``
        transition itself (one storage write) instead of a separate
        read-check-write round trip; only deferred work persists it
        standalone — the orphan requeue must see which node holds the 202.
        """
        policy = self.retry_policy.merged(ex.retry_policy)
        tried: set[str] = set()
        self._dispatching.add(ex.execution_id)
        if node is not None and self._affinity_tokens(ex) is not None:
            # Prefix-affinity routing owns target selection for hashable
            # model-generate work: drop the _prepare-resolved node so the
            # first attempt goes through _pick_node's scoring too (with
            # affinity off or an unhashable prompt this branch never fires
            # and the pre-affinity dispatch flow is untouched).
            node = None

        async def persist_attempts() -> None:
            cur = await self.db.get_execution(ex.execution_id)
            if cur is not None and not cur.status.terminal:
                cur.attempts = ex.attempts
                cur.nodes_tried = ex.nodes_tried
                await self.db.update_execution(cur)

        keep_handoff = False  # deferred channel submits keep phase-1 state
        # alive for the terminal interceptor; every other exit drops it
        try:
            last_err = "no capable active node"
            while ex.attempts < policy.max_attempts:
                if self._deadline_passed(ex):
                    # Retry backoff ate the rest of the budget: shedding here
                    # beats handing a node work whose caller-facing deadline
                    # is already unmeetable (docs/FAULT_TOLERANCE.md).
                    return await self._shed_expired(ex)
                if node is None:
                    node = await self._pick_node(ex, tried)
                if node is None:
                    break  # nothing active can serve this component
                ex.attempts += 1
                # Append EVERY dispatch (duplicates allowed): nodes_tried is
                # dispatch order, so its last element is always the node the
                # work was last handed to — the orphan requeue's "holder".
                ex.nodes_tried.append(node.node_id)
                t0w, t0m = time.time(), time.perf_counter()
                outcome, data = await self._call_agent_once(node, ex)
                self.traces.record_span(
                    "gateway.dispatch", ex.trace_id, t0w,
                    (time.perf_counter() - t0m) * 1e3,
                    {
                        "node": node.node_id,
                        "attempt": ex.attempts,
                        "outcome": outcome,
                    },
                )
                ho = self._handoff.get(ex.execution_id)
                if (
                    ho is not None
                    and ho.get("phase") == 2
                    and outcome in ("completed", "deferred")
                ):
                    # Phase 2 accepted: close the cross-node handoff span
                    # (phase-1 terminal → phase-2 accepted) and drop the
                    # state — completion is ordinary from here on.
                    self.traces.record_span(
                        "gateway.handoff", ex.trace_id, ho["t0w"],
                        (time.perf_counter() - ho["t0m"]) * 1e3,
                        {
                            "prefill_node": ho.get("prefill_node"),
                            "decode_node": node.node_id,
                        },
                    )
                    self._handoff.pop(ex.execution_id, None)
                if outcome == "completed":
                    if self._handoff_transition(ex, node, data):
                        # phase-1 terminal on the POST path: discard the
                        # stub result, re-enter selection for phase 2 (or a
                        # plain re-run). The phase switch costs no budget.
                        ex.attempts -= 1
                        node = None
                        continue
                    return await self.complete(
                        ex.execution_id,
                        result=data,
                        attempts=ex.attempts,
                        nodes_tried=ex.nodes_tried,
                    )
                if outcome == "deferred":
                    await persist_attempts()
                    keep_handoff = True
                    return None
                if outcome == "fatal":
                    return await self.complete(
                        ex.execution_id,
                        error=data,
                        attempts=ex.attempts,
                        nodes_tried=ex.nodes_tried,
                    )
                # node_error — retryable
                if self._handoff.pop(ex.execution_id, None) is not None:
                    # Mid-handoff node failure (either phase): degrade to a
                    # plain single-node retry. The prefill node's published
                    # pages make a re-run cheap, its tail stash expires by
                    # TTL — zero leaked pages on both nodes.
                    self.metrics.inc("gateway_handoff_fallback_total")
                last_err = data
                tried.add(node.node_id)
                self.metrics.inc("gateway_retries_total")
                log.warning(
                    "agent call failed; will retry",
                    execution_id=ex.execution_id,
                    node_id=node.node_id,
                    attempt=ex.attempts,
                    error=data,
                )
                # A late status callback may have completed the execution
                # while the failed call was in flight — never re-dispatch
                # finished work.
                cur = await self.db.get_execution(ex.execution_id)
                if cur is None or cur.status.terminal:
                    return cur
                if ex.attempts >= policy.max_attempts:
                    break
                nxt = await self._pick_node(ex, tried)
                if nxt is not None and nxt.node_id != node.node_id:
                    self.metrics.inc("gateway_failovers_total")
                node = nxt
                if node is None:
                    break
                await asyncio.sleep(policy.backoff(ex.attempts, self._retry_rng))
            return await self.complete(
                ex.execution_id,
                error=f"retry budget exhausted after {ex.attempts} attempt(s) "
                f"over nodes {ex.nodes_tried}: {last_err}",
                dead_letter=True,
                attempts=ex.attempts,
                nodes_tried=ex.nodes_tried,
            )
        except asyncio.CancelledError:
            # The caller vanished mid-retry (HTTP disconnect / client
            # timeout cancels the handler task, possibly inside a backoff
            # sleep). The execution must still reach a terminal state —
            # its node is ACTIVE, so no requeue hook will ever touch it.
            # Fire-and-forget on the loop (awaiting here would be
            # re-cancelled); complete() is idempotent if anything else
            # finishes it first, and a late agent result is still recorded.
            t = asyncio.ensure_future(
                self.complete(
                    ex.execution_id,
                    error="dispatch cancelled: caller disconnected mid-retry",
                    attempts=ex.attempts,
                    nodes_tried=ex.nodes_tried,
                )
            )
            self._bg_completions.add(t)
            t.add_done_callback(self._bg_completions.discard)
            raise
        finally:
            self._dispatching.discard(ex.execution_id)
            self._kv_hints.pop(ex.execution_id, None)
            if not keep_handoff:
                self._handoff.pop(ex.execution_id, None)

    # ------------------------------------------------------------------

    @staticmethod
    def _deadline_passed(ex: Execution) -> bool:
        return ex.deadline_s is not None and now() > ex.created_at + ex.deadline_s

    async def _shed_expired(self, ex: Execution) -> Execution | None:
        """Deadline-aware shedding (docs/FAULT_TOLERANCE.md overload
        control): the execution's wall-clock budget expired before any node
        could take it — terminal TIMEOUT, never dispatched. The counter is
        the gateway-side overload signal (its engine-side twin is
        ``shed_pending_deadline_total``)."""
        self.metrics.inc("gateway_shed_total")
        return await self.complete(
            ex.execution_id,
            error=f"deadline_s={ex.deadline_s} expired before dispatch; "
            "shed (overload control)",
            timeout=True,
            attempts=ex.attempts,
            nodes_tried=ex.nodes_tried,
        )

    async def execute_sync(
        self,
        target: str,
        payload: Any,
        headers: dict[str, str],
        webhook_url: str | None = None,
        timeout: float | None = None,
        retry_policy: dict[str, Any] | None = None,
        priority: int = 0,
        deadline_s: float | None = None,
        n_branches: int = 1,
        branch_policy: Any = None,
        expect_followup: bool = False,
    ) -> Execution:
        """Sync path: call agent (with retry/failover), then wait on the
        event bus until the execution reaches a terminal state
        (execute.go:195-278)."""
        ex, node = await self._prepare(
            target, payload, headers, webhook_url, ExecutionStatus.RUNNING,
            retry_policy=retry_policy, priority=priority, deadline_s=deadline_s,
            n_branches=n_branches, branch_policy=branch_policy,
            expect_followup=expect_followup,
        )
        done = await self._dispatch(ex, node)
        if done is not None and done.status.terminal:
            return done  # dispatch finished the work: no re-read needed
        # Deferred (202) path: a status callback may have landed already.
        current = await self.db.get_execution(ex.execution_id)
        if current is not None and current.status.terminal:
            return current
        try:
            await self.bus.wait_for(
                EXEC_TOPIC,
                lambda ev: ev.get("execution_id") == ex.execution_id and ev.get("terminal"),
                timeout=timeout or self.sync_wait_timeout,
            )
        except TimeoutError:
            await self.complete(ex.execution_id, error="sync wait timeout", timeout=True)
        return await self.db.get_execution(ex.execution_id)  # type: ignore[return-value]

    async def execute_stream(
        self,
        target: str,
        payload: Any,
        headers: dict[str, str],
        webhook_url: str | None = None,
        timeout: float | None = None,
        retry_policy: dict[str, Any] | None = None,
        priority: int = 0,
        deadline_s: float | None = None,
        n_branches: int = 1,
        branch_policy: Any = None,
        expect_followup: bool = False,
    ) -> tuple[Execution, StreamSubscription]:
        """Streaming sync path: prepare + subscribe to the execution's frame
        stream FIRST (so frame 0 is never missed), then drive dispatch in
        the background. The caller consumes token frames as the node emits
        them — first byte at TTFT — and the stream always ends with exactly
        one terminal frame (the execution's terminal state). Channel-less
        targets degrade gracefully: the subscription just carries the one
        terminal frame when the POST completes. Branched executions
        (n_branches > 1) stream GROUP-AWARE: only the winner's tokens are
        ever emitted, at group resolution."""
        ex, node = await self._prepare(
            target, payload, headers, webhook_url, ExecutionStatus.RUNNING,
            retry_policy=retry_policy, priority=priority, deadline_s=deadline_s,
            n_branches=n_branches, branch_policy=branch_policy,
            expect_followup=expect_followup,
        )
        sub = self.streams.attach(ex.execution_id)

        async def drive() -> None:
            try:
                done = await self._dispatch(ex, node)
                if done is not None and done.status.terminal:
                    return  # complete() already published the terminal frame
                current = await self.db.get_execution(ex.execution_id)
                if current is not None and current.status.terminal:
                    self.streams.finish(current)  # raced a callback: idempotent
                    return
                await self.bus.wait_for(
                    EXEC_TOPIC,
                    lambda ev: ev.get("execution_id") == ex.execution_id
                    and ev.get("terminal"),
                    timeout=timeout or self.sync_wait_timeout,
                )
            except TimeoutError:
                await self.complete(
                    ex.execution_id, error="sync wait timeout", timeout=True
                )
            except asyncio.CancelledError:
                raise
            except Exception as e:  # the task must leave a terminal, never a hang
                await self.complete(
                    ex.execution_id, error=f"internal dispatch error: {e!r}"
                )

        t = asyncio.create_task(drive())
        self._stream_tasks.add(t)
        t.add_done_callback(self._stream_tasks.discard)
        return ex, sub

    async def execute_async(
        self,
        target: str,
        payload: Any,
        headers: dict[str, str],
        webhook_url: str | None = None,
        retry_policy: dict[str, Any] | None = None,
        priority: int = 0,
        deadline_s: float | None = None,
        n_branches: int = 1,
        branch_policy: Any = None,
        expect_followup: bool = False,
        stream: bool = False,  # open the execution's frame stream now so a
        # later GET /executions/{id}/stream attach replays every token
        # (channel-served targets only; without it async work streams
        # nothing and the attach sees just the terminal frame)
    ) -> Execution:
        """Async path: enqueue and 202 immediately. Queue-full backpressure
        is SPLIT by what the drain telemetry says (execute.go:327-367 only
        knew the blind 503): workers visibly draining → transient overload,
        429 with a Retry-After derived from depth/rate — the caller should
        come back; no drain inside the window → nothing is moving, the old
        no-capacity 503."""
        ex, _node = await self._prepare(
            target, payload, headers, webhook_url, ExecutionStatus.QUEUED,
            retry_policy=retry_policy, priority=priority, deadline_s=deadline_s,
            n_branches=n_branches, branch_policy=branch_policy,
            expect_followup=expect_followup,
        )
        if stream:
            # BEFORE the enqueue: a worker may dispatch immediately, and the
            # stream-wanted decision is read at submit time.
            self.streams.ensure(ex.execution_id)
        try:
            self._queue.put_nowait(ex)
        except asyncio.QueueFull:
            ex.status = ExecutionStatus.FAILED
            ex.error = "async queue at capacity"
            ex.finished_at = now()
            await self.db.update_execution(ex)
            # This terminal bypasses complete(): close the root here or it
            # (and its _trace_roots entry) leaks per rejected request.
            self._close_trace_root(ex)
            self.metrics.inc("gateway_backpressure_total")
            ra = self.overload_retry_after()
            if ra is not None:
                raise GatewayError(
                    429,
                    "async execution queue is full (transient overload: "
                    f"retry in ~{ra:.0f}s)",
                    retry_after=ra,
                ) from None
            raise GatewayError(503, "async execution queue is full") from None
        self.metrics.set_gauge("gateway_queue_depth", self._queue.qsize())
        return ex

    def overload_retry_after(self) -> float | None:
        """Estimated seconds until the async queue frees a slot: queue depth
        over the drain rate observed in the last ``_drain_window_s`` seconds.
        None when no drain landed in the window — the queue is full AND
        stalled, which is no-capacity (503 territory), not transient
        overload. Clamped to [1, 120] so one slow execution cannot tell
        callers to go away for an hour."""
        t = time.monotonic()
        cutoff = t - self._drain_window_s
        recent = [d for d in self._drained if d >= cutoff]
        if not recent:
            return None
        if len(recent) >= 2:
            # Inter-drain rate over the observed span. Dividing by the time
            # since the OLDEST drain instead would spike the rate right
            # after a drain lands (1 sample / tiny elapsed), telling callers
            # to retry in ~1s against a queue that actually frees a slot
            # once a minute.
            rate = (len(recent) - 1) / max(recent[-1] - recent[0], 0.05)
        else:
            # One drain in the whole window: that IS the observed rate.
            rate = 1.0 / self._drain_window_s
        return min(max((self._queue.qsize() + 1) / max(rate, 1e-6), 1.0), 120.0)

    async def _worker_loop(self, idx: int) -> None:
        while True:
            ex = await self._queue.get()
            try:
                self.metrics.set_gauge("gateway_queue_depth", self._queue.qsize())
                self.metrics.inc("worker_dispatch_total")
                # Either outcome below (shed, skip, or dispatch) freed a
                # queue slot: that drain timestamp is what turns the next
                # queue-full answer into 429+Retry-After instead of 503.
                self._drained.append(time.monotonic())
                # Re-read: the row may have gone terminal while queued (client
                # status callback, cleanup) — never resurrect it.
                fresh = await self.db.get_execution(ex.execution_id)
                if fresh is None or fresh.status.terminal:
                    continue
                ex = fresh
                if self._deadline_passed(ex):
                    # Deadline-aware shedding: the budget expired while the
                    # work sat queued — dispatching it now would burn a
                    # worker and a node slot on an answer nobody can use.
                    await self._shed_expired(ex)
                    continue
                self.traces.record_span(
                    "gateway.queue_wait", ex.trace_id, ex.created_at,
                    max(now() - ex.created_at, 0.0) * 1e3,
                    {"worker": idx},
                )
                ex.status = ExecutionStatus.RUNNING
                await self.db.update_execution(ex)
                self._publish(ex)
                # _dispatch resolves the node itself (the target's node when
                # ACTIVE, else failover candidates): a node that vanished or
                # went INACTIVE while the work sat queued is just the first
                # failover, not an instant failure.
                await self._dispatch(ex)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # a worker must never die (cf. sweep loop)
                self.metrics.inc("worker_errors_total")
                try:
                    await self.complete(ex.execution_id, error=f"internal dispatch error: {e!r}")
                except Exception as e2:
                    # Still swallowed (the worker loop must survive), but a
                    # double fault is worth an operator-visible trace.
                    log.warning(
                        "failed to record internal dispatch error",
                        execution_id=ex.execution_id,
                        dispatch_error=repr(e),
                        complete_error=repr(e2),
                    )

    # ------------------------------------------------------------------

    async def complete(
        self,
        execution_id: str,
        result: Any = None,
        error: str | None = None,
        timeout: bool = False,
        dead_letter: bool = False,
        attempts: int | None = None,
        nodes_tried: list[str] | None = None,
    ) -> Execution | None:
        """Terminal-state transition: persist once, publish once, fire webhook
        (reference: completeExecution/failExecution, execute.go:831-919;
        completions serialized by _complete_lock — the thread-offloaded
        storage provider yields the loop mid-transition, so loop ordering
        alone no longer guarantees exactly-once). ``attempts``/``nodes_tried``
        let the dispatch loop fold its retry bookkeeping into the terminal
        write instead of a separate read-check-write round trip."""
        async with self._complete_lock:
            ex, barrier = await self._complete_locked(
                execution_id, result, error, timeout, dead_letter,
                attempts=attempts, nodes_tried=nodes_tried,
            )
        if barrier is not None:
            # Group-commit durability barrier, awaited OUTSIDE the completion
            # lock: every completion that lands within one flush tick shares
            # a single commit, and the caller's acknowledgment still goes
            # out only after that commit (docs/OPERATIONS.md).
            await barrier
        if ex is not None and ex.status.terminal:
            self._close_trace_root(ex)
            # Exactly-one terminal frame to every stream subscriber
            # (idempotent — a no-op when nothing ever streamed/subscribed)...
            self.streams.finish(ex)
            # ...and if the execution is still live on a node channel, the
            # terminal came from THIS side (sync-wait timeout, deadline,
            # stale cleanup): propagate cancel down the channel so the
            # engine's cancel path frees the slot now. Fire-and-forget — a
            # terminal transition must never block on a dead socket.
            self.channels.cancel_soon(ex.execution_id)
        return ex

    async def _complete_locked(  # guarded by: _complete_lock
        self,
        execution_id: str,
        result: Any = None,
        error: str | None = None,
        timeout: bool = False,
        dead_letter: bool = False,
        attempts: int | None = None,
        nodes_tried: list[str] | None = None,
    ) -> tuple[Execution | None, Any]:
        """Returns (execution, durability_barrier). The barrier is None on
        the eager-commit path; with the group-commit journal it is an
        awaitable the caller must await AFTER releasing _complete_lock."""
        if isinstance(result, dict) and "trace" in result:
            # Node spans may arrive embedded in ANY completion path's result
            # (direct 200, 202 status callback, channel unary, late result):
            # harvest + pop here, the one choke point, so the persisted and
            # served result never exposes the span payload.
            self._harvest_trace(result.pop("trace"))
        ex = await self.db.get_execution(execution_id)
        if ex is None:
            return None, None
        if ex.status.terminal:
            # Idempotent: late callbacks don't double-complete. One refinement
            # (sync-wait-timeout race): a RESULT arriving after the timeout
            # already went terminal is still recorded — the work WAS done and
            # an operator (or dead-letter requeue) should see it — but the
            # status, events and webhooks are not replayed: subscribers got
            # exactly one terminal event.
            if (
                ex.status in (ExecutionStatus.TIMEOUT, ExecutionStatus.DEAD_LETTER)
                and error is None
                and not timeout
                and not dead_letter
                and ex.result is None
                and result is not None
            ):
                if self.payloads is not None:
                    ex.result = await asyncio.to_thread(self.payloads.offload, result)
                else:
                    ex.result = result
                await self.db.update_execution(ex)
                self.metrics.inc("gateway_late_results_total")
                log.info(
                    "late result recorded on terminal execution",
                    execution_id=ex.execution_id,
                    status=ex.status.value,
                )
            return ex, None
        # Retry bookkeeping folded into the terminal write (the dispatch
        # loop's attempts are authoritative — they only ever run ahead of
        # what a standalone persist would have recorded).
        if attempts is not None:
            ex.attempts = attempts
        if nodes_tried is not None:
            ex.nodes_tried = list(nodes_tried)
        # Record how much of the token stream the client already saw — the
        # fact that forbids replay (dead-letter triage reads this).
        frames = self.streams.tokens_published(execution_id)
        if frames:
            ex.frames_delivered = frames
        if dead_letter:
            ex.status = ExecutionStatus.DEAD_LETTER
            ex.error = error
        elif timeout:
            ex.status = ExecutionStatus.TIMEOUT
            ex.error = error
        elif error is not None:
            ex.status = ExecutionStatus.FAILED
            ex.error = error
        else:
            ex.status = ExecutionStatus.COMPLETED
            raw_result = result
            if self.payloads is not None:
                ex.result = await asyncio.to_thread(self.payloads.offload, result)
            else:
                ex.result = result
        ex.finished_at = now()
        journal = getattr(self.storage, "journal", None)
        barrier = None
        if journal is not None:
            # Group commit: the terminal row is overlay-visible to every
            # reader the instant it is enqueued (the race window the lock
            # protects closes HERE); the commit itself is shared with every
            # other completion landing this flush tick. Events/webhooks
            # below fire inside the (at most) one-tick pre-durability
            # window — an at-least-once delivery wrinkle bounded by the
            # flush interval (docs/OPERATIONS.md).
            journal.enqueue_terminal(ex)
            barrier = journal.flush_barrier()
        else:
            await self.db.update_execution(ex)
        self.metrics.inc(f"gateway_executions_{ex.status.value}_total")
        log.info(
            "execution terminal",
            execution_id=ex.execution_id,
            target=ex.target,
            status=ex.status.value,
            error=ex.error,
        )
        if ex.started_at:
            self.metrics.observe("execution_duration_seconds", ex.finished_at - ex.started_at)
        self._publish(ex)
        if ex.webhook_url and self.webhook_notify:
            # Hand the webhook the in-memory result — no disk round-trip.
            notify_ex = ex
            if ex.status == ExecutionStatus.COMPLETED and self.payloads is not None:
                import dataclasses as _dc

                notify_ex = _dc.replace(ex, result=raw_result)
            await self.webhook_notify(notify_ex)
        return ex, barrier

    async def handle_status_update(
        self, execution_id: str, status: str, result: Any = None, error: str | None = None
    ) -> Execution | None:
        """Agent status callback (reference: handleStatusUpdate, execute.go:423)."""
        if status == "completed":
            return await self.complete(execution_id, result=result)
        if status in ("failed", "error"):
            return await self.complete(execution_id, error=error or "agent reported failure")
        if status == "running":
            ex = await self.db.get_execution(execution_id)
            if ex is not None and not ex.status.terminal:
                ex.status = ExecutionStatus.RUNNING
                await self.db.update_execution(ex)
                self._publish(ex)
            return ex
        raise GatewayError(400, f"unknown status {status!r}")

    async def requeue_node_executions(self, node_id: str, reason: str = "node down") -> int:
        """Orphan requeue: a node just went INACTIVE/away — its in-flight
        (RUNNING) executions must not ride out ``sync_wait_timeout``. Each
        one re-enters the async queue, where a worker re-dispatches it with
        failover; sync callers are still parked on the event bus and wake
        when the requeued execution completes elsewhere. Executions with a
        LIVE dispatch loop on this event loop are skipped (their own retry
        loop owns recovery); an execution whose retry budget is already
        spent dead-letters here rather than looping. Wired to the registry's
        node-down hook (sweep + health monitor). NOTE: requeue is
        at-least-once — the dead node may have partially executed the work;
        targets must tolerate replay (same contract as SDK-side failover)."""
        n = 0
        for ex in await self.db.list_executions(
            status=ExecutionStatus.RUNNING, limit=10_000
        ):
            # The node HOLDING the work is the last one dispatched to
            # (persist_attempts records it at the 202) — after a failover
            # that differs from the target prefix: work deferred on node b
            # must requeue when B dies, and must NOT double-dispatch when
            # the originally-named (but no longer involved) node dies.
            holder = (
                ex.nodes_tried[-1] if ex.nodes_tried else ex.target.split(".", 1)[0]
            )
            if holder != node_id:
                continue
            if ex.execution_id in self._dispatching:
                continue
            # Serialize against completions and re-read: the snapshot above
            # is stale by the time we get here, and flipping a
            # just-COMPLETED row back to QUEUED would erase its result.
            async with self._complete_lock:
                cur = await self.db.get_execution(ex.execution_id)
                if (
                    cur is None
                    or cur.status != ExecutionStatus.RUNNING
                    or cur.execution_id in self._dispatching
                ):
                    continue
                policy = self.retry_policy.merged(cur.retry_policy)
                exhausted = cur.attempts >= policy.max_attempts
                if not exhausted:
                    cur.status = ExecutionStatus.QUEUED
                    await self.db.update_execution(cur)
            if exhausted:
                await self.complete(
                    cur.execution_id,
                    error=f"node {node_id} went down ({reason}); retry budget "
                    f"exhausted after {cur.attempts} attempt(s) over nodes "
                    f"{cur.nodes_tried}",
                    dead_letter=True,
                )
                continue
            try:
                self._queue.put_nowait(cur)
            except asyncio.QueueFull:
                await self.complete(
                    cur.execution_id,
                    error=f"node {node_id} went down ({reason}) and the "
                    "requeue found the async queue at capacity",
                    dead_letter=True,
                )
                continue
            self._publish(cur)
            self.metrics.inc("gateway_orphans_requeued_total")
            n += 1
        if n:
            self.metrics.set_gauge("gateway_queue_depth", self._queue.qsize())
            log.warning("requeued orphaned executions", node_id=node_id, count=n, reason=reason)
        return n

    async def list_dead_letter(self, limit: int = 100, offset: int = 0) -> list[Execution]:
        return await self.db.list_executions(
            status=ExecutionStatus.DEAD_LETTER, limit=limit, offset=offset,
            newest_first=True,
        )

    async def requeue_dead_letter(self, execution_id: str) -> Execution:
        """Operator requeue of a dead-lettered execution: fresh retry budget,
        back through the async queue (404 unknown id, 409 not dead-lettered)."""
        ex = await self.db.get_execution(execution_id)
        if ex is None:
            raise GatewayError(404, f"unknown execution {execution_id!r}")
        if ex.status != ExecutionStatus.DEAD_LETTER:
            raise GatewayError(
                409, f"execution is {ex.status.value}, not dead_letter"
            )
        ex.status = ExecutionStatus.QUEUED
        ex.error = None
        ex.finished_at = None
        ex.attempts = 0  # operator-granted fresh budget
        ex.nodes_tried = []  # stale holder/audit trail must not leak into
        # the new incarnation's requeue matching or error reports
        ex.result = None  # ditto a late-recorded result from the dead
        # incarnation — and the late-result guard must be open for the new one
        ex.frames_delivered = 0  # operator accepted the duplication risk by
        # requeueing; the new incarnation streams from frame 0
        # Fresh trace too: the old root closed at the dead-letter terminal
        # (and its spans have usually aged out of the TTL-bounded store by
        # triage time) — appending the rerun's attempt-1 spans onto the old
        # id would yield a root-less waterfall with colliding attempt
        # labels. The new id's root is registered after the enqueue
        # succeeds, mirroring _prepare.
        ex.trace_id = tracing.new_trace_id() if tracing.enabled() else None
        self.streams.discard(ex.execution_id)
        if ex.deadline_s is not None:
            # Fresh deadline window too: deadline_s counts from created_at,
            # and the original window has usually lapsed by the time an
            # operator triages the dead letter — without a re-base, the
            # worker's pre-dispatch deadline check would shed the requeue
            # as timeout on arrival. Re-basing created_at (rather than
            # adding the lapsed time onto deadline_s) keeps the grant
            # idempotent across REPEATED requeues: every incarnation gets
            # exactly the original window from its requeue instant, never
            # a compounded one.
            ex.created_at = now()
        # Persist BEFORE enqueueing: the worker re-reads the row and drops
        # anything still terminal, so enqueue-first could silently lose the
        # requeue to that race.
        await self.db.update_execution(ex)
        try:
            self._queue.put_nowait(ex)
        except asyncio.QueueFull:
            ex.status = ExecutionStatus.DEAD_LETTER
            ex.error = "requeue failed: async execution queue is full"
            ex.finished_at = now()
            await self.db.update_execution(ex)
            raise GatewayError(503, "async execution queue is full") from None
        if ex.trace_id is not None:
            self._trace_roots[ex.execution_id] = (
                ex.trace_id, time.time(), time.perf_counter()
            )
        self._publish(ex)
        self.metrics.inc("gateway_dead_letter_requeued_total")
        self.metrics.set_gauge("gateway_queue_depth", self._queue.qsize())
        return ex

    def _publish(self, ex: Execution) -> None:
        self.bus.publish(
            EXEC_TOPIC,
            {
                "execution_id": ex.execution_id,
                "run_id": ex.run_id,
                "target": ex.target,
                "status": ex.status.value,
                "terminal": ex.status.terminal,
                "ts": now(),
            },
        )
