"""Model node: the serving engine behind a stdlib HTTP server — counterpart
of ``agentfield_tpu/serving/model_node.py``.

``ModelBackend`` drives the engine on one worker thread (continuous
batching: every ``generate`` call submits a request and waits for its
terminal event) and returns the JAX node's text result dict: ``tokens``,
``logprobs``, ``finish_reason``, ``model`` and ``text``. ``deadline_s`` and
``priority`` ride into the engine's request (the JAX node validates them the
same way); a request past its deadline answers with the tokens generated so
far and ``finish_reason`` "deadline_exceeded". A waiter that gives up
(``timeout``) cancels its request in the engine. ``drain()`` closes
admission (``NodeDrainingError``, HTTP 503), lets in-flight work finish for a
grace period, then deadline-outs the rest through ``deadline_all_now``.

``generate(response_schema=...)`` decodes under the schema's grammar
(``serving.grammar``, compiled once per canonical schema into an LRU of 8):
the node's engine runs with ``grammar_slots=256`` by default, as the JAX
node's does, and the stop id falls back to the tokenizer's
``eos_token_id``.

``generate(n_branches=N, branch_policy=...)`` is the JAX node's branch
decoding: the engine forks the request into N branches after one prefill,
the node's ``branching.BranchGroup`` scores them, prunes and re-forks them
(``beam``) through the engine's ``request_cancel``/``request_fork``, and the
caller gets the winner only, with a ``branches`` summary. The node has no
verifier hook (that needs the control plane), so a policy's ``verifier`` is
not called and the best cumulative logprob wins, as on a JAX node without
one. ``submit_stream`` streams a request's events into a queue; a branched
stream carries the winner's events only, replayed at resolution. A caller
that gives up cancels every branch.

``ModelNodeServer`` keeps the JAX node's direct-invocation HTTP contract
(``sdk/agent.py``): ``POST /reasoners/generate`` with ``{"input": {...}}``
answers ``{"result": {...}}``; ``GET /health``; ``GET /reasoners``. A
request the node cannot serve as sent (an invalid schema, a schema with no
stop id) answers 400, other argument errors 422, a full queue or grammar
bank 503. It is
built on ``http.server.ThreadingHTTPServer`` because the card's machine has
no aiohttp. Control-plane registration, heartbeats and the channel/SSE/gRPC
transports are not ported yet.

Run a node::

    python -m agentfield_tpu_torch.serving.model_node --model llama-3-8b --port 8080 --seed 0

``--kv-quant-dtype int8`` (or ``fp8``) stores the KV pages quantized, with
per-slot scales (``EngineConfig.kv_quant_dtype``). ``--spec-draft
llama-3.2-draft --spec-k 3`` decodes speculatively with a draft preset
(``load_draft_model``: random weights from the seed; a trained draft needs
the HF checkpoint loader, which is not ported yet).
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import dataclasses
import inspect
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import torch

from agentfield_tpu_torch.branching import BranchGroup, validate_branch_spec
from agentfield_tpu_torch.models.configs import LlamaConfig, get_config
from agentfield_tpu_torch.models.llama import init_params
from agentfield_tpu_torch.ops.kv_quant import KV_QUANT_DTYPES
from agentfield_tpu_torch.serving.engine import (
    EngineConfig,
    GrammarCapacityError,
    InferenceEngine,
    QueueFullError,
    Request,
    RequestTooLongError,
    TokenEvent,
)
from agentfield_tpu_torch.serving.grammar import Grammar, SchemaError, compile_json_schema
from agentfield_tpu_torch.serving.sampler import SamplingParams
from agentfield_tpu_torch.serving.tokenizer import ByteTokenizer

log = logging.getLogger(__name__)

GRAMMAR_SLOTS = 256  # the node's grammar bank rows, as the JAX node builds it


class BadRequestError(ValueError):
    """A request this node cannot serve as sent (HTTP 400)."""


class NodeDrainingError(QueueFullError):
    """The node is draining: admission is closed. A QueueFullError, so the
    HTTP front answers it as retryable backpressure (503)."""


class ModelBackend:
    def __init__(
        self,
        params: dict[str, Any],
        cfg: LlamaConfig,
        ecfg: EngineConfig | None = None,
        tokenizer=None,
        seed: int = 0,
        model_name: str = "custom",
        device: str | torch.device | None = None,
        idle_sleep: float = 0.002,
        draft: tuple[dict[str, Any], LlamaConfig] | None = None,
    ):
        self.cfg = cfg
        self.model_name = model_name
        self.tokenizer = tokenizer
        if ecfg is None:
            ecfg = EngineConfig(grammar_slots=GRAMMAR_SLOTS)
        self.engine = InferenceEngine(params, cfg, ecfg, seed=seed, device=device, draft=draft)
        self.idle_sleep = idle_sleep
        # canonical schema JSON -> compiled grammar, least recently used out
        self._grammars: collections.OrderedDict[str, Grammar] = collections.OrderedDict()
        self._grammars_max = 8
        self._grammar_lock = threading.Lock()
        # rid -> (future, [(token, logprob)]); touched under _lock only
        self._waiting: dict[str, tuple[concurrent.futures.Future, list]] = {}
        self._streams: dict[str, queue.Queue] = {}  # rid -> its event queue
        # branch decoding: every branch rid -> its group; a group's parent
        # rid -> its one caller-visible sink ("future", fut) | ("stream", q);
        # the resolved summary of a streamed group. Under _lock; the groups
        # themselves are driven on the engine thread only
        self._groups: dict[str, BranchGroup] = {}
        self._group_sinks: dict[str, tuple[str, Any]] = {}
        self._group_meta: dict[str, dict] = {}
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._next = 0
        self._thread: threading.Thread | None = None
        self.error: BaseException | None = None
        self._draining = False

    def start(self) -> None:
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._drive_loop, name="engine", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None

    def _drive_loop(self) -> None:
        """Continuous-batching driver: engine.step() until stopped. A step
        failure fails every waiting request with the real error (the
        engine's state may be corrupt) and stops the loop."""
        if self.engine.device.type == "cuda":
            # kernels launch on this thread's current device and stream
            torch.cuda.set_device(self.engine.device)
        last_gc = time.monotonic()
        while not self._stop.is_set():
            if not self.engine.has_work():
                if time.monotonic() - last_gc > 30.0:
                    last_gc = time.monotonic()
                    self.engine.gc_sessions()
                self._wake.wait(timeout=self.idle_sleep * 50)
                self._wake.clear()
                continue
            try:
                events = self.engine.step()
            except Exception as e:  # noqa: BLE001 — surfaced to every waiter
                with self._lock:  # generate() checks error under this lock
                    self.error = e
                    waiting, self._waiting = self._waiting, {}
                    streams, self._streams = self._streams, {}
                    groups = {id(g): g for g in self._groups.values()}.values()
                log.exception("engine step failed; failing %d waiting requests", len(waiting))
                for fut, _ in waiting.values():
                    fut.set_exception(RuntimeError(f"engine step failed: {e!r}"))
                for rid, q in streams.items():
                    q.put(_error_event(rid, e))
                for g in list(groups):
                    self._fail_group(g, e)
                return
            for ev in events:
                with self._lock:
                    group = self._groups.get(ev.request_id)
                    stream = self._streams.get(ev.request_id)
                    if stream is not None and ev.finished:
                        del self._streams[ev.request_id]
                if group is not None:
                    # a branch's events feed its group, never the caller
                    self._on_group_event(group, ev)
                    continue
                if stream is not None:
                    stream.put(ev)
                    continue
                with self._lock:
                    entry = self._waiting.get(ev.request_id)
                    if entry is None:
                        continue
                    fut, records = entry
                    if ev.token >= 0 and not (ev.finished and ev.finish_reason == "stop"):
                        # stop tokens terminate, they are not content; a
                        # deadline terminal carries no token
                        records.append((ev.token, ev.logprob))
                    if ev.finished:
                        del self._waiting[ev.request_id]
                if ev.finished:
                    fut.set_result(
                        {
                            "tokens": [t for t, _ in records],
                            "logprobs": [lp for _, lp in records],
                            "finish_reason": ev.finish_reason,
                        }
                    )

    def _grammar_for(self, schema: dict[str, Any]) -> Grammar:
        """Compile (once) the token-level grammar of a JSON schema; the cache
        key is the canonical schema text, so identical schemas share one
        grammar and one registration in the engine's bank."""
        if self.tokenizer is None:
            raise BadRequestError("constrained decoding needs a tokenizer on this node")
        key = json.dumps(schema, sort_keys=True)
        with self._grammar_lock:
            g = self._grammars.get(key)
            if g is None:
                vocab = self.tokenizer.token_bytes(self.cfg.vocab_size)
                g = self._grammars[key] = compile_json_schema(schema, vocab)
            self._grammars.move_to_end(key)
            while len(self._grammars) > self._grammars_max:
                # the engine's bank keeps its own reference until its rows
                # evict, so requests in flight are unaffected
                self._grammars.popitem(last=False)
            return g

    def generate(
        self,
        prompt: str | None = None,
        tokens: list[int] | None = None,
        max_new_tokens: int = 128,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        stop_token_ids: list[int] | None = None,
        session_id: str | None = None,
        response_schema: dict[str, Any] | None = None,
        deadline_s: float | None = None,
        priority: int = 0,
        n_branches: int = 1,
        branch_policy: Any = None,
        timeout: float | None = None,
    ) -> dict[str, Any]:
        """Generate from a text ``prompt`` or from ``tokens``; blocks until
        the request finishes. ``response_schema`` (a JSON schema) constrains
        the output to it; ``deadline_s`` bounds the request's wall time in
        the engine (``finish_reason`` "deadline_exceeded", partial tokens
        kept); ``priority`` is its admission tier; ``n_branches`` > 1 forks
        it into branches under ``branch_policy`` ("best_of_n" | "beam" | an
        object, ``branching.validate_branch_spec``) and answers the winner
        with a ``branches`` summary. Raises QueueFullError
        (NodeDrainingError while draining) / RequestTooLongError /
        GrammarCapacityError from admission, BadRequestError (or the
        grammar's SchemaError) for a schema the node cannot serve,
        ValueError for a bad argument, RuntimeError if the engine failed,
        and TimeoutError after cancelling the request (every branch of it)
        when ``timeout`` runs out."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        rid = self._submit(("future", fut), prompt, tokens, max_new_tokens, temperature, top_k,
                           top_p, stop_token_ids, session_id, response_schema, deadline_s,
                           priority, n_branches, branch_policy)
        try:
            result = fut.result(timeout=timeout)
        except concurrent.futures.TimeoutError:
            # the caller gives up: free the engine slots, no reader is left
            self._abandon(rid)
            raise
        if self.tokenizer is not None:
            result["text"] = self.tokenizer.decode(result["tokens"])
        result["model"] = self.model_name
        return result

    def submit_stream(
        self,
        prompt: str | None = None,
        tokens: list[int] | None = None,
        max_new_tokens: int = 128,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        stop_token_ids: list[int] | None = None,
        session_id: str | None = None,
        response_schema: dict[str, Any] | None = None,
        deadline_s: float | None = None,
        priority: int = 0,
        n_branches: int = 1,
        branch_policy: Any = None,
    ) -> tuple[str, queue.Queue]:
        """Streaming variant of ``generate``: returns ``(request_id, queue)``
        of the request's TokenEvents, the last one finished. A branched
        stream emits nothing while its branches decode; at resolution the
        winner's events replay under ``request_id``, then one terminal, and
        ``pop_group_meta(request_id)`` gives the ``branches`` summary.
        ``release_stream`` when the consumer goes away."""
        q: queue.Queue = queue.Queue()
        rid = self._submit(("stream", q), prompt, tokens, max_new_tokens, temperature, top_k,
                           top_p, stop_token_ids, session_id, response_schema, deadline_s,
                           priority, n_branches, branch_policy)
        return rid, q

    def release_stream(self, rid: str) -> None:
        """The consumer of ``rid``'s stream is gone: cancel its request (a
        branched one whole)."""
        self._abandon(rid)
        with self._lock:
            self._group_meta.pop(rid, None)

    def pop_group_meta(self, rid: str) -> dict | None:
        """The ``branches`` summary of a resolved streamed group (once)."""
        with self._lock:
            return self._group_meta.pop(rid, None)

    def _submit(self, sink, prompt, tokens, max_new_tokens, temperature, top_k, top_p,
                stop_token_ids, session_id, response_schema, deadline_s, priority,
                n_branches, branch_policy) -> str:
        """Validate, register ``sink`` for the new request id and submit the
        request to the engine; returns the id."""
        if self._draining:
            raise NodeDrainingError("node is draining: not admitting new work")
        n_branches, branch_policy = validate_branch_spec(n_branches, branch_policy)
        if n_branches > 1 and response_schema is not None:
            raise ValueError(
                "branch decoding is incompatible with response_schema "
                "(constrained decoding owns the sampler mask)"
            )
        if tokens is None:
            if prompt is None:
                raise ValueError("one of 'prompt' or 'tokens' is required")
            if self.tokenizer is None:
                raise ValueError("no tokenizer loaded on this model node; pass 'tokens'")
            tokens = self.tokenizer.encode(prompt)
        grammar = None
        if response_schema is not None:
            if not isinstance(response_schema, dict):
                raise BadRequestError("response_schema must be a JSON object")
            grammar = self._grammar_for(response_schema)
            if not stop_token_ids:
                eos = getattr(self.tokenizer, "eos_token_id", None)
                if eos is None:
                    raise BadRequestError(
                        "constrained decoding needs stop_token_ids (tokenizer has no eos_token_id)"
                    )
                stop_token_ids = [eos]
        with self._lock:
            if self.error is not None:
                raise RuntimeError(f"engine stopped after a failed step: {self.error!r}")
            self._next += 1
            rid = f"gen_{self._next}"
            if n_branches > 1:
                g = BranchGroup(rid, n_branches, branch_policy)
                for r in g.branch_rids():
                    self._groups[r] = g
                self._group_sinks[rid] = sink
            elif sink[0] == "future":
                self._waiting[rid] = (sink[1], [])
            else:
                self._streams[rid] = sink[1]
        try:
            self.engine.submit(
                Request(
                    id=rid,
                    prompt=[int(t) for t in tokens],
                    sampling=SamplingParams(
                        temperature=temperature, top_k=top_k, top_p=top_p,
                        max_new_tokens=max_new_tokens,
                        stop_token_ids=tuple(stop_token_ids or ()),
                    ),
                    session_id=session_id,
                    grammar=grammar,
                    deadline_s=deadline_s,
                    priority=priority,
                    n_branches=n_branches,
                )
            )
        except Exception:
            with self._lock:
                self._forget(rid)
            raise
        self._wake.set()
        return rid

    def _forget(self, rid: str) -> BranchGroup | None:
        """Drop ``rid``'s sinks (under _lock); returns its group, if any."""
        self._waiting.pop(rid, None)
        self._streams.pop(rid, None)
        g = self._groups.get(rid)
        if g is not None:
            self._teardown_group(g)
        return g

    def _abandon(self, rid: str) -> None:
        """No reader is left for ``rid``: drop its sinks and cancel it in the
        engine, every live branch of a group."""
        with self._lock:
            g = self._forget(rid)
        if g is None:
            self.cancel(rid)
            return
        for b in map(g.branch, g.branch_rids()):
            if b is not None and b.live:
                self.engine.request_cancel(b.rid)
        self._wake.set()

    # -- branch decoding: the group lifecycle, on the engine thread -------

    def _teardown_group(self, g: BranchGroup) -> None:  # under _lock
        for r in [r for r, gg in self._groups.items() if gg is g]:
            del self._groups[r]
        self._group_sinks.pop(g.parent, None)

    def _fail_group(self, g: BranchGroup, error: BaseException) -> None:
        with self._lock:
            sink = self._group_sinks.get(g.parent)
            self._teardown_group(g)
        if sink is None:
            return
        kind, obj = sink
        if kind == "future":
            if not obj.done():
                obj.set_exception(RuntimeError(f"engine step failed: {error!r}"))
        else:
            obj.put(_error_event(g.parent, error))

    def _on_group_event(self, g: BranchGroup, ev: TokenEvent) -> None:
        """Feed one branch event to its group and apply the actions: a
        pruned branch is cancelled (its pages free now), a beam survivor
        re-forks into a new branch id, a settled group resolves."""
        for act in g.on_event(ev.request_id, ev):
            if act[0] == "cancel":
                self.engine.stats["branch_pruned_total"] += 1
                self.engine.request_cancel(act[1])
            elif act[0] == "fork":
                _, src, new_rid = act
                with self._lock:
                    if g.parent not in self._group_sinks:
                        continue  # the caller left: no new branches
                    self._groups[new_rid] = g
                self.engine.request_fork(src, new_rid)
            elif act[0] == "resolve":
                self._resolve_group(g)

    @staticmethod
    def _branch_content(b) -> list[tuple[int, float | None]]:
        """A branch's content: a terminal stop token is not content."""
        if b.finish_reason == "stop" and b.records:
            return b.records[:-1]
        return list(b.records)

    def _resolve_group(self, g: BranchGroup) -> None:
        """Every branch settled: the best cumulative logprob wins (the node
        has no verifier hook); deliver it to the group's one sink."""
        cands = g.candidates()
        winner = cands[0] if cands else g.fallback_branch()
        meta = g.summary(winner, False)
        with self._lock:
            sink = self._group_sinks.get(g.parent)
            self._teardown_group(g)
            if sink is not None and sink[0] == "stream":
                self._group_meta[g.parent] = meta
        if sink is None or winner is None:
            return
        kind, obj = sink
        content = self._branch_content(winner)
        if kind == "future":
            if not obj.done():
                obj.set_result({"tokens": [t for t, _ in content],
                                "logprobs": [lp for _, lp in content],
                                "finish_reason": winner.finish_reason, "branches": meta})
            return
        # the winner's tokens replay under the parent id, then one terminal
        # (a deadline or failure terminal carries no token, as the engine's)
        recs, reason = winner.records, winner.finish_reason
        tokened = reason in ("stop", "length") and bool(recs)
        for i, (tok, lp) in enumerate(recs):
            last = tokened and i == len(recs) - 1
            obj.put(TokenEvent(request_id=g.parent, token=tok, index=i, finished=last,
                               finish_reason=reason if last else None, logprob=lp))
        if not tokened:
            obj.put(TokenEvent(request_id=g.parent, token=-1, index=-1, finished=True,
                               finish_reason=reason or "error: branch group unresolved"))

    def cancel(self, rid: str) -> None:
        """Cancel an in-flight request and wake the drive loop so its slot
        frees now."""
        self.engine.request_cancel(rid)
        self._wake.set()

    def drain(self, grace_s: float = 30.0) -> dict[str, Any]:
        """Graceful drain: stop admitting, let in-flight requests finish for
        ``grace_s``, then deadline-out whatever still runs (each caller gets
        a "deadline_exceeded" answer, never a hang). Idempotent; returns a
        summary."""
        t0 = time.monotonic()
        if not self._draining:
            self._draining = True
            self.engine.stats["drains_total"] += 1
        while self.engine.has_work() and time.monotonic() - t0 < grace_s:
            self._wake.set()
            time.sleep(0.02)
        cancelled = 0
        if self.engine.has_work():
            cancelled = self.engine.deadline_all_now()
            self.engine.stats["drain_cancelled"] += cancelled
            t1 = time.monotonic()
            while self.engine.has_work() and time.monotonic() - t1 < 10.0:
                self._wake.set()
                time.sleep(0.02)
        return {
            "drained": not self.engine.has_work(),
            "deadline_outed": cancelled,
            "elapsed_s": round(time.monotonic() - t0, 3),
        }


def _error_event(rid: str, error: BaseException) -> TokenEvent:
    """The terminal a stream gets when the engine failed."""
    return TokenEvent(request_id=rid, token=-1, index=-1, finished=True,
                      finish_reason=f"error: engine step failed: {error!r}")


_GENERATE_ARGS = frozenset(
    p for p in inspect.signature(ModelBackend.generate).parameters if p not in ("self", "timeout")
)


class ModelNodeServer:
    """Stdlib HTTP front of one ModelBackend (one handler thread per
    connection; the engine batches whatever is in flight)."""

    def __init__(self, backend: ModelBackend, node_id: str = "model"):
        self.backend = backend
        self.node_id = node_id
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Start the engine loop and serve on ``host:port`` (0 = any free
        port) from a background thread; returns the bound port."""
        self.backend.start()
        self._httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever, name="http", daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self.backend.stop()

    def reasoners(self) -> list[dict]:
        return [
            {
                "id": "generate",
                "description": f"GPU-served {self.backend.model_name} generation",
                "input_schema": {
                    "type": "object",
                    "properties": {name: {} for name in sorted(_GENERATE_ARGS)},
                },
            }
        ]


def _make_handler(node: ModelNodeServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # keep request logs off stderr
            pass

        def _json(self, status: int, doc: dict) -> None:
            body = json.dumps(doc).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"status": "ok", "node_id": node.node_id})
            elif self.path == "/reasoners":
                self._json(200, {"reasoners": node.reasoners()})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(n) if n else b""
            if self.path != "/reasoners/generate":
                self._json(404, {"error": "unknown component"})
                return
            try:
                body = json.loads(raw) if raw else {}
            except ValueError:
                self._json(400, {"error": "invalid JSON"})
                return
            if not isinstance(body, dict):
                self._json(400, {"error": "JSON object body required"})
                return
            payload = body.get("input") or {}
            if not isinstance(payload, dict) or set(payload) - _GENERATE_ARGS:
                self._json(422, {"error": f"input must be an object with keys in {sorted(_GENERATE_ARGS)}"})
                return
            try:
                result = node.backend.generate(**payload)
            except (QueueFullError, GrammarCapacityError) as e:
                self._json(503, {"error": repr(e)})
                return
            except (BadRequestError, SchemaError) as e:
                self._json(400, {"error": repr(e)})
                return
            except (RequestTooLongError, ValueError, TypeError) as e:
                self._json(422, {"error": repr(e)})
                return
            except Exception as e:  # noqa: BLE001 — reported to the caller
                self._json(500, {"error": repr(e)})
                return
            self._json(200, {"result": result})

    return Handler


def load_draft_model(source: str, target_vocab: int, seed: int = 0,
                     device: str | torch.device = "cuda",
                     dtype: str | torch.dtype | None = None):
    """A speculative-decoding draft for a preset name: random weights drawn
    from ``seed`` on ``device`` (in ``dtype``, default the preset's), the
    ``(params, cfg)`` pair ``InferenceEngine(draft=...)`` takes. A
    vocabulary other than the target's is refused (speculation compares
    token ids), as is a checkpoint directory: the HF checkpoint loader is not
    ported yet."""
    import os

    if os.path.isdir(source):
        raise ValueError(
            f"spec draft {source!r} is a checkpoint directory: the HF checkpoint "
            "loader is not ported yet; pass a preset name")
    dcfg = get_config(source)
    if dcfg.vocab_size != target_vocab:
        raise ValueError(
            f"spec draft {source!r} vocab {dcfg.vocab_size} != target vocab {target_vocab}")
    return init_params(dcfg, seed=seed, dtype=dtype, device=device), dcfg


def build_model_node(
    model: str = "llama-3-8b",
    seed: int = 0,
    ecfg: EngineConfig | None = None,
    device: str | torch.device = "cuda",
    params: dict[str, Any] | None = None,
    tokenizer=None,
    node_id: str = "model",
    spec_draft: str | None = None,
    spec_k: int | None = None,
) -> tuple[ModelNodeServer, ModelBackend]:
    """Construct ``(server, backend)`` for a preset: random weights drawn
    from ``seed`` on ``device`` unless ``params`` are given, the byte
    tokenizer unless one is given. ``spec_k`` sets ``ecfg.spec_k``; with
    ``spec_k > 0`` the ``spec_draft`` preset is the draft model
    (``load_draft_model``, seed ``seed + 4`` as the JAX node draws it, in
    the target's dtype). Call ``server.start(port=...)``."""
    cfg = get_config(model)
    if ecfg is None:
        ecfg = EngineConfig(grammar_slots=GRAMMAR_SLOTS)
    if spec_k is not None:
        ecfg = dataclasses.replace(ecfg, spec_k=spec_k)
    if ecfg.spec_k > 0 and spec_draft is None:
        raise ValueError("spec_k > 0 needs spec_draft=<model preset>")
    if params is None:
        params = init_params(cfg, seed=seed, device=device)
    draft = None
    if ecfg.spec_k > 0:
        draft = load_draft_model(spec_draft, cfg.vocab_size, seed=seed + 4, device=device,
                                 dtype=params["embed"].dtype)
    if tokenizer is None:
        tokenizer = ByteTokenizer(cfg.vocab_size)
    backend = ModelBackend(
        params, cfg, ecfg, tokenizer=tokenizer, seed=seed, model_name=model, device=device,
        draft=draft,
    )
    return ModelNodeServer(backend, node_id=node_id), backend


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="Serve a model over HTTP on the GPU.")
    ap.add_argument("--model", default="llama-3-8b")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kv-quant-dtype", default="none", choices=KV_QUANT_DTYPES,
                    help="store KV pages quantized with per-slot scales")
    ap.add_argument("--spec-draft", default=None,
                    help="draft model preset for speculative decoding (with --spec-k)")
    ap.add_argument("--spec-k", type=int, default=None,
                    help="draft proposals per speculative step (needs --spec-draft)")
    args = ap.parse_args(argv)
    server, _ = build_model_node(
        args.model, seed=args.seed, device=args.device,
        ecfg=EngineConfig(grammar_slots=GRAMMAR_SLOTS, kv_quant_dtype=args.kv_quant_dtype),
        spec_draft=args.spec_draft, spec_k=args.spec_k,
    )
    port = server.start(args.host, args.port)
    print(f"model node {args.model} serving on http://{args.host}:{port}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()


if __name__ == "__main__":
    main()
