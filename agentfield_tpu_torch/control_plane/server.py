"""Control-plane HTTP server: the port's copy of
``agentfield_tpu/control_plane/server.py`` on ``http.py`` (asyncio, the
standard library) in place of aiohttp. The routes, status codes and error
bodies are the JAX server's, the DID/VC identity layer on the port's own
primitives (``identity.py`` over ``crypto.py``), the MCP manager
(``mcp_service.py``), the dashboard on ``/``, ``/api/ui/*``,
``/api/v1/packages`` and ``/api/v1/memory/events/ws`` included. A
``postgres://`` ``db_path`` opens ``storage_pg.PostgresStorage`` (the
port's own wire client, ``pgwire.py``); ``admin_grpc_port`` serves the
admin gRPC service (``admin_grpc.py``, on the port's own HTTP/2 transport,
``grpc_h2.py``) from ``start`` to ``stop``.

Two differences, neither visible in an answer: a workflow chain is signed
on a worker thread (the JAX server signs it on the loop), and the memory
events WebSocket's handler ends as soon as its client closes (the JAX one at
its next 30 s wait).

Route surface mirrors the reference's REST API (route table:
internal/server/server.go:557-1049) — /api/v1 namespace, node lifecycle,
sync/async execution, status callbacks, batch status, scoped memory, vector
search, SSE event streams, Prometheus /metrics, /health.
"""

from __future__ import annotations

import asyncio
import json

from agentfield_tpu_torch.control_plane import http as web

from agentfield_tpu_torch.control_plane.channel import ChannelManager as _Channels
from agentfield_tpu_torch.control_plane.events import EventBus
from agentfield_tpu_torch.control_plane.gateway import EXEC_TOPIC, ExecutionGateway, GatewayError
from agentfield_tpu_torch.control_plane.metrics import Metrics
from agentfield_tpu_torch.control_plane.registry import NODE_TOPIC, NodeRegistry, RegistryError
from agentfield_tpu_torch.control_plane.types import ExecutionStatus, now
from agentfield_tpu_torch.control_plane.webhooks import WebhookDispatcher
from agentfield_tpu_torch.logging import get_logger

_log = get_logger("server")

MEMORY_TOPIC = "memory"
VALID_SCOPES = ("global", "session", "actor", "workflow")

CP_KEY: web.AppKey["ControlPlane"] = web.AppKey("cp")


class ControlPlane:
    """Wires storage + bus + registry + gateway + webhook dispatcher
    (the reference's AgentFieldServer plays this role, server.go:75-273)."""

    def __init__(
        self,
        db_path: str = ":memory:",
        agent_timeout: float = 90.0,
        sync_wait_timeout: float = 600.0,
        async_workers: int = 8,
        queue_capacity: int = 1024,
        heartbeat_ttl: float = 300.0,
        sweep_interval: float = 30.0,
        evict_after: float = 1800.0,
        webhook_secret: str | None = None,
        cleanup_interval: float = 60.0,
        stale_after: float = 3600.0,  # reference cleanup defaults (config.go:48-55)
        retention: float = 86400.0,
        keystore_path: str | None = None,  # None → ephemeral seed (tests/dev)
        keystore_passphrase: str | None = None,  # None → env var or dev default
        payload_dir: str | None = None,  # None → payloads stay inline
        admin_grpc_port: int | None = None,  # reference serves admin gRPC on port+100
        health_interval: float = 30.0,  # active probe cadence (health_monitor.go)
        data_dir: str | None = None,  # package registry root (packages page)
        db_group_commit_ms: float | None = None,  # write-behind execution
        # journal flush tick; None → $AGENTFIELD_DB_GROUP_COMMIT_MS, 0 = off
        # (docs/OPERATIONS.md "Durability vs throughput")
        registry_cache: bool | None = None,  # dispatch-path node snapshot
        # cache; None → $AGENTFIELD_REGISTRY_CACHE (default on)
        registry_cache_ttl: float | None = None,  # None → $AGENTFIELD_REGISTRY_CACHE_TTL_S
        channel: bool | None = None,  # streaming data plane master switch:
        # persistent gateway↔node WebSocket channels + token streaming.
        # None → $AGENTFIELD_CHANNEL (default on); False forces every
        # dispatch onto the per-execution POST path (bit-compatible with the
        # pre-channel gateway, pinned by test). docs/OPERATIONS.md.
        prefix_affinity: bool | None = None,  # cluster prefix cache
        # (docs/PREFIX_CACHING.md "Cluster tier"): prefix-affinity dispatch
        # scoring + cross-node KV transfer hints. None →
        # $AGENTFIELD_PREFIX_AFFINITY (default on).
    ):
        from agentfield_tpu_torch.control_plane.identity import DIDService, Keystore, VCService
        from agentfield_tpu_torch.control_plane.storage import AsyncStorage, create_storage

        # db_path doubles as a storage URL: a postgres:// DSN selects the
        # shared-database provider; anything else is a SQLite path
        # (reference: StorageFactory).
        self.storage = create_storage(db_path, group_commit_ms=db_group_commit_ms)

        # Awaitable mirror: handlers await this so a slow Postgres can never
        # stall the event loop (SQLite passes through on-loop).
        self.db = AsyncStorage(self.storage)
        if keystore_path:
            seed = Keystore(keystore_path, keystore_passphrase).load_or_create_seed()
        else:
            import os as _os

            seed = _os.urandom(32)
        self.did_service = DIDService(seed)
        self.vc_service = VCService(self.did_service)
        from agentfield_tpu_torch.control_plane.payloads import PayloadStore

        self.payloads = (
            PayloadStore(payload_dir, secret=seed) if payload_dir else None
        )
        self.admin_grpc_port = admin_grpc_port
        self._admin_grpc = None
        self.metrics = Metrics()
        # Metrics attach to the bus so per-topic drops surface as
        # events_dropped_total{topic=...} instead of a silent swallow.
        self.bus = EventBus(metrics=self.metrics)
        self.webhooks = WebhookDispatcher(self.storage, self.metrics, db=self.db)
        self.webhook_secret = webhook_secret
        self.registry = NodeRegistry(
            self.storage,
            self.bus,
            self.metrics,
            heartbeat_ttl=heartbeat_ttl,
            sweep_interval=sweep_interval,
            evict_after=evict_after,
            did_service=self.did_service,
            db=self.db,
            cache_enabled=registry_cache,
            cache_ttl_s=registry_cache_ttl,
        )
        self.gateway = ExecutionGateway(
            self.storage,
            self.bus,
            self.metrics,
            agent_timeout=agent_timeout,
            sync_wait_timeout=sync_wait_timeout,
            async_workers=async_workers,
            queue_capacity=queue_capacity,
            webhook_notify=self._notify_webhook,
            payloads=self.payloads,
            db=self.db,
            # Dispatch fast path: _prepare/_pick_node resolve nodes from the
            # registry's in-memory snapshot, not a SQLite scan per request.
            node_cache=self.registry.cache,
            channels=_Channels(self.metrics, enabled=channel),
            prefix_affinity=prefix_affinity,
        )

        from agentfield_tpu_torch.control_plane.health import HealthMonitor
        from agentfield_tpu_torch.control_plane.mcp_service import MCPService

        self.health_monitor = HealthMonitor(self.registry, interval=health_interval)
        # Failure-domain hook: the instant a node is marked INACTIVE (lease
        # sweep, health probe) or deregistered, its in-flight executions
        # requeue with failover instead of riding out sync_wait_timeout
        # (docs/FAULT_TOLERANCE.md).
        self.registry.on_node_down(self.gateway.requeue_node_executions)
        self.mcp = MCPService(self.storage, db=self.db)
        import os as _os2
        from pathlib import Path as _Path

        self.data_dir = _Path(_os2.path.expanduser(data_dir or "~/.agentfield_tpu"))
        self._notes_lock = asyncio.Lock()
        self.cleanup_interval = cleanup_interval
        self.stale_after = stale_after
        self.retention = retention
        self._cleanup_task: asyncio.Task | None = None
        self._mcp_autostart_task: asyncio.Task | None = None
        self._started = False

    async def _notify_webhook(self, ex) -> None:
        # gateway.complete hands the raw in-memory result; nothing to resolve.
        await self.webhooks.notify(ex, self.webhook_secret)

    async def start(self) -> None:
        if self._started:  # create_app's startup hook + manual start() are both fine
            return
        self._started = True
        await self.gateway.start()
        await self.registry.start()
        await self.webhooks.start()
        await self.health_monitor.start()
        # autostart MCP servers off the startup path: a hung child binary
        # must not delay /health and the gateway coming up
        self._mcp_autostart_task = asyncio.create_task(self.mcp.start_autostart())
        self._cleanup_task = asyncio.create_task(self._cleanup_loop())
        if self.admin_grpc_port:
            from agentfield_tpu_torch.control_plane.admin_grpc import start_admin_grpc

            self._admin_grpc = start_admin_grpc(self.storage, self.admin_grpc_port)

    async def stop(self) -> None:
        if not self._started:
            return
        self._started = False
        if self._cleanup_task:
            self._cleanup_task.cancel()
            await asyncio.gather(self._cleanup_task, return_exceptions=True)
        if self._admin_grpc is not None:
            # joins the server's threads: off the loop
            await asyncio.to_thread(self._admin_grpc.stop, 0)
            self._admin_grpc = None
        if self._mcp_autostart_task:
            self._mcp_autostart_task.cancel()
            await asyncio.gather(self._mcp_autostart_task, return_exceptions=True)
        await self.mcp.stop_all()
        await self.health_monitor.stop()
        await self.webhooks.stop()
        await self.registry.stop()
        await self.gateway.stop()
        # Group-commit drain hook: flush journaled execution rows while the
        # connection is still open — a graceful shutdown (stop(), SIGTERM in
        # examples/run_control_plane.py) must lose nothing. close() drains
        # again defensively for callers that skip stop(). Both hop to a
        # worker thread: drain() joins the flusher (seconds, worst case) and
        # must not freeze in-flight responses on the way down.
        try:
            await asyncio.to_thread(self.storage.drain_executions)
        except Exception as e:
            # close() retries the drain; a failed flush must not block
            # shutdown, but it must not vanish either.
            _log.warning("journal drain failed during stop", error=repr(e))
        await asyncio.to_thread(self.storage.close)

    async def cleanup_once(self) -> dict[str, int]:
        """Stale marking + retention GC (reference: ExecutionCleanupService,
        internal/handlers/execution_cleanup.go). Stale executions terminate
        through gateway.complete so SSE subscribers and webhooks still see a
        terminal event for orphaned work."""
        t = now()
        stale = 0
        for status in (ExecutionStatus.RUNNING, ExecutionStatus.QUEUED):
            for ex in await self.db.list_executions(status=status, limit=10_000):
                if ex.created_at < t - self.stale_after:
                    await self.gateway.complete(
                        ex.execution_id, error="marked stale by cleanup", timeout=True
                    )
                    stale += 1
        deleted = await self.db.delete_executions_before(t - self.retention)
        wh = await self.db.delete_webhooks_before(t - self.retention)
        if stale:
            self.metrics.inc("executions_marked_stale_total", stale)
        if deleted:
            self.metrics.inc("executions_gc_total", deleted)
        return {"stale": stale, "deleted": deleted, "webhooks_deleted": wh}

    async def _cleanup_loop(self) -> None:
        while True:
            await asyncio.sleep(self.cleanup_interval)
            try:
                await self.cleanup_once()
            except Exception:
                self.metrics.inc("cleanup_errors_total")


def _json_error(
    status: int, message: str, retry_after: float | None = None
) -> web.Response:
    headers = None
    if retry_after is not None:
        # HTTP delta-seconds (integral, at least 1): overloaded-queue 429s
        # tell callers when to come back (docs/FAULT_TOLERANCE.md).
        headers = {"Retry-After": str(max(int(retry_after + 0.5), 1))}
    return web.json_response({"error": message}, status=status, headers=headers)


class _BadBody(Exception):
    pass


async def _json_dict(req: web.Request, allow_empty: bool = True) -> dict:
    """Parse the request body as a JSON object; anything else is a 400."""
    if not req.can_read_body:
        if allow_empty:
            return {}
        raise _BadBody("JSON object body required")
    try:
        body = await req.json()
    except json.JSONDecodeError:
        raise _BadBody("invalid JSON body") from None
    if body is None and allow_empty:
        return {}
    if not isinstance(body, dict):
        raise _BadBody(f"JSON object body required, got {type(body).__name__}")
    return body


def create_app(cp: ControlPlane) -> web.Application:
    app = web.Application(client_max_size=64 * 1024 * 1024)
    app[CP_KEY] = cp

    async def on_startup(_app):
        await cp.start()

    async def on_cleanup(_app):
        await cp.stop()

    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)

    routes = web.RouteTableDef()

    # -- health / metrics ----------------------------------------------

    @routes.get("/")
    async def index(_req):
        from agentfield_tpu_torch.control_plane.dashboard import DASHBOARD_HTML

        return web.Response(text=DASHBOARD_HTML, content_type="text/html")

    @routes.get("/health")
    async def health(_req):
        return web.json_response({"status": "ok", "ts": now()})

    @routes.get("/metrics")
    async def metrics(_req):
        # Re-publish the storage journal's coalesced-write/flush counters at
        # scrape time (the journal lives below the metrics registry; its
        # stats() is an in-memory dict read — cheap and loop-safe).
        # afcheck: ignore[async-blocking] journal_stats() reads an in-memory dict under a short mutex; no DB I/O
        jstats = cp.storage.journal_stats()
        if jstats:
            for k, v in jstats.items():
                cp.metrics.set_gauge(f"db_{k}", float(v))
        return web.Response(text=cp.metrics.render(), content_type="text/plain")

    # -- nodes ----------------------------------------------------------

    async def _resolve_callback(candidates: list, fallback, node_id) -> str | None:
        """Probe candidate callback URLs (GET /health, 1s budget each) and
        pick the first that answers 200 AND identifies itself as the
        registering node — the reference's registration-time callback
        discovery (nodes.go:205-276 probeCandidate /
        resolveCallbackCandidates), hardened: identity-checking the body
        means a loopback candidate can never be satisfied by some unrelated
        process that happens to share the port. All-unreachable keeps the
        declared base_url: the agent may simply not be routable *yet* (it is
        still inside its own registration call for in-process test
        topologies), and the health monitor owns liveness from here on."""
        for cand in candidates:
            if not isinstance(cand, str) or not cand.startswith("http"):
                continue
            try:
                async with web.ClientSession(
                    timeout=web.ClientTimeout(total=1.0)
                ) as s:
                    async with s.get(cand.rstrip("/") + "/health") as r:
                        if r.status != 200:
                            continue
                        doc = await r.json()
                        if isinstance(doc, dict) and doc.get("node_id") == node_id:
                            return cand
            except Exception as e:
                # Unreachable candidates are the expected case during
                # registration races — trace them, keep probing.
                _log.debug(
                    "callback candidate probe failed",
                    candidate=cand, node_id=node_id, error=repr(e),
                )
                continue
        return fallback

    @routes.post("/api/v1/nodes")
    async def register_node(req: web.Request):
        try:
            body = await _json_dict(req, allow_empty=False)
            cands = body.get("callback_candidates")
            if isinstance(cands, list) and cands:
                body["base_url"] = await _resolve_callback(
                    cands, body.get("base_url"), body.get("node_id")
                )
            node = await cp.registry.register(body)
        except RegistryError as e:
            return _json_error(e.status, e.message)
        except (_BadBody, TypeError) as e:
            return _json_error(400, str(e) or "invalid JSON body")
        return web.json_response({"node": node.to_dict()}, status=201)

    @routes.get("/api/v1/nodes")
    async def list_nodes(_req):
        return web.json_response({"nodes": [n.to_dict() for n in await cp.db.list_nodes()]})

    @routes.get("/api/v1/nodes/{node_id}")
    async def get_node(req: web.Request):
        node = await cp.db.get_node(req.match_info["node_id"])
        if node is None:
            return _json_error(404, "unknown node")
        return web.json_response({"node": node.to_dict()})

    @routes.post("/api/v1/nodes/{node_id}/heartbeat")
    async def heartbeat(req: web.Request):
        try:
            body = await _json_dict(req)
            node = await cp.registry.heartbeat(req.match_info["node_id"], body)
        except _BadBody as e:
            return _json_error(400, str(e))
        except RegistryError as e:
            return _json_error(e.status, e.message)
        return web.json_response({"status": node.status.value, "ts": now()})

    @routes.get("/api/v1/nodes/{node_id}/health")
    async def node_health(req: web.Request):
        nid = req.match_info["node_id"]
        node = await cp.db.get_node(nid)
        if node is None:
            return _json_error(404, "unknown node")
        return web.json_response(
            {
                "node_id": nid,
                "status": node.status.value,
                "last_heartbeat": node.last_heartbeat,
                "last_probe": cp.health_monitor.last_probe.get(nid),
            }
        )

    @routes.delete("/api/v1/nodes/{node_id}")
    async def deregister(req: web.Request):
        if not await cp.registry.deregister(req.match_info["node_id"]):
            return _json_error(404, "unknown node")
        return web.json_response({"deleted": True})

    # -- reasoners (REST complement to the admin gRPC surface) ----------

    @routes.get("/api/v1/reasoners")
    async def list_reasoners(_req):
        out = []
        for node in await cp.db.list_nodes():
            for r in node.reasoners:
                out.append(
                    {
                        "node_id": node.node_id,
                        "id": r.id,
                        "target": f"{node.node_id}.{r.id}",
                        "description": r.description,
                        "input_schema": r.input_schema,
                        "did": r.did,
                        "node_status": node.status.value,
                    }
                )
        return web.json_response({"reasoners": out})

    @routes.get("/api/v1/reasoners/{target}/metrics")
    async def reasoner_metrics(req: web.Request):
        target = req.match_info["target"]
        doc = await cp.db.target_metrics(target)
        if not doc["executions"]:
            return _json_error(404, f"no executions recorded for target {target!r}")
        return web.json_response(doc)

    # -- execution ------------------------------------------------------

    def _headers(req: web.Request) -> dict[str, str]:
        return {
            k: v
            for k, v in req.headers.items()
            if k.lower().startswith("x-") and v
        }

    async def _resolve_terminal_frame(frame: dict) -> dict:
        """Payload-offloaded results resolve to real bytes before the
        terminal frame goes over the wire (mirrors execute_sync's doc
        resolution); the stream buffer keeps the offloaded ref."""
        if cp.payloads is not None and frame.get("result") is not None:
            frame = dict(frame)
            frame["result"] = await asyncio.to_thread(
                cp.payloads.resolve, frame["result"]
            )
        return frame

    async def _sse_frames(req: web.Request, sub, first_frame: dict | None = None):
        """Drain one execution's frame stream as SSE: `: ping` comments keep
        idle streams alive through proxies, and the stream ALWAYS ends with
        an explicit terminal frame (or a `dropped` frame for a lagging
        consumer) before close — a client seeing the connection end without
        one knows it was a transport drop, not completion."""
        resp = web.StreamResponse(
            headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
                "Connection": "keep-alive",
            }
        )
        await resp.prepare(req)
        try:
            if first_frame is not None:
                await resp.write(
                    f"data: {json.dumps(first_frame)}\n\n".encode()
                )
            while True:
                try:
                    # wait_for, not aio_timeout: the backport cancels the
                    # ENCLOSING task at its deadline, so a server-shutdown
                    # cancel landing in that window was relabeled
                    # TimeoutError and this loop absorbed it (afcheck
                    # task-lifecycle; the stop()-hang class)
                    frame = await asyncio.wait_for(sub.get(), 15)
                except asyncio.TimeoutError:
                    await resp.write(b": ping\n\n")
                    continue
                if frame is None:
                    # this consumer lagged and was dropped by the fanout —
                    # explicit, so the client can distinguish it from done
                    dropped = {
                        "kind": "dropped",
                        "error": "subscriber lagged behind the stream",
                    }
                    await resp.write(
                        f"data: {json.dumps(dropped)}\n\n".encode()
                    )
                    break
                if frame.get("kind") == "terminal":
                    frame = await _resolve_terminal_frame(frame)
                    await resp.write(f"data: {json.dumps(frame)}\n\n".encode())
                    break
                await resp.write(f"data: {json.dumps(frame)}\n\n".encode())
        except (ConnectionResetError, asyncio.CancelledError):
            # Client gone mid-stream: the execution continues and its result
            # is recorded; GET /executions/{id}/stream can re-attach.
            pass
        finally:
            sub.close()
        return resp

    async def _execute_stream(req: web.Request, body: dict, timeout):
        """`stream=true` sync execute: SSE token frames from TTFT instead of
        one JSON body at completion (docs/ARCHITECTURE.md data plane)."""
        try:
            ex, sub = await cp.gateway.execute_stream(
                req.match_info["target"],
                body.get("input"),
                _headers(req),
                webhook_url=body.get("webhook_url"),
                timeout=timeout,
                retry_policy=body.get("retry_policy"),
                priority=0 if body.get("priority") is None else body["priority"],
                deadline_s=body.get("deadline_s"),
                n_branches=1 if body.get("n_branches") is None else body["n_branches"],
                branch_policy=body.get("branch_policy"),
                expect_followup=False
                if body.get("expect_followup") is None
                else body["expect_followup"],
            )
        except GatewayError as e:
            return _json_error(e.status, e.message, retry_after=e.retry_after)
        start = {
            "kind": "start",
            "execution_id": ex.execution_id,
            "run_id": ex.run_id,
            "target": ex.target,
        }
        if ex.trace_id is not None:
            # Streaming callers learn the trace id up front (the terminal
            # frame may be minutes away); key absent when tracing is off —
            # the start frame stays bit-identical (pinned).
            start["trace_id"] = ex.trace_id
        return await _sse_frames(req, sub, first_frame=start)

    @routes.post("/api/v1/execute/{target}")
    async def execute_sync(req: web.Request):
        try:
            body = await _json_dict(req)
            timeout = body.get("timeout")
            if timeout is not None and (
                isinstance(timeout, bool)
                or not isinstance(timeout, (int, float))
                or timeout <= 0
            ):
                raise _BadBody("timeout must be a positive number")
            if body.get("stream"):
                return await _execute_stream(req, body, timeout)
            ex = await cp.gateway.execute_sync(
                req.match_info["target"],
                body.get("input"),
                _headers(req),
                webhook_url=body.get("webhook_url"),
                timeout=timeout,
                retry_policy=body.get("retry_policy"),
                priority=0 if body.get("priority") is None else body["priority"],
                deadline_s=body.get("deadline_s"),
                n_branches=1 if body.get("n_branches") is None else body["n_branches"],
                branch_policy=body.get("branch_policy"),
                expect_followup=False
                if body.get("expect_followup") is None
                else body["expect_followup"],
            )
        except _BadBody as e:
            return _json_error(400, str(e))
        except GatewayError as e:
            return _json_error(e.status, e.message, retry_after=e.retry_after)
        doc = ex.to_dict()
        if cp.payloads is not None:
            doc["input"] = await asyncio.to_thread(cp.payloads.resolve, doc["input"])
            doc["result"] = await asyncio.to_thread(cp.payloads.resolve, doc["result"])
        return web.json_response(doc)

    @routes.post("/api/v1/execute/async/{target}")
    async def execute_async(req: web.Request):
        try:
            body = await _json_dict(req)
        except _BadBody as e:
            return _json_error(400, str(e))
        try:
            ex = await cp.gateway.execute_async(
                req.match_info["target"],
                body.get("input"),
                _headers(req),
                webhook_url=body.get("webhook_url"),
                retry_policy=body.get("retry_policy"),
                priority=0 if body.get("priority") is None else body["priority"],
                deadline_s=body.get("deadline_s"),
                n_branches=1 if body.get("n_branches") is None else body["n_branches"],
                branch_policy=body.get("branch_policy"),
                expect_followup=False
                if body.get("expect_followup") is None
                else body["expect_followup"],
                stream=bool(body.get("stream")),
            )
        except GatewayError as e:
            return _json_error(e.status, e.message, retry_after=e.retry_after)
        doc = {
            "execution_id": ex.execution_id,
            "run_id": ex.run_id,
            "status": ex.status.value,
        }
        if ex.trace_id is not None:
            doc["trace_id"] = ex.trace_id
        return web.json_response(doc, status=202)

    @routes.get("/api/v1/executions/{execution_id}")
    async def get_execution(req: web.Request):
        ex = await cp.db.get_execution(req.match_info["execution_id"])
        if ex is None:
            return _json_error(404, "unknown execution")
        doc = ex.to_dict()
        if cp.payloads is not None:
            doc["input"] = await asyncio.to_thread(cp.payloads.resolve, doc["input"])
            doc["result"] = await asyncio.to_thread(cp.payloads.resolve, doc["result"])
        return web.json_response(doc)

    @routes.get("/api/v1/executions/{execution_id}/stream")
    async def execution_stream(req: web.Request):
        """Attach to an execution's token stream (any execution — async,
        sync, or one someone else is already watching): buffered frames
        replay from frame 0, then live frames, then the terminal frame. An
        already-terminal execution answers with just its terminal frame."""
        from agentfield_tpu_torch.control_plane.channel import ExecutionStreams

        eid = req.match_info["execution_id"]
        ex = await cp.db.get_execution(eid)
        if ex is None:
            return _json_error(404, "unknown execution")
        if ex.status.terminal and cp.gateway.streams.tokens_published(eid) == 0:
            # Terminal with no retained stream: synthesize the one terminal
            # frame from the row so the contract (always a terminal before
            # close) holds for old executions too.
            frame = await _resolve_terminal_frame(
                ExecutionStreams.terminal_frame(ex.to_dict())
            )
            resp = web.StreamResponse(
                headers={
                    "Content-Type": "text/event-stream",
                    "Cache-Control": "no-cache",
                }
            )
            await resp.prepare(req)
            await resp.write(f"data: {json.dumps(frame)}\n\n".encode())
            return resp
        sub = cp.gateway.streams.attach(eid)
        # Close the attach-vs-terminal race: a completion landing between
        # the row read and the attach would have found no entry to finish —
        # re-read and finish idempotently so the subscriber can never hang.
        cur = await cp.db.get_execution(eid)
        if cur is not None and cur.status.terminal:
            cp.gateway.streams.finish(cur)
        return await _sse_frames(req, sub)

    @routes.get("/api/v1/executions/{execution_id}/trace")
    async def execution_trace(req: web.Request):
        """The execution's assembled trace waterfall (docs/OBSERVABILITY.md
        "Trace anatomy"): every span the gateway recorded or harvested for
        the execution's trace id — gateway root + queue wait + per-attempt
        dispatch + channel submit, then the serving node's engine lifecycle
        spans (queue-wait, prefill, decode, park/resume, kv-restore, fork)
        — ordered by wall-clock start. 404 when tracing was off for this
        execution or the trace aged out of the TTL-bounded store."""
        eid = req.match_info["execution_id"]
        ex = await cp.db.get_execution(eid)
        if ex is None:
            return _json_error(404, "unknown execution")
        if not ex.trace_id:
            return _json_error(
                404,
                "no trace recorded for this execution (tracing off — "
                "AGENTFIELD_TRACE=0 — or the row predates the trace subsystem)",
            )
        spans = cp.gateway.traces.get(ex.trace_id)
        if not spans:
            return _json_error(
                404,
                f"trace {ex.trace_id!r} is no longer retained "
                "(in-memory TraceStore TTL; see docs/OBSERVABILITY.md)",
            )
        return web.json_response(
            {
                "execution_id": eid,
                "trace_id": ex.trace_id,
                "status": ex.status.value,
                "target": ex.target,
                "spans": spans,
            }
        )

    @routes.post("/api/v1/executions/{execution_id}/status")
    async def status_callback(req: web.Request):
        try:
            body = await _json_dict(req, allow_empty=False)
        except _BadBody as e:
            return _json_error(400, str(e))
        try:
            ex = await cp.gateway.handle_status_update(
                req.match_info["execution_id"],
                body.get("status", ""),
                result=body.get("result"),
                error=body.get("error"),
            )
        except GatewayError as e:
            return _json_error(e.status, e.message)
        if ex is None:
            return _json_error(404, "unknown execution")
        return web.json_response({"status": ex.status.value})

    @routes.post("/api/v1/executions/batch-status")
    async def batch_status(req: web.Request):
        try:
            body = await _json_dict(req, allow_empty=False)
        except _BadBody as e:
            return _json_error(400, str(e))
        ids = body.get("execution_ids", [])
        if not isinstance(ids, list) or len(ids) > 1000:
            return _json_error(400, "execution_ids must be a list of at most 1000 ids")
        out = {}
        for eid in ids:
            ex = await cp.db.get_execution(eid)
            if ex is not None:
                result = ex.result if ex.status.terminal else None
                if cp.payloads is not None:
                    result = await asyncio.to_thread(cp.payloads.resolve, result)
                out[eid] = {
                    "status": ex.status.value,
                    "result": result,
                    "error": ex.error,
                }
        return web.json_response({"executions": out})

    @routes.get("/api/v1/executions")
    async def list_executions(req: web.Request):
        q = req.query
        try:
            status = ExecutionStatus(q["status"]) if "status" in q else None
            limit = min(max(int(q.get("limit", "100")), 1), 1000)
            offset = max(int(q.get("offset", "0")), 0)
        except ValueError as e:
            return _json_error(400, f"invalid query parameter: {e}")
        exs = await cp.db.list_executions(
            run_id=q.get("run_id"), status=status, limit=limit, offset=offset
        )
        docs = [e.to_dict() for e in exs]
        if cp.payloads is not None:

            def _resolve_list():
                for d in docs:
                    d["input"] = cp.payloads.resolve(d["input"])
                    d["result"] = cp.payloads.resolve(d["result"])

            await asyncio.to_thread(_resolve_list)
        return web.json_response({"executions": docs})

    # -- dead letter (failed-over-to-exhaustion executions) -------------

    @routes.get("/api/v1/dead-letter")
    async def dead_letter_list(req: web.Request):
        """Operator triage queue: executions whose node-failure retry budget
        was exhausted (docs/FAULT_TOLERANCE.md dead-letter triage runbook)."""
        try:
            limit = min(max(int(req.query.get("limit", "100")), 1), 1000)
            offset = max(int(req.query.get("offset", "0")), 0)
        except ValueError:
            return _json_error(400, "limit/offset must be integers")
        exs = await cp.gateway.list_dead_letter(limit=limit, offset=offset)
        return web.json_response(
            {
                "executions": [
                    {
                        "execution_id": e.execution_id,
                        "target": e.target,
                        "run_id": e.run_id,
                        "error": e.error,
                        "attempts": e.attempts,
                        "nodes_tried": e.nodes_tried,
                        "created_at": e.created_at,
                        "finished_at": e.finished_at,
                    }
                    for e in exs
                ]
            }
        )

    @routes.post("/api/v1/dead-letter/{execution_id}/requeue")
    async def dead_letter_requeue(req: web.Request):
        try:
            ex = await cp.gateway.requeue_dead_letter(req.match_info["execution_id"])
        except GatewayError as e:
            return _json_error(e.status, e.message)
        return web.json_response(
            {"execution_id": ex.execution_id, "status": ex.status.value}, status=202
        )

    # -- DID / VC audit layer ------------------------------------------

    @routes.get("/api/v1/did/org")
    async def org_did(_req):
        return web.json_response({"did": cp.did_service.org_did})

    @routes.get("/api/v1/did/{node_id}")
    async def node_did(req: web.Request):
        node = await cp.db.get_node(req.match_info["node_id"])
        if node is None:
            return _json_error(404, "unknown node")
        return web.json_response(
            {
                "node_id": node.node_id,
                "did": node.did,
                "components": {
                    c.id: c.did for c in node.reasoners + node.skills
                },
                "org_did": cp.did_service.org_did,
            }
        )

    @routes.post("/api/v1/vc/executions/{execution_id}")
    async def issue_vc(req: web.Request):
        ex = await cp.db.get_execution(req.match_info["execution_id"])
        if ex is None:
            return _json_error(404, "unknown execution")
        if not ex.status.terminal:
            return _json_error(409, "execution not terminal yet")
        doc = ex.to_dict()
        if cp.payloads is not None:
            from agentfield_tpu_torch.control_plane.payloads import PayloadMissingError

            try:
                doc["input"] = await asyncio.to_thread(cp.payloads.resolve, doc["input"], True)
                doc["result"] = await asyncio.to_thread(cp.payloads.resolve, doc["result"], True)
            except PayloadMissingError as e:
                return _json_error(410, f"cannot attest: offloaded payload gone ({e})")
        vc = cp.vc_service.issue_execution_vc(doc)
        # Persist for the credentials explorer (/api/ui/v1/credentials) —
        # the reference keeps issued VCs behind its DID/VC services.
        await cp.db.save_credential(
            vc.get("id", f"vc:exec:{ex.execution_id}"), "execution",
            ex.execution_id, vc,
        )
        return web.json_response({"vc": vc})

    @routes.post("/api/v1/vc/verify")
    async def verify_vc(req: web.Request):
        try:
            body = await _json_dict(req, allow_empty=False)
        except _BadBody as e:
            return _json_error(400, str(e))
        vc = body.get("vc")
        if not isinstance(vc, dict):
            return _json_error(400, "field 'vc' (object) is required")
        ok, reason = cp.vc_service.verify(vc)
        return web.json_response({"valid": ok, "reason": reason})

    @routes.get("/api/v1/vc/workflows/{run_id}")
    async def workflow_vc_chain(req: web.Request):
        # Paginate to completeness: an org-SIGNED chain must never silently
        # attest a truncated run.
        # One SQL statement = one snapshot: offset pagination could skip or
        # duplicate rows while the run mutates, and a signed chain must not.
        run_id = req.match_info["run_id"]
        limit = 1_000_000
        exs = await cp.db.list_executions(run_id=run_id, limit=limit)
        if len(exs) == limit:
            # Refuse rather than org-sign a possibly-truncated chain.
            return _json_error(413, f"run exceeds {limit} executions; chain refused")
        if not exs:
            return _json_error(404, "unknown run")
        non_terminal = [e.execution_id for e in exs if not e.status.terminal]
        if non_terminal:
            return _json_error(409, f"run has non-terminal executions: {non_terminal[:5]}")
        docs = [e.to_dict() for e in exs]
        if cp.payloads is not None:
            from agentfield_tpu_torch.control_plane.payloads import PayloadMissingError

            def _resolve_all():
                for d in docs:
                    d["input"] = cp.payloads.resolve(d["input"], strict=True)
                    d["result"] = cp.payloads.resolve(d["result"], strict=True)

            try:
                await asyncio.to_thread(_resolve_all)
            except PayloadMissingError as e:
                return _json_error(410, f"cannot attest: offloaded payload gone ({e})")
        # Signed on a worker thread: a pure-Python signature per credential
        # would hold the loop for the whole chain.
        chain = await asyncio.to_thread(cp.vc_service.workflow_chain, docs)
        # GET stays read-only (a dashboard poll must not mutate the DB); an
        # explicit POST records the chain in the credentials explorer —
        # envelope only, not the payload-resolved per-execution VCs (a large
        # run's chain is megabytes).
        if req.method == "POST":
            await cp.db.save_credential(
                chain.get("envelope", {}).get("id", f"vc:run:{run_id}"),
                "workflow", run_id,
                {
                    "envelope": chain.get("envelope"),
                    "credential_count": len(chain.get("credentials", [])),
                },
            )
        return web.json_response(chain)

    routes.post("/api/v1/vc/workflows/{run_id}")(workflow_vc_chain)

    # -- workflow DAG / runs / notes -----------------------------------

    @routes.get("/api/v1/workflows/{run_id}/dag")
    async def workflow_dag(req: web.Request):
        from agentfield_tpu_torch.control_plane.dag import build_dag

        light = req.query.get("lightweight", "") in ("1", "true")
        dag = await asyncio.to_thread(
            build_dag, cp.storage, req.match_info["run_id"], lightweight=light
        )
        if not dag["nodes"]:
            return _json_error(404, "unknown run")
        return web.json_response(dag)

    @routes.get("/api/v1/runs")
    async def runs(req: web.Request):
        from agentfield_tpu_torch.control_plane.dag import run_summaries

        try:
            limit = min(max(int(req.query.get("limit", "50")), 1), 500)
        except ValueError:
            return _json_error(400, "invalid limit")
        return web.json_response(
            {"runs": await asyncio.to_thread(run_summaries, cp.storage, limit=limit)}
        )

    @routes.post("/api/v1/executions/{execution_id}/notes")
    async def add_note(req: web.Request):
        """Execution notes (reference: app.note() → handlers/execution_notes.go)."""
        try:
            body = await _json_dict(req, allow_empty=False)
        except _BadBody as e:
            return _json_error(400, str(e))
        if "note" not in body:
            return _json_error(400, "field 'note' is required")
        # Serialize the read-modify-write: with the thread-offloaded provider
        # two concurrent notes would otherwise each rewrite the doc from
        # their own snapshot and silently drop one.
        async with cp._notes_lock:
            ex = await cp.db.get_execution(req.match_info["execution_id"])
            if ex is None:
                return _json_error(404, "unknown execution")
            ex.notes.append({"note": body["note"], "ts": now(), "actor": body.get("actor")})
            await cp.db.update_execution(ex)
        return web.json_response({"ok": True, "notes": len(ex.notes)})

    @routes.post("/api/v1/workflow/executions/events")
    async def workflow_event(req: web.Request):
        """Lifecycle-event ingestion for calls the gateway never saw (in-process
        child calls — reference: WorkflowExecutionEventHandler,
        internal/handlers/workflow_execution_events.go:35)."""
        from agentfield_tpu_torch.control_plane.types import Execution, TargetType

        try:
            body = await _json_dict(req, allow_empty=False)
            event = body["event"]
            eid = body["execution_id"]
            run_id = body["run_id"]
            ttype = TargetType(body.get("target_type", "reasoner"))
        except _BadBody as e:
            return _json_error(400, str(e))
        except KeyError as e:
            return _json_error(400, f"missing field {e}")
        except ValueError as e:
            return _json_error(400, str(e))
        if event not in ("start", "complete", "error"):
            return _json_error(400, f"unknown event {event!r}")
        ex = await cp.db.get_execution(eid)
        if ex is None:
            ex = Execution(
                execution_id=eid,
                target=body.get("target", "unknown.unknown"),
                target_type=ttype,
                status=ExecutionStatus.RUNNING,
                run_id=run_id,
                parent_execution_id=body.get("parent_execution_id"),
                session_id=body.get("session_id"),
                actor_id=body.get("actor_id"),
                input=body.get("input"),
            )
            await cp.db.create_execution(ex)
        if event == "complete" and not ex.status.terminal:
            await cp.gateway.complete(eid, result=body.get("result"))
        elif event == "error" and not ex.status.terminal:
            await cp.gateway.complete(eid, error=body.get("error") or "error event")
        return web.json_response({"ok": True})

    # -- event streams (SSE) -------------------------------------------

    async def _sse(req: web.Request, topic: str) -> web.StreamResponse:
        resp = web.StreamResponse(
            headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
                "Connection": "keep-alive",
            }
        )
        await resp.prepare(req)
        q = cp.bus.subscribe(topic)
        try:
            while True:
                try:
                    # wait_for: an external cancel must propagate, never be
                    # relabeled TimeoutError by the aio_timeout backport
                    _, ev = await asyncio.wait_for(q.get(), 15)
                    await resp.write(f"data: {json.dumps(ev)}\n\n".encode())
                except asyncio.TimeoutError:
                    # Periodic comment frame: idle streams survive proxies
                    # and LBs that reap silent connections.
                    await resp.write(b": ping\n\n")
        except asyncio.CancelledError:
            # Server-side close (shutdown): an explicit end event lets the
            # client distinguish a deliberate close from a dropped link.
            try:
                await resp.write(b"event: end\ndata: {}\n\n")
            except (ConnectionResetError, RuntimeError):
                pass  # client is gone too; nothing left to tell it
            raise
        except ConnectionResetError:
            pass  # client hung up; nothing to write a terminal to
        finally:
            cp.bus.unsubscribe(topic, q)
        return resp

    @routes.get("/api/v1/events/executions")
    async def exec_events(req: web.Request):
        return await _sse(req, EXEC_TOPIC)

    @routes.get("/api/v1/events/nodes")
    async def node_events(req: web.Request):
        return await _sse(req, NODE_TOPIC)

    @routes.get("/api/v1/memory/events")
    async def memory_events(req: web.Request):
        return await _sse(req, MEMORY_TOPIC)

    @routes.get("/api/v1/memory/events/ws")
    async def memory_events_ws(req: web.Request):
        """WebSocket fan-out of memory change events (reference:
        handlers/memory_events.go:38 + the SDK's pattern-subscribing client)."""
        ws = web.WebSocketResponse(heartbeat=20)
        await ws.prepare(req)
        q = cp.bus.subscribe(MEMORY_TOPIC)

        async def reader():
            # receive() answers pings and sees the close; the handler ends
            # when the client goes (not at the next event)
            async for _msg in ws:
                pass

        reader_task = asyncio.create_task(reader())
        try:
            while not ws.closed:
                get = asyncio.ensure_future(q.get())
                done, _ = await asyncio.wait({get, reader_task}, timeout=30,
                                             return_when=asyncio.FIRST_COMPLETED)
                if get not in done:
                    get.cancel()
                    await asyncio.gather(get, return_exceptions=True)
                    if reader_task.done():
                        break
                    continue
                _, ev = get.result()
                await ws.send_json(ev)
        except (ConnectionResetError, asyncio.CancelledError):
            pass
        finally:
            reader_task.cancel()
            await asyncio.gather(reader_task, return_exceptions=True)
            cp.bus.unsubscribe(MEMORY_TOPIC, q)
        return ws

    # -- UI service layer ----------------------------------------------

    @routes.get("/api/ui/v1/summary")
    async def ui_summary(_req):
        """Dashboard rollup (reference: UIService aggregated summaries,
        internal/services/ui_service.go)."""
        from agentfield_tpu_torch.control_plane.dag import run_summaries

        nodes = await cp.db.list_nodes()
        return web.json_response(
            {
                "nodes": {
                    "total": len(nodes),
                    "active": sum(n.status.value == "active" for n in nodes),
                    "models": sum(n.kind == "model" for n in nodes),
                },
                "executions_by_status": await cp.db.execution_counts(),
                "recent_runs": await asyncio.to_thread(run_summaries, cp.storage, limit=10),
                "queue_depth": cp.gateway.queue_depth,
                "backpressure_total": cp.metrics.counter_value("gateway_backpressure_total"),
            }
        )

    @routes.get("/api/ui/v1/executions")
    async def ui_executions(req: web.Request):
        """Paginated/filtered/grouped executions page payload (reference:
        GetExecutionsSummary + GetGroupedExecutions,
        internal/services/executions_ui_service.go:112,158). Totals and
        group rollups come from SQL, never from len() of one page."""
        from agentfield_tpu_torch.control_plane import ui_service

        q = req.query
        try:
            payload = await ui_service.executions_page(
                cp.db,
                page=q.get("page", 1),
                page_size=q.get("page_size", 25),
                status=q.get("status"),
                target=q.get("target"),
                run_id=q.get("run_id"),
                order=q.get("order", "desc"),
                group_by=q.get("group_by"),
            )
        except ValueError as e:
            return _json_error(400, str(e))
        return web.json_response(payload)

    @routes.get("/api/ui/v1/nodes")
    async def ui_nodes(_req):
        """Per-node rollups (reference: GetNodesSummary, ui_service.go:78)."""
        from agentfield_tpu_torch.control_plane import ui_service

        return web.json_response(await ui_service.node_summaries(cp))

    @routes.post("/api/ui/v1/executions/status")
    async def ui_executions_status_bulk(req: web.Request):
        """Bulk status refresh for visible rows (reference:
        executions_ui_service.go RefreshStatuses) — one IN query, not N
        detail fetches."""
        from agentfield_tpu_torch.control_plane import ui_service

        try:
            body = await _json_dict(req, allow_empty=False)
        except _BadBody as e:
            return _json_error(400, str(e))
        ids = body.get("ids")
        if not isinstance(ids, list) or not all(isinstance(i, str) for i in ids):
            return _json_error(400, "field 'ids' (list of execution ids) is required")
        return web.json_response(await ui_service.executions_status_bulk(cp.db, ids))

    @routes.get("/api/ui/v1/nodes/{node_id}")
    async def ui_node_details(req: web.Request):
        """Node detail + per-target SQL metrics in one fetch (reference:
        GetNodeDetailsWithMCP, ui_service.go:467)."""
        from agentfield_tpu_torch.control_plane import ui_service

        doc = await ui_service.node_details(cp, req.match_info["node_id"])
        if doc is None:
            return _json_error(404, "unknown node")
        return web.json_response(doc)

    @routes.get("/api/ui/v1/credentials")
    async def ui_credentials(req: web.Request):
        """Issued-credential explorer (reference: CredentialsPage.tsx)."""
        from agentfield_tpu_torch.control_plane import ui_service

        q = req.query
        return web.json_response(
            await ui_service.credentials_page(
                cp.db,
                page=q.get("page", 1),
                page_size=q.get("page_size", 25),
                subject_type=q.get("subject_type"),
            )
        )

    @routes.get("/api/v1/packages")
    async def list_packages(_req):
        """Installed-package inventory (reference: package service routes
        behind PackagesPage.tsx)."""
        from agentfield_tpu_torch.control_plane import ui_service

        return web.json_response(
            await asyncio.to_thread(ui_service.packages_summary, cp.data_dir)
        )

    # -- MCP manager (reference: internal/mcp + ui mcp handlers,
    # server.go:794-798) ------------------------------------------------

    def _mcp_err(e) -> web.Response:
        return _json_error(404 if "unknown MCP server" in str(e) else 400, str(e))

    @routes.get("/api/v1/mcp/servers")
    async def mcp_list(_req):
        return web.json_response({"servers": cp.mcp.status()})

    @routes.post("/api/v1/mcp/servers")
    async def mcp_add(req: web.Request):
        from agentfield_tpu_torch.control_plane.mcp_service import MCPServerSpec, MCPServiceError

        try:
            body = await _json_dict(req, allow_empty=False)
            spec = MCPServerSpec(
                alias=body.get("alias", ""),
                command=body.get("command", ""),
                args=list(body.get("args") or []),
                env=dict(body.get("env") or {}),
                autostart=bool(body.get("autostart", False)),
            )
            cp.mcp.add(spec)
            if body.get("start", False):
                await cp.mcp.start(spec.alias)
        except MCPServiceError as e:
            return _mcp_err(e)
        except _BadBody as e:
            return _json_error(400, str(e))
        return web.json_response({"status": "created", "alias": spec.alias}, status=201)

    @routes.delete("/api/v1/mcp/servers/{alias}")
    async def mcp_remove(req: web.Request):
        from agentfield_tpu_torch.control_plane.mcp_service import MCPServiceError

        try:
            await cp.mcp.remove(req.match_info["alias"])
        except MCPServiceError as e:
            return _mcp_err(e)
        return web.json_response({"status": "removed"})

    @routes.post("/api/v1/mcp/servers/{alias}/{action:start|stop|restart}")
    async def mcp_action(req: web.Request):
        from agentfield_tpu_torch.control_plane.mcp_service import MCPServiceError

        alias, action = req.match_info["alias"], req.match_info["action"]
        try:
            await getattr(cp.mcp, action)(alias)
        except MCPServiceError as e:
            return _mcp_err(e)
        return web.json_response({"status": action, "alias": alias})

    @routes.get("/api/v1/mcp/servers/{alias}/tools")
    async def mcp_tools(req: web.Request):
        from agentfield_tpu_torch.control_plane.mcp_service import MCPServiceError

        try:
            manifest = await cp.mcp.discover(
                req.match_info["alias"], refresh=req.query.get("refresh") == "1"
            )
        except MCPServiceError as e:
            return _mcp_err(e)
        return web.json_response(manifest)

    @routes.get("/api/v1/mcp/servers/{alias}/logs")
    async def mcp_logs(req: web.Request):
        from agentfield_tpu_torch.control_plane.mcp_service import MCPServiceError

        try:
            lines = max(int(req.query.get("lines", "50")), 0)
        except ValueError:
            return _json_error(400, "lines must be an integer")
        try:
            lines = cp.mcp.logs(req.match_info["alias"], lines)
        except MCPServiceError as e:
            return _mcp_err(e)
        return web.json_response({"lines": lines})

    @routes.post("/api/v1/mcp/servers/{alias}/skills/generate")
    async def mcp_generate(req: web.Request):
        from agentfield_tpu_torch.control_plane.mcp_service import MCPServiceError

        alias = req.match_info["alias"]
        try:
            code = await cp.mcp.generate_skills(alias)
        except MCPServiceError as e:
            return _mcp_err(e)
        return web.json_response({"alias": alias, "module": code})

    @routes.get("/api/ui/v1/mcp/status")
    async def mcp_status(_req):
        return web.json_response(cp.mcp.health_summary())

    # -- memory (scoped KV + vectors) ----------------------------------

    def _scope(req: web.Request) -> tuple[str, str]:
        scope = req.query.get("scope", "global")
        scope_id = req.query.get("scope_id", "")
        if scope not in VALID_SCOPES:
            raise GatewayError(400, f"scope must be one of {VALID_SCOPES}")
        if scope != "global" and not scope_id:
            raise GatewayError(400, f"scope {scope!r} requires scope_id")
        return scope, scope_id

    @routes.post("/api/v1/memory/{key}")
    async def memory_set(req: web.Request):
        try:
            scope, scope_id = _scope(req)
            body = await _json_dict(req, allow_empty=False)
        except GatewayError as e:
            return _json_error(e.status, e.message)
        except _BadBody as e:
            return _json_error(400, str(e))
        key = req.match_info["key"]
        await cp.db.memory_set(scope, scope_id, key, body.get("value"))
        cp.bus.publish(
            MEMORY_TOPIC,
            {"type": "set", "scope": scope, "scope_id": scope_id, "key": key, "ts": now()},
        )
        return web.json_response({"ok": True})

    @routes.get("/api/v1/memory/{key}")
    async def memory_get(req: web.Request):
        try:
            scope, scope_id = _scope(req)
        except GatewayError as e:
            return _json_error(e.status, e.message)
        value = await cp.db.memory_get(scope, scope_id, req.match_info["key"])
        if value is None:
            return _json_error(404, "key not found")
        return web.json_response({"value": value})

    @routes.delete("/api/v1/memory/{key}")
    async def memory_delete(req: web.Request):
        try:
            scope, scope_id = _scope(req)
        except GatewayError as e:
            return _json_error(e.status, e.message)
        key = req.match_info["key"]
        if not await cp.db.memory_delete(scope, scope_id, key):
            return _json_error(404, "key not found")
        cp.bus.publish(
            MEMORY_TOPIC,
            {"type": "delete", "scope": scope, "scope_id": scope_id, "key": key, "ts": now()},
        )
        return web.json_response({"ok": True})

    @routes.get("/api/v1/memory")
    async def memory_list(req: web.Request):
        try:
            scope, scope_id = _scope(req)
        except GatewayError as e:
            return _json_error(e.status, e.message)
        return web.json_response(
            {"items": await cp.db.memory_list(scope, scope_id, req.query.get("prefix", ""))}
        )

    @routes.post("/api/v1/memory/vectors/set")
    async def vector_set(req: web.Request):
        try:
            scope, scope_id = _scope(req)
            body = await _json_dict(req, allow_empty=False)
            await cp.db.vector_set(
                scope, scope_id, body["key"], body["embedding"], body.get("metadata")
            )
        except GatewayError as e:
            return _json_error(e.status, e.message)
        except (_BadBody, KeyError, TypeError, ValueError) as e:
            return _json_error(400, f"invalid vector payload: {e!r}")
        return web.json_response({"ok": True})

    @routes.post("/api/v1/memory/vectors/search")
    async def vector_search(req: web.Request):
        try:
            scope, scope_id = _scope(req)
            body = await _json_dict(req, allow_empty=False)
            results = await cp.db.vector_search(
                scope,
                scope_id,
                body["embedding"],
                top_k=int(body.get("top_k", 5)),
                metric=body.get("metric", "cosine"),
            )
        except GatewayError as e:
            return _json_error(e.status, e.message)
        except (_BadBody, KeyError, TypeError, ValueError) as e:
            return _json_error(400, f"invalid search payload: {e!r}")
        return web.json_response({"results": results})

    @routes.post("/api/v1/memory/vectors/delete")
    async def vector_delete(req: web.Request):
        try:
            scope, scope_id = _scope(req)
            body = await _json_dict(req, allow_empty=False)
            ok = await cp.db.vector_delete(scope, scope_id, body["key"])
        except GatewayError as e:
            return _json_error(e.status, e.message)
        except (_BadBody, KeyError, TypeError) as e:
            return _json_error(400, f"invalid payload: {e!r}")
        return web.json_response({"ok": ok})

    app.add_routes(routes)
    return app


async def run_server(cp: ControlPlane, host: str = "127.0.0.1", port: int = 8800) -> web.AppRunner:
    app = create_app(cp)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, host, port)
    await site.start()
    return runner


# seconds ControlPlaneThread.stop waits for running handlers before it
# cancels them (run_server keeps the AppRunner's own default)
_THREAD_SHUTDOWN_S = 5.0


class ControlPlaneThread:
    """A control plane on an event loop of its own, in a daemon thread: for
    a caller that is not asyncio (a test, ``chip_smoke.py``, a node's own
    process). ``start`` serves it and returns its base URL; ``call`` runs a
    coroutine on its loop and returns the result; ``stop`` shuts the server
    down (the control plane's ``stop`` included) and joins the thread."""

    def __init__(self, cp: ControlPlane, host: str = "127.0.0.1", port: int = 0):
        import threading

        self.cp = cp
        self.host, self.port = host, port
        self.loop = asyncio.new_event_loop()
        self._runner: web.AppRunner | None = None
        self._thread = threading.Thread(target=self.loop.run_forever, daemon=True,
                                        name="control-plane")

    @property
    def base_url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self, timeout: float = 30.0) -> str:
        self._thread.start()

        async def boot():
            app = create_app(self.cp)
            runner = web.AppRunner(app, shutdown_timeout=_THREAD_SHUTDOWN_S)
            await runner.setup()
            site = web.TCPSite(runner, self.host, self.port)
            await site.start()
            return runner

        self._runner = self.call(boot(), timeout)
        self.port = self._runner.addresses[0][1]
        return self.base_url

    def call(self, coro, timeout: float | None = None):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def stop(self, timeout: float = 60.0) -> None:
        if self._runner is not None:
            runner, self._runner = self._runner, None
            self.call(runner.cleanup(), timeout)
        if self._thread.is_alive():
            self.loop.call_soon_threadsafe(self.loop.stop)
            self._thread.join(timeout)
        if not self.loop.is_running():
            self.loop.run_until_complete(self.loop.shutdown_default_executor())
            self.loop.close()
