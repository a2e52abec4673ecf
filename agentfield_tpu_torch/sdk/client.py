"""Control-plane HTTP client: the port's copy of
``agentfield_tpu/sdk/client.py``, on ``control_plane/http.py``'s
``ClientSession`` where the JAX module uses aiohttp (the card's machine has
none). The model node's own blocking client is ``sdk/node_client.py``.

The SDK-side counterpart of the reference's AgentFieldClient
(sdk/python/agentfield/client.py:68: register, execute sync/async, batch
status, heartbeat, graceful shutdown). Async-only — the SDK's
public sync façade wraps it with asyncio.run where needed. The DID/VC calls
reach routes the port's control plane answers with 501 (ROADMAP A7 1):
they raise ControlPlaneError there, as against a JAX control plane without
``cryptography``.
"""

from __future__ import annotations

import asyncio
from typing import Any
from urllib.parse import quote, urlencode

from agentfield_tpu_torch.control_plane import http
from agentfield_tpu_torch.control_plane.http import aio_timeout


class ControlPlaneError(Exception):
    def __init__(self, status: int, message: str, retry_after: float | None = None):
        super().__init__(f"[{status}] {message}")
        self.status = status
        self.message = message
        # Server overload hint (429/503 Retry-After header, delta-seconds):
        # the SDK backpressure loop waits at least this long (capped +
        # jittered) instead of its own blind exponential schedule.
        self.retry_after = retry_after


# Terminal execution statuses, mirroring ExecutionStatus.terminal on the
# control plane (dead_letter: gateway retry budget exhausted on node-level
# failures — docs/FAULT_TOLERANCE.md).
TERMINAL_STATUSES = ("completed", "failed", "timeout", "dead_letter")
# Terminal AND immutable — safe to cache client-side forever. dead_letter
# rows can be requeued by an operator and timeout rows can still gain a
# late-arriving result, so neither may be frozen in the result cache.
CACHEABLE_STATUSES = ("completed", "failed")


class ControlPlaneClient:
    def __init__(self, base_url: str, timeout: float = 600.0):
        self.base_url = base_url.rstrip("/")
        self._timeout = http.ClientTimeout(total=timeout)
        self._session: http.ClientSession | None = None
        from agentfield_tpu_torch.sdk.result_cache import ResultCache

        self._result_cache = ResultCache()

    async def _s(self) -> http.ClientSession:
        if self._session is None or self._session.closed:
            self._session = http.ClientSession(timeout=self._timeout)
        return self._session

    async def close(self) -> None:
        if self._session and not self._session.closed:
            await self._session.close()

    async def _req(self, method: str, path: str, **kw) -> Any:
        s = await self._s()
        async with s.request(method, self.base_url + path, **kw) as resp:
            if resp.status >= 400:
                try:
                    msg = (await resp.json()).get("error", "")
                except Exception:
                    msg = (await resp.text())[:300]
                retry_after = None
                try:
                    ra = resp.headers.get("Retry-After")
                    if ra is not None:
                        retry_after = float(ra)  # delta-seconds form only
                except (TypeError, ValueError):
                    retry_after = None  # HTTP-date form: ignore, use backoff
                raise ControlPlaneError(resp.status, msg, retry_after=retry_after)
            if resp.content_type == "application/json":
                return await resp.json()
            return await resp.text()

    # -- nodes ----------------------------------------------------------

    async def register_node(self, spec: dict[str, Any]) -> dict[str, Any]:
        return await self._req("POST", "/api/v1/nodes", json=spec)

    async def heartbeat(
        self, node_id: str, status: str | None = None, stats: dict[str, Any] | None = None
    ) -> dict[str, Any]:
        body: dict[str, Any] = {}
        if status:
            body["status"] = status
        if stats:
            body["stats"] = stats
        return await self._req("POST", f"/api/v1/nodes/{node_id}/heartbeat", json=body)

    async def deregister_node(self, node_id: str) -> None:
        await self._req("DELETE", f"/api/v1/nodes/{node_id}")

    async def list_nodes(self) -> list[dict[str, Any]]:
        return (await self._req("GET", "/api/v1/nodes"))["nodes"]

    # -- execution ------------------------------------------------------

    async def execute(
        self,
        target: str,
        payload: Any = None,
        headers: dict[str, str] | None = None,
        timeout: float | None = None,
        webhook_url: str | None = None,
        priority: int = 0,
        deadline_s: float | None = None,
        n_branches: int = 1,
        branch_policy=None,
        expect_followup: bool = False,
    ) -> dict[str, Any]:
        body: dict[str, Any] = {"input": payload}
        kw: dict[str, Any] = {}
        if timeout is not None:
            body["timeout"] = timeout
            # The session-wide total would otherwise abort long waits early.
            kw["timeout"] = http.ClientTimeout(total=timeout + 30)
        if webhook_url:
            body["webhook_url"] = webhook_url
        if priority:
            body["priority"] = priority
        if deadline_s is not None:
            body["deadline_s"] = deadline_s
        if n_branches != 1:
            body["n_branches"] = n_branches
        if branch_policy is not None:
            body["branch_policy"] = branch_policy
        if expect_followup:
            # Agent-aware serving hint: the serving node keeps this
            # session's KV warm for the follow-up (a latency hint only).
            body["expect_followup"] = True
        return await self._req(
            "POST", f"/api/v1/execute/{target}", json=body, headers=headers or {}, **kw
        )

    async def execute_async(
        self,
        target: str,
        payload: Any = None,
        headers: dict[str, str] | None = None,
        webhook_url: str | None = None,
        priority: int = 0,
        deadline_s: float | None = None,
        n_branches: int = 1,
        branch_policy=None,
        expect_followup: bool = False,
    ) -> dict[str, Any]:
        body: dict[str, Any] = {"input": payload}
        if webhook_url:
            body["webhook_url"] = webhook_url
        if priority:
            body["priority"] = priority
        if deadline_s is not None:
            body["deadline_s"] = deadline_s
        if n_branches != 1:
            body["n_branches"] = n_branches
        if branch_policy is not None:
            body["branch_policy"] = branch_policy
        if expect_followup:
            # Agent-aware serving hint: the serving node keeps this
            # session's KV warm for the follow-up (a latency hint only).
            body["expect_followup"] = True
        return await self._req(
            "POST", f"/api/v1/execute/async/{target}", json=body, headers=headers or {}
        )

    async def execute_stream(
        self,
        target: str,
        payload: Any = None,
        headers: dict[str, str] | None = None,
        timeout: float = 600.0,
        priority: int = 0,
        deadline_s: float | None = None,
        n_branches: int = 1,
        branch_policy=None,
        expect_followup: bool = False,
    ):
        """Streaming sync execute (`stream=true`): yields the control
        plane's SSE frames as dicts — a `start` frame with the execution id,
        `token` frames from time-to-first-token, then exactly one `terminal`
        frame carrying the execution's final status/result. A `dropped`
        frame means this consumer lagged behind the stream and was detached
        (the execution itself continues and its result is recorded)."""
        import json as _json

        body: dict[str, Any] = {"input": payload, "stream": True}
        if priority:
            body["priority"] = priority
        if deadline_s is not None:
            body["deadline_s"] = deadline_s
        if n_branches != 1:
            body["n_branches"] = n_branches
        if branch_policy is not None:
            body["branch_policy"] = branch_policy
        if expect_followup:
            # Agent-aware serving hint: the serving node keeps this
            # session's KV warm for the follow-up (a latency hint only).
            body["expect_followup"] = True
        if timeout is not None:
            body["timeout"] = timeout
        s = await self._s()
        async with s.post(
            f"{self.base_url}/api/v1/execute/{target}",
            json=body,
            headers=headers or {},
            # sock_read bounds inter-frame gaps, not the whole stream — the
            # server pings every 15s, so 60s of silence means a dead link.
            # timeout=None = deliberately unbounded total (the server's own
            # sync-wait bound owns stream lifetime then).
            timeout=http.ClientTimeout(
                total=timeout + 30 if timeout is not None else None, sock_read=60
            ),
        ) as resp:
            if resp.status >= 400:
                try:
                    msg = (await resp.json()).get("error", "")
                except Exception:
                    msg = (await resp.text())[:300]
                raise ControlPlaneError(resp.status, msg)
            async for line in resp.content:
                if not line.startswith(b"data: "):
                    continue
                frame = _json.loads(line[6:])
                yield frame
                if frame.get("kind") in ("terminal", "dropped"):
                    return

    async def stream_execution(self, execution_id: str, timeout: float = 600.0):
        """Attach to an execution's token stream (GET
        /api/v1/executions/{id}/stream): buffered frames replay from frame
        0, then live frames, then the terminal frame."""
        import json as _json

        s = await self._s()
        async with s.get(
            f"{self.base_url}/api/v1/executions/{execution_id}/stream",
            timeout=http.ClientTimeout(
                total=timeout if timeout is not None else None, sock_read=60
            ),
        ) as resp:
            if resp.status >= 400:
                try:
                    msg = (await resp.json()).get("error", "")
                except Exception:
                    msg = (await resp.text())[:300]
                raise ControlPlaneError(resp.status, msg)
            async for line in resp.content:
                if not line.startswith(b"data: "):
                    continue
                frame = _json.loads(line[6:])
                yield frame
                if frame.get("kind") in ("terminal", "dropped"):
                    return

    async def get_trace(self, execution_id: str) -> dict[str, Any]:
        """The execution's assembled trace waterfall (GET
        /api/v1/executions/{id}/trace, docs/OBSERVABILITY.md): one ordered
        list of spans covering gateway dispatch (every retry/failover
        attempt, attempt-labeled), the channel submit, and the serving
        node's engine lifecycle. Raises ControlPlaneError 404 when tracing
        was off for the execution or the trace aged out of the gateway's
        TTL-bounded store — trace early, the spans are in memory only.
        Never cached: the waterfall can still be accumulating spans when
        the execution row is already terminal."""
        return await self._req("GET", f"/api/v1/executions/{execution_id}/trace")

    async def get_execution(self, execution_id: str) -> dict[str, Any]:
        import copy

        cached = self._result_cache.get(execution_id)
        if cached is not None:
            return copy.deepcopy(cached)  # caller mutations must not poison the cache
        doc = await self._req("GET", f"/api/v1/executions/{execution_id}")
        if doc.get("status") in CACHEABLE_STATUSES:
            self._result_cache.put(execution_id, copy.deepcopy(doc))  # immutable
        return doc

    async def batch_status(self, execution_ids: list[str]) -> dict[str, Any]:
        return (
            await self._req(
                "POST", "/api/v1/executions/batch-status", json={"execution_ids": execution_ids}
            )
        )["executions"]

    async def post_status(
        self, execution_id: str, status: str, result: Any = None, error: str | None = None
    ) -> None:
        """Agent-side completion callback, retried with backoff (the reference
        retries 5x — agent.py:1493-1515)."""
        last: Exception | None = None
        for attempt in range(5):
            try:
                await self._req(
                    "POST",
                    f"/api/v1/executions/{execution_id}/status",
                    json={"status": status, "result": result, "error": error},
                )
                return
            except ControlPlaneError as e:
                if e.status < 500:
                    raise
                last = e
            except http.ClientError as e:
                last = e
            await asyncio.sleep(0.2 * (2**attempt))
        raise last  # type: ignore[misc]

    async def wait_for_execution(
        self, execution_id: str, timeout: float = 600.0, poll_interval: float = 0.05
    ) -> dict[str, Any]:
        """SSE event-stream wait with adaptive-polling fallback (the
        reference's async manager uses the same strategy —
        async_execution_manager.py:644 + :869 batch-poll fallback). The
        timeout budget is shared across both phases — never 2x."""
        t0 = asyncio.get_event_loop().time()
        try:
            return await self._wait_sse(execution_id, timeout)
        except (http.ClientError, TimeoutError, asyncio.TimeoutError):
            pass  # SSE unavailable/raced: fall back to polling
        remaining = timeout - (asyncio.get_event_loop().time() - t0)
        if remaining <= 0:
            raise TimeoutError(f"execution {execution_id} not terminal after {timeout}s")
        return await self._wait_poll(execution_id, remaining, poll_interval)

    async def _wait_sse(self, execution_id: str, timeout: float) -> dict[str, Any]:
        s = await self._s()
        async with aio_timeout(timeout):
            async with s.get(
                self.base_url + "/api/v1/events/executions",
                timeout=http.ClientTimeout(total=timeout),
            ) as resp:
                # The terminal event may predate our subscription: check once
                # AFTER the stream is open so nothing can slip between. A 404
                # is not fatal — the execution may not exist YET (e.g. created
                # by a workflow event moments from now).
                try:
                    doc = await self.get_execution(execution_id)
                    if doc["status"] in TERMINAL_STATUSES:
                        return doc
                except ControlPlaneError as e:
                    if e.status != 404:
                        raise
                import json as _json

                async for line in resp.content:
                    if not line.startswith(b"data: "):
                        continue
                    ev = _json.loads(line[6:])
                    if ev.get("execution_id") == execution_id and ev.get("terminal"):
                        return await self.get_execution(execution_id)
        raise TimeoutError(f"execution {execution_id} not terminal after {timeout}s")

    async def _wait_poll(
        self, execution_id: str, timeout: float, poll_interval: float
    ) -> dict[str, Any]:
        deadline = asyncio.get_event_loop().time() + timeout
        interval = poll_interval
        while True:
            try:
                doc = await self.get_execution(execution_id)
                if doc["status"] in TERMINAL_STATUSES:
                    return doc
            except ControlPlaneError as e:
                if e.status != 404:  # not-yet-created: keep polling
                    raise
            if asyncio.get_event_loop().time() > deadline:
                raise TimeoutError(f"execution {execution_id} not terminal after {timeout}s")
            await asyncio.sleep(interval)
            interval = min(interval * 1.5, 1.0)

    # -- DID / VC -------------------------------------------------------

    async def get_did(self, node_id: str = "org") -> dict[str, Any]:
        return await self._req("GET", f"/api/v1/did/{node_id}")

    async def issue_execution_vc(self, execution_id: str) -> dict[str, Any]:
        return (await self._req("POST", f"/api/v1/vc/executions/{execution_id}"))["vc"]

    async def verify_vc(self, vc: dict[str, Any]) -> dict[str, Any]:
        return await self._req("POST", "/api/v1/vc/verify", json={"vc": vc})

    async def workflow_vc_chain(self, run_id: str) -> dict[str, Any]:
        return await self._req("GET", f"/api/v1/vc/workflows/{run_id}")

    # -- workflow / notes ----------------------------------------------

    async def add_note(self, execution_id: str, note: Any, actor: str | None = None) -> None:
        await self._req(
            "POST",
            f"/api/v1/executions/{execution_id}/notes",
            json={"note": note, "actor": actor},
        )

    async def workflow_dag(self, run_id: str, lightweight: bool = False) -> dict[str, Any]:
        q = "?lightweight=1" if lightweight else ""
        return await self._req("GET", f"/api/v1/workflows/{run_id}/dag{q}")

    async def run_summaries(self, limit: int = 50) -> list[dict[str, Any]]:
        return (await self._req("GET", f"/api/v1/runs?limit={limit}"))["runs"]

    async def post_workflow_event(self, event: dict[str, Any]) -> None:
        await self._req("POST", "/api/v1/workflow/executions/events", json=event)

    # -- memory ---------------------------------------------------------

    def _scope_q(self, scope: str, scope_id: str | None, **extra: str) -> str:
        params = {"scope": scope}
        if scope_id:
            params["scope_id"] = scope_id
        params.update({k: v for k, v in extra.items() if v})
        return "?" + urlencode(params)

    @staticmethod
    def _k(key: str) -> str:
        return quote(key, safe="")

    async def memory_set(
        self, key: str, value: Any, scope: str = "global", scope_id: str | None = None
    ) -> None:
        await self._req(
            "POST", f"/api/v1/memory/{self._k(key)}{self._scope_q(scope, scope_id)}", json={"value": value}
        )

    async def memory_get(
        self, key: str, scope: str = "global", scope_id: str | None = None, default: Any = None
    ) -> Any:
        try:
            return (await self._req("GET", f"/api/v1/memory/{self._k(key)}{self._scope_q(scope, scope_id)}"))[
                "value"
            ]
        except ControlPlaneError as e:
            if e.status == 404:
                return default
            raise

    async def memory_delete(
        self, key: str, scope: str = "global", scope_id: str | None = None
    ) -> bool:
        try:
            await self._req("DELETE", f"/api/v1/memory/{self._k(key)}{self._scope_q(scope, scope_id)}")
            return True
        except ControlPlaneError as e:
            if e.status == 404:
                return False
            raise

    async def memory_list(
        self, scope: str = "global", scope_id: str | None = None, prefix: str = ""
    ) -> dict[str, Any]:
        q = self._scope_q(scope, scope_id, prefix=prefix)
        return (await self._req("GET", f"/api/v1/memory{q}"))["items"]

    async def vector_set(
        self,
        key: str,
        embedding: list[float],
        metadata: dict | None = None,
        scope: str = "global",
        scope_id: str | None = None,
    ) -> None:
        await self._req(
            "POST",
            f"/api/v1/memory/vectors/set{self._scope_q(scope, scope_id)}",
            json={"key": key, "embedding": embedding, "metadata": metadata},
        )

    async def vector_search(
        self,
        embedding: list[float],
        top_k: int = 5,
        metric: str = "cosine",
        scope: str = "global",
        scope_id: str | None = None,
    ) -> list[dict[str, Any]]:
        return (
            await self._req(
                "POST",
                f"/api/v1/memory/vectors/search{self._scope_q(scope, scope_id)}",
                json={"embedding": embedding, "top_k": top_k, "metric": metric},
            )
        )["results"]
