"""Memory change-event subscriptions over WebSocket: the port's copy of
``agentfield_tpu/sdk/memory_events.py`` on ``control_plane/http.py``'s
WebSocket client where the JAX module uses aiohttp's.

Parity with the reference's MemoryEventClient (sdk/python/agentfield/
memory_events.py:79: WS client to /api/v1/memory/events/ws, glob pattern
matching, auto-reconnect, subscription registry).
"""

from __future__ import annotations

import asyncio
import fnmatch
from typing import Any, Awaitable, Callable

from agentfield_tpu_torch.control_plane import http
from agentfield_tpu_torch.logging import get_logger

log = get_logger("sdk.memory_events")

Handler = Callable[[dict[str, Any]], Awaitable[None] | None]


class MemoryEventClient:
    def __init__(self, base_url: str, reconnect_delay: float = 1.0, max_delay: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.reconnect_delay = reconnect_delay
        self.max_delay = max_delay
        self._subs: list[tuple[str, str | None, Handler]] = []  # (pattern, scope, fn)
        self._task: asyncio.Task | None = None
        self.connected = False

    def on_change(self, pattern: str = "*", handler: Handler | None = None, scope: str | None = None):
        """Subscribe a handler to keys matching a glob pattern; usable as a
        decorator: ``@events.on_change("user_*")``."""

        def register(fn: Handler) -> Handler:
            self._subs.append((pattern, scope, fn))
            return fn

        return register(handler) if handler is not None else register

    async def start(self) -> None:
        self._task = asyncio.create_task(self._run())

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            await asyncio.gather(self._task, return_exceptions=True)
        self.connected = False

    async def _run(self) -> None:
        delay = self.reconnect_delay
        while True:
            try:
                # Explicit timeout: the WS read itself must stay unbounded
                # (events are sparse; heartbeat=20 owns liveness) but
                # connect must never hang the reconnect loop.
                async with http.ClientSession(
                    timeout=http.ClientTimeout(total=None, connect=10, sock_connect=10)
                ) as s:
                    ws = await s.ws_connect(
                        f"{self.base_url}/api/v1/memory/events/ws", heartbeat=20
                    )
                    try:
                        self.connected = True
                        delay = self.reconnect_delay  # healthy: reset backoff
                        async for msg in ws:
                            if msg.type != http.WSMsgType.TEXT:
                                continue
                            await self._dispatch(msg.json())
                    finally:
                        await ws.close()
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # fall through to reconnect with backoff
                log.debug("memory event stream dropped", error=repr(e))
            self.connected = False
            await asyncio.sleep(delay)
            delay = min(delay * 2, self.max_delay)

    async def _dispatch(self, ev: dict[str, Any]) -> None:
        key = ev.get("key", "")
        scope = ev.get("scope")
        for pattern, want_scope, fn in self._subs:
            if want_scope is not None and scope != want_scope:
                continue
            if not fnmatch.fnmatch(key, pattern):
                continue
            try:
                out = fn(ev)
                if asyncio.iscoroutine(out):
                    await out
            except Exception as e:
                # one bad handler must not break the stream
                log.debug(
                    "memory event handler failed",
                    pattern=pattern, key=key, error=repr(e),
                )
