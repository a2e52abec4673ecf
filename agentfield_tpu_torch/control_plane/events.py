"""In-process event buses.

Same role as the reference's generic EventBus[T]
(internal/events/event_bus.go:6-57): subscribe/publish fan-out with
non-blocking drop on slow consumers, feeding SSE/WS streams and the sync
gateway's wait-for-completion path. asyncio-native: each subscriber is a
bounded asyncio.Queue; publish never awaits.
"""

from __future__ import annotations

import asyncio

import collections
from typing import Any, AsyncIterator

from agentfield_tpu_torch.control_plane.http import aio_timeout


class EventBus:
    def __init__(self, maxsize: int = 256, history: int = 0, metrics=None):
        self._subs: dict[str, set[asyncio.Queue]] = collections.defaultdict(set)
        self._maxsize = maxsize
        self._history: collections.deque | None = (
            collections.deque(maxlen=history) if history else None
        )
        self.dropped = 0
        # Drops are counted PER TOPIC (a slow SSE consumer on "executions"
        # and a slow one on "memory" are different operational problems),
        # and exported as ``events_dropped_total{topic=...}`` when a metrics
        # registry is attached — a silent swallow was invisible to operators.
        self.dropped_by_topic: collections.Counter[str] = collections.Counter()
        self._metrics = metrics

    def publish(self, topic: str, event: Any) -> None:
        """Non-blocking publish; slow subscribers drop events (the reference
        makes the same tradeoff — event_bus.go:42-55 drops on full channel)."""
        if self._history is not None:
            self._history.append((topic, event))
        for q in list(self._subs.get(topic, ())) + list(self._subs.get("*", ())):
            try:
                q.put_nowait((topic, event))
            except asyncio.QueueFull:
                self.dropped += 1
                self.dropped_by_topic[topic] += 1
                if self._metrics is not None:
                    self._metrics.inc("events_dropped_total", labels={"topic": topic})

    def subscribe(self, topic: str = "*") -> asyncio.Queue:
        q: asyncio.Queue = asyncio.Queue(maxsize=self._maxsize)
        self._subs[topic].add(q)
        return q

    def unsubscribe(self, topic: str, q: asyncio.Queue) -> None:
        self._subs.get(topic, set()).discard(q)

    def history(self) -> list[tuple[str, Any]]:
        return list(self._history or ())

    async def stream(self, topic: str = "*") -> AsyncIterator[Any]:
        q = self.subscribe(topic)
        try:
            while True:
                _, ev = await q.get()
                yield ev
        finally:
            self.unsubscribe(topic, q)

    async def wait_for(self, topic: str, predicate, timeout: float | None = None) -> Any:
        """Block until an event on `topic` satisfies `predicate` (the sync
        gateway's completion-wait — reference: waitForExecutionCompletion,
        execute.go:568)."""
        q = self.subscribe(topic)
        try:
            async with aio_timeout(timeout):
                while True:
                    _, ev = await q.get()
                    if predicate(ev):
                        return ev
        finally:
            self.unsubscribe(topic, q)
