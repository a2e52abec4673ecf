"""Memory change-event subscriptions (``agentfield_tpu/sdk/memory_events.py``):
not ported yet. They ride the control plane's
``/api/v1/memory/events/ws``, which waits for ROADMAP A7 7; the client
raises NotImplementedError naming it."""

from __future__ import annotations


class MemoryEventClient:
    def __init__(self, base_url: str, reconnect_delay: float = 1.0, max_delay: float = 30.0):
        raise NotImplementedError(
            "MemoryEventClient is not ported: it waits for ROADMAP A7 7 "
            "(/api/v1/memory/events/ws)")
