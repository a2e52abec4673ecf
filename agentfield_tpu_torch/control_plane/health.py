"""Active health monitoring.

The lease sweep (registry.py) only notices *silent* nodes; this monitor
actively probes each active node's /health endpoint and aggregates the MCP
health the agent reports — reference: HealthMonitor.checkAgentHealth
(internal/services/health_monitor.go:190) and checkMCPHealthForNode (:331).
Consecutive probe failures transition the node to INACTIVE through the same
status machinery heartbeats use, so the gateway stops routing to it before
its lease would have expired.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any

from agentfield_tpu_torch.control_plane import http

from agentfield_tpu_torch.control_plane.registry import NodeRegistry
from agentfield_tpu_torch.control_plane.types import NodeStatus
from agentfield_tpu_torch.logging import get_logger

log = get_logger("health")


class HealthMonitor:
    def __init__(
        self,
        registry: NodeRegistry,
        interval: float = 30.0,
        probe_timeout: float = 5.0,
        failure_threshold: int = 3,
        probe_backoff_cap: float = 600.0,
    ):
        self.registry = registry
        self.interval = interval
        self.probe_timeout = probe_timeout
        self.failure_threshold = failure_threshold
        self.probe_backoff_cap = probe_backoff_cap
        self.last_probe: dict[str, dict[str, Any]] = {}  # node_id -> probe doc
        # Per-node probe backoff (capped exponential, like the webhook
        # dispatcher's retry schedule): once a node's failure streak reaches
        # the deactivation threshold, further probes of it space out at 2x,
        # 4x, ... the base interval (capped) instead of hammering it every
        # tick forever. Pre-threshold failures keep the normal cadence —
        # backing off there would only delay legitimate deactivation. The
        # streak survives the deactivate→fence→heartbeat-revive flap cycle
        # and resets only on a probe success.
        self._streak: dict[str, int] = {}  # node_id -> consecutive failures
        self._next_probe: dict[str, float] = {}  # node_id -> earliest next probe
        # node_id -> registered_at of the incarnation the streak belongs to:
        # a deregister/re-register inside one probe interval must not hand
        # the fresh node the dead incarnation's streak and backoff.
        self._incarnation: dict[str, float] = {}
        self._task: asyncio.Task | None = None
        self._session: http.ClientSession | None = None

    def probe_backoff(self, streak: int) -> float:
        """Delay before the next probe after `streak` consecutive failures."""
        return min(self.interval * (2 ** max(streak - 1, 0)), self.probe_backoff_cap)

    async def start(self) -> None:
        self._session = http.ClientSession(
            timeout=http.ClientTimeout(total=self.probe_timeout)
        )
        self._task = asyncio.create_task(self._loop())

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            await asyncio.gather(self._task, return_exceptions=True)
        if self._session:
            await self._session.close()

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.interval)
            try:
                await self.probe_all()
            except asyncio.CancelledError:
                raise
            except Exception:
                self.registry.metrics.inc("health_probe_errors_total")

    async def probe_all(self, at: float | None = None) -> dict[str, bool]:
        all_nodes = await self.registry.db.list_nodes()
        # Prune state for deregistered ids — churn must not grow these maps,
        # and a re-registered id must not inherit a dead incarnation's probe.
        known = {n.node_id for n in all_nodes}
        for stale in set(self.last_probe) | set(self._streak) | set(self._next_probe):
            if stale not in known:
                self.last_probe.pop(stale, None)
                self._streak.pop(stale, None)
                self._next_probe.pop(stale, None)
                self._incarnation.pop(stale, None)
        for node in all_nodes:
            # Same id, NEW registration (registered_at moved): the streak
            # and backoff belong to the dead incarnation — reset them even
            # when the restart happened between two probe ticks.
            if self._incarnation.get(node.node_id) != node.registered_at:
                self._incarnation[node.node_id] = node.registered_at
                self._streak.pop(node.node_id, None)
                self._next_probe.pop(node.node_id, None)
        t = at if at is not None else time.time()
        nodes = [
            n
            for n in all_nodes
            if n.status == NodeStatus.ACTIVE
            and self._next_probe.get(n.node_id, 0.0) <= t  # backed-off: skip
        ]
        results = await asyncio.gather(*(self.probe_one(n) for n in nodes))
        return {n.node_id: ok for n, ok in zip(nodes, results)}

    async def probe_one(self, node) -> bool:
        assert self._session is not None
        doc: dict[str, Any] = {"ts": time.time(), "healthy": False}
        try:
            async with self._session.get(f"{node.base_url.rstrip('/')}/health") as resp:
                body = await resp.json()
                doc["healthy"] = resp.status == 200
                if isinstance(body, dict):
                    doc["mcp"] = body.get("mcp")  # agent-reported MCP summary
        except (http.ClientError, asyncio.TimeoutError, ValueError) as e:
            doc["error"] = repr(e)
        self.last_probe[node.node_id] = doc

        if doc["healthy"]:
            self._streak.pop(node.node_id, None)
            self._next_probe.pop(node.node_id, None)
            return True
        streak = self._streak.get(node.node_id, 0) + 1
        self._streak[node.node_id] = streak
        over = streak - self.failure_threshold + 1  # cycles past the threshold
        if streak >= self.failure_threshold:
            self._next_probe[node.node_id] = doc["ts"] + self.probe_backoff(over)
        # Deactivate at the threshold — and, because the streak survives the
        # flap cycle, on the FIRST failure after a heartbeat revive: a node
        # that already proved unreachable must not get `threshold` fresh
        # strikes of routed traffic every time its own heartbeats revive it.
        if streak >= self.failure_threshold:
            # Same transition machinery heartbeats use — events fire and the
            # gateway stops routing. The fence keeps the agent's own 2s
            # heartbeats from instantly re-activating an unreachable node
            # (flap guard); it GROWS with the streak, tracking the probe
            # backoff, so a flapping node spends the backoff window
            # INACTIVE (unrouted) rather than revived-but-unprobed. After
            # the fence expires a heartbeat revives it and probing resumes.
            try:
                fence_for = max(self.interval * 2, self.probe_backoff(max(over, 1)))
                self.registry.fence(node.node_id, duration=fence_for)
                await self.registry.heartbeat(node.node_id, {"status": "inactive"})
            except Exception as e:
                # The node may have deregistered mid-deactivation — the
                # warning below still fires; record why the fence didn't.
                log.debug(
                    "deactivation fence/heartbeat failed",
                    node_id=node.node_id,
                    error=repr(e),
                )
            self.registry.metrics.inc("health_deactivations_total")
            log.warning(
                "node deactivated by health probe",
                node_id=node.node_id,
                error=doc.get("error"),
            )
        return False
