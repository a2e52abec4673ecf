"""Node registry, presence leasing, and status management.

Condenses the reference's three services — node registration handlers
(internal/handlers/nodes.go:363,646), StatusManager state machine
(internal/services/status_manager.go:356,449) and PresenceManager lease
tracking (internal/services/presence_manager.go:68,113) — into one
asyncio-native component: heartbeats refresh a lease; a sweep loop marks
expired nodes inactive and hard-evicts long-gone ones. Lease numbers follow
the reference defaults (TTL 5m, sweep 30s, evict 30m — server.go:131-137).
"""

from __future__ import annotations

import asyncio
import os
from typing import Any

from agentfield_tpu_torch.control_plane import faults
from agentfield_tpu_torch.control_plane.events import EventBus
from agentfield_tpu_torch.control_plane.metrics import Metrics
from agentfield_tpu_torch.control_plane.storage import AsyncStorage, SQLiteStorage
from agentfield_tpu_torch.control_plane.types import (
    AgentNode,
    ComponentMeta,
    NodeStatus,
    now,
)

from agentfield_tpu_torch.logging import get_logger

log = get_logger("registry")

NODE_TOPIC = "nodes"


class RegistryError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class NodeSnapshotCache:
    """Generation-stamped in-memory snapshot of the node table.

    Every gateway dispatch used to re-scan ``agent_nodes`` and JSON-decode
    every row (`list_nodes()` in ``_prepare``/``_pick_node``); this cache
    serves those hot-path reads from memory. Registry write paths —
    register, heartbeat persist, status change (including the node-down
    hook's INACTIVE transitions), deregister/evict, sweep — bump the
    generation, so the next read rebuilds once from storage and then hits
    until the next change. A TTL additionally bounds staleness against
    writers this process cannot observe (a second control-plane instance on
    a shared Postgres, tests poking storage directly).

    Returned ``AgentNode`` objects are SHARED snapshot entries: callers must
    treat them as read-only (the gateway only reads; registry mutations go
    through fresh ``db.get_node`` fetches).

    Knobs: ``AGENTFIELD_REGISTRY_CACHE=0`` disables (every read falls
    through to storage); ``AGENTFIELD_REGISTRY_CACHE_TTL_S`` (default 2.0)
    bounds snapshot age. Hit/miss counters ride the existing metrics →
    Prometheus pipeline (``registry_cache_hits_total`` / ``_misses_total``).
    """

    def __init__(
        self,
        db: AsyncStorage,
        metrics: Metrics | None = None,
        enabled: bool | None = None,
        ttl_s: float | None = None,
        sketch_ttl_s: float | None = None,
    ):
        if enabled is None:
            enabled = os.environ.get("AGENTFIELD_REGISTRY_CACHE", "1").lower() not in (
                "0",
                "false",
                "no",
            )
        if ttl_s is None:
            try:
                ttl_s = float(os.environ.get("AGENTFIELD_REGISTRY_CACHE_TTL_S", "2.0"))
            except ValueError:
                ttl_s = 2.0
        if sketch_ttl_s is None:
            try:
                sketch_ttl_s = float(
                    os.environ.get("AGENTFIELD_PREFIX_SKETCH_TTL_S", "15.0")
                )
            except ValueError:
                sketch_ttl_s = 15.0
        self.enabled = enabled
        self.ttl_s = ttl_s
        # Prefix-sketch staleness bound (docs/PREFIX_CACHING.md "Cluster
        # tier"): a sketch older than this reads as ABSENT, so affinity
        # scoring can never act on a node whose heartbeats stopped — the
        # dispatch fast path degrades to today's load order instead.
        self.sketch_ttl_s = sketch_ttl_s
        self._db = db
        self._metrics = metrics
        self._gen = 0  # bumped by invalidate()
        self._snap_gen = -1  # generation the current snapshot was built at
        self._snap_at = 0.0
        self._by_id: dict[str, AgentNode] = {}
        # Prefix-affinity side table (node_id → (sketch, load, stamped_at)):
        # replaced ATOMICALLY on every sketch-bearing heartbeat — the
        # explicit invalidation path for sketches. Deliberately OUTSIDE the
        # generation-stamped node snapshot: sketches change every heartbeat
        # and must not force node-table rebuilds, and they live only in this
        # process (a second gateway instance simply routes without affinity
        # until its own heartbeats arrive).
        self._sketches: dict[str, tuple[dict, float, float]] = {}
        # Pool-capacity side table (node_id → (free_pages, load, stamped_at)):
        # same lifecycle/TTL discipline as sketches, but fed from EVERY
        # stats-bearing heartbeat (sketch-less nodes included) — phase-2
        # decode placement scores candidates by it, and a stale entry reads
        # as absent so the picker degrades to plain round-robin.
        self._pool_stats: dict[str, tuple[float, float, float]] = {}
        self._rebuild_lock = asyncio.Lock()

    @property
    def generation(self) -> int:
        return self._gen

    def invalidate(self) -> None:
        self._gen += 1

    def _count(self, name: str) -> None:
        if self._metrics is not None:
            self._metrics.inc(name)

    def _fresh(self) -> bool:
        return self._snap_gen == self._gen and now() - self._snap_at <= self.ttl_s

    async def _snapshot(self) -> dict[str, AgentNode]:
        if self._fresh():
            self._count("registry_cache_hits_total")
            return self._by_id
        async with self._rebuild_lock:
            if self._fresh():  # a concurrent rebuild landed while we waited
                self._count("registry_cache_hits_total")
                return self._by_id
            # Stamp the generation BEFORE the read: an invalidation racing
            # the list_nodes() fetch must force another rebuild, never be
            # masked by this one.
            gen = self._gen
            nodes = await self._db.list_nodes()
            self._by_id = {n.node_id: n for n in nodes}
            self._snap_gen = gen
            self._snap_at = now()
            self._count("registry_cache_misses_total")
            return self._by_id

    async def get(self, node_id: str) -> AgentNode | None:
        if not self.enabled:
            self._count("registry_cache_misses_total")
            return await self._db.get_node(node_id)
        return (await self._snapshot()).get(node_id)

    async def list(self) -> list[AgentNode]:
        if not self.enabled:
            self._count("registry_cache_misses_total")
            return await self._db.list_nodes()
        return list((await self._snapshot()).values())

    # -- prefix-affinity side table (docs/PREFIX_CACHING.md "Cluster tier")

    def put_sketch(self, node_id: str, sketch: dict, load: float = 0.0) -> None:
        """Install a node's heartbeat prefix sketch + load sample. The whole
        entry is replaced in one assignment, so a reader can never observe a
        half-updated (sketch, load) pair."""
        self._sketches[node_id] = (sketch, float(load), now())

    def get_sketch(self, node_id: str) -> tuple[dict, float] | None:
        """(sketch, load) when a fresh one exists; None past
        ``sketch_ttl_s`` — stale sketches are never served (the affinity
        scorer then treats the node as advertising nothing)."""
        entry = self._sketches.get(node_id)
        if entry is None:
            return None
        sketch, load, at = entry
        if now() - at > self.sketch_ttl_s:
            return None
        return sketch, load

    def drop_sketch(self, node_id: str) -> None:
        self._sketches.pop(node_id, None)
        self._pool_stats.pop(node_id, None)

    # -- pool-capacity side table (phase-2 decode placement) --

    def put_pool_stats(self, node_id: str, free_pages: float, load: float) -> None:
        self._pool_stats[node_id] = (float(free_pages), float(load), now())

    def get_pool_stats(self, node_id: str) -> tuple[float, float] | None:
        """(free_pages, load) when heartbeat-fresh; None past
        ``sketch_ttl_s`` — a node whose heartbeats stopped must not keep
        winning placement on its last good capacity sample."""
        entry = self._pool_stats.get(node_id)
        if entry is None:
            return None
        free_pages, load, at = entry
        if now() - at > self.sketch_ttl_s:
            return None
        return free_pages, load


class NodeRegistry:
    def __init__(
        self,
        storage: SQLiteStorage,
        bus: EventBus,
        metrics: Metrics,
        heartbeat_ttl: float = 300.0,
        sweep_interval: float = 30.0,
        evict_after: float = 1800.0,
        did_service=None,
        db=None,  # shared AsyncStorage facade (built if absent)
        cache_enabled: bool | None = None,  # None → $AGENTFIELD_REGISTRY_CACHE
        cache_ttl_s: float | None = None,  # None → $AGENTFIELD_REGISTRY_CACHE_TTL_S
    ):
        self.storage = storage
        self.db = db if db is not None else AsyncStorage(storage)
        self.bus = bus
        self.metrics = metrics
        # Dispatch fast path: the gateway resolves nodes from this snapshot
        # instead of re-scanning SQLite per request; every registry write
        # below invalidates it.
        self.cache = NodeSnapshotCache(
            self.db, metrics, enabled=cache_enabled, ttl_s=cache_ttl_s
        )
        self.did_service = did_service
        self.heartbeat_ttl = heartbeat_ttl
        self.sweep_interval = sweep_interval
        self.evict_after = evict_after
        self._sweeper: asyncio.Task | None = None
        # In-memory heartbeat cache: storage writes are throttled so a 2s
        # heartbeat cadence doesn't hammer SQLite (the reference caches
        # heartbeats in memory for the same reason, nodes.go:290).
        self._last_persist: dict[str, float] = {}
        # Health fences: while fenced, plain heartbeats may NOT auto-revive
        # an INACTIVE node (prevents probe-deactivate / heartbeat-reactivate
        # flapping for nodes whose advertised URL is unreachable).
        self._fences: dict[str, float] = {}  # node_id -> fence expiry
        # Node-down hooks: fired (async, fire-and-forget) whenever a node
        # leaves ACTIVE for INACTIVE or is deregistered — the gateway hangs
        # its orphan requeue here so a dead node's in-flight executions
        # re-dispatch immediately instead of riding out sync_wait_timeout.
        self._node_down_cbs: list[Any] = []
        self._cb_tasks: set[asyncio.Task] = set()

    async def start(self) -> None:
        self._sweeper = asyncio.create_task(self._sweep_loop())

    async def stop(self) -> None:
        if self._sweeper:
            self._sweeper.cancel()
            await asyncio.gather(self._sweeper, return_exceptions=True)
        if self._cb_tasks:  # let in-flight node-down hooks settle
            await asyncio.gather(*list(self._cb_tasks), return_exceptions=True)

    # ------------------------------------------------------------------

    async def register(self, payload: dict[str, Any]) -> AgentNode:
        """Idempotent registration: re-registering an existing node refreshes
        its components and lease (the reference treats re-registration the
        same way, nodes.go:363)."""
        node_id = payload.get("node_id")
        base_url = payload.get("base_url")
        if not node_id or not isinstance(node_id, str):
            raise RegistryError(400, "node_id is required")
        if "." in node_id:
            raise RegistryError(400, "node_id must not contain '.' (target separator)")
        if not base_url or not isinstance(base_url, str) or not base_url.startswith("http"):
            raise RegistryError(400, "base_url must be an http(s) URL")

        def comps(kind: str) -> list[ComponentMeta]:
            out = []
            for c in payload.get(kind + "s", []):
                if isinstance(c, str):
                    c = {"id": c}
                if not isinstance(c, dict) or not c.get("id"):
                    raise RegistryError(400, f"each {kind} needs an 'id' (got {c!r})")
                out.append(
                    ComponentMeta(
                        id=c["id"],
                        node_id=node_id,
                        kind=kind,
                        description=c.get("description", ""),
                        input_schema=c.get("input_schema", {}),
                        output_schema=c.get("output_schema", {}),
                    )
                )
            return out

        node = AgentNode(
            node_id=node_id,
            base_url=base_url,
            status=NodeStatus.ACTIVE,
            kind=payload.get("kind", "agent"),
            reasoners=comps("reasoner"),
            skills=comps("skill"),
            metadata=payload.get("metadata", {}),
        )
        if self.did_service is not None:
            # Mint the identity tree on registration (reference: nodes.go
            # registration mints node + component DIDs via DIDService).
            node.did = self.did_service.node_did(node_id)
            for comp in node.reasoners + node.skills:
                comp.did = self.did_service.component_did(node_id, comp.id)
        await self.db.upsert_node(node)
        self.cache.invalidate()
        self._last_persist[node_id] = now()
        self.metrics.inc("nodes_registered_total")
        self.bus.publish(NODE_TOPIC, {"type": "registered", "node_id": node_id, "ts": now()})
        return node

    def on_node_down(self, cb) -> None:
        """Register an async callback(node_id, reason) fired when a node
        transitions ACTIVE→INACTIVE (sweep, health probe, explicit status)
        or is deregistered/evicted."""
        self._node_down_cbs.append(cb)

    def _fire_node_down(self, node_id: str, reason: str) -> None:
        for cb in self._node_down_cbs:

            async def run(cb=cb):
                try:
                    await cb(node_id, reason)
                except Exception:  # a broken hook must not break the sweep
                    self.metrics.inc("node_down_hook_errors_total")

            task = asyncio.create_task(run())
            self._cb_tasks.add(task)
            task.add_done_callback(self._cb_tasks.discard)

    async def heartbeat(self, node_id: str, data: dict[str, Any] | None = None) -> AgentNode:
        node = await self.db.get_node(node_id)
        if node is None:
            raise RegistryError(404, f"unknown node {node_id!r}; re-register")
        if faults.fire("registry.heartbeat.drop") is not None:
            # Chaos: the heartbeat is "lost in transit" — the lease is not
            # refreshed, so a sustained drop schedule makes the node look
            # silent to the sweep without touching the node process.
            self.metrics.inc("heartbeats_dropped_injected_total")
            return node
        node.last_heartbeat = now()
        requested = (data or {}).get("status")
        # Enhanced heartbeats may carry live node stats (e.g. a model node's
        # engine counters — reference: enhanced heartbeat payload,
        # agent_field_handler.py:459); surfaced via node metadata.
        stats = (data or {}).get("stats")
        if isinstance(stats, dict):
            # Prefix-affinity routing (docs/PREFIX_CACHING.md "Cluster
            # tier"): a sketch-bearing heartbeat replaces the node's entry
            # in the cache's side table NOW — the explicit invalidation the
            # dispatch fast path relies on (a sketch is never served past
            # sketch_ttl_s either way). Popped before metadata persistence:
            # the sketch is a routing signal, not node state, and a
            # several-KB digest list must not ride every node-table row.
            sketch = stats.pop("prefix_sketch", None)
            load = 0.0
            for k in ("active_slots", "pending_requests"):
                v = stats.get(k)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    load += v
            if isinstance(sketch, dict):
                self.cache.put_sketch(node_id, sketch, load)
            # Pool-aware phase-2 placement: every stats-bearing heartbeat
            # refreshes the node's capacity sample (free KV pages + load),
            # sketch or no sketch — decode-pool nodes skip prefix sketches
            # entirely but still need scoring.
            fp = stats.get("free_pages")
            if isinstance(fp, (int, float)) and not isinstance(fp, bool):
                self.cache.put_pool_stats(node_id, fp, load)
            # Engine latency histograms (docs/OBSERVABILITY.md): popped off
            # the stats like the sketch (a multi-bucket block must not ride
            # every node-table row) and re-published as REAL per-node
            # Prometheus histogram series — TTFT/ITL/queue-wait/tick
            # distributions, fleet-wide, from one control-plane scrape.
            latency_hist = stats.pop("latency_hist", None)
            node.metadata["stats"] = stats
            # Re-export the node's engine counters (prefix-cache hit/miss/
            # eviction/shared-page among them) as per-node /metrics gauges so
            # one Prometheus scrape of the control plane covers the fleet.
            from agentfield_tpu_torch.control_plane.metrics import (
                export_engine_histograms,
                export_engine_stats,
            )

            export_engine_stats(self.metrics, node_id, stats)
            if isinstance(latency_hist, dict):
                export_engine_histograms(self.metrics, node_id, latency_hist)
        old_status = node.status
        if requested is not None:
            try:
                new_status = NodeStatus(requested)
            except ValueError:  # afcheck: caller-error invalid status value is the heartbeater's bug — a 400, not a rung
                raise RegistryError(
                    400, f"invalid status {requested!r}; one of {[s.value for s in NodeStatus]}"
                ) from None
        else:
            new_status = NodeStatus.ACTIVE
            if node.status == NodeStatus.INACTIVE and self.is_fenced(node_id):
                new_status = NodeStatus.INACTIVE  # health-fenced: stay down
        if NodeStatus.valid_transition(node.status, new_status):
            if node.status != new_status:
                self._publish_status(node.node_id, node.status, new_status)
            node.status = new_status
        # Throttled persistence: immediately on any actual status change (events
        # and storage must not diverge), else at most every 10s — a 2s heartbeat
        # cadence must not hammer SQLite. The lease check tolerates the
        # staleness (TTL is 300s >> 10s).
        if node.status != old_status or now() - self._last_persist.get(node_id, 0) > 10.0:
            await self.db.upsert_node(node)
            self.cache.invalidate()
            self._last_persist[node_id] = now()
        return node

    def fence(self, node_id: str, duration: float) -> None:
        self._fences[node_id] = now() + duration

    def is_fenced(self, node_id: str) -> bool:
        exp = self._fences.get(node_id)
        if exp is None:
            return False
        if exp < now():
            del self._fences[node_id]
            return False
        return True

    async def deregister(self, node_id: str) -> bool:
        ok = await self.db.delete_node(node_id)
        if ok:
            self.cache.invalidate()
            self.cache.drop_sketch(node_id)
            self._last_persist.pop(node_id, None)
            self._fences.pop(node_id, None)
            # a dead node's engine gauges must not linger in /metrics
            self.metrics.remove_gauges({"node": node_id})
            self.bus.publish(NODE_TOPIC, {"type": "deregistered", "node_id": node_id, "ts": now()})
            self._fire_node_down(node_id, "deregistered")
        return ok

    def _publish_status(self, node_id: str, old: NodeStatus, new: NodeStatus) -> None:
        log.info("node status changed", node_id=node_id, old=old.value, new=new.value)
        self.bus.publish(
            NODE_TOPIC,
            {
                "type": "status_changed",
                "node_id": node_id,
                "old": old.value,
                "new": new.value,
                "ts": now(),
            },
        )
        if new == NodeStatus.INACTIVE and old != NodeStatus.INACTIVE:
            # ONE choke point for "this node is gone": lease-expiry sweep,
            # health-probe deactivation and explicit status heartbeats all
            # pass through here. STOPPING is deliberately excluded — a
            # draining node finishes its in-flight work itself.
            self._fire_node_down(node_id, f"status {old.value} -> inactive")

    # ------------------------------------------------------------------

    async def sweep_once(self, at: float | None = None) -> dict[str, int]:
        """Expire leases: TTL → inactive; hard evict after `evict_after`
        (reference: PresenceManager.checkExpirations, presence_manager.go:113)."""
        t = at or now()
        marked = evicted = active = 0
        by_role = {"prefill": 0, "decode": 0, "mixed": 0}
        for node in await self.db.list_nodes():  # single pass; gauge derived inline
            age = t - node.last_heartbeat
            if age > self.evict_after:
                await self.deregister(node.node_id)
                evicted += 1
            elif age > self.heartbeat_ttl and node.status == NodeStatus.ACTIVE:
                self._publish_status(node.node_id, node.status, NodeStatus.INACTIVE)
                node.status = NodeStatus.INACTIVE
                await self.db.upsert_node(node)
                self.cache.invalidate()
                marked += 1
            elif node.status == NodeStatus.ACTIVE:
                active += 1
                role = str((node.metadata or {}).get("role") or "mixed")
                by_role[role if role in by_role else "mixed"] += 1
        self.metrics.set_gauge("nodes_active", active)
        for role, n in by_role.items():
            # Always publish all three roles (zeros included) so operators can
            # alert on "decode pool empty" without absent-series ambiguity.
            self.metrics.set_gauge("nodes_by_role", float(n), labels={"role": role})
        return {"marked_inactive": marked, "evicted": evicted}

    async def _sweep_loop(self) -> None:
        while True:
            await asyncio.sleep(self.sweep_interval)
            try:
                await self.sweep_once()
            except Exception:  # pragma: no cover - sweep must never die
                self.metrics.inc("sweep_errors_total")
