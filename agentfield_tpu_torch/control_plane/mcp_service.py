"""Control-plane-side MCP manager: server configs, process supervision,
capability discovery with caching, logs, and skill generation. The port's
copy of ``agentfield_tpu/control_plane/mcp_service.py``, over the port's
``sdk/mcp.py``; the behaviour is the JAX module's.

Capability parity with the reference's internal/mcp package —
MCPManager.Add/Start/Stop/Remove/Restart/Status/Logs (manager.go:37-328),
ProcessManager.MonitorProcess auto-restart (process.go:155), and
CapabilityDiscovery.DiscoverCapabilities/CacheCapabilities
(capability_discovery.go:46,306) — re-designed for the asyncio control
plane: supervision is a per-server watchdog task over the SDK's stdio
JSON-RPC client (no duplicate protocol stack), and capability manifests
cache in the storage kv_config table instead of loose JSON files.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Any

from agentfield_tpu_torch.sdk.mcp import MCPError, MCPStdioClient

_CONFIG_KEY = "mcp.servers"  # persisted spec map {alias: spec}
_CACHE_PREFIX = "mcp.capabilities."  # + alias → {tools, resources, ts}


class MCPServiceError(Exception):
    pass


@dataclass
class MCPServerSpec:
    alias: str
    command: str
    args: list[str] = field(default_factory=list)
    env: dict[str, str] = field(default_factory=dict)
    autostart: bool = False

    def to_doc(self) -> dict[str, Any]:
        return {
            "alias": self.alias,
            "command": self.command,
            "args": self.args,
            "env": self.env,
            "autostart": self.autostart,
        }

    @classmethod
    def from_doc(cls, doc: dict[str, Any]) -> "MCPServerSpec":
        return cls(
            alias=doc["alias"],
            command=doc["command"],
            args=list(doc.get("args") or []),
            env=dict(doc.get("env") or {}),
            autostart=bool(doc.get("autostart", False)),
        )


class _Managed:
    """One supervised server: the live client plus watchdog state."""

    def __init__(self, spec: MCPServerSpec):
        self.spec = spec
        self.client: MCPStdioClient | None = None
        self.watchdog: asyncio.Task | None = None
        self.state = "stopped"  # stopped | running | failed | restarting
        self.restarts = 0
        self.last_error: str | None = None
        self.started_at: float | None = None
        self.stopping = False
        # capability-manifest summary mirrored from the storage cache, so the
        # UI-polled status() never touches SQLite
        self.tools = 0
        self.resources = 0
        self.capabilities_ts: float | None = None


class MCPService:
    """Owns MCP server processes on behalf of the control plane.

    Supervision contract: a crashed server is restarted with linear backoff
    up to ``max_restarts`` times (reference: MonitorProcess's onExit restart,
    process.go:155-183); exhausting the budget parks it in state=failed with
    the last stderr captured for the logs endpoint.
    """

    def __init__(self, storage, max_restarts: int = 3, restart_backoff: float = 0.5,
                 capability_ttl: float = 300.0, log_lines: int = 200, db=None):
        from agentfield_tpu_torch.control_plane.storage import AsyncStorage

        self.storage = storage
        self.db = db if db is not None else AsyncStorage(storage)
        self.max_restarts = max_restarts
        self.restart_backoff = restart_backoff
        self.capability_ttl = capability_ttl
        self.log_lines = log_lines
        self._servers: dict[str, _Managed] = {}
        for doc in (storage.config_get(_CONFIG_KEY) or {}).values():
            spec = MCPServerSpec.from_doc(doc)
            m = _Managed(spec)
            self._apply_manifest(m, storage.config_get(_CACHE_PREFIX + spec.alias))
            self._servers[spec.alias] = m

    @staticmethod
    def _apply_manifest(m: _Managed, manifest: dict | None) -> None:
        if manifest:
            m.tools = len(manifest.get("tools", []))
            m.resources = len(manifest.get("resources", []))
            m.capabilities_ts = manifest.get("ts")

    # ---- config -----------------------------------------------------------

    def _persist(self) -> None:
        self.storage.config_set(
            _CONFIG_KEY, {a: m.spec.to_doc() for a, m in self._servers.items()}
        )

    def add(self, spec: MCPServerSpec) -> None:
        if spec.alias in self._servers:
            raise MCPServiceError(f"server {spec.alias!r} already exists")
        if not spec.alias or not spec.command:
            raise MCPServiceError("alias and command are required")
        self._servers[spec.alias] = _Managed(spec)
        self._persist()

    async def remove(self, alias: str) -> None:
        m = self._get(alias)
        await self.stop(alias)
        del self._servers[alias]
        await self.db.config_set(_CACHE_PREFIX + alias, None)
        self._persist()

    def _get(self, alias: str) -> _Managed:
        m = self._servers.get(alias)
        if m is None:
            raise MCPServiceError(f"unknown MCP server {alias!r}")
        return m

    # ---- lifecycle --------------------------------------------------------

    async def start_autostart(self) -> None:
        for alias, m in self._servers.items():
            if m.spec.autostart and m.state != "running":
                try:
                    await self.start(alias)
                except MCPServiceError:
                    pass  # recorded in last_error; operator sees it in status

    async def start(self, alias: str) -> None:
        m = self._get(alias)
        if m.state == "running":
            return
        if m.watchdog and not m.watchdog.done():
            # A crashed server's watchdog may be sleeping out its restart
            # backoff; left alive it would respawn a SECOND, unsupervised
            # process after this start() installs its own.
            m.watchdog.cancel()
            await asyncio.gather(m.watchdog, return_exceptions=True)
            m.watchdog = None
        m.stopping = False
        m.restarts = 0
        await self._spawn(m)

    async def _spawn(self, m: _Managed) -> None:
        client = MCPStdioClient(
            m.spec.command, m.spec.args, m.spec.env or None,
            capture_stderr=self.log_lines,
        )
        try:
            await client.start()
        except asyncio.CancelledError:
            # shutdown/disconnect raced the spawn: the child is already
            # running — it must not outlive its supervisor unsupervised
            await asyncio.shield(client.stop())
            raise
        except Exception as e:
            m.state = "failed"
            m.last_error = str(e)
            # keep whatever stderr the doomed process produced for logs()
            m.client = client
            await client.stop()
            raise MCPServiceError(f"failed to start {m.spec.alias!r}: {e}") from e
        m.client = client
        m.state = "running"
        m.last_error = None
        m.started_at = time.time()
        m.watchdog = asyncio.create_task(self._watch(m))

    async def _watch(self, m: _Managed) -> None:
        proc = m.client._proc if m.client else None
        if proc is None:
            return
        rc = await proc.wait()
        if m.stopping:
            return
        m.last_error = f"exited rc={rc}"
        if m.restarts >= self.max_restarts:
            m.state = "failed"
            return
        m.restarts += 1
        m.state = "restarting"
        await asyncio.sleep(self.restart_backoff * m.restarts)
        if m.stopping:  # stop() raced the backoff sleep
            m.state = "stopped"
            return
        try:
            await self._spawn(m)
        except MCPServiceError:
            pass  # state=failed + last_error already set by _spawn

    async def stop(self, alias: str) -> None:
        m = self._get(alias)
        m.stopping = True
        if m.watchdog:
            m.watchdog.cancel()
            await asyncio.gather(m.watchdog, return_exceptions=True)
            m.watchdog = None
        if m.client:
            await m.client.stop()
        m.state = "stopped"

    async def restart(self, alias: str) -> None:
        await self.stop(alias)
        await self.start(alias)

    async def stop_all(self) -> None:
        for alias in list(self._servers):
            await self.stop(alias)

    # ---- introspection ----------------------------------------------------

    def status(self) -> list[dict[str, Any]]:
        out = []
        for alias, m in sorted(self._servers.items()):
            proc = m.client._proc if m.client else None
            out.append(
                {
                    "alias": alias,
                    "command": m.spec.command,
                    "args": m.spec.args,
                    "autostart": m.spec.autostart,
                    "state": m.state,
                    "pid": proc.pid if proc and proc.returncode is None else None,
                    "restarts": m.restarts,
                    "last_error": m.last_error,
                    "started_at": m.started_at,
                    "server_info": m.client.server_info if m.client else {},
                    "tools": m.tools,
                    "resources": m.resources,
                    "capabilities_ts": m.capabilities_ts,
                }
            )
        return out

    def logs(self, alias: str, lines: int = 50) -> list[str]:
        m = self._get(alias)
        if not m.client or lines <= 0:
            return []
        return list(m.client.stderr_lines)[-lines:]

    # ---- capability discovery --------------------------------------------

    async def discover(self, alias: str, refresh: bool = False) -> dict[str, Any]:
        """Tools+resources manifest. Serves the storage-cached manifest while
        fresh (TTL) unless refresh=True; live discovery requires the server
        to be running and re-caches on success."""
        m = self._get(alias)
        cached = await self.db.config_get(_CACHE_PREFIX + alias)
        if (
            not refresh
            and cached
            and time.time() - cached.get("ts", 0) < self.capability_ttl
        ):
            return cached
        if m.state != "running" or m.client is None:
            if cached:
                return cached  # stale beats nothing for a stopped server
            raise MCPServiceError(f"server {alias!r} is not running (state={m.state})")
        try:
            tools = await m.client.list_tools()
            resources = await m.client.list_resources()
        except MCPError as e:
            raise MCPServiceError(f"discovery on {alias!r} failed: {e}") from e
        manifest = {"alias": alias, "tools": tools, "resources": resources, "ts": time.time()}
        await self.db.config_set(_CACHE_PREFIX + alias, manifest)
        self._apply_manifest(m, manifest)
        return manifest

    async def generate_skills(self, alias: str) -> str:
        """Emit the typed skill-stub module for this server's tools
        (reference: MCPManager.GenerateSkills, manager.go:763)."""
        from agentfield_tpu_torch.sdk.mcp import generate_skill_file

        manifest = await self.discover(alias)
        return generate_skill_file(alias, manifest.get("tools", []))

    def health_summary(self) -> dict[str, Any]:
        """Aggregated health for UI/health endpoints (reference: MCP health
        aggregation per node, health_monitor.go:331)."""
        states = [m.state for m in self._servers.values()]
        return {
            "total": len(states),
            "running": states.count("running"),
            "failed": states.count("failed"),
            "servers": {a: m.state for a, m in self._servers.items()},
        }
