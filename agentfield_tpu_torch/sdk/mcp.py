"""MCP (Model Context Protocol) integration: the port's copy of
``agentfield_tpu/sdk/mcp.py`` on the standard library (the JAX module is
already asyncio and json only). One difference: the skill module that
``generate_skill_file`` writes imports ``agentfield_tpu_torch.sdk.mcp``
where the JAX one's imports ``agentfield_tpu.sdk.mcp``; the rest of its
text is the JAX module's.

Capability parity with the reference's MCP stack — stdio servers spoken to
over JSON-RPC (sdk/python/agentfield/mcp_stdio_bridge.py:24), client with
initialize/tools-list/tools-call (mcp_client.py:9), config discovery from
.mcp.json (mcp_manager.py:42), and every discovered tool auto-registered as
an agent skill (dynamic_skills.py:33) — condensed: asyncio subprocesses speak
newline-delimited JSON-RPC directly (no local HTTP bridge process needed; the
reference's bridge exists because its stack was threaded FastAPI).
"""

from __future__ import annotations

import asyncio
import json
from collections import deque
from pathlib import Path
from typing import Any

from agentfield_tpu_torch.control_plane.http import aio_timeout


class MCPError(Exception):
    pass


class MCPStdioClient:
    """JSON-RPC 2.0 over a child process's stdio (MCP stdio transport:
    one JSON message per line). Request ids correlate concurrent calls."""

    def __init__(
        self,
        command: str,
        args: list[str] | None = None,
        env: dict | None = None,
        capture_stderr: int = 0,  # >0 → keep the last N stderr lines (CP logs)
    ):
        self.command = command
        self.args = args or []
        self.env = env
        self._proc: asyncio.subprocess.Process | None = None
        self._pending: dict[int, asyncio.Future] = {}
        self._next_id = 0
        self._reader: asyncio.Task | None = None
        self._stderr_reader: asyncio.Task | None = None
        self._capture_stderr = capture_stderr
        self.stderr_lines: "deque[str]" = deque(maxlen=max(capture_stderr, 1))
        self._dead: str | None = None  # set when the reader exits; fail fast
        self.server_info: dict[str, Any] = {}

    async def start(self) -> None:
        import os

        self._proc = await asyncio.create_subprocess_exec(
            self.command,
            *self.args,
            stdin=asyncio.subprocess.PIPE,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.PIPE
            if self._capture_stderr
            else asyncio.subprocess.DEVNULL,
            env={**os.environ, **(self.env or {})},
            limit=16 * 1024 * 1024,  # tool results can be one very long line;
            # the 64KiB default would kill readline()
        )
        self._reader = asyncio.create_task(self._read_loop())
        if self._capture_stderr:
            self._stderr_reader = asyncio.create_task(self._stderr_loop())
        init = await self.request(
            "initialize",
            {
                "protocolVersion": "2024-11-05",
                "clientInfo": {"name": "agentfield_tpu", "version": "0.1"},
                "capabilities": {},
            },
        )
        self.server_info = init.get("serverInfo", {})
        await self.notify("notifications/initialized", {})

    async def stop(self) -> None:
        for task in (self._reader, self._stderr_reader):
            if task:
                task.cancel()
                await asyncio.gather(task, return_exceptions=True)
        if self._proc and self._proc.returncode is None:
            self._proc.terminate()
            try:
                async with aio_timeout(5):
                    await self._proc.wait()
            except TimeoutError:
                self._proc.kill()
                await self._proc.wait()
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(MCPError("server stopped"))
        self._pending.clear()

    async def _read_loop(self) -> None:
        assert self._proc and self._proc.stdout
        while True:
            try:
                line = await self._proc.stdout.readline()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # oversized line / broken pipe: fail loudly
                self._fail_all(f"stdio read failed: {e!r}")
                return
            if not line:
                self._fail_all("server closed stdout")
                return
            try:
                msg = json.loads(line)
            except json.JSONDecodeError:
                continue  # non-protocol noise on stdout
            fut = self._pending.pop(msg.get("id"), None)
            if fut is None or fut.done():
                continue
            if "error" in msg:
                fut.set_exception(MCPError(str(msg["error"])))
            else:
                fut.set_result(msg.get("result"))

    async def _stderr_loop(self) -> None:
        assert self._proc and self._proc.stderr
        while True:
            try:
                line = await self._proc.stderr.readline()
            except asyncio.CancelledError:
                raise
            except Exception:
                return
            if not line:
                return
            self.stderr_lines.append(line.decode(errors="replace").rstrip("\n"))

    async def _send(self, msg: dict[str, Any]) -> None:
        assert self._proc and self._proc.stdin
        self._proc.stdin.write(json.dumps(msg).encode() + b"\n")
        await self._proc.stdin.drain()

    def _fail_all(self, reason: str) -> None:
        self._dead = reason  # subsequent requests fail fast, not by timeout
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(MCPError(reason))
        self._pending.clear()

    async def request(self, method: str, params: Any = None, timeout: float = 30.0) -> Any:
        if self._dead:
            raise MCPError(f"server connection dead: {self._dead}")
        self._next_id += 1
        rid = self._next_id
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        try:
            await self._send(
                {"jsonrpc": "2.0", "id": rid, "method": method, "params": params or {}}
            )
            async with aio_timeout(timeout):
                return await fut
        finally:
            self._pending.pop(rid, None)  # timed-out futures must not accumulate

    async def notify(self, method: str, params: Any = None) -> None:
        await self._send({"jsonrpc": "2.0", "method": method, "params": params or {}})

    async def list_tools(self) -> list[dict[str, Any]]:
        return ((await self.request("tools/list")) or {}).get("tools", [])

    async def list_resources(self) -> list[dict[str, Any]]:
        """resources/list — optional per the MCP spec; servers without the
        capability answer method-not-found (or a null result), which maps to
        an empty list."""
        try:
            return ((await self.request("resources/list")) or {}).get("resources", [])
        except MCPError:
            return []

    async def call_tool(self, name: str, arguments: dict[str, Any]) -> Any:
        result = await self.request("tools/call", {"name": name, "arguments": arguments})
        # Per MCP spec, tool-level failures come back as a RESULT with
        # isError=true (not a JSON-RPC error) — they must not masquerade as
        # successful outputs.
        if isinstance(result, dict) and result.get("isError"):
            raise MCPError(f"tool {name!r} failed: {result.get('content')}")
        # Unwrap MCP content envelopes to plain values where trivial.
        content = result.get("content") if isinstance(result, dict) else None
        if isinstance(content, list) and len(content) == 1 and content[0].get("type") == "text":
            return content[0]["text"]
        return result


_JSON_TO_PY = {
    "string": "str",
    "integer": "int",
    "number": "float",
    "boolean": "bool",
    "array": "list",
    "object": "dict",
}


def _py_ident(name: str, taken: set[str]) -> str:
    """Tool/param names are untrusted (hyphens, dots, keywords, shadowing):
    coerce to a safe unique Python identifier."""
    import keyword
    import re

    ident = re.sub(r"\W", "_", name)
    if not ident or ident[0].isdigit():
        ident = f"t_{ident}"
    while keyword.iskeyword(ident) or ident in taken:
        ident += "_"
    taken.add(ident)
    return ident


def generate_skill_file(server: str, tools: list[dict[str, Any]]) -> str:
    """Emit a Python module of typed skill functions, one per MCP tool, ready
    to attach to an Agent (reference: skill-file code generation into the
    agent project, internal/mcp/skill_generator.go:37). The generated module
    exposes ``register(app, manager)`` wiring each function as a skill that
    forwards to the live MCP client. Unset optional parameters are OMITTED
    from tools/call arguments (absent != null for schema-validating servers)."""
    lines = [
        '"""Auto-generated MCP skill stubs — aftpu mcp generate. DO NOT EDIT."""',
        "",
        "from agentfield_tpu_torch.sdk.mcp import MCPManager  # noqa: F401",
        "",
        "",
        "def register(app, manager):",
        f'    """Attach {server!r} tools to `app` using a STARTED MCPManager."""',
        f"    client = manager.clients[{server!r}]",
    ]
    fn_names: set[str] = {"register", "app", "manager", "client"}
    for tool in tools:
        name = tool["name"]
        fn = _py_ident(name, fn_names)
        schema = tool.get("inputSchema", {})
        props = schema.get("properties", {})
        required = set(schema.get("required", []))
        # Seed with closure names (shadowing would break the forward call)
        # and the framework-reserved ctx/context (the SDK strips + injects
        # those — a tool param by that name must be renamed to stay settable).
        param_names: set[str] = {"client", "app", "manager", "register", "ctx", "context"}
        entries = []  # (py_param, wire_name, is_required, py_type)
        for pname, pschema in props.items():
            py = _JSON_TO_PY.get(pschema.get("type", ""), "object")
            entries.append((_py_ident(pname, param_names), pname, pname in required, py))
        entries.sort(key=lambda e: not e[2])  # required params must precede optional
        sig = ", ".join(
            f"{p}: {py}" if req else f"{p}: {py} | None = None"
            for p, _, req, py in entries
        )
        doc = repr(tool.get("description") or f"MCP tool {name}")  # literal-safe
        args = ", ".join(f"{wire!r}: {p}" for p, wire, _, _ in entries)
        lines += [
            "",
            # id derives from the RAW tool name — identical to
            # MCPManager.attach_to_agent so both registration paths expose
            # the same execute target; only the function name is sanitized.
            f"    @app.skill(id={f'{server}_{name}'!r}, description={doc})",
            f"    async def {fn}({sig}):",
            f"        _args = {{{args}}}",
            f"        return await client.call_tool({name!r}, "
            "{k: v for k, v in _args.items() if v is not None})",
        ]
    lines.append("")
    return "\n".join(lines)


class MCPManager:
    """Start/stop configured MCP servers and expose their tools as agent
    skills (the tool's own inputSchema becomes the skill schema; invocation
    forwards raw arguments)."""

    def __init__(self, config: dict[str, Any] | None = None):
        self.config = config or {}
        self.clients: dict[str, MCPStdioClient] = {}
        self.tools: dict[str, list[dict[str, Any]]] = {}

    @staticmethod
    def discover_config(project_dir: str | Path = ".") -> dict[str, Any]:
        """Read .mcp.json ({"mcpServers": {name: {command, args, env}}}) —
        the same file the reference SDK discovers (mcp_manager.py:42)."""
        p = Path(project_dir) / ".mcp.json"
        if not p.exists():
            return {}
        doc = json.loads(p.read_text())
        return doc.get("mcpServers", {})

    async def start_all(self) -> None:
        for name, spec in self.config.items():
            client = MCPStdioClient(
                spec["command"], spec.get("args", []), spec.get("env")
            )
            try:
                await client.start()
                self.clients[name] = client
                self.tools[name] = await client.list_tools()
            except Exception:
                await client.stop()  # the failing one...
                await self.stop_all()  # ...and every server started before it
                raise

    async def stop_all(self) -> None:
        for client in self.clients.values():
            await client.stop()
        self.clients.clear()
        self.tools.clear()  # keep clients/tools consistent for attach/health

    def health(self) -> dict[str, Any]:
        return {
            name: {
                "alive": c._proc is not None and c._proc.returncode is None,
                "tools": len(self.tools.get(name, [])),
                "server_info": c.server_info,
            }
            for name, c in self.clients.items()
        }

    def attach_to_agent(self, agent) -> list[str]:
        """Register every discovered tool as `<server>_<tool>` skill on the
        agent (reference: DynamicMCPSkillManager.discover_and_register_all_
        skills, dynamic_skills.py:33). Returns the registered skill ids."""
        from agentfield_tpu_torch.sdk.agent import ComponentDef

        registered = []
        for server, tools in self.tools.items():
            client = self.clients[server]
            for tool in tools:
                sid = f"{server}_{tool['name']}"

                def make_handler(c: MCPStdioClient, tname: str):
                    async def handler(payload):
                        return await c.call_tool(tname, payload or {})

                    return handler

                comp = ComponentDef.passthrough(
                    id=sid,
                    kind="skill",
                    handler=make_handler(client, tool["name"]),
                    description=tool.get("description", f"MCP tool {tool['name']} ({server})"),
                    input_schema=tool.get("inputSchema", {}),
                )
                agent._add_component(comp)
                registered.append(sid)
        return registered
