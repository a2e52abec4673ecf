"""The port's MCP layer against the JAX one, on the CPU: ``sdk/mcp.py``
(``MCPStdioClient``, ``MCPManager``, ``generate_skill_file``),
``control_plane/mcp_service.py`` and the control plane's MCP routes.

``tests/fake_mcp_server.py`` runs under both stdio clients and both managers
(the same answers, tools and health), and behind both control planes' MCP
routes (the JAX ``tests/test_mcp_manager.py`` lifecycle script through
``tests/test_torch_cp_server.py``'s ``both``: the same codes and bodies,
with pids and clocks replaced). ``generate_skill_file``'s text is the JAX
function's, the package of its import line apart, and the module it writes
registers working skills on the port's ``Agent``. ``MCPService``'s
supervision (a crashed server restarted, the restart budget, the
capability cache across a stop, specs persisted and autostarted) runs as
the JAX tests run it. A control plane's stop leaves no child process."""

from __future__ import annotations

import asyncio
import os
import pathlib
import signal
import sys
import threading

import pytest

from agentfield_tpu.sdk import agent as jax_agent_mod
from agentfield_tpu.sdk import mcp as jax_mcp
from agentfield_tpu_torch.control_plane import mcp_service as port_svc
from agentfield_tpu_torch.control_plane.storage import SQLiteStorage
from agentfield_tpu_torch.sdk import agent as port_agent_mod
from agentfield_tpu_torch.sdk import mcp as port_mcp
from tests.helpers_cp import async_test, free_port
from tests.test_torch_cp_server import Side, assert_same, both

FAKE = str(pathlib.Path(__file__).resolve().parent / "fake_mcp_server.py")
SPEC = {"command": sys.executable, "args": [FAKE]}

# Completes the MCP handshake, then exits: every spawn "crashes" right after
# coming up (the JAX test's script).
_DIE_AFTER_INIT = (
    "import json,sys\n"
    "m=json.loads(sys.stdin.readline())\n"
    'print(json.dumps({"jsonrpc":"2.0","id":m["id"],"result":'
    '{"serverInfo":{"name":"dier"},"capabilities":{}}}),flush=True)\n'
    "sys.stdin.readline()\n"
)


_BASELINE: tuple = ()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread while this module runs; the child processes
    and threads alive when it began, for the last test."""
    global _BASELINE
    import torch

    _BASELINE = (_children(), set(threading.enumerate()))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _children() -> set[int]:
    """Pids of this process's live child processes (``/proc``)."""
    me, out = os.getpid(), set()
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == me and fields[0] != "Z":
            out.add(int(d))
    return out


@async_test
async def test_stdio_clients_answer_the_same():
    out = {}
    for name, mod in (("jax", jax_mcp), ("port", port_mcp)):
        c = mod.MCPStdioClient(sys.executable, [FAKE], capture_stderr=10)
        await c.start()
        try:
            rec = [c.server_info, await c.list_tools(), await c.list_resources(),
                   await c.call_tool("add", {"a": 2, "b": 40}),
                   await c.call_tool("shout", {"text": "quiet"})]
            with pytest.raises(mod.MCPError) as e:
                await c.call_tool("nope", {})
            rec.append(str(e.value))
            with pytest.raises(mod.MCPError):
                await c.request("tools/call", {"name": "add", "arguments": {}}, timeout=5)
            await asyncio.sleep(0.05)
            rec.append(list(c.stderr_lines))
        finally:
            await c.stop()
        with pytest.raises(Exception) as e:  # stdin is closed with the child
            await c.request("tools/list")
        rec.append(type(e.value).__name__)
        assert c._proc.returncode is not None
        out[name] = rec
    assert out["port"] == out["jax"]
    assert out["port"][3] == "42" and out["port"][4] == "QUIET"


@async_test
async def test_managers_tools_health_and_attached_skills_equal():
    out = {}
    for name, mod, agent_mod in (("jax", jax_mcp, jax_agent_mod),
                                 ("port", port_mcp, port_agent_mod)):
        mgr = mod.MCPManager({"calc": SPEC, "calc2": SPEC})
        await mgr.start_all()
        try:
            app = agent_mod.Agent(f"mcp-{name}", "http://127.0.0.1:1")
            ids = app.attach_mcp(mgr)
            comps = {i: (app.components[i].kind, app.components[i].description,
                         app.components[i].input_schema) for i in ids}
            res = await app.components["calc_add"].invoke({"a": 1, "b": 2})
            out[name] = [mgr.tools, mgr.health(), ids, comps, res]
        finally:
            await mgr.stop_all()
        assert mgr.clients == {} and mgr.tools == {}
    assert out["port"] == out["jax"]
    assert out["port"][2] == ["calc_add", "calc_shout", "calc2_add", "calc2_shout"]
    assert out["port"][4] == "3"


@async_test
async def test_manager_start_failure_stops_every_server_started():
    for mod in (jax_mcp, port_mcp):
        mgr = mod.MCPManager({"ok": SPEC, "broken": {"command": "/nonexistent-mcp"}})
        kids = _children()
        with pytest.raises(Exception):
            await mgr.start_all()
        assert mgr.clients == {}
        assert _children() <= kids


TOOLS = [
    {"name": "add", "description": "Add two integers",
     "inputSchema": {"type": "object", "properties": {"a": {"type": "integer"},
                                                        "b": {"type": "integer"}},
                     "required": ["a", "b"]}},
    {"name": "my-tool.v2", "inputSchema": {"type": "object", "properties": {
        "class": {"type": "string"}, "ctx": {"type": "number"}, "client": {"type": "boolean"},
        "opt": {"type": "array"}, "1st": {"type": "object"}, "x": {}}, "required": ["class"]}},
    {"name": "import", "description": "it's \"quoted\"\nmultiline", "inputSchema": {}},
    {"name": "register", "inputSchema": {"type": "object", "properties": {}}},
    {"name": "add", "description": "a duplicate name"},
]


def test_generate_skill_file_text_equals_jax():
    for server in ("calc", "my-server", "srv"):
        tools = TOOLS if server != "calc" else TOOLS[:1]
        port_text = port_mcp.generate_skill_file(server, tools)
        jax_text = jax_mcp.generate_skill_file(server, tools)
        assert port_text.replace("agentfield_tpu_torch.sdk", "agentfield_tpu.sdk") == jax_text
        assert "from agentfield_tpu_torch.sdk.mcp import MCPManager" in port_text
        compile(port_text, f"mcp_{server}_skills.py", "exec")


@async_test
async def test_generated_module_registers_working_skills_on_the_port_agent():
    mgr = port_mcp.MCPManager({"calc": SPEC})
    await mgr.start_all()
    try:
        code = port_mcp.generate_skill_file("calc", mgr.tools["calc"])
        ns: dict = {}
        exec(compile(code, "mcp_calc_skills.py", "exec"), ns)
        app = port_agent_mod.Agent("gen", "http://127.0.0.1:1")
        ns["register"](app, mgr)
        assert sorted(app.components) == ["calc_add", "calc_shout"]
        assert await app.components["calc_add"].invoke({"a": 20, "b": 22}) == "42"
        assert await app.components["calc_shout"].invoke({"text": "hey"}) == "HEY"
        schema = app.components["calc_add"].input_schema
        assert sorted(schema["properties"]) == ["a", "b"] and schema["required"] == ["a", "b"]
    finally:
        await mgr.stop_all()


def _norm_mcp(rec: list) -> list:
    """Pids, start times and capability clocks replaced."""
    def walk(x, key=None):
        if isinstance(x, dict):
            return {k: ("<pid>" if k == "pid" and v else "<t>" if k in (
                "capabilities_ts", "ts", "started_at") and v else walk(v, k))
                    for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v) for v in x]
        return x
    return walk(rec)


async def flow_mcp_lifecycle(s: Side):
    """The JAX ``test_mcp_api_lifecycle`` and ``test_mcp_bad_command_fails_
    cleanly`` scripts, every answer recorded."""
    await s.req("add+start", "POST", "/api/v1/mcp/servers",
                json={"alias": "calc", "command": sys.executable, "args": [FAKE], "start": True})
    await s.req("add again", "POST", "/api/v1/mcp/servers",
                json={"alias": "calc", "command": sys.executable, "args": [FAKE]})
    await s.req("add no command", "POST", "/api/v1/mcp/servers", json={"alias": "x"})
    await s.req("add not an object", "POST", "/api/v1/mcp/servers", json=[1])
    await s.req("list", "GET", "/api/v1/mcp/servers")
    await s.req("tools", "GET", "/api/v1/mcp/servers/calc/tools")
    await s.req("tools cached", "GET", "/api/v1/mcp/servers/calc/tools")
    await s.req("tools refresh", "GET", "/api/v1/mcp/servers/calc/tools?refresh=1")
    await s.req("generate", "POST", "/api/v1/mcp/servers/calc/skills/generate")
    s.record[-1][2]["module"] = s.record[-1][2]["module"].replace(
        "agentfield_tpu_torch.sdk", "agentfield_tpu.sdk")
    await s.req("logs", "GET", "/api/v1/mcp/servers/calc/logs")
    await s.req("logs 0", "GET", "/api/v1/mcp/servers/calc/logs?lines=0")
    await s.req("logs bad", "GET", "/api/v1/mcp/servers/calc/logs?lines=x")
    await s.req("status", "GET", "/api/ui/v1/mcp/status")
    await s.req("restart", "POST", "/api/v1/mcp/servers/calc/restart")
    await s.req("list after restart", "GET", "/api/v1/mcp/servers")
    await s.req("stop", "POST", "/api/v1/mcp/servers/calc/stop")
    await s.req("status stopped", "GET", "/api/ui/v1/mcp/status")
    await s.req("tools stopped (cached)", "GET", "/api/v1/mcp/servers/calc/tools")
    await s.req("start unknown", "POST", "/api/v1/mcp/servers/ghost/start")
    await s.req("bad action", "POST", "/api/v1/mcp/servers/calc/explode")
    await s.req("remove", "DELETE", "/api/v1/mcp/servers/calc")
    await s.req("tools removed", "GET", "/api/v1/mcp/servers/calc/tools")
    await s.req("remove again", "DELETE", "/api/v1/mcp/servers/calc")
    await s.req("add broken", "POST", "/api/v1/mcp/servers",
                json={"alias": "broken", "command": "/nonexistent-mcp", "start": True})
    await s.req("list broken", "GET", "/api/v1/mcp/servers")
    await s.req("tools broken", "GET", "/api/v1/mcp/servers/broken/tools")
    await s.req("nodes page", "GET", "/api/ui/v1/nodes")


@async_test
async def test_mcp_routes_same_on_both_control_planes():
    kids = _children()
    j, t = await both(flow_mcp_lifecycle)
    assert_same(_norm_mcp(j), _norm_mcp(t))
    codes = {r[0]: r[1] for r in t}
    assert codes["add+start"] == 201 and codes["add again"] == 400, codes
    assert codes["start unknown"] == 404 and codes["tools removed"] == 404, codes
    assert codes["add broken"] == 400, codes
    tools = next(r[2] for r in t if r[0] == "tools")
    assert [x["name"] for x in tools["tools"]] == ["add", "shout"]
    assert "fake-mcp starting" in next(r[2] for r in t if r[0] == "logs")["lines"]
    assert _children() <= kids, "a control plane left an MCP child running"


@async_test
async def test_supervision_restarts_a_crashed_server():
    svc = port_svc.MCPService(SQLiteStorage(), restart_backoff=0.05)
    svc.add(port_svc.MCPServerSpec(alias="fake", command=sys.executable, args=[FAKE]))
    await svc.start("fake")
    [st] = svc.status()
    pid = st["pid"]
    os.kill(pid, signal.SIGKILL)
    for _ in range(100):
        await asyncio.sleep(0.05)
        [st] = svc.status()
        if st["state"] == "running" and st["pid"] != pid:
            break
    assert st["state"] == "running" and st["restarts"] == 1
    manifest = await svc.discover("fake")
    assert len(manifest["tools"]) == 2
    await svc.stop_all()
    assert svc.status()[0]["pid"] is None


@async_test
async def test_restart_budget_exhausts_to_failed():
    svc = port_svc.MCPService(SQLiteStorage(), max_restarts=2, restart_backoff=0.02)
    svc.add(port_svc.MCPServerSpec(alias="dier", command=sys.executable,
                                   args=["-c", _DIE_AFTER_INIT]))
    await svc.start("dier")
    for _ in range(200):
        await asyncio.sleep(0.05)
        [st] = svc.status()
        if st["state"] == "failed":
            break
    assert st["state"] == "failed" and st["restarts"] == 2
    assert "exited rc=" in st["last_error"]
    await svc.stop_all()
    svc2 = port_svc.MCPService(SQLiteStorage(), max_restarts=1, restart_backoff=0.02)
    svc2.add(port_svc.MCPServerSpec(alias="dead", command=sys.executable, args=["-c", "pass"]))
    with pytest.raises(port_svc.MCPServiceError, match="failed to start 'dead'"):
        await svc2.start("dead")
    assert svc2.status()[0]["state"] == "failed"
    await svc2.stop_all()


@async_test
async def test_capability_cache_survives_stop_and_specs_persist_with_autostart(tmp_path):
    svc = port_svc.MCPService(SQLiteStorage())
    svc.add(port_svc.MCPServerSpec(alias="fake", command=sys.executable, args=[FAKE]))
    await svc.start("fake")
    live = await svc.discover("fake")
    await svc.stop("fake")
    cached = await svc.discover("fake")
    assert cached["ts"] == live["ts"] and [t["name"] for t in cached["tools"]] == ["add", "shout"]
    await svc.stop_all()
    db = str(tmp_path / "cp.db")
    store1 = SQLiteStorage(db)
    port_svc.MCPService(store1).add(port_svc.MCPServerSpec(
        alias="fake", command=sys.executable, args=[FAKE], autostart=True))
    store1.close()
    store2 = SQLiteStorage(db)
    svc2 = port_svc.MCPService(store2)
    [st] = svc2.status()
    assert st["alias"] == "fake" and st["autostart"] and st["state"] == "stopped"
    await svc2.start_autostart()
    assert svc2.status()[0]["state"] == "running"
    await svc2.stop_all()
    store2.close()


def test_control_plane_autostarts_and_its_stop_leaves_no_child(tmp_path):
    """A control plane on a database whose MCP spec autostarts: the child
    runs after start, its pid is gone after the control plane's stop, and
    the control plane's thread is gone."""
    from agentfield_tpu_torch.control_plane.server import ControlPlane, ControlPlaneThread

    db = str(tmp_path / "cp.db")
    store = SQLiteStorage(db)
    port_svc.MCPService(store).add(port_svc.MCPServerSpec(
        alias="auto", command=sys.executable, args=[FAKE], autostart=True))
    store.close()
    kids = _children()
    cpt = ControlPlaneThread(ControlPlane(db_path=db))
    cpt.start()
    try:
        import time

        t0 = time.monotonic()
        while cpt.cp.mcp.status()[0]["state"] != "running":
            assert time.monotonic() - t0 < 20, cpt.cp.mcp.status()
            time.sleep(0.05)
        pid = cpt.cp.mcp.status()[0]["pid"]
        assert pid in _children()
    finally:
        cpt.stop()
    assert pid not in _children() and _children() <= kids
    assert not cpt._thread.is_alive()


@async_test
async def test_attach_mcp_skill_through_both_gateways():
    """A port agent with a started manager attached, registered with the
    port's control plane, and a JAX agent with the JAX manager behind the
    JAX control plane: the same execute of the tool answers the same."""
    from agentfield_tpu_torch.control_plane.server import ControlPlane, run_server
    from tests.helpers_cp import CPHarness

    out = {}
    for name in ("jax", "port"):
        mod, agent_mod = (jax_mcp, jax_agent_mod) if name == "jax" else (port_mcp, port_agent_mod)
        mgr = mod.MCPManager({"calc": SPEC})
        await mgr.start_all()
        if name == "jax":
            ctx = CPHarness()
            h = await ctx.__aenter__()
            base = h.base_url
        else:
            port = free_port()
            runner = await run_server(ControlPlane(), "127.0.0.1", port)
            base = f"http://127.0.0.1:{port}"
        app = agent_mod.Agent("tools", base)
        app.attach_mcp(mgr)
        await app.start()
        try:
            out[name] = [await app.client.execute("tools.calc_add", {"a": 5, "b": 6}),
                         await app.client.execute("tools.calc_shout", {"text": "mcp"})]
            out[name] = [(d["status"], d["result"]) for d in out[name]]
        finally:
            await app.stop()
            await mgr.stop_all()
            if name == "jax":
                await ctx.__aexit__(None, None, None)
            else:
                await runner.cleanup()
    assert out["port"] == out["jax"] == [("completed", "11"), ("completed", "MCP")]


def test_no_threads_or_children_left():
    """Runs last in this module: no child process and no thread started by
    this module's tests outlived them."""
    kids0, threads0 = _BASELINE
    assert _children() <= kids0, _children() - kids0
    left = [t for t in threading.enumerate() if t not in threads0 and t.is_alive()]
    assert not left, left
