"""The port's dashboard, ``/api/ui/*``, ``/api/v1/packages`` and memory
events over WebSocket against the JAX control plane's, on the CPU.

The scripts of the JAX ``tests/test_ui_service.py`` (paginated, filtered
and grouped executions, node rollups and details, the credentials explorer,
the package inventory, the dashboard's pages, the bulk status refresh, the
stale-heartbeat reconciliation) and of ``tests/test_memory_events.py`` (the
summary, pattern and scope subscriptions, a reconnect) run against both
servers through ``tests/test_torch_cp_server.py``'s ``both``: every answer's
code and body are equal after that file's normalisation (ids, clocks), with
a heartbeat's age and a credential's signature and digests also replaced
where the executions' ids are random. The WebSocket's frames are equal too,
and each package's ``MemoryEventClient`` gets the same events from either
server."""

from __future__ import annotations

import asyncio
import json
import threading
import time

import aiohttp
import pytest

from agentfield_tpu.control_plane import ui_service as jax_ui
from agentfield_tpu.sdk import memory_events as jax_events
from agentfield_tpu_torch.control_plane import ui_service as port_ui
from agentfield_tpu_torch.sdk import memory_events as port_events
from agentfield_tpu_torch.control_plane.server import CP_KEY
from tests.helpers_cp import async_test
from tests.test_torch_cp_server import Side, assert_same, both, jax_side, port_side


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _replace(rec, keys: dict):
    """``rec`` with each value under one of ``keys`` replaced by its tag."""
    if isinstance(rec, dict):
        return {k: (keys[k] if k in keys and v is not None else _replace(v, keys))
                for k, v in rec.items()}
    if isinstance(rec, list):
        return [_replace(v, keys) for v in rec]
    return rec


def _seed(s: Side, n: int = 60, run: str = "run_ui"):
    """The JAX test's executions: alternating targets, every third failed,
    two runs."""
    types = s.types
    t0 = time.time() - n
    for i in range(n):
        s.cp.storage.create_execution(types.Execution(
            execution_id=f"exec_{i:04d}", target="n.alpha" if i % 2 else "n.beta",
            target_type=types.TargetType.REASONER,
            status=types.ExecutionStatus.COMPLETED if i % 3 else types.ExecutionStatus.FAILED,
            run_id=run if i < n // 2 else f"{run}_2", created_at=t0 + i, finished_at=t0 + i + 0.5))


async def flow_executions_page(s: Side):
    _seed(s)
    _, d, _ = await s.req("page 1", "GET", "/api/ui/v1/executions?page=1&page_size=10")
    s.note("page 1 ids", [e["execution_id"] for e in d["executions"]])
    s.note("duration", d["executions"][0]["duration_s"])
    _, d, _ = await s.req("page 6", "GET", "/api/ui/v1/executions?page=6&page_size=10")
    s.note("page 6 ids", [e["execution_id"] for e in d["executions"]])
    _, d, _ = await s.req("asc", "GET", "/api/ui/v1/executions?order=asc&page_size=3")
    s.note("asc ids", [e["execution_id"] for e in d["executions"]])
    for q in ("status=failed", "target=n.alpha", "group_by=target", "run_id=run_ui_2",
              "status=failed&group_by=run_id", "group_by=status", "status=nope", "group_by=doc",
              "page=zzz&page_size=-3", "page_size=1000", "page=99"):
        await s.req(q, "GET", f"/api/ui/v1/executions?{q}")


async def flow_nodes_and_details(s: Side):
    await s.register(s.agent, "fake-agent")
    await s.req("register model", "POST", "/api/v1/nodes", json={
        "node_id": "model-x", "base_url": "http://127.0.0.1:1", "kind": "model",
        "reasoners": [{"id": "generate"}]})
    node = s.cp.storage.get_node("model-x")
    node.metadata["stats"] = {"decode_tokens": 123, "active_slots": 2, "free_pages": 9,
                              "grammar_bank_rows_used": 4, "grammar_bank_rows": 255,
                              "not_shown": 1}
    s.cp.storage.upsert_node(node)
    await s.req("nodes", "GET", "/api/ui/v1/nodes")
    types = s.types
    s.cp.storage.create_execution(types.Execution(
        execution_id="e1", target="fake-agent.echo", target_type=types.TargetType.REASONER,
        status=types.ExecutionStatus.COMPLETED, run_id="r1", finished_at=time.time()))
    await s.req("details", "GET", "/api/ui/v1/nodes/fake-agent")
    await s.req("details model", "GET", "/api/ui/v1/nodes/model-x")
    await s.req("details unknown", "GET", "/api/ui/v1/nodes/ghost")


async def flow_summary(s: Side):
    """``tests/test_memory_events.py::test_ui_summary``, two runs."""
    await s.register(s.agent, "fake-agent")
    await s.req("echo", "POST", "/api/v1/execute/fake-agent.echo", json={"input": 1})
    await s.req("echo 2", "POST", "/api/v1/execute/fake-agent.echo", json={"input": 2})
    await s.req("summary", "GET", "/api/ui/v1/summary")
    s.note("storage counts", s.cp.storage.execution_counts())


async def flow_credentials(s: Side):
    await s.register(s.agent, "fake-agent")
    _, doc, _ = await s.req("echo", "POST", "/api/v1/execute/fake-agent.echo",
                            json={"input": {"x": 1}})
    eid, run_id = doc["execution_id"], doc["run_id"]
    await s.req("issue", "POST", f"/api/v1/vc/executions/{eid}")
    _, d, _ = await s.req("credentials", "GET", "/api/ui/v1/credentials")
    s.note("row ids", [d["credentials"][0]["vc_id"] == f"vc:exec:{eid}",
                       d["credentials"][0]["subject_id"] == eid])
    await s.req("issue again", "POST", f"/api/v1/vc/executions/{eid}")
    await s.req("executions only", "GET", "/api/ui/v1/credentials?subject_type=execution")
    await s.req("chain get", "GET", f"/api/v1/vc/workflows/{run_id}")
    await s.req("workflow after GET", "GET", "/api/ui/v1/credentials?subject_type=workflow")
    await s.req("chain post", "POST", f"/api/v1/vc/workflows/{run_id}")
    await s.req("workflow after POST", "GET", "/api/ui/v1/credentials?subject_type=workflow")
    await s.req("paged", "GET", "/api/ui/v1/credentials?page=2&page_size=1")


async def flow_packages(s: Side):
    data = s.cp.data_dir
    await s.req("empty", "GET", "/api/v1/packages")
    (data / "packages").mkdir(parents=True, exist_ok=True)
    (data / "packages" / "installed.json").write_text(json.dumps({
        "demo": {"name": "demo", "path": "/x/demo", "entry": "agent.py",
                 "description": "demo pkg", "origin": {"type": "local", "path": "/src"},
                 "installed_at": 1.0},
        "alpha": {"name": "alpha", "path": "/x/alpha", "entry": "main.py",
                  "description": "", "origin": {"type": "git", "url": "u"},
                  "installed_at": 2.0}}))
    await s.req("two", "GET", "/api/v1/packages")
    await s.register(s.agent, "demo")
    await s.req("node with package", "GET", "/api/ui/v1/nodes/demo")
    (data / "packages" / "installed.json").unlink()


async def flow_dashboard(s: Side):
    async with s.http.get("/") as r:
        s.note("dashboard", [r.status, r.headers["Content-Type"], await r.text()])
    html = s.record[-1][1][2]
    s.note("pages", [frag in html for frag in ("pgPkgs", "pgCreds", "'pkgs'", "'creds'",
                                               "/api/ui/v1/executions")])


async def flow_bulk_status(s: Side):
    _seed(s, n=10)
    ids = [f"exec_{i:04d}" for i in range(6)] + ["exec_gone"]
    _, d, _ = await s.req("bulk", "POST", "/api/ui/v1/executions/status", json={"ids": ids})
    s.note("keys", [sorted(d["statuses"]), d["missing"]])
    await s.req("bulk 501", "POST", "/api/ui/v1/executions/status",
                json={"ids": [f"exec_{i:04d}" for i in range(501)]})
    await s.req("bulk bad", "POST", "/api/ui/v1/executions/status", json={"ids": "nope"})
    await s.req("bulk not strings", "POST", "/api/ui/v1/executions/status", json={"ids": [1]})
    await s.req("bulk no body", "POST", "/api/ui/v1/executions/status")


async def flow_effective_status(s: Side):
    await s.register(s.agent, "fresh-node")
    await s.register(s.agent, "dead-node")
    node = s.cp.storage.get_node("dead-node")
    node.last_heartbeat = time.time() - 10_000
    s.cp.storage.upsert_node(node)
    ui = jax_ui if s.name == "jax" else port_ui
    d = await s.run(ui.node_summaries(s.cp))
    s.note("summaries", {n["node_id"]: [n["status"], n["effective_status"]] for n in d["nodes"]})
    await s.req("nodes", "GET", "/api/ui/v1/nodes")


AGES = {"last_heartbeat_age_s": "<age>"}
SIGS = {"proofValue": "<sig>", "vc_digests": "<digests>", "input_digest": "<d>"}
UI_FLOWS = {
    "executions_page": (flow_executions_page, {}, {"latest": "<t>"}),
    "nodes_and_details": (flow_nodes_and_details, {}, AGES),
    "summary": (flow_summary, {}, {}),
    "credentials": (flow_credentials, {}, SIGS),
    "dashboard": (flow_dashboard, {}, {}),
    "bulk_status": (flow_bulk_status, {}, {}),
    "effective_status": (flow_effective_status, {}, AGES),
}


@pytest.mark.parametrize("name", list(UI_FLOWS))
@async_test
async def test_ui_flow_same_on_both_control_planes(name):
    flow, kw, extra = UI_FLOWS[name]
    j, t = await both(flow, **kw)
    assert_same(_replace(j, extra), _replace(t, extra))
    rec = {r[0]: r[1:] for r in t}
    if name == "executions_page":
        assert rec["page 1"][1]["total"] == 60 and rec["page 1"][1]["total_pages"] == 6
        assert rec["page 1 ids"][0] == [f"exec_{i:04d}" for i in range(59, 49, -1)]
        assert rec["status=failed"][1]["total"] == 20 and rec["status=nope"][0] == 400
    elif name == "summary":
        counts = rec["storage counts"][0]
        assert rec["summary"][1]["executions_by_status"] == counts
        assert counts["completed"] == 2 and sum(counts.values()) == 2, counts
    elif name == "credentials":
        assert rec["row ids"][0] == [True, True]
        assert rec["workflow after GET"][1]["total"] == 0
        assert rec["workflow after POST"][1]["total"] == 1
    elif name == "dashboard":
        assert rec["pages"][0] == [True] * 5
    elif name == "effective_status":
        assert rec["summaries"][0]["dead-node"] == ["active", "stale"]


@async_test
async def test_packages_same_on_both_control_planes(tmp_path):
    j, t = await both(flow_packages, data_dir=str(tmp_path))
    assert_same(_replace(j, AGES), _replace(t, AGES))
    rec = {r[0]: r[1:] for r in t}
    assert rec["empty"][1] == {"packages": [], "total": 0}
    assert [p["name"] for p in rec["two"][1]["packages"]] == ["alpha", "demo"]
    assert rec["node with package"][1]["package"]["entry"] == "agent.py"


# -- memory events over WebSocket ------------------------------------------------


async def _set(s: Side, key: str, value, scope: str = "global", scope_id: str = ""):
    q = f"?scope={scope}&scope_id={scope_id}" if scope != "global" else ""
    async with s.http.post(f"/api/v1/memory/{key}{q}", json={"value": value}) as r:
        assert r.status == 200


async def _delete(s: Side, key: str):
    async with s.http.delete(f"/api/v1/memory/{key}") as r:
        assert r.status == 200


async def _wake_jax_handlers(s: Side):
    """The JAX server's WebSocket handler waits up to 30 s on the bus after
    its client has gone (its loop checks ``ws.closed`` between waits); one
    bus event ends every such handler now, so the harness's shutdown does
    not wait for them. The port's handler ends with its client."""
    if s.name == "jax":
        await asyncio.sleep(0.05)
        s.cp.bus.publish("memory", {"type": "wake", "key": ""})


async def _until(pred, tries: int = 200):
    for _ in range(tries):
        if pred():
            return True
        await asyncio.sleep(0.02)
    return False


@async_test
async def test_memory_events_websocket_frames_same_on_both_servers():
    """Raw frames of ``/api/v1/memory/events/ws`` for a set, a scoped set and
    a delete; the server's subscriber goes when the client closes."""
    frames = {}
    for ctx in (jax_side, port_side):
        async with ctx() as s:
            async with aiohttp.ClientSession() as c:
                async with c.ws_connect(f"{s.base_url}/api/v1/memory/events/ws") as ws:
                    await _until(lambda: s.cp.bus._subs.get("memory"))
                    await _set(s, "user_a", {"x": 1})
                    await _set(s, "sess", 3, scope="session", scope_id="s1")
                    await _delete(s, "user_a")
                    got = [json.loads((await ws.receive(timeout=5)).data) for _ in range(3)]
            frames[s.name] = [{k: v for k, v in f.items() if k != "ts"} for f in got]
            assert all(isinstance(f["ts"], float) for f in got)
            if s.name == "port":  # its handler ends with the client, not at a 30 s wait
                assert await _until(lambda: not s.cp.bus._subs.get("memory"))
            await _wake_jax_handlers(s)
    assert frames["port"] == frames["jax"]
    assert [f["type"] for f in frames["port"]] == ["set", "set", "delete"]


def _clients():
    return (("jax client", jax_events.MemoryEventClient),
            ("port client", port_events.MemoryEventClient))


async def _subscriptions_script(s: Side, Client) -> list:
    """``tests/test_memory_events.py::test_ws_pattern_subscriptions``."""
    events = Client(s.base_url, reconnect_delay=0.1)
    got_user, got_all, got_scoped, got_async = [], [], [], []

    async def on_async(ev):
        got_async.append((ev["type"], ev["key"]))

    events.on_change("user_*", lambda ev: got_user.append(ev["key"]))
    events.on_change("*", lambda ev: got_all.append(ev["key"]))
    events.on_change("*", lambda ev: got_scoped.append(ev["key"]), scope="session")
    events.on_change("*", on_async)
    events.on_change("*", lambda ev: 1 / 0)  # one bad handler breaks nothing
    await events.start()
    try:
        assert await _until(lambda: events.connected)
        await _set(s, "user_prefs", {"a": 1})
        await _set(s, "other_key", 2)
        await _set(s, "sess_key", 3, scope="session", scope_id="s1")
        await _delete(s, "other_key")
        assert await _until(lambda: len(got_all) >= 4)
    finally:
        await events.stop()
    assert not events.connected and events._task.done()
    return [got_user, got_all, got_scoped, got_async]


async def _reconnect_script(s: Side, Client) -> list:
    """``tests/test_memory_events.py::test_ws_reconnects_after_drop``."""
    events = Client(s.base_url, reconnect_delay=0.05)
    seen = []
    events.on_change("*", lambda ev: seen.append(ev["key"]))
    await events.start()
    try:
        assert await _until(lambda: events.connected)
        events._task.cancel()
        await asyncio.gather(events._task, return_exceptions=True)
        await events.start()
        # the connected flag may still be the cancelled task's: post until
        # the new connection delivers
        for _ in range(50):
            await _set(s, "after_reconnect", 1)
            if await _until(lambda: seen, tries=5):
                break
    finally:
        await events.stop()
    return sorted(set(seen))


@pytest.mark.parametrize("script", ["subscriptions", "reconnect"])
@async_test
async def test_memory_event_clients_same_on_both_servers(script):
    fn = _subscriptions_script if script == "subscriptions" else _reconnect_script
    out = {}
    for ctx in (jax_side, port_side):
        async with ctx() as s:
            for name, Client in _clients():
                out[(s.name, name)] = await fn(s, Client)
            await _wake_jax_handlers(s)
    first = out[("jax", "jax client")]
    assert all(v == first for v in out.values()), out
    if script == "subscriptions":
        assert first == [["user_prefs"], ["user_prefs", "other_key", "sess_key", "other_key"],
                         ["sess_key"], [("set", "user_prefs"), ("set", "other_key"),
                                        ("set", "sess_key"), ("delete", "other_key")]]
    else:
        assert first == ["after_reconnect"]


@async_test
async def test_memory_event_client_reconnects_once_the_server_is_up():
    """The port's client against a port nothing listens on: not connected,
    retrying with backoff; once a control plane serves there, it connects
    and gets events; its stop leaves no task."""
    from agentfield_tpu_torch.control_plane.server import ControlPlane, run_server
    from tests.helpers_cp import free_port

    port = free_port()
    events = port_events.MemoryEventClient(f"http://127.0.0.1:{port}", reconnect_delay=0.02,
                                           max_delay=0.08)
    seen = []
    events.on_change("*", lambda ev: seen.append(ev["key"]))
    await events.start()
    await asyncio.sleep(0.3)
    assert not events.connected and not events._task.done()
    runner = await run_server(ControlPlane(), "127.0.0.1", port)
    try:
        assert await _until(lambda: events.connected, tries=400)
        async with aiohttp.ClientSession() as c:
            await _until(lambda: runner.app[CP_KEY].bus._subs.get("memory"))
            async with c.post(f"http://127.0.0.1:{port}/api/v1/memory/k",
                              json={"value": 1}) as r:
                assert r.status == 200
        assert await _until(lambda: seen == ["k"])
    finally:
        await events.stop()
        await runner.cleanup()
    assert events._task.done() and not events.connected


def test_no_threads_left():
    names = [t.name for t in threading.enumerate()]
    assert "control-plane" not in names, names
