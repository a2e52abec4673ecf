"""The port's control plane against the JAX one, request by request, on the CPU.

Each test runs one flow of ``tests/test_control_plane.py`` or
``tests/test_fault_tolerance.py`` twice: against the JAX ``ControlPlane``
(``tests/helpers_cp.CPHarness``, in the test's event loop, with its lock
witness and leak audit) and against the port's
(``agentfield_tpu_torch.control_plane``, served by ``ControlPlaneThread`` on
a loop of its own), each with its own ``helpers_cp.FakeAgent``. Every
response's status code and JSON body is recorded and the two records must
be equal after normalisation:

- agents' URLs (each side's agents listen on ports of their own), ids,
  trace ids and timestamps (``execution_id``, ``run_id``, ``trace_id``,
  ``ts``, ``*_at``, ``last_heartbeat``, ``last_probe``, ``first_seen``,
  ``last_seen``, a span's ``t0``) are replaced by placeholders, and so are
  measured durations (``duration_s``, a span's ``dur_ms``);
- ``did`` fields are compared as they are: both control planes of a flow
  open one keystore file (the JAX one creates it, the port's opens it), so
  they mint the same DIDs at registration. A credential's ``issuanceDate``
  (its proof's ``created``, a stored credential's ``issued_at``) is replaced
  by a placeholder; the identity flow freezes both identity modules'
  clock, so its credentials, signatures included, compare byte for byte;
- the text after "agent call failed: " is an exception's repr, which names
  aiohttp's classes on one side and ``http.py``'s on the other; it is
  replaced by a placeholder (the classification before it is compared);
- the 429 flow depends on how fast the worker drains: both must answer 429
  with a ``Retry-After`` of at least 1 s, not the same sequence of codes.

``/metrics`` is compared by its metric names (``# TYPE`` lines), and one
terminal execution's ``/stream`` answer byte for byte after the ids.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import re
import threading
import time

import aiohttp
import numpy as np
import pytest
from aiohttp import web

from agentfield_tpu.control_plane import types as jtypes
from agentfield_tpu.control_plane.webhooks import SIGNATURE_HEADER, sign_payload
from agentfield_tpu_torch.control_plane import server as tserver
from agentfield_tpu_torch.control_plane import types as ttypes
from agentfield_tpu_torch.control_plane import webhooks as twebhooks
from tests.helpers_cp import CPHarness, FakeAgent, async_test, free_port

FAST_RETRY = {"max_attempts": 3, "base_backoff": 0.01, "max_backoff": 0.02}
ID_KEYS = {"execution_id", "run_id", "trace_id"}
TIME_KEYS = {"ts", "created_at", "started_at", "finished_at", "registered_at",
             "last_heartbeat", "last_probe", "first_seen", "last_seen", "t0", "dur_ms",
             "issuanceDate", "created", "issued_at"}


def norm(x, key: str | None = None):
    """The record with ids, clocks and transport reprs replaced."""
    if isinstance(x, dict):
        return {norm(k): ("<id>" if k in ID_KEYS and x[k] else
                    "<t>" if k in TIME_KEYS and x[k] is not None else
                    ({q: "<f>" for q in x[k]} if isinstance(x[k], dict) else "<f>")
                    if k == "duration_s" and x[k] is not None else norm(v, k))
                for k, v in x.items()}
    if isinstance(x, list):
        return [norm(v) for v in x]
    if isinstance(x, str):
        x = re.sub(r"agent call failed: .*", "agent call failed: <transport>", x)
        x = re.sub(r"http://127\.0\.0\.1:\d+", "http://<agent>", x)
        return re.sub(r"\b(exec|run|tr)_[0-9a-f]{20}\b", r"\1_<id>", x)
    return x


class Side:
    """One control plane under test, as the flows see it."""

    def __init__(self, name, base_url, agent, cp, run, types):
        self.name, self.base_url, self.agent, self.cp = name, base_url, agent, cp
        self.run = run  # run(coroutine) on the control plane's own loop
        self.types = types  # its package's control_plane.types
        self.http = aiohttp.ClientSession(base_url=base_url)
        self.record: list = []

    async def req(self, label, method, path, **kw):
        async with self.http.request(method, path, **kw) as r:
            raw = await r.read()
            try:
                body = json.loads(raw) if raw else None
            except ValueError:
                body = raw.decode(errors="replace")
            self.record.append([label, r.status, body])
            return r.status, body, r.headers

    def note(self, label, value):
        self.record.append([label, value])

    async def register(self, agent, node_id):
        return await self.req(f"register {node_id}", "POST", "/api/v1/nodes", json={
            "node_id": node_id, "base_url": agent.base_url,
            "reasoners": agent.reasoner_specs()})

    async def fake(self, **kw) -> FakeAgent:
        a = FakeAgent(self.base_url, **kw)
        await a.start()
        return a

    async def poll(self, eid, until=("completed",), tries=400):
        for _ in range(tries):
            async with self.http.get(f"/api/v1/executions/{eid}") as r:
                doc = await r.json()
            if doc["status"] in until:
                return doc
            await asyncio.sleep(0.01)
        return doc


@contextlib.asynccontextmanager
async def jax_side(**kw):
    async with CPHarness(**kw) as h:
        s = Side("jax", h.base_url, h.agent, h.cp, lambda coro: coro, jtypes)
        try:
            yield s
        finally:
            await s.http.close()


@contextlib.asynccontextmanager
async def port_side(**kw):
    threads0 = set(threading.enumerate())
    cpt = tserver.ControlPlaneThread(tserver.ControlPlane(**kw))
    base = cpt.start()
    agent = FakeAgent(base)
    await agent.start()

    def run(coro):
        return asyncio.wrap_future(asyncio.run_coroutine_threadsafe(coro, cpt.loop))

    s = Side("port", base, agent, cpt.cp, run, ttypes)
    try:
        yield s
    finally:
        await s.http.close()
        await agent.stop()
        await asyncio.to_thread(cpt.stop)
        left = [t for t in threading.enumerate() if t not in threads0 and t.is_alive()
                and not t.name.startswith(("asyncio_", "ThreadPoolExecutor"))]
        assert not left, f"the port's control plane left threads: {left}"


async def both(flow, **kw) -> tuple[list, list]:
    """Run ``flow`` against each control plane, both on one keystore file;
    return both records, normalised."""
    import tempfile

    out = []
    with tempfile.TemporaryDirectory(prefix="cp-keystore-") as d:
        kw = {"keystore_path": f"{d}/keystore.bin", "keystore_passphrase": "parity", **kw}
        for ctx in (jax_side, port_side):
            async with ctx(**kw) as s:
                await flow(s)
                out.append(norm(s.record))
    return out[0], out[1]


def assert_same(j, t):
    assert len(j) == len(t), (len(j), len(t), j, t)
    for a, b in zip(j, t):
        assert a == b, f"\njax:  {a}\nport: {b}"


# -- the flows -------------------------------------------------------------


async def flow_register_heartbeat_list(s: Side):
    await s.register(s.agent, "fake-agent")
    await s.req("heartbeat", "POST", "/api/v1/nodes/fake-agent/heartbeat", json={})
    await s.req("heartbeat stats", "POST", "/api/v1/nodes/fake-agent/heartbeat",
                json={"stats": {"decode_tokens": 9, "prefix_index_hits": 2}})
    await s.req("heartbeat unknown", "POST", "/api/v1/nodes/ghost/heartbeat", json={})
    await s.req("list", "GET", "/api/v1/nodes")
    await s.req("get", "GET", "/api/v1/nodes/fake-agent")
    await s.req("get unknown", "GET", "/api/v1/nodes/ghost")
    await s.req("health", "GET", "/api/v1/nodes/fake-agent/health")
    await s.req("health unknown", "GET", "/api/v1/nodes/ghost/health")
    await s.req("reasoners", "GET", "/api/v1/reasoners")
    await s.req("deregister", "DELETE", "/api/v1/nodes/fake-agent")
    await s.req("deregister again", "DELETE", "/api/v1/nodes/fake-agent")
    await s.req("cp health", "GET", "/health")


async def flow_sync_200_and_202(s: Side):
    await s.register(s.agent, "fake-agent")
    _, doc, _ = await s.req("echo", "POST", "/api/v1/execute/fake-agent.echo",
                            json={"input": {"msg": "hi"}})
    call = s.agent.calls[0]
    s.note("context headers", [call["headers"]["X-Execution-ID"] == doc["execution_id"],
                               call["headers"]["X-Run-ID"] == doc["run_id"],
                               sorted(k for k in call["headers"] if k.startswith("X-"))])
    await s.req("deferred", "POST", "/api/v1/execute/fake-agent.deferred", json={})
    await s.req("get", "GET", f"/api/v1/executions/{doc['execution_id']}")
    await s.req("get unknown", "GET", "/api/v1/executions/exec_nope")


async def flow_async_poll_batch(s: Side):
    await s.register(s.agent, "fake-agent")
    _, doc, _ = await s.req("async", "POST", "/api/v1/execute/async/fake-agent.deferred",
                            json={})
    eid = doc["execution_id"]
    s.note("polled", await s.poll(eid))
    await s.req("batch", "POST", "/api/v1/executions/batch-status",
                json={"execution_ids": [eid, "nope"]})
    await s.req("batch not a list", "POST", "/api/v1/executions/batch-status",
                json={"execution_ids": "x"})
    await s.req("batch no body", "POST", "/api/v1/executions/batch-status")
    await s.req("list", "GET", "/api/v1/executions?limit=5")
    await s.req("list by status", "GET", "/api/v1/executions?status=completed")


async def flow_error_paths(s: Side):
    await s.register(s.agent, "fake-agent")
    await s.req("boom", "POST", "/api/v1/execute/fake-agent.boom",
                json={"retry_policy": FAST_RETRY})
    await s.req("no dot", "POST", "/api/v1/execute/no-dot", json={})
    await s.req("ghost", "POST", "/api/v1/execute/ghost.echo", json={})
    await s.req("no component", "POST", "/api/v1/execute/fake-agent.nope", json={})
    await s.req("bad timeout", "POST", "/api/v1/execute/fake-agent.echo",
                json={"timeout": -1})
    await s.req("bad priority", "POST", "/api/v1/execute/fake-agent.echo",
                json={"priority": "high"})
    await s.req("bad deadline", "POST", "/api/v1/execute/fake-agent.echo",
                json={"deadline_s": 0})
    await s.req("bad retry policy", "POST", "/api/v1/execute/fake-agent.echo",
                json={"retry_policy": {"max_attempts": 0}})
    await s.req("bad branches", "POST", "/api/v1/execute/fake-agent.echo",
                json={"n_branches": 0})
    await s.req("bad followup", "POST", "/api/v1/execute/fake-agent.echo",
                json={"expect_followup": "yes"})
    await s.req("flaky retried", "POST", "/api/v1/execute/fake-agent.flaky",
                json={"input": 3, "retry_policy": FAST_RETRY})


async def flow_agent_timeout(s: Side):
    s.agent.slow_s = 1.0  # past the 0.2 s agent timeout; the agent's stop waits it out
    await s.register(s.agent, "fake-agent")
    await s.req("slow", "POST", "/api/v1/execute/fake-agent.slow",
                json={"retry_policy": FAST_RETRY})


async def flow_backpressure_503(s: Side):
    await s.register(s.agent, "fake-agent")
    for i in range(3):
        st, _, hdrs = await s.req(f"async {i}", "POST", "/api/v1/execute/async/fake-agent.echo",
                                  json={})
        s.note(f"retry-after {i}", hdrs.get("Retry-After"))


async def flow_sync_wait_timeout(s: Side):
    await s.register(s.agent, "fake-agent")
    await s.req("silent", "POST", "/api/v1/execute/fake-agent.silent202", json={})


async def flow_memory(s: Side):
    await s.req("set", "POST", "/api/v1/memory/greeting", json={"value": {"x": 1}})
    await s.req("get", "GET", "/api/v1/memory/greeting")
    await s.req("set session", "POST", "/api/v1/memory/k1?scope=session&scope_id=s1",
                json={"value": "a"})
    await s.req("get global", "GET", "/api/v1/memory/k1")
    await s.req("list session", "GET", "/api/v1/memory?scope=session&scope_id=s1")
    await s.req("list prefix", "GET", "/api/v1/memory?prefix=gr")
    await s.req("no scope id", "POST", "/api/v1/memory/k?scope=session", json={"value": 1})
    await s.req("bad scope", "GET", "/api/v1/memory/k?scope=planet")
    await s.req("set no body", "POST", "/api/v1/memory/k2")
    await s.req("set list body", "POST", "/api/v1/memory/k2", json=[1])
    await s.req("delete", "DELETE", "/api/v1/memory/greeting")
    await s.req("get deleted", "GET", "/api/v1/memory/greeting")
    await s.req("delete again", "DELETE", "/api/v1/memory/greeting")


async def flow_vectors(s: Side):
    vecs = {"a": [1.0, 0.0], "b": [0.9, 0.1], "c": [0.0, 1.0]}
    for k, v in vecs.items():
        await s.req(f"set {k}", "POST", "/api/v1/memory/vectors/set",
                    json={"key": k, "embedding": v, "metadata": {"name": k}})
    for metric in ("cosine", "dot", "l2"):
        await s.req(f"search {metric}", "POST", "/api/v1/memory/vectors/search",
                    json={"embedding": [1.0, 0.0], "top_k": 2, "metric": metric})
    await s.req("search scoped", "POST",
                "/api/v1/memory/vectors/search?scope=actor&scope_id=x",
                json={"embedding": [1.0, 0.0]})
    await s.req("bad metric", "POST", "/api/v1/memory/vectors/search",
                json={"embedding": [1.0, 0.0], "metric": "nope"})
    await s.req("no key", "POST", "/api/v1/memory/vectors/set", json={"embedding": [1.0]})
    await s.req("delete", "POST", "/api/v1/memory/vectors/delete", json={"key": "b"})
    await s.req("delete again", "POST", "/api/v1/memory/vectors/delete", json={"key": "b"})
    await s.req("search after", "POST", "/api/v1/memory/vectors/search",
                json={"embedding": [1.0, 0.0], "top_k": 5})


async def flow_lowercase_headers_duplicate(s: Side):
    await s.register(s.agent, "fake-agent")
    hdrs = {"x-run-id": "run_low", "x-execution-id": "exec_low", "x-session-id": "sess1",
            "x-actor-id": "act1", "x-parent-execution-id": "exec_parent"}
    _, doc, rh = await s.req("lowercase", "POST", "/api/v1/execute/fake-agent.echo", json={},
                             headers=hdrs)
    s.note("ids kept", [doc["run_id"], doc["execution_id"], doc["session_id"],
                        doc["actor_id"], doc["parent_execution_id"]])
    await s.req("duplicate", "POST", "/api/v1/execute/fake-agent.echo", json={}, headers=hdrs)


async def flow_input_validation(s: Side):
    await s.register(s.agent, "fake-agent")
    await s.req("bogus status", "POST", "/api/v1/nodes/fake-agent/heartbeat",
                json={"status": "bogus"})
    await s.req("bogus filter", "GET", "/api/v1/executions?status=bogus")
    await s.req("bad limit", "GET", "/api/v1/executions?limit=abc")
    await s.req("bad component", "POST", "/api/v1/nodes",
                json={"node_id": "x", "base_url": "http://y", "reasoners": [{"name": "no-id"}]})
    await s.req("no node id", "POST", "/api/v1/nodes", json={"base_url": "http://y"})
    await s.req("dot in id", "POST", "/api/v1/nodes", json={"node_id": "a.b",
                                                            "base_url": "http://y"})
    await s.req("register empty", "POST", "/api/v1/nodes")
    await s.req("bad json", "POST", "/api/v1/execute/fake-agent.echo", data=b"{nope",
                headers={"Content-Type": "application/json"})
    await s.req("json array", "POST", "/api/v1/execute/fake-agent.echo", json=[1, 2])
    await s.req("status no body", "POST", "/api/v1/executions/exec_x/status")
    await s.req("status unknown", "POST", "/api/v1/executions/exec_x/status",
                json={"status": "completed"})
    await s.req("dead letter bad limit", "GET", "/api/v1/dead-letter?limit=x")
    await s.req("runs bad limit", "GET", "/api/v1/runs?limit=x")
    await s.req("note no body", "POST", "/api/v1/executions/exec_x/notes", json={})
    await s.req("note unknown", "POST", "/api/v1/executions/exec_x/notes", json={"note": 1})
    await s.req("event missing", "POST", "/api/v1/workflow/executions/events",
                json={"event": "start"})
    await s.req("event unknown", "POST", "/api/v1/workflow/executions/events",
                json={"event": "bogus", "execution_id": "e1", "run_id": "r1"})
    await s.req("unknown path", "GET", "/api/v1/nope")
    await s.req("wrong method", "GET", "/api/v1/execute/fake-agent.echo")
    await s.req("wrong method 2", "PUT", "/api/v1/nodes")


async def flow_reasoner_metrics(s: Side):
    await s.register(s.agent, "fake-agent")
    for _ in range(3):
        await s.req("echo", "POST", "/api/v1/execute/fake-agent.echo", json={"input": 1})
    await s.req("boom", "POST", "/api/v1/execute/fake-agent.boom",
                json={"retry_policy": FAST_RETRY})
    await s.req("metrics echo", "GET", "/api/v1/reasoners/fake-agent.echo/metrics")
    await s.req("metrics boom", "GET", "/api/v1/reasoners/fake-agent.boom/metrics")
    await s.req("metrics ghost", "GET", "/api/v1/reasoners/ghost.fn/metrics")
    _, doc, _ = await s.req("runs", "GET", "/api/v1/runs")
    run_id = doc["runs"][0]["run_id"]
    await s.req("dag", "GET", f"/api/v1/workflows/{run_id}/dag")
    await s.req("dag light", "GET", f"/api/v1/workflows/{run_id}/dag?lightweight=1")
    await s.req("dag unknown", "GET", "/api/v1/workflows/run_nope/dag")


async def flow_notes_and_workflow_events(s: Side):
    await s.register(s.agent, "fake-agent")
    _, doc, _ = await s.req("echo", "POST", "/api/v1/execute/fake-agent.echo", json={})
    eid = doc["execution_id"]
    await s.req("note", "POST", f"/api/v1/executions/{eid}/notes",
                json={"note": "looked", "actor": "me"})
    await s.req("note 2", "POST", f"/api/v1/executions/{eid}/notes", json={"note": "again"})
    await s.req("with notes", "GET", f"/api/v1/executions/{eid}")
    for ev in ("start", "complete"):
        await s.req(f"event {ev}", "POST", "/api/v1/workflow/executions/events",
                    json={"event": ev, "execution_id": "exec_child", "run_id": "run_w",
                          "parent_execution_id": eid, "target": "fake-agent.echo",
                          "result": {"r": 1}})
    await s.req("child", "GET", "/api/v1/executions/exec_child")
    await s.req("dag", "GET", "/api/v1/workflows/run_w/dag")


async def flow_registry_cache(s: Side):
    cache = s.cp.registry.cache
    m = s.cp.metrics
    await s.register(s.agent, "a")
    await s.req("first", "POST", "/api/v1/execute/a.echo", json={})
    misses0 = m.counter_value("registry_cache_misses_total")
    await s.req("second", "POST", "/api/v1/execute/a.echo", json={})
    s.note("cache", [cache.enabled, misses0 >= 1,
                     m.counter_value("registry_cache_hits_total") >= 1,
                     m.counter_value("registry_cache_misses_total") == misses0])
    b = await s.fake(behavior_map={"only_b": "echo"}, extra_reasoners=("only_b",))
    try:
        g0 = cache.generation
        await s.register(b, "b")
        s.note("generation bumped", cache.generation > g0)
        await s.req("only b", "POST", "/api/v1/execute/b.only_b", json={"input": 1})
        await s.run(s.cp.registry.heartbeat("b", {"status": "inactive"}))
        await s.req("b inactive", "POST", "/api/v1/execute/b.only_b", json={})
        await s.run(s.cp.registry.deregister("b"))
        await s.req("b gone", "POST", "/api/v1/execute/b.only_b", json={})
    finally:
        await b.stop()


async def flow_failover(s: Side):
    await s.register(s.agent, "a")
    b = await s.fake()
    try:
        await s.register(b, "b")
        await s.agent.stop()  # node a's server is gone: connection refused
        _, doc, _ = await s.req("failover", "POST", "/api/v1/execute/a.echo",
                                json={"input": "hi", "retry_policy": FAST_RETRY})
        s.note("failover", [s.cp.metrics.counter_value("gateway_failovers_total") >= 1,
                            len(b.calls)])
    finally:
        await b.stop()


async def flow_dead_letter_requeue(s: Side):
    await s.register(s.agent, "a")
    await s.agent.stop()
    _, doc, _ = await s.req("down", "POST", "/api/v1/execute/a.echo",
                            json={"input": 7, "retry_policy": FAST_RETRY})
    eid = doc["execution_id"]
    await s.req("list", "GET", "/api/v1/dead-letter")
    await s.req("requeue missing", "POST", "/api/v1/dead-letter/missing/requeue")
    await s.agent.start()
    _, other, _ = await s.req("other", "POST", "/api/v1/execute/a.echo", json={})
    await s.req("requeue completed", "POST",
                f"/api/v1/dead-letter/{other['execution_id']}/requeue")
    await s.req("requeue", "POST", f"/api/v1/dead-letter/{eid}/requeue")
    s.note("requeued", await s.poll(eid))
    s.note("counter", s.cp.metrics.counter_value("gateway_dead_letter_requeued_total"))
    await s.req("list after", "GET", "/api/v1/dead-letter")


async def flow_node_down_requeue(s: Side):
    a = await s.fake(behavior_map={"task": "silent202"}, extra_reasoners=("task",))
    b = await s.fake(behavior_map={"task": "echo"}, extra_reasoners=("task",))
    try:
        await s.register(a, "a")
        await s.register(b, "b")
        _, doc, _ = await s.req("async", "POST", "/api/v1/execute/async/a.task",
                                json={"input": "payload"})
        eid = doc["execution_id"]
        for _ in range(200):
            if a.calls:
                break
            await asyncio.sleep(0.01)
        await asyncio.sleep(0.05)
        await s.run(s.cp.registry.heartbeat("a", {"status": "inactive"}))
        s.note("requeued", await s.poll(eid))
        s.note("orphans", s.cp.metrics.counter_value("gateway_orphans_requeued_total"))
    finally:
        await a.stop()
        await b.stop()


async def flow_orphan_cleanup(s: Side):
    await s.register(s.agent, "fake-agent")
    types = s.types
    ex = types.Execution(execution_id="exec_orphan", target="fake-agent.echo",
                         target_type=types.TargetType.REASONER,
                         status=types.ExecutionStatus.QUEUED, run_id="run_orphan")
    s.cp.storage.create_execution(ex)
    res = await s.run(s.cp.cleanup_once())
    s.note("cleanup", [res["stale"] >= 1, res["deleted"]])
    await s.req("orphan", "GET", "/api/v1/executions/exec_orphan")


async def flow_sse_events_and_stream_bytes(s: Side):
    await s.register(s.agent, "fake-agent")
    events: list = []

    async def consume():
        async with aiohttp.ClientSession(base_url=s.base_url) as c:
            async with c.get("/api/v1/events/executions") as resp:
                s.note("events content type", resp.headers["Content-Type"])
                async for line in resp.content:
                    if line.startswith(b"data: "):
                        events.append(json.loads(line[6:]))
                        if events[-1].get("terminal"):
                            return

    task = asyncio.create_task(consume())
    await asyncio.sleep(0.2)
    _, doc, _ = await s.req("echo", "POST", "/api/v1/execute/fake-agent.echo",
                            json={"input": 2})
    await asyncio.wait_for(task, 10)
    s.note("events", events)
    # two more events: the server's next writes find the subscriber gone, so
    # its handler ends now (not at the 15 s keep-alive comment)
    for i in range(2):
        await s.req(f"after {i}", "POST", "/api/v1/execute/fake-agent.echo", json={})
    await asyncio.sleep(0.05)
    # a terminal execution's stream: the raw bytes on the wire
    port = int(s.base_url.rsplit(":", 1)[1])
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET /api/v1/executions/{doc['execution_id']}/stream HTTP/1.1\r\n"
                 f"Host: x\r\nConnection: close\r\n\r\n".encode())
    raw = await asyncio.wait_for(reader.read(), 10)
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    lines = [ln for ln in head.decode().split("\r\n") if not ln.lower().startswith(
        ("date:", "server:", "connection:"))]
    s.note("stream head", lines)
    s.note("stream body", re.sub(rb"(exec|run)_[0-9a-f]{20}", rb"\1_<id>", body).decode())
    await s.req("stream unknown", "GET", "/api/v1/executions/exec_nope/stream")
    await s.req("trace", "GET", f"/api/v1/executions/{doc['execution_id']}/trace")


async def flow_metrics_names(s: Side):
    await s.register(s.agent, "fake-agent")
    await s.req("echo", "POST", "/api/v1/execute/fake-agent.echo", json={})
    await s.req("boom", "POST", "/api/v1/execute/fake-agent.boom",
                json={"retry_policy": FAST_RETRY})
    await s.req("heartbeat", "POST", "/api/v1/nodes/fake-agent/heartbeat", json={"stats": {
        "decode_tokens": 5, "latency_hist": {"ttft_ms": {
            "buckets": [1.0, 10.0], "counts": [1, 1, 0], "sum": 4.0, "count": 2}}}})
    async with s.http.get("/metrics") as r:
        s.note("metrics status", [r.status, r.headers["Content-Type"]])
        text = await r.text()
    s.note("metric names", sorted(re.findall(r"^# TYPE (\S+) (\S+)", text, re.M)))


class _FrozenClock:
    """Stands in for the ``time`` module inside both identity modules: the
    issuance clock fixed, so credentials compare byte for byte."""

    strftime = staticmethod(time.strftime)

    @staticmethod
    def gmtime(secs=None):
        return time.gmtime(1_700_000_000)


@contextlib.contextmanager
def frozen_issuance_clock():
    from agentfield_tpu.control_plane import identity as jid
    from agentfield_tpu_torch.control_plane import identity as tid

    saved = jid.time, tid.time
    jid.time = tid.time = _FrozenClock
    try:
        yield
    finally:
        jid.time, tid.time = saved


async def flow_identity(s: Side):
    """The JAX server's identity routes (``server.py:837-962``): DIDs,
    credential issue (404/409/410), verify (valid, tampered, re-signed by
    a foreign key, malformed), workflow chains (404/409, GET read-only, POST
    recorded), on executions with fixed ids and clocks."""
    import base64

    types = s.types
    await s.register(s.agent, "fake-agent")
    await s.req("org did", "GET", "/api/v1/did/org")
    await s.req("node did", "GET", "/api/v1/did/fake-agent")
    await s.req("node did unknown", "GET", "/api/v1/did/ghost")

    def make(eid, status, **kw):
        ex = types.Execution(execution_id=eid, target="fake-agent.echo",
                             target_type=types.TargetType.REASONER, status=status,
                             run_id="run_ident", created_at=1.0e9, **kw)
        s.cp.storage.create_execution(ex)
        return ex

    make("exec_done", types.ExecutionStatus.COMPLETED, input={"a": [1, "x"]},
         result={"echo": {"a": [1, "x"]}}, started_at=1.0e9 + 1, finished_at=1.0e9 + 2)
    running = make("exec_busy", types.ExecutionStatus.RUNNING, input={"n": 2})
    with frozen_issuance_clock():
        _, doc, _ = await s.req("issue", "POST", "/api/v1/vc/executions/exec_done")
        await s.req("issue running", "POST", "/api/v1/vc/executions/exec_busy")
        await s.req("issue unknown", "POST", "/api/v1/vc/executions/exec_ghost")
        vc = doc["vc"]
        await s.req("verify", "POST", "/api/v1/vc/verify", json={"vc": vc})
        tampered = json.loads(json.dumps(vc))
        tampered["credentialSubject"]["result_digest"] = "A" * 43
        await s.req("verify tampered", "POST", "/api/v1/vc/verify", json={"vc": tampered})
        foreign = json.loads(json.dumps(tampered))
        foreign["proof"]["verificationMethod"] = (
            "did:key:z6MkhaXgBZDvotDkL5257faiztiGiC2QtKLGpbnnEGta2doK")
        await s.req("verify foreign", "POST", "/api/v1/vc/verify", json={"vc": foreign})
        for label, bad in (("no proof", {k: v for k, v in vc.items() if k != "proof"}),
                           ("proof not a dict", {**vc, "proof": "x"}),
                           ("no issuer", {k: v for k, v in vc.items() if k != "issuer"}),
                           ("short signature", {**vc, "proof": {**vc["proof"], "proofValue":
                                                base64.urlsafe_b64encode(b"x" * 63).decode()}}),
                           ("bad did", {**vc, "issuer": "did:web:x", "proof": {
                               **vc["proof"], "verificationMethod": "did:web:x"}})):
            await s.req(f"verify {label}", "POST", "/api/v1/vc/verify", json={"vc": bad})
        await s.req("verify no vc", "POST", "/api/v1/vc/verify", json={"x": 1})
        await s.req("chain non-terminal", "GET", "/api/v1/vc/workflows/run_ident")
        running.status = types.ExecutionStatus.FAILED
        running.error = "boom"
        running.finished_at = 1.0e9 + 3
        s.cp.storage.update_execution(running)
        await s.req("chain", "GET", "/api/v1/vc/workflows/run_ident")
        await s.req("credentials after GET", "GET", "/api/ui/v1/credentials?subject_type=workflow")
        await s.req("chain post", "POST", "/api/v1/vc/workflows/run_ident")
        await s.req("credentials", "GET", "/api/ui/v1/credentials")
        await s.req("chain unknown", "GET", "/api/v1/vc/workflows/run_ghost")


async def flow_identity_offloaded_payload_gone(s: Side):
    """A credential over an offloaded payload whose file is gone: 410."""
    import pathlib

    await s.register(s.agent, "fake-agent")
    _, doc, _ = await s.req("echo big", "POST", "/api/v1/execute/fake-agent.echo",
                            json={"input": {"blob": "z" * 70_000}})
    files = [f for f in pathlib.Path(s.cp.payloads.base).rglob("*") if f.is_file()]
    s.note("offloaded files", len(files))
    for f in files:
        f.unlink()
    _, body, _ = await s.req("issue", "POST", f"/api/v1/vc/executions/{doc['execution_id']}")
    s.record[-1][2] = {"error": re.sub(r"\(.*\)$", "(<path>)", body["error"])}
    await s.req("chain", "GET", f"/api/v1/vc/workflows/{doc['run_id']}")
    s.record[-1][2] = {"error": re.sub(r"\(.*\)$", "(<path>)", s.record[-1][2]["error"])}


FLOWS = {
    "register_heartbeat_list": (flow_register_heartbeat_list, {}),
    "sync_200_and_202": (flow_sync_200_and_202, {}),
    "async_poll_batch": (flow_async_poll_batch, {}),
    "error_paths": (flow_error_paths, {}),
    "agent_timeout": (flow_agent_timeout, {"agent_timeout": 0.2}),
    "backpressure_503": (flow_backpressure_503, {"async_workers": 0, "queue_capacity": 1}),
    "sync_wait_timeout": (flow_sync_wait_timeout, {"sync_wait_timeout": 0.3}),
    "memory": (flow_memory, {}),
    "vectors": (flow_vectors, {}),
    "lowercase_headers_duplicate": (flow_lowercase_headers_duplicate, {}),
    "input_validation": (flow_input_validation, {}),
    "reasoner_metrics_runs_dag": (flow_reasoner_metrics, {}),
    "notes_workflow_events": (flow_notes_and_workflow_events, {}),
    "registry_cache": (flow_registry_cache, {}),
    "failover": (flow_failover, {}),
    "dead_letter_requeue": (flow_dead_letter_requeue, {}),
    "node_down_requeue": (flow_node_down_requeue, {}),
    "orphan_cleanup": (flow_orphan_cleanup, {"stale_after": 0.0}),
    "sse_events_stream_bytes": (flow_sse_events_and_stream_bytes, {}),
    "metrics_names": (flow_metrics_names, {}),
    "identity": (flow_identity, {}),
}


@pytest.mark.parametrize("name", list(FLOWS))
@async_test
async def test_flow_same_on_both_control_planes(name):
    flow, kw = FLOWS[name]
    j, t = await both(flow, **kw)
    assert_same(j, t)


@async_test
async def test_backpressure_429_with_retry_after():
    async def flow(s: Side):
        s.agent.slow_s = 1.0
        await s.register(s.agent, "fake-agent")
        for i in range(6):
            st, _, hdrs = await s.req(f"async {i}", "POST",
                                      "/api/v1/execute/async/fake-agent.slow", json={})
            if st == 429:
                s.note("retry-after", float(hdrs["Retry-After"]))
        async with s.http.get("/metrics") as r:
            s.note("counter", "agentfield_gateway_backpressure_total" in await r.text())

    for ctx in (jax_side, port_side):
        async with ctx(async_workers=1, queue_capacity=1) as s:
            await flow(s)
            codes = [r[1] for r in s.record if r[0].startswith("async")]
            assert 429 in codes, (s.name, codes)
            assert set(codes) <= {202, 429}, (s.name, codes)
            assert all(r[1] >= 1 for r in s.record if r[0] == "retry-after"), s.record
            assert s.record[-1] == ["counter", True]


@async_test
async def test_webhook_hmac_and_retry_on_both():
    for ctx in (jax_side, port_side):
        received, attempts = [], {"n": 0}

        async def receiver(req: web.Request):
            attempts["n"] += 1
            if attempts["n"] == 1:
                return web.Response(status=500)  # one retry
            received.append({"body": await req.read(), "sig": req.headers.get(SIGNATURE_HEADER)})
            return web.Response(status=200)

        port = free_port()
        app = web.Application()
        app.router.add_post("/hook", receiver)
        runner = web.AppRunner(app)
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", port).start()
        try:
            async with ctx(webhook_secret="s3cret") as s:
                s.cp.webhooks.base_backoff = 0.05
                await s.register(s.agent, "fake-agent")
                await s.req("echo", "POST", "/api/v1/execute/fake-agent.echo",
                            json={"input": 1, "webhook_url": f"http://127.0.0.1:{port}/hook"})
                for _ in range(200):
                    if received:
                        break
                    await asyncio.sleep(0.05)
                assert received, f"{s.name}: webhook never delivered"
                body = received[0]["body"]
                assert received[0]["sig"] == sign_payload("s3cret", body)
                assert twebhooks.sign_payload("s3cret", body) == received[0]["sig"]
                assert json.loads(body)["status"] == "completed"
                assert attempts["n"] == 2
        finally:
            await runner.cleanup()


@async_test
async def test_port_identity_routes_answer_501_and_large_body_413(tmp_path):
    """The identity routes answer as the JAX server's (the name is the
    test's older one, from when the port answered 501 there): a credential
    over an offloaded payload whose file is gone is a 410 on both servers,
    and the identity flow of the comparison above answers the same on both.
    A body past the 64 MiB limit is a 413 on both servers."""
    j, t = await both(flow_identity_offloaded_payload_gone, payload_dir=str(tmp_path))
    assert_same(j, t)
    assert [r[1] for r in t if r[0] in ("issue", "chain")] == [410, 410], t
    assert t[2][0] == "offloaded files" and t[2][1] >= 1, t[2]
    j, t = await both(flow_identity)
    assert_same(j, t)
    codes = {r[0]: r[1] for r in t if len(r) == 3}
    assert codes["issue"] == 200 and codes["issue running"] == 409, codes
    assert codes["chain non-terminal"] == 409 and codes["chain unknown"] == 404, codes
    reasons = {r[0]: r[2].get("reason") for r in t if r[0].startswith("verify")}
    assert reasons["verify"] == "ok" and reasons["verify tampered"] == "signature invalid"
    assert reasons["verify foreign"] == "proof key does not match issuer", reasons
    big = b'{"value": "' + b"x" * (64 * 1024 * 1024) + b'"}'
    statuses = []
    for ctx in (jax_side, port_side):
        async with ctx() as s:
            st, body, _ = await s.req("big", "POST", "/api/v1/memory/k", data=big,
                                      headers={"Content-Type": "application/json"})
            statuses.append(st)
            assert "Maximum request body size 67108864 exceeded" in body, body
    assert statuses == [413, 413]


# -- http.py on its own: what the flows above do not reach ------------------


@async_test
async def test_http_client_errors_are_distinct():
    """Connection refused, a server that resets mid-answer, a timeout and
    an HTTP status each raise their own ``ClientError`` subclass."""
    from agentfield_tpu_torch.control_plane import http

    async def reset(reader, writer):
        await reader.readline()
        writer.transport.abort()

    async def hang(reader, writer):
        await asyncio.sleep(5)

    servers = [await asyncio.start_server(f, "127.0.0.1", 0) for f in (reset, hang)]
    ports = [s.sockets[0].getsockname()[1] for s in servers]
    async with http.ClientSession(timeout=http.ClientTimeout(total=0.3)) as s:
        with pytest.raises(http.ClientConnectorError) as e:
            await s.get(f"http://127.0.0.1:{free_port()}/x")
        assert isinstance(e.value, (http.ClientError, OSError))
        with pytest.raises(http.ServerDisconnectedError):
            await s.get(f"http://127.0.0.1:{ports[0]}/x")
        with pytest.raises(http.ServerTimeoutError) as e:
            await s.get(f"http://127.0.0.1:{ports[1]}/x")
        assert isinstance(e.value, asyncio.TimeoutError)
    for srv in servers:
        srv.close()
    async with port_side() as side:
        async with http.ClientSession(base_url=side.base_url) as s:
            async with s.get("/api/v1/nodes/ghost") as r:
                with pytest.raises(http.ClientResponseError) as e:
                    r.raise_for_status()
                assert e.value.status == 404
            async with s.get("/metrics") as r:
                with pytest.raises(http.ContentTypeError):
                    await r.json()


@async_test
async def test_http_keepalive_chunked_request_and_pool():
    """One pooled connection carries many requests; a chunked request body
    is read whole; a 202 with an empty body frees its connection."""
    from agentfield_tpu_torch.control_plane import http

    async with port_side() as side:
        conn = http.TCPConnector(limit=4, limit_per_host=1)
        async with http.ClientSession(base_url=side.base_url, connector=conn) as s:
            for i in range(20):
                async with s.post(f"/api/v1/memory/k{i}", json={"value": i}) as r:
                    assert r.status == 200 and await r.json() == {"ok": True}
            assert sum(len(v) for v in conn._idle.values()) == 1

            async def get(i):  # 8 at once queue on the one connection the host may have
                async with s.get(f"/api/v1/memory/k{i}") as r:
                    return await r.json()

            assert await asyncio.gather(*(get(i) for i in range(8))) == [
                {"value": i} for i in range(8)]
            assert sum(len(v) for v in conn._idle.values()) == 1
        port = int(side.base_url.rsplit(":", 1)[1])
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        body = json.dumps({"value": "chunked"}).encode()
        writer.write(b"POST /api/v1/memory/ck HTTP/1.1\r\nHost: x\r\n"
                     b"Transfer-Encoding: chunked\r\nContent-Type: application/json\r\n\r\n"
                     + b"%x\r\n%s\r\n" % (5, body[:5]) + b"%x\r\n%s\r\n" % (len(body) - 5, body[5:])
                     + b"0\r\n\r\nGET /api/v1/memory/ck HTTP/1.1\r\nHost: x\r\n"
                     b"Connection: close\r\n\r\n")
        raw = await asyncio.wait_for(reader.read(), 10)
        writer.close()
        assert raw.count(b"HTTP/1.1 200 OK") == 2 and raw.endswith(b'{"value": "chunked"}')


@async_test
async def test_http_client_resends_only_idempotent_requests_on_a_dropped_connection():
    """A server that answers a connection's first request, then reads the
    second whole and closes without answering: a GET is sent again on a new
    connection; a POST is not (the server may have run it) and raises
    ``ServerDisconnectedError``, so the gateway's own retry logic sees it."""
    from agentfield_tpu_torch.control_plane import http

    seen: list[str] = []

    async def serve(reader, writer):
        n = 0
        while True:
            line = await reader.readline()
            if not line:
                break
            length = 0
            while (h := await reader.readline()) not in (b"\r\n", b""):
                if h.lower().startswith(b"content-length:"):
                    length = int(h.split(b":")[1])
            await reader.readexactly(length)
            method, path = line.decode().split(" ")[:2]
            seen.append(f"{method} {path}")
            n += 1
            if n == 2:
                break
            writer.write(b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n\r\nok")
            await writer.drain()
        writer.close()

    srv = await asyncio.start_server(serve, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{srv.sockets[0].getsockname()[1]}"
    try:
        async with http.ClientSession(base_url=base) as s:
            async with s.get("/a") as r:
                assert await r.text() == "ok"  # the connection goes back to the pool
            with pytest.raises(http.ServerDisconnectedError):
                async with s.post("/p", json={"x": 1}):
                    pass
            async with s.get("/b") as r:
                assert await r.text() == "ok"
            async with s.get("/g") as r:  # dropped on the pooled connection, sent again
                assert r.status == 200 and await r.text() == "ok"
    finally:
        srv.close()
        await srv.wait_closed()
    assert seen == ["GET /a", "POST /p", "GET /b", "GET /g", "GET /g"]


@async_test
async def test_http_server_drops_a_stream_whose_handler_raises():
    """A handler that raises after its chunked stream was prepared gets no
    second response written into the stream: the connection is dropped, so
    the client's chunk parser never reads a 500 head as data."""
    from agentfield_tpu_torch.control_plane import http

    routes = http.RouteTableDef()

    @routes.get("/sse")
    async def sse(request):
        resp = http.StreamResponse(headers={"Content-Type": "text/event-stream"})
        await resp.prepare(request)
        await resp.write(b"data: one\n\n")
        raise RuntimeError("boom mid-stream")

    @routes.get("/late")
    async def late(request):
        resp = http.StreamResponse()
        await resp.prepare(request)
        raise http.HTTPException(404)

    app = http.Application()
    app.add_routes(routes)
    runner = http.AppRunner(app)
    await runner.setup()
    site = http.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = runner.addresses[0][1]
    try:
        for path in ("/sse", "/late"):
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
            raw = await asyncio.wait_for(reader.read(), 10)  # EOF: the server closed
            writer.close()
            assert raw.count(b"HTTP/1.1 ") == 1 and raw.startswith(b"HTTP/1.1 200 OK"), raw
            assert b"500" not in raw and not raw.endswith(b"0\r\n\r\n"), raw
            if path == "/sse":
                assert raw.endswith(b"b\r\ndata: one\n\n\r\n"), raw
    finally:
        await runner.cleanup()


@async_test
async def test_http_websocket_client_against_the_node_side():
    """The asyncio WebSocket client against the port's threaded WebSocket
    server (``serving/websocket.py``): text and binary messages, a binary
    message given in parts (a 2 MiB KV blob's header and its pages),
    fragmented server messages reassembled, a ping answered, a close."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from agentfield_tpu_torch.control_plane import http
    from agentfield_tpu_torch.serving import websocket as nws

    got: list = []

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def do_GET(self):
            self.send_response(101)
            for k, v in nws.handshake_headers(self.headers):
                self.send_header(k, v)
            self.end_headers()
            self.wfile.flush()
            ws = nws.WebSocket(self.connection, self.rfile)
            sock = self.connection  # raw frames first: a ping, then a fragmented text
            sock.sendall(nws.encode_frame(nws.OP_PING, b"hb"))
            sock.sendall(nws.encode_frame(nws.OP_TEXT, b"frag", fin=False)
                         + nws.encode_frame(nws.OP_CONT, b"mented"))
            while True:
                msg = ws.recv()
                if msg is None:
                    break
                got.append(msg)
                ws.send_binary(b"echo:", bytes(msg[1]) if msg[0] == nws.OP_BINARY
                               else msg[1].encode())
            self.close_connection = True

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    srv.daemon_threads = True
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        async with http.ClientSession() as s:
            ws = await s.ws_connect(f"http://127.0.0.1:{srv.server_address[1]}/channel",
                                    heartbeat=5.0)
            first = await ws.receive()
            assert (first.type, first.data) == (http.WSMsgType.TEXT, "fragmented")
            await ws.send_str(json.dumps({"kind": "ping"}))
            blob = np.random.default_rng(0).integers(0, 256, 2 << 20, dtype=np.uint8).tobytes()
            head = b"AFKV1" + bytes([3]) + b"fid" + (7).to_bytes(4, "big")
            await ws.send_bytes(head, memoryview(blob))
            a = await ws.receive()
            b = await ws.receive()
            assert a.type == http.WSMsgType.BINARY and a.data == b'echo:{"kind": "ping"}'
            assert b.type == http.WSMsgType.BINARY and b.data == b"echo:" + head + blob
            await ws.close()
            assert ws.closed
        assert got[0] == (nws.OP_TEXT, '{"kind": "ping"}')
        assert got[1][0] == nws.OP_BINARY and bytes(got[1][1]) == head + blob
    finally:
        srv.shutdown()
        srv.server_close()
