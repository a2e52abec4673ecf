"""The port's SDK ``Agent`` end to end, on the CPU: the scripts of the JAX
package's ``tests/test_sdk_e2e.py`` (15) and ``tests/test_ai_resilience.py``
(4), each written once against an SDK namespace and run three ways:

- the port's ``Agent`` against the port's control plane;
- the JAX ``Agent`` against the port's control plane (the oracle);
- the port's ``Agent`` against the JAX control plane (``CPHarness``).

Every run uses a control plane of its own, with the port's model node
(``python -m agentfield_tpu_torch.serving.model_node --device cpu --model
llama-tiny --vision vit-tiny``, one child process for the module) registered
by hand as the JAX test registers a node, its gateway reaching the node over
the channel. The scripts' results, greedy tokens included, are equal across
the three runs. The JAX tests' own failures under load (the lock witness)
are no oracle here: the scripts are called directly.

The asyncio node half of the channel (``control_plane/channel.py``'s
``ChannelServer`` on ``http.WebSocketResponse``) is held against RFC 6455
with the vectors ``tests/test_torch_channel.py`` uses, and against the JAX
``ChannelServer`` frame for frame on a dropped and re-attached stream.
"""

from __future__ import annotations

import asyncio
import base64
import json
import math
import os
import pathlib
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import types

import aiohttp
import numpy as np
import pytest
import torch

from agentfield_tpu.control_plane import channel as jax_channel
from agentfield_tpu.sdk import agent as jax_agent_mod
from agentfield_tpu.sdk import context as jax_context
from agentfield_tpu.sdk import multimodal as jax_mm
from agentfield_tpu_torch.control_plane import channel as port_channel
from agentfield_tpu_torch.control_plane import http
from agentfield_tpu_torch.control_plane.server import ControlPlane, ControlPlaneThread
from agentfield_tpu_torch.sdk import agent as port_agent_mod
from agentfield_tpu_torch.sdk import context as port_context
from agentfield_tpu_torch.sdk import multimodal as port_mm
from tests.helpers_cp import CPHarness, async_test, free_port

ROOT = pathlib.Path(__file__).resolve().parents[1]
NODE = "torch-node"
MAX_CONTEXT = 32 * 16  # the node's EngineConfig: max_pages_per_seq 32, pages of 16

PORT_SDK = types.SimpleNamespace(
    name="port", Agent=port_agent_mod.Agent, AgentRouter=port_agent_mod.AgentRouter,
    AIConfig=port_agent_mod.AIConfig, FileContent=port_mm.FileContent,
    UnsupportedModalityError=port_mm.UnsupportedModalityError,
    current_context=port_context.current_context)
JAX_SDK = types.SimpleNamespace(
    name="jax", Agent=jax_agent_mod.Agent, AgentRouter=jax_agent_mod.AgentRouter,
    AIConfig=jax_agent_mod.AIConfig, FileContent=jax_mm.FileContent,
    UnsupportedModalityError=jax_mm.UnsupportedModalityError,
    current_context=jax_context.current_context)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Node:
    """The port's model node as a child process, registered with no
    control plane of its own: each run registers it by hand."""

    def __init__(self):
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                   MKL_NUM_THREADS="1", AGENTFIELD_DRAIN_GRACE="1")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "agentfield_tpu_torch.serving.model_node", "--device", "cpu",
             "--model", "llama-tiny", "--vision", "vit-tiny", "--port", "0",
             "--node-id", NODE], cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self.lines: list[str] = []
        t0 = time.monotonic()
        self.base = None
        while self.base is None:
            line = self.proc.stdout.readline()
            assert line and time.monotonic() - t0 < 60, f"the node exited: {self.lines}"
            self.lines.append(line)
            m = re.search(r"serving on (http://\S+)", line)
            if m:
                self.base = m.group(1)
        self._drain = threading.Thread(target=lambda: self.lines.extend(self.proc.stdout),
                                       daemon=True)
        self._drain.start()

    def spec(self) -> dict:
        return {"node_id": NODE, "base_url": self.base, "kind": "model",
                "reasoners": [{"id": "generate"}, {"id": "embed"}],
                "metadata": {"model": "llama-tiny", "modalities": ["text", "image-in"],
                             "role": "mixed", "channel": True}}

    def stop(self) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(30)
        self._drain.join(10)
        return rc


@pytest.fixture(scope="module")
def node():
    n = Node()
    try:
        yield n
    finally:
        n.stop()


class Env:
    """One run's control plane (its URL, a client), the node's base URL."""

    def __init__(self, cp_url: str, http_client, node: Node):
        self.cp_url, self.http, self.node = cp_url, http_client, node

    async def post(self, path: str, body: dict, headers: dict | None = None) -> dict:
        async with self.http.post(self.cp_url + path, json=body, headers=headers or {}) as r:
            assert r.status < 500, await r.text()
            return await r.json()

    async def get(self, path: str) -> dict:
        async with self.http.get(self.cp_url + path) as r:
            assert r.status == 200, await r.text()
            return await r.json()

    async def register(self, spec: dict) -> None:
        async with self.http.post(self.cp_url + "/api/v1/nodes", json=spec) as r:
            assert r.status in (200, 201), await r.text()

    async def node_stats(self) -> dict:
        async with self.http.get(self.node.base + "/stats") as r:
            return await r.json()


async def _run(script, sdk, plane: str, node: Node):
    """``script`` with ``sdk``'s Agent against a fresh control plane of
    ``plane`` ("port" or "jax"), the node registered by hand."""
    async with aiohttp.ClientSession() as client:
        if plane == "port":
            cpt = ControlPlaneThread(ControlPlane(channel=True))
            url = await asyncio.to_thread(cpt.start)
            try:
                env = Env(url, client, node)
                if getattr(script, "needs_node", True):
                    await env.register(node.spec())
                return await script(sdk, env)
            finally:
                await asyncio.to_thread(cpt.stop)
        async with CPHarness(channel=True) as h:
            env = Env(h.base_url, client, node)
            if getattr(script, "needs_node", True):
                await env.register(node.spec())
            return await script(sdk, env)


def _three_ways(script, node: Node):
    """The script's results: port Agent / port CP, JAX Agent / port CP, port
    Agent / JAX CP; all three equal."""
    async def go():
        return [await _run(script, PORT_SDK, "port", node),
                await _run(script, JAX_SDK, "port", node),
                await _run(script, PORT_SDK, "jax", node)]

    port, jax_agent, jax_cp = asyncio.run(asyncio.wait_for(go(), 240))
    assert port == jax_agent, ("the port's Agent != the JAX Agent", port, jax_agent)
    assert port == jax_cp, ("the port's control plane != the JAX one", port, jax_cp)
    return port


# -- the scripts of tests/test_sdk_e2e.py ---------------------------------


async def reasoner_schema_and_direct_invoke(sdk, env):
    app = sdk.Agent("greeter", env.cp_url)

    @app.reasoner()
    def say_hello(name: str, excited: bool = False) -> str:
        return f"Hello {name}{'!' if excited else '.'}"

    await app.start()
    try:
        spec = app._node_spec()["reasoners"][0]
        assert spec["id"] == "say_hello" and "name" in spec["input_schema"]["properties"]
        doc = await env.post("/api/v1/execute/greeter.say_hello",
                             {"input": {"name": "Ada", "excited": True}})
        assert doc["status"] == "completed" and doc["result"] == "Hello Ada!"
        bad = await env.post("/api/v1/execute/greeter.say_hello", {"input": {"wrong": 1}})
        assert bad["status"] == "failed"
        coerced = await env.post("/api/v1/execute/greeter.say_hello",
                                 {"input": {"name": "Bo", "excited": "yes"}})
        return {"schema": spec["input_schema"], "result": doc["result"], "bad": bad["status"],
                "coerced": coerced["result"]}
    finally:
        await app.stop()


async def cross_agent_call_preserves_run_dag(sdk, env):
    upstream, downstream = sdk.Agent("upstream", env.cp_url), sdk.Agent("downstream", env.cp_url)
    seen = {}

    @downstream.reasoner()
    def leaf(x: int) -> int:
        seen["leaf_ctx"] = sdk.current_context()
        return x * 2

    @upstream.reasoner()
    async def root(x: int) -> int:
        seen["root_ctx"] = sdk.current_context()
        return await upstream.call("downstream.leaf", x=x) + 1

    await upstream.start()
    await downstream.start()
    try:
        doc = await env.post("/api/v1/execute/upstream.root", {"input": {"x": 5}})
        assert doc["status"] == "completed" and doc["result"] == 11
        assert seen["leaf_ctx"].run_id == seen["root_ctx"].run_id == doc["run_id"]
        assert seen["leaf_ctx"].parent_execution_id == seen["root_ctx"].execution_id
        execs = (await env.get(f"/api/v1/executions?run_id={doc['run_id']}"))["executions"]
        assert len(execs) == 2
        return {"result": doc["result"], "targets": sorted(e["target"] for e in execs)}
    finally:
        await upstream.stop()
        await downstream.stop()


async def agent_ai_through_model_node(sdk, env):
    app = sdk.Agent("greeting-agent", env.cp_url)

    @app.reasoner()
    async def say_hello(name: str) -> dict:
        out = await app.ai(prompt=f"Hello {name}", max_new_tokens=6)
        return {"reply_tokens": out["tokens"], "model": out["model"]}

    await app.start()
    try:
        doc = await env.post("/api/v1/execute/greeting-agent.say_hello",
                             {"input": {"name": "world"}})
        assert doc["status"] == "completed", doc
        assert len(doc["result"]["reply_tokens"]) == 6 and doc["result"]["model"] == "llama-tiny"
        return doc["result"]
    finally:
        await app.stop()


async def concurrent_ai_calls_share_engine(sdk, env):
    caller = sdk.Agent("caller", env.cp_url)
    await caller.start()
    try:
        before = await env.node_stats()
        outs = await asyncio.gather(*(caller.ai(prompt=f"request number {i}", max_new_tokens=5)
                                      for i in range(8)))
        assert all(len(o["tokens"]) == 5 for o in outs)
        after = await env.node_stats()
        tokens = after["decode_tokens"] - before["decode_tokens"]
        steps = after["decode_steps"] - before["decode_steps"]
        assert tokens > steps, (tokens, steps)  # decode steps shared across slots
        return {"tokens": [o["tokens"] for o in outs]}
    finally:
        await caller.stop()


async def ai_stream_tokens_and_dag(sdk, env):
    caller = sdk.Agent("streamer", env.cp_url)
    await caller.start()
    try:
        frames = [f async for f in caller.ai_stream(prompt="stream me", max_new_tokens=5)]
        assert len(frames) == 5
        assert frames[-1]["finished"] and frames[-1]["finish_reason"] == "length"
        assert [f["index"] for f in frames] == list(range(5))
        flat = await caller.ai(prompt="stream me", max_new_tokens=5)
        assert [f["token"] for f in frames] == flat["tokens"]
        runs = await caller.client.run_summaries()
        streamed = [r for r in runs if f"{NODE}.generate" in r["targets"]
                    and r["executions"] == 1]
        assert streamed and streamed[-1]["overall_status"] == "completed", runs
        return {"tokens": flat["tokens"], "frames": [f["token"] for f in frames]}
    finally:
        await caller.stop()


async def router_prefixing_and_skills(sdk, env):
    app = sdk.Agent("routed", env.cp_url)
    router = sdk.AgentRouter(prefix="math")

    @router.skill()
    def add(a: int, b: int) -> int:
        return a + b

    app.include_router(router)
    await app.start()
    try:
        doc = await env.post("/api/v1/execute/routed.math_add", {"input": {"a": 2, "b": 3}})
        assert doc["status"] == "completed" and doc["result"] == 5
        assert doc["target_type"] == "skill"
        return {"result": doc["result"], "type": doc["target_type"]}
    finally:
        await app.stop()


async def memory_facade(sdk, env):
    app = sdk.Agent("memuser", env.cp_url)
    await app.start()
    try:
        await app.memory.memory_set("notes", {"v": 1}, scope="session", scope_id="s9")
        got = await app.memory.memory_get("notes", scope="session", scope_id="s9")
        assert got == {"v": 1}
        assert await app.memory.memory_get("missing", default="dflt") == "dflt"
        weird = "user/prefs?x=1&y=#z"
        await app.memory.memory_set(weird, "ok")
        assert await app.memory.memory_get(weird) == "ok"
        assert await app.memory.memory_delete(weird)
        return {"got": got}
    finally:
        await app.stop()


async def ctx_param_injection(sdk, env):
    app = sdk.Agent("ctxuser", env.cp_url)

    @app.reasoner()
    def who_am_i(ctx, tag: str) -> dict:
        return {"tag": tag, "execution_id": ctx.execution_id, "run_id": ctx.run_id}

    await app.start()
    try:
        doc = await env.post("/api/v1/execute/ctxuser.who_am_i", {"input": {"tag": "t1"}})
        assert doc["status"] == "completed"
        assert doc["result"]["execution_id"] == doc["execution_id"]
        assert doc["result"]["run_id"] == doc["run_id"]
        spec = app._node_spec()["reasoners"][0]
        assert "ctx" not in spec["input_schema"].get("properties", {})
        return {"tag": doc["result"]["tag"], "schema": spec["input_schema"]}
    finally:
        await app.stop()


async def ai_config_hierarchy(sdk, env):
    app = sdk.Agent("cfg-agent", env.cp_url, ai_defaults=sdk.AIConfig(max_new_tokens=3))

    @app.reasoner()
    async def agent_level() -> dict:
        return {"n": len((await app.ai(prompt="a"))["tokens"])}

    @app.reasoner(ai_defaults={"max_new_tokens": 5})
    async def reasoner_level() -> dict:
        return {"n": len((await app.ai(prompt="b"))["tokens"])}

    @app.reasoner(ai_defaults={"max_new_tokens": 5})
    async def call_site() -> dict:
        return {"n": len((await app.ai(prompt="c", max_new_tokens=2))["tokens"])}

    await app.start()
    try:
        out = {}
        for rid, want in (("agent_level", 3), ("reasoner_level", 5), ("call_site", 2)):
            doc = await env.post(f"/api/v1/execute/cfg-agent.{rid}", {"input": {}})
            assert doc["status"] == "completed", doc
            assert doc["result"]["n"] == want, (rid, doc["result"])
            out[rid] = doc["result"]["n"]
        return out
    finally:
        await app.stop()


async def ai_file_parts_inline_and_reject(sdk, env):
    app = sdk.Agent("file-agent", env.cp_url)
    await app.start()
    try:
        out = await app.ai(prompt="summarize:", max_new_tokens=3, files=[
            sdk.FileContent(b'{"k": 1}', name="data.json", mime="application/json")])
        assert len(out["tokens"]) == 3
        with pytest.raises(sdk.UnsupportedModalityError, match="binary"):
            await app.ai(prompt="x", files=[sdk.FileContent(b"\x00\x01\x02\xff",
                                                            name="blob.bin")])
        with pytest.raises(TypeError, match="images="):
            await app.ai(prompt="x", files=[b"\x89PNG\r\n\x1a\n" + b"0" * 16])
        return {"tokens": out["tokens"]}
    finally:
        await app.stop()


async def ai_chat_messages(sdk, env):
    app = sdk.Agent("chat-agent", env.cp_url)
    await app.start()
    try:
        out = await app.ai(messages=[{"role": "system", "content": "be brief"},
                                     {"role": "user", "content": "hi"}], max_new_tokens=4)
        assert len(out["tokens"]) == 4
        with pytest.raises(ValueError, match="exclusive"):
            await app.ai(prompt="x", messages=[{"role": "user", "content": "y"}])
        doc = await app.client.execute(f"{NODE}.generate",
                                       {"messages": [{"role": "tool", "content": "z"}]})
        assert doc["status"] == "failed" and "role" in (doc["error"] or "")
        return {"tokens": out["tokens"], "bad_role": doc["status"]}
    finally:
        await app.stop()


async def ai_chat_composes_with_schema_files_media(sdk, env):
    app = sdk.Agent("compose-agent", env.cp_url)
    await app.start()
    try:
        def msgs(c):
            return [{"role": "user", "content": c}]

        out = await app.ai(messages=msgs("pick"), max_new_tokens=40, schema={
            "type": "object", "properties": {"ok": {"type": "boolean"}}, "required": ["ok"]})
        assert isinstance(out["parsed"]["ok"], bool)
        out2 = await app.ai(messages=msgs("summarize"), max_new_tokens=3, files=[
            sdk.FileContent(b"k,v\n1,2\n", name="t.csv", mime="text/csv")])
        assert len(out2["tokens"]) == 3
        img = np.full((8, 8, 3), 0.5, np.float32)
        out3 = await app.ai(messages=msgs("describe <image>"), images=[img], max_new_tokens=3)
        assert len(out3["tokens"]) == 3
        keep = msgs("untouched")
        await app.ai(messages=keep, schema={"type": "boolean"}, max_new_tokens=30)
        assert keep == [{"role": "user", "content": "untouched"}]
        return {"parsed": out["parsed"], "tokens": [out["tokens"], out2["tokens"],
                                                    out3["tokens"]]}
    finally:
        await app.stop()


async def session_kv_reuse_across_agent_chain(sdk, env):
    prefix = list(range(40, 60))
    b = sdk.Agent("chain-b", env.cp_url)

    @b.reasoner()
    async def extend(history: list[int]) -> dict:
        out = await b.ai(tokens=history + [7, 8], max_new_tokens=3)
        return {"n": len(out["tokens"]), "tokens": out["tokens"]}

    a = sdk.Agent("chain-a", env.cp_url)

    @a.reasoner()
    async def root() -> dict:
        first = await a.ai(tokens=prefix, max_new_tokens=3)
        down = await a.call("chain-b.extend", {"history": prefix + first["tokens"]})
        return {"first": len(first["tokens"]), "down": down["n"], "tokens": down["tokens"]}

    await a.start()
    await b.start()
    try:
        hits0 = (await env.node_stats())["prefix_cache_hits"]
        doc = await env.post("/api/v1/execute/chain-a.root", {"input": {}},
                             headers={"X-Session-ID": f"chain-sess-{time.monotonic_ns()}"})
        assert doc["status"] == "completed", doc
        assert {k: doc["result"][k] for k in ("first", "down")} == {"first": 3, "down": 3}
        assert (await env.node_stats())["prefix_cache_hits"] >= hits0 + 1
        return doc["result"]
    finally:
        await a.stop()
        await b.stop()


async def ai_embed_feeds_vector_memory(sdk, env):
    app = sdk.Agent("embed-agent", env.cp_url)
    await app.start()
    try:
        e1 = await app.ai_embed("the quick brown fox")
        assert e1["dim"] > 0 and e1["pooling"] == "mean"
        assert abs(math.sqrt(sum(v * v for v in e1["embedding"])) - 1.0) < 1e-3
        e2 = await app.ai_embed("completely different words!")
        assert e1["embedding"] != e2["embedding"]
        assert (await app.ai_embed("the quick brown fox"))["embedding"] == e1["embedding"]
        for key, e in (("fox", e1), ("other", e2)):
            await env.post("/api/v1/memory/vectors/set?scope=global",
                           {"key": key, "embedding": e["embedding"], "metadata": {"t": key}})
        hits = (await env.post("/api/v1/memory/vectors/search?scope=global",
                               {"embedding": e1["embedding"], "top_k": 2}))["results"]
        assert hits[0]["key"] == "fox", hits
        t = await app.ai_embed(tokens=[5, 6, 7], pooling="last")
        assert t["tokens_used"] == 3
        return {"e1": e1["embedding"], "last": t["embedding"]}
    finally:
        await app.stop()


# -- the scripts of tests/test_ai_resilience.py ---------------------------


async def ai_fails_over_to_live_model_node(sdk, env):
    # "model-dead" sorts before the live node: the registry lists it first
    await env.register({"node_id": "model-dead", "base_url": f"http://127.0.0.1:{free_port()}",
                        "kind": "model", "reasoners": [{"id": "generate"}]})
    app = sdk.Agent("caller", env.cp_url)
    await app.start()
    try:
        out = await app.ai(prompt="hi", max_new_tokens=4)
        assert len(out["tokens"]) == 4 and out["model"] == "llama-tiny"
        return {"tokens": out["tokens"]}
    finally:
        await app.stop()


async def ai_named_dead_node_still_fails(sdk, env):
    await env.register({"node_id": "model-dead", "base_url": f"http://127.0.0.1:{free_port()}",
                        "kind": "model", "reasoners": [{"id": "generate"}]})
    app = sdk.Agent("caller", env.cp_url)
    await app.start()
    try:
        with pytest.raises(RuntimeError, match="ai\\(\\) (failed|dead_letter)") as e:
            await app.ai(prompt="hi", max_new_tokens=4, model="model-dead")
        return {"raised": str(e.value).split(":")[0]}
    finally:
        await app.stop()


# as in the JAX script, no live model node is registered: no same-model
# substitute for the gateway to fail over to
ai_named_dead_node_still_fails.needs_node = False

LONG = [(i * 7) % 500 + 1 for i in range(MAX_CONTEXT + 36)]


async def context_overflow_truncate_left(sdk, env):
    app = sdk.Agent("caller", env.cp_url)
    await app.start()
    try:
        out = await app.ai(tokens=LONG, max_new_tokens=8)
        assert len(out["tokens"]) == 8
        assert out["truncated_prompt_tokens"] == len(LONG) - (MAX_CONTEXT - 8)
        with pytest.raises(RuntimeError, match="RequestTooLongError"):
            await app.ai(tokens=LONG, max_new_tokens=8, context_overflow="error")
        return {"tokens": out["tokens"], "dropped": out["truncated_prompt_tokens"]}
    finally:
        await app.stop()


async def truncated_prompt_same_as_explicit_tail(sdk, env):
    app = sdk.Agent("caller", env.cp_url)
    await app.start()
    try:
        budget = MAX_CONTEXT - 8
        out_trunc = await app.ai(tokens=LONG, max_new_tokens=8)
        out_tail = await app.ai(tokens=LONG[-budget:], max_new_tokens=8)
        assert out_trunc["tokens"] == out_tail["tokens"]
        assert "truncated_prompt_tokens" not in out_tail
        return {"tokens": out_tail["tokens"]}
    finally:
        await app.stop()


SCRIPTS = [reasoner_schema_and_direct_invoke, cross_agent_call_preserves_run_dag,
           agent_ai_through_model_node, concurrent_ai_calls_share_engine,
           ai_stream_tokens_and_dag, router_prefixing_and_skills, memory_facade,
           ctx_param_injection, ai_config_hierarchy, ai_file_parts_inline_and_reject,
           ai_chat_messages, ai_chat_composes_with_schema_files_media,
           session_kv_reuse_across_agent_chain, ai_embed_feeds_vector_memory,
           ai_fails_over_to_live_model_node, ai_named_dead_node_still_fails,
           context_overflow_truncate_left, truncated_prompt_same_as_explicit_tail]


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda s: s.__name__)
def test_script_three_ways(node, script):
    _three_ways(script, node)


def test_byte_tokenizer_roundtrip():
    """The one script of ``test_sdk_e2e.py`` without an agent: the port's
    byte tokenizer."""
    from agentfield_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer(512)
    ids = tok.encode("hello")
    assert tok.decode(ids) == "hello" and all(0 <= t < 512 for t in ids)


@async_test
async def test_agent_refusals_name_their_items():
    """``Agent.attach_mcp`` and ``MemoryEventClient`` work (the name is the
    test's older one, from when both raised): a port agent registers a
    started ``MCPManager``'s tools as skills, an execute through the port's
    gateway reaches the tool, the agent's ``/health`` carries the manager's
    health; a ``MemoryEventClient`` sees the agent's memory set and delete,
    and its stop leaves no task."""
    from agentfield_tpu_torch.control_plane.server import run_server
    from agentfield_tpu_torch.sdk.mcp import MCPManager
    from agentfield_tpu_torch.sdk.memory_events import MemoryEventClient

    port = free_port()
    runner = await run_server(ControlPlane(), "127.0.0.1", port)
    base = f"http://127.0.0.1:{port}"
    mgr = MCPManager({"calc": {"command": sys.executable,
                               "args": [str(ROOT / "tests" / "fake_mcp_server.py")]}})
    events = MemoryEventClient(base, reconnect_delay=0.05)
    seen: list = []
    events.on_change("k*", lambda ev: seen.append((ev["type"], ev["key"])))
    app = port_agent_mod.Agent("mcpuser", base)
    tasks0 = set(asyncio.all_tasks())
    try:
        await mgr.start_all()
        assert app.attach_mcp(mgr) == ["calc_add", "calc_shout"]
        await app.start()
        await events.start()
        for _ in range(100):
            if events.connected:
                break
            await asyncio.sleep(0.02)
        async with http.ClientSession(base_url=base) as s:
            async with s.post("/api/v1/execute/mcpuser.calc_add",
                              json={"input": {"a": 2, "b": 3}}) as r:
                doc = await r.json()
            assert r.status == 200 and doc["result"] == "5", doc
            async with s.get(f"http://127.0.0.1:{app.port}/health") as r:
                health = await r.json()
            assert health["mcp"]["calc"]["alive"] and health["mcp"]["calc"]["tools"] == 2
        await app.memory.memory_set("k1", {"v": 1})
        await app.memory.memory_delete("k1")
        await app.memory.memory_set("other", 2)
        for _ in range(100):
            if len(seen) >= 2:
                break
            await asyncio.sleep(0.02)
        assert seen == [("set", "k1"), ("delete", "k1")], seen
    finally:
        await events.stop()
        await app.stop()
        await mgr.stop_all()
        await runner.cleanup()
    assert not events.connected and events._task.done()
    left = [t for t in asyncio.all_tasks() - tasks0 if not t.done()
            and t is not asyncio.current_task()]
    assert not left, left


# -- the channel's node half ----------------------------------------------

RFC_KEY, RFC_ACCEPT = "dGhlIHNhbXBsZSBub25jZQ==", "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="
MASKED_HELLO = bytes([0x81, 0x85, 0x37, 0xFA, 0x21, 0x3D, 0x7F, 0x9F, 0x4D, 0x51, 0x58])
UNMASKED_HELLO = bytes([0x81, 0x05, 0x48, 0x65, 0x6C, 0x6C, 0x6F])


def _recv_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, "the server closed the connection"
        buf += chunk
    return buf


@async_test
async def test_websocket_response_against_rfc6455():
    """The server half (``http.WebSocketResponse``) on a raw socket: the
    handshake's accept value, a masked "Hello" echoed unmasked (the RFC's
    frames), a fragmented text reassembled, a ping answered, an unmasked
    client frame closed with 1002, a request that is no upgrade a 400."""
    got: list = []

    async def echo(req):
        ws = http.WebSocketResponse()
        await ws.prepare(req)
        async for msg in ws:
            got.append((msg.type, msg.data if msg.type == http.WSMsgType.TEXT else None))
            if msg.type == http.WSMsgType.TEXT:
                await ws.send_str(msg.data)
        return ws

    app = http.Application()
    app.router.add_route("GET", "/ws", echo)
    runner = http.AppRunner(app)
    await runner.setup()
    site = http.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = site.address[1]

    def client():
        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        s.sendall((f"GET /ws HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n"
                   f"Sec-WebSocket-Key: {RFC_KEY}\r\nSec-WebSocket-Version: 13\r\n\r\n").encode())
        head = b""
        while b"\r\n\r\n" not in head:
            head += s.recv(1)
        assert head.startswith(b"HTTP/1.1 101 "), head
        assert f"Sec-WebSocket-Accept: {RFC_ACCEPT}".encode() in head, head
        s.sendall(MASKED_HELLO)
        assert _recv_exact(s, 7) == UNMASKED_HELLO
        # "Hel" + "lo", the RFC's fragmented text, masked with the same key
        s.sendall(bytes([0x01, 0x83, 0x37, 0xFA, 0x21, 0x3D, 0x7F, 0x9F, 0x4D]))
        s.sendall(bytes([0x80, 0x82, 0x37, 0xFA, 0x21, 0x3D, 0x5B, 0x95]))
        assert _recv_exact(s, 7) == UNMASKED_HELLO
        s.sendall(bytes([0x89, 0x85, 0x37, 0xFA, 0x21, 0x3D, 0x7F, 0x9F, 0x4D, 0x51, 0x58]))
        assert _recv_exact(s, 7) == bytes([0x8A, 0x05]) + b"Hello"  # the pong
        s.sendall(UNMASKED_HELLO)  # a client frame must be masked
        close = _recv_exact(s, 4)
        assert close[0] == 0x88 and int.from_bytes(close[2:4], "big") == 1002, close
        s.close()
        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        s.sendall(b"GET /ws HTTP/1.1\r\nHost: x\r\n\r\n")
        assert s.recv(64).startswith(b"HTTP/1.1 400 "), "a plain GET was upgraded"
        s.close()

    await asyncio.to_thread(client)
    await runner.cleanup()
    assert got == [(http.WSMsgType.TEXT, "Hello")] * 2 + [(http.WSMsgType.ERROR, None)]


async def _slow_stream(payload, headers, emit):
    for i in range(payload["n"]):
        await emit({"token": i, "index": i, "finished": i == payload["n"] - 1})
        await asyncio.sleep(0.02)
    return {"tokens": list(range(payload["n"]))}


async def _drop_and_reattach(make_server, serve, ws_connect) -> list[str]:
    """A stream dropped after 3 frames and re-attached from seq 3: every
    frame text the client got, in order, then an unknown id's reattach."""
    server = make_server()
    url, stop = await serve(server)
    texts: list[str] = []
    try:
        ws, close = await ws_connect(url)
        await ws.send_str(json.dumps({"kind": "submit", "exec_id": "e1", "target": "gen",
                                      "input": {"n": 8}, "headers": {}, "stream": True}))
        while len([t for t in texts if '"token"' in t]) < 3:
            texts.append((await ws.receive()).data)
        await close()  # the socket drops mid-stream
        await asyncio.sleep(0.3)  # frames go on into the replay buffer
        ws, close = await ws_connect(url)
        await ws.send_str(json.dumps({"kind": "reattach", "exec_id": "e1", "last_seq": 3}))
        while '"terminal"' not in texts[-1]:
            texts.append((await ws.receive()).data)
        await ws.send_str(json.dumps({"kind": "reattach", "exec_id": "nope", "last_seq": 0}))
        texts.append((await ws.receive()).data)
        await close()
    finally:
        await server.close()
        await stop()
    return texts


@async_test
async def test_channel_node_half_drop_and_reattach_equals_jax():
    """The asyncio node half (``control_plane/channel.ChannelServer`` on
    ``http.WebSocketResponse``) against the JAX one (aiohttp), the same
    script: a submit, a drop after 3 token frames, a reattach from seq 3
    (frames 4.. replayed, then the terminal), an unknown id refused; the
    frame texts equal, seq rising by one with no gap or repeat."""
    from aiohttp import web

    async def port_serve(server):
        app = http.Application()
        app.router.add_route("GET", "/channel", server.handler)
        runner = http.AppRunner(app)
        await runner.setup()
        site = http.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        return f"http://127.0.0.1:{site.address[1]}/channel", runner.cleanup

    async def jax_serve(server):
        app = web.Application()
        app.router.add_get("/channel", server.handler)
        runner = web.AppRunner(app)
        await runner.setup()
        port = free_port()
        await web.TCPSite(runner, "127.0.0.1", port).start()
        return f"http://127.0.0.1:{port}/channel", runner.cleanup

    async def port_connect(url):
        s = http.ClientSession()
        ws = await s.ws_connect(url)

        async def close():
            await ws.close()
            await s.close()
        return ws, close

    def make(mod):
        return lambda: mod.ChannelServer(invoke=None, stream_handlers={"gen": _slow_stream})

    port = await _drop_and_reattach(make(port_channel), port_serve, port_connect)
    jax = await _drop_and_reattach(make(jax_channel), jax_serve, port_connect)
    assert port == jax
    frames = [json.loads(t) for t in port]
    seqs = [f["seq"] for f in frames if "seq" in f]
    assert seqs == list(range(1, 10)), seqs
    kinds = [f["kind"] for f in frames]
    assert kinds[0] == "accepted" and "reattach_ok" in kinds and kinds[-1] == "reattach_fail"


@async_test
async def test_a_handler_that_raises_answers_500():
    """A handler's uncaught exception is logged and answered with aiohttp's
    500 (the logger's ``exception`` takes structured fields), and the server
    goes on serving."""
    async def boom(req):
        raise RuntimeError("boom")

    async def fine(req):
        return http.json_response({"ok": True})

    app = http.Application()
    app.router.add_route("GET", "/boom", boom)
    app.router.add_route("GET", "/fine", fine)
    runner = http.AppRunner(app)
    await runner.setup()
    site = http.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    base = f"http://127.0.0.1:{site.address[1]}"
    try:
        async with aiohttp.ClientSession() as s:
            async with s.get(base + "/boom") as r:
                assert r.status == 500
                assert (await r.text()).startswith("500 Internal Server Error")
            async with s.get(base + "/fine") as r:
                assert r.status == 200 and await r.json() == {"ok": True}
    finally:
        await runner.cleanup()
