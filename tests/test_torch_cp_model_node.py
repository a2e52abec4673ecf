"""The port's model node behind the port's control plane, on the CPU.

The port's control plane (``agentfield_tpu_torch.control_plane``) runs on a
loop of its own (``ControlPlaneThread``); the port's node runs as a child
process (``python -m agentfield_tpu_torch.serving.model_node --device cpu
--model llama-tiny --control-plane URL``), started once for the module, and
registers with it. A JAX SDK ``Agent`` pointed at the port's control plane
then calls it the way agent programs do:

- ``ai()`` with a prompt and with ``messages``, ``ai(stream=True)`` and
  ``ai_embed()`` complete, and their tokens (or vector) equal a direct
  ``POST`` of the same payload to the node and the same calls through the
  JAX control plane (``CPHarness``, the node registered there by hand, its
  gateway reaching the node over the channel). Run over the channel and
  once with the port gateway's channel off (the node's 202, then its status
  callback to the port's control plane);
- the streamed execution's ``/trace`` is one ordered waterfall from the
  gateway's dispatch down to the engine's spans;
- the registry shows the node as a model with its heartbeat stats, and
  ``/metrics`` its latency histograms;
- SIGTERM: the child exits 0 and the port's registry no longer lists it
  (or shows it stopping).

``chip_smoke.phase_gateway`` is rehearsed on the CPU at llama-tiny size,
its agent programs on the port's SDK (g), the branch verifier (h) and the
README quickstart through the port's CLI (i) included.
"""

from __future__ import annotations

import asyncio
import os
import pathlib
import re
import signal
import subprocess
import sys
import threading
import time

import aiohttp
import pytest
import torch

import chip_smoke
from agentfield_tpu.sdk.agent import Agent
from agentfield_tpu_torch.control_plane.server import ControlPlane, ControlPlaneThread
from tests.helpers_cp import CPHarness, async_test

ROOT = pathlib.Path(__file__).resolve().parents[1]
NODE = "torch-node"
MSGS = [{"role": "system", "content": "be brief"}, {"role": "user", "content": "say hi"}]
WATERFALL = ("gateway.execute", "gateway.dispatch", "channel.submit", "node.generate",
             "engine.queue_wait", "engine.prefill", "engine.decode")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Fleet:
    """The port's control plane and one port node registered with it."""

    def __init__(self):
        self.cpt = ControlPlaneThread(ControlPlane(channel=True))
        self.cp_url = self.cpt.start()
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                   MKL_NUM_THREADS="1", AGENTFIELD_DRAIN_GRACE="1")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "agentfield_tpu_torch.serving.model_node", "--device",
             "cpu", "--model", "llama-tiny", "--port", "0", "--control-plane", self.cp_url,
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

    def stop(self) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(30)
        self._drain.join(10)
        return rc

    def close(self) -> None:
        try:
            self.stop()
        finally:
            self.cpt.stop()


@pytest.fixture(scope="module")
def fleet():
    f = Fleet()
    try:
        yield f
    finally:
        f.close()


async def _direct(base: str, path: str, payload: dict) -> dict:
    async with aiohttp.ClientSession(base_url=base) as s:
        async with s.post(path, json={"input": payload}) as r:
            assert r.status == 200, await r.text()
            return (await r.json())["result"]


async def _sdk_calls(cp_url: str) -> dict:
    """The SDK calls of the flow, through the control plane at ``cp_url``."""
    caller = Agent("caller", cp_url, channel=False)
    try:
        out = {"ai": await caller.ai("hello from the SDK", max_new_tokens=6, timeout=60),
               "ai_messages": await caller.ai(messages=MSGS, max_new_tokens=5, timeout=60)}
        gen = await caller.ai("hello from the SDK", max_new_tokens=6, timeout=60, stream=True)
        out["stream"] = [f async for f in gen]
        out["embed"] = await caller.ai_embed("embed through the gateway", timeout=60)
        return out
    finally:
        await caller.client.close()


@pytest.mark.parametrize("channel", [True, False], ids=["channel", "post"])
@async_test
async def test_sdk_agent_through_the_port_control_plane(fleet, channel):
    fleet.cpt.cp.gateway.channels.enabled = channel
    try:
        async with aiohttp.ClientSession(base_url=fleet.cp_url) as http:
            async with http.get(f"/api/v1/nodes/{NODE}") as r:
                assert r.status == 200, await r.text()
                node = (await r.json())["node"]
            assert node["kind"] == "model" and node["status"] == "active"
            assert node["metadata"]["channel"] is True
            assert sorted(c["id"] for c in node["reasoners"]) == ["embed", "generate"]
            submits0 = fleet.cpt.cp.metrics.counter_value("channel_submits_total")
            got = await _sdk_calls(fleet.cp_url)
            want = await _direct(fleet.base, "/reasoners/generate", chip_smoke.sdk_payload(
                prompt="hello from the SDK", max_new_tokens=6))
            assert got["ai"]["tokens"] == want["tokens"] and len(want["tokens"]) == 6
            want_m = await _direct(fleet.base, "/reasoners/generate",
                                   chip_smoke.sdk_payload(messages=MSGS, max_new_tokens=5))
            assert got["ai_messages"]["tokens"] == want_m["tokens"]
            frames = got["stream"]
            assert frames[-1]["terminal"] and frames[-1]["status"] == "completed"
            assert frames[-1]["result"]["tokens"] == want["tokens"]
            streamed = [f["token"] for f in frames[:-1] if f["token"] >= 0]
            assert streamed == (want["tokens"] if channel else [])  # POST: the terminal only
            want_e = await _direct(fleet.base, "/reasoners/embed",
                                   {"prompt": "embed through the gateway"})
            assert got["embed"] == want_e and got["embed"]["dim"] == len(want_e["embedding"])
            # the streamed execution's waterfall
            eid = frames[-1]["execution_id"]
            async with http.get(f"/api/v1/executions/{eid}/trace") as r:
                assert r.status == 200, await r.text()
                doc = await r.json()
            names = [s["name"] for s in doc["spans"]]
            for required in WATERFALL if channel else set(WATERFALL) - {"channel.submit"}:
                assert required in names, (required, names)
            assert names.count("gateway.execute") == 1
            t0s = [s["t0"] for s in doc["spans"]]
            assert t0s == sorted(t0s)
            by_name = {s["name"]: s for s in doc["spans"]}
            assert by_name["engine.queue_wait"]["t0"] <= by_name["engine.prefill"]["t0"]
            assert by_name["engine.prefill"]["t0"] <= by_name["engine.decode"]["t0"]
            for n in ("engine.prefill", "engine.decode", "node.generate"):
                assert by_name[n]["node"] == NODE and by_name[n]["attempt"] == 1
            # the heartbeat's stats on the registry, the histograms on /metrics
            for _ in range(100):
                async with http.get(f"/api/v1/nodes/{NODE}") as r:
                    stats = (await r.json())["node"]["metadata"].get("stats") or {}
                if stats.get("requests_finished", 0) >= 4:
                    break
                await asyncio.sleep(0.1)
            assert {"active_slots", "free_pages", "channel_server_submits_total"} <= set(stats)
            assert "latency_hist" not in stats
            async with http.get("/metrics") as r:
                metrics = await r.text()
            for name in ("ttft_ms", "itl_ms", "queue_wait_ms", "tick_ms"):
                assert re.search(rf'engine_{name}_count{{[^}}]*node="{NODE}"', metrics), name
            submits = fleet.cpt.cp.metrics.counter_value("channel_submits_total") - submits0
            assert (submits >= 4) if channel else submits == 0, submits
    finally:
        fleet.cpt.cp.gateway.channels.enabled = True


@async_test
async def test_same_tokens_as_through_the_jax_control_plane(fleet):
    """The same SDK calls through the JAX control plane, the node registered
    there by hand (its heartbeats go to the port's): equal tokens and
    vector. The JAX gateway reaches the node over the channel."""
    port_got = await _sdk_calls(fleet.cp_url)
    async with CPHarness(channel=True) as h:
        async with h.http.post("/api/v1/nodes", json={
                "node_id": NODE, "base_url": fleet.base, "kind": "model",
                "reasoners": [{"id": "generate"}, {"id": "embed"}],
                "metadata": {"model": "llama-tiny", "modalities": ["text"], "role": "mixed",
                             "channel": True}}) as r:
            assert r.status == 201, await r.text()
        jax_got = await _sdk_calls(h.base_url)
    assert jax_got["ai"]["tokens"] == port_got["ai"]["tokens"]
    assert jax_got["ai_messages"]["tokens"] == port_got["ai_messages"]["tokens"]
    assert ([f.get("token") for f in jax_got["stream"][:-1]]
            == [f.get("token") for f in port_got["stream"][:-1]])
    assert jax_got["stream"][-1]["result"]["tokens"] == port_got["stream"][-1]["result"]["tokens"]
    assert jax_got["embed"] == port_got["embed"]


def test_phase_gateway_rehearsed_on_cpu():
    """``chip_smoke.phase_gateway`` at llama-tiny size on the CPU: (a)-(m)
    hold (launch counts, nvidia-smi and the build dir are checked on the
    card only): (g) the port's SDK agents, (h) the branch verifier, (i) the
    quickstart through the port's CLI with ``model --cpu`` (its installed
    package on ``/api/v1/packages``), (j) DIDs, credentials and a chain on
    the phase's keystore, (k) an MCP server through the routes and
    ``attach_mcp``, (l) the dashboard's payloads, (m) memory events, (n)
    gRPC Generate, (o) admin gRPC, (p) a control plane on the fake
    Postgres server."""
    from agentfield_tpu_torch.models.configs import get_config
    from agentfield_tpu_torch.models.llama import init_params

    cfg = get_config("llama-tiny")
    params = init_params(cfg, seed=0, device="cpu")
    results: dict = {}
    threads0 = set(threading.enumerate())
    chip_smoke.phase_gateway(results, {"params": params, "cfg": cfg}, 0, device="cpu",
                             model_name="llama-tiny", prompts=(10, 30, 50), new=4, burst=4,
                             num_pages=128, max_pages_per_seq=16, sdk_prompts=(10, 40),
                             cli_model="llama-tiny")
    g = results["gateway"]
    assert set(g["g"]["sdk_ms"]) == {"ask", "chat", "structured", "stream"}
    assert all(len(v) == 2 for v in g["g"]["sdk_ms"].values())
    runs = g["h"]["runs"]
    assert [runs[k]["verifier_used"] for k in ("plain0", "judge0", "fail", "missing",
                                               "reentrant")] == [False, True, False, False, True]
    assert g["h"]["verifier_calls"] == chip_smoke.GATEWAY_VERIFIER_TURNS + 3
    assert set(g["i"]["steps_s"]) == {"server", "model", "init", "install", "run", "status",
                                      "execute", "stop"}
    assert g["i"]["packages"] == ["myagent"] and g["i"]["org_did"].startswith("did:key:z")
    assert set(g["dids"]) == {"app", "judge"}
    assert set(g["j"]["p50_ms"]) == {"issue", "verify", "chain", "register"}
    assert all(len(v) == 2 * chip_smoke.AUDIT_TURNS if k in ("issue", "verify")
               else len(v) == chip_smoke.AUDIT_TURNS for k, v in g["j"]["ms"].items())
    assert g["j"]["chain_count"] == 2 and g["k"]["tools"] == ["fact"]
    assert g["k"]["run_executions"] == 3 and g["k"]["children_left"] == 0
    assert g["l"]["pages"] == -(-g["l"]["executions"] // 7) and g["l"]["credentials"] >= 3
    assert g["m"]["events"] == [("set", "notes_prompt"), ("set", "notes_tokens"),
                                ("delete", "notes_prompt")]
    assert g["invalid"][0] == "INTERNAL" and g["n"]["tokens"] == chip_smoke.GRPC_NEW
    assert len(g["n"]["grpc_ms"]) == len(g["n"]["post_ms"]) == chip_smoke.GRPC_TURNS
    assert g["o"]["reasoners"] >= 2 and g["o"]["nodes"] >= 3
    assert g["p"]["pg_server"] == "fake (sqlite)" and g["p"]["execution_rows"] >= 1
    assert 0 < g["audit_s"] < g["main_s"]
    assert len(g["b"]["gateway_own_ms"]) == 6 and g["e"]["executions_per_s"] > 0
    assert g["c"] == {"channel": 3, "post": 3}
    assert all(v > 0 for v in g["a"]["hist_counts"].values())
    left = [t for t in threading.enumerate() if t not in threads0 and t.is_alive()
            and not t.name.startswith(("asyncio_", "ThreadPoolExecutor"))]
    assert not left, left  # the phase's control plane, node and clients are gone


def test_sigterm_deregisters_the_node(fleet):
    """Last in the module: SIGTERM, exit 0, gone from the port's registry."""
    rc = fleet.stop()
    assert rc == 0, "".join(fleet.lines)
    import json
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"{fleet.cp_url}/api/v1/nodes/{NODE}", timeout=10) as r:
            status = json.loads(r.read())["node"]["status"]
    except urllib.error.HTTPError as e:
        status = e.code
    assert status in (404, "stopping"), status
