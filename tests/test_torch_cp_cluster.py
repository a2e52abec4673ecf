"""The cluster tier's KV fetch and two-phase handoff through the port's
gateway, on the CPU, against ``chip_smoke.StandInControlPlane`` and the JAX
gateway on the same port nodes.

The scripts are those of ``tests/test_torch_cluster_kv.py`` (a ``kv_peer``
fetch of a warm node's prefix) and ``tests/test_torch_handoff.py`` (a token
prompt dispatched to a prefill node, its KV and live tail handed to a decode
node). Two port nodes run as child processes (``tests.helpers_torch_cluster``
on the JAX llama-tiny weights) whose control plane is a stand-in (it takes
their registrations and heartbeats). Each script then runs through three
gateways in turn, each registering the two nodes with itself (by hand for
the port's and the JAX control planes) and opening its own channels to
them, which it closes before the next: the stand-in's gateway half, the
port's control plane (``ControlPlaneThread``), the JAX control plane
(``CPHarness``). The node that receives the KV (the fetcher, the decode
node) is started afresh before each gateway, so each run begins cold there.

Each run must give the tokens of a direct request to the serving node, the
same tokens as the other two gateways, the same node-side counters
(pages adopted, handoffs completed, prefill tokens) and the same relay
counters (``kv_relay_fetches_total``, ``kv_relay_frames_total``,
``kv_relay_errors_total``).
"""

from __future__ import annotations

import asyncio
import json
import os
import pathlib
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from agentfield_tpu.models import configs as jax_configs
from agentfield_tpu.models import llama as jax_llama
from agentfield_tpu_torch.control_plane.server import ControlPlane, ControlPlaneThread
from tests import helpers_torch_cluster as hc
from tests.helpers_cp import CPHarness

ROOT = pathlib.Path(__file__).resolve().parents[1]
ECFG = dict(max_batch=2, page_size=8, num_pages=64, max_pages_per_seq=16)
RELAY = ("kv_relay_fetches_total", "kv_relay_frames_total", "kv_relay_errors_total")
GATEWAYS = ("stand_in", "port", "jax")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights_file(tmp_path_factory):
    jcfg = jax_configs.get_config("llama-tiny")
    tree = jax.tree.map(np.asarray, jax_llama.init_params(jcfg, jax.random.PRNGKey(0)))
    path = str(tmp_path_factory.mktemp("cp_cluster") / "llama_tiny.npz")
    hc.write_weights(path, tree)
    return path


class Node:
    """One port node as a child process (``tests.helpers_torch_cluster``)."""

    def __init__(self, cp_url: str, node_id: str, weights: str, role: str):
        self.node_id, self.role = node_id, role
        spec = {"cp_url": cp_url, "node_id": node_id, "weights": weights, "role": role,
                "ecfg": ECFG, "faults": None, "kv_fetch_timeout_s": None,
                "heartbeat_interval": 0.2}
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                   MKL_NUM_THREADS="1", AFT_NODE=json.dumps(spec))
        self.proc = subprocess.Popen([sys.executable, "-m", "tests.helpers_torch_cluster"],
                                     cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self.lines: list[str] = []
        self.base = None

    def wait_up(self) -> "Node":
        t0 = time.monotonic()
        while self.base is None:
            line = self.proc.stdout.readline()
            assert line and time.monotonic() - t0 < 60, f"{self.node_id} exited: {self.lines}"
            self.lines.append(line)
            m = re.search(r"serving on (http://\S+)", line)
            if m:
                self.base = m.group(1)
        self.port = int(self.base.rsplit(":", 1)[1])
        self._drain = threading.Thread(target=lambda: self.lines.extend(self.proc.stdout),
                                       daemon=True)
        self._drain.start()
        return self

    def stats(self) -> dict:
        """``GET /stats`` once nothing runs on the node."""
        t0 = time.monotonic()
        while True:
            with urllib.request.urlopen(f"{self.base}/stats", timeout=30) as r:
                st = json.loads(r.read())
            if st["active_slots"] == 0 and st["pending_requests"] == 0:
                return st
            assert time.monotonic() - t0 < 30, st
            time.sleep(0.05)

    def direct(self, body: dict) -> list[int]:
        status, doc = chip_smoke._http(self.port, "POST", "/reasoners/generate",
                                       {"input": body})
        assert status == 200, (status, doc)
        return doc["result"]["tokens"]

    def stop(self) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(60)
        self._drain.join(10)
        return rc

    def spec(self) -> dict:
        """Its registration, as the node sends it."""
        return {"node_id": self.node_id, "base_url": self.base, "kind": "model",
                "reasoners": [{"id": "generate"}, {"id": "embed"}],
                "metadata": {"model": "llama-tiny", "modalities": ["text"],
                             "role": self.role, "channel": True}}


def start(stand_in_url, weights, specs) -> list[Node]:
    nodes = [Node(stand_in_url, nid, weights, role) for nid, role in specs]
    return [n.wait_up() for n in nodes]


def run_stand_in(cp, nodes, script):
    """``script`` with the stand-in's gateway half: ``gen(target, body)``
    sends an execution over its channel (two-phase for a prefill node's
    token prompt, as the JAX gateway does)."""
    by_id = {n.node_id: n for n in nodes}
    for n in nodes:
        cp.attach(n.node_id, n.port)
    k0 = dict(cp.kv_stats)
    seq = iter(range(1_000_000))

    def gen(target: str, body: dict) -> list[int]:
        nid = target.split(".")[0]
        eid = f"si_{next(seq)}"
        if by_id[nid].role == "prefill":
            decode = next(n.node_id for n in nodes if n.role == "decode")
            return cp.two_phase(eid, body, nid, decode)["result"]["tokens"]
        return cp.execute(nid, eid, body, stream=False)["result"]["tokens"]

    try:
        out = script(gen)
    finally:
        for n in nodes:
            cp.channels.pop(n.node_id).close()
    return out, {k: cp.kv_stats[k] - k0[k] for k in RELAY}


def run_port(nodes, script, affinity: bool):
    cpt = ControlPlaneThread(ControlPlane(channel=True, prefix_affinity=affinity))
    base = cpt.start()
    try:
        for n in nodes:
            st, doc = chip_smoke._http(cpt.port, "POST", "/api/v1/nodes", n.spec())
            assert st == 201, (st, doc)

        def gen(target: str, body: dict) -> list[int]:
            st, doc = chip_smoke._http(cpt.port, "POST", f"/api/v1/execute/{target}",
                                       {"input": body})
            assert st == 200 and doc["status"] == "completed", (st, doc)
            return doc["result"]["tokens"]

        out = script(gen)
        relay = {k: cpt.cp.metrics.counter_value(k) for k in RELAY}
        assert cpt.cp.metrics.counter_value("gateway_handoff_fallback_total") == 0
    finally:
        cpt.stop()
    assert base
    return out, relay


def run_jax(nodes, script, affinity: bool):
    async def main():
        async with CPHarness(channel=True, prefix_affinity=affinity) as h:
            for n in nodes:
                async with h.http.post("/api/v1/nodes", json=n.spec()) as r:
                    assert r.status == 201, await r.text()
            loop = asyncio.get_running_loop()

            def gen(target: str, body: dict) -> list[int]:
                async def call():
                    async with h.http.post(f"/api/v1/execute/{target}",
                                           json={"input": body}) as r:
                        return await r.json()
                doc = asyncio.run_coroutine_threadsafe(call(), loop).result(60)
                assert doc["status"] == "completed", doc
                return doc["result"]["tokens"]

            out = await asyncio.to_thread(script, gen)
            relay = {k: h.cp.metrics.counter_value(k) for k in RELAY}
            assert h.cp.metrics.counter_value("gateway_handoff_fallback_total") == 0
            return out, relay

    return asyncio.run(asyncio.wait_for(main(), 60))


def three_gateways(weights, specs, fresh: str, script, affinity: bool) -> dict:
    """Run ``script(nodes, gen)`` through each gateway; the node ``fresh``
    is started again before each run after the first. ``affinity``: the
    gateways' prefix affinity (two-phase dispatch rides on it; the fetch
    script drives its ``kv_peer`` hint by hand, with it off)."""
    stand_in = chip_smoke.StandInControlPlane()
    url = stand_in.start()
    nodes = start(url, weights, specs)
    results = {}
    try:
        for gw in GATEWAYS:
            if gw != GATEWAYS[0]:
                i = next(i for i, n in enumerate(nodes) if n.node_id == fresh)
                assert nodes[i].stop() == 0, nodes[i].lines
                nodes[i] = start(url, weights, [(fresh, nodes[i].role)])[0]
            bound = lambda gen: script(nodes, gen)  # noqa: E731
            if gw == "stand_in":
                results[gw] = run_stand_in(stand_in, nodes, bound)
            elif gw == "port":
                results[gw] = run_port(nodes, bound, affinity)
            else:
                results[gw] = run_jax(nodes, bound, affinity)
    finally:
        rcs = [n.stop() for n in nodes]
        stand_in.stop()
    assert rcs == [0] * len(nodes), [n.lines for n in nodes]
    return results


def fetch_script(nodes, gen) -> dict:
    a, b = nodes
    shared = list(range(50, 82))  # 4 full pages of 8
    gen("node-a.generate", {"tokens": shared + [1, 2], "max_new_tokens": 4})
    prompt = shared + [7, 9]
    ref = gen("node-a.generate", {"tokens": prompt, "max_new_tokens": 6})
    pre = b.stats()["prefill_tokens"]
    got = gen("node-b.generate", {"tokens": prompt, "max_new_tokens": 6,
                                  "kv_peer": {"node_id": "node-a", "pages": 4, "page_size": 8}})
    sb = b.stats()
    return {"ref": ref, "fetched": got, "direct": a.direct({"tokens": prompt,
                                                            "max_new_tokens": 6}),
            "b_prefill_tokens": sb["prefill_tokens"] - pre,
            "b_adopted": sb["kv_fetch_pages_adopted_total"],
            "b_requested": sb["kv_fetch_requested_total"],
            "b_failed": sb["kv_fetch_failed_total"]}


def handoff_script(nodes, gen) -> dict:
    p, d = nodes
    prompt = list(range(50, 70))  # 2 full pages and a tail at page size 8
    got = gen("node-p.generate", {"tokens": prompt, "max_new_tokens": 6})
    sp, sd = p.stats(), d.stats()
    return {"tokens": got, "direct": p.direct({"tokens": prompt, "max_new_tokens": 6}),
            "p_initiated": sp["kv_handoff_initiated_total"],
            "d_completed": sd["kv_handoff_completed_total"],
            "d_prefill_tokens": sd["prefill_tokens"]}


def test_kv_fetch_same_through_three_gateways(weights_file):
    res = three_gateways(weights_file, [("node-a", "mixed"), ("node-b", "mixed")], "node-b",
                         fetch_script, affinity=False)
    for gw, (out, relay) in res.items():
        assert out["fetched"] == out["ref"] == out["direct"], (gw, out)
        assert out["b_adopted"] == 4 and out["b_requested"] == 1 and out["b_failed"] == 0, (
            gw, out)
        assert out["b_prefill_tokens"] < 32, (gw, out)  # the shared pages came over the wire
        assert relay["kv_relay_fetches_total"] == 1 and relay["kv_relay_errors_total"] == 0, (
            gw, relay)
    assert res["port"] == res["stand_in"] == res["jax"], res


def test_two_phase_handoff_same_through_three_gateways(weights_file):
    res = three_gateways(weights_file, [("node-p", "prefill"), ("node-d", "decode")], "node-d",
                         handoff_script, affinity=True)
    for gw, (out, relay) in res.items():
        assert out["tokens"] == out["direct"] and len(out["tokens"]) == 6, (gw, out)
        assert out["d_completed"] == 1 and out["d_prefill_tokens"] == 0, (gw, out)
        assert relay["kv_relay_fetches_total"] == 1 and relay["kv_relay_errors_total"] == 0, (
            gw, relay)
    # node-p is not restarted: its export count rises by one a run
    assert [res[g][0]["p_initiated"] for g in GATEWAYS] == [1, 2, 3]
    strip = {g: ({k: v for k, v in out.items() if k != "p_initiated"}, relay)
             for g, (out, relay) in res.items()}
    assert strip["port"] == strip["stand_in"] == strip["jax"], res


def test_kv_blob_header_matches_the_node_side():
    """The gateway relay's ``AFKV1`` header equals the node's, byte for
    byte, and the relay parses the node's blobs (payload passed as a view)."""
    from agentfield_tpu.control_plane import channel as jchannel
    from agentfield_tpu_torch.control_plane import channel as tchannel
    from agentfield_tpu_torch.serving import channel as nchannel

    payload = bytes(range(256)) * 8
    for fid, seq in (("kvr_1", 0), ("f" * 255, 2**32 - 1), ("é-id", 7)):
        head = nchannel.kv_blob_header(fid, seq)
        assert tchannel._pack_kv_blob(fid, seq, b"") == head
        assert tchannel._pack_kv_blob(fid, seq, payload) == jchannel._pack_kv_blob(
            fid, seq, payload)
        got = tchannel._unpack_kv_blob(head + payload)
        assert got[:2] == (fid, seq) and bytes(got[2]) == payload
    assert tchannel._unpack_kv_blob(b"AFKV0" + b"\x00" * 10) is None
    assert tchannel.CHANNEL_PATH == jchannel.CHANNEL_PATH
