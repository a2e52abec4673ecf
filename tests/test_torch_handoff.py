"""The port's live-slot handoff (two-phase prefill/decode dispatch) against
the JAX package's, on the CPU (llama-tiny, float32, the same weights):

- engine level, both engines on one script: phase one's descriptor and
  terminal event, its declines (a prompt under 2 tokens, a first token
  that ends it, one new token, branches, the shared-prefix cache off, an
  injected ``kv.handoff_fail``), phase two's shortfalls (a descriptor that
  does not match the prompt, no adopted tail, an aged-out tail), the stash
  bounds, and a live install; tokens and the ``kv_handoff_*`` counters
  must be equal;
- the JAX control plane (``tests/helpers_cp.CPHarness``) over port nodes
  as child processes (``tests/helpers_torch_cluster``), the scripts of
  ``tests/test_disaggregated.py``: the role knob, two-phase dispatch
  token-exact with its counters, one waterfall (``gateway.handoff`` and
  ``engine.kv_export``), the per-role gauge and no leaked page; an
  all-mixed fleet never handing off; ``kv.handoff_fail`` and
  ``kv.handoff_stall`` degrading token-exact with no leaked page on either
  node;
- mixed fleets: a JAX prefill node with a port decode node, and the
  reverse, token-exact against single-node runs.

Torch runs on one intra-op thread (a module fixture); every engine is
closed.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from agentfield_tpu.control_plane import faults as jax_faults
from agentfield_tpu.models import configs as jax_configs
from agentfield_tpu.models import llama as jax_llama
from agentfield_tpu.serving import engine as jax_engine
from agentfield_tpu.serving.sampler import SamplingParams as JaxSampling
from agentfield_tpu_torch.models.configs import get_config
from agentfield_tpu_torch.models.convert import params_from_numpy
from agentfield_tpu_torch.prefix_hash import page_chain_hashes
from agentfield_tpu_torch.serving import engine
from agentfield_tpu_torch.serving import faults
from agentfield_tpu_torch.serving import model_node
from agentfield_tpu_torch.serving.sampler import SamplingParams
from tests import helpers_torch_cluster as hc
from tests.helpers_cp import CPHarness, async_test

ECFG = dict(max_batch=2, page_size=8, num_pages=64, max_pages_per_seq=16)
HANDOFF_COUNTERS = ("kv_handoff_initiated_total", "kv_handoff_completed_total",
                    "kv_handoff_failed_total", "kv_handoff_bytes_total",
                    "kv_handoff_fail_walk_total", "kv_handoff_fail_stash_total",
                    "kv_handoff_fail_upload_total", "kv_handoff_fail_export_total")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """llama-tiny gains nothing from intra-op threads; one keeps this file
    off the cores that concurrent test workers time their locks on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_configs.get_config("llama-tiny")
    tree = jax.tree.map(np.asarray, jax_llama.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tree, params_from_numpy(tree, get_config("llama-tiny"), device="cpu")


@pytest.fixture(scope="module")
def weights_file(weights, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("handoff") / "llama_tiny.npz")
    hc.write_weights(path, weights[1])
    return path


@pytest.fixture(autouse=True)
def _clear_injectors():
    yield
    jax_faults.install(None)
    faults.install(None)


@pytest.fixture
def engines(weights):
    made = []
    jcfg, tree, params = weights

    def make(kind: str, **over):
        mod = jax_engine if kind == "jax" else engine
        ecfg = mod.EngineConfig(**{**ECFG, **over})
        e = (jax_engine.InferenceEngine(tree, jcfg, ecfg) if kind == "jax"
             else engine.InferenceEngine(params, get_config("llama-tiny"), ecfg))
        made.append(e)
        return e

    yield make
    for e in made:
        e.close()


def _prompt(seed: int, n: int) -> list[int]:
    return np.random.default_rng(seed).integers(0, 512, n).tolist()


def _req(eng, rid, prompt, max_new=6, stop=(), **kw):
    jax_side = isinstance(eng, jax_engine.InferenceEngine)
    mod, samp = (jax_engine, JaxSampling) if jax_side else (engine, SamplingParams)
    return mod.Request(id=rid, prompt=prompt,
                       sampling=samp(max_new_tokens=max_new, stop_token_ids=tuple(stop)), **kw)


def _events(eng, reqs) -> list[tuple]:
    for r in reqs:
        eng.submit(r)
    out = []
    while eng.has_work():
        out += [(e.request_id, e.token, e.index, e.finished, e.finish_reason)
                for e in eng.step()]
    return out


def _tail_of(src, dst, rid):
    """Move phase one's tail from engine ``src`` to ``dst`` as a node would
    (each package's own payload form), returning the descriptor."""
    desc, payload = src.export_handoff_tail(rid)
    assert dst.adopt_handoff_tail(rid, payload)
    return desc


def _tail_of_payload(a, kind):
    """A host copy of page 1 of engine ``a`` (any page will do as a tail)."""
    with a._session_lock:
        handle = a._capture_page_kv(1)
    return a._fetch_page_kv(handle) if kind == "torch" else jax_engine._fetch_page_kv(handle)


def _script(kind: str, make) -> dict:
    a, b = make(kind), make(kind)
    obs: dict = {}
    p = _prompt(1, 27)
    first = _prompt(2, 12)
    # phase one; its descriptor; the declines
    obs["p1"] = _events(a, [_req(a, "h", p, handoff_export=True)])
    desc = a.pop_handoff_desc("h")
    obs["desc"] = {k: v for k, v in desc.items() if k != "logprob"}
    stop_tok = _events(make(kind), [_req(a, "probe", first, max_new=1)])[0][1]
    obs["declines"] = _events(a, [
        _req(a, "one", [5], handoff_export=True),  # prompt under 2 tokens
        _req(a, "stop", first, stop=(stop_tok,), handoff_export=True),  # first token ends it
        _req(a, "len1", _prompt(3, 9), max_new=1, handoff_export=True),
        _req(a, "br", _prompt(4, 9), n_branches=2, handoff_export=True),
    ])
    off = make(kind, shared_prefix_cache=False)
    obs["off"] = _events(off, [_req(off, "x", _prompt(5, 9), handoff_export=True)])
    inj = jax_faults if kind == "jax" else faults
    inj.install(inj.FaultInjector(seed=3, spec={"kv.handoff_fail": {"times": 1}}))
    obs["fault"] = _events(a, [_req(a, "f", _prompt(6, 20), handoff_export=True)])
    inj.install(None)
    # phase two: the live install, then the shortfalls
    entries = [(c, d, tuple(p[d * 8 : (d + 1) * 8]), payload)
               for c, d, payload in a.export_kv_pages(page_chain_hashes(p[:-1], 8))]
    obs["adopted"] = b.adopt_kv_pages(entries)
    _tail_of(a, b, "h")
    obs["live"] = _events(b, [_req(b, "h2", p, handoff=desc)])
    obs["walk"] = _events(b, [_req(b, "w", p, handoff=dict(desc, prompt_tokens=99))])
    obs["stash"] = _events(b, [_req(b, "s", p, handoff=dict(desc, id="nobody"))])
    b.adopt_handoff_tail("old", _tail_of_payload(a, kind))
    with b._session_lock:  # age the stashed tail out
        exp, payload = b._handoff_in["old"]
        b._handoff_in["old"] = (time.monotonic() - 1.0, payload)
    obs["aged"] = _events(b, [_req(b, "o", p, handoff=dict(desc, id="old"))])
    obs["bool_t0"] = _events(b, [_req(b, "t", p, handoff=dict(desc, t0=True))])
    # the stash bounds: the cap holds, oldest first
    for i in range(70):
        b.adopt_handoff_tail(f"cap{i}", _tail_of_payload(a, kind))
    with b._session_lock:
        obs["cap"] = (len(b._handoff_in), next(iter(b._handoff_in)))
    obs["counters"] = {n: {k: e.stats[k] for k in HANDOFF_COUNTERS + ("prefill_tokens",)}
                       for n, e in (("a", a), ("b", b))}
    obs["free"] = (a.allocator.free_pages, b.allocator.free_pages)
    return obs



def test_handoff_engine_script_matches_jax(engines):
    j, t = (_script(k, engines) for k in ("jax", "torch"))
    assert t == j
    # what the script shows, on the port's side
    assert t["p1"] == [("h", t["desc"]["t0"], 0, True, "handoff")]
    assert t["desc"] == {"id": "h", "t0": t["p1"][0][1], "prompt_tokens": 27, "pages": 3,
                         "page_size": 8}
    assert t["adopted"] == 3
    live = [e for e in t["live"] if e[0] == "h2"]
    assert live[0][:3] == ("h2", t["desc"]["t0"], 0) and len(live) == 6
    ca, cb = t["counters"]["a"], t["counters"]["b"]
    # "h", and the branched request's sibling: its fork found no free slot,
    # re-queued as a plain request that still carries the flag (both packages)
    assert ca["kv_handoff_initiated_total"] == 2
    assert ("br#b1", True, "handoff") in [(e[0], e[3], e[4]) for e in t["declines"]]
    assert ca["kv_handoff_fail_export_total"] == ca["kv_handoff_failed_total"] == 5
    assert cb["kv_handoff_completed_total"] == 1
    assert (cb["kv_handoff_fail_walk_total"], cb["kv_handoff_fail_stash_total"]) == (2, 2)
    assert t["cap"] == (64, "cap6")
    assert [e[4] for e in t["off"] if e[3]] == ["length"]


def test_handoff_request_checks_match_jax(engines):
    for kind, mod in (("jax", jax_engine), ("torch", engine)):
        e = engines(kind)
        with pytest.raises(ValueError, match="descriptor dict"):
            e.submit(_req(e, "bad", [1, 2, 3], handoff=["not", "a", "dict"]))


# ---------------------------------------------------------------------------
# the JAX control plane over port nodes (tests/test_disaggregated.py)


async def _gen(h, target, body):
    async with h.http.post(f"/api/v1/execute/{target}", json={"input": body}) as r:
        doc = await r.json()
    assert doc["status"] == "completed", doc
    return doc


async def _direct(base: str, body: dict) -> dict:
    import aiohttp

    async with aiohttp.ClientSession(base_url=base) as s:
        async with s.post("/reasoners/generate", json={"input": body}) as r:
            doc = await r.json()
    assert r.status == 200, doc
    return doc["result"]


async def _roles(h, weights_file, roles, kws=None):
    kws = kws or [{}] * len(roles)
    return await asyncio.gather(*(
        hc.start_node(h.base_url, f"node-{i}", weights_file, role=role, ecfg=ECFG, **kw)
        for i, (role, kw) in enumerate(zip(roles, kws))))


async def _stop(*nodes):
    rcs = await asyncio.gather(*(hc.stop_node(proc, lines) for proc, _, lines in nodes))
    assert rcs == [0] * len(nodes), [n[2] for n in nodes]


async def _zero_leak(*bases):
    for base in bases:
        st = await hc.idle_stats(base)
        assert st["free_pages"] == ECFG["num_pages"] - 1, st["free_pages"]


def test_role_knob_and_validation(weights, monkeypatch):
    _, _, params = weights
    with pytest.raises(ValueError, match="unknown node role"):
        model_node.build_model_node("llama-tiny", params=params, device="cpu", role="turbo")
    monkeypatch.setenv("AGENTFIELD_NODE_ROLE", "decode")
    server, back = model_node.build_model_node("llama-tiny", params=params, device="cpu",
                                               ecfg=engine.EngineConfig(**ECFG))
    try:
        assert server.metadata["role"] == "decode"
        for k in HANDOFF_COUNTERS:  # present before any traffic
            assert back.engine.stats[k] == 0
    finally:
        back.engine.close()


@async_test
async def test_two_phase_handoff_token_exact_counters_and_trace(weights_file):
    async with CPHarness() as h:
        p, d = await _roles(h, weights_file, ["prefill", "decode"])
        try:
            prompt = list(range(50, 70))  # 2 full pages and a tail at page size 8
            ref = await _direct(p[1], {"tokens": prompt, "max_new_tokens": 6})
            doc = await _gen(h, "node-0.generate", {"tokens": prompt, "max_new_tokens": 6})
            assert doc["result"]["tokens"] == ref["tokens"]
            assert doc["result"]["finish_reason"] == "length"
            sp, sd = await hc.idle_stats(p[1]), await hc.idle_stats(d[1])
            assert sp["kv_handoff_initiated_total"] == 1 and sp["kv_handoff_bytes_total"] > 0
            assert sd["kv_handoff_completed_total"] == 1
            assert sd["prefill_tokens"] == 0  # the live install prefilled nothing
            assert h.cp.metrics.counter_value("gateway_handoff_fallback_total") == 0
            async with h.http.get(f"/api/v1/executions/{doc['execution_id']}/trace") as r:
                names = [s["name"] for s in (await r.json())["spans"]]
            assert "gateway.handoff" in names and "engine.kv_export" in names
            for k in ("kv_handoff_initiated_total", "kv_handoff_completed_total"):
                for _ in range(300):  # the nodes' heartbeats bring the gauges
                    if h.cp.metrics.gauge_value(f"engine_{k}", labels={"node": "node-1"}) \
                            is not None:
                        break
                    await asyncio.sleep(0.05)
                assert h.cp.metrics.gauge_value(f"engine_{k}", labels={"node": "node-1"}) \
                    is not None
            await h.cp.registry.sweep_once()
            for role, n in (("prefill", 1.0), ("decode", 1.0), ("mixed", 0.0)):
                assert h.cp.metrics.gauge_value("nodes_by_role", labels={"role": role}) == n
            await _zero_leak(p[1], d[1])
        finally:
            await _stop(p, d)


@async_test
async def test_mixed_fleet_never_enters_two_phase(weights_file):
    async with CPHarness() as h:
        a, b = await _roles(h, weights_file, ["mixed", "mixed"])
        try:
            doc = await _gen(h, "node-0.generate",
                             {"tokens": list(range(30, 48)), "max_new_tokens": 4})
            assert len(doc["result"]["tokens"]) == 4
            for base in (a[1], b[1]):
                st = await hc.idle_stats(base)
                for k in HANDOFF_COUNTERS:
                    assert st[k] == 0, k
            assert h.cp.gateway._handoff == {}
            assert h.cp.metrics.counter_value("gateway_handoff_fallback_total") == 0
            await _zero_leak(a[1], b[1])
        finally:
            await _stop(a, b)


@async_test
async def test_handoff_fail_chaos_single_node_token_exact_zero_leak(weights_file):
    """``kv.handoff_fail`` in the prefill node vetoes the export: it decodes
    the request itself, token-exact; the decode node never sees it."""
    async with CPHarness() as h:
        p, d = await _roles(h, weights_file, ["prefill", "decode"],
                            [{"faults": {"kv.handoff_fail": {"times": 1}}}, {}])
        try:
            prompt = list(range(90, 112))
            ref = await _direct(p[1], {"tokens": prompt, "max_new_tokens": 6})
            doc = await _gen(h, "node-0.generate", {"tokens": prompt, "max_new_tokens": 6})
            assert doc["result"]["tokens"] == ref["tokens"]
            sp, sd = await hc.idle_stats(p[1]), await hc.idle_stats(d[1])
            assert sp["kv_handoff_failed_total"] == 1 and sp["kv_handoff_initiated_total"] == 0
            assert sd["kv_handoff_completed_total"] == 0 and sd["requests_finished"] == 0
            assert h.cp.metrics.counter_value("gateway_handoff_fallback_total") == 1
            await _zero_leak(p[1], d[1])
        finally:
            await _stop(p, d)


@async_test
async def test_handoff_stall_chaos_decode_reprefills_token_exact_zero_leak(weights_file):
    """``kv.handoff_stall`` outlives the decode node's 0.15 s fetch: phase
    two adopts nothing and prefills the whole prompt, token-exact; the
    stalled answer lands on nobody."""
    async with CPHarness() as h:
        p, d = await _roles(h, weights_file, ["prefill", "decode"], [
            {"faults": {"kv.handoff_stall": {"times": 1, "delay_s": 1.0}}},
            {"kv_fetch_timeout_s": 0.15}])
        try:
            prompt = list(range(130, 154))
            ref = await _direct(p[1], {"tokens": prompt, "max_new_tokens": 6})
            doc = await _gen(h, "node-0.generate", {"tokens": prompt, "max_new_tokens": 6})
            assert doc["result"]["tokens"] == ref["tokens"]
            await asyncio.sleep(1.0)
            sp, sd = await hc.idle_stats(p[1]), await hc.idle_stats(d[1])
            assert sp["kv_handoff_initiated_total"] == 1
            assert sd["kv_fetch_failed_total"] == 1 and sd["kv_handoff_completed_total"] == 0
            assert sd["prefill_tokens"] == len(prompt)
            assert sd["kv_fetch_pages_adopted_total"] == 0
            await _zero_leak(p[1], d[1])
        finally:
            await _stop(p, d)


# ---------------------------------------------------------------------------
# mixed fleets: a JAX node and a port node


async def _jax_node(h, node_id: str, role: str, ecfg):
    from agentfield_tpu.models import get_config as jax_get_config
    from agentfield_tpu.models import init_params
    from agentfield_tpu.serving.model_node import build_model_node

    params = init_params(jax_get_config("llama-tiny"), jax.random.PRNGKey(0))
    agent, back = build_model_node(node_id, h.base_url, model="llama-tiny", params=params,
                                   ecfg=ecfg, role=role)
    await back.start()
    await agent.start()
    return agent, back


@pytest.mark.parametrize("jax_role", ["prefill", "decode"])
@async_test
async def test_mixed_fleet_jax_and_port_hand_off_token_exact(weights_file, jax_role):
    """A JAX prefill node handing off to a port decode node, and a port
    prefill node to a JAX decode node: tokens equal to the JAX node's
    single-node run, the decode side installed live, no page leaked."""
    port_role = "decode" if jax_role == "prefill" else "prefill"
    async with CPHarness() as h:
        jid, pid = ("node-0", "node-1") if jax_role == "prefill" else ("node-1", "node-0")
        agent, jback = await _jax_node(h, jid, jax_role, jax_engine.EngineConfig(**ECFG))
        port = await hc.start_node(h.base_url, pid, weights_file, role=port_role, ecfg=ECFG)
        try:
            prompt = list(range(200, 221))
            ref = await jback.generate(tokens=prompt, max_new_tokens=6)
            doc = await _gen(h, f"{jid}.generate", {"tokens": prompt, "max_new_tokens": 6})
            assert doc["result"]["tokens"] == ref["tokens"]
            sport = await hc.idle_stats(port[1])
            sj = jback.engine.stats
            if jax_role == "prefill":
                assert sj["kv_handoff_initiated_total"] == 1
                assert sport["kv_handoff_completed_total"] == 1 and sport["prefill_tokens"] == 0
            else:
                assert sport["kv_handoff_initiated_total"] == 1
                assert sj["kv_handoff_completed_total"] == 1
            assert h.cp.metrics.counter_value("gateway_handoff_fallback_total") == 0
            await _zero_leak(port[1])
            for _ in range(100):
                if not jback.engine.has_work():
                    break
                await asyncio.sleep(0.05)
            assert jback.engine.allocator.free_pages == ECFG["num_pages"] - 1
        finally:
            await agent.stop()
            await jback.stop()
            await _stop(port)
