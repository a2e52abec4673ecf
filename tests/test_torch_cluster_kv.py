"""The port's cluster KV tier against the JAX package's, on the CPU
(llama-tiny, float32 unless a test says otherwise):

- pool level, one script through the JAX pool and the port's pool: the
  heartbeat sketch (digests leading pages first, the byte cap,
  ``prefix_sketch_truncated_total``), ``adopt_host_pages`` (local content
  wins, the restore budget, the counters, the restore through ``lookup``)
  and ``export_prep`` (host payloads, captured device pages, a failing
  capture left out). Observations must be equal;
- the wire: ``kv_export_pages`` of a JAX node and of the port's node on the
  same weights and requests, f32, bf16 and int8 pools: the page metas equal
  and the payload bytes equal, the pools filled with the same seeded bytes
  first (the two frameworks' K/V round apart); the handoff tail's meta
  equal and its values within float rounding;
- cross-adoption: the JAX node's export adopted by the port's node, and the
  port's by the JAX node, greedy tokens equal to a local prefill's; a JAX
  phase one installed live by the port's node;
- the JAX control plane (``tests/helpers_cp.CPHarness``) over two port
  nodes as child processes (``tests/helpers_torch_cluster``), the scripts
  of ``tests/test_cluster_prefix.py``: a ``kv_peer`` transfer token-exact
  with its counters and the gateway's relay, ``kv.fetch_fail`` and
  ``kv.fetch_stall`` degrading token-exact with no leaked page, the
  same-prefix prefetch dedup, affinity routing on heartbeat sketches;
- ``chip_smoke.phase_cluster`` rehearsed on the CPU.

Torch runs on one intra-op thread (a module fixture); every engine is
closed; the file's last test asserts that no node thread is left.
"""

from __future__ import annotations

import asyncio
import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentfield_tpu import prefix_hash as jax_prefix_hash
from agentfield_tpu.models import configs as jax_configs
from agentfield_tpu.models import llama as jax_llama
from agentfield_tpu.ops.kv_quant import QuantPages as JaxQuantPages
from agentfield_tpu.serving import engine as jax_engine
from agentfield_tpu.serving import kv_cache as jax_kv
from agentfield_tpu.serving import model_node as jax_node
from agentfield_tpu.serving.sampler import SamplingParams as JaxSampling
from agentfield_tpu_torch import prefix_hash
from agentfield_tpu_torch.models.configs import get_config
from agentfield_tpu_torch.models.convert import params_from_numpy
from agentfield_tpu_torch.ops.kv_quant import bits
from agentfield_tpu_torch.serving import engine
from agentfield_tpu_torch.serving import kv_cache
from agentfield_tpu_torch.serving.model_node import ModelBackend
from agentfield_tpu_torch.serving.sampler import SamplingParams
from tests import helpers_torch_cluster as hc
from tests.helpers_cp import CPHarness, async_test

ECFG = dict(max_batch=2, page_size=8, num_pages=64, max_pages_per_seq=16)
POOLS = {"jax": jax_kv, "torch": kv_cache}
HASHES = {"jax": jax_prefix_hash, "torch": prefix_hash}
KV_COUNTERS = ("prefix_sketch_truncated_total", "kv_fetch_pages_adopted_total",
               "kv_offload_host_evicted", "kv_offload_restored", "prefix_pages_reused",
               "kv_quant_host_bytes_saved_total")


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
    path = str(tmp_path_factory.mktemp("cluster") / "llama_tiny.npz")
    hc.write_weights(path, weights[1])
    return path


@pytest.fixture
def backends(weights):
    """``make(kind, **ecfg)``: a JAX or a port node backend (not started) on
    the same weights; every engine is closed at the test's end."""
    made = []
    jcfg, tree, params = weights

    def make(kind: str, dtype: str = "float32", **ecfg):
        ecfg = {**ECFG, **ecfg}
        if kind == "jax":
            p = jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)
            b = jax_node.ModelBackend(p, dataclasses.replace(jcfg, dtype=dtype),
                                      jax_engine.EngineConfig(**ecfg))
        else:
            cfg = dataclasses.replace(get_config("llama-tiny"), dtype=dtype)
            b = ModelBackend(params_from_numpy(tree, cfg, device="cpu"), cfg,
                             engine.EngineConfig(**ecfg), device="cpu")
        made.append(b)
        return b

    yield make
    for b in made:
        b.engine.close()


def _prompt(seed: int, n: int) -> list[int]:
    return np.random.default_rng(seed).integers(0, 512, n).tolist()


def _run(eng, rid, prompt, max_new=6, **kw):
    jax_side = isinstance(eng, jax_engine.InferenceEngine)
    mod, samp = (jax_engine, JaxSampling) if jax_side else (engine, SamplingParams)
    return eng.run_to_completion([mod.Request(id=rid, prompt=prompt,
                                              sampling=samp(max_new_tokens=max_new),
                                              **kw)])[rid]


# ---------------------------------------------------------------------------
# pool level


def test_sketch_digest_matches_jax():
    toks = _prompt(1, 40)
    for h_j, h_t in zip(jax_prefix_hash.page_chain_hashes(toks, 8),
                        prefix_hash.page_chain_hashes(toks, 8)):
        assert h_j == h_t
        assert prefix_hash.sketch_digest(h_t) == jax_prefix_hash.sketch_digest(h_j)
    assert prefix_hash.SKETCH_DIGEST_BYTES == jax_prefix_hash.SKETCH_DIGEST_BYTES


def _script_sketch(kv, _h) -> dict:
    pool = kv.PrefixPagePool(32, 4)
    a, b = list(range(20)), list(range(100, 112))
    pa, pb = pool.alloc(5), pool.alloc(3)
    pool.publish(a, pa)
    pool.publish(b, pb)
    obs = {"full": pool.sketch(4096), "capped": pool.sketch(64 + 2 * 19),
           "three": pool.sketch(64 + 3 * 19), "none": pool.sketch(0)}
    pool.free(pa)
    pool.free(pb)
    obs["after_free"] = pool.sketch(4096)
    return obs | {k: pool.stats[k] for k in KV_COUNTERS}


def _script_adopt(kv, h) -> dict:
    pool = kv.PrefixPagePool(16, 4)
    toks = list(range(24))  # 6 full pages
    hs = h.page_chain_hashes(toks, 4)
    entries = [(hs[i], i, tuple(toks[4 * i : 4 * i + 4]), f"peer-{i}") for i in range(6)]
    obs = {"unarmed": pool.adopt_host_pages(entries)}  # restore not armed: nothing
    uploaded: list = []
    pool.configure_quant(7)
    pool.enable_restore(budget_bytes=4 * 100, page_bytes=100,
                        upload=lambda payloads, pages: uploaded.append(list(zip(pages, payloads))))
    p = pool.alloc(1)
    pool.publish(toks[:4], p)  # page 0 local: local content wins
    pool.free(p)
    obs["adopted"] = pool.adopt_host_pages(entries[:5])  # 4 new, within the budget
    obs["again"] = pool.adopt_host_pages(entries[:5])  # all indexed now
    obs["host"] = (pool.host_pages, pool.host_bytes, pool.peek(toks),
                   pool.host_prefix_pages(toks), pool.evictable_prefix_pages(toks))
    obs["sketch"] = pool.sketch(4096)
    pages, n = pool.lookup(toks[:20])
    obs["lookup"] = (pages, n, uploaded)
    pool.free(pages)
    obs["over_budget"] = pool.adopt_host_pages(  # 6 more pages past a 4-page budget
        [(c, d + 6, tuple(range(50 + d, 54 + d)), f"x-{d}")
         for d, c in enumerate(h.page_chain_hashes(list(range(200, 224)), 4))])
    obs["end"] = (pool.host_pages, pool.free_pages, pool.cached_pages)
    return obs | {k: pool.stats[k] for k in KV_COUNTERS}


def _script_export(kv, h) -> dict:
    pool = kv.PrefixPagePool(16, 4)
    pool.enable_restore(budget_bytes=1000, page_bytes=100, upload=lambda payloads, pages: None)
    toks = list(range(16))
    hs = h.page_chain_hashes(toks, 4)
    p = pool.alloc(2)
    pool.publish(toks[:8], p)  # pages 0 and 1 on the device, still held
    pool.adopt_host_pages([(hs[2], 2, tuple(toks[8:12]), "host-2")])
    want = [hs[0], hs[2], b"\0" * 16, hs[1]]
    obs = {"export": pool.export_prep(want, lambda page: f"cap-{page}")}

    def failing(page):
        if page == p[1]:
            raise RuntimeError("capture failed")
        return f"cap-{page}"

    obs["failing"] = pool.export_prep(want, failing)
    pool.free(p)
    obs["after_free"] = pool.export_prep(want, lambda page: f"cap-{page}")
    return obs | {k: pool.stats[k] for k in KV_COUNTERS}


@pytest.mark.parametrize("script", [_script_sketch, _script_adopt, _script_export],
                         ids=["sketch", "adopt", "export"])
def test_pool_cluster_tier_matches_jax(script):
    j, t = (script(POOLS[k], HASHES[k]) for k in ("jax", "torch"))
    assert t == j


def test_pool_script_outcomes():
    """What the scripts above show, stated (the port's pool)."""
    s = _script_sketch(kv_cache, prefix_hash)
    assert s["full"]["truncated"] == 0 and len(s["full"]["digests"]) == 8
    # leading pages first: depth 0 of both prompts, then depth 1
    a, b = prefix_hash.page_chain_hashes(list(range(20)), 4), prefix_hash.page_chain_hashes(
        list(range(100, 112)), 4)
    assert s["capped"]["digests"] == [prefix_hash.sketch_digest(x) for x in (a[0], b[0])]
    assert s["prefix_sketch_truncated_total"] == 3 and s["none"]["digests"] == []
    ad = _script_adopt(kv_cache, prefix_hash)
    assert ad["unarmed"] == 0 and ad["adopted"] == 4 and ad["again"] == 0
    assert ad["host"][:3] == (4, 400, 20) and ad["lookup"][1] == 20
    assert ad["kv_offload_restored"] == 4 and ad["kv_fetch_pages_adopted_total"] == 10
    assert ad["kv_offload_host_evicted"] == 2 and ad["kv_quant_host_bytes_saved_total"] == 70
    ex = _script_export(kv_cache, prefix_hash)
    assert [(d, kind) for _, d, _, kind in ex["export"]] == [(0, "handle"), (2, "host"),
                                                             (1, "handle")]
    assert [d for _, d, _, _ in ex["failing"]] == [0, 2]


def test_engine_sketch_knob_and_peek_match_jax(backends):
    prompt = _prompt(2, 40)
    obs = []
    for kind in ("jax", "torch"):
        off = backends(kind, prefix_sketch_bytes=0)
        assert off.engine.prefix_sketch() is None
        on = backends(kind)
        _run(on.engine, "s", prompt)
        obs.append((on.engine.prefix_sketch(), on.engine.peek_prefix(prompt),
                    on.engine.peek_prefix(prompt[:20]), on.engine.page_payload_spec()))
    assert obs[1] == obs[0]
    assert obs[1][1] == 40 and len(obs[1][0]["digests"]) == 5


# ---------------------------------------------------------------------------
# the wire


def _fill_pools(jb, tb, seed: int) -> None:
    """Both engines' pools hold the same seeded bytes: the two frameworks'
    K/V round apart, the wire format must not."""
    rng = np.random.default_rng(seed)
    jleaves, treedef = jax.tree.flatten((jb.engine.cache.k_pages, jb.engine.cache.v_pages))
    new = []
    for jl, tl in zip(jleaves, tb.engine.cache.leaves()):
        shape, dt = tuple(jl.shape), np.dtype(jl.dtype)
        if dt.kind == "f":
            raw = rng.standard_normal(shape).astype(np.float32).astype(dt)
        else:
            raw = rng.integers(-127, 128, shape).astype(dt)
        new.append(jnp.asarray(raw))
        src = torch.frombuffer(bytearray(raw.tobytes()), dtype=torch.uint8)
        bits(tl).copy_(src.view(bits(tl).dtype).view(tl.shape))
    jb.engine.cache.k_pages, jb.engine.cache.v_pages = jax.tree.unflatten(treedef, new)


@pytest.mark.parametrize("dtype,kv_quant", [("float32", "none"), ("bfloat16", "none"),
                                            ("float32", "int8")])
def test_kv_export_pages_wire_matches_jax(backends, dtype, kv_quant):
    jb = backends("jax", dtype=dtype, kv_quant_dtype=kv_quant)
    tb = backends("torch", dtype=dtype, kv_quant_dtype=kv_quant)
    prompt, hprompt = _prompt(3, 45), _prompt(4, 29)
    for b in (jb, tb):
        _run(b.engine, "w", prompt)
        ev = _run(b.engine, "h", hprompt, handoff_export=True)
        assert len(ev) == 1
    descs = [b.engine.pop_handoff_desc("h") for b in (jb, tb)]
    assert {k: v for k, v in descs[1].items() if k != "logprob"} == {
        k: v for k, v in descs[0].items() if k != "logprob"}
    assert descs[1]["logprob"] == pytest.approx(descs[0]["logprob"], abs=1e-4)
    _fill_pools(jb, tb, seed=5)
    chains = [h.hex() for h in prefix_hash.page_chain_hashes(prompt[:-1], 8)]
    # a chain twice, one unknown, one malformed: the exporters skip alike
    asked = chains + [chains[0], "00" * 16, "zz"]
    jpages = asyncio.run(jb.kv_export_pages(asked, 8 << 20, handoff="h"))
    tpages = tb.kv_export_pages(asked, 8 << 20, handoff="h")
    assert [m for m, _ in tpages] == [m for m, _ in jpages]
    assert len(tpages) == len(chains) + 2  # the tail, the pages, the repeat
    assert "handoff" in tpages[0][0] and "chain" not in tpages[0][0]
    n_leaves = 4 if kv_quant != "none" else 2
    assert len(tpages[1][0]["parts"]) == n_leaves
    for (m, tbytes), (_, jbytes) in zip(tpages[1:], jpages[1:]):
        assert tbytes == jbytes, m["chain"]
    # the tail was captured before the fill: the two frameworks' values
    tail = [np.frombuffer(p[0][1], np.uint8) for p in (jpages, tpages)]
    assert tail[0].size == tail[1].size
    off = 0
    for part, seg in zip(tpages[0][0]["parts"], tpages[0][0]["segs"]):
        dt = np.dtype(jnp.dtype(part["dtype"]))
        a, b = (t[off : off + seg].view(dt).astype(np.float32) for t in tail)
        np.testing.assert_allclose(b, a, rtol=2e-2 if dtype == "bfloat16" else 1e-4,
                                   atol=2e-2 if dtype == "bfloat16" else 1e-4)
        off += seg
    keys = ("kv_fetch_served_total", "kv_fetch_bytes_total", "kv_quant_wire_bytes_saved_total",
            "kv_handoff_bytes_total")
    assert {k: tb.engine.stats[k] for k in keys} == {k: jb.engine.stats[k] for k in keys}
    assert tb.engine.export_handoff_tail("h") is None  # one-shot, on both sides
    assert jb.engine.export_handoff_tail("h") is None
    if kv_quant != "none":
        assert tb.engine.stats["kv_quant_wire_bytes_saved_total"] > 0


def _pages_for(pages: list) -> list[dict]:
    """An exporter's ``(meta, payload)`` list as a fetch returns it."""
    return [{**m, "data": data} for m, data in pages]


def test_port_adopts_a_jax_export_token_exact(backends):
    jb, tb, ref = backends("jax"), backends("torch"), backends("torch")
    shared, tail = _prompt(6, 32), _prompt(7, 3)
    _run(jb.engine, "warm", shared + [1, 2], max_new=4)
    chains = [h.hex() for h in prefix_hash.page_chain_hashes(shared, 8)]
    jpages = asyncio.run(jb.kv_export_pages(chains, 8 << 20))
    calls = []

    def fetch(peer, chains_hex, timeout_s, **kw):
        calls.append((peer, len(chains_hex), kw))
        return _pages_for(jpages)

    tb._kv_fetch_fn = fetch
    tb.start()
    try:
        out = tb.generate(tokens=shared + tail, max_new_tokens=6,
                          kv_peer={"node_id": "jax-a", "pages": 4, "page_size": 8})
    finally:
        tb.stop()
    assert calls == [("jax-a", 4, {})]
    assert tb.engine.stats["kv_fetch_pages_adopted_total"] == 4
    assert tb.engine.stats["kv_offload_restored"] == 4
    assert tb.engine.stats["prefill_tokens"] == len(tail)
    assert out["tokens"] == _run(ref.engine, "r", shared + tail)


def test_jax_adopts_a_port_export_token_exact(backends):
    tb, jb, jref = backends("torch"), backends("jax"), backends("jax")
    shared, tail = _prompt(8, 32), _prompt(9, 3)
    _run(tb.engine, "warm", shared + [1, 2], max_new=4)
    chains = [h.hex() for h in prefix_hash.page_chain_hashes(shared, 8)]
    tpages = tb.kv_export_pages(chains, 8 << 20)

    async def fetch(peer, chains_hex, timeout_s, **kw):
        return _pages_for(tpages)

    async def main():
        jb._kv_fetch_fn = fetch
        await jb.start()
        try:
            return await jb.generate(tokens=shared + tail, max_new_tokens=6,
                                     kv_peer={"node_id": "port-a", "pages": 4, "page_size": 8})
        finally:
            await jb.stop()

    out = asyncio.run(main())
    assert jb.engine.stats["kv_fetch_pages_adopted_total"] == 4
    assert jb.engine.stats["prefill_tokens"] == len(tail)
    assert out["tokens"] == _run(jref.engine, "r", shared + tail)


def test_port_installs_a_jax_phase_one_live(backends):
    """A JAX node's phase one (pages and tail) installed live by the port's
    node: no prefill, the JAX first token, tokens equal to single-node runs
    of both packages."""
    jb, tb = backends("jax"), backends("torch")
    prompt = _prompt(10, 27)
    ev = _run(jb.engine, "p1", prompt, handoff_export=True)
    desc = jb.engine.pop_handoff_desc("p1")
    assert len(ev) == 1 and desc["pages"] == 3
    chains = [h.hex() for h in prefix_hash.page_chain_hashes(prompt[:-1], 8)]
    jpages = asyncio.run(jb.kv_export_pages(chains, 8 << 20, handoff="p1"))
    tb._kv_fetch_fn = lambda peer, chains_hex, timeout_s, **kw: _pages_for(jpages)
    tb.start()
    try:
        out = tb.generate(tokens=prompt, max_new_tokens=6, handoff=desc,
                          kv_peer={"node_id": "jax-a", "pages": 3, "page_size": 8,
                                   "handoff": "p1"})
    finally:
        tb.stop()
    assert tb.engine.stats["kv_handoff_completed_total"] == 1
    assert tb.engine.stats["prefill_tokens"] == 0
    assert out["tokens"][0] == desc["t0"] == ev[0]
    ref_j = _run(backends("jax").engine, "r", prompt)
    assert out["tokens"] == ref_j == _run(backends("torch").engine, "r", prompt)


def test_prefetch_rejects_a_mismatched_or_corrupt_page(backends):
    """Pages checked leaf by leaf against ``page_payload_spec``: a peer with
    another pool dtype, or a torn payload, ends the adoptable prefix (a
    local prefill follows); a hint of another page size asks nothing."""
    b32, b16 = backends("torch"), backends("torch", dtype="bfloat16")
    shared = _prompt(11, 32)
    _run(b16.engine, "warm", shared + [1], max_new=2)
    chains = [h.hex() for h in prefix_hash.page_chain_hashes(shared, 8)]
    pages16 = b16.kv_export_pages(chains, 8 << 20)
    b32._kv_fetch_fn = lambda *a, **kw: _pages_for(pages16)
    hint = {"node_id": "p", "pages": 4, "page_size": 8}
    assert b32.maybe_prefetch_kv(shared + [3], hint) == 0
    assert b32.engine.stats["kv_fetch_failed_total"] == 1
    torn = _pages_for(b32.kv_export_pages(chains, 8 << 20))  # nothing held: empty
    assert torn == []
    _run(b32.engine, "warm", shared + [1], max_new=2)
    other = backends("torch")
    good = _pages_for(b32.kv_export_pages(chains, 8 << 20))
    good[2] = {**good[2], "data": good[2]["data"][:-4]}  # page 2 torn
    other._kv_fetch_fn = lambda *a, **kw: good
    assert other.maybe_prefetch_kv(shared + [3], hint) == 2
    assert other.engine.stats["kv_fetch_failed_total"] == 1
    assert other.maybe_prefetch_kv(shared + [3], {**hint, "page_size": 16}) == 0
    assert other.engine.stats["kv_fetch_requested_total"] == 1


# ---------------------------------------------------------------------------
# the JAX control plane over port nodes (tests/test_cluster_prefix.py)


async def _gen(h, target, body):
    async with h.http.post(f"/api/v1/execute/{target}", json={"input": body}) as r:
        doc = await r.json()
    assert doc["status"] == "completed", doc
    return doc


async def _gauge(h, name: str, node: str, want: float) -> None:
    """Wait for a node's heartbeat to bring a counter to the control
    plane's per-node gauge."""
    for _ in range(300):
        if h.cp.metrics.gauge_value(name, labels={"node": node}) == want:
            return
        await asyncio.sleep(0.05)
    raise AssertionError(f"{name} of {node}: "
                         f"{h.cp.metrics.gauge_value(name, labels={'node': node})} != {want}")


async def _pair(h, weights_file, b_kw=None, a_kw=None):
    return await asyncio.gather(
        hc.start_node(h.base_url, "node-a", weights_file, ecfg=ECFG, **(a_kw or {})),
        hc.start_node(h.base_url, "node-b", weights_file, ecfg=ECFG, **(b_kw or {})))


async def _stop(*nodes):
    rcs = await asyncio.gather(*(hc.stop_node(proc, lines) for proc, _, lines in nodes))
    assert rcs == [0] * len(nodes), [n[2] for n in nodes]


@async_test
async def test_cross_node_transfer_token_exact_and_counters(weights_file):
    async with CPHarness() as h:
        a, b = await _pair(h, weights_file)
        # the hint is driven by hand: affinity off keeps the nodes' own
        # heartbeat sketches from routing the hinted request to A
        h.cp.gateway.prefix_affinity = False
        try:
            shared = list(range(50, 82))  # 4 full pages of 8
            await _gen(h, "node-a.generate", {"tokens": shared + [1, 2], "max_new_tokens": 4})
            prompt = shared + [7, 9]
            ref = await _gen(h, "node-a.generate", {"tokens": prompt, "max_new_tokens": 6})
            pre = (await hc.idle_stats(b[1]))["prefill_tokens"]
            doc = await _gen(h, "node-b.generate", {
                "tokens": prompt, "max_new_tokens": 6,
                "kv_peer": {"node_id": "node-a", "pages": 4, "page_size": 8}})
            assert doc["result"]["tokens"] == ref["result"]["tokens"]
            sb, sa = await hc.idle_stats(b[1]), await hc.idle_stats(a[1])
            assert sb["prefill_tokens"] - pre < len(shared)
            assert sb["kv_fetch_requested_total"] == 1 and sb["kv_fetch_failed_total"] == 0
            assert sb["kv_fetch_pages_adopted_total"] == 4
            assert sa["kv_fetch_served_total"] == 4 and sa["kv_fetch_bytes_total"] > 0
            assert h.cp.metrics.counter_value("kv_relay_fetches_total") == 1
            # the counters ride the heartbeat to the control plane's gauges
            await _gauge(h, "engine_kv_fetch_pages_adopted_total", "node-b", 4.0)
            await _gauge(h, "engine_channel_server_kv_fetches_total", "node-a", 1.0)
        finally:
            await _stop(a, b)


@async_test
async def test_fetch_fail_and_stall_degrade_token_exact_zero_leak(weights_file):
    """``kv.fetch_fail`` (A answers an error frame) then ``kv.fetch_stall``
    (A answers after B's 0.15 s timeout): both re-prefill locally with the
    same tokens, nothing adopted, no page leaked."""
    spec = {"kv.fetch_fail": {"times": 1},
            "kv.fetch_stall": {"times": 1, "after": 1, "delay_s": 1.0}}
    async with CPHarness() as h:
        a, b = await _pair(h, weights_file, b_kw={"kv_fetch_timeout_s": 0.15},
                           a_kw={"faults": spec})
        h.cp.gateway.prefix_affinity = False
        try:
            hint = {"node_id": "node-a", "pages": 4, "page_size": 8}
            shared = list(range(90, 122))
            await _gen(h, "node-a.generate", {"tokens": shared + [1, 2], "max_new_tokens": 4})
            prompt = shared + [3, 4]
            ref = await _gen(h, "node-a.generate", {"tokens": prompt, "max_new_tokens": 6})
            pre = (await hc.idle_stats(b[1]))["prefill_tokens"]
            doc = await _gen(h, "node-b.generate",
                             {"tokens": prompt, "max_new_tokens": 6, "kv_peer": hint})
            assert doc["result"]["tokens"] == ref["result"]["tokens"]
            sb = await hc.idle_stats(b[1])
            assert sb["kv_fetch_failed_total"] == 1 and sb["kv_fetch_pages_adopted_total"] == 0
            assert sb["prefill_tokens"] - pre == len(prompt)
            shared2 = list(range(160, 192))  # warmed on A only
            await _gen(h, "node-a.generate", {"tokens": shared2 + [1, 2], "max_new_tokens": 4})
            prompt2 = shared2 + [5, 6]
            ref2 = await _gen(h, "node-a.generate", {"tokens": prompt2, "max_new_tokens": 6})
            doc2 = await _gen(h, "node-b.generate",
                              {"tokens": prompt2, "max_new_tokens": 6, "kv_peer": hint})
            assert doc2["result"]["tokens"] == ref2["result"]["tokens"]
            await asyncio.sleep(1.0)  # the stalled answer lands on nobody
            sb = await hc.idle_stats(b[1])
            assert sb["kv_fetch_failed_total"] == 2 and sb["kv_fetch_pages_adopted_total"] == 0
            await _gauge(h, "engine_channel_server_kv_fetch_timeouts_total", "node-b", 1.0)
            await _gauge(h, "engine_channel_server_kv_fetch_errors_total", "node-a", 1.0)
            sa = await hc.idle_stats(a[1])
            for st in (sa, sb):
                assert st["free_pages"] == ECFG["num_pages"] - 1
        finally:
            await _stop(a, b)


def test_prefetch_dedups_concurrent_same_prefix_fetches(backends):
    """A same-prefix burst on one cold node makes one transfer: the others
    wait for the leader's adoption (here a failure) and re-prefill."""
    back = backends("torch", num_pages=32, max_pages_per_seq=8)
    calls = []
    gate = threading.Event()

    def slow_fetch(peer, chains_hex, timeout_s):
        calls.append(peer)
        gate.wait(5)
        return None

    back._kv_fetch_fn = slow_fetch
    toks = list(range(40))
    hint = {"node_id": "peer-a", "pages": 4, "page_size": 8}
    out: list = []
    ths = [threading.Thread(target=lambda: out.append(back.maybe_prefetch_kv(toks, hint)))
           for _ in range(4)]
    for th in ths:
        th.start()
    for _ in range(500):
        if calls and back._kv_prefetch_inflight:
            break
        time.sleep(0.005)
    time.sleep(0.05)  # the followers reach the leader's event
    gate.set()
    for th in ths:
        th.join(10)
    assert calls == ["peer-a"] and out == [0, 0, 0, 0]
    assert back.engine.stats["kv_fetch_requested_total"] == 1
    assert back._kv_prefetch_inflight == {}


@async_test
async def test_affinity_routes_burst_to_warm_node_and_off_pin(weights_file):
    """Through the nodes' own heartbeat sketches: a request named for the
    cold node B routes to the warm advertiser A with affinity on; off, it
    stays on B."""
    async with CPHarness() as h:
        a, b = await _pair(h, weights_file)
        try:
            shared = list(range(130, 162))
            await _gen(h, "node-a.generate", {"tokens": shared + [1, 2], "max_new_tokens": 4})
            want = jax_prefix_hash.sketch_digest(
                jax_prefix_hash.page_chain_hashes(shared, 8)[3])
            for _ in range(300):  # A's next heartbeat carries the pages
                got = h.cp.registry.cache.get_sketch("node-a")
                if got is not None and want in got[0]["digests"]:
                    break
                await asyncio.sleep(0.05)
            else:
                raise AssertionError("node-a's sketch never advertised the prefix")
            doc = await _gen(h, "node-b.generate", {"tokens": shared + [3, 4],
                                                    "max_new_tokens": 4})
            assert doc["nodes_tried"][-1] == "node-a"
            h.cp.gateway.prefix_affinity = False
            doc2 = await _gen(h, "node-b.generate", {"tokens": shared + [5, 6],
                                                     "max_new_tokens": 4})
            assert doc2["nodes_tried"][-1] == "node-b"
        finally:
            await _stop(a, b)


# ---------------------------------------------------------------------------
# the chip smoke's phase, rehearsed


def test_smoke_cluster_phase_rehearses_on_cpu():
    """``chip_smoke.phase_cluster`` end to end on the CPU at llama-tiny size:
    two-phase dispatch, a fetched prefix (bf16-free: the tiny preset is
    f32; an int8 pair too), the four faults, the keep-warm chain."""
    import chip_smoke
    from agentfield_tpu_torch.models.llama import init_params

    cfg = get_config("llama-tiny")
    results: dict = {}
    chip_smoke.phase_cluster(
        results, {"params": init_params(cfg, seed=0, device="cpu"), "cfg": cfg}, 0,
        device="cpu", model_name="llama-tiny", a_prompts=2, a_prompt=48, a_suffix=8, a_new=6,
        int8_prompts=1, b_prompts=(20, 37, 50, 70), b_new=8,
        d=dict(prompt=30, cand=10, tool=5, new=4), num_pages=128, max_pages_per_seq=16,
        page_size=8, restore_bytes=8 << 20, stall_s=0.5, fetch_timeout_s=0.15,
        heartbeat_interval=0.1)
    cl = results["cluster"]
    assert len(cl["b"]["gap_ms"]) == 4 and cl["b"]["pages_adopted"] > 0
    assert [r["pages"] for r in cl["a"]["rows"]] == [6, 6]
    assert cl["a_int8"]["wire_bytes_saved"] > 0
    assert cl["c"]["kv.handoff_stall"]["b_kv_fetch_failed_total"] == 1
    assert cl["d"]["counters"]["spec_hit_total"] == 4
    assert cl["relay"]["kv_relay_errors_total"] == 0


def test_no_node_thread_outlives_the_file():
    time.sleep(0.2)
    left = [t.name for t in threading.enumerate()
            if t.is_alive() and t.name.startswith(("channel-", "engine", "kv-offload"))]
    assert not left, left
