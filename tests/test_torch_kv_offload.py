"""The port's host KV tier against the JAX package's, on the CPU (llama-tiny,
float32, the same carried weights). The scripts are those of
``tests/test_kv_offload.py``:

- pool level, one fake device (a dict of page -> payload) driving the JAX
  pool and the port's pool: round trip, the host budget dropping the
  oldest demotion, a stalled copy aborted after eviction, the disabled tier
  inert. Counters and host pages must be equal;
- engine level, through both engines with the JAX file's ``ECFG``: expiry
  demote then a token-exact resume, ``kv.restore_fail`` degrading to a
  re-prefill (each package's own injector), ``kv.offload_stall`` churn with
  no corruption or deadlock, offload on equal to offload off (classic and
  mixed ticks), a restore evicting idle live sessions, the config check's
  message, no worker thread without a budget. Tokens, the ``kv_offload_*``
  counters and ``free_pages`` must be equal;
- int8 and fp8 pools: a page's bytes and scales restore bit for bit, and
  the port's host payloads hold the JAX payloads' values bit for bit.

Every engine with a host tier is closed by the ``engines`` fixture's
finalizer, and the file's last test asserts that no offload thread is left.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import jax
import numpy as np
import pytest
import torch

from agentfield_tpu.control_plane import faults as jax_faults
from agentfield_tpu.models import configs as jax_configs
from agentfield_tpu.models import llama as jax_llama
from agentfield_tpu.serving import engine as jax_engine
from agentfield_tpu.serving import kv_cache as jax_kv
from agentfield_tpu.serving.sampler import SamplingParams as JaxSampling
from agentfield_tpu_torch.models.configs import get_config
from agentfield_tpu_torch.models.convert import params_from_numpy
from agentfield_tpu_torch.ops.kv_quant import bits
from agentfield_tpu_torch.serving import engine
from agentfield_tpu_torch.serving import faults
from agentfield_tpu_torch.serving import kv_cache
from agentfield_tpu_torch.serving.sampler import SamplingParams

# the JAX file's engine shape: 15 usable pages that cannot hold many idle
# sessions, a 64 MiB host budget (llama-tiny pages are tiny)
ECFG = dict(max_batch=2, page_size=8, num_pages=16, max_pages_per_seq=8,
            host_cache_bytes=64 << 20, session_ttl=60.0)
NO_TIER = dict(max_batch=2, page_size=8, num_pages=16, max_pages_per_seq=8,
               enable_prefix_cache=False)
OFFLOAD_KEYS = ("kv_offload_demoted", "kv_offload_restored", "kv_offload_restore_fail",
                "kv_offload_demote_fail", "kv_offload_host_evicted", "prefix_index_hits",
                "sessions_evicted")
V = 512
# (the kv_cache module, its package's fault module) of each pool
POOLS = {"jax": (jax_kv, jax_faults), "torch": (kv_cache, faults)}


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
    jcfg = dataclasses.replace(jax_configs.get_config("llama-tiny"), dtype="float32")
    tree = jax.tree.map(np.asarray, jax_llama.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tree, params_from_numpy(tree, get_config("llama-tiny"), device="cpu")


@pytest.fixture(autouse=True)
def _clear_injectors():
    yield
    jax_faults.install(None)
    faults.install(None)


@pytest.fixture
def engines(weights):
    """``make(mod, **ecfg)`` builds an engine of either package; every one
    is closed at the test's end (the offload worker must not outlive it)."""
    made = []
    jcfg, tree, params = weights

    def make(mod, **ecfg):
        if mod is jax_engine:
            e = jax_engine.InferenceEngine(tree, jcfg, jax_engine.EngineConfig(**ecfg))
        else:
            e = engine.InferenceEngine(params, get_config("llama-tiny"),
                                       engine.EngineConfig(**ecfg))
        made.append(e)
        return e

    yield make
    for e in made:
        e.close()


def _prompt(seed: int, n: int) -> list[int]:
    return np.random.default_rng(seed).integers(0, V, n).tolist()


def _run(eng, rid, prompt, max_new=4, session=None):
    samp = JaxSampling if isinstance(eng, jax_engine.InferenceEngine) else SamplingParams
    mod = jax_engine if isinstance(eng, jax_engine.InferenceEngine) else engine
    return eng.run_to_completion([mod.Request(id=rid, prompt=prompt,
                                              sampling=samp(max_new_tokens=max_new),
                                              session_id=session)])[rid]


def _install(mod, spec, seed):
    """Install an injector of the engine module's own package."""
    f = jax_faults if mod is jax_engine else faults
    f.install(f.FaultInjector(seed=seed, spec=spec))


def _observe(eng) -> dict:
    """What must agree between the packages after a script."""
    with eng._session_lock:
        return {"counters": {k: eng.stats[k] for k in OFFLOAD_KEYS},
                "free_pages": eng.allocator.free_pages,
                "host_pages": eng.allocator.host_pages}


# ---------------------------------------------------------------------------
# pool level: one fake device for both pools


def _fake_tier(pool, budget_pages: int = 8):
    dev: dict[int, object] = {}
    lock = threading.RLock()
    pool.enable_host_tier(
        budget_bytes=budget_pages * 100, page_bytes=100, lock=lock,
        capture=lambda p: ("snap", dev.get(p)),  # content at capture time
        fetch=lambda h: h[1],
        upload=lambda payloads, pages: dev.update(zip(pages, payloads)),
    )
    return dev, lock


def _pool_counts(pool) -> dict:
    return {k: pool.stats[k] for k in ("kv_offload_demoted", "kv_offload_restored",
                                       "kv_offload_host_evicted", "prefix_pages_evicted",
                                       "prefix_pages_reused")} | {
        "host_pages": pool.host_pages, "free_pages": pool.free_pages}


def _script_round_trip(kv, _faults) -> dict:
    pool = kv.PrefixPagePool(8, page_size=4)
    dev, lock = _fake_tier(pool)
    obs = {}
    try:
        with lock:
            pages = pool.alloc(2)
            for p in pages:
                dev[p] = f"kv-{p}"
            toks = list(range(8))
            pool.publish(toks, pages)
            pool.free(pages)
            obs["free_cached"] = pool.free_pages
            obs["enqueued"] = pool.demote_lru()
        assert pool.offload_drain(5.0)
        with lock:
            obs["demoted"] = _pool_counts(pool) | {
                "cached": pool.cached_pages, "evictable": pool.evictable_prefix_pages(toks),
                "host_prefix": pool.host_prefix_pages(toks), "peek": pool.peek(toks)}
            got, n = pool.lookup(toks)
            obs["lookup"] = (n, [pool.refcount(p) for p in got], [dev[p] for p in got])
            obs["restored"] = _pool_counts(pool)
            pool.free(got)
            obs["evictable_after"] = pool.evictable_prefix_pages(toks)
    finally:
        pool.close()
    return obs


def _script_budget_drop(kv, _faults) -> dict:
    pool = kv.PrefixPagePool(8, page_size=4)
    dev, lock = _fake_tier(pool, budget_pages=1)
    try:
        with lock:
            pages = pool.alloc(2)
            for p in pages:
                dev[p] = f"kv-{p}"
            toks = list(range(8))
            pool.publish(toks, pages)
            pool.free(pages)
            pool.demote_lru()
        assert pool.offload_drain(5.0)
        with lock:
            return _pool_counts(pool) | {"peek": pool.peek(toks), "lookup": pool.lookup(toks)}
    finally:
        pool.close()


def _script_stalled_copy(kv, f) -> dict:
    f.install(f.FaultInjector(seed=3, spec={"kv.offload_stall": {"prob": 1.0, "delay_s": 0.05}}))
    pool = kv.PrefixPagePool(4, page_size=4)  # 3 usable pages
    dev, lock = _fake_tier(pool)
    try:
        with lock:
            pages = pool.alloc(1)
            dev[pages[0]] = "old-kv"
            pool.publish(list(range(4)), pages)
            pool.free(pages)
            enq = pool.demote_lru()  # the capture happens now
            # while the worker stalls, pressure evicts and reuses the page
            grabbed = pool.alloc(3)
            reused = pages[0] in grabbed
            dev[pages[0]] = "new-kv"
        assert pool.offload_drain(5.0)
        with lock:
            out = _pool_counts(pool) | {"enqueued": enq, "reused": reused,
                                        "peek": pool.peek(list(range(4)))}
            pool.free(grabbed)
            out["free_after"] = pool.free_pages
        return out
    finally:
        pool.close()
        f.install(None)


def _script_disabled(kv, _faults) -> dict:
    pool = kv.PrefixPagePool(8, page_size=4)
    out = {"thread": pool._offload_thread is None,
           "demote": (pool.demote_lru(), pool.demote_pages([1, 2])),
           "drain": pool.offload_drain(), "host": (pool.host_pages,
                                                   pool.host_prefix_pages([0, 1, 2, 3]))}
    pool.close()
    pool.close()
    return out


def test_pool_round_trip_matches_jax():
    j, t = (_script_round_trip(*POOLS[k]) for k in ("jax", "torch"))
    assert t == j
    assert t["enqueued"] == 2 and t["demoted"]["host_pages"] == 2
    assert t["demoted"]["free_pages"] == 7 and t["demoted"]["evictable"] == 0
    assert t["demoted"]["peek"] == 8 and t["lookup"][0] == 8 and t["lookup"][1] == [1, 1]
    assert t["lookup"][2] == ["kv-1", "kv-2"]  # the captured payloads, restored
    assert t["restored"]["kv_offload_restored"] == 2 and t["evictable_after"] == 2


def test_pool_host_budget_drops_oldest_matches_jax():
    j, t = (_script_budget_drop(*POOLS[k]) for k in ("jax", "torch"))
    assert t == j
    assert t["host_pages"] == 1 and t["kv_offload_host_evicted"] == 1
    assert t["peek"] == 0 and t["lookup"] == ([], 0)  # the chain broke at page 0


def test_pool_stalled_copy_aborts_after_eviction_matches_jax():
    j, t = (_script_stalled_copy(*POOLS[k]) for k in ("jax", "torch"))
    assert t == j
    assert t["enqueued"] == 1 and t["reused"] and t["prefix_pages_evicted"] == 1
    assert t["kv_offload_demoted"] == 0 and t["host_pages"] == 0 and t["peek"] == 0
    assert t["free_after"] == 3


def test_pool_disabled_tier_is_inert_matches_jax():
    j, t = (_script_disabled(*POOLS[k]) for k in ("jax", "torch"))
    assert t == j == {"thread": True, "demote": (0, 0), "drain": True, "host": (0, 0)}


@pytest.mark.parametrize("spec", [
    {"kv.restore_fail": {"prob": 0.5}},
    {"engine.preempt_storm": {"times": 2, "after": 4}},
    {"kv.offload_stall": {"prob": 0.3, "delay_s": 0.05}, "engine.page_pressure": {"prob": 0.7}},
], ids=["prob", "times-after", "two-points"])
def test_fault_injector_schedule_matches_jax(spec):
    """The same seed and spec give the JAX injector's decisions, point by
    point and call by call (interleaved consultations do not shift a
    point's stream)."""
    def schedule(f):
        inj = f.FaultInjector(seed=11, spec=spec)
        return [(p, (ft.point, ft.delay_s, ft.error) if (ft := inj.fire(p)) else None)
                for _ in range(20) for p in list(spec) + ["spec.fail"]]

    assert schedule(faults) == schedule(jax_faults)
    with pytest.raises(ValueError, match="unknown fault point"):
        faults.FaultInjector(spec={"kv.restore_fial": {}})
    faults.install(faults.FaultInjector(seed=0, spec={"kv.restore_fail": {"times": 1}}))
    assert faults.active() is not None and faults.fire("kv.restore_fail") is not None
    assert faults.fire("kv.restore_fail") is None
    faults.install(None)
    assert faults.fire("kv.restore_fail") is None


# ---------------------------------------------------------------------------
# engine level: each script through both engines


def _both(engines, script, ecfg=ECFG):
    """``script(make, mod)`` on the JAX engine and the port's: the returned
    observations must be equal."""
    j = script(lambda **kw: engines(jax_engine, **(ecfg | kw)), jax_engine)
    t = script(lambda **kw: engines(engine, **(ecfg | kw)), engine)
    assert t == j
    return t


def test_expiry_demotes_and_resume_restores_token_exact(engines):
    def script(make, mod):
        eng = make()
        t1 = _prompt(1, 16)  # 2 full pages
        out1 = _run(eng, "a", t1, session="conv")
        assert eng.gc_sessions(at=time.time() + 120) == 1
        assert eng.allocator.offload_drain(10.0)
        mid = _observe(eng)
        t2 = t1 + out1 + _prompt(2, 3)
        out2 = _run(eng, "b", t2, session="conv")
        fresh = _run(engines(mod, **NO_TIER), "b", t2)
        assert out2 == fresh, "restored KV diverged from a re-prefill"
        return {"out": (out1, out2), "mid": mid, "end": _observe(eng)}

    t = _both(engines, script)
    assert t["mid"]["host_pages"] >= 2 and t["mid"]["counters"]["kv_offload_demoted"] >= 2
    c = t["end"]["counters"]
    assert c["kv_offload_restored"] >= 2 and c["prefix_index_hits"] == 1
    assert c["kv_offload_restore_fail"] == 0


def test_restore_fail_degrades_to_reprefill(engines):
    def script(make, mod):
        eng = make()
        t1 = _prompt(10, 16)
        out1 = _run(eng, "a", t1, session="s")
        eng.gc_sessions(at=time.time() + 120)
        assert eng.allocator.offload_drain(10.0)
        host_before = eng.allocator.host_pages
        _install(mod, {"kv.restore_fail": {"prob": 1.0, "times": 1}}, seed=5)
        t2 = t1 + out1 + _prompt(11, 3)
        out2 = _run(eng, "b", t2, session="s")
        assert out2 == _run(engines(mod, **NO_TIER), "b", t2), "re-prefill diverged"
        failed = _observe(eng)
        # the re-prefill re-published the chain: its host copy was re-adopted
        assert eng.allocator.host_pages < host_before
        # with the fault spent, the next expiry and resume restore again
        eng.gc_sessions(at=time.time() + 240)
        assert eng.allocator.offload_drain(10.0)
        t3 = t2 + out2 + _prompt(12, 3)
        out3 = _run(eng, "c", t3, session="s")
        assert out3 == _run(engines(mod, **NO_TIER), "c", t3)
        return {"out": (out1, out2, out3), "host_before": host_before, "failed": failed,
                "end": _observe(eng)}

    t = _both(engines, script)
    assert t["host_before"] >= 2 and t["failed"]["counters"]["kv_offload_restore_fail"] == 1
    assert t["end"]["counters"]["kv_offload_restored"] > t["failed"]["counters"][
        "kv_offload_restored"]


def test_offload_stall_churn_never_corrupts_or_deadlocks(engines):
    """Every demote stalls 50 ms while two sessions alternate turns through
    the undersized pool and expire between turns: tokens stay the no-tier
    engine's, nothing wedges, every page is accounted for."""
    def script(make, mod):
        _install(mod, {"kv.offload_stall": {"prob": 1.0, "delay_s": 0.05}}, seed=7)
        eng = make()
        fresh = engines(mod, **NO_TIER)
        got, want = {}, {}
        clock = time.time()
        for turn in range(4):
            for s in ("x", "y"):
                rid = f"{s}{turn}"
                p = _prompt(40 + turn if s == "x" else 60 + turn, 12)
                got[rid] = _run(eng, rid, p, session=s)
                want[rid] = _run(fresh, rid, p)
            clock += 120
            eng.gc_sessions(at=clock)
        assert got == want, "offload churn changed emitted tokens"
        assert eng.allocator.offload_drain(10.0), "offload worker wedged"
        with eng._session_lock:
            a = eng.allocator
            assert a.free_pages == ECFG["num_pages"] - 1, "pages leaked"
            assert not a._demote_q and not a._demote_inflight
        return {"tokens": got, "free_pages": a.free_pages}

    _both(engines, script)


@pytest.mark.parametrize("mixed", [False, True], ids=["classic", "mixed"])
def test_offload_on_equals_offload_off(engines, mixed):
    extra = dict(mixed_step=True, mixed_step_budget=32) if mixed else {}
    shared = _prompt(80, 16)

    def reqs(mod):
        samp = JaxSampling if mod is jax_engine else SamplingParams
        return [mod.Request(id=f"r{i}", prompt=shared + _prompt(81 + i, 3),
                            sampling=samp(max_new_tokens=3)) for i in range(4)]

    def script(make, mod):
        off = make(host_cache_bytes=0, **extra)
        assert off.allocator._offload_thread is None
        want = off.run_to_completion(reqs(mod))
        on = make(**extra)
        got = on.run_to_completion(reqs(mod)[:2])
        with on._session_lock:
            on.allocator.demote_lru()  # churn through the tier mid-burst
        assert on.allocator.offload_drain(10.0)
        got.update(on.run_to_completion(reqs(mod)[2:]))
        assert got == want
        return {"tokens": got, "on": _observe(on), "off_free": off.allocator.free_pages}

    _both(engines, script)


def test_restore_evicts_idle_live_sessions_for_target_pages(engines):
    def script(make, mod):
        eng = make()
        t_old = _prompt(30, 16)
        out_old = _run(eng, "a", t_old, session="old")
        eng.gc_sessions(at=time.time() + 120)
        assert eng.allocator.offload_drain(10.0)
        assert eng.allocator.host_pages >= 2
        # live sessions then pin (nearly) the whole pool
        for i in range(3):
            _run(eng, f"pin{i}", _prompt(31 + i, 24), max_new=12, session=f"pin{i}")
        with eng._session_lock:
            free_now = eng.allocator.free_pages
        assert free_now < 2, f"pool not pinned enough ({free_now} free)"
        t2 = t_old + out_old + _prompt(40, 3)
        out2 = _run(eng, "b", t2, session="old")
        assert out2 == _run(engines(mod, **NO_TIER), "b", t2)
        return {"out": out2, "free_now": free_now, "end": _observe(eng)}

    t = _both(engines, script)
    assert t["end"]["counters"]["kv_offload_restored"] >= 2
    assert t["end"]["counters"]["sessions_evicted"] >= 1


def test_starvation_probe_counts_host_prefix_pages(engines):
    """A host-tier prefix page counts as cached for the candidate, but its
    restore takes a fresh page: with 3 pages free, a resume needing 2 pages
    beyond its 2 host-tier prefix pages is starved in both engines."""
    def script(make, mod):
        eng = make()
        t1 = _prompt(50, 16)
        out1 = _run(eng, "a", t1, session="h")
        eng.gc_sessions(at=time.time() + 120)
        assert eng.allocator.offload_drain(10.0)
        with eng._session_lock:
            assert eng.allocator.host_pages == 2
            held = eng.allocator.alloc(eng.allocator.free_pages - 3)
        samp = JaxSampling if mod is jax_engine else SamplingParams
        cand = mod.Request(id="b", prompt=t1 + out1 + _prompt(51, 3),
                           sampling=samp(max_new_tokens=4))
        starved = eng._cand_starved(cand)
        with eng._session_lock:
            eng.allocator.free(held)
        return {"starved": starved, "obs": _observe(eng)}

    t = _both(engines, script)
    assert t["starved"] is True


@pytest.mark.parametrize("off", ["shared_prefix_cache", "enable_prefix_cache"])
def test_host_tier_requires_shared_prefix_cache(engines, off):
    msgs = []
    for mod in (jax_engine, engine):
        with pytest.raises(ValueError, match="host_cache_bytes") as ei:
            engines(mod, **(ECFG | {off: False}))
        msgs.append(str(ei.value))
    assert msgs[1] == msgs[0]


def test_default_engine_has_no_offload_machinery(engines):
    def script(make, mod):
        eng = make(host_cache_bytes=0)
        _run(eng, "a", _prompt(90, 16), session="s")
        eng.gc_sessions(at=time.time() + 120)
        assert eng.allocator._offload_thread is None
        return {"obs": _observe(eng),
                "gauge": eng.prefix_cache_stats()["kv_offload_host_pages"]}

    t = _both(engines, script)
    assert t["obs"]["host_pages"] == 0 and t["gauge"] == 0
    assert t["obs"]["counters"]["kv_offload_demoted"] == 0
    assert t["obs"]["counters"]["kv_offload_restored"] == 0


# ---------------------------------------------------------------------------
# quantized pools: raw bytes and scales round-trip


def _port_payload(p) -> list[np.ndarray]:
    return [t.numpy().copy() for t in p.leaves]


def _jax_payload(p) -> list[np.ndarray]:
    out = []
    for pool in p:  # (k, v), each QuantPages(q, scale)
        for leaf in pool:
            a = np.asarray(leaf)
            out.append(a.view(np.uint8) if a.dtype.itemsize == 1 and a.dtype != np.int8 else a)
    return out


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_pages_round_trip_bit_for_bit(engines, mode):
    """A quantized session demotes and restores: every restored page's
    values and scales equal its bytes at capture bit for bit, the resumed
    tokens equal the no-tier engine's, and the port's host payloads hold
    the JAX engine's values bit for bit (scales to 2e-6 relative: the K/V
    of two frameworks' float32 matmuls round apart)."""
    cfg = ECFG | {"kv_quant_dtype": mode}
    t1 = _prompt(70, 16)

    def demote(mod):
        eng = engines(mod, **cfg)
        out1 = _run(eng, "a", t1, session="q")
        eng.gc_sessions(at=time.time() + 120)
        assert eng.allocator.offload_drain(10.0)
        return eng, out1

    jeng, jout = demote(jax_engine)
    teng, tout = demote(engine)
    assert tout == jout
    with teng._session_lock:
        chains = list(teng.allocator._host)
        assert chains and chains == list(jeng.allocator._host)
        port = {c: _port_payload(teng.allocator._host[c]) for c in chains}
    jpay = {c: _jax_payload(jeng.allocator._host[c]) for c in chains}
    for c in chains:
        for i, (a, b) in enumerate(zip(port[c], jpay[c])):
            if i % 2 == 0:  # values
                assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), (mode, i)
            else:  # f32 scales: the two frameworks' K/V differ in rounding
                np.testing.assert_allclose(a, b, rtol=2e-6, atol=0)
    # restore: each page's bytes come back bit for bit, matched by chain
    restored: dict[bytes, list[torch.Tensor]] = {}
    orig = teng.allocator._commit_restores

    def spy(pending):
        ok = orig(pending)
        for rec, page, _ in pending:
            restored[rec.chain] = [bits(t)[:, page].clone() for t in teng.cache.leaves()]
        return ok

    teng.allocator._commit_restores = spy
    t2 = t1 + tout + _prompt(71, 3)
    out2 = _run(teng, "b", t2, session="q")
    assert sorted(restored) == sorted(chains)
    for c in chains:
        for got, want in zip(restored[c], port[c]):
            assert np.array_equal(got.numpy().view(np.uint8), want.view(np.uint8))
    assert out2 == _run(engines(engine, **(NO_TIER | {"kv_quant_dtype": mode})), "b", t2)
    assert teng.stats["kv_offload_restored"] == len(chains)


def test_host_store_reuses_slots_after_release():
    """The host store carves page slots from slabs: a dropped payload's slot
    is handed out again (no new slab), with the leaves' dtypes and shapes
    of the pool's page."""
    leaves = [torch.zeros(2, 5, 3, 4, 8, dtype=torch.bfloat16), torch.zeros(2, 5, 3, 4)]
    store = engine._HostPageStore(leaves, pin=False)
    a = store.take()
    assert [t.shape for t in a.leaves] == [(2, 3, 4, 8), (2, 3, 4)]
    assert [t.dtype for t in a.leaves] == [torch.bfloat16, torch.float32]
    slabs = store.host_bytes
    held = [store.take() for _ in range(engine._HostPageStore.SLAB_PAGES - 1)]
    assert store.host_bytes == slabs  # one slab serves SLAB_PAGES pages
    del a
    b = store.take()
    assert store.host_bytes == slabs  # the dropped slot came back
    del held, b


def test_smoke_tier_phase_rehearses_on_cpu(weights):
    """``chip_smoke.phase_tier`` end to end on the CPU at a small size
    (llama-tiny, two 48-token sessions over an 11-page pool): every restored
    leaf bit-equal to its capture, no failed restore, the resumed turns'
    tokens equal to the HBM-resident engine's, pages balanced, in plain and
    int8 pools; the engine's own expiry path restores as many pages."""
    import chip_smoke

    results = {}
    chip_smoke.phase_tier(results, {"params": weights[2], "cfg": get_config("llama-tiny")}, 0,
                          device="cpu", sessions=2, prompt_len=48, max_new=4, turn2_new=4,
                          churn=(48,), num_pages=12, host_bytes=1 << 26, modes=("none", "int8"))
    for mode in ("none", "int8"):
        row = results["tier"][mode]
        assert row["restore_fail"] == 0 and row["restored_pages"] >= 2 * 3
        assert row["leaves_checked"] > 0 and not row["leaf_mismatches"]
        assert row["resumed_equal_hbm_hit"] == 2 and row["free_pages_end"] == 11
        own = row["own_path"]  # expiry alone: these sessions fit the demote queue
        assert own["restore_fail"] == 0 and own["leaves_checked"] > 0
        assert [r for r, _ in own["restored_prefilled_per_turn"]] == [
            r for r, _ in row["restored_prefilled_per_turn"]]
    assert results["tier"]["int8"]["page_bytes"] < results["tier"]["none"]["page_bytes"]


def test_no_offload_thread_outlives_the_file():
    """Runs last in this file: every engine and pool above closed its
    worker."""
    time.sleep(0.01)
    left = [t for t in threading.enumerate() if t.name == "kv-offload" and t.is_alive()]
    assert not left, left
