"""The port's continuous-batching engine against the JAX package's on one
request script, on the CPU, with the same carried weights (llama-tiny,
float32).

The script has a burst larger than ``max_batch`` (admission waits for
slots), a prompt longer than ``prefill_chunk`` (chunked suffix prefill), a
second turn on a session (suffix prefill over the session's pages) and a
request that shares a full page with an earlier prompt (shared-prefix index
hit). Both engines set ``prefill_chunk=16`` explicitly: the JAX engine on
its plain path does not resolve it, and the port's automatic value would be
this config's whole 64-token context.

Both engines run the same ``kv_quant_dtype`` ("none", "int8" or "fp8").
Greedy tokens must be identical, logprobs within ``LP_TOL[mode]``, the
prefix-cache and ``kv_quant_*`` gauges and counters identical, and no page
may stay referenced once the sessions are dropped.

``LP_TOL["none"]`` = 1e-4: float32 math in another order. Quantized pools
add one step: the two frameworks compute K and V in float32 in another
order, ~1e-7 apart, and where an element sits within that of a rounding
boundary of ``x / scale`` the two pools store neighbouring codes, one
quantization step (1/127 of the slot's max |x| in int8; 2^-3 of the
element in fp8) apart. Such an element moves one logit by at most a step
times |q_d| / sqrt(hd), and that shift then passes through the later
layers: 2e-3 allows a few such flips in a run, and stays 25x inside the
JAX package's own on/off drift pin of 0.05."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest

from agentfield_tpu.models import configs as jax_configs
from agentfield_tpu.models import llama as jax_llama
from agentfield_tpu.serving import engine as jax_engine
from agentfield_tpu.serving.sampler import SamplingParams as JaxSampling
from agentfield_tpu_torch.models.configs import get_config
from agentfield_tpu_torch.models.convert import params_from_numpy
from agentfield_tpu_torch.serving import engine
from agentfield_tpu_torch.serving.sampler import SamplingParams

ECFG = dict(max_batch=4, page_size=8, num_pages=64, max_pages_per_seq=8, prefill_chunk=16)
LP_TOL = {"none": 1e-4, "int8": 2e-3, "fp8": 2e-3}
KV_MODES = list(LP_TOL)
PREFIX_COUNTERS = (
    "prefix_cache_hits", "prefix_tokens_reused", "prefix_index_hits", "prefix_index_misses",
    "prefix_cow_copies", "prefix_pages_unpublished", "prefix_batch_deferrals",
    "prefix_pages_published", "prefix_pages_reused", "prefix_pages_evicted",
    "sessions_evicted", "requests_finished", "prefill_tokens",
    "kv_quant_pages_total", "kv_quant_bytes_saved_total",
)


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jax_configs.get_config("llama-tiny"), dtype="float32")
    tree = jax.tree.map(np.asarray, jax_llama.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tree, params_from_numpy(tree, get_config("llama-tiny"), device="cpu")


def _script():
    """Two waves of (id, prompt, max_new, session_id)."""
    rng = np.random.default_rng(0)
    toks = lambda n: rng.integers(1, 512, n).tolist()  # noqa: E731
    shared = toks(16)  # two full pages another request will publish
    wave1 = [
        ("r0", toks(6), 6, "s0"),  # r0, r3, r4: one batched prefill
        ("r3", toks(11), 7, None),
        ("r4", toks(3), 9, None),
        ("r1", shared + toks(5), 8, None),  # > prefill_chunk: chunked prefill
        ("r2", toks(30), 5, None),
        ("r5", toks(14), 4, None),  # burst of 6 > max_batch 4
    ]
    wave2 = [
        ("r6", shared + toks(9), 6, None),  # shared-prefix index hit
    ]
    return wave1, wave2, rng


def _drive(eng, reqs, make):
    out: dict[str, list[tuple[int, float]]] = {rid: [] for rid, *_ in reqs}
    for rid, prompt, max_new, sid in reqs:
        eng.submit(make(rid, prompt, max_new, sid))
    while eng.has_work():
        for ev in eng.step():
            out[ev.request_id].append((ev.token, ev.logprob))
    return out


def _run(eng, req_cls, samp_cls):
    def make(rid, prompt, max_new, sid):
        return req_cls(id=rid, prompt=prompt, sampling=samp_cls(max_new_tokens=max_new), session_id=sid)

    wave1, wave2, rng = _script()
    res = _drive(eng, wave1, make)
    # second turn of s0: its first turn + answer + new user tokens
    turn2 = wave1[0][1] + [t for t, _ in res["r0"]] + rng.integers(1, 512, 5).tolist()
    res.update(_drive(eng, wave2 + [("r7", turn2, 5, "s0")], make))
    return res


@pytest.mark.parametrize("mode", KV_MODES)
def test_engine_matches_jax_engine(weights, mode):
    jcfg, tree, params = weights
    ecfg = dict(ECFG, kv_quant_dtype=mode)
    jeng = jax_engine.InferenceEngine(tree, jcfg, jax_engine.EngineConfig(**ecfg))
    want = _run(jeng, jax_engine.Request, JaxSampling)
    teng = engine.InferenceEngine(params, get_config("llama-tiny"), engine.EngineConfig(**ecfg))
    got = _run(teng, engine.Request, SamplingParams)

    assert set(got) == set(want)
    for rid in want:
        assert [t for t, _ in got[rid]] == [t for t, _ in want[rid]], rid
        np.testing.assert_allclose(
            [lp for _, lp in got[rid]], [lp for _, lp in want[rid]], atol=LP_TOL[mode], rtol=0,
            err_msg=rid,
        )
    # the script reached every path it is meant to
    assert teng.stats["prefix_cache_hits"] >= 1  # session turn 2
    assert teng.stats["prefix_index_hits"] >= 1  # shared prefix
    assert teng.stats["prefill_batches"] >= 1  # batched fresh prefill
    assert (teng.stats["kv_quant_pages_total"] > 0) == (mode != "none")
    assert teng.kv_page_bytes == jeng.kv_page_bytes

    jstats = jeng.prefix_cache_stats()
    for k, v in teng.prefix_cache_stats().items():
        assert v == jstats[k], k
    for k in PREFIX_COUNTERS + ("decode_steps",):
        assert teng.stats[k] == jeng.stats[k], k

    # no leaks: dropping the sessions returns every page
    for sid in ("s0",):
        assert teng.free_session(sid)
    pool = teng.allocator
    assert all(pool.refcount(p) == 0 for p in range(pool.num_pages))
    assert pool.free_pages == ECFG["num_pages"] - 1
    assert teng.num_active == 0 and not teng.pending


def test_engine_matches_jax_engine_with_node_defaults(weights):
    """The same script under the model node's engine defaults (a grammar
    bank of 256 rows, the pipelined tick) plus decode buckets, on both
    engines: the same tokens, logprobs and counters, ``decode_steps``
    included."""
    jcfg, tree, params = weights
    ecfg = dict(ECFG, grammar_slots=256, decode_buckets=(2,))
    assert engine.EngineConfig().async_decode and jax_engine.EngineConfig().async_decode
    jeng = jax_engine.InferenceEngine(tree, jcfg, jax_engine.EngineConfig(**ecfg))
    want = _run(jeng, jax_engine.Request, JaxSampling)
    teng = engine.InferenceEngine(params, get_config("llama-tiny"), engine.EngineConfig(**ecfg))
    got = _run(teng, engine.Request, SamplingParams)
    for rid in want:
        assert [t for t, _ in got[rid]] == [t for t, _ in want[rid]], rid
        np.testing.assert_allclose(
            [lp for _, lp in got[rid]], [lp for _, lp in want[rid]], atol=LP_TOL["none"], rtol=0,
            err_msg=rid,
        )
    for k in PREFIX_COUNTERS + ("decode_steps", "decode_tokens"):
        assert teng.stats[k] == jeng.stats[k], k
    assert teng.grammar_bank_stats() == jeng.grammar_bank_stats()


def test_engine_rejects_fields_it_does_not_implement():
    # the JAX engine's implementation switches are accepted under their
    # names (one path each in the port: the hand-written kernel on the card,
    # its plain version on the CPU); what the port does not implement is
    # refused: the removed kv_write_impl with the JAX words, ring prefill
    # naming its ROADMAP item (tests/test_torch_cli.py holds every value
    # against the JAX engine)
    with pytest.raises(ValueError, match="kv_write_impl='pallas' was removed"):
        engine.resolve_impls(engine.EngineConfig(kv_write_impl="pallas"))
    with pytest.raises(NotImplementedError, match="ROADMAP A5: ring attention"):
        engine.resolve_impls(engine.EngineConfig(prefill_impl="ring"))
    assert engine.resolve_impls(engine.EngineConfig(attn_impl="pallas")).chunk_attn_impl == "pallas"
    fields = {f.name for f in dataclasses.fields(engine.EngineConfig)}
    jax_fields = {f.name for f in dataclasses.fields(jax_engine.EngineConfig)}
    assert fields == jax_fields
    for f in ("prefix_sketch_bytes", "spec_prefill", "spec_pin_ttl", "spec_pin_budget",
              "spec_max_candidates", "attn_impl", "prefill_impl", "chunk_attn_impl",
              "kv_write_impl", "compile_cache_dir"):  # the JAX defaults
        assert getattr(engine.EngineConfig(), f) == getattr(jax_engine.EngineConfig(), f), f


def test_engine_admission_errors(weights):
    _, _, params = weights
    eng = engine.InferenceEngine(
        params, get_config("llama-tiny"), engine.EngineConfig(**dict(ECFG, max_pending=1))
    )
    assert eng.ecfg.prefill_chunk == 16
    with pytest.raises(engine.RequestTooLongError):
        eng.submit(engine.Request("long", [1] * 60, SamplingParams(max_new_tokens=10)))
    with pytest.raises(ValueError):
        eng.submit(engine.Request("empty", []))
    eng.submit(engine.Request("a", [1, 2, 3], SamplingParams(max_new_tokens=4)))
    with pytest.raises(engine.QueueFullError):
        eng.submit(engine.Request("b", [1, 2, 3], SamplingParams(max_new_tokens=4)))
    auto = engine.InferenceEngine(
        params, get_config("llama-tiny"), engine.EngineConfig(**dict(ECFG, prefill_chunk=None))
    )
    assert auto.ecfg.prefill_chunk == 64  # min(512, max_context)


def test_decode_span_keeps_tokens(weights):
    """Several decode steps per dispatch give the same greedy tokens."""
    _, _, params = weights
    cfg = get_config("llama-tiny")
    reqs = [engine.Request(f"q{i}", list(range(3 + i, 12 + 2 * i)), SamplingParams(max_new_tokens=7))
            for i in range(3)]
    one = engine.InferenceEngine(params, cfg, engine.EngineConfig(**ECFG)).run_to_completion(reqs)
    span = engine.InferenceEngine(
        params, cfg, engine.EngineConfig(**dict(ECFG, decode_span=3))
    ).run_to_completion(reqs)
    assert span == one and all(len(v) == 7 for v in one.values())


@pytest.mark.parametrize("mode", KV_MODES)
def test_engine_retry_and_copy_on_write_match_jax(weights, mode):
    """A session's fully resident prompt sent again (a retry) re-prefills
    its last token; when another request holds that page through the
    shared-prefix index, the engine copies it first (copy-on-write: values
    and, for a quantized pool, scales)."""
    jcfg, tree, params = weights
    rng = np.random.default_rng(5)
    p = rng.integers(1, 512, 16).tolist()
    waves = [
        [("a0", p, 8, "s1")],
        # x hits the index on p's two pages and holds them while the
        # retry of s1 re-writes slot 15 of the second one
        [("x", p + [3], 10, None), ("a1", list(p), 4, "s1")],
    ]

    def run(eng, req_cls, samp_cls):
        res = {}
        for wave in waves:
            res.update(_drive(eng, wave, lambda rid, pr, n, sid: req_cls(
                id=rid, prompt=pr, sampling=samp_cls(max_new_tokens=n), session_id=sid)))
        return res

    ecfg = dict(ECFG, kv_quant_dtype=mode)
    jeng = jax_engine.InferenceEngine(tree, jcfg, jax_engine.EngineConfig(**ecfg))
    want = run(jeng, jax_engine.Request, JaxSampling)
    teng = engine.InferenceEngine(params, get_config("llama-tiny"), engine.EngineConfig(**ecfg))
    got = run(teng, engine.Request, SamplingParams)
    for rid in want:
        assert [t for t, _ in got[rid]] == [t for t, _ in want[rid]], rid
        np.testing.assert_allclose(
            [lp for _, lp in got[rid]], [lp for _, lp in want[rid]], atol=LP_TOL[mode], rtol=0,
            err_msg=rid,
        )
    assert teng.stats["prefix_cow_copies"] >= 1
    for k in PREFIX_COUNTERS + ("admission_reorders",):
        assert teng.stats[k] == jeng.stats[k], k
    assert teng.prefix_cache_stats() == {
        k: v for k, v in jeng.prefix_cache_stats().items() if k in teng.prefix_cache_stats()
    }
