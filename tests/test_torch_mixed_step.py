"""The port's mixed token-budget tick against the JAX engine's, on the CPU,
with the same carried weights (llama-tiny, float32): the submission scripts
of ``tests/test_mixed_step.py`` run through both engines, and each must give
the same greedy tokens, the same finish reasons, the same new counters
(``MIXED_KEYS``) and the same ``free_pages`` at the end; the port's mixed
tokens must also equal its own classic tick's. Plus the W=1 mixed descriptor
through the plain ragged attention against the JAX Pallas kernel in
interpret mode (tolerance of the JAX ``test_kernel_w1_rows_parity``, pools
bit-equal), the configuration checks and ``scheduler_stats``."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentfield_tpu.models import configs as jax_configs
from agentfield_tpu.models import llama as jax_llama
from agentfield_tpu.ops.pallas.ragged_paged_attention_kernel import (
    ragged_paged_attention_pallas,
)
from agentfield_tpu.serving import engine as jax_engine
from agentfield_tpu.serving.sampler import SamplingParams as JaxSampling
from agentfield_tpu_torch.models.configs import get_config
from agentfield_tpu_torch.models.convert import params_from_numpy
from agentfield_tpu_torch.ops.paged_attention import ragged_paged_attention_ref
from agentfield_tpu_torch.serving import engine
from agentfield_tpu_torch.serving.kv_cache import pack_ragged_rows
from agentfield_tpu_torch.serving.sampler import SamplingParams

# the JAX test's geometry: ONE budget (20) for every engine here
ECFG = dict(max_batch=4, page_size=8, num_pages=128, max_pages_per_seq=8,
            mixed_step=True, mixed_step_budget=20)
CLASSIC = dict(ECFG, mixed_step=False)
MIXED_KEYS = (
    "mixed_ticks", "mixed_tokens", "decode_steps", "decode_tokens", "prefill_tokens",
    "requests_finished", "requests_cancelled", "cancels_unknown", "prefix_index_hits",
    "prefix_tokens_reused", "prefix_batch_deferrals", "admission_reorders",
    "kv_quant_pages_total",
)
V = 512  # llama-tiny's vocabulary


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jax_configs.get_config("llama-tiny"), dtype="float32")
    tree = jax.tree.map(np.asarray, jax_llama.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tree, params_from_numpy(tree, get_config("llama-tiny"), device="cpu")


def _prompt(seed: int, n: int) -> list[int]:
    return np.random.default_rng(seed).integers(0, V, n).tolist()


def _engines(weights, ecfg: dict):
    jcfg, tree, params = weights
    return (jax_engine.InferenceEngine(tree, jcfg, jax_engine.EngineConfig(**ecfg)),
            engine.InferenceEngine(params, get_config("llama-tiny"), engine.EngineConfig(**ecfg)))


def _req(mod, rid, prompt, max_new, **kw):
    samp = JaxSampling if mod is jax_engine else SamplingParams
    return mod.Request(id=rid, prompt=prompt, sampling=samp(max_new_tokens=max_new), **kw)


def _drive(eng, script, actions=None):
    """Run ``script`` [(at_step, (rid, prompt, max_new, kw))] and the
    ``actions`` {step: callable(engine)}; returns (tokens per id, finish
    reasons per id)."""
    mod = jax_engine if isinstance(eng, jax_engine.InferenceEngine) else engine
    toks: dict[str, list[int]] = {}
    reasons: dict[str, list[str]] = {}
    pending = sorted(script, key=lambda x: x[0])
    step = 0
    while pending or eng.has_work() or (actions and step <= max(actions)):
        while pending and pending[0][0] <= step:
            rid, prompt, n, kw = pending.pop(0)[1]
            eng.submit(_req(mod, rid, prompt, n, **kw))
        if actions and step in actions:
            actions[step](eng)
        for ev in eng.step():
            if ev.token >= 0:
                toks.setdefault(ev.request_id, []).append(ev.token)
            if ev.finished:
                reasons.setdefault(ev.request_id, []).append(ev.finish_reason)
        step += 1
    return toks, reasons


def _same(jeng, jout, teng, tout, keys=MIXED_KEYS):
    assert tout == jout
    for k in keys:
        assert teng.stats.get(k, 0) == jeng.stats.get(k, 0), k
    assert teng.allocator.free_pages == jeng.allocator.free_pages


def _parity(weights, ecfg, script, actions=None):
    jeng, teng = _engines(weights, ecfg)
    jout, tout = _drive(jeng, script, actions), _drive(teng, script, actions)
    _same(jeng, jout, teng, tout)
    return jeng, teng, tout


BURST = [
    (0, ("a0", _prompt(1, 5), 14, {})),
    (0, ("a1", _prompt(2, 9), 14, {})),
    (4, ("b0", _prompt(3, 30), 6, {})),  # 30 > budget 20: chunked over ticks
    (4, ("b1", _prompt(4, 12), 6, {})),
    (4, ("b2", _prompt(5, 23), 6, {})),
]


def test_mixed_burst_matches_jax_and_classic(weights):
    """A burst into in-flight decodes, one prompt longer than the budget:
    the port's mixed tick equals the JAX engine's, and its tokens equal the
    port's classic tick's."""
    _, teng, tout = _parity(weights, ECFG, BURST)
    assert teng.stats["mixed_ticks"] > 0 and teng.stats["mixed_tokens"] > 0
    ceng = engine.InferenceEngine(weights[2], get_config("llama-tiny"),
                                  engine.EngineConfig(**CLASSIC))
    cout = _drive(ceng, BURST)
    assert ceng.stats["mixed_ticks"] == 0
    assert cout == tout
    assert teng.allocator.free_pages == ceng.allocator.free_pages
    assert not teng._prefill_jobs and not teng.has_work()


def test_mixed_prefix_hit_mid_decode(weights):
    shared = _prompt(99, 24)  # 3 full pages at page_size 8
    script = [
        (0, ("seed", shared + _prompt(6, 4), 2, {})),
        (6, ("long", _prompt(7, 6), 16, {})),
        (9, ("hit", shared + _prompt(8, 5), 6, {})),
    ]
    _, teng, _ = _parity(weights, ECFG, script)
    assert teng.stats["prefix_index_hits"] == 1 and teng.stats["mixed_ticks"] > 0


def test_budget_smaller_than_one_prompt(weights):
    script = [(0, ("d", _prompt(9, 4), 20, {})), (2, ("big", _prompt(10, 60), 4, {}))]
    _, teng, _ = _parity(weights, ECFG, script)
    assert teng.stats["mixed_ticks"] >= 4
    assert teng.allocator.free_pages == ECFG["num_pages"] - 1


def test_cancel_mid_prefill_releases_pages(weights):
    """Cancels of a job mid-prompt and of a decoding slot: both engines free
    every page, install nothing, and count two cancels."""
    script = [(0, ("d", _prompt(11, 4), 30, {})), (3, ("big", _prompt(12, 60), 4, {}))]

    def cancel(eng):
        assert eng._prefill_jobs, "the job should be mid-prompt"
        eng.request_cancel("big")
        eng.request_cancel("d")

    _, teng, tout = _parity(weights, ECFG, script, actions={4: cancel})
    assert teng.stats["requests_cancelled"] == 2 and "big" not in tout[0]
    assert not teng._prefill_jobs
    assert teng.allocator.free_pages == ECFG["num_pages"] - 1


def test_defers_same_leading_page(weights):
    shared = _prompt(50, 16)
    script = [
        (0, ("d", _prompt(51, 5), 16, {})),
        (3, ("p0", shared + _prompt(52, 10), 4, {})),
        (3, ("p1", shared + _prompt(53, 7), 4, {})),
    ]
    _, teng, _ = _parity(weights, ECFG, script)
    assert teng.stats["prefix_batch_deferrals"] >= 1 and teng.stats["prefix_index_hits"] >= 1


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_mixed_over_quantized_pages(weights, mode):
    """Chunk rows write several slots of one page per launch, each slot
    quantized with its own scale: the quantized mixed tick equals the JAX
    engine's and the port's quantized classic tick's."""
    script = [(0, ("d", _prompt(90, 5), 12, {})), (3, ("p", _prompt(91, 30), 5, {}))]
    _, teng, tout = _parity(weights, dict(ECFG, kv_quant_dtype=mode), script)
    assert teng.stats["mixed_ticks"] > 0 and teng.stats["kv_quant_pages_total"] > 0
    ceng = engine.InferenceEngine(weights[2], get_config("llama-tiny"),
                                  engine.EngineConfig(**dict(CLASSIC, kv_quant_dtype=mode)))
    assert _drive(ceng, script) == tout


def test_mixed_pauses_while_grammar_active(weights):
    """A grammar request admits through the classic path and, while it
    decodes, no mixed tick runs; afterwards mixed ticks resume."""
    from agentfield_tpu_torch.serving.grammar import compile_json_schema

    vocab = [bytes([i]) for i in range(256)] + [b"\x00"] * (V - 256)
    g = compile_json_schema({"type": "boolean"}, vocab)
    teng = engine.InferenceEngine(weights[2], get_config("llama-tiny"),
                                  engine.EngineConfig(**dict(ECFG, grammar_slots=32)))
    teng.submit(_req(engine, "d", _prompt(70, 5), 12))
    teng.step()
    gr = engine.Request(id="g", prompt=_prompt(71, 6), grammar=g,
                        sampling=SamplingParams(max_new_tokens=4, stop_token_ids=(0,)))
    teng.submit(gr)
    assert not teng._mixed_tick_ready()  # an ineligible head waits for a classic tick
    teng.step()
    assert any(s is not None and s.req.grammar is g for s in teng.slots)
    teng.submit(_req(engine, "p", _prompt(72, 9), 3))
    assert not teng._mixed_tick_ready()
    while teng.has_work():
        teng.step()
    assert teng.allocator.free_pages == ECFG["num_pages"] - 1


def test_config_checks(weights):
    """``mixed_step`` defaults to off; "auto" resolves to on without
    speculative decoding and to off with ``spec_k > 0``, where True is
    refused; a bad value and a budget under max_batch + 16 are refused, as
    in the JAX engine."""
    params, cfg = weights[2], get_config("llama-tiny")
    assert engine.EngineConfig().mixed_step is False
    auto = engine.InferenceEngine(params, cfg, engine.EngineConfig(**dict(ECFG, mixed_step="auto")))
    assert auto.ecfg.mixed_step is True
    spec = dict(ECFG, spec_k=2, mixed_step="auto")
    auto_spec = engine.InferenceEngine(params, cfg, engine.EngineConfig(**spec), draft=(params, cfg))
    jauto = jax_engine.InferenceEngine(weights[1], weights[0], jax_engine.EngineConfig(**spec),
                                       draft=(weights[1], weights[0]))
    assert auto_spec.ecfg.mixed_step is False is jauto.ecfg.mixed_step
    with pytest.raises(ValueError, match="incompatible with spec_k"):
        engine.InferenceEngine(params, cfg, engine.EngineConfig(**dict(spec, mixed_step=True)),
                               draft=(params, cfg))
    with pytest.raises(ValueError, match="mixed_step"):
        engine.InferenceEngine(params, cfg, engine.EngineConfig(**dict(ECFG, mixed_step="always")))
    with pytest.raises(ValueError, match="mixed_step_budget"):
        engine.InferenceEngine(params, cfg, engine.EngineConfig(**dict(ECFG, mixed_step_budget=10)))
    e = engine.EngineConfig(**ECFG)
    j = jax_engine.EngineConfig(**ECFG)
    assert [e.mixed_bucket(n) for n in (1, 16, 17, 20, 40)] == [
        j.mixed_bucket(n) for n in (1, 16, 17, 20, 40)]


def test_scheduler_stats(weights):
    teng = engine.InferenceEngine(weights[2], get_config("llama-tiny"), engine.EngineConfig(**ECFG))
    teng.run_to_completion([_req(engine, f"r{i}", _prompt(20 + i, 5), 6) for i in range(2)])
    sched = teng.scheduler_stats()
    assert set(sched) == {"itl_ms_p50", "itl_ms_p99", "tokens_per_tick"}
    assert sched["itl_ms_p50"] > 0 and sched["itl_ms_p99"] >= sched["itl_ms_p50"]
    assert sched["tokens_per_tick"] > 0


def _mixed_descriptor():
    """The mixed tick's W=1 descriptor at a small size: 5 decode rows at
    ragged contexts (page edges included), chunks of 6 tokens over 9 cached
    and of 4 over none, padding rows to 20."""
    ps, maxp = 8, 6
    entries = [(c, 1) for c in (0, 7, 8, 15, 23)] + [(9, 6), (0, 4)]
    rng = np.random.default_rng(5)
    P = len(entries) * maxp + 1
    tables = (rng.permutation(P - 1) + 1)[: len(entries) * maxp].reshape(len(entries), maxp)
    rr = pack_ragged_rows([(tables[s], st, [1] * n) for s, (st, n) in enumerate(entries)],
                          maxp, budget=20, block_q=1)
    return rr, P, ps


@pytest.mark.parametrize("window", [None, 6])
def test_w1_mixed_descriptor_matches_pallas(window):
    """The W=1 rows of a mixed tick (decode rows, chunk rows sharing a seq_id
    over their cached context, padding) through the port's plain version and
    the JAX kernel in interpret mode: outputs within the JAX test's 2e-3,
    pools bit-equal outside page 0, padding rows zero."""
    rr, P, ps = _mixed_descriptor()
    H, Kh, hd = 4, 2, 32
    R = rr.row_starts.shape[0]
    rng = np.random.default_rng(6)
    q, kn, vn = (rng.standard_normal((R, 1, h, hd)).astype(np.float32) for h in (H, Kh, Kh))
    kp, vp = (rng.standard_normal((P, Kh, ps, hd)).astype(np.float32) for _ in range(2))
    desc = (rr.page_tables, rr.row_starts, rr.n_tokens, rr.ctx_lens, rr.seq_ids)
    out, ok, ov = ragged_paged_attention_pallas(
        *(jnp.asarray(a) for a in (q, kn, vn, kp, vp) + desc), interpret=True, window=window)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    ref, _, _ = ragged_paged_attention_ref(
        *(torch.from_numpy(a) for a in (q, kn, vn)), tk, tv,
        *(torch.from_numpy(a) for a in desc), window=window)
    np.testing.assert_allclose(ref.numpy(), np.asarray(out), rtol=2e-3, atol=2e-3)
    live = rr.n_tokens > 0
    assert np.all(ref.numpy()[~live] == 0.0) and (~live).any()
    np.testing.assert_array_equal(tk.numpy()[1:], np.asarray(ok)[1:])
    np.testing.assert_array_equal(tv.numpy()[1:], np.asarray(ov)[1:])


def test_smoke_holds_the_mixed_launch_at_full_width():
    """``chip_smoke.py`` checks, times and fault-tests the mixed tick's
    launch at Llama-3-8B heads: 512 W=1 rows, 16 decode rows at contexts
    500-2000, chunks of 240 tokens over 1024 cached and of 256 over none;
    the windowed variant runs at phi-3-mini's heads with its window binding;
    both ride the kernel's split-context path (W * rep <= 8)."""
    import chip_smoke

    from agentfield_tpu_torch.models.configs import PRESETS

    shapes = chip_smoke.ragged_shapes()
    p = shapes["llama3_mixed_w1"]
    l3 = PRESETS["llama-3-8b"]
    assert (p["kh"], p["kh"] * p["rep"], p["hd"]) == (l3.num_kv_heads, l3.num_heads, l3.head_dim)
    entries = [(c, 1) for c in p["served"]] + list(p["chunk_list"])
    assert p["W"] == 1 and p["pad_to"] == 512 and sum(n for _, n in entries) == 512
    assert list(p["served"]) == list(range(500, 2001, 100)) and p["chunk_list"] == ((1024, 240), (0, 256))
    rr = pack_ragged_rows([(np.zeros(p["maxp"], np.int32), s, [0] * n) for s, n in entries],
                          p["maxp"], budget=p["pad_to"], block_q=1)
    assert rr.row_starts.shape == (512,) and len(set(rr.seq_ids.tolist())) == 18
    w = shapes["phi-3-mini_mixed_w1+window"]
    phi = PRESETS["phi-3-mini"]
    assert (w["kh"], w["hd"], w["window"]) == (phi.num_kv_heads, phi.head_dim, phi.sliding_window)
    assert max(w["served"]) > w["window"] and w["W"] * w["rep"] <= 8 >= p["W"] * p["rep"]
    assert "llama3_mixed_w1" in chip_smoke.FAULT_SHAPES
    assert {f"llama3_mixed_w1_{m}" for m in chip_smoke.QUANT_MODES} <= set(chip_smoke.quant_shapes())
