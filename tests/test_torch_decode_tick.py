"""The port's decode tick against the JAX engine's, on the CPU, with the same
carried weights (llama-tiny, float32): the one-deep pipeline
(``async_decode``), decode buckets (``decode_buckets``, compact control
state) and the chained device state. Greedy tokens must be identical,
logprobs within ``LP_TOL`` (float32 math in another order), and the prefix
counters and ``decode_steps`` equal, on a script that fills the batch,
drains it through the bucket widths and returns to full width, with a
session's second turn."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from agentfield_tpu.models import configs as jax_configs
from agentfield_tpu.models import llama as jax_llama
from agentfield_tpu.serving import engine as jax_engine
from agentfield_tpu.serving.sampler import SamplingParams as JaxSampling
from agentfield_tpu_torch.models.configs import get_config
from agentfield_tpu_torch.models.convert import params_from_numpy
from agentfield_tpu_torch.serving import engine
from agentfield_tpu_torch.serving.sampler import SamplingParams

BASE = dict(max_batch=8, page_size=8, num_pages=128, max_pages_per_seq=8, prefill_chunk=16)
LP_TOL = 1e-4
COUNTERS = (
    "decode_steps", "decode_tokens", "requests_finished", "prefill_tokens", "prefill_batches",
    "prefix_cache_hits", "prefix_tokens_reused", "prefix_index_hits", "prefix_index_misses",
    "prefix_cow_copies", "prefix_pages_unpublished", "prefix_batch_deferrals",
    "prefix_pages_published", "prefix_pages_reused", "sessions_evicted",
)


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jax_configs.get_config("llama-tiny"), dtype="float32")
    tree = jax.tree.map(np.asarray, jax_llama.init_params(jcfg, jax.random.PRNGKey(2)))
    return jcfg, tree, params_from_numpy(tree, get_config("llama-tiny"), device="cpu")


def _waves():
    """(id, prompt, max_new, session) per wave: 7 requests finishing at
    different steps (full width, then 4 and 2 active), then a session turn
    beside a shared-prefix request."""
    rng = np.random.default_rng(3)
    toks = lambda n: rng.integers(1, 512, n).tolist()  # noqa: E731
    shared = toks(8)
    wave1 = [(f"a{i}", toks(3 + 2 * i), 2 + 3 * i, "s0" if i == 0 else None) for i in range(6)]
    wave1.append(("a6", shared + toks(4), 5, None))
    return wave1, [("b0", shared + toks(6), 4, None)], rng


def _drive(eng, reqs, req_cls, samp_cls):
    out = {rid: [] for rid, *_ in reqs}
    for rid, prompt, n, sid in reqs:
        eng.submit(req_cls(id=rid, prompt=prompt, sampling=samp_cls(max_new_tokens=n),
                           session_id=sid))
    while eng.has_work():
        for ev in eng.step():
            out[ev.request_id].append((ev.token, ev.logprob))
    return out


def _run(eng, req_cls, samp_cls):
    wave1, wave2, rng = _waves()
    res = _drive(eng, wave1, req_cls, samp_cls)
    turn2 = wave1[0][1] + [t for t, _ in res["a0"]] + rng.integers(1, 512, 3).tolist()
    res.update(_drive(eng, wave2 + [("a0b", turn2, 5, "s0")], req_cls, samp_cls))
    return res


def _assert_same(got, want, teng, jeng):
    assert set(got) == set(want)
    for rid in want:
        assert [t for t, _ in got[rid]] == [t for t, _ in want[rid]], rid
        np.testing.assert_allclose([lp for _, lp in got[rid]], [lp for _, lp in want[rid]],
                                   atol=LP_TOL, rtol=0, err_msg=rid)
    for k in COUNTERS:
        assert teng.stats[k] == jeng.stats[k], k


@pytest.mark.parametrize("buckets", [None, (2, 4)], ids=["full", "buckets"])
@pytest.mark.parametrize("async_decode", [True, False], ids=["async", "sync"])
def test_decode_tick_matches_jax(weights, async_decode, buckets):
    jcfg, tree, params = weights
    ecfg = dict(BASE, async_decode=async_decode, decode_buckets=buckets)
    jeng = jax_engine.InferenceEngine(tree, jcfg, jax_engine.EngineConfig(**ecfg))
    want = _run(jeng, jax_engine.Request, JaxSampling)
    teng = engine.InferenceEngine(params, get_config("llama-tiny"), engine.EngineConfig(**ecfg))
    got = _run(teng, engine.Request, SamplingParams)
    _assert_same(got, want, teng, jeng)
    assert teng.stats["prefix_cache_hits"] >= 1 and teng.stats["prefix_index_hits"] >= 1
    if buckets:  # the script decoded at every width
        assert set(teng._states) == {2, 4, 8}
    assert teng.num_active == 0 and teng._inflight is None and not teng.has_work()
    assert teng.free_session("s0")
    assert teng.allocator.free_pages == BASE["num_pages"] - 1


def test_bucket_selection(weights):
    _, _, params = weights
    cfg = get_config("llama-tiny")
    eng = engine.InferenceEngine(params, cfg, engine.EngineConfig(**dict(BASE, decode_buckets=(2, 4))))
    assert [eng._pick_decode_bucket(n) for n in (1, 2, 3, 4, 5)] == [2, 2, 4, 4, None]
    assert engine.InferenceEngine(params, cfg, engine.EngineConfig(**BASE))._pick_decode_bucket(1) is None
    # a bucket as wide as the batch is never taken
    wide = engine.InferenceEngine(
        params, cfg, engine.EngineConfig(**dict(BASE, max_batch=4, decode_buckets=(4,))))
    assert wide._pick_decode_bucket(2) is None


def test_transition_between_bucket_and_full_matches_jax(weights):
    """Four slots at full width finish one by one, so the batch drops to the
    compact width mid-run; then a new request brings it back to full width
    (the full-width state is rebuilt from the host shadows)."""
    jcfg, tree, params = weights
    ecfg = dict(BASE, max_batch=4, decode_buckets=(2,))
    rng = np.random.default_rng(11)
    reqs = [(f"r{i}", rng.integers(1, 512, 4).tolist(), 3 + 2 * i, None) for i in range(4)]
    late = [(f"l{i}", rng.integers(1, 512, 5).tolist(), 6, None) for i in range(3)]

    def run(eng, req_cls, samp_cls):
        res = _drive(eng, reqs, req_cls, samp_cls)
        res.update(_drive(eng, late, req_cls, samp_cls))
        return res

    jeng = jax_engine.InferenceEngine(tree, jcfg, jax_engine.EngineConfig(**ecfg))
    want = run(jeng, jax_engine.Request, JaxSampling)
    teng = engine.InferenceEngine(params, get_config("llama-tiny"), engine.EngineConfig(**ecfg))
    got = run(teng, engine.Request, SamplingParams)
    _assert_same(got, want, teng, jeng)


def test_pipeline_keeps_one_step_in_flight(weights):
    """With ``async_decode`` the first decode tick dispatches and returns no
    token; ``has_work`` holds while that step is in flight, and the next
    tick returns its tokens."""
    _, _, params = weights
    eng = engine.InferenceEngine(params, get_config("llama-tiny"), engine.EngineConfig(**BASE))
    eng.submit(engine.Request("x", [5, 6, 7], SamplingParams(max_new_tokens=3)))
    assert [e.index for e in eng.step()] == [0]  # admission: the first token
    assert eng.step() == [] and eng._inflight is not None  # dispatched, not read
    assert eng.has_work()
    assert [e.index for e in eng.step()] == [1]
    last = eng.step()
    assert [(e.index, e.finished) for e in last] == [(2, True)]
    assert eng.num_active == 0 and eng._inflight is not None  # a discarded extra step
    assert eng.has_work() and eng.step() == [] and not eng.has_work()


def test_sampled_steps_chain_on_the_device(weights):
    """Sampled rows at temperature > 0 decode through the chained state:
    each step draws fresh numbers (a run does not repeat one draw), and the
    engine's generator seed fixes the tokens."""
    _, _, params = weights
    cfg = get_config("llama-tiny")

    def run(seed):
        eng = engine.InferenceEngine(params, cfg, engine.EngineConfig(**BASE), seed=seed)
        samp = SamplingParams(temperature=1.5, top_p=0.95, max_new_tokens=12)
        return eng.run_to_completion([engine.Request(f"s{i}", [3, 4, 5], samp) for i in range(4)])

    a, b = run(0), run(0)
    assert a == b
    assert len({tuple(v) for v in a.values()}) > 1  # same prompt, different draws
    assert any(len(set(v)) > 1 for v in a.values())
    assert run(1) != a


def test_decode_step_writes_its_state_in_place(weights):
    """The step a CUDA graph captures reads and writes only its
    ``DecodeState`` buffers: their storage never moves, lengths advance on
    active rows only, the next tokens are the step's outputs."""
    _, _, params = weights
    eng = engine.InferenceEngine(params, get_config("llama-tiny"),
                                 engine.EngineConfig(**dict(BASE, decode_span=2)))
    for i in range(3):
        eng.submit(engine.Request(f"q{i}", [7 + i, 8, 9], SamplingParams(max_new_tokens=6)))
    eng.step()  # one batched admission
    st = eng._dev_state()
    ptrs = {n: getattr(st, n).data_ptr() for n in st.INPUTS + ("out_tokens", "out_logprobs")}
    lens0 = st.seq_lens.clone()
    eng._decode_step(st, "greedy", False)
    assert {n: getattr(st, n).data_ptr() for n in ptrs} == ptrs
    assert torch.equal(st.seq_lens, lens0 + 2 * (lens0 > 0).int())
    assert torch.equal(st.tokens, st.out_tokens[-1].long())


@pytest.mark.parametrize("family", ["gemma-tiny", "llama-tiny+window"])
def test_decode_tick_other_families_match_jax(family):
    """The pipelined, bucketed tick on a gemma-family config (tied and
    scaled embeddings, gelu) and on a sliding window that binds inside the
    context (chunked prefill and decode over windowed pages)."""
    name = family.split("+")[0]
    jcfg = dataclasses.replace(jax_configs.get_config(name), dtype="float32")
    cfg = dataclasses.replace(get_config(name), dtype="float32")
    if family.endswith("+window"):
        jcfg = dataclasses.replace(jcfg, sliding_window=24)
        cfg = dataclasses.replace(cfg, sliding_window=24)
    tree = jax.tree.map(np.asarray, jax_llama.init_params(jcfg, jax.random.PRNGKey(4)))
    params = params_from_numpy(tree, cfg, device="cpu")
    ecfg = dict(BASE, decode_buckets=(2, 4))
    rng = np.random.default_rng(5)
    reqs = [(f"w{i}", rng.integers(1, 256, n).tolist(), m, None)
            for i, (n, m) in enumerate([(40, 12), (5, 9), (20, 6), (9, 3)])]
    jeng = jax_engine.InferenceEngine(tree, jcfg, jax_engine.EngineConfig(**ecfg))
    want = _drive(jeng, reqs, jax_engine.Request, JaxSampling)
    teng = engine.InferenceEngine(params, cfg, engine.EngineConfig(**ecfg))
    got = _drive(teng, reqs, engine.Request, SamplingParams)
    _assert_same(got, want, teng, jeng)
    assert teng.window == (24 if family.endswith("+window") else None)
