"""The port's sampler against the JAX package's.

Greedy rows are argmax in both and must match token for token. Sampled rows
cannot: JAX draws threefry bits, the port a ``torch.Generator``'s Philox
stream. They are held instead to the analytic distribution each strategy
defines (tempered softmax, top-k inside the ``k_max`` prefilter, top-p
nucleus, and the exact full-vocab nucleus when it is wider than ``k_max``):
every draw lies in that distribution's support, and the empirical frequency
of N draws over its K tokens is within total-variation distance
``sqrt(K / N)`` of it — twice the bound ``0.5 * sqrt(K / N)`` on the
expected TV of N exact draws."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentfield_tpu.serving import sampler as jax_sampler
from agentfield_tpu_torch.serving.sampler import SamplingParams, sample_tokens

N = 40_000


def _softmax(x):
    e = np.exp(x - x.max())
    return e / e.sum()


def _truncated(logits: np.ndarray, temp: float, top_k: int, top_p: float, k_max: int = 64):
    """The distribution one row samples from (float64, numpy)."""
    V = logits.shape[0]
    k_max = min(k_max, V)
    order = np.argsort(-logits, kind="stable")
    if top_k == 0 and top_p >= 1.0:
        return _softmax(logits / temp)
    scaled = logits[order] / temp
    full_p = _softmax(scaled)
    if top_k == 0 and full_p[:k_max].sum() < top_p:  # exact wide nucleus
        keep = (np.cumsum(full_p) - full_p) < top_p
    else:
        k_eff = min(top_k, k_max) if top_k > 0 else k_max
        p = _softmax(scaled[:k_eff])
        keep = np.zeros(V, bool)
        keep[:k_eff] = (np.cumsum(p) - p) < top_p
    out = np.zeros(V)
    out[order[keep]] = _softmax(scaled[keep])
    return out


def _draw(logits: np.ndarray, temp: float, top_k: int, top_p: float, seed: int = 0):
    g = torch.Generator()
    g.manual_seed(seed)
    x = torch.from_numpy(np.broadcast_to(logits, (N, logits.shape[0])).copy())
    toks = sample_tokens(
        x, g, torch.full((N,), temp), torch.full((N,), top_k, dtype=torch.int32),
        torch.full((N,), top_p),
    )
    assert toks.dtype == torch.int32
    return np.bincount(toks.numpy(), minlength=logits.shape[0]) / N


CASES = {
    "tempered": (32, 1.0, 0.7, 0, 1.0),
    "top_k": (32, 1.0, 1.0, 5, 1.0),
    "top_p": (32, 1.0, 1.3, 0, 0.6),
    "top_k_and_p": (32, 1.0, 1.0, 10, 0.5),
    "k_over_k_max": (100, 2.0, 1.0, 80, 1.0),
    "wide_nucleus": (200, 0.1, 1.0, 0, 0.9),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sampled_frequencies_match_truncated_distribution(case):
    V, scale, temp, top_k, top_p = CASES[case]
    logits = (np.random.default_rng(V).standard_normal(V) * scale).astype(np.float32)
    want = _truncated(logits.astype(np.float64), temp, top_k, top_p)
    if case == "wide_nucleus":
        assert (want > 0).sum() > 64  # the exact fallback path really runs
    got = _draw(logits, temp, top_k, top_p)
    support = want > 0
    assert got[~support].sum() == 0, "a token outside the distribution's support was drawn"
    K = int(support.sum())
    tv = 0.5 * np.abs(got - want).sum()
    assert tv <= np.sqrt(K / N), (tv, K)


def test_greedy_matches_jax_exactly():
    rng = np.random.default_rng(0)
    B, V = 9, 512
    logits = rng.standard_normal((B, V)).astype(np.float32)
    temps = np.array([0, 0, 0.8, 0, 1.0, 0, 0, 0.5, 0], np.float32)
    top_ks = np.array([0, 5, 0, 3, 0, 0, 40, 0, 1], np.int32)
    top_ps = np.array([1, 1, 0.9, 0.5, 1, 0.3, 1, 1, 1], np.float32)
    want = np.asarray(jax_sampler.sample_tokens(
        jnp.asarray(logits), jax.random.PRNGKey(0), jnp.asarray(temps),
        jnp.asarray(top_ks), jnp.asarray(top_ps),
    ))
    g = torch.Generator()
    g.manual_seed(0)
    got = sample_tokens(
        torch.from_numpy(logits), g, torch.from_numpy(temps), torch.from_numpy(top_ks),
        torch.from_numpy(top_ps),
    ).numpy()
    greedy = temps <= 0
    np.testing.assert_array_equal(got[greedy], want[greedy])
    np.testing.assert_array_equal(got[greedy], logits.argmax(-1)[greedy])
    # top_k=1 at any temperature has a one-token support: the argmax
    assert got[-1] == logits[-1].argmax()


def test_all_greedy_batch_is_argmax_and_draws_nothing():
    logits = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 64)).astype(np.float32))
    g = torch.Generator()
    g.manual_seed(3)
    state = g.get_state().clone()
    toks = sample_tokens(logits, g, torch.zeros(4), torch.zeros(4, dtype=torch.int32), torch.ones(4))
    assert torch.equal(toks, logits.argmax(-1).to(torch.int32))
    assert torch.equal(g.get_state(), state)


def test_sampling_params_same_fields_and_checks():
    import dataclasses

    assert [f.name for f in dataclasses.fields(SamplingParams)] == [
        f.name for f in dataclasses.fields(jax_sampler.SamplingParams)
    ]
    assert SamplingParams() == SamplingParams(**dataclasses.asdict(jax_sampler.SamplingParams()))
    for bad in (dict(temperature=-1.0), dict(max_new_tokens=0)):
        with pytest.raises(ValueError):
            SamplingParams(**bad)


def _branching_sampler(logits, generator, temps, top_ks, top_ps, k_max=64):
    """The truncated path as it read ``need_exact.any()`` back before taking
    the exact wide-nucleus branch (the port's sampler before its step was
    captured in a CUDA graph): the reference for the unconditional form."""
    from agentfield_tpu_torch.serving.sampler import _categorical

    k_max = min(k_max, logits.shape[1])
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    t = temps.clamp(min=1e-6)[:, None]
    full = _categorical(logits / t, generator).to(torch.int32)
    vals, idxs = torch.topk(logits, k_max, dim=-1)
    scaled = vals / t
    k_eff = torch.where(top_ks[:, None] > 0, top_ks[:, None].clamp(max=k_max), k_max)
    k_mask = torch.arange(k_max)[None, :] < k_eff
    probs = torch.softmax(scaled.masked_fill(~k_mask, float("-inf")), dim=-1)
    p_mask = (torch.cumsum(probs, dim=-1) - probs) < top_ps.clamp(max=1.0)[:, None]
    choice = _categorical(scaled.masked_fill(~(k_mask & p_mask), float("-inf")), generator)
    trunc = torch.gather(idxs, 1, choice[:, None])[:, 0].to(torch.int32)
    cand_mass = torch.exp(torch.logsumexp(scaled, -1) - torch.logsumexp(logits / t, -1))
    need_exact = (top_ks == 0) & (top_ps < 1.0) & (cand_mass < top_ps)
    if bool(need_exact.any()):
        order = torch.argsort(logits, dim=-1, descending=True)
        svals = torch.gather(logits, 1, order) / t
        p_full = torch.softmax(svals, dim=-1)
        keep = (torch.cumsum(p_full, dim=-1) - p_full) < top_ps[:, None]
        ch = _categorical(svals.masked_fill(~keep, float("-inf")), generator)
        trunc = torch.where(need_exact, torch.gather(order, 1, ch[:, None])[:, 0].to(torch.int32),
                            trunc)
    sampled = torch.where((top_ks > 0) | (top_ps < 1.0), trunc, full)
    return torch.where(temps <= 0, greedy, sampled), need_exact


@pytest.mark.parametrize("wide", [True, False], ids=["need_exact_rows", "no_need_exact_row"])
def test_truncated_variant_matches_the_branching_sampler(wide):
    """The truncated variant computes the exact rows unconditionally and
    selects them with ``torch.where`` (no device read): per call it gives
    the values the branch on ``need_exact.any()`` gave, with and without
    rows that need the exact nucleus."""
    from agentfield_tpu_torch.serving.sampler import sampler_variant

    rng = np.random.default_rng(7)
    B, V = 64, 300
    logits = torch.from_numpy((rng.standard_normal((B, V)) * (0.1 if wide else 3.0)).astype(np.float32))
    temps = torch.from_numpy(rng.choice([0.0, 0.7, 1.0], B).astype(np.float32))
    top_ks = torch.from_numpy(rng.choice([0, 0, 5], B).astype(np.int32))
    top_ps = torch.from_numpy(rng.choice([1.0, 0.9, 0.5], B).astype(np.float32))
    assert sampler_variant(temps, top_ks, top_ps) == "truncated"
    for seed in range(5):
        g1, g2 = torch.Generator(), torch.Generator()
        g1.manual_seed(seed)
        g2.manual_seed(seed)
        want, need_exact = _branching_sampler(logits, g1, temps, top_ks, top_ps)
        assert bool(need_exact.any()) == wide
        got = sample_tokens(logits, g2, temps, top_ks, top_ps, variant="truncated")
        assert torch.equal(got, want)
        assert torch.equal(sample_tokens(logits, g2, temps, top_ks, top_ps,
                                         variant="greedy"), logits.argmax(-1).int())


def test_sampler_variant_from_host_knobs():
    from agentfield_tpu_torch.serving.sampler import sampler_variant

    z, o = np.zeros(3, np.float32), np.ones(3, np.float32)
    zi = np.zeros(3, np.int32)
    assert sampler_variant(z, zi, o) == "greedy"
    assert sampler_variant(z, zi + 5, o * 0.5) == "greedy"  # knobs without a sampled row
    assert sampler_variant(np.array([0, 1, 0], np.float32), zi, o) == "sampled"
    assert sampler_variant(np.array([0, 1, 0], np.float32), np.array([0, 0, 4], np.int32), o) == "truncated"
    with pytest.raises(ValueError):
        sample_tokens(torch.zeros(3, 8), torch.Generator(), torch.from_numpy(z),
                      torch.from_numpy(zi), torch.from_numpy(o), variant="nucleus")
