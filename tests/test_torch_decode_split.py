"""The plain versions of the CUDA kernel's split-context decode
(``ops/paged_attention.py``: ``decode_split_plan``, ``decode_partials_ref``,
``merge_partials_ref``) on the CPU.

- The plan covers each row's cached keys in reach, ``[k_lo, ctx)``, exactly
  once, with every range inside its split.
- Attention split into the plan's ranges plus the launch's own keys, merged
  by the plain combine, equals the unsplit plain version within 1e-6 in
  float32 (the same sums in another order): on the fast shape mixes and the
  quantized mixes (over the dequantized pools with the new K/V unquantized,
  the kernel's semantics), and on edge rows: context 0, shorter than one
  split, not a multiple of the split, padding rows, and windows that cross
  split edges.
- The merged result agrees with the JAX package's plain version (1e-5).
"""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentfield_tpu_torch.ops import paged_attention as pa
from agentfield_tpu_torch.ops.cuda import ragged_paged_attention as rpa
from agentfield_tpu_torch.ops.kernel_shapes import QUANT_SHAPES, SHAPES, build_case
from agentfield_tpu_torch.ops.kv_quant import kv_dequantize
from agentfield_tpu_torch.serving.kv_cache import pack_ragged_rows

jax_pa = importlib.import_module("agentfield_tpu.ops.paged_attention")

SPLIT_TOL = 1e-6
JAX_TOL = 1e-5


def _edge_case(seed=0):
    """Decode rows at contexts around the split size (0, shorter than one
    split, exactly one, not a multiple, several), two padding rows, and one
    two-token row: ps 16, maxp 48 (768 keys, 3 splits), Kh 2, rep 2, hd 32."""
    rng = np.random.default_rng(seed)
    ps, maxp, kh, rep, hd = 16, 48, 2, 2, 32
    entries = [(0, 1), (5, 1), (255, 1), (256, 1), (300, 1), (513, 1), (767, 1), (600, 2)]
    P = len(entries) * maxp + 1
    tables = (rng.permutation(P - 1) + 1)[: len(entries) * maxp].reshape(-1, maxp)
    W = 2
    rr = pack_ragged_rows([(tables[i], s, [0] * n) for i, (s, n) in enumerate(entries)], maxp,
                          budget=(len(entries) + 2) * W, block_q=W)
    R = rr.row_starts.shape[0]
    assert (rr.n_tokens == 0).sum() >= 2  # padding rows present
    f = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)  # noqa: E731
    return (f(R, W, kh * rep, hd), f(R, W, kh, hd), f(R, W, kh, hd), f(P, kh, ps, hd),
            f(P, kh, ps, hd), rr.page_tables, rr.row_starts, rr.n_tokens, rr.ctx_lens, rr.seq_ids)


# name -> (function making the numpy case, window)
PLAIN = {name: (lambda n=name: build_case(n), None) for name in SHAPES}
PLAIN["mixed_ragged+window"] = (lambda: build_case("mixed_ragged"), 50)
PLAIN["long_context_paged+window300"] = (lambda: build_case("long_context_paged"), 300)
PLAIN["edges"] = (_edge_case, None)
PLAIN["edges+window200"] = (_edge_case, 200)  # windows cross the 256 and 512 edges
PLAIN["edges+window1"] = (_edge_case, 1)
# the served decode's shape, cut: live decode rows at spread contexts among
# padding rows (build_case's ``served`` and ``pad_to``)
SERVED = dict(page_size=16, maxp=48, kh=2, rep=4, hd=32, served=(0, 64, 300, 700), pad_to=8)
PLAIN["served"] = (lambda: build_case("served", params=SERVED), None)
QUANT = list(QUANT_SHAPES)


def _t(case):
    return [torch.from_numpy(np.array(a)) for a in case]


def _plan_cases():
    out = []
    for ctx in (0, 1, 255, 256, 257, 511, 512, 700, 2048, 3000):
        for start in (ctx, ctx + 3):
            for window in (None, 1, 100, 256, 300, 4096):
                for maxp, ps in ((128, 16), (48, 16), (5, 7), (1, 1)):
                    out.append((ctx, start, window, maxp, ps))
    return out


@pytest.mark.parametrize("split", [256, 64])
def test_plan_covers_reach_exactly_once(split):
    for ctx, start, window, maxp, ps in _plan_cases():
        plan = pa.decode_split_plan(ctx, start, window, maxp, ps, split=split)
        k_lo = max(0, start - window + 1) if window else 0
        want = list(range(k_lo, min(ctx, maxp * ps)))
        got = [k for _, lo, hi in plan for k in range(lo, hi)]
        assert got == want, (ctx, start, window, maxp, ps)
        for s, lo, hi in plan:
            assert s * split <= lo < hi <= (s + 1) * split
            assert s < -(-maxp * ps // split)


def test_merge_of_empty_partials_is_zero_and_of_one_is_normalized():
    m = torch.tensor([[-1e30, -1e30], [0.5, -1e30]])  # [S, nq]
    lsum = torch.tensor([[0.0, 0.0], [2.0, 0.0]])
    acc = torch.zeros((2, 2, 3))
    acc[1, 0] = torch.tensor([1.0, -2.0, 4.0])
    out = pa.merge_partials_ref(m, lsum, acc)
    torch.testing.assert_close(out[0], torch.tensor([0.5, -1.0, 2.0]), rtol=0, atol=0)
    assert torch.equal(out[1], torch.zeros(3))


@pytest.mark.parametrize("name", list(PLAIN))
def test_split_merge_matches_unsplit_plain(name):
    make, window = PLAIN[name]
    case = _t(make())
    want = pa.ragged_paged_attention_ref(*[x.clone() for x in case], window=window)[0]
    got = pa.ragged_paged_attention_split_ref(*case, window=window)
    err = float((got - want).abs().max())
    assert err <= SPLIT_TOL, err
    pad = torch.arange(case[0].shape[1])[None] >= case[7][:, None]
    assert bool((got[pad] == 0).all())  # padding rows and tokens give zeros


@pytest.mark.parametrize("name", QUANT)
@pytest.mark.parametrize("window", [None, 50])
def test_split_merge_matches_unsplit_plain_quantized(name, window):
    case = list(build_case(name))
    q, kn, vn, kp, vp = (x if isinstance(x, torch.Tensor) else torch.from_numpy(x)
                         for x in case[:5])
    desc = [torch.from_numpy(np.array(a)) for a in case[5:10]]
    ks, vs = case[10:12]
    # the kernel's semantics: cached pages dequantized, own K/V unquantized
    want = pa.ragged_paged_attention_ref(q, kn, vn, kv_dequantize(kp, ks), kv_dequantize(vp, vs),
                                         *desc, window=window)[0]
    got = pa.ragged_paged_attention_split_ref(q, kn, vn, kp, vp, *desc, ks, vs, window=window)
    err = float((got - want).abs().max())
    assert err <= SPLIT_TOL, err


@pytest.mark.parametrize("name", ["pure_decode", "mixed_ragged", "long_context_paged", "edges"])
@pytest.mark.parametrize("window", [None, 200])
def test_split_merge_matches_jax_plain(name, window):
    case = PLAIN[name][0]()
    want = jax_pa.ragged_paged_attention_ref(*(jnp.asarray(a) for a in case), window=window)
    got = pa.ragged_paged_attention_split_ref(*_t(case), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want[0]), atol=JAX_TOL, rtol=0)


def test_partials_follow_the_plan():
    """Splits outside a row's plan, and every split of a padding row, hold
    the empty partial; phase B's partial (the last) is never empty for a
    live row."""
    case = _t(_edge_case())
    m, lsum, acc = pa.decode_partials_ref(*case, window=200)
    tables, starts, ntok, ctx = case[5], case[6], case[7], case[8]
    ns = m.shape[2] - 1
    for r in range(m.shape[0]):
        held = {s for s, _, _ in pa.decode_split_plan(int(ctx[r]), int(starts[r]), 200,
                                                     tables.shape[1], case[3].shape[2])}
        for s in range(ns):
            if int(ntok[r]) <= 0 or s not in held:
                assert bool((m[r, :, s] == -1e30).all() and (lsum[r, :, s] == 0).all())
                assert bool((acc[r, :, s] == 0).all())
        if int(ntok[r]) > 0:
            assert bool((lsum[r, :, ns, : int(ntok[r]) * 2] > 0).all())


def test_served_case_packs_live_rows_then_padding():
    case = build_case("served", params=SERVED)
    starts, ntok, ctx = case[6], case[7], case[8]
    assert len(ntok) == SERVED["pad_to"]
    assert list(starts[:4]) == list(SERVED["served"]) == list(ctx[:4])
    assert list(ntok) == [1] * 4 + [0] * 4


def test_reset_launches_clears_the_path_counts():
    rpa.PATH_LAUNCHES["ragged_decode_split"] += 3
    rpa.LAUNCHES["ragged_paged_attention"] += 1
    rpa.reset_launches()
    assert not any(rpa.PATH_LAUNCHES.values()) and not any(rpa.LAUNCHES.values())
