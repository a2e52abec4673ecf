"""The port's plain ragged paged attention against the JAX package's plain
version and against its Pallas kernel run in interpret mode, on the kernel
gate's fast shape mixes (packed by the port's ``pack_ragged_rows``) plus a
windowed and a padding-row mix.

Tolerances: the two plain versions do the same float32 math in another
order (1e-5); the Pallas kernel's online softmax reorders more
(``PARITY_TOL["none"]`` = 2e-3, the kernel gate's bound). The pools hold
copies of the new K/V, so they are bit-equal outside the garbage page 0."""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from agentfield_tpu.models import llama as jax_llama
from agentfield_tpu.ops.pallas.ragged_paged_attention_kernel import (
    ragged_paged_attention_pallas,
)
from agentfield_tpu_torch.models.configs import PRESETS
from agentfield_tpu_torch.ops import paged_attention as pa
from agentfield_tpu_torch.ops.cuda import build
from agentfield_tpu_torch.ops.cuda import ragged_paged_attention as rpa
from agentfield_tpu_torch.ops.kernel_shapes import PARITY_TOL, SHAPES, build_case
from agentfield_tpu_torch.serving.kv_cache import pack_ragged_rows

# the JAX ops package re-exports a function under the module's name
jax_pa = importlib.import_module("agentfield_tpu.ops.paged_attention")

REF_TOL = 1e-5
MIXES = {name: (SHAPES[name]["fast"], None) for name in SHAPES}
MIXES["mixed_ragged+window"] = (SHAPES["mixed_ragged"]["fast"], 50)
# padding rows (budget past the last entry) and partly filled rows
MIXES["padding_rows"] = (None, None)
# the speculative verify at GQA 4: R rows of W = k + 1 tokens, each its own
# sequence over its own cached context (k = 1 and 3); and the draft's decode
# (llama-3.2-draft's heads: Kh 2, rep 4, hd 64)
for _k in (1, 3):
    MIXES[f"verify_k{_k}"] = (dict(page_size=16, maxp=16, kh=2, rep=4, hd=32, W=_k + 1,
                                   chunk_list=tuple((c, _k + 1) for c in (0, 37, 100, 160, 252 - _k))),
                              None)
MIXES["draft_decode_hd64"] = (dict(page_size=16, maxp=16, kh=2, rep=4, hd=64, rows=6, ctx=200), None)


def _padding_case(seed=0):
    rng = np.random.default_rng(seed)
    ps, maxp, kh, rep, hd, W = 8, 8, 2, 2, 32, 16
    entries = [(0, 5), (19, 1), (12, 20), (40, 1)]  # (start, n_tokens)
    P = len(entries) * maxp + 1
    tables = (rng.permutation(P - 1) + 1)[: len(entries) * maxp].reshape(-1, maxp)
    rr = pack_ragged_rows(
        [(tables[i], s, [0] * n) for i, (s, n) in enumerate(entries)], maxp, budget=8 * W, block_q=W
    )
    R = rr.row_starts.shape[0]
    assert (rr.n_tokens == 0).sum() >= 2  # padding rows present
    f = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)  # noqa: E731
    return (
        f(R, W, kh * rep, hd), f(R, W, kh, hd), f(R, W, kh, hd), f(P, kh, ps, hd), f(P, kh, ps, hd),
        rr.page_tables, rr.row_starts, rr.n_tokens, rr.ctx_lens, rr.seq_ids,
    )


def _case(name):
    params, window = MIXES[name]
    if params is None:
        return _padding_case(), window
    return build_case(name.split("+")[0], params=params, seed=0), window


def _port_ref(case, window):
    t = [torch.from_numpy(np.array(a)) for a in case]
    return pa.ragged_paged_attention_ref(*t, window=window)


@pytest.mark.parametrize("name", list(MIXES))
def test_plain_matches_jax_plain(name):
    case, window = _case(name)
    want = jax_pa.ragged_paged_attention_ref(*(jnp.asarray(a) for a in case), window=window)
    got = _port_ref(case, window)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=REF_TOL, rtol=0)
    for g, w in zip(got[1:], want[1:]):  # pools, outside the garbage page
        np.testing.assert_array_equal(g[1:].numpy(), np.asarray(w)[1:])


@pytest.mark.parametrize("name", list(MIXES))
def test_plain_matches_pallas_interpret(name):
    case, window = _case(name)
    want = ragged_paged_attention_pallas(
        *(jnp.asarray(a) for a in case), window=window, interpret=True
    )
    got = _port_ref(case, window)
    err = float(np.abs(got[0].numpy() - np.asarray(want[0])).max())
    assert err <= PARITY_TOL["none"], err
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g[1:].numpy(), np.asarray(w)[1:])


def test_padding_rows_and_tokens_give_zeros_and_write_nothing():
    case, _ = _case("padding_rows")
    q, kn, vn, kp, vp, tables, starts, ntok, ctx, seqs = case
    out, kp2, _ = _port_ref(case, None)
    W = q.shape[1]
    pad = np.arange(W)[None, :] >= ntok[:, None]
    assert pad.any() and np.all(out.numpy()[pad] == 0)
    # real pages hold the old content except where a valid token wrote
    written = np.zeros(kp.shape[:1] + kp.shape[2:3], bool)  # [P, ps]
    ps = kp.shape[2]
    for r in range(len(ntok)):
        for w in range(int(ntok[r])):
            pos = int(starts[r]) + w
            written[tables[r, pos // ps], pos % ps] = True
    keep = ~written
    keep[0] = False
    np.testing.assert_array_equal(kp2.numpy().transpose(0, 2, 1, 3)[keep], kp.transpose(0, 2, 1, 3)[keep])


def test_dispatcher_on_cpu_takes_plain_version():
    case, window = _case("mixed_ragged")
    t = [torch.from_numpy(np.array(a)) for a in case]
    t2 = [x.clone() for x in t]
    before = dict(rpa.LAUNCHES)
    a = pa.ragged_paged_attention(*t, window=window)
    b = pa.ragged_paged_attention_ref(*t2, window=window)
    assert rpa.LAUNCHES == before  # the plain version launches no kernel
    assert torch.equal(a[0], b[0])
    for x, y in zip(a[1:], b[1:]):  # page 0 takes colliding garbage writes
        assert torch.equal(x[1:], y[1:])


def test_cuda_wrapper_refuses_cpu_tensors():
    case, _ = _case("pure_decode")
    t = [torch.from_numpy(np.array(a)) for a in case]
    with pytest.raises(ValueError, match="CUDA"):
        rpa.ragged_paged_attention_cuda(*t)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("B,S,H,Kh,hd", [(2, 37, 4, 2, 32), (1, 300, 8, 1, 16)])
def test_dense_causal_attention_matches_jax_attention_ref(B, S, H, Kh, hd, window):
    rng = np.random.default_rng(S)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Kh, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Kh, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want = jax_llama.attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), jnp.asarray(pos),
        jnp.ones((B, S), bool), window=window,
    )
    got = rpa.dense_causal_attention(*(torch.from_numpy(a) for a in (q, k, v)), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=REF_TOL, rtol=0)


def test_decode_oracle_matches_jax():
    rng = np.random.default_rng(7)
    B, H, Kh, hd, ps, maxp = 3, 4, 2, 32, 8, 4
    P = B * maxp + 1
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kp = rng.standard_normal((P, Kh, ps, hd)).astype(np.float32)
    vp = rng.standard_normal((P, Kh, ps, hd)).astype(np.float32)
    tables = (np.arange(B * maxp, dtype=np.int32) + 1).reshape(B, maxp)
    lens = np.array([1, 17, 32], np.int32)
    for window in (None, 6):
        want = jax_pa.paged_attention_ref(
            *(jnp.asarray(a) for a in (q, kp, vp, tables, lens)), window=window
        )
        got = pa.paged_attention_ref(*(torch.from_numpy(a) for a in (q, kp, vp, tables, lens)), window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=REF_TOL, rtol=0)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_smoke_bound_passes_one_ulp_and_rejects_faults(dname):
    """``chip_smoke.py``'s element-wise kernel-vs-plain bound, exercised with
    the plain version standing in for the kernel at a cut Llama-3-8B decode
    shape (Kh 8, rep 4, hd 128, ps 16; 4 rows at ~500 tokens): a 1-ulp move
    of every element passes; a quarter of the cached pages zeroed, or the
    rows' own new K/V zeroed, fails."""
    dtype = getattr(torch, dname)
    p = dict(page_size=16, maxp=32, kh=8, rep=4, hd=128, rows=4, ctx=500)
    case = [torch.from_numpy(a) for a in build_case("decode", params=p, seed=0)]
    case = [a.to(dtype) if a.is_floating_point() else a for a in case]
    q, kn, vn, kp, vp = case[:5]
    o_r, _, _ = pa.ragged_paged_attention_ref(q, kn, vn, kp.clone(), vp.clone(), *case[5:])
    r = o_r.float()
    _, e = torch.frexp(r.abs())
    ulp = torch.exp2((e - chip_smoke.SIGNIFICAND_BITS[dname]).float())
    moved = (r + torch.where(r != 0, ulp, 0.0)).to(dtype)  # representable: no rounding
    assert bool((moved.float() != r).any())
    assert chip_smoke.compare(moved, o_r, dname)[0]
    faults = chip_smoke.fault_check(case, dname, o_r, None, pa.ragged_paged_attention_ref)
    assert all(ratio > 1.0 for _, ratio in faults.values()), faults


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_kernel_has_an_instance_for_every_preset_head_dim(preset):
    """Every preset the port serves has a kernel build of its head dim (the
    JAX kernel checks no head dim), and the build compiles that instance."""
    hd = PRESETS[preset].head_dim
    assert hd in rpa.SUPPORTED_HEAD_DIMS
    targets = build._targets(build.CSRC_DIR / "ragged_paged_attention.cu")
    assert targets[f"ragged_paged_attention.hd{hd}"] == (f"-DAFP_HEAD_DIM={hd}",)


def test_smoke_checks_every_new_head_dim_on_every_path():
    """chip_smoke holds the kernel at each new head dim on decode (also over
    int8 and fp8 pools), chunk and dense, at the preset's own heads."""
    dims = {PRESETS[p].head_dim for p in chip_smoke.HEAD_DIM_PRESETS}
    assert dims | {32, 64, 128} == set(rpa.SUPPORTED_HEAD_DIMS)
    ragged, quant = chip_smoke.ragged_shapes(), chip_smoke.quant_shapes()
    dense = {(H, Kh, hd) for _, _, H, Kh, hd, _ in chip_smoke.dense_shapes()}
    for p in chip_smoke.HEAD_DIM_PRESETS:
        cfg = PRESETS[p]
        for path in ("decode_ctx2k", "chunk512_over1k"):
            s = ragged[f"{p}_{path}"]
            assert (s["kh"], s["kh"] * s["rep"], s["hd"]) == (
                cfg.num_kv_heads, cfg.num_heads, cfg.head_dim)
            assert s.get("window") == cfg.sliding_window
        assert {f"{p}_decode_ctx2k_{m}" for m in chip_smoke.QUANT_MODES} <= set(quant)
        assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) in dense
    assert set(chip_smoke.FAULT_SHAPES) <= set(ragged)
