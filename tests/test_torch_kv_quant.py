"""The port's quantized KV pages (``ops/kv_quant.py``) against the JAX
package's, on the CPU.

- ``kv_quantize`` and ``write_pages`` give the JAX package's bytes and scales
  bit for bit, for float32 and bfloat16 inputs, including zero vectors,
  exact half-integer ties and fp8 values near the format's max of 448.
- The dequantization error bounds of the JAX package's own test.
- The plain ragged attention over quantized pools against the JAX plain
  version (outputs within 1e-5: the same float32 math in another order) and
  against the JAX Pallas kernel in interpret mode (``PARITY_TOL[mode]``: the
  kernel attends the launch's own keys unquantized, the plain versions read
  them back quantized). Pools and scales are bit-equal on every live page.
- The plain version over the float32-dequantized pools, with the new K/V
  unquantized, against the Pallas kernel within 1e-5: the kernel's own
  semantics, which ``chip_smoke.py`` holds the CUDA kernel to element-wise.
- ``PagedKVCache`` layouts and byte counts equal the JAX package's; a bad
  ``kv_quant_dtype`` raises.
"""

from __future__ import annotations

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from agentfield_tpu.models import configs as jax_configs
from agentfield_tpu.ops import kv_quant as jax_kq
from agentfield_tpu.ops.pallas.ragged_paged_attention_kernel import (
    ragged_paged_attention_pallas,
)
from agentfield_tpu.serving import kv_cache as jax_kv
from agentfield_tpu_torch.models.configs import get_config
from agentfield_tpu_torch.models.llama import init_params
from agentfield_tpu_torch.ops import kv_quant as kq
from agentfield_tpu_torch.ops import paged_attention as pa
from agentfield_tpu_torch.ops.cuda import ragged_paged_attention as rpa
from agentfield_tpu_torch.ops.kernel_shapes import PARITY_TOL, QUANT_SHAPES, build_case
from agentfield_tpu_torch.serving import engine
from agentfield_tpu_torch.serving.kv_cache import PagedKVCache, pack_ragged_rows

jax_pa = importlib.import_module("agentfield_tpu.ops.paged_attention")

MODES = ("int8", "fp8")
REF_TOL = 1e-5


def _jnp(t):
    """A torch CPU tensor as a JAX array of the same dtype and bits."""
    if t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(t.view(torch.uint8).numpy().view(jnp.float8_e4m3fn))
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _np_bits(a) -> np.ndarray:
    """Raw bits of a JAX array or torch CPU tensor, for bit-equality."""
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.uint8) if a.dtype == torch.float8_e4m3fn else a).numpy()
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a.view(np.uint8)


def _vectors(mode: str) -> np.ndarray:
    """[n, 64] float32 rows: random ones, a zero row, a row whose max |x|
    is 127 with half-integer entries, and rows near fp8's max of 448."""
    rng = np.random.default_rng(3)
    rows = [rng.standard_normal((40, 64)) * s for s in (0.02, 0.3, 3.0)]
    tie = rng.integers(-120, 120, 64) + 0.5  # y = x / 1.0: exact .5 ties
    tie[0] = 127.0
    near = np.array([448, 447, 440, 432, 430, 416, 300, -448, -433, 1e-3] * 6 + [0, 0, 0, 0.5])
    rows += [np.zeros((1, 64)), tie[None], near[None] * (1.0 if mode == "fp8" else 0.25)]
    return np.concatenate(rows).astype(np.float32)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_kv_quantize_bit_equal_to_jax(mode, dname):
    x = torch.from_numpy(_vectors(mode)).to(getattr(torch, dname))
    if mode == "int8":  # the tie row quantizes with scale exactly 1.0
        tie_row = x[-2].float()
        assert float(tie_row.abs().max()) * kq.INV_QMAX["int8"] == 1.0
        assert bool(((tie_row % 1) == 0.5).any())
    q, s = kq.kv_quantize(x, mode)
    jq, js = jax_kq.kv_quantize(_jnp(x), mode)
    np.testing.assert_array_equal(_np_bits(q), _np_bits(jq))
    np.testing.assert_array_equal(_np_bits(s), _np_bits(js))
    assert q.dtype == kq.quant_value_dtype(mode) and s.dtype == torch.float32
    assert s[-3] == torch.tensor(kq.SCALE_FLOOR) and not q[-3].float().any()  # zero row


@pytest.mark.parametrize("mode", MODES)
def test_write_pages_bit_equal_to_jax(mode):
    rng = np.random.default_rng(4)
    L, P, Kh, ps, hd, N = 2, 6, 2, 4, 32, 9
    vals = torch.from_numpy((rng.standard_normal((N, L, Kh, hd)) * 0.7).astype(np.float32))
    slots = rng.permutation(P * ps)[:N]
    pid, sid = torch.from_numpy(slots // ps), torch.from_numpy(slots % ps)
    pool = kq.QuantPages(
        torch.zeros((L, P, Kh, ps, hd), dtype=kq.quant_value_dtype(mode)),
        torch.zeros((L, P, Kh, ps)),
    )
    kq.write_pages(pool, vals, pid, sid)
    jpool = jax_kq.QuantPages(
        jnp.zeros((L, P, Kh, ps, hd), jax_kq.quant_value_dtype(mode)),
        jnp.zeros((L, P, Kh, ps), jnp.float32),
    )
    jpool = jax_kq.write_pages(jpool, _jnp(vals), jnp.asarray(pid.numpy()), jnp.asarray(sid.numpy()))
    np.testing.assert_array_equal(_np_bits(pool.q), _np_bits(jpool.q))
    np.testing.assert_array_equal(_np_bits(pool.scale), _np_bits(jpool.scale))
    assert int((pool.scale > 0).sum()) == N * L * Kh
    plain = torch.zeros((L, P, Kh, ps, hd))
    kq.write_pages(plain, vals, pid, sid)
    assert torch.equal(plain[:, pid, :, sid], vals)


@pytest.mark.parametrize("mode", MODES)
def test_quantize_roundtrip_error_bound(mode):
    """The JAX package's dequantization bounds: int8 is uniform (half a step
    of the row's max |x| / 127); fp8 e4m3 is relative (3 mantissa bits, at
    most 2^-4 of each element). Zero rows round-trip to exact zeros."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal((4, 7, 64)) * 3.0).astype(np.float32))
    back = kq.kv_dequantize(*kq.kv_quantize(x, mode))
    maxabs = x.abs().amax(dim=-1, keepdim=True)
    err = (back - x).abs()
    if mode == "int8":
        assert bool((err <= maxabs * (0.51 / 127.0) + 1e-7).all())
    else:
        assert bool((err <= x.abs() * 2.0**-4 + maxabs * 1e-3).all())
    zq, zs = kq.kv_quantize(torch.zeros((2, 64)), mode)
    assert not kq.kv_dequantize(zq, zs).any()


# --------------------------------------------------------------------------
# attention over quantized pools

# the JAX package's quantized parity cases (tests/test_kv_quant.py _CASES)
_CASES = {
    "all_decode": dict(
        entries=[(0, 1), (7, 1), (8, 1), (15, 1), (16, 1), (40, 1)],
        ps=8, maxp=6, kh=2, rep=2, hd=32, W=1,
    ),
    "adversarial_interleave": dict(
        entries=[(11, 1), (5, 13), (30, 1), (3, 7), (47, 1)],
        ps=8, maxp=8, kh=2, rep=4, hd=32, W=4,
    ),
    "all_prefill": dict(
        entries=[(0, 19), (0, 8), (0, 1)],
        ps=8, maxp=6, kh=2, rep=2, hd=32, W=8,
    ),
}


def _entries_case(c: dict, mode: str, seed: int = 0):
    ps, maxp, kh, rep, hd, W = (c[k] for k in ("ps", "maxp", "kh", "rep", "hd", "W"))
    entries = c["entries"]
    P = len(entries) * maxp + 3
    rng = np.random.default_rng(seed)
    tables = (rng.permutation(P - 1) + 1)[: len(entries) * maxp].reshape(-1, maxp)
    need = sum(-(-n // W) for _, n in entries)
    rr = pack_ragged_rows(
        [(tables[i], s, [0] * n) for i, (s, n) in enumerate(entries)], maxp, budget=need * W, block_q=W
    )
    R = rr.row_starts.shape[0]
    f = lambda *s: torch.from_numpy((rng.standard_normal(s) * 0.5).astype(np.float32))  # noqa: E731
    q, kn, vn = f(R, W, kh * rep, hd), f(R, W, kh, hd), f(R, W, kh, hd)
    kp, ks = kq.kv_quantize(f(P, kh, ps, hd), mode)
    vp, vs = kq.kv_quantize(f(P, kh, ps, hd), mode)
    desc = [torch.from_numpy(a) for a in (rr.page_tables, rr.row_starts, rr.n_tokens, rr.ctx_lens, rr.seq_ids)]
    return [q, kn, vn, kp, vp, *desc, ks, vs]


def _case(name: str):
    """(mode, [q, k_new, v_new, k_pages, v_pages, 5 descriptors, k_scales,
    v_scales]) as CPU tensors."""
    if name in QUANT_SHAPES:
        mode = QUANT_SHAPES[name]["fast"]["kv_dtype"]
        c = build_case(name)
        return mode, [a if isinstance(a, torch.Tensor) else torch.from_numpy(a) for a in c]
    base, mode = name.rsplit("/", 1)
    return mode, _entries_case(_CASES[base], mode)


CASE_NAMES = list(QUANT_SHAPES) + [f"{b}/{m}" for b in _CASES for m in MODES]


def _port(case, window):
    return pa.ragged_paged_attention_ref(*[t.clone() for t in case], window=window)


def _assert_pools_bit_equal(got, want, msg):
    for i, what in ((1, "K"), (2, "V"), (3, "K scales"), (4, "V scales")):
        np.testing.assert_array_equal(  # live pages: page 0 is the garbage sink
            _np_bits(got[i])[1:], _np_bits(want[i])[1:], err_msg=f"{msg} {what}"
        )


@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("name", CASE_NAMES)
def test_quant_plain_matches_jax_plain(name, window):
    mode, case = _case(name)
    got = _port(case, window)
    want = jax_pa.ragged_paged_attention_ref(*(_jnp(t) for t in case), window=window)
    assert len(got) == len(want) == 5
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=REF_TOL, rtol=0)
    _assert_pools_bit_equal(got, want, f"{name} w={window}")


@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("name", CASE_NAMES)
def test_quant_plain_matches_pallas_interpret(name, window):
    mode, case = _case(name)
    want = ragged_paged_attention_pallas(*(_jnp(t) for t in case), window=window, interpret=True)
    got = _port(case, window)
    err = float(np.abs(got[0].numpy() - np.asarray(want[0])).max())
    assert err <= PARITY_TOL[mode], err
    _assert_pools_bit_equal(got, want, f"{name} w={window}")
    # the kernel's own semantics: cached pages dequantized to float32, the
    # launch's keys unquantized
    q, kn, vn, kp, vp, *desc, ks, vs = case
    deq = pa.ragged_paged_attention_ref(
        q, kn, vn, kq.kv_dequantize(kp, ks), kq.kv_dequantize(vp, vs), *desc, window=window
    )
    np.testing.assert_allclose(deq[0].numpy(), np.asarray(want[0]), atol=REF_TOL, rtol=0)


@pytest.mark.parametrize("mode", MODES)
def test_dispatcher_takes_and_returns_quant_pages_on_cpu(mode):
    _, case = _case(f"adversarial_interleave/{mode}")
    q, kn, vn, kp, vp, *desc, ks, vs = case
    before = dict(rpa.LAUNCHES)
    out, kpo, vpo = pa.ragged_paged_attention(
        q, kn, vn, kq.QuantPages(kp.clone(), ks.clone()), kq.QuantPages(vp.clone(), vs.clone()), *desc
    )
    assert rpa.LAUNCHES == before  # CPU tensors take the plain version
    want = _port(case, None)
    assert isinstance(kpo, kq.QuantPages) and kq.quant_mode_of(kpo) == mode
    assert torch.equal(out, want[0])
    _assert_pools_bit_equal((out, kpo.q, vpo.q, kpo.scale, vpo.scale), want, mode)
    with pytest.raises(ValueError, match="CUDA"):
        rpa.ragged_paged_attention_cuda(*case)


@pytest.mark.parametrize("mode", MODES)
def test_smoke_quant_checks_on_plain_version(mode):
    """``chip_smoke.py``'s quantized checks with the plain version in the
    kernel's place, at a cut Llama-3-8B decode shape (Kh 8, rep 4, hd 128,
    ps 16; 4 rows at ~500 tokens): the plain version over the dequantized
    pools passes check (b) against itself moved by one ulp, and (b) rejects
    a quarter of the cached pages zeroed (values and scales) and the rows'
    own new K/V zeroed."""
    p = dict(page_size=16, maxp=32, kh=8, rep=4, hd=128, rows=4, ctx=500, kv_dtype=mode)
    case = [a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
            for a in build_case("decode", params=p, seed=0)]
    case = [a.bfloat16() if a.dtype == torch.float32 and i < 3 else a for i, a in enumerate(case)]
    o_d = chip_smoke.dequantized_ref(case, None)
    r = o_d.float()
    _, e = torch.frexp(r.abs())
    ulp = torch.exp2((e - chip_smoke.SIGNIFICAND_BITS["bfloat16"]).float())
    moved = (r + torch.where(r != 0, ulp, 0.0)).bfloat16()
    assert bool((moved.float() != r).any())
    assert chip_smoke.compare(moved, o_d, "bfloat16")[0]
    faults = chip_smoke.fault_check(case, "bfloat16", o_d, None, pa.ragged_paged_attention_ref)
    assert all(ratio > 1.0 for _, ratio in faults.values()), faults


# --------------------------------------------------------------------------
# cache and engine


@pytest.mark.parametrize("mode", ("none",) + MODES)
def test_paged_kv_cache_layout_matches_jax(mode):
    tcfg = get_config("llama-tiny")
    jcfg = dataclasses.replace(jax_configs.get_config("llama-tiny"), dtype="float32")
    c = PagedKVCache.create(tcfg, num_pages=10, page_size=8, dtype="float32", device="cpu", kv_quant=mode)
    j = jax_kv.PagedKVCache.create(jcfg, num_pages=10, page_size=8, dtype="float32", kv_quant=mode)
    assert c.kv_quant == j.kv_quant == mode and c.num_pages == j.num_pages == 10
    assert c.page_bytes() == j.page_bytes() and c.hbm_bytes() == j.hbm_bytes()
    if mode == "none":
        assert tuple(c.k_pages.shape) == tuple(j.k_pages.shape)
        return
    assert isinstance(c.k_pages, kq.QuantPages) and isinstance(c.v_pages, kq.QuantPages)
    for t, a in ((c.k_pages.q, j.k_pages.q), (c.k_pages.scale, j.k_pages.scale)):
        assert tuple(t.shape) == tuple(a.shape) and t.itemsize == a.dtype.itemsize
        assert not t.float().any()
    assert c.k_pages.q.dtype == kq.quant_value_dtype(mode)
    assert c.k_pages.scale.dtype == torch.float32


def test_engine_rejects_unknown_kv_quant_dtype():
    cfg = get_config("llama-tiny")
    params = init_params(cfg, seed=0, device="cpu")
    ecfg = engine.EngineConfig(max_batch=2, page_size=8, num_pages=16, max_pages_per_seq=4,
                               kv_quant_dtype="int4")
    with pytest.raises(ValueError, match="kv_quant_dtype"):
        engine.InferenceEngine(params, cfg, ecfg)
