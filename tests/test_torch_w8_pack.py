"""The int8-weight kernel's packed layout (``ops.cuda.quant_matmul.
pack_int8_weight``) on the CPU, where the kernel cannot run:

- ``unpack_int8_weight(pack_int8_weight(q)) == q`` bit for bit at every
  projection width of every dense preset, with a leading layer axis, and no
  padding where K and N are multiples of 64;
- a pure-Python emulation of the kernel's documented reads (the producer's
  bulk-copy offset of each ring stage, each consumer thread's 16-byte load,
  the A register and half each byte lands in, the byte-to-bf16 widening)
  finds every weight ``q^T[n, k]`` exactly once, where wgmma's A fragment
  wants it: this holds the lane map, which only the card could show wrong;
- a packed ``QuantW`` (``shape``, layer slicing, ``dequantize``) and the
  logits of ``llama.forward`` on packed weights, equal to the logical ones;
- MoE expert stacks ``[L, E, K, N]`` (mixtral-tiny and Mixtral-8x7B
  widths): round trips, and ``QuantW[l][e]`` of a quantized 4-D leaf equal
  to packing that one matrix alone (what the card's per-expert launch
  reads);
- the wrapper's instance list matches the source's.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from agentfield_tpu_torch.models import llama, quant
from agentfield_tpu_torch.models.configs import PRESETS, get_config
from agentfield_tpu_torch.ops.cuda import build
from agentfield_tpu_torch.ops.cuda import quant_matmul as qm


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread keeps this file off the cores that concurrent
    test workers time their locks on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _widths(cfg):
    d, f = cfg.hidden_size, cfg.intermediate_size
    return ((d, cfg.q_dim), (d, cfg.kv_dim), (cfg.q_dim, d), (d, f), (f, d))


@pytest.mark.parametrize("name", sorted(n for n, c in PRESETS.items() if c.num_experts == 0))
def test_pack_round_trips_every_preset_width(name):
    g = torch.Generator().manual_seed(0)
    for K, N in _widths(PRESETS[name]):
        lead = (2,) if K * N <= 1 << 24 else (1,)  # the largest widths: one layer
        q = torch.randint(-127, 128, (*lead, K, N), dtype=torch.int8, generator=g)
        packed = qm.pack_int8_weight(q)
        assert tuple(packed.shape) == (*lead, *qm.packed_shape(K, N))
        if K % qm.K_TILE == 0 and N % qm.PANEL == 0:
            assert packed.numel() == q.numel()  # the same bytes, rearranged
        assert torch.equal(qm.unpack_int8_weight(packed, K, N), q)


def _widen(byte: np.ndarray) -> np.ndarray:
    """The source's widen4 on one byte, in numpy: the byte biased to
    unsigned, placed in the mantissa of 2^23, 2^23 + 128 subtracted in f32,
    the upper half kept as a bf16."""
    u = (byte.astype(np.uint8) ^ np.uint8(0x80)).astype(np.uint32)
    f = (np.uint32(0x4B000000) | u).view(np.float32) - np.float32(8388736.0)
    hi = f.view(np.uint32) & np.uint32(0xFFFF0000)  # bf16 bits, back in an f32
    return hi.view(np.float32)


def test_widening_is_exact_for_every_byte():
    b = np.arange(-128, 128, dtype=np.int8)
    np.testing.assert_array_equal(_widen(b), b.astype(np.float32))


@pytest.mark.parametrize("K,N", [(128, 192), (96, 40), (1024, 256)], ids=str)
def test_packed_bytes_follow_the_kernel_fragment_map(K, N):
    """Every (panel p, K tile kt, warp w, lane, k16 step s of the tile, A
    register r, half e): the producer's bulk copy of a ring stage of panel
    p starting at tile kt starts at byte (p * nkt + kt) * 4096 (a stage of
    two tiles is the next 8192 bytes); the consumer thread's 16-byte load
    for steps 2 c, 2 c + 1 reads at c * 2048 + (32 w + lane) * 16 in the
    tile; byte 8 (s % 2) + 2 r + e of the load widens to register r, half
    e. That must be wgmma's A fragment of the panel's q^T tile: row
    (output column) 16 w + g + 8 (r % 2), column (k) 2 t + e + 8 (r // 2)
    of step s; zero past K and N."""
    rng = np.random.default_rng(3)
    q = rng.integers(-127, 128, (K, N)).astype(np.int8)
    flat = qm.pack_int8_weight(torch.from_numpy(q)).reshape(-1).numpy()
    P, KC, _ = qm.packed_shape(K, N)
    Kp, Np = KC * qm.KC_ROWS, P * qm.PANEL
    nkt = Kp // qm.K_TILE
    qpad = np.zeros((Kp, Np), np.int8)
    qpad[:K, :N] = q
    p, kt, w, lane, s, r, e = (a.ravel() for a in np.meshgrid(
        np.arange(P), np.arange(nkt), np.arange(4), np.arange(32), np.arange(4), np.arange(4),
        np.arange(2), indexing="ij"))
    g, t = lane // 4, lane % 4
    stage = (p * nkt + kt) * 4096  # the producer's one bulk copy of the stage
    load = stage + (s // 2) * qm.KC_BYTES + (32 * w + lane) * 16  # the consumer's 16 bytes
    off = load + (s % 2) * 8 + 2 * r + e
    k = qm.K_TILE * kt + 16 * s + 2 * t + e + 8 * (r // 2)
    n = qm.PANEL * p + 16 * w + g + 8 * (r % 2)
    np.testing.assert_array_equal(_widen(flat[off]), qpad[k, n].astype(np.float32))
    # every weight once, every packed byte once; each stage one 4096-byte run
    assert (np.bincount(k * Np + n, minlength=Kp * Np) == 1).all()
    assert (np.bincount(off, minlength=flat.size) == 1).all()
    assert ((off - stage) < 4096).all() and (stage % 16 == 0).all() and (load % 16 == 0).all()


def test_packed_quantw_reads_like_the_logical_one():
    g = torch.Generator().manual_seed(1)
    w = quant.quantize_weight(torch.empty((3, 96, 40)).normal_(0.0, 0.02, generator=g))
    pw = quant.pack_quantw(w)
    assert w.packed is None and pw.packed == (96, 40)
    assert pw.shape == w.shape == (3, 96, 40) and pw.ndim == 3
    assert tuple(pw.q.shape) == (3, *qm.packed_shape(96, 40))
    assert torch.equal(pw.logical(), w.q) and torch.equal(pw.dequantize(), w.dequantize())
    layer = pw[1]  # the layer axis slices the packed q
    assert layer.packed == (96, 40) and torch.equal(layer.q, pw.q[1])
    x = torch.randn(5, 96)
    assert torch.equal(x @ layer, x @ w[1])  # the plain version reads through unpack
    row = layer[7]  # past the layer axes: through unpack, as the logical weight
    assert row.packed is None and torch.equal(row.q, w.q[1, 7])
    assert quant.pack_quantw(pw) is not pw and torch.equal(quant.pack_quantw(pw).q, pw.q)
    with pytest.raises(ValueError, match="int8"):
        qm.pack_int8_weight(torch.zeros((64, 64)))
    with pytest.raises(ValueError, match="packed weight"):
        qm.unpack_int8_weight(pw.q, 96, 128)


def test_packed_quantw_gives_the_logical_logits():
    cfg = get_config("llama-tiny")
    params = quant.quantize_params(llama.init_params(cfg, seed=0, dtype="float32", device="cpu"))
    packed = {**params, "layers": {k: quant.pack_quantw(v) if isinstance(v, quant.QuantW) else v
                                   for k, v in params["layers"].items()}}
    assert all(packed["layers"][k].packed is not None for k in quant.QUANT_KEYS)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 12)))
    pos = torch.arange(12)[None].expand(2, 12)
    want, _ = llama.forward(params, cfg, tokens, pos, collect_kv=False)
    got, _ = llama.forward(packed, cfg, tokens, pos, collect_kv=False)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name,lead", [("mixtral-tiny", (2, 4)), ("mixtral-8x7b", (1, 2))])
def test_expert_stacks_round_trip(name, lead):
    cfg = PRESETS[name]
    d, f = cfg.hidden_size, cfg.intermediate_size
    assert cfg.num_experts > 0
    g = torch.Generator().manual_seed(2)
    for K, N in ((d, f), (f, d)):
        q = torch.randint(-127, 128, (*lead, K, N), dtype=torch.int8, generator=g)
        packed = qm.pack_int8_weight(q)
        assert tuple(packed.shape) == (*lead, *qm.packed_shape(K, N))
        assert packed.numel() == q.numel()  # Mixtral's widths tile exactly
        assert torch.equal(qm.unpack_int8_weight(packed, K, N), q)
        # the leading axes index matrices: (layer, expert) packs on its own
        l, e = lead[0] - 1, lead[1] - 1
        assert torch.equal(packed[l, e], qm.pack_int8_weight(q[l, e].contiguous()))


def test_quantized_expert_leaf_indexes_layer_then_expert():
    cfg = get_config("mixtral-tiny")
    L, E, d, f = cfg.num_layers, cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
    w = torch.empty((L, E, d, f)).normal_(0.0, 0.02, generator=torch.Generator().manual_seed(3))
    qw = quant.quantize_weight(w)
    pw = quant.pack_quantw(qw)
    assert pw.shape == (L, E, d, f) and tuple(pw.q.shape) == (L, E, *qm.packed_shape(d, f))
    for layer in range(L):
        for e in range(E):
            one = quant.quantize_weight(w[layer, e])
            sl = pw[layer][e]
            assert sl.packed == (d, f) and tuple(sl.scale.shape) == (f,)
            assert torch.equal(sl.q, qm.pack_int8_weight(one.q))
            assert torch.equal(sl.scale, one.scale)
            assert torch.equal(qw[layer][e].q, one.q)


def test_wrapper_instances_match_the_source():
    src = (build.CSRC_DIR / "int8_weight_matmul.cu").read_text()
    macro = src[src.index("#define W8_INSTANCES(X)"):]
    macro = macro[:macro.index("\n\n")]
    assert {(int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", macro)} == qm.INSTANCES
    for name, value in (("BK", qm.K_TILE), ("PANEL", qm.PANEL), ("KC_BYTES", qm.KC_BYTES),
                        ("MAX_SPLITS", qm.MAX_SPLITS)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
