"""Wrapper of the hand-written int8-weight matrix product
(``csrc/int8_weight_matmul.cu``): ``y = (x @ q) * scale`` with ``q [K, N]``
int8 and ``scale [N]`` f32, per-output-channel symmetric weights as
``models.quant.QuantW`` holds them. The kernel is the port's implementation
of ``agentfield_tpu/models/quant.py``'s ``QuantW.__rmatmul__``; it has no
Pallas twin (on the TPU, XLA folds the int8 convert into the dot).

Two layouts of q. The logical one, ``[..., K, N]`` with N contiguous, is the
JAX package's; CPU tensors keep it, and the plain version
(``int8_weight_matmul_ref``, the JAX formula ``(x @ q.to(x.dtype)) *
scale.to(x.dtype)``) reads it. The kernel reads the packed one
(``pack_int8_weight``; ``unpack_int8_weight`` inverts it): panels of 64
output columns, each a run of 2048-byte chunks of 32 K rows laid out as the
kernel's consumer threads take them (the fragment map below, and the
source's note). ``models.quant`` packs a weight once, when it is quantized on (or
carried to) a CUDA device, so ``QuantW.q`` on the card is packed and on the
CPU logical; both hold the same bytes where K and N are multiples of 64.

``int8_weight_matmul_cuda`` takes CUDA tensors and a packed q only: it
checks them, plans the launch (``plan``), allocates ``y`` with
``torch.empty`` (the kernel needs no workspace: a split product sums its
partials across a thread-block cluster's shared memory), launches on the
current stream and counts the launch in ``LAUNCHES``; anything the kernel
does not take raises, as does a launch the runtime refuses. ``PATH_LAUNCHES``
counts by the kernel's path: ``w8_stream`` (M <= 64) or ``w8_tiled`` (larger
M), and ``w8_splitk`` the launches among them that split K across a
cluster's CTAs (a product is always one launch). A launch recorded into a
CUDA graph counts once, at capture; the graph's owner adds its launches per
replay (``ops.cuda.ragged_paged_attention.launch_counts`` and
``add_launches`` cover these counters too).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from agentfield_tpu_torch.ops.cuda import build, refuse_grad

# the kernel's tiles and edge rules (csrc/int8_weight_matmul.cu)
K_TILE = 64  # K rows of a ring stage; the packed layout pads K to it
PANEL = 64  # output columns of a panel (wgmma's M); the packed layout pads N to it
KC_ROWS, KC_BYTES = 32, 2048  # a packed chunk: 32 K rows of a panel, 128 threads x 16 bytes
K_MULTIPLE, N_MULTIPLE = 16, 32
STREAM_MAX_M = 64
MAX_SPLITS = 8  # a portable thread-block cluster
H100_SMS = 132
SMEM_LIMIT = 232448  # shared memory a CTA may take on the card
# the (nx, cw) instances the source builds (its W8_INSTANCES): nx rows of x a
# tile (wgmma's N), cw panels (consumer warpgroups) a CTA
INSTANCES = frozenset({(nx, 1) for nx in range(8, STREAM_MAX_M + 1, 8)}
                      | {(128, 1), (128, 2), (256, 1), (256, 2)})
# Plans that beat the heuristic on the card by more than 5% (``chip_smoke.py
# --w8-sweep``: every candidate at every bf16 shape, chained cold products in
# a graph; NVIDIA H100 80GB HBM3, 700 W): (M bucket, K, N) -> (nx, cw,
# splits). Every other shape takes ``_heuristic``.
PLAN_TABLE: dict[tuple[int, int, int], tuple[int, int, int]] = {
    (16, 3072, 8192): (16, 1, 2),  # phi-3-mini w_gate/w_up, 16 rows
    (256, 4096, 4096): (128, 2, 2),  # wq/wo, 200 rows
    (512, 4096, 1024): (128, 1, 2),  # wk/wv, 512 rows
    (512, 14336, 4096): (256, 2, 2),  # w_down, 512 rows
}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = {"int8_weight_matmul": 0}
PATH_LAUNCHES = {"w8_stream": 0, "w8_tiled": 0, "w8_splitk": 0}


# ---------------------------------------------------------------------------
# the packed layout

def packed_shape(K: int, N: int) -> tuple[int, int, int]:
    """Shape of one packed ``[K, N]`` weight: ``(panels, K chunks, 2048)``,
    K padded to ``K_TILE`` and N to ``PANEL``."""
    return -(-N // PANEL), -(-K // K_TILE) * (K_TILE // KC_ROWS), KC_BYTES


# The kernel's fragment map, which the packing follows: byte ``8 s + 2 r +
# e`` of thread ``T = 32 w + 4 g + t`` in chunk ``kc`` of panel ``p`` holds
# q[k = 32 kc + 16 s + 2 t + e + 8 (r // 2), n = 64 p + 16 w + g + 8 (r % 2)]
# (k16 step s, A register r, half e). As axes of the chunk: k splits into
# (kc, s, hk = r // 2, t, e) and n into (p, w, h = r % 2, g); the packed
# order is (p, kc, w, g, t, s, hk, h, e).
_K_AXES, _N_AXES = (2, 2, 4, 2), (4, 2, 8)  # (s, hk, t, e) under kc; (w, h, g) under p
_PACK_PERM = (5, 0, 6, 8, 3, 1, 2, 7, 4)  # (kc s hk t e p w h g) -> (p kc w g t s hk h e)
_UNPACK_PERM = tuple(_PACK_PERM.index(i) for i in range(9))


def pack_int8_weight(q: torch.Tensor) -> torch.Tensor:
    """``[..., K, N]`` int8 (the logical layout) -> ``[..., panels, K
    chunks, 2048]`` (the kernel's), zero-padded to whole 64 x 64 tiles.
    Plain PyTorch on any device; leading axes (layers, experts) are kept."""
    if q.dtype != torch.int8 or q.dim() < 2:
        raise ValueError(f"pack_int8_weight takes [..., K, N] int8, not {q.dtype} {tuple(q.shape)}")
    *lead, K, N = q.shape
    P, KC, _ = packed_shape(K, N)
    Kp, Np = KC * KC_ROWS, P * PANEL
    if (Kp, Np) != (K, N):
        q = F.pad(q, (0, Np - N, 0, Kp - K))
    nl = len(lead)
    v = q.reshape(*lead, KC, *_K_AXES, P, *_N_AXES)
    return v.permute(*range(nl), *(nl + i for i in _PACK_PERM)).reshape(
        *lead, P, KC, KC_BYTES).contiguous()


def unpack_int8_weight(packed: torch.Tensor, K: int, N: int) -> torch.Tensor:
    """The inverse of ``pack_int8_weight``: ``[..., K, N]`` int8."""
    P, KC, B = packed_shape(K, N)
    if tuple(packed.shape[-3:]) != (P, KC, B) or packed.dtype != torch.int8:
        raise ValueError(f"packed weight {packed.dtype} {tuple(packed.shape)} is not [..., {P}, "
                         f"{KC}, {B}] int8 (K={K}, N={N})")
    lead = packed.shape[:-3]
    nl = len(lead)
    v = packed.reshape(*lead, P, KC, *(4, 8, 4, 2, 2, 2, 2))  # (p kc w g t s hk h e)
    q = v.permute(*range(nl), *(nl + i for i in _UNPACK_PERM)).reshape(
        *lead, KC * KC_ROWS, P * PANEL)
    return q[..., :K, :N].contiguous()


# ---------------------------------------------------------------------------
# the launch plan

def cta_smem(nx: int, cw: int) -> dict:
    """The source's ``Cfg<nx, cw>``: ring stages and bytes of a CTA's shared
    memory, and the bytes of its f32 partial tile (which reuses the ring)."""
    kt = 1 if nx > STREAM_MAX_M else 2  # 64-row K tiles a stage
    stage = kt * (cw * PANEL * K_TILE + nx * 2 * K_TILE)
    budget = (200 if nx > 64 else 100) * 1024
    stages = min(16, budget // stage)
    red = nx * (PANEL * cw + 4) * 4
    data = max(stages * stage, red)
    return {"stages": stages, "stage_bytes": stage, "partial_bytes": red,
            "smem_bytes": data + 2 * stages * 8 + 1024}


def m_bucket(M: int) -> int:
    """Rows of x rounded up: to 8 up to 64 (the decode widths), then to a
    power of two."""
    return 8 * -(-M // 8) if M <= STREAM_MAX_M else 1 << (M - 1).bit_length()


def _heuristic(M: int, K: int, N: int, sms: int) -> tuple[int, int, int]:
    """(nx, cw, splits), from sweeps on the card. Decode widths: x's rows
    rounded up to 8, one panel a CTA, and the most splits (at most
    ``MAX_SPLITS``, at least 2 K tiles each) that keep the CTAs within 1.5
    an SM: the consumers' latency bounds a CTA's stream, so more of them
    stream faster while they all fit at once (192 CTAs beat 128 at wq/wo
    and w_down; 256 or more lose their single wave). Prefill: 128 or 256
    rows a tile; two panels a CTA where that still gives three quarters of
    the SMs a tile (they share the x tile), else one; then the fewest
    splits, at most 4, that give three quarters of the SMs a CTA (a split
    costs more here than an idle SM)."""
    panels, nkt = -(-N // PANEL), -(-K // K_TILE)
    if M <= STREAM_MAX_M:
        nx, cw = max(8, 8 * -(-M // 8)), 1
        splits = (3 * sms // 2) // panels
    else:
        nx = 128 if M <= 128 else 256
        m_tiles = -(-M // nx)
        cw = 2 if m_tiles * -(-panels // 2) >= 3 * sms // 4 else 1
        splits = min(4, -(-(3 * sms // 4) // (m_tiles * -(-panels // cw))))
    return nx, cw, max(1, min(MAX_SPLITS, splits, nkt // 2))


def plan(M: int, K: int, N: int, sms: int = H100_SMS) -> dict:
    """The launch of one bf16 ``[M, K] @ [K, N]`` product: ``PLAN_TABLE``'s
    entry for ``(m_bucket(M), K, N)`` where there is one, else the
    heuristic's. ``path`` "stream" (M <= 64) or "tiled"; ``nx`` rows of x a
    tile (wgmma's N), ``cw`` 64-column panels a CTA, the ``ceil(K / 64)`` K
    tiles cut into ``splits`` ranges of ``kt_per_split`` (a cluster of
    ``splits`` CTAs a tile); ``ctas`` the grid. f32 x takes a kernel of its
    own and ignores the plan. Raises ``ValueError`` on widths the kernel
    cannot tile."""
    if K <= 0 or K % K_MULTIPLE or N <= 0 or N % N_MULTIPLE:
        raise ValueError(
            f"int8-weight matmul: K={K} must be a positive multiple of {K_MULTIPLE} and "
            f"N={N} of {N_MULTIPLE}")
    nx, cw, splits = PLAN_TABLE.get((m_bucket(M), K, N)) or _heuristic(M, K, N, sms)
    nkt, panels = -(-K // K_TILE), -(-N // PANEL)
    per = -(-nkt // splits)
    splits = -(-nkt // per)
    m_tiles, groups = -(-max(M, 1) // nx), -(-panels // cw)
    return {"path": "stream" if M <= STREAM_MAX_M else "tiled", "nx": nx, "cw": cw,
            "splits": splits, "kt_per_split": per, "m_tiles": m_tiles, "groups": groups,
            "ctas": splits * groups * m_tiles}


def int8_weight_matmul_ref(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The plain version (the JAX package's formula) on the logical layout:
    ``(x @ q) * scale`` in ``x``'s dtype, the weight widened to it."""
    y = x @ q.to(x.dtype)
    return y * scale.to(y.dtype)


# ---------------------------------------------------------------------------
# the launch

_fns: dict[str, object] = {}
_sms: dict[int, int] = {}  # device index -> SM count, once the device is set up


def _device_state(dev: torch.device) -> int:
    """The SM count of ``dev``; at the device's first product, sets up the
    kernel there (every instance's shared-memory limit, the tensor-map
    encoder), which must not happen inside a CUDA graph capture."""
    sms = _sms.get(dev.index)
    if sms is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "int8-weight matmul: the first product on a device may not be captured into "
                "a CUDA graph; run one eagerly first (it sets up the kernel on the device)")
        fn, setup, err_str = _entry()
        with torch.cuda.device(dev):
            rc = setup()
        if rc != 0:
            raise RuntimeError(f"int8-weight matmul setup failed: CUDA error {rc} "
                               f"({err_str(rc).decode()})")
        sms = _sms[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms


def bind(lib: ctypes.CDLL) -> tuple:
    """``(matmul, setup, error_string)`` of a built library, argument types
    set: every pointer and the stream as c_void_p (unset argtypes would pass
    Python ints as 32-bit C ints and cut 64-bit device pointers)."""
    fn = lib.w8_matmul
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.w8_setup.argtypes = []
    lib.w8_setup.restype = ctypes.c_int
    lib.w8_error_string.argtypes = [ctypes.c_int]
    lib.w8_error_string.restype = ctypes.c_char_p
    return fn, lib.w8_setup, lib.w8_error_string


def _entry() -> tuple:
    fns = _fns.get("w8")
    if fns is None:
        fns = _fns["w8"] = bind(build.load("int8_weight_matmul"))
    return fns


def _check(name: str, t: torch.Tensor, device, dtypes, shape) -> None:
    if not isinstance(t, torch.Tensor) or not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} dtype {t.dtype} not in {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _launch(fn, err_str, x, qp, scale, y, M, K, N, p: dict, stream: int) -> None:
    """One call of the C entry; raises with the CUDA error on a refused
    launch, else counts it."""
    Kp = packed_shape(K, N)[1] * KC_ROWS
    rc = fn(x.data_ptr(), qp.data_ptr(), scale.data_ptr(), y.data_ptr(), M, K, N, Kp,
            _DTYPE_CODES[x.dtype], p["nx"], p["cw"], p["splits"], p["kt_per_split"], stream)
    if rc != 0:
        raise RuntimeError(
            f"int8-weight matmul launch failed: CUDA error {rc} ({err_str(rc).decode()})")
    LAUNCHES["int8_weight_matmul"] += 1
    PATH_LAUNCHES[f"w8_{p['path']}"] += 1
    if p["splits"] > 1 and x.dtype == torch.bfloat16:
        PATH_LAUNCHES["w8_splitk"] += 1


def int8_weight_matmul_cuda(x: torch.Tensor, qp: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``(x @ q) * scale`` on the card: ``x [..., K]`` bf16 or f32, ``qp``
    the packed ``[K, N]`` int8 weight (``pack_int8_weight``), ``scale [N]``
    f32; returns ``[..., N]`` in ``x``'s dtype, summed in f32. Raises on
    anything the kernel does not take (an ``x`` that requires grad under
    grad mode among it: no backward); there is no fallback."""
    refuse_grad("int8_weight_matmul_cuda", x)
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x dtype {x.dtype} not supported (float32, bfloat16)")
    K, N = x.shape[-1], scale.shape[-1]
    lead = x.shape[:-1]
    M = math.prod(lead)
    dev = x.device
    x2 = x.reshape(M, K)
    if x2.is_cuda and (not x2.is_contiguous() or x2.data_ptr() % 16):  # a fresh copy is both
        x2 = x2.clone(memory_format=torch.contiguous_format)
    _check("x", x2, dev, (x.dtype,), (M, K))
    _check("scale", scale, dev, (torch.float32,), (N,))
    if qp.dim() != 3:
        raise ValueError(f"q {tuple(qp.shape)} is not packed: the kernel reads "
                         "pack_int8_weight's layout")
    _check("q", qp, dev, (torch.int8,), packed_shape(K, N))
    p = plan(M, K, N, _device_state(dev))
    y = torch.empty((M, N), dtype=x.dtype, device=dev)
    if M == 0:
        return y.reshape(*lead, N)
    fn, _, err_str = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(fn, err_str, x2, qp, scale, y, M, K, N, p, stream)
    return y.reshape(*lead, N)
