"""Wrapper of the hand-written int8-weight matrix product
(``csrc/int8_weight_matmul.cu``): ``y = (x @ q) * scale`` with ``q [K, N]``
int8 and ``scale [N]`` f32, per-output-channel symmetric weights as
``models.quant.QuantW`` holds them. The kernel is the port's implementation
of ``agentfield_tpu/models/quant.py``'s ``QuantW.__rmatmul__``; it has no
Pallas twin (on the TPU, XLA folds the int8 convert into the dot).

``int8_weight_matmul_ref`` is the plain version, the JAX formula ``(x @
q.to(x.dtype)) * scale.to(x.dtype)``: CPU tensors run it (through
``models.quant``). ``int8_weight_matmul_cuda`` takes CUDA tensors only: it
checks them, plans the launch (``plan``), allocates ``y`` with
``torch.empty`` (the split-K partials live in a per-device workspace of
fixed size, allocated with the tile counters at the device's first product
and never replaced, so a CUDA graph captured on it stays valid), launches on
the current stream and counts
the launch in ``LAUNCHES``; anything the kernel does not take raises, as
does a launch the runtime refuses. ``PATH_LAUNCHES`` counts by the kernel's
path: ``w8_stream`` (M <= 64) or ``w8_tiled`` (larger M), and ``w8_splitk``
the launches among them that split K across CTAs (the last CTA of a tile
sums the partials, so a product is always one launch). A launch
recorded into a CUDA graph counts once, at capture; the graph's owner adds
its launches per replay (``ops.cuda.ragged_paged_attention.launch_counts``
and ``add_launches`` cover these counters too).
"""

from __future__ import annotations

import ctypes
import math

import torch

from agentfield_tpu_torch.ops.cuda import build

# the kernel's tiles (BK, and 32 columns times the warps across N in the
# source) and its edge rules
K_TILE = 64
STREAM_N_TILE, TILED_N_TILE = 256, 128
K_MULTIPLE, N_MULTIPLE = 16, 32
STREAM_MAX_M = 64
_STREAM_BM = (16, 32, 64)
_TILED_BM = 128
# the most outputs a CTA tile holds (64 x 256 streamed, 128 x 128 tiled)
TILE_FLOATS = max(_STREAM_BM[-1] * STREAM_N_TILE, _TILED_BM * TILED_N_TILE)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PATH_CODES = {"stream": 1, "tiled": 2}
H100_SMS = 132

LAUNCHES = {"int8_weight_matmul": 0}
PATH_LAUNCHES = {"w8_stream": 0, "w8_tiled": 0, "w8_splitk": 0}


def plan(M: int, K: int, N: int, sms: int = H100_SMS) -> dict:
    """The launch of one ``[M, K] @ [K, N]`` product: its path ("stream"
    for M <= 64, else "tiled"), the rows ``bm`` of a CTA, and the split of
    the ``ceil(K / 64)`` K tiles into ``splits`` ranges of ``kt_per_split``
    tiles: split-K only when the ``N / n_tile x M / bm`` CTAs (``n_tile``
    256 on the stream path, 128 tiled) alone would leave
    some of the card's ``sms`` without one (a CTA's 3-4 ring stages keep
    enough bytes in flight to stream its SM's share), at least 4 K tiles a
    split. The split-K partials (``splits x M x N`` f32) go to the device's
    workspace: ``tiles x splits <= sms`` and a tile holds at most
    ``TILE_FLOATS`` outputs, so ``sms x TILE_FLOATS`` floats cover every
    product, and ``sms`` tile counters cover its tiles.
    Raises ``ValueError`` on widths the kernel cannot tile."""
    if K <= 0 or K % K_MULTIPLE or N <= 0 or N % N_MULTIPLE:
        raise ValueError(
            f"int8-weight matmul: K={K} must be a positive multiple of {K_MULTIPLE} and "
            f"N={N} of {N_MULTIPLE}")
    if M <= STREAM_MAX_M:
        path, bm = "stream", next(b for b in _STREAM_BM if M <= b)
    else:
        path, bm = "tiled", _TILED_BM
    n_tile = STREAM_N_TILE if path == "stream" else TILED_N_TILE
    tiles = -(-N // n_tile) * -(-M // bm)
    nkt = -(-K // K_TILE)
    splits = max(1, min(sms // tiles, nkt // 4))
    per = -(-nkt // splits)
    return {"path": path, "bm": bm, "splits": -(-nkt // per), "kt_per_split": per}


def int8_weight_matmul_ref(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The plain version (the JAX package's formula): ``(x @ q) * scale``
    in ``x``'s dtype, the weight widened to it."""
    y = x @ q.to(x.dtype)
    return y * scale.to(y.dtype)


_fns: dict[str, object] = {}
_sms: dict[int, int] = {}  # device index -> SM count
# device index -> the split-K tile counters (int32, one per SM; zeroed once,
# and each split launch leaves them zero again) and the f32 workspace of the
# split-K partials (``sms x TILE_FLOATS``, the most any product needs).
# Both are allocated at the device's first product and never replaced, so
# a CUDA graph captured on them stays valid. Launches on one device run in
# stream order, so they never share them at once.
_counters: dict[int, torch.Tensor] = {}
_workspace: dict[int, torch.Tensor] = {}


def _device_state(dev: torch.device) -> int:
    """The SM count of ``dev``; allocates its counters and workspace at its
    first product, which must not be inside a CUDA graph capture (the
    zeroing would run only on replay, and the memory would be the graph's)."""
    sms = _sms.get(dev.index)
    if sms is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "int8-weight matmul: the first product on a device may not be captured into "
                "a CUDA graph; run one eagerly first (it allocates the split-K workspace)")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        _counters[dev.index] = torch.zeros((sms,), dtype=torch.int32, device=dev)
        _workspace[dev.index] = torch.empty((sms * TILE_FLOATS,), dtype=torch.float32,
                                            device=dev)
        _sms[dev.index] = sms
    return sms


def bind(lib: ctypes.CDLL) -> tuple:
    """``(matmul, error_string)`` of a built library, argument types set:
    every pointer and the stream as c_void_p (unset argtypes would pass
    Python ints as 32-bit C ints and cut 64-bit device pointers)."""
    fn = lib.w8_matmul
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_void_p]
                   + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.w8_error_string.argtypes = [ctypes.c_int]
    lib.w8_error_string.restype = ctypes.c_char_p
    return fn, lib.w8_error_string


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


def _launch(fn, err_str, x, q, scale, y, part, counters, M, K, N, p: dict,
            stream: int) -> None:
    """One call of the C entry; raises with the CUDA error on a refused
    launch, else counts it."""
    split = part is not None
    rc = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
            part.data_ptr() if split else None, part.numel() if split else 0,
            counters.data_ptr() if split else None, counters.numel() if split else 0,
            M, K, N, _DTYPE_CODES[x.dtype], _PATH_CODES[p["path"]], p["bm"], p["splits"],
            p["kt_per_split"], stream)
    if rc != 0:
        raise RuntimeError(
            f"int8-weight matmul launch failed: CUDA error {rc} ({err_str(rc).decode()})")
    LAUNCHES["int8_weight_matmul"] += 1
    PATH_LAUNCHES[f"w8_{p['path']}"] += 1
    if p["splits"] > 1:
        PATH_LAUNCHES["w8_splitk"] += 1


def int8_weight_matmul_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``(x @ q) * scale`` on the card: ``x [..., K]`` bf16 or f32, ``q [K,
    N]`` int8, ``scale [N]`` f32; returns ``[..., N]`` in ``x``'s dtype,
    summed in f32. Raises on anything the kernel does not take; there is no
    fallback."""
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x dtype {x.dtype} not supported (float32, bfloat16)")
    if q.dim() != 2 or x.shape[-1] != q.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} @ q {tuple(q.shape)}: contraction widths differ")
    K, N = q.shape
    lead = x.shape[:-1]
    M = math.prod(lead)
    dev = x.device
    x2 = x.reshape(M, K)
    if not x2.is_contiguous() or x2.data_ptr() % 16:  # a fresh copy is both
        x2 = x2.clone(memory_format=torch.contiguous_format)
    _check("x", x2, dev, (x.dtype,), (M, K))
    _check("q", q, dev, (torch.int8,), (K, N))
    _check("scale", scale, dev, (torch.float32,), (N,))
    p = plan(M, K, N, _device_state(dev))
    y = torch.empty((M, N), dtype=x.dtype, device=dev)
    if M == 0:
        return y.reshape(*lead, N)
    part = _workspace[dev.index] if p["splits"] > 1 else None
    fn, err_str = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(fn, err_str, x2, q, scale, y, part, _counters[dev.index], M, K, N, p, stream)
    return y.reshape(*lead, N)
