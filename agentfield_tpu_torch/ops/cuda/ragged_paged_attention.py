"""Wrappers of the hand-written ragged paged-attention kernel
(``csrc/ragged_paged_attention.cu``) — counterparts of the JAX package's
``ragged_paged_attention_pallas`` and ``dense_causal_attention``
(``agentfield_tpu/ops/pallas/ragged_paged_attention_kernel.py:267,485``).
The ragged wrapper takes plain bf16/f32 pools or int8/fp8 pools with
per-slot scales (``ops.kv_quant``); the quantized launches are counted
under their own keys.

A wrapper given CUDA tensors checks them, launches the kernel on the current
stream and counts the launch in ``LAUNCHES``; anything the kernel does not
take raises, as does a launch the runtime refuses. ``PATH_LAUNCHES``
counts the launches by the kernel's path: ``ragged_tiles_tc`` (bf16
tensor-core tile: dense, chunked and suffix prefill), ``ragged_tiles_f32``
(f32 CUDA-core tile), and ``ragged_decode_split`` plus
``ragged_decode_combine`` (decode: split-context partials, then their
merge; the wrapper allocates the partials' scratch with ``torch.empty``
per call: an engine decode step captured in a CUDA graph thus holds it in
the graph's private pool, reused by every replay). A launch recorded into a
CUDA graph counts once, at capture; the graph's owner adds its launches per
replay (``launch_counts``, ``add_launches``, which also cover the int8-weight
matmul's counters in ``ops.cuda.quant_matmul``). Given CPU tensors,
``dense_causal_attention`` runs its plain version (``models.llama.
attention_ref``); ``ragged_paged_attention_cuda`` takes CUDA tensors only —
the dispatcher ``ops.paged_attention.ragged_paged_attention`` picks the
plain version for CPU tensors. Neither wrapper takes inputs that require
grad under grad mode (``ops.cuda.refuse_grad``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from agentfield_tpu_torch.models.llama import attention_ref
from agentfield_tpu_torch.ops.cuda import build, refuse_grad
from agentfield_tpu_torch.ops.cuda import quant_matmul as _qm
from agentfield_tpu_torch.ops.kernel_autotune import lookup_blocks

SUPPORTED_HEAD_DIMS = build.ATTENTION_HEAD_DIMS  # one library per head dim
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# quantized pool value dtype -> (pool code of the C entry, mode)
_QUANT_POOLS = {torch.int8: (2, "int8")}
if hasattr(torch, "float8_e4m3fn"):
    _QUANT_POOLS[torch.float8_e4m3fn] = (3, "fp8")

# Launch counts per wrapper and pool kind: +1 each time a wrapper launches
# its kernel.
LAUNCHES = {
    "ragged_paged_attention": 0,
    "ragged_paged_attention_int8": 0,
    "ragged_paged_attention_fp8": 0,
    "dense_causal_attention": 0,
}
# Launch counts per kernel path (``afp_attention_path``: 1 tensor-core tile,
# 2 split decode + combine, 3 f32 tile), over every wrapper and pool kind.
PATH_LAUNCHES = {
    "ragged_tiles_tc": 0,
    "ragged_tiles_f32": 0,
    "ragged_decode_split": 0,
    "ragged_decode_combine": 0,
}
_PATH_KEYS = {1: ("ragged_tiles_tc",), 2: ("ragged_decode_split", "ragged_decode_combine"),
              3: ("ragged_tiles_f32",)}
# every hand-written kernel's counters: this module's and the int8-weight
# matmul's (``ops.cuda.quant_matmul``), so that a graph's owner and a run's
# reader take them all together
_COUNTERS = (LAUNCHES, PATH_LAUNCHES, _qm.LAUNCHES, _qm.PATH_LAUNCHES)


def reset_launches() -> None:
    for d in _COUNTERS:
        for k in d:
            d[k] = 0


def launch_counts() -> dict[str, int]:
    """Every counter of every hand-written kernel (``LAUNCHES``,
    ``PATH_LAUNCHES`` and ``quant_matmul``'s) as one flat dict."""
    return {k: n for d in _COUNTERS for k, n in d.items()}


def add_launches(counts: dict[str, int], sign: int = 1) -> None:
    """Add ``sign`` times ``counts`` (as ``launch_counts`` gives them) to the
    counters: a CUDA graph's launches, once per replay."""
    for d in _COUNTERS:
        for k in d:
            d[k] += sign * counts.get(k, 0)


_entry_fns: dict[int, tuple] = {}


def bind(lib: ctypes.CDLL, hd: int) -> tuple:
    """The C entry points of a built attention library for head dim ``hd``,
    with their argument types set: ``(attention, error_string, path,
    decode_part_floats)``."""
    fn = lib.afp_ragged_paged_attention
    # every pointer and the stream as c_void_p: unset argtypes would pass
    # Python ints as 32-bit C ints and cut 64-bit device pointers
    fn.argtypes = (
        [ctypes.c_void_p] * 14 + [ctypes.c_longlong] + [ctypes.c_int] * 9
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.afp_error_string.argtypes = [ctypes.c_int]
    lib.afp_error_string.restype = ctypes.c_char_p
    lib.afp_attention_path.argtypes = [ctypes.c_int] * 4
    lib.afp_attention_path.restype = ctypes.c_int
    lib.afp_decode_part_floats.argtypes = [ctypes.c_int] * 7
    lib.afp_decode_part_floats.restype = ctypes.c_longlong
    lib.afp_head_dim.restype = ctypes.c_int
    if lib.afp_head_dim() != hd:
        raise RuntimeError(f"library for head_dim {hd} was built for {lib.afp_head_dim()}")
    return fn, lib.afp_error_string, lib.afp_attention_path, lib.afp_decode_part_floats


def _entry(hd: int):
    fns = _entry_fns.get(hd)
    if fns is None:
        fns = _entry_fns[hd] = bind(build.load(f"ragged_paged_attention.hd{hd}"), hd)
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


def _launch(q, k_new, v_new, k_pages, v_pages, k_scales, v_scales, out, page_tables,
            row_starts, n_tokens, ctx_lens, seq_ids, sm_scale, window, write_kv,
            counter: str) -> None:
    """Check every operand, launch on the current stream, count the launch
    under ``LAUNCHES[counter]``; raise on anything refused. ``k_scales`` and
    ``v_scales`` are None for a plain pool (of q's dtype), or the f32
    ``[P, Kh, ps]`` scales of an int8/fp8 pool."""
    R, W, H, hd = q.shape
    P, Kh, ps, _ = k_pages.shape
    maxp = page_tables.shape[1]
    dev = q.device
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"q dtype {q.dtype} not supported (float32, bfloat16)")
    if H % Kh:
        raise ValueError(f"num_heads {H} not divisible by num_kv_heads {Kh}")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported by the kernel {SUPPORTED_HEAD_DIMS}")
    fdt = (q.dtype,)
    _check("q", q, dev, fdt, (R, W, H, hd))
    _check("k_new", k_new, dev, fdt, (R, W, Kh, hd))
    _check("v_new", v_new, dev, fdt, (R, W, Kh, hd))
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be passed together")
    if k_scales is None:
        pdt, pool_code = fdt, _DTYPE_CODES[q.dtype]
    else:
        if k_pages.dtype not in _QUANT_POOLS:
            raise ValueError(
                f"quantized pool dtype {k_pages.dtype} not in {tuple(_QUANT_POOLS)}"
            )
        pdt, pool_code = (k_pages.dtype,), _QUANT_POOLS[k_pages.dtype][0]
        for nm, t in (("k_scales", k_scales), ("v_scales", v_scales)):
            _check(nm, t, dev, (torch.float32,), (P, Kh, ps))
    _check("k_pages", k_pages, dev, pdt, (P, Kh, ps, hd))
    _check("v_pages", v_pages, dev, pdt, (P, Kh, ps, hd))
    _check("out", out, dev, fdt, (R, W, H, hd))
    i32 = (torch.int32,)
    _check("page_tables", page_tables, dev, i32, (R, maxp))
    for nm, t in (("row_starts", row_starts), ("n_tokens", n_tokens),
                  ("ctx_lens", ctx_lens), ("seq_ids", seq_ids)):
        _check(nm, t, dev, i32, (R,))
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be >= 1 or None")
    if R == 0 or W == 0:
        return  # no work: nothing launched, nothing counted
    fn, err_str, path_of, part_floats = _entry(hd)
    dcode = _DTYPE_CODES[q.dtype]
    path = path_of(W, H, Kh, dcode)
    n_part = part_floats(R, W, H, Kh, ps, maxp, hd)
    # decode partials (m, l, acc per split), f32, written before they are read
    part = torch.empty((n_part,), dtype=torch.float32, device=dev) if n_part else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(),
            None if k_scales is None else k_scales.data_ptr(),
            None if v_scales is None else v_scales.data_ptr(),
            out.data_ptr(), page_tables.data_ptr(),
            row_starts.data_ptr(), n_tokens.data_ptr(), ctx_lens.data_ptr(),
            seq_ids.data_ptr(), None if part is None else part.data_ptr(), n_part,
            R, W, H, Kh, ps, maxp, hd, dcode, pool_code,
            float(hd**-0.5 if sm_scale is None else sm_scale),
            int(window or 0), int(write_kv), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"ragged paged-attention launch failed: CUDA error {rc} "
            f"({err_str(rc).decode()})"
        )
    LAUNCHES[counter] += 1
    for key in _PATH_KEYS[path]:
        PATH_LAUNCHES[key] += 1


def ragged_paged_attention_cuda(
    q: torch.Tensor,  # [R, W, H, hd]
    k_new: torch.Tensor,  # [R, W, Kh, hd]
    v_new: torch.Tensor,  # [R, W, Kh, hd]
    k_pages: torch.Tensor,  # [P, Kh, ps, hd] (int8/fp8 with scales) — in place
    v_pages: torch.Tensor,  # [P, Kh, ps, hd] — updated in place
    page_tables: torch.Tensor,  # [R, maxp] int32
    row_starts: torch.Tensor,  # [R] int32
    n_tokens: torch.Tensor,  # [R] int32 (0 = padding row)
    ctx_lens: torch.Tensor,  # [R] int32 — keys already in the pool per row
    seq_ids: torch.Tensor,  # [R] int32 — launch-local sequence identity
    k_scales: torch.Tensor | None = None,  # [P, Kh, ps] f32 — in place
    v_scales: torch.Tensor | None = None,
    sm_scale: float | None = None,
    window: int | None = None,
):
    """Fused ragged paged attention + KV write on the card. Returns ``(out
    [R, W, H, hd], k_pages, v_pages)`` — plus ``(k_scales, v_scales)`` for a
    quantized pool — with the new K/V written into the pools in place
    (slots of padding tokens and of positions past the page table are not
    written). A quantized pool (int8 or float8_e4m3fn values with f32
    per-slot scales) is dequantized and quantized inside the kernel. Page
    ids in ``page_tables`` must lie in ``[0, P)``: they are not checked,
    which would cost a device read per launch."""
    refuse_grad("ragged_paged_attention_cuda", q, k_new, v_new)
    out = torch.empty_like(q)
    counter = "ragged_paged_attention"
    if k_scales is not None and k_pages.dtype in _QUANT_POOLS:
        counter += "_" + _QUANT_POOLS[k_pages.dtype][1]
    _launch(q, k_new, v_new, k_pages, v_pages, k_scales, v_scales, out, page_tables,
            row_starts, n_tokens, ctx_lens, seq_ids, sm_scale, window, write_kv=True,
            counter=counter)
    if k_scales is not None:
        return out, k_pages, v_pages, k_scales, v_scales
    return out, k_pages, v_pages


def dense_causal_attention(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, S, Kh, hd]
    v: torch.Tensor,  # [B, S, Kh, hd]
    window: int | None = None,
) -> torch.Tensor:
    """Dense causal self-attention through the ragged kernel, packed as the
    JAX package packs it: each batch row becomes ``ceil(S / block_q)``
    same-``seq_id`` rows with ``ctx_lens == 0``, so the whole computation
    runs in the kernel's new-key phase (with causal block skipping). The
    pool is never read and nothing is written to it. CPU tensors take the
    plain ``models.llama.attention_ref`` over per-row arange positions.
    Returns ``[B, S, H, hd]``. Raises ``NotImplementedError`` on any
    device when grad mode is on and q, k or v requires grad (the kernel has
    no backward; ``forward(attn_impl="ref")`` trains)."""
    refuse_grad("dense_causal_attention", q, k, v)
    if not q.is_cuda:
        B, S = q.shape[:2]
        pos = torch.arange(S, device=q.device).expand(B, S)
        valid = torch.ones((B, S), dtype=torch.bool, device=q.device)
        return attention_ref(q, k, v, pos, pos, valid, window=window)
    B, S, H, hd = q.shape
    Kh = k.shape[2]
    W = max(1, min(lookup_blocks(page_size=128, head_dim=hd, bucket=S).block_q, S))
    nw = -(-S // W)
    if nw * W > S:
        pad = (0, 0, 0, 0, 0, nw * W - S)
        q, k, v = F.pad(q, pad), F.pad(k, pad), F.pad(v, pad)
    R = B * nw
    qr = q.reshape(R, W, H, hd).contiguous()
    kr = k.reshape(R, W, Kh, hd).contiguous()
    vr = v.reshape(R, W, Kh, hd).contiguous()
    dev = q.device
    offs = torch.arange(nw, dtype=torch.int32, device=dev) * W
    starts = offs.repeat(B)
    n_toks = (S - offs).clamp(0, W).repeat(B)
    seqs = torch.arange(B, dtype=torch.int32, device=dev).repeat_interleave(nw)
    ctx = torch.zeros((R,), dtype=torch.int32, device=dev)  # empty pool: never read
    tables = torch.zeros((R, 1), dtype=torch.int32, device=dev)
    pool = torch.zeros((1, Kh, 1, hd), dtype=q.dtype, device=dev)
    out = torch.empty_like(qr)
    _launch(qr, kr, vr, pool, pool, None, None, out, tables, starts, n_toks, ctx, seqs,
            None, window, write_kv=False, counter="dense_causal_attention")
    return out.reshape(B, nw * W, H, hd)[:, :S]
