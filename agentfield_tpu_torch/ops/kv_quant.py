"""Quantized KV pages: int8 / fp8 values with one f32 scale per (token slot,
KV head) — the port's copy of the JAX package's ``ops/kv_quant.py``.

The format and the formula are the JAX module's, verbatim, so a pool
written by the port and one written by the JAX package hold the same bytes:

    scale = max(max_abs(vals over head_dim) * INV_QMAX, SCALE_FLOOR)
    int8:  q = clip(round(vals / scale), -127, 127)    # round half to even
    fp8:   q = (vals / scale).to(float8_e4m3fn)        # round to nearest even

Dequantization is ``q.float() * scale`` everywhere. The CUDA kernel's write
phase (``csrc/ragged_paged_attention.cu``) does the same operations in the
same order, so its pool bytes and scales equal ``kv_quantize``'s bit for bit.
Storage per (page, KV head): ``ps * hd`` bytes of values plus ``4 * ps`` of
scales, against ``2 * ps * hd`` for bf16.

Unlike the JAX functions, ``write_pages`` updates the pool in place.
"""

from __future__ import annotations

import typing

import torch

KV_QUANT_DTYPES = ("none", "int8", "fp8")

# fp8 storage is e4m3 (max normal 448), as in the JAX package.
_FP8_DTYPE = getattr(torch, "float8_e4m3fn", None)

QMAX = {"int8": 127.0, "fp8": 448.0}
# A multiply by the reciprocal, not a division by QMAX, as in the JAX
# package: float32 tensor * Python float multiplies by float32(1/QMAX) in
# both frameworks, and the CUDA kernel multiplies by the same float32 value.
INV_QMAX = {m: 1.0 / v for m, v in QMAX.items()}

SCALE_FLOOR = 1e-20  # all-zero vectors quantize to 0 with a harmless scale


class QuantPages(typing.NamedTuple):
    """A quantized page pool: values and per-slot scales.

    - ``q``     — ``[..., P, Kh, ps, hd]`` int8 / float8_e4m3fn values
    - ``scale`` — ``[..., P, Kh, ps]`` float32 per-(slot, KV head) scales

    The leading dims match (the engine stacks layers on axis 0)."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):  # the values' shape
        return self.q.shape


def quant_mode_supported(mode: str) -> bool:
    return mode in ("none", "int8") or (mode == "fp8" and _FP8_DTYPE is not None)


def quant_value_dtype(mode: str) -> torch.dtype:
    """torch dtype storing quantized values for ``mode`` (raises on 'none')."""
    if mode == "int8":
        return torch.int8
    if mode == "fp8":
        if _FP8_DTYPE is None:
            raise ValueError(
                "kv_quant_dtype='fp8' needs torch.float8_e4m3fn, which this "
                "torch build does not provide — use 'int8' or 'none'"
            )
        return _FP8_DTYPE
    raise ValueError(f"no quantized value dtype for mode {mode!r}")


def quant_mode_of(pages) -> str:
    """The kv-quant mode a pool operand encodes ('none' for plain tensors)."""
    if not isinstance(pages, QuantPages):
        return "none"
    return "int8" if pages.q.dtype == torch.int8 else "fp8"


def bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` as raw bytes when it is fp8 (else ``t`` itself): indexing and
    scatters move fp8 values through a uint8 view, because advanced indexing
    of float8 tensors is not implemented on every torch build."""
    return t.view(torch.uint8) if t.dtype == _FP8_DTYPE else t


def kv_quantize(vals: torch.Tensor, mode: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-slot quantization of ``vals [..., hd]`` -> ``(q [..., hd], scale
    [...])``: the one quantization formula (module docstring)."""
    f = vals.float()
    scale = torch.clamp_min(f.abs().amax(dim=-1) * INV_QMAX[mode], SCALE_FLOOR)
    y = f / scale[..., None]
    if mode == "int8":
        q = torch.clamp(torch.round(y), -127.0, 127.0).to(torch.int8)
    else:
        q = y.to(quant_value_dtype(mode))
    return q, scale


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``q [..., hd]`` + ``scale [...]`` -> float32 values."""
    return q.float() * scale[..., None]


def write_pages(pages, vals: torch.Tensor, page_ids: torch.Tensor, slot_ids: torch.Tensor) -> None:
    """Scatter per-token K or V vectors into a (possibly quantized) page pool,
    in place — the engine's dense-prefill write.

    ``pages`` is ``[L, P, Kh, ps, hd]`` (plain) or the matching
    :class:`QuantPages`; ``vals`` is ``[N, L, Kh, hd]`` for the 1-D
    ``page_ids``/``slot_ids`` of shape ``[N]`` (the value layout of
    ``pages[:, page_ids, :, slot_ids]``)."""
    if isinstance(pages, QuantPages):
        q, s = kv_quantize(vals, quant_mode_of(pages))
        bits(pages.q)[:, page_ids, :, slot_ids] = bits(q)
        pages.scale[:, page_ids, :, slot_ids] = s
    else:
        pages[:, page_ids, :, slot_ids] = vals.to(pages.dtype)
