"""Weight-only int8 quantization for serving — counterpart of
``agentfield_tpu/models/quant.py``.

A decode step streams every layer weight from device memory while the
activations stay tiny, so fewer bytes a weight is a direct lever on the
step's time. Per-output-channel symmetric int8: ``w ≈ q * scale`` with
``scale[j] = max_i |w[i, j]| / 127``. The scale is constant along the
contraction axis, so ``x @ (q * s) == (x @ q) * s``: the product runs on the
int8 weights and one ``[d_out]`` rescale follows. The bf16 weight matrix is
never materialized on the card: CUDA tensors go through the hand-written
kernel (``ops.cuda.quant_matmul``, ``csrc/int8_weight_matmul.cu``), which
reads q as int8 and widens it in registers; CPU tensors run its plain
version, the JAX formula ``(x @ q.to(x.dtype)) * scale.to(x.dtype)``.

:class:`QuantW` stands on the right of ``@`` like the fp matrix
(``Tensor.__matmul__`` returns NotImplemented for it, so Python calls
``QuantW.__rmatmul__``): ``x @ lp["wq"]`` in ``models/llama.py`` works
unchanged for fp and quantized params alike. Both leaves keep the
stacked-layer axis, and ``QuantW[i]`` slices them in lockstep
(``llama.layer``). Embeddings, ``lm_head``, norms and biases stay fp.

Which layout ``QuantW.q`` holds depends on its device. On the CPU it is the
JAX package's, ``[L, in, out]`` int8, so every CPU comparison with
``agentfield_tpu/models/quant.py`` holds it unchanged. On a CUDA device it is
the kernel's packed layout (``ops.cuda.quant_matmul.pack_int8_weight``,
``[L, panels, K chunks, 2048]``: the same bytes for Llama-3-8B's widths),
made once, matrix by matrix, when ``quantize_weight`` quantizes on the card
or ``models.convert`` carries a quantized tree there; ``QuantW.packed``
records it (the logical ``(in, out)``, or None). ``shape`` is the logical
shape either way, and ``__getitem__`` past the layer axes, ``dequantize``
and the plain version read a packed q through ``unpack_int8_weight``.

A MoE expert stack (``[L, E, d_in, d_out]``, Mixtral) keeps its expert axis
after the layer axis, packed per matrix (``[L, E, panels, K chunks,
2048]``); ``QuantW[l][e]`` is one expert's packed matrix and scale row.
``expert_einsum`` is the port of the JAX ``QuantW.expert_einsum``: on the
card, one kernel launch per expert, the outputs stacked in the spec's
layout.
"""

from __future__ import annotations

from typing import Any

import torch

from agentfield_tpu_torch.ops.cuda import refuse_grad
from agentfield_tpu_torch.ops.cuda.quant_matmul import (
    int8_weight_matmul_cuda,
    int8_weight_matmul_ref,
    pack_int8_weight,
    packed_shape,
    unpack_int8_weight,
)

# The layer weight leaves of models.llama.init_params that carry the decode
# step's weight traffic (the JAX package's tuple).
QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def int8_weight_matmul(x: torch.Tensor, w: QuantW) -> torch.Tensor:
    """``(x @ q) * scale``: the plain version for CPU tensors (on the
    logical layout), the kernel for any other device (which takes the
    packed layout and raises on what it does not take: there is no
    fallback). On either device an ``x`` that requires grad under grad mode
    raises ``NotImplementedError``: the kernel has no backward, and the
    plain version refuses it too, so the CPU shows what the card would."""
    refuse_grad("QuantW product", x)
    if x.device.type == "cpu":
        return int8_weight_matmul_ref(x, w.logical(), w.scale)
    return int8_weight_matmul_cuda(x, w.q, w.scale)


class QuantW:
    """int8 weight + per-output-channel scale behaving like the fp matrix
    on the right side of ``@``."""

    __slots__ = ("q", "scale", "packed")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor,
                 packed: tuple[int, int] | None = None):
        self.q = q  # [..., d_in, d_out] int8, or the packed [..., panels, K chunks, 2048]
        self.scale = scale  # [..., d_out] f32
        self.packed = packed  # the logical (d_in, d_out) of a packed q, else None

    @property
    def shape(self):
        if self.packed is None:
            return self.q.shape
        return torch.Size((*self.scale.shape[:-1], *self.packed))

    @property
    def ndim(self):
        return len(self.shape)

    def logical(self) -> torch.Tensor:
        """q in the logical ``[..., d_in, d_out]`` layout (unpacked, a copy,
        if packed)."""
        return self.q if self.packed is None else unpack_int8_weight(self.q, *self.packed)

    def __getitem__(self, i) -> QuantW:
        if self.packed is None:
            return type(self)(self.q[i], self.scale[i])
        if self.scale.dim() > 1:  # the layer (or expert) axes
            return type(self)(self.q[i], self.scale[i], self.packed)
        return type(self)(self.logical()[i], self.scale[i])

    def __rmatmul__(self, x: torch.Tensor) -> torch.Tensor:
        return int8_weight_matmul(x, self)

    # soft-routing specs ([B, E, S, out] outputs) and sparse-dispatch buffer
    # specs ([E, C, out] outputs); the JAX package's tuple
    _EXPERT_SPECS = (
        "bsd,edf->besf", "besf,efd->besd", "ecd,edf->ecf", "ecf,efd->ecd",
    )

    def expert_einsum(self, spec: str, x: torch.Tensor) -> torch.Tensor:
        """``einsum(spec, x, w)`` over one layer's ``[E, d_in, d_out]``
        expert stack, the weight the second operand; only the specs of
        ``models.llama._moe_mlp`` are taken (another spec raises
        ``ValueError``: its scale would broadcast against the wrong axis).
        CPU tensors run the JAX formula, ``einsum(spec, x, q.to(x.dtype)) *
        scale[..., :, None, :]``. On the card every expert is one launch of
        the int8-weight kernel on its packed matrix and scale row (under
        "bsd,edf->besf" every expert takes the same x), the outputs stacked
        on the spec's expert axis."""
        if spec not in self._EXPERT_SPECS:
            raise ValueError(
                f"expert_einsum supports {self._EXPERT_SPECS}, got {spec!r}")
        refuse_grad("QuantW.expert_einsum", x)
        if x.device.type == "cpu":
            y = torch.einsum(spec, x, self.logical().to(x.dtype))
            return y * self.scale[..., :, None, :].to(y.dtype)
        E = self.scale.shape[0]
        if spec.startswith("e"):  # [E, C, d_in] buffers -> [E, C, d_out]
            return torch.stack([x[e] @ self[e] for e in range(E)])
        if spec.startswith("bsd"):  # [B, S, d_in], shared -> [B, E, S, d_out]
            return torch.stack([x @ self[e] for e in range(E)], dim=1)
        return torch.stack([x[:, e] @ self[e] for e in range(E)], dim=1)  # [B, E, S, .]

    def dequantize(self) -> torch.Tensor:
        """The fp approximation as a float32 tensor (tests only)."""
        return self.logical().float() * self.scale[..., None, :]

    def __repr__(self):
        layout = "" if self.packed is None else f", packed {tuple(self.q.shape)}"
        return (f"QuantW(q={tuple(self.shape)} int8{layout}, "
                f"scale={tuple(self.scale.shape)})")


def pack_quantw(w: QuantW, device: str | torch.device | None = None) -> QuantW:
    """``w`` on ``device`` (default: where it is) with its q in the kernel's
    packed layout, moved and packed matrix by matrix, so the device never
    holds a second int8 stack; an already packed ``w`` only moves."""
    device = w.q.device if device is None else torch.device(device)
    if w.packed is not None:
        return QuantW(w.q.to(device), w.scale.to(device), w.packed)
    *lead, K, N = w.q.shape
    q = torch.empty((*lead, *packed_shape(K, N)), dtype=torch.int8, device=device)
    src, dst = w.q.reshape(-1, K, N), q.view(-1, *packed_shape(K, N))
    for i in range(src.shape[0]):
        dst[i] = pack_int8_weight(src[i].to(device))
    return QuantW(q, w.scale.to(device), (K, N))


def _quantize_matrix(w32: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    amax = w32.abs().amax(dim=-2)  # [..., d_out]
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale[..., None, :]), -127, 127).to(torch.int8)
    return q, scale


def _quantize_stack(shape, device: torch.device, matrix, shard=None) -> QuantW:
    """A :class:`QuantW` of logical ``shape`` ``[..., d_in, d_out]`` on
    ``device``, filled matrix by matrix: ``matrix(i)`` gives the i-th fp
    ``[d_in, d_out]`` matrix (leading axes flattened), which is quantized
    and, on a CUDA device, packed into its slot before the next is made.
    ``shard=(spec, tp, rank)`` (the leaf's partition spec) keeps one
    tensor-parallel rank's slice: each matrix is quantized whole, then q and
    its scale are cut as ``parallel.sharding.shard_quantw`` cuts them, then
    packed."""
    *lead, K, N = shape
    cut = None
    if shard is not None:
        from agentfield_tpu_torch.parallel.sharding import shard_tensor

        spec, tp, rank = shard
        q_spec, s_spec = spec[-2:], spec[-1:]
        K = K // tp if q_spec[0] is not None else K
        N = N // tp if q_spec[1] is not None else N

        def cut(qi, si):
            return shard_tensor(qi, q_spec, tp, rank), shard_tensor(si, s_spec, tp, rank)
    pack = device.type == "cuda"
    q = torch.empty((*lead, *packed_shape(K, N)) if pack else (*lead, K, N), dtype=torch.int8,
                    device=device)
    scale = torch.empty((*lead, N), dtype=torch.float32, device=device)
    qf, sf = q.view(-1, *q.shape[len(lead):]), scale.view(-1, N)
    for i in range(sf.shape[0]):
        qi, si = _quantize_matrix(matrix(i).float())
        if cut is not None:
            qi, si = cut(qi, si)
        sf[i] = si
        qf[i] = pack_int8_weight(qi) if pack else qi
    return QuantW(q, scale, (K, N) if pack else None)


def quantize_weight(w: torch.Tensor) -> QuantW:
    """``[..., d_in, d_out]`` fp -> :class:`QuantW`, symmetric per output
    channel, the JAX formula: ``scale = max(amax, 1e-8) / 127``, ``q =
    clip(round(w / scale), -127, 127)`` (``torch.round`` rounds half to
    even, as ``jnp.round`` does). Each ``[d_in, d_out]`` matrix is
    quantized on its own device in turn, so a stacked full-width leaf never
    stages a float32 copy of the whole stack; on a CUDA device each is
    packed as it is quantized (the kernel's layout: no second int8 stack is
    held)."""
    wf = w.reshape(-1, *w.shape[-2:])
    return _quantize_stack(w.shape, w.device, lambda i: wf[i])


def init_quantized(shape, dtype: torch.dtype, device: torch.device,
                   generator: torch.Generator, shard=None) -> QuantW:
    """A random :class:`QuantW` of logical ``shape``: each ``[d_in,
    d_out]`` matrix drawn from ``generator`` (normal, std 0.02, as
    ``llama.init_params`` draws) in ``dtype`` on ``device``, then quantized
    and packed as ``quantize_weight`` does, one matrix at a time — the fp
    stack is never held whole (``llama.init_params(quantize=True)``).
    ``shard`` keeps one tensor-parallel rank's slice (``_quantize_stack``)."""
    K, N = shape[-2:]

    def draw(_):
        return torch.empty((K, N), dtype=dtype, device=device).normal_(
            0.0, 0.02, generator=generator)

    return _quantize_stack(shape, torch.device(device), draw, shard)


def quantize_params(params: dict[str, Any]) -> dict[str, Any]:
    """Quantize the layer weight matrices (``QUANT_KEYS``) of a param dict
    in ``models.llama.init_params``'s layout. Idempotent; every other leaf
    passes through untouched."""
    out = dict(params)
    layers = dict(params["layers"])
    for k in QUANT_KEYS:
        w = layers.get(k)
        if w is not None and not isinstance(w, QuantW):
            layers[k] = quantize_weight(w)
    out["layers"] = layers
    return out


def is_quantized(params: dict[str, Any]) -> bool:
    return any(isinstance(params.get("layers", {}).get(k), QuantW) for k in QUANT_KEYS)
