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
unchanged for fp and quantized params alike. Both leaves (q ``[L, in,
out]`` int8, scale ``[L, out]`` f32) keep the stacked-layer axis, and
``QuantW[i]`` slices them in lockstep (``llama.layer``). Embeddings,
``lm_head``, norms and biases stay fp.
"""

from __future__ import annotations

from typing import Any

import torch

from agentfield_tpu_torch.ops.cuda.quant_matmul import (
    int8_weight_matmul_cuda,
    int8_weight_matmul_ref,
)

# The layer weight leaves of models.llama.init_params that carry the decode
# step's weight traffic (the JAX package's tuple).
QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def int8_weight_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``(x @ q) * scale``: the plain version for CPU tensors, the kernel
    for any other device (which raises on what it does not take: there is
    no fallback)."""
    if x.device.type == "cpu":
        return int8_weight_matmul_ref(x, q, scale)
    return int8_weight_matmul_cuda(x, q, scale)


class QuantW:
    """int8 weight + per-output-channel scale behaving like the fp matrix
    on the right side of ``@``."""

    __slots__ = ("q", "scale")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q  # [..., d_in, d_out] int8
        self.scale = scale  # [..., d_out] f32

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self):
        return self.q.ndim

    def __getitem__(self, i) -> QuantW:
        return QuantW(self.q[i], self.scale[i])

    def __rmatmul__(self, x: torch.Tensor) -> torch.Tensor:
        return int8_weight_matmul(x, self.q, self.scale)

    def expert_einsum(self, spec: str, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            "QuantW.expert_einsum (quantized MoE experts) is not ported yet: ROADMAP A3")

    def dequantize(self) -> torch.Tensor:
        """The fp approximation as a float32 tensor (tests only)."""
        return self.q.float() * self.scale[..., None, :]

    def __repr__(self):
        return f"QuantW(q={tuple(self.q.shape)} int8, scale={tuple(self.scale.shape)})"


def _quantize_matrix(w32: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    amax = w32.abs().amax(dim=-2)  # [..., d_out]
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale[..., None, :]), -127, 127).to(torch.int8)
    return q, scale


def quantize_weight(w: torch.Tensor) -> QuantW:
    """``[..., d_in, d_out]`` fp -> :class:`QuantW`, symmetric per output
    channel, the JAX formula: ``scale = max(amax, 1e-8) / 127``, ``q =
    clip(round(w / scale), -127, 127)`` (``torch.round`` rounds half to
    even, as ``jnp.round`` does). Each ``[d_in, d_out]`` matrix is
    quantized on its own device in turn, so a stacked full-width leaf never
    stages a float32 copy of the whole stack."""
    lead = w.shape[:-2]
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty((*lead, w.shape[-1]), dtype=torch.float32, device=w.device)
    wf, qf, sf = w.reshape(-1, *w.shape[-2:]), q.view(-1, *w.shape[-2:]), scale.view(-1, w.shape[-1])
    for i in range(wf.shape[0]):
        qf[i], sf[i] = _quantize_matrix(wf[i].float())
    return QuantW(q, scale)


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
