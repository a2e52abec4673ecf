"""Carry weights from the JAX package into the port.

The port keeps the JAX parameter layout unchanged (stacked ``[L, in, out]``
layer leaves, ``embed [V, D]``, ``final_norm [D]``, optional ``lm_head
[D, V]`` and ``bq/bk/bv [L, n]``), so conversion is a dtype/device move —
no transposes, and logits of the two packages can be compared directly.
A quantized tree (the JAX package's ``quantize_params``) comes across as it
is: each ``QUANT_KEYS`` leaf that is a JAX ``QuantW`` (with numpy ``q`` and
``scale``, as ``jax.tree.map(np.asarray, tree)`` leaves it) or a ``(q,
scale)`` pair becomes the port's ``models.quant.QuantW``, q int8 and scale
float32 bit for bit: in the logical layout on the CPU, packed for the
kernel (``models.quant.pack_quantw``, matrix by matrix) on a CUDA device.
A MoE config (``num_experts > 0``) takes ``router [L, d, E]`` (always fp)
and the expert stacks ``w_gate``/``w_up [L, E, d, f]``, ``w_down [L, E, f,
d]``, fp or quantized (scale ``[L, E, out]``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from agentfield_tpu_torch.models.configs import LlamaConfig
from agentfield_tpu_torch.models.llama import Params, resolve_dtype
from agentfield_tpu_torch.models.quant import QUANT_KEYS, QuantW, pack_quantw

_LAYER_LEAVES = ("attn_norm", "mlp_norm", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_BIAS_LEAVES = ("bq", "bk", "bv")


def params_from_numpy(
    tree: dict[str, Any],
    cfg: LlamaConfig,
    device: str | torch.device = "cuda",
    dtype: str | torch.dtype | None = None,
) -> Params:
    """Turn the JAX package's param pytree, as numpy arrays (e.g.
    ``jax.tree.map(np.asarray, agentfield_tpu.models.llama.init_params(cfg,
    key))``), into the port's params on ``device`` in ``dtype`` (default:
    ``cfg.dtype``). Raises on a missing leaf or a shape that does not match
    ``cfg``."""
    dt = resolve_dtype(dtype or cfg.dtype)
    L, d, f, v = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    E = cfg.num_experts
    ex = (L, E) if E > 0 else (L,)  # the expert axis after the layer axis
    shapes = {
        "attn_norm": (L, d), "mlp_norm": (L, d),
        "wq": (L, d, cfg.q_dim), "wk": (L, d, cfg.kv_dim), "wv": (L, d, cfg.kv_dim),
        "wo": (L, cfg.q_dim, d),
        "w_gate": (*ex, d, f), "w_up": (*ex, d, f), "w_down": (*ex, f, d),
        "router": (L, d, E),
        "bq": (L, cfg.q_dim), "bk": (L, cfg.kv_dim), "bv": (L, cfg.kv_dim),
    }

    def move(a, shape, name):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"param {name}: shape {a.shape} != expected {shape}")
        # through float32 (numpy has no bfloat16; ml_dtypes arrays upcast
        # exactly), copied: JAX hands out read-only buffers
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=device, dtype=dt)

    def exact(a, shape, dtype, name):  # a CPU tensor
        a = np.asarray(a)
        if tuple(a.shape) != tuple(shape) or a.dtype != dtype:
            raise ValueError(f"param {name}: {a.dtype} {a.shape} != expected {dtype} {shape}")
        return torch.from_numpy(np.array(a))

    def leaf(n):
        w = layers_in[n]
        if n in QUANT_KEYS and (hasattr(w, "q") or isinstance(w, tuple)):
            q, scale = (w.q, w.scale) if hasattr(w, "q") else w
            qw = QuantW(exact(q, shapes[n], np.int8, f"layers.{n}.q"),
                        exact(scale, shapes[n][:-2] + shapes[n][-1:], np.float32,
                              f"layers.{n}.scale"))
            if torch.device(device).type == "cuda":
                return pack_quantw(qw, device)
            return QuantW(qw.q.to(device), qw.scale.to(device))
        return move(w, shapes[n], f"layers.{n}")

    layers_in = tree["layers"]
    names = (_LAYER_LEAVES + (("router",) if E > 0 else ())
             + (_BIAS_LEAVES if cfg.attn_bias else ()))
    out: Params = {
        "embed": move(tree["embed"], (v, d), "embed"),
        "layers": {n: leaf(n) for n in names},
        "final_norm": move(tree["final_norm"], (d,), "final_norm"),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = move(tree["lm_head"], (d, v), "lm_head")
    return out


def tower_params_from_numpy(
    tree: dict[str, Any],
    cfg: Any,
    device: str | torch.device = "cuda",
    dtype: str | torch.dtype | None = None,
) -> dict[str, Any]:
    """The JAX package's params of a vision tower, an audio tower, a TTS
    head or an image-generation head, as numpy arrays (``jax.tree.map(
    np.asarray, init_vision_params(cfg, key))`` and the like), as the
    port's tree of the same keys and shapes on ``device`` in ``dtype``
    (default: ``cfg.dtype``, the config of that tower or head)."""
    dt = resolve_dtype(dtype or cfg.dtype)

    def move(a):
        if isinstance(a, dict):
            return {k: move(v) for k, v in a.items()}
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=device, dtype=dt)

    return move(tree)
