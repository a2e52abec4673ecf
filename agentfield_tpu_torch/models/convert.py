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

Training state comes across too: ``lora_from_numpy`` takes a JAX adapter
tree (the JAX ``load_adapter``'s, read from its orbax artifact), and
``train_state_from_numpy`` a JAX ``TrainState`` with optax's Adam moments,
so a run started in the JAX package resumes on the port.
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


def _tree_from_numpy(tree: dict[str, Any], device, dtype=None) -> dict[str, Any]:
    """A nested dict of numpy arrays (ml_dtypes bfloat16 among them) as
    torch tensors on ``device``, each in ``dtype`` or in its own dtype,
    copied through float32 (exact for float32 and bfloat16)."""
    def move(a):
        if isinstance(a, dict):
            return {k: move(v) for k, v in a.items()}
        a = np.asarray(a)
        dt = resolve_dtype(dtype or str(a.dtype))
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=device, dtype=dt)

    return move(tree)


def lora_from_numpy(tree: dict[str, Any], lcfg, device: str | torch.device = "cuda"
                    ) -> dict[str, Any]:
    """The JAX package's adapter tree (``agentfield_tpu.training.lora.
    load_adapter``'s second element, as numpy: ``{"layers": {"<t>_a": [L,
    in, r], "<t>_b": [L, r, out]}}``) as the port's on ``device`` in
    ``lcfg.dtype``; raises where the tree's targets are not ``lcfg``'s."""
    names = sorted(tree["layers"])
    want = sorted(f"{t}_{s}" for t in lcfg.targets for s in "ab")
    if names != want:
        raise ValueError(f"adapter leaves {names} are not the targets' {want}")
    return _tree_from_numpy(tree, device, lcfg.dtype)


def train_state_from_numpy(params: dict[str, Any], opt_state: Any, step: Any, optimizer,
                           device: str | torch.device = "cuda"):
    """A JAX ``TrainState`` (``agentfield_tpu.training.trainer``), its leaves
    as numpy, as the port's ``TrainState`` on ``device``: ``params`` any
    nested dict (a model's tree or an adapter's), leaves in their own
    dtypes; ``optimizer`` the ``training.optim`` spec of the optax transform
    the state was made with. For Adam and AdamW, optax's
    ``ScaleByAdamState(count, mu, nu)`` (the first state of the chain)
    becomes each param's ``step`` (``count``), ``exp_avg`` (``mu``) and
    ``exp_avg_sq`` (``nu``); SGD has no state to carry."""
    from agentfield_tpu_torch.training.trainer import named_leaves, state_from_params

    state = state_from_params(_tree_from_numpy(params, device), optimizer)
    state.step = int(np.asarray(step))
    if optimizer.kind == "sgd":
        return state
    adam_state = next((s for s in opt_state if hasattr(s, "mu") and hasattr(s, "nu")), None)
    if adam_state is None:
        raise ValueError(f"no ScaleByAdamState (count, mu, nu) in the optax state {opt_state!r}")
    count = int(np.asarray(adam_state.count))
    if count == 0:
        return state  # no update yet: torch's Adam makes its moments at its first step
    mu, nu = dict(named_leaves(adam_state.mu)), dict(named_leaves(adam_state.nu))
    sd = state.optimizer.state_dict()
    for i, (name, p) in enumerate(named_leaves(state.params)):
        sd["state"][i] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.from_numpy(np.array(mu[name], dtype=np.float32)).to(p.dtype),
            "exp_avg_sq": torch.from_numpy(np.array(nu[name], dtype=np.float32)).to(p.dtype),
        }
    state.optimizer.load_state_dict(sd)
    return state
