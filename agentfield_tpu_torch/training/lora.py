"""LoRA fine-tuning: low-rank adapters over the stacked-layer param tree —
counterpart of ``agentfield_tpu/training/lora.py``.

Adapters attach to the stacked layer weights (``[L, in, out]`` → ``a: [L,
in, r]``, ``b: [L, r, out]`` with ``b`` zero-initialised, so step 0 is
exactly the base model). The loss merges ``w + a @ b * alpha/rank`` per step
(``merge_lora``) and runs the one forward; the node merges the same way
once at load (``serving.model_node.build_model_node(lora=)``): one merge
definition, so training and serving cannot drift. Gradients and optimizer
moments exist only for the adapters; the base tree is a frozen input and
stays bit-identical.

Merging happens on fp weights, before any quantization: a ``QuantW`` base
leaf raises ``ValueError`` (quantizing first would freeze the base).

The adapter artifact (``save_adapter``) is the port's own:
``adapter.safetensors`` (the port's safetensors writer, ``models.
hf_loader``; tensor names ``layers.<target>_a`` / ``_b``) and
``lora_config.json`` with the JAX file's keys (rank, alpha, targets, dtype,
shapes, dtypes). A JAX artifact (an orbax ``adapter/`` directory) is carried
across with ``models.convert.lora_from_numpy`` from the JAX
``load_adapter``'s tree. ``lora_pspecs`` (the adapters' TP shardings) waits
for the mesh (ROADMAP A5).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any

import torch

from agentfield_tpu_torch.models.configs import LlamaConfig
from agentfield_tpu_torch.models.llama import resolve_dtype
from agentfield_tpu_torch.training.optim import OptimizerSpec
from agentfield_tpu_torch.training.trainer import (
    TrainState,
    apply_step,
    causal_lm_loss,
    check_optimizer,
    check_single_device,
    state_from_params,
)

# target name → (in_dim, out_dim) resolver over the config
_TARGET_DIMS = {
    "wq": lambda c: (c.hidden_size, c.q_dim),
    "wk": lambda c: (c.hidden_size, c.kv_dim),
    "wv": lambda c: (c.hidden_size, c.kv_dim),
    "wo": lambda c: (c.q_dim, c.hidden_size),
    "w_gate": lambda c: (c.hidden_size, c.intermediate_size),
    "w_up": lambda c: (c.hidden_size, c.intermediate_size),
    "w_down": lambda c: (c.intermediate_size, c.hidden_size),
}
ADAPTER_FILE = "adapter.safetensors"
CONFIG_FILE = "lora_config.json"


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0
    targets: tuple[str, ...] = ("wq", "wk", "wv", "wo")
    dtype: str = "float32"  # adapters train in f32 regardless of base dtype

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _check_targets(cfg: LlamaConfig, lcfg: LoRAConfig) -> None:
    unknown = set(lcfg.targets) - set(_TARGET_DIMS)
    if unknown:
        raise ValueError(f"unknown LoRA targets {sorted(unknown)}; have {sorted(_TARGET_DIMS)}")
    if cfg.num_experts > 0 and set(lcfg.targets) & {"w_gate", "w_up", "w_down"}:
        raise ValueError(
            "MoE expert stacks are not LoRA targets (per-expert adapters are "
            "not implemented) — target the attention projections instead"
        )
    if lcfg.rank < 1:
        raise ValueError(f"rank={lcfg.rank} must be >= 1")


def init_lora_params(cfg: LlamaConfig, lcfg: LoRAConfig, seed: int = 0,
                     device: str | torch.device = "cuda") -> dict[str, Any]:
    """Adapter tree: ``{"layers": {"<t>_a": [L, in, r], "<t>_b": [L, r,
    out]}}`` in ``lcfg.dtype`` on ``device``. ``a`` is normal with std
    ``1 / r`` (drawn in float32 from a seeded ``torch.Generator``), ``b``
    zero: the merged model is the base model at step 0."""
    _check_targets(cfg, lcfg)
    dt = resolve_dtype(lcfg.dtype)
    L, r = cfg.num_layers, lcfg.rank
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    layers: dict[str, torch.Tensor] = {}
    for t in lcfg.targets:
        d_in, d_out = _TARGET_DIMS[t](cfg)
        a = torch.empty((L, d_in, r), dtype=torch.float32, device=device).normal_(generator=g)
        layers[f"{t}_a"] = (a * (1.0 / r)).to(dt)
        layers[f"{t}_b"] = torch.zeros((L, r, d_out), dtype=dt, device=device)
    return {"layers": layers}


def merge_lora(params: dict[str, Any], lora: dict[str, Any], lcfg: LoRAConfig) -> dict[str, Any]:
    """base + adapters → merged params (same tree shape as the base): each
    target ``(base.float() + (a @ b) * scale).to(base.dtype)``, the product
    in float32. Used per step inside the LoRA loss and once at serve time.
    Differentiable in the adapters; a ``QuantW`` base raises ``ValueError``
    (merge before quantizing)."""
    merged_layers = dict(params["layers"])
    for name, a in lora["layers"].items():
        if not name.endswith("_a"):
            continue
        t = name[:-2]
        b = lora["layers"][t + "_b"]
        base = merged_layers[t]
        if not isinstance(base, torch.Tensor):
            raise ValueError(
                f"LoRA target {t} is {type(base).__name__}: adapters merge into fp weights, "
                "before quantization")
        delta = torch.einsum("lir,lro->lio", a.float(), b.float())
        merged_layers[t] = (base.float() + delta * lcfg.scale).to(base.dtype)
    return {**params, "layers": merged_layers}


def make_lora_train_step(
    cfg: LlamaConfig,
    lcfg: LoRAConfig,
    optimizer: OptimizerSpec,
    attn_impl: str = "ref",
    mesh=None,
):
    """``lora_step(state, base_params, batch) -> (state, metrics)``:
    gradients and moments only for the adapters (``state`` is a
    ``TrainState`` over the adapter tree, ``init_lora_state``); the base
    params are read detached and never written."""
    _check_targets(cfg, lcfg)
    check_single_device(attn_impl, mesh)

    def lora_step(state: TrainState, base_params: dict[str, Any],
                  batch: dict[str, torch.Tensor]):
        from agentfield_tpu_torch.models.llama import detached

        check_optimizer(state, optimizer)
        merged = merge_lora(detached(base_params), state.params, lcfg)
        loss, metrics = causal_lm_loss(merged, cfg, batch, attn_impl)
        del merged  # the graph holds what the backward needs
        apply_step(state, loss)
        return state, {k: v.detach() for k, v in metrics.items()}

    return lora_step


def init_lora_state(
    cfg: LlamaConfig,
    lcfg: LoRAConfig,
    seed: int,
    optimizer: OptimizerSpec,
    mesh=None,
    device: str | torch.device = "cuda",
) -> TrainState:
    check_single_device("ref", mesh)
    return state_from_params(init_lora_params(cfg, lcfg, seed, device), optimizer)


def save_adapter(path, lora: dict[str, Any], lcfg: LoRAConfig) -> None:
    """Persist an adapter as a standalone artifact: ``adapter.safetensors``
    and ``lora_config.json`` (the LoRAConfig and every leaf's shape and
    dtype, the JAX file's keys), so ``load_adapter`` needs no model config.
    Re-saving into one directory overwrites it."""
    from agentfield_tpu_torch.models.hf_loader import write_safetensors

    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    layers = lora["layers"]
    write_safetensors(path / ADAPTER_FILE, [
        (f"layers.{k}", tuple(v.shape), v.dtype, lambda v=v: v.detach())
        for k, v in layers.items()])
    meta = {
        "rank": lcfg.rank,
        "alpha": lcfg.alpha,
        "targets": list(lcfg.targets),
        "dtype": lcfg.dtype,
        "shapes": {k: list(v.shape) for k, v in layers.items()},
        "dtypes": {k: str(v.dtype).removeprefix("torch.") for k, v in layers.items()},
    }
    (path / CONFIG_FILE).write_text(json.dumps(meta, indent=1))


def load_adapter(path, device: str | torch.device = "cuda") -> tuple[LoRAConfig, dict[str, Any]]:
    """Inverse of ``save_adapter``: ``(LoRAConfig, adapter tree)`` on
    ``device``, each leaf checked against the recorded shape and dtype. A
    directory with only a JAX artifact (orbax ``adapter/``) raises
    ``ValueError``."""
    from agentfield_tpu_torch.models.hf_loader import SafetensorsFile

    path = Path(path).absolute()
    if not (path / ADAPTER_FILE).exists():
        if (path / "adapter").is_dir():
            raise ValueError(
                f"{path} holds a JAX (orbax) adapter; carry it across with "
                "agentfield_tpu_torch.models.convert.lora_from_numpy and save_adapter")
        raise FileNotFoundError(f"no {ADAPTER_FILE} under {path}")
    meta = json.loads((path / CONFIG_FILE).read_text())
    lcfg = LoRAConfig(
        rank=int(meta["rank"]),
        alpha=float(meta["alpha"]),
        targets=tuple(meta["targets"]),
        dtype=meta["dtype"],
    )
    st = SafetensorsFile(path / ADAPTER_FILE)
    try:
        layers = {}
        for k, shape in meta["shapes"].items():
            t = st.get(f"layers.{k}")
            want = (tuple(shape), resolve_dtype(meta["dtypes"][k]))
            if (tuple(t.shape), t.dtype) != want:
                raise ValueError(f"{path}: adapter leaf {k} is {t.dtype} {tuple(t.shape)}, "
                                 f"{CONFIG_FILE} says {want[1]} {want[0]}")
            layers[k] = t.to(device=device, copy=True)
    finally:
        st.close()
    return lcfg, {"layers": layers}
