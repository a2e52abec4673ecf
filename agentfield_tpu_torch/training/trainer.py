"""The training step of the port — counterpart of
``agentfield_tpu/training/trainer.py``.

The JAX step is one jitted pure function ``(state, batch) -> (state,
metrics)`` over optax; here the state holds the param tree (leaves that
require grad), the torch optimizer over those leaves (built by a
``training.optim`` spec) and the step count, and a step runs the loss,
``backward`` and the optimizer in place, returning ``(state, metrics)`` as
the JAX step does. The forward is ``models.llama.forward(collect_kv=False,
remat=True)`` with the plain attention (``attn_impl="ref"``, float32
softmax), as the JAX trainer's ``attention_ref``: the hand-written kernels
have no backward, and ``attn_impl="kernel"`` raises under a gradient
(``ops.cuda.refuse_grad``), as ``jax.grad`` through the Pallas call does.

The mesh path of the JAX trainer (``attn_impl="ring"``, ``mesh=``,
``shard_batch``, the sharded init) needs more than one card and is not
ported (ROADMAP A5): asking for it raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from agentfield_tpu_torch.models.configs import LlamaConfig
from agentfield_tpu_torch.models.llama import forward, init_params
from agentfield_tpu_torch.training.optim import OptimizerSpec, spec_of


@dataclasses.dataclass
class TrainState:
    params: Any  # nested dict of leaves that require grad
    optimizer: torch.optim.Optimizer  # over named_leaves(params), in that order
    step: int = 0


def named_leaves(tree: dict[str, Any], prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """``(dotted name, tensor)`` of every leaf of a nested dict, in the
    tree's order (``layers.wq``, ``embed``, ...): the order of the
    optimizer's params and the names a checkpoint stores."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += named_leaves(v, f"{prefix}{k}.")
        else:
            out.append((f"{prefix}{k}", v))
    return out


def check_single_device(attn_impl: str, mesh) -> None:
    if attn_impl == "ring" or mesh is not None:
        raise NotImplementedError(
            "training over a mesh (attn_impl='ring', mesh=) needs more than one card and is "
            "not ported yet (ROADMAP A5)")


def state_from_params(params: Any, optimizer: OptimizerSpec) -> TrainState:
    """A step-0 state over ``params`` (each leaf set to require grad)."""
    leaves = [t.requires_grad_(True) for _, t in named_leaves(params)]
    return TrainState(params, optimizer(leaves), 0)


def causal_lm_loss(
    params: Any,
    cfg: LlamaConfig,
    batch: dict[str, torch.Tensor],
    attn_impl: str = "ref",
    mesh=None,
):
    """Masked next-token cross-entropy. batch: tokens/positions/targets
    ``[B, S]``; targets < 0 are ignored (padding). Returns ``(loss,
    {"loss", "tokens"})``, the loss averaged over the unmasked targets."""
    check_single_device(attn_impl, mesh)
    logits, _ = forward(params, cfg, batch["tokens"], batch["positions"], attn_impl=attn_impl,
                        collect_kv=False, remat=True)
    targets = batch["targets"]
    mask = (targets >= 0).float()
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.take_along_dim(logp, targets.clamp_min(0).long()[..., None], dim=-1)[..., 0]
    denom = mask.sum().clamp_min(1.0)
    loss = -(ll * mask).sum() / denom
    return loss, {"loss": loss, "tokens": mask.sum()}


def init_train_state(
    cfg: LlamaConfig,
    seed: int,
    optimizer: OptimizerSpec,
    mesh=None,
    dtype: str | torch.dtype | None = None,
    device: str | torch.device = "cuda",
) -> TrainState:
    """``models.llama.init_params`` (a seeded ``torch.Generator`` on
    ``device``) as a step-0 state."""
    check_single_device("ref", mesh)
    return state_from_params(init_params(cfg, seed=seed, dtype=dtype, device=device), optimizer)


def apply_step(state: TrainState, loss: torch.Tensor) -> None:
    """Backward from ``loss``, one optimizer update in place, the step
    count + 1; the gradients do not outlive the call."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    state.step += 1


def check_optimizer(state: TrainState, optimizer: OptimizerSpec) -> None:
    if spec_of(state.optimizer) != optimizer:
        raise ValueError(f"the state's optimizer is {spec_of(state.optimizer)}, the step's "
                         f"{optimizer}")


def make_train_step(
    cfg: LlamaConfig,
    optimizer: OptimizerSpec,
    attn_impl: str = "ref",
    mesh=None,
):
    """``train_step(state, batch) -> (state, metrics)``: the loss at the
    current params, their update in place (``state.optimizer``, which must
    have been built by ``optimizer``). ``metrics`` are detached 0-d
    tensors (reading one waits for the device)."""
    check_single_device(attn_impl, mesh)

    def train_step(state: TrainState, batch: dict[str, torch.Tensor]):
        check_optimizer(state, optimizer)
        loss, metrics = causal_lm_loss(state.params, cfg, batch, attn_impl)
        apply_step(state, loss)
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_lm_batch(tokens: torch.Tensor) -> dict[str, torch.Tensor]:
    """Standard next-token LM batch from ``[B, S]`` tokens: arange
    positions (int32), roll(-1) targets with the final column masked (-1
    sentinel)."""
    B, S = tokens.shape
    targets = torch.roll(tokens, -1, dims=1)
    targets[:, -1] = -1
    return {
        "tokens": tokens,
        "positions": torch.arange(S, dtype=torch.int32, device=tokens.device)[None].repeat(B, 1),
        "targets": targets,
    }
