"""The optimizers of the training slice: counterparts of the optax
transforms the JAX package's trainer and tests use (``optax.sgd``,
``optax.adam``, ``optax.adamw``).

Each constructor returns an :class:`OptimizerSpec`: a frozen record of the
hyperparameters that builds a ``torch.optim.Optimizer`` over a list of
leaves when called (``spec(params)``), as an optax transform is ``init``-ed
over a param tree. The spec, not the torch object, is what a trainer is made
with and what a checkpoint records.

The update rules are optax's, in torch's implementation (the default one:
a loop over tensors on the CPU, ``foreach`` on CUDA; neither ``fused`` nor
``capturable``):

- ``sgd``: ``p -= lr * g``.
- ``adam``: ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g²``, ``p -=
  lr * m̂ / (√v̂ + eps)`` with the bias corrections of step t; optax's
  ``eps_root`` is 0, as here.
- ``adamw``: optax's ``chain(scale_by_adam, add_decayed_weights(wd),
  scale_by_learning_rate(lr))`` gives ``p -= lr * (m̂ / (√v̂ + eps) + wd *
  p)``, which is torch's decoupled ``p *= 1 - lr * wd`` followed by the Adam
  step. The weight decay defaults to optax's 1e-4, not torch's 0.01.

Moments are kept in each parameter's dtype, as optax keeps ``mu`` and ``nu``
when ``mu_dtype`` is unset.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import torch

KINDS = ("sgd", "adam", "adamw")


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    kind: str  # "sgd" | "adam" | "adamw"
    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown optimizer {self.kind!r}; have {KINDS}")

    def __call__(self, params: Iterable[torch.Tensor]) -> torch.optim.Optimizer:
        params = list(params)
        if self.kind == "sgd":
            return torch.optim.SGD(params, lr=self.lr)
        cls = torch.optim.Adam if self.kind == "adam" else torch.optim.AdamW
        return cls(params, lr=self.lr, betas=(self.b1, self.b2), eps=self.eps,
                   weight_decay=self.weight_decay)


def sgd(lr: float) -> OptimizerSpec:
    return OptimizerSpec("sgd", lr)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> OptimizerSpec:
    return OptimizerSpec("adam", lr, b1, b2, eps)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> OptimizerSpec:
    return OptimizerSpec("adamw", lr, b1, b2, eps, weight_decay)


def spec_of(optimizer: torch.optim.Optimizer) -> OptimizerSpec:
    """The spec a torch optimizer built by an :class:`OptimizerSpec` was
    built from (its first param group's hyperparameters)."""
    g = optimizer.param_groups[0]
    if isinstance(optimizer, torch.optim.SGD):
        return OptimizerSpec("sgd", g["lr"])
    kind = {torch.optim.AdamW: "adamw", torch.optim.Adam: "adam"}.get(type(optimizer))
    if kind is None:
        raise ValueError(f"{type(optimizer).__name__} is not an optimizer of this module")
    b1, b2 = g["betas"]
    return OptimizerSpec(kind, g["lr"], b1, b2, g["eps"], g["weight_decay"])
