"""Hand-written CUDA kernels for Hopper (sources in ``agentfield_tpu_torch/
csrc/``), their ctypes bindings and their launch counters. Nothing here
builds or loads a kernel at import time.

No kernel has a backward: a wrapper asked for a result that autograd would
differentiate raises (``refuse_grad``), as ``jax.grad`` through the JAX
package's ``pallas_call`` raises, instead of returning a result cut off from
its inputs' gradients."""

from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise ``NotImplementedError`` when grad mode is on and one of
    ``tensors`` requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the hand-written kernel has no backward; differentiate through the "
            "plain version (attn_impl='ref', fp weights), or call it under torch.no_grad()")
