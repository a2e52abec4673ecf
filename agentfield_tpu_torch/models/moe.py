"""Mixture-of-Experts FFN in PyTorch — counterpart of
``agentfield_tpu/models/moe.py`` (single device; the expert-parallel
``shard_map`` bodies are not ported).

Expert weights carry a leading ``[E, ...]`` axis. Two formulations share
that layout:

- **soft routing** (``moe_ffn`` / ``moe_impl="dense"``): every expert
  computes for every token and a top-k-masked softmax weights the outputs.
  Exact (no token is ever dropped) but pays E/top_k times the FFN FLOPs.
- **capacity-based sparse dispatch** (``moe_ffn_sparse`` /
  ``moe_impl="sparse"``): each token's top-k expert choices are scattered
  into a per-expert ``[E, capacity, D]`` buffer (token-major priority:
  earlier tokens win slots), each expert runs on its buffer only, and a
  gather + weighted sum combines. Tokens past an expert's capacity lose
  that expert's contribution; agreement with soft routing is exact whenever
  nothing drops.

Every shape is static (no data-dependent sizes, no host reads), so the soft
path records into a CUDA graph. Top-k uses ``torch.topk(..., sorted=True)``:
``jax.lax.top_k`` returns its k values in descending order with ties to the
lower index; ``torch.topk`` promises the order but not the tie-break, which
random float32 router logits never reach.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    hidden_size: int
    expert_intermediate: int
    num_experts: int
    top_k: int = 2  # router mass concentrates on k experts (soft weights)


def moe_ffn(params: dict[str, Any], cfg: MoEConfig, x: torch.Tensor) -> torch.Tensor:
    """Soft-routed reference. x: [B, S, D] -> [B, S, D]."""
    logits = (x @ params["router"]).float()  # [B, S, E]
    mask = topk_router_weights(logits, cfg.top_k)
    h = torch.einsum("bsd,edf->besf", x, params["w_in"])
    h = F.silu(h.float()).to(x.dtype)
    y = torch.einsum("besf,efd->besd", h, params["w_out"])
    return torch.einsum("besd,bse->bsd", y.float(), mask).to(x.dtype)


def topk_router_weights(logits: torch.Tensor, k: int) -> torch.Tensor:
    """``[..., E]`` router logits -> ``[..., E]`` routing weights: softmax
    over the top-k logits, zero elsewhere (HF Mixtral's softmax -> top-k ->
    renormalize)."""
    top, idx = torch.topk(logits, k, dim=-1, sorted=True)
    return torch.zeros_like(logits).scatter(-1, idx, torch.softmax(top, dim=-1))


def expert_capacity(
    num_tokens: int, num_experts: int, top_k: int, capacity_factor: float
) -> int:
    """Per-expert slot count for sparse dispatch, never below top_k."""
    return max(top_k, math.ceil(num_tokens * top_k / num_experts * capacity_factor))


def sparse_plan(
    logits: torch.Tensor, k: int, capacity: int, valid: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``[N, E]`` router logits -> token-major dispatch plan ``(experts,
    slots, keep, weights)``, each ``[N * k]`` (entry ``m`` is token
    ``m // k``'s choice ``m % k``): the chosen expert, the entry's rank
    among earlier entries choosing that expert, whether that rank fits under
    ``capacity``, and the softmax routing weight.

    ``valid`` ([N] bool) excludes tokens from dispatch: their entries route
    to the out-of-range expert E, take no rank, and ``keep`` masks them out
    of the combine (prefill padding must not take capacity from real
    tokens)."""
    n, e_total = logits.shape
    top, idx = torch.topk(logits, k, dim=-1, sorted=True)  # [N, k]
    weights = torch.softmax(top, dim=-1)
    experts = idx.reshape(-1)  # [M]
    if valid is not None:
        experts = torch.where(valid.repeat_interleave(k), experts, e_total)
    onehot = F.one_hot(experts, e_total + 1)[:, :e_total]  # expert E: a zero row
    ranks = torch.cumsum(onehot, dim=0) - onehot  # rank within each expert
    slots = torch.gather(ranks, 1, experts.clamp(max=e_total - 1)[:, None])[:, 0]
    keep = (slots < capacity) & (experts < e_total)
    return experts, slots, keep, weights.reshape(-1)


def dispatch_tokens(
    xt: torch.Tensor, experts: torch.Tensor, slots: torch.Tensor, num_experts: int,
    capacity: int,
) -> torch.Tensor:
    """Scatter ``[N, D]`` tokens into ``[E, C, D]`` per-expert buffers.
    torch has no scatter that drops out-of-range indices, so the entries
    past capacity (or routed to expert E) are sent to one spare row past
    the buffers, which is cut off: kept entries have distinct (expert,
    slot) pairs, and nothing reads the device back."""
    k = experts.shape[0] // xt.shape[0]
    d = xt.shape[-1]
    x_rep = xt.repeat_interleave(k, dim=0)  # [M, D]
    keep = (experts < num_experts) & (slots < capacity)
    flat = torch.where(keep, experts * capacity + slots, num_experts * capacity)
    buf = xt.new_zeros((num_experts * capacity + 1, d))
    buf.index_put_((flat,), x_rep)
    return buf[: num_experts * capacity].view(num_experts, capacity, d)


def combine_tokens(
    y: torch.Tensor,
    experts: torch.Tensor,
    slots: torch.Tensor,
    keep: torch.Tensor,
    weights: torch.Tensor,
    k: int,
) -> torch.Tensor:
    """Gather ``[E, C, D]`` expert outputs back to tokens and weight-sum the
    k choices: ``[N, D]`` float32."""
    ec = experts.clamp(max=y.shape[0] - 1)
    sc = slots.clamp(max=y.shape[1] - 1)
    ym = y[ec, sc].float() * (weights * keep)[:, None]
    return ym.reshape(-1, k, y.shape[-1]).sum(dim=1)


def moe_ffn_sparse(
    params: dict[str, Any],
    cfg: MoEConfig,
    x: torch.Tensor,
    capacity_factor: float = 2.0,
    capacity: int | None = None,
) -> torch.Tensor:
    """Capacity-based sparse-dispatch MoE FFN. x: [B, S, D]. Equal to
    :func:`moe_ffn` whenever no expert overflows."""
    b, s, d = x.shape
    n = b * s
    if capacity is None:
        capacity = expert_capacity(n, cfg.num_experts, cfg.top_k, capacity_factor)
    xt = x.reshape(n, d)
    logits = (xt @ params["router"]).float()  # [N, E]
    experts, slots, keep, weights = sparse_plan(logits, cfg.top_k, capacity)
    buf = dispatch_tokens(xt, experts, slots, cfg.num_experts, capacity)
    h = torch.einsum("ecd,edf->ecf", buf, params["w_in"])
    h = F.silu(h.float()).to(x.dtype)
    y = torch.einsum("ecf,efd->ecd", h, params["w_out"])
    out = combine_tokens(y, experts, slots, keep, weights, cfg.top_k)
    return out.reshape(b, s, d).to(x.dtype)
