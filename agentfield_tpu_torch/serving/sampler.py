"""Token sampling — counterpart of ``agentfield_tpu/serving/sampler.py``.

Same strategies per row as the JAX sampler: greedy (temperature <= 0), full
tempered sampling, and top-k / top-p inside a ``k_max``-wide candidate set
with the exact full-vocab fallback for top-p-only rows whose nucleus is
wider than the candidates. Randomness comes from an explicit
``torch.Generator`` (Gumbel-max over ``torch.rand`` draws), so sampled
tokens differ from the JAX package's threefry draws; greedy rows are
argmax and match exactly.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0  # 0 → greedy
    top_k: int = 0  # 0 → disabled
    top_p: float = 1.0  # 1 → disabled
    max_new_tokens: int = 128
    stop_token_ids: tuple[int, ...] = ()

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")


def _categorical(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(x) (Gumbel-max; -inf entries never win)."""
    u = torch.rand(x.shape, generator=generator, device=x.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))
    return torch.argmax(x + gumbel, dim=-1)


SAMPLER_VARIANTS = ("greedy", "sampled", "truncated")


def sampler_variant(temperatures, top_ks, top_ps) -> str:
    """Which branch of ``sample_tokens`` a batch needs, from host values of
    its per-row knobs: "greedy" (no row samples), "truncated" (some row has
    top-k or top-p) or "sampled". A CUDA graph of a decode step is keyed by
    it, so the captured step reads no device value to choose."""
    temps, ks, ps = (torch.as_tensor(t) for t in (temperatures, top_ks, top_ps))
    if not bool((temps > 0).any()):
        return "greedy"
    return "truncated" if bool(((ks > 0) | (ps < 1.0)).any()) else "sampled"


def sample_tokens(
    logits: torch.Tensor,  # [B, V] float32
    generator: torch.Generator,  # on logits' device
    temperatures: torch.Tensor,  # [B] float32; <= 0 → greedy for that row
    top_ks: torch.Tensor,  # [B] int; 0 → disabled (applied as a top-k_max prefilter)
    top_ps: torch.Tensor,  # [B] float32; >= 1 → disabled
    k_max: int = 64,
    variant: str | None = None,
) -> torch.Tensor:
    """Mixed-strategy sampling, one token per row (int32 [B]).

    ``variant`` (``SAMPLER_VARIANTS``) names the branch; None reads it from
    the knobs passed in (``sampler_variant``): pass them as CPU tensors and
    an all-greedy batch costs one argmax and no device synchronisation. With
    ``variant`` given nothing is read back from the device, so the call can
    be captured in a CUDA graph: the truncated variant computes the exact
    wide-nucleus draw for every row and keeps it where a row needs it (the
    JAX sampler's ``lax.cond``), the same values a branch on
    ``need_exact.any()`` gives."""
    B, V = logits.shape
    k_max = min(k_max, V)
    dev = logits.device
    if variant is None:
        variant = sampler_variant(temperatures, top_ks, top_ps)
    if variant not in SAMPLER_VARIANTS:
        raise ValueError(f"unknown sampler variant {variant!r}; have {SAMPLER_VARIANTS}")
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if variant == "greedy":
        return greedy
    temps_d = temperatures.to(dev, torch.float32)
    top_ks_d = top_ks.to(dev)
    top_ps_d = top_ps.to(dev, torch.float32)
    temps = temps_d.clamp(min=1e-6)[:, None]
    full = _categorical(logits / temps, generator).to(torch.int32)
    sampled = full
    if variant == "truncated":
        vals, idxs = torch.topk(logits, k_max, dim=-1)  # [B, k_max] descending
        scaled = vals / temps
        ranks = torch.arange(k_max, device=dev)[None, :]
        k_eff = torch.where(
            top_ks_d[:, None] > 0, top_ks_d[:, None].clamp(max=k_max), k_max
        )
        k_mask = ranks < k_eff
        probs = torch.softmax(scaled.masked_fill(~k_mask, float("-inf")), dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        p_mask = (cum - probs) < top_ps_d.clamp(max=1.0)[:, None]
        masked = scaled.masked_fill(~(k_mask & p_mask), float("-inf"))
        choice = _categorical(masked, generator)
        trunc = torch.gather(idxs, 1, choice[:, None])[:, 0].to(torch.int32)
        # exact wide-nucleus fallback: a top-p-only row whose k_max candidates
        # hold less tempered mass than its top_p samples the full sorted vocab
        cand_mass = torch.exp(
            torch.logsumexp(scaled, dim=-1) - torch.logsumexp(logits / temps, dim=-1)
        )
        need_exact = (top_ks_d == 0) & (top_ps_d < 1.0) & (cand_mass < top_ps_d)
        order = torch.argsort(logits, dim=-1, descending=True)  # [B, V]
        svals = torch.gather(logits, 1, order) / temps
        p_full = torch.softmax(svals, dim=-1)
        cum_f = torch.cumsum(p_full, dim=-1)
        keep = (cum_f - p_full) < top_ps_d[:, None]
        ch = _categorical(svals.masked_fill(~keep, float("-inf")), generator)
        exact = torch.gather(order, 1, ch[:, None])[:, 0].to(torch.int32)
        trunc = torch.where(need_exact, exact, trunc)
        sampled = torch.where((top_ks_d > 0) | (top_ps_d < 1.0), trunc, full)
    return torch.where(temps_d <= 0, greedy, sampled)
