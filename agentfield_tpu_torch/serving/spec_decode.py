"""Speculative decoding over the paged KV cache — counterpart of the JAX
engine's ``_spec_decode_fn`` (``agentfield_tpu/serving/engine.py``).

One spec step: the DRAFT model runs ``k + 1`` decode steps (proposals
``d_1..d_k``, and one more step that writes ``d_k``'s KV into the draft pool
for the case where everything is accepted); the TARGET verifies them in one
``(k + 1)``-wide forward, one ragged row of ``W = k + 1`` tokens per
sequence over its cached context with the KV write fused; each row emits its
accepted prefix and a correction token, 1..k+1 tokens per target pass.

Per-row modes, as in the JAX step:

- greedy (temperature <= 0): accept while the proposal equals the target's
  argmax; the correction is the target's argmax (plain greedy, token for
  token);
- plain temperature (no top-k, top-p 1): Leviathan rejection sampling,
  accept ``d`` when ``u * q(d) < p(d)`` over the tempered target ``p`` and
  draft ``q``; on rejection sample the residual ``max(p - q, 0)`` (``p``
  itself when it sums to at most 1e-9); after full acceptance sample ``p``;
- truncated (top-k or top-p): proposals are always rejected and the
  correction comes from ``sample_tokens`` on the first verify position.

Both models share the page tables and lengths; each has its own pool on the
same page ids. Every attention call goes through ``ops.paged_attention.
ragged_paged_attention`` (the hand-written kernel on the card: the draft's
W = 1 rows on the split-context path, the verify on the path its ``W * rep``
picks). Random numbers come from the caller's ``torch.Generator`` through
``torch.rand`` (Gumbel-max for categorical draws), never a call that reads
the device back, so the whole step can be captured in one CUDA graph. The
``variant`` of ``sample_tokens`` (``sampler_variant`` of the batch) decides
what the step draws: a greedy batch draws nothing.
"""

from __future__ import annotations

import typing

import torch

from agentfield_tpu_torch.models import llama
from agentfield_tpu_torch.models.configs import LlamaConfig
from agentfield_tpu_torch.ops.paged_attention import ragged_paged_attention
from agentfield_tpu_torch.serving.kv_cache import PagedKVCache
from agentfield_tpu_torch.serving.sampler import _categorical, sample_tokens


class PagedModel(typing.NamedTuple):
    """A model with its paged KV pool and its binding sliding window; under
    tensor parallelism one rank's slices and its ``parallel.mesh.Mesh``."""

    params: dict
    cfg: LlamaConfig
    cache: PagedKVCache
    window: int | None
    mesh: typing.Any = None


def rows_forward(m: PagedModel, tokens: torch.Tensor, starts: torch.Tensor,
                 n_tokens: torch.Tensor, page_tables: torch.Tensor,
                 unembed: bool = True) -> torch.Tensor | None:
    """Forward of one ragged row per sequence: row b's tokens ``[B, W]`` at
    positions ``starts[b] + j`` over ``starts[b]`` cached keys, its first
    ``n_tokens[b]`` valid (0: an inert padding row, nothing written). Each
    layer's attention is one ragged launch with the KV write fused. Returns
    the logits ``[B, W, V]`` (float32), or None without ``unembed``."""
    cfg, mesh = m.cfg, m.mesh
    B, W = tokens.shape
    x = llama.embed_tokens(m.params, cfg, tokens, mesh)  # [B, W, D]
    positions = starts[:, None] + torch.arange(W, dtype=starts.dtype, device=starts.device)
    cos, sin = llama.rope_sincos(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    row_ids = torch.arange(B, dtype=torch.int32, device=tokens.device)
    for i in range(cfg.num_layers):
        lp = llama.layer(m.params, i)
        h = llama.rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        q, k, v = llama.qkv_proj(lp, h, cfg, cos, sin)  # [B, W, ...]
        attn, _, _ = ragged_paged_attention(
            q, k, v, *m.cache.layer(i), page_tables, starts, n_tokens, starts, row_ids,
            window=m.window, mesh=mesh,
        )
        x = llama.attn_out(lp, attn, x, mesh)
        x = x + llama.mlp_block(lp, x, cfg, mesh=mesh)
    return llama.unembed(m.params, cfg, x, mesh) if unembed else None


class SpecOut(typing.NamedTuple):
    emitted: torch.Tensor  # [W, B] int32: row b's first counts[b] are its tokens
    logprobs: torch.Tensor  # [W, B] float32, raw-logit log-softmax
    counts: torch.Tensor  # [B] int32: tokens emitted (0 for a padding row)
    new_seq_lens: torch.Tensor  # [B] int32
    next_tokens: torch.Tensor  # [B] int64: each row's last emitted token


def spec_step(
    target: PagedModel,
    draft: PagedModel,
    tokens: torch.Tensor,  # [B] int64: each row's last token (its KV not yet written)
    seq_lens: torch.Tensor,  # [B] int32: cached tokens; 0 = padding row
    page_tables: torch.Tensor,  # [B, maxp] int32, shared by both pools
    temps: torch.Tensor,  # [B] float32
    top_ks: torch.Tensor,  # [B] int32
    top_ps: torch.Tensor,  # [B] float32
    k: int,
    generator: torch.Generator,
    variant: str,
    share=None,
) -> SpecOut:
    """One speculative step (module docstring); writes both pools in place.
    Under tensor parallelism ``share`` (the mesh's ``broadcast``) gives
    every rank rank 0's decisions: each proposal, the accepted counts and
    the corrections; a worker's own draws are overwritten by them."""
    share = share or (lambda t: t)
    B = tokens.shape[0]
    W = k + 1
    dev = tokens.device
    active = seq_lens > 0
    sampled = variant != "greedy"
    step = active.to(seq_lens.dtype)
    t = temps.clamp(min=1e-6)[:, None]
    drafts, qs = [], []
    toks, lens = tokens, seq_lens
    for s in range(k + 1):
        last = s == k  # writes d_k's KV; its proposal is not used
        logits = rows_forward(draft, toks[:, None], lens, step, page_tables, unembed=not last)
        lens = lens + step
        if last:
            break
        logits = logits[:, 0]
        nt = torch.argmax(logits, dim=-1)
        if sampled:
            scaled = logits / t
            qs.append(torch.softmax(scaled, dim=-1))  # tempered draft distribution
            nt = torch.where(temps <= 0, nt, _categorical(scaled, generator))
        nt = share(nt)
        drafts.append(nt)
        toks = nt
    dmat = torch.stack(drafts, dim=1)  # [B, k] = d_1..d_k
    x_tokens = torch.cat([tokens[:, None], dmat], dim=1)  # [B, W]
    n_w = torch.where(active, W, 0).to(seq_lens.dtype)
    logits = rows_forward(target, x_tokens, seq_lens, n_w, page_tables)  # [B, W, V]
    V = logits.shape[-1]
    greedy_row = temps <= 0
    match = dmat == torch.argmax(logits[:, :k], dim=-1)
    if sampled:
        truncated_row = (top_ks > 0) | (top_ps < 1.0)
        p = torch.softmax(logits / t[:, :, None], dim=-1)  # [B, W, V] tempered target
        qstack = torch.stack(qs, dim=1)  # [B, k, V]
        p_d = torch.gather(p[:, :k], 2, dmat[..., None])[..., 0]
        q_d = torch.gather(qstack, 2, dmat[..., None])[..., 0]
        u = torch.rand((B, k), generator=generator, device=dev, dtype=torch.float32)
        # u < p/q written as u * q < p: robust at q -> 0
        match = torch.where(greedy_row[:, None], match, ~truncated_row[:, None] & (u * q_d < p_d))
    m = share(torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1))  # [B] accepted, 0..k
    at_m = m[:, None, None].expand(B, 1, V)
    l_m = torch.gather(logits, 1, at_m)[:, 0]  # [B, V] the correction position
    c = torch.argmax(l_m, dim=-1)  # greedy rows (and sample_tokens' greedy)
    if sampled:
        p_m = torch.gather(p, 1, at_m)[:, 0]
        # full acceptance (m == k) has no proposal there: q is zero, the residual is p
        q_m = torch.gather(torch.cat([qstack, torch.zeros_like(qstack[:, :1])], dim=1), 1, at_m)[:, 0]
        residual = (p_m - q_m).clamp(min=0.0)
        resid = torch.where(residual.sum(dim=-1, keepdim=True) > 1e-9, residual, p_m)
        resid_tok = _categorical(
            torch.where(resid > 0, torch.log(resid.clamp(min=1e-30)), float("-inf")), generator)
        if variant == "truncated":
            c = sample_tokens(l_m, generator, temps, top_ks, top_ps, variant=variant).long()
        c = torch.where(~greedy_row & ~truncated_row, resid_tok, c)
    c = share(c)
    t_idx = torch.arange(W, device=dev)[None]
    dmat_pad = torch.cat([dmat, torch.zeros_like(dmat[:, :1])], dim=1)
    emitted = torch.where(t_idx < m[:, None], dmat_pad, c[:, None])  # [B, W]
    lps = torch.gather(torch.log_softmax(logits, dim=-1), 2, emitted[..., None])[..., 0]
    counts = torch.where(active, m + 1, 0).to(torch.int32)
    return SpecOut(
        emitted=emitted.to(torch.int32).T, logprobs=lps.T, counts=counts,
        new_seq_lens=seq_lens + counts.to(seq_lens.dtype),
        next_tokens=torch.where(active, c, tokens),
    )
