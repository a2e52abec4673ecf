"""Ragged paged attention with the KV write fused in — counterpart of
``agentfield_tpu/ops/paged_attention.py``: the one attention entry point of
the serving engine.

Every forward the engine issues (decode, chunked/suffix prefill) is a batch
of *ragged rows*: R rows of up to W query tokens, each row at its own start
position over its own page table, with its own count of already-cached
keys. ``ragged_paged_attention`` consumes that descriptor and writes each
row's new K/V into the paged pool in the same call.

- ``ragged_paged_attention_ref`` — the plain PyTorch version: scatter the new
  K/V into the pool, then a page-gather masked attention. It is what CPU
  tensors run and what the CUDA kernel is held against on the card.
- ``ops/cuda/ragged_paged_attention.py`` — the hand-written CUDA kernel
  (``csrc/ragged_paged_attention.cu``), which CUDA tensors run.
- ``decode_split_plan``, ``decode_partials_ref`` and ``merge_partials_ref``
  — the plain versions of the kernel's split-context decode: which cached
  keys each split CTA takes, the online-softmax partial ``(m, l, acc)`` of
  each split (and of the launch's own keys), and the combine step that
  merges them. ``ragged_paged_attention_split_ref`` chains the three.

Pools are plain tensors or, with ``EngineConfig.kv_quant_dtype``, int8/fp8
values with per-slot f32 scales (``ops.kv_quant``): both versions
dequantize cached pages on the way in and quantize the new K/V on the way
out with the shared ``kv_quantize`` formula. The pools (and scales) are
updated IN PLACE by both versions (the JAX functions return new arrays);
both still return ``(out, k_pages, v_pages)`` (plus the two scales when
quantized).

Descriptor invariants (``serving.kv_cache.pack_ragged_rows`` builds them):
row r's queries sit at absolute positions ``[row_starts[r], row_starts[r] +
n_tokens[r])``; ``n_tokens[r] == 0`` marks a padding row (zero output, no
writes); ``ctx_lens[r]`` keys of the row's sequence are already in the pool,
and positions ``[ctx_lens[r], row_starts[r])`` are covered by earlier rows of
the same launch carrying the same ``seq_ids[r]``; pages are looked up as
``page_tables[r, pos // page_size]``, and positions past the table route to
the garbage page 0 (the plain version) or are not written (the kernel) —
page 0's content is undefined either way.
"""

from __future__ import annotations

import typing

import torch

from agentfield_tpu_torch.ops.kv_quant import QuantPages, bits, kv_dequantize, kv_quantize

_NEG_INF = -1e30
# Cached keys per split CTA of the decode path (DEC_SPLIT in
# csrc/ragged_paged_attention.cu).
DECODE_SPLIT = 256


class RaggedRows(typing.NamedTuple):
    """Host-side ragged forward descriptor (one kernel launch), numpy."""

    tokens: typing.Any  # [R, W] int32 token ids (model input, not consumed here)
    page_tables: typing.Any  # [R, maxp] int32
    row_starts: typing.Any  # [R] int32 — absolute position of row r's first query
    n_tokens: typing.Any  # [R] int32 — valid queries in row r (0 = padding row)
    ctx_lens: typing.Any  # [R] int32 — keys already in the pool for row r's seq
    seq_ids: typing.Any  # [R] int32 — launch-local sequence identity (-1 padding)
    last_flat: list  # flat token index of each packed entry's LAST token


def ragged_paged_attention_ref(
    q: torch.Tensor,  # [R, W, H, hd]
    k_new: torch.Tensor,  # [R, W, Kh, hd]
    v_new: torch.Tensor,  # [R, W, Kh, hd]
    k_pages: torch.Tensor,  # [P, Kh, ps, hd] (int8/fp8 when scales are passed) — in place
    v_pages: torch.Tensor,  # [P, Kh, ps, hd] — updated in place
    page_tables: torch.Tensor,  # [R, maxp] int32
    row_starts: torch.Tensor,  # [R] int32
    n_tokens: torch.Tensor,  # [R] int32
    ctx_lens: torch.Tensor,  # [R] int32 (unused: the scatter-first pool already
    seq_ids: torch.Tensor,  # holds the launch's keys; kept for signature parity)
    k_scales: torch.Tensor | None = None,  # [P, Kh, ps] f32 per-slot scales
    v_scales: torch.Tensor | None = None,  # (quantized pools; ops.kv_quant) — in place
    sm_scale: float | None = None,
    window: int | None = None,
):
    """Plain version: exact multi-row scatter of the new K/V into the paged
    pool, then masked gather attention per row (float32 logits and softmax).
    Returns ``(out [R, W, H, hd], k_pages, v_pages)``, plus ``(k_scales,
    v_scales)`` when a quantized pool's scales were passed. On quantized
    pools the scatter quantizes each slot with ``kv_quant.kv_quantize`` and
    the gather dequantizes, as the JAX version does: the launch's own keys
    are read back quantized, where the kernel attends them unquantized."""
    del ctx_lens, seq_ids
    R, W, H, hd = q.shape
    P, Kh, ps, _ = k_pages.shape
    maxp = page_tables.shape[1]
    T = maxp * ps
    if H % Kh:
        raise ValueError(f"num_heads {H} not divisible by num_kv_heads {Kh}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be passed together")
    quant = None
    if k_scales is not None:
        quant = "int8" if k_pages.dtype == torch.int8 else "fp8"
    rep = H // Kh
    if sm_scale is None:
        sm_scale = hd**-0.5
    dev = q.device
    tables = page_tables.long()
    j = torch.arange(W, device=dev)[None]  # [1, W]
    pos = row_starts.long()[:, None] + j  # [R, W]
    valid = j < n_tokens.long()[:, None]  # [R, W]
    lookup = pos // ps
    in_table = (lookup < maxp) & valid
    page_ids = torch.where(
        in_table, torch.gather(tables, 1, lookup.clamp(max=maxp - 1)), 0
    )  # padding/over-budget tokens write the garbage page
    slot_ids = pos % ps
    # advanced [R, W] indices at dims 0 and 2 put the broadcast dims first:
    # values [R, W, Kh, hd] (numpy/JAX semantics)
    if quant is not None:
        kq, ks = kv_quantize(k_new, quant)
        vq, vs = kv_quantize(v_new, quant)
        bits(k_pages)[page_ids, :, slot_ids] = bits(kq)
        bits(v_pages)[page_ids, :, slot_ids] = bits(vq)
        k_scales[page_ids, :, slot_ids] = ks
        v_scales[page_ids, :, slot_ids] = vs
        # [R, maxp, Kh, ps, hd] gathered and dequantized in float32
        k = kv_dequantize(bits(k_pages)[tables].view(k_pages.dtype), k_scales[tables])
        v = kv_dequantize(bits(v_pages)[tables].view(v_pages.dtype), v_scales[tables])
    else:
        k_pages[page_ids, :, slot_ids] = k_new.to(k_pages.dtype)
        v_pages[page_ids, :, slot_ids] = v_new.to(v_pages.dtype)
        k, v = k_pages[tables], v_pages[tables]

    # [R, maxp, Kh, ps, hd] -> [R, T, Kh, hd] gathered context
    k = k.permute(0, 1, 3, 2, 4).reshape(R, T, Kh, hd)
    v = v.permute(0, 1, 3, 2, 4).reshape(R, T, Kh, hd)
    qg = q.reshape(R, W, Kh, rep, hd).float()
    logits = torch.einsum("bwkrh,btkh->bkrwt", qg, k.float()) * sm_scale
    k_pos = torch.arange(T, device=dev)[None, None]  # [1, 1, T]
    keep = (k_pos <= pos[..., None]) & valid[..., None]  # [R, W, T]
    if window is not None:
        keep = keep & (k_pos > pos[..., None] - window)
    logits = torch.where(keep[:, None, None], logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrwt,btkh->bwkrh", probs, v.float()).reshape(R, W, H, hd)
    # padding rows/tokens return zeros like the kernel's un-accumulated rows
    out = torch.where(valid[..., None, None], out, 0.0).to(q.dtype)
    if quant is not None:
        return out, k_pages, v_pages, k_scales, v_scales
    return out, k_pages, v_pages


def ragged_paged_attention(
    q,
    k_new,
    v_new,
    k_pages,
    v_pages,
    page_tables,
    row_starts,
    n_tokens,
    ctx_lens,
    seq_ids,
    window: int | None = None,
    sm_scale: float | None = None,
):
    """One ragged fused write+attention launch. ``k_pages``/``v_pages`` are
    plain tensors or :class:`ops.kv_quant.QuantPages`, and come back as the
    same kind. CPU tensors take the plain version; CUDA tensors launch the
    hand-written kernel (which raises on anything it does not take — there
    is no fallback)."""
    quant = isinstance(k_pages, QuantPages)
    kq, ksc = (k_pages.q, k_pages.scale) if quant else (k_pages, None)
    vq, vsc = (v_pages.q, v_pages.scale) if quant else (v_pages, None)
    if q.is_cuda:
        from agentfield_tpu_torch.ops.cuda.ragged_paged_attention import (
            ragged_paged_attention_cuda as impl,
        )
    else:
        impl = ragged_paged_attention_ref
    out = impl(
        q, k_new, v_new, kq, vq, page_tables, row_starts, n_tokens, ctx_lens, seq_ids,
        k_scales=ksc, v_scales=vsc, sm_scale=sm_scale, window=window,
    )
    if quant:
        o, kp, vp, ks, vs = out
        return o, QuantPages(kp, ks), QuantPages(vp, vs)
    return out


def paged_attention_ref(
    q: torch.Tensor,  # [B, H, hd] — one query token per sequence
    k_pages: torch.Tensor,  # [P, Kh, ps, hd]
    v_pages: torch.Tensor,
    page_tables: torch.Tensor,  # [B, maxp] int32 page ids (0 = garbage page)
    seq_lens: torch.Tensor,  # [B] int32 — valid tokens (incl. current) per sequence
    window: int | None = None,
) -> torch.Tensor:
    """Single-token decode attention over a pre-written pool via page gather
    (an independent decode oracle). Returns [B, H, hd]."""
    B, H, hd = q.shape
    P, Kh, ps, _ = k_pages.shape
    maxp = page_tables.shape[1]
    T = maxp * ps
    tables = page_tables.long()
    k = k_pages[tables].permute(0, 1, 3, 2, 4).reshape(B, T, Kh, hd)
    v = v_pages[tables].permute(0, 1, 3, 2, 4).reshape(B, T, Kh, hd)
    rep = H // Kh
    qg = q.reshape(B, Kh, rep, hd).float()
    logits = torch.einsum("bkrh,btkh->bkrt", qg, k.float()) * (hd**-0.5)
    k_pos = torch.arange(T, device=q.device)[None, :]
    valid = k_pos < seq_lens.long()[:, None]  # [B, T]
    if window is not None:
        valid = valid & (k_pos >= seq_lens.long()[:, None] - window)
    logits = torch.where(valid[:, None, None, :], logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrt,btkh->bkrh", probs, v.float())
    return out.reshape(B, H, hd).to(q.dtype)


def decode_split_plan(ctx_len: int, row_start: int, window: int | None, maxp: int,
                      page_size: int, split: int = DECODE_SPLIT) -> list[tuple[int, int, int]]:
    """The cached-key ranges of the decode path's split CTAs for one row:
    ``(s, lo, hi)`` for every split ``s`` that holds keys, together covering
    ``[k_lo, min(ctx_len, maxp * page_size))`` once, where ``k_lo =
    row_start - window + 1`` (at least 0) with a window, else 0. Split ``s``
    may hold keys only in ``[s * split, (s + 1) * split)``; splits with no
    key do no work and are not merged (the kernel's choice, mirrored)."""
    ctx_eff = min(ctx_len, maxp * page_size)
    k_lo = max(0, row_start - window + 1) if window else 0
    plan = []
    for s in range(-(-maxp * page_size // split)):
        lo, hi = max(s * split, k_lo), min((s + 1) * split, ctx_eff)
        if lo < hi:
            plan.append((s, lo, hi))
    return plan


def _fold(qf, keys, vals, kpos, qpos, live, causal, window, sm_scale):
    """Online-softmax partial of packed query rows ``qf [Kh, nq, hd]`` over
    ``keys``/``vals [n, Kh, hd]`` at positions ``kpos [n]``: (m, l, acc)."""
    logits = torch.einsum("knd,jkd->knj", qf, keys) * sm_scale
    keep = live[:, None].expand(-1, len(kpos))
    if causal:
        keep = keep & (kpos[None] <= qpos[:, None])
    if window is not None:
        keep = keep & (kpos[None] > qpos[:, None] - window)
    logits = torch.where(keep[None], logits, _NEG_INF)
    m = logits.max(dim=-1).values
    p = torch.where(logits <= _NEG_INF / 2, 0.0, torch.exp(logits - m[..., None]))
    return m, p.sum(-1), torch.einsum("knj,jkd->knd", p, vals)


def decode_partials_ref(
    q, k_new, v_new, k_pages, v_pages, page_tables, row_starts, n_tokens, ctx_lens, seq_ids,
    k_scales=None, v_scales=None, sm_scale: float | None = None, window: int | None = None,
    split: int = DECODE_SPLIT,
):
    """Plain version of the decode path's split kernel, with the kernel's
    semantics (cached pages dequantized to float32, the launch's own keys
    unquantized). For every row and KV head: one online-softmax partial per
    split of ``decode_split_plan`` over its cached keys, and one (index
    ``nsplit``) over every same-``seq_id`` row's new keys, causal. Returns
    ``(m, l, acc)``: ``[R, Kh, nsplit + 1, W * rep]`` and ``[..., hd]``,
    float32, natural-log units, packed query row ``i = w * rep + h``. A
    split with no key, a padding row and a padding token hold ``(-1e30, 0,
    0)``. Pools are not written."""
    R, W, H, hd = q.shape
    _, Kh, ps, _ = k_pages.shape
    maxp = page_tables.shape[1]
    rep = H // Kh
    nq = W * rep
    if sm_scale is None:
        sm_scale = hd**-0.5
    kf = k_pages.float() if k_scales is None else kv_dequantize(k_pages, k_scales)
    vf = v_pages.float() if v_scales is None else kv_dequantize(v_pages, v_scales)
    ns = -(-maxp * ps // split)
    m = torch.full((R, Kh, ns + 1, nq), _NEG_INF)
    l_ = torch.zeros((R, Kh, ns + 1, nq))
    acc = torch.zeros((R, Kh, ns + 1, nq, hd))
    qf = q.float().reshape(R, W, Kh, rep, hd).permute(0, 2, 1, 3, 4).reshape(R, Kh, nq, hd)
    rows = torch.arange(nq)
    for r in range(R):
        nt = int(n_tokens[r])
        if nt <= 0:
            continue
        start = int(row_starts[r])
        qpos, live = start + rows // rep, rows < min(W, nt) * rep
        for s, lo, hi in decode_split_plan(int(ctx_lens[r]), start, window, maxp, ps, split):
            kp = torch.arange(lo, hi)
            pages = page_tables[r].long()[kp // ps]
            m[r, :, s], l_[r, :, s], acc[r, :, s] = _fold(
                qf[r], kf[pages, :, kp % ps], vf[pages, :, kp % ps], kp, qpos, live, False,
                window, sm_scale)
        mine = [r2 for r2 in range(R) if int(n_tokens[r2]) > 0 and int(seq_ids[r2]) == int(seq_ids[r])]
        kpos = torch.cat([int(row_starts[r2]) + torch.arange(int(n_tokens[r2])) for r2 in mine])
        keys = torch.cat([k_new[r2, : int(n_tokens[r2])].float() for r2 in mine])
        vals = torch.cat([v_new[r2, : int(n_tokens[r2])].float() for r2 in mine])
        m[r, :, ns], l_[r, :, ns], acc[r, :, ns] = _fold(
            qf[r], keys, vals, kpos, qpos, live, True, window, sm_scale)
    return m, l_, acc


def merge_partials_ref(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """Plain version of the decode path's combine step: merge online-softmax
    partials over the split axis (``m``/``l [..., S, nq]``, ``acc [..., S,
    nq, hd]``) and finalize, ``sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s -
    M) l_s, 1e-30)`` with ``M = max_s m_s``. An empty partial ``(-1e30, 0,
    0)`` adds nothing. Returns ``[..., nq, hd]`` float32."""
    w = torch.exp(m - m.max(dim=-2, keepdim=True).values)
    lsum = (w * l).sum(-2)
    return (w[..., None] * acc).sum(-3) / lsum.clamp_min(1e-30)[..., None]


def ragged_paged_attention_split_ref(
    q, k_new, v_new, k_pages, v_pages, page_tables, row_starts, n_tokens, ctx_lens, seq_ids,
    k_scales=None, v_scales=None, sm_scale: float | None = None, window: int | None = None,
    split: int = DECODE_SPLIT,
) -> torch.Tensor:
    """The attention output the decode path computes, as split partials
    merged by the combine step, in plain PyTorch: ``[R, W, H, hd]`` in q's
    dtype (pools are not written)."""
    R, W, H, hd = q.shape
    Kh = k_pages.shape[1]
    m, l_, acc = decode_partials_ref(
        q, k_new, v_new, k_pages, v_pages, page_tables, row_starts, n_tokens, ctx_lens, seq_ids,
        k_scales, v_scales, sm_scale=sm_scale, window=window, split=split)
    o = merge_partials_ref(m, l_, acc)  # [R, Kh, W * rep, hd]
    return o.reshape(R, Kh, W, H // Kh, hd).permute(0, 2, 1, 3, 4).reshape(R, W, H, hd).to(q.dtype)
