"""The Llama decoder family in PyTorch — counterpart of
``agentfield_tpu/models/llama.py``.

Parameters are a plain dict laid out exactly like the JAX package's pytree:
every layer leaf is stacked on a leading ``[L, ...]`` axis and every
projection is stored ``[in, out]`` (so ``x @ w``). The op order follows the
JAX code line by line — it decides where bf16 rounds: norms and softmax
accumulate in float32, the MLP gate activation runs in float32, logits come
out float32.

``forward(attn_impl="kernel")`` is the counterpart of the JAX
``attn_impl="flash"``: dense causal prefill through the hand-written ragged
paged-attention kernel (``ops.cuda.ragged_paged_attention.
dense_causal_attention``; its plain version on CPU tensors).

``mesh=`` (a ``parallel.mesh.Mesh`` of tp > 1, params from
``parallel.sharding.shard_params``) runs one rank's share of the
Megatron-style tensor-parallel forward: the projections and attention on
the rank's H/tp query and Kh/tp KV heads (head counts are read from the
weights' widths), the FFN on its f/tp columns, and the collectives written
out where GSPMD inserts them in the JAX package — an all-reduce after the
row-parallel ``wo`` and ``w_down`` (``attn_out``, ``mlp_block``), a masked
lookup of the vocab-sharded table and an all-reduce (``embed_tokens``), the
vocab gather of the logits (``unembed``). Attention itself has no
collective: each rank runs the kernel on its heads (the JAX ``attend``'s
``shard_map``).

``forward(remat=True)`` under autograd is the training forward
(``training.trainer``); ``generate_greedy`` over ``forward_with_cache`` and
a contiguous cache is the greedy oracle the engine is held against.

A config with ``num_experts > 0`` (Mixtral) has a top-k MoE FFN: ``router
[L, d, E]`` and expert stacks ``w_gate``/``w_up [L, E, d, f]``, ``w_down [L,
E, f, d]``; ``cfg.moe_impl`` picks soft routing or capacity-based sparse
dispatch (``models.moe``).

A projection leaf is a tensor or a ``models.quant.QuantW`` (int8 weights with
per-output-channel scales, ``quant.quantize_params``): every projection is
written ``x @ w``, which a QuantW takes through ``__rmatmul__`` (the
hand-written int8-weight kernel on the card), and ``layer`` slices it like a
tensor. One forward serves both. An expert stack contracts through
``QuantW.expert_einsum`` (one kernel launch per expert on the card).
"""

from __future__ import annotations

import functools
import math
from typing import Any

import torch
import torch.nn.functional as F

from agentfield_tpu_torch.models.configs import LlamaConfig

Params = dict[str, Any]

_NEG_INF = -1e30  # large-negative instead of -inf: avoids NaN from all-masked rows

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def resolve_dtype(name: str | torch.dtype) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(_DTYPES)}") from None


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def init_params(
    cfg: LlamaConfig,
    seed: int = 0,
    dtype: str | torch.dtype | None = None,
    device: str | torch.device = "cuda",
    quantize: bool = False,
    shard=None,
) -> Params:
    """Random-normal init (std 0.02; norms 1), drawn from a seeded
    ``torch.Generator`` directly in the target dtype on the target device —
    a full-width model never stages float32 copies. The values differ from
    the JAX package's (different generators); carry JAX weights across with
    ``models.convert.params_from_numpy`` when the two must match.

    With ``quantize`` every ``models.quant.QUANT_KEYS`` leaf is drawn one
    ``[d_in, d_out]`` matrix at a time, quantized and (on a CUDA device)
    packed into its ``QuantW`` at once (``quant.init_quantized``): the
    distribution of ``quantize_params(init_params(...))`` without ever
    holding a whole fp stack (Mixtral's bf16 expert stacks alone outgrow an
    80 GB card).

    With ``shard`` (a ``parallel.mesh.Mesh``) only that rank's slice of
    each leaf is kept (``parallel.sharding.param_pspecs``): every leaf is
    still drawn whole, in the same order from the same generator, and cut
    at once (an int8 matrix quantized whole, then cut, then packed), so a
    rank's tree is bit-equal to ``shard_params`` of the unsharded tree."""
    dt = resolve_dtype(dtype or cfg.dtype)
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    d, f, v, L = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_layers

    tp = 1 if shard is None else shard.tp
    specs = None
    if tp > 1:
        from agentfield_tpu_torch.parallel.sharding import (
            param_pspecs, refuse_experts, shard_tensor)

        refuse_experts(cfg, tp)
        specs = param_pspecs(cfg)

    def spec(name):
        if specs is None:
            return None
        return specs[name] if name in specs else specs["layers"][name]

    def cut(name, t):
        if specs is None:
            return t
        return shard_tensor(t, spec(name), tp, shard.rank)

    def norm(name, *shape):
        return cut(name, torch.empty(shape, dtype=dt, device=device).normal_(
            0.0, 0.02, generator=g))

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    def weight(name, *shape):  # a QUANT_KEYS leaf
        if not quantize:
            return norm(name, *shape)
        from agentfield_tpu_torch.models.quant import init_quantized

        cut_spec = None if specs is None else (spec(name), tp, shard.rank)
        return init_quantized(shape, dt, device, g, shard=cut_spec)

    E = cfg.num_experts
    embed = norm("embed", v, d)
    layers = {
        "attn_norm": ones(L, d),
        "mlp_norm": ones(L, d),
        "wq": weight("wq", L, d, cfg.q_dim),
        "wk": weight("wk", L, d, cfg.kv_dim),
        "wv": weight("wv", L, d, cfg.kv_dim),
        "wo": weight("wo", L, cfg.q_dim, d),
    }
    if E > 0:  # Mixtral-style MoE FFN: the expert axis after the layer axis
        layers["router"] = norm("router", L, d, E)  # stays fp, as in the JAX package
        lead = (L, E)
    else:
        lead = (L,)
    layers.update(w_gate=weight("w_gate", *lead, d, f), w_up=weight("w_up", *lead, d, f),
                  w_down=weight("w_down", *lead, f, d))
    params: Params = {"embed": embed, "layers": layers, "final_norm": ones(d)}
    if cfg.attn_bias:  # Qwen2-style QKV biases
        for name, n in (("bq", cfg.q_dim), ("bk", cfg.kv_dim), ("bv", cfg.kv_dim)):
            params["layers"][name] = cut(name, torch.zeros((L, n), dtype=dt, device=device))
    if not cfg.tie_embeddings:
        params["lm_head"] = norm("lm_head", d, v)
    return params


def layer(params: Params, i: int) -> Params:
    """Layer ``i``'s leaves (views into the stacked ``[L, ...]`` tensors, or
    a ``QuantW`` of the two sliced in lockstep)."""
    return {k: t[i] for k, t in params["layers"].items()}


def _layers(params: Params, num_layers: int):
    """Every layer's leaves, in order. A stacked leaf that requires grad
    (with grad mode on) is split once with ``unbind(0)``, whose backward
    stacks the layers' gradients once: ``t[i]``'s backward would fill a
    zero ``[L, ...]`` gradient a layer (1 GiB a layer for Llama-3-8B's
    ``wq``). Every other leaf is sliced as ``layer`` slices it, so the
    serving path's ops are unchanged."""
    split = {k: t.unbind(0) for k, t in params["layers"].items()
             if torch.is_grad_enabled() and isinstance(t, torch.Tensor) and t.requires_grad}
    for i in range(num_layers):
        yield {k: split[k][i] if k in split else t[i] for k, t in params["layers"].items()}


def detached(params: Params) -> Params:
    """``params`` with every tensor leaf detached from autograd (sharing its
    storage; a ``QuantW`` passes through): a trained state's leaves served
    or held frozen without building graphs."""
    return {k: detached(v) if isinstance(v, dict)
            else v.detach() if isinstance(v, torch.Tensor) else v
            for k, v in params.items()}


# ---------------------------------------------------------------------------
# Building blocks (shared with the paged serving engine)
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    # float32 normalise, cast back, THEN scale (the JAX op order)
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def embed_tokens(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
                 mesh=None) -> torch.Tensor:
    """Token-table lookup; gemma-family configs scale by sqrt(hidden) in the
    table's dtype (the tied UNEMBED uses the raw table). The scale is a CPU
    scalar: no host-to-device copy, so a CUDA graph can capture the call.
    Under a ``mesh`` the table is this rank's vocab rows: tokens outside
    them look up zeros, and the all-reduce over ranks (one non-zero addend
    an element: exact) gives every rank the whole lookup."""
    table = params["embed"]
    if mesh is not None and mesh.tp > 1:
        n = table.shape[0]
        local = tokens - mesh.rank * n
        mine = (local >= 0) & (local < n)
        x = mesh.all_reduce(table[local.clamp(0, n - 1)] * mine[..., None].to(table.dtype))
    else:
        x = table[tokens]
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.hidden_size**0.5, dtype=x.dtype)
    return x


def rope_sincos(positions: torch.Tensor, head_dim: int, theta: float, scaling=None):
    """cos/sin tables (float32) for absolute ``positions`` [...], with the
    optional Llama-3.1/3.2 ``RopeScaling`` frequency rescaling."""
    half = head_dim // 2
    dev = positions.device
    inv_freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=dev) / half))
    if scaling is not None:
        wavelen = 2.0 * math.pi / inv_freq
        orig = float(scaling.original_max_position_embeddings)
        low_wl = orig / scaling.low_freq_factor  # longest unscaled wavelength
        high_wl = orig / scaling.high_freq_factor
        smooth = (orig / wavelen - scaling.low_freq_factor) / (
            scaling.high_freq_factor - scaling.low_freq_factor
        )
        interp = (1.0 - smooth) * inv_freq / scaling.factor + smooth * inv_freq
        inv_freq = torch.where(
            wavelen < high_wl,
            inv_freq,
            torch.where(wavelen > low_wl, inv_freq / scaling.factor, interp),
        )
    angles = positions.float()[..., None] * inv_freq  # [..., half]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs split at head_dim/2 (HF 'rotate_half'). x: [B, S, N, hd];
    cos/sin: [B, S, hd/2]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c, s = cos[..., None, :], sin[..., None, :]  # broadcast over heads
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


def attention_ref(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, T, Kh, hd]
    v: torch.Tensor,  # [B, T, Kh, hd]
    q_pos: torch.Tensor,  # [B, S] absolute positions of queries
    k_pos: torch.Tensor,  # [B, T] absolute positions of keys
    k_valid: torch.Tensor,  # [B, T] bool — is this key slot populated
    window: int | None = None,
) -> torch.Tensor:
    """Plain GQA attention with causal+validity masking, float32 softmax."""
    B, S, H, hd = q.shape
    Kh = k.shape[2]
    rep = H // Kh
    qg = q.reshape(B, S, Kh, rep, hd).float()
    logits = torch.einsum("bskrh,btkh->bkrst", qg, k.float()) * (hd**-0.5)
    mask = (k_pos[:, None, :] <= q_pos[:, :, None]) & k_valid[:, None, :]  # [B,S,T]
    if window is not None:
        mask = mask & (k_pos[:, None, :] > q_pos[:, :, None] - window)
    logits = torch.where(mask[:, None, None], logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrst,btkh->bskrh", probs, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def qkv_proj(lp: Params, x_normed: torch.Tensor, cfg: LlamaConfig, cos, sin):
    """Project (+bias for Qwen2-style configs) + rope.
    Returns q [B,S,H,hd], k/v [B,S,Kh,hd]."""
    B, S, _ = x_normed.shape
    q, k, v = x_normed @ lp["wq"], x_normed @ lp["wk"], x_normed @ lp["wv"]
    if "bq" in lp:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    # -1: a tensor-parallel rank holds H/tp and Kh/tp heads of the weights
    q = q.reshape(B, S, -1, cfg.head_dim)
    k = k.reshape(B, S, -1, cfg.head_dim)
    v = v.reshape(B, S, -1, cfg.head_dim)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _act(t: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    if cfg.mlp_act == "silu":
        return F.silu(t)
    # jax.nn.gelu's default tanh approximation (HF gelu_pytorch_tanh)
    return F.gelu(t, approximate="tanh")


def mlp_block(
    lp: Params,
    x: torch.Tensor,
    cfg: LlamaConfig,
    valid: torch.Tensor | None = None,
    capacity_tokens: int | None = None,
    mesh=None,
) -> torch.Tensor:
    """The FFN sublayer (without its residual add). For a MoE config,
    ``valid`` ([B, S] bool) keeps padding out of sparse dispatch and
    ``capacity_tokens`` is the token count expert capacity is sized from
    (default B * S): the engine passes the padded size of the JAX engine's
    prefill, so the same entries overflow. Soft routing ignores both.
    Under a ``mesh`` the rank's ``w_down`` rows give a partial sum, summed
    over ranks."""
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
    tp = mesh is not None and mesh.tp > 1
    if cfg.num_experts > 0:
        if tp:
            from agentfield_tpu_torch.parallel.sharding import refuse_experts

            refuse_experts(cfg, mesh.tp)
        return _moe_mlp(lp, h, cfg, valid, capacity_tokens).to(x.dtype)
    gate = _act((h @ lp["w_gate"]).float(), cfg).to(x.dtype)
    y = (gate * (h @ lp["w_up"])) @ lp["w_down"]
    return (mesh.all_reduce(y) if tp else y).to(x.dtype)


def _emm(spec: str, x: torch.Tensor, w) -> torch.Tensor:
    """Expert contraction ``einsum(spec, x, w)``, int8-aware."""
    from agentfield_tpu_torch.models.quant import QuantW

    return w.expert_einsum(spec, x) if isinstance(w, QuantW) else torch.einsum(spec, x, w)


def _moe_mlp(lp: Params, h: torch.Tensor, cfg: LlamaConfig,
             valid: torch.Tensor | None = None,
             capacity_tokens: int | None = None) -> torch.Tensor:
    """Mixtral-style top-k MoE FFN under ``cfg.moe_impl``: "dense" (soft
    routing: every expert computes, a top-k-masked softmax weights them;
    what decode runs, since every expert's weights stream each step
    anyway) or "sparse" (capacity-based dispatch, ``_moe_mlp_sparse``: what
    prefill runs under ``EngineConfig.moe_prefill_impl="sparse"``)."""
    from agentfield_tpu_torch.models.moe import topk_router_weights

    if cfg.moe_impl == "sparse":
        return _moe_mlp_sparse(lp, h, cfg, valid, capacity_tokens)
    if cfg.moe_impl != "dense":
        raise ValueError(f"moe_impl={cfg.moe_impl!r} must be 'dense' or 'sparse'")
    logits = (h @ lp["router"]).float()  # [B, S, E]
    weights = topk_router_weights(logits, cfg.num_experts_per_tok)
    gate = _act(_emm("bsd,edf->besf", h, lp["w_gate"]).float(), cfg).to(h.dtype)
    up = _emm("bsd,edf->besf", h, lp["w_up"])
    y = _emm("besf,efd->besd", gate * up, lp["w_down"])
    return torch.einsum("bse,besd->bsd", weights.to(y.dtype), y)


def _moe_mlp_sparse(lp: Params, h: torch.Tensor, cfg: LlamaConfig,
                    valid: torch.Tensor | None = None,
                    capacity_tokens: int | None = None) -> torch.Tensor:
    """Capacity-based sparse dispatch of the gated MoE FFN: the routed
    tokens scatter into ``[E, capacity, D]`` buffers, each expert runs on
    its buffer, and a gather + weighted sum combines."""
    from agentfield_tpu_torch.models.moe import (
        combine_tokens,
        dispatch_tokens,
        expert_capacity,
        sparse_plan,
    )

    b, s, d = h.shape
    n = b * s
    k = cfg.num_experts_per_tok
    capacity = expert_capacity(n if capacity_tokens is None else capacity_tokens,
                               cfg.num_experts, k, cfg.moe_capacity_factor)
    xt = h.reshape(n, d)
    logits = (xt @ lp["router"]).float()  # [N, E]
    experts, slots, keep, weights = sparse_plan(
        logits, k, capacity, None if valid is None else valid.reshape(n))
    buf = dispatch_tokens(xt, experts, slots, cfg.num_experts, capacity)
    gate = _act(_emm("ecd,edf->ecf", buf, lp["w_gate"]).float(), cfg).to(h.dtype)
    up = _emm("ecd,edf->ecf", buf, lp["w_up"])
    y = _emm("ecf,efd->ecd", gate * up, lp["w_down"])
    out = combine_tokens(y, experts, slots, keep, weights, k)
    return out.reshape(b, s, d).to(h.dtype)


def unembed(params: Params, cfg: LlamaConfig, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """float32 logits; under a ``mesh`` the rank's vocab columns, gathered
    into the whole vocabulary on every rank."""
    h = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (h @ w).float()
    return mesh.gather_vocab(logits) if mesh is not None and mesh.tp > 1 else logits


def attn_out(lp: Params, attn: torch.Tensor, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Residual add of the output projection: ``x + attn @ wo`` in x.dtype;
    under a ``mesh`` the rank's heads give a partial sum of ``attn @ wo``,
    summed over ranks before the add."""
    y = attn.reshape(*attn.shape[:2], -1) @ lp["wo"]
    if mesh is not None and mesh.tp > 1:
        y = mesh.all_reduce(y)
    return x + y.to(x.dtype)


# ---------------------------------------------------------------------------
# Full forward
# ---------------------------------------------------------------------------


def forward(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B, S]
    positions: torch.Tensor,  # [B, S]
    attn_impl: str = "ref",
    collect_kv: bool = True,
    last_idx: torch.Tensor | None = None,  # [B]: unembed only x[b, last_idx[b]]
    return_hidden: bool = False,
    valid_mask: torch.Tensor | None = None,  # [B, S] bool: the real tokens
    capacity_tokens: int | None = None,  # sparse MoE: capacity's token count
    embeds_override: tuple[torch.Tensor, torch.Tensor] | None = None,
    remat: bool = False,
    mesh=None,
):
    """Dense causal forward. Returns ``(logits [B, S, V] float32, (k, v)``
    each ``[L, B, S, Kh, hd]`` or None). With ``last_idx`` the logits are
    ``[B, V]`` at one position per row — the engine samples only there, and
    a full-vocab unembed of every prompt position would cost GBs at 8B.
    With ``return_hidden`` the first element is the final-norm hidden states
    ``[B, S, D]`` in the params' dtype instead of logits, and the unembed is
    skipped (the embeddings path).

    ``attn_impl``: "ref" (plain ``attention_ref``) | "kernel" (dense causal
    attention through the ragged paged-attention kernel; valid when
    ``positions`` are per-row aranges, which prefill guarantees).

    ``valid_mask`` and ``capacity_tokens`` reach a sparse-dispatch MoE FFN
    (``mlp_block``): serving prefills mark their padding False so it takes
    no expert capacity; every other path ignores them.

    ``embeds_override=(inject [B, S, D], mask [B, S] bool)`` substitutes
    non-token embeddings (a vision or audio tower's) at the masked
    positions, after ``embed_tokens``, cast to its dtype (multimodal early
    fusion, as the JAX ``forward_impl``).

    ``remat`` (with grad mode on) runs each layer body under
    ``torch.utils.checkpoint`` (non-reentrant): the backward recomputes the
    layer instead of keeping its activations, the JAX ``jax.checkpoint``
    of the scan body. Training passes ``collect_kv=False, remat=True``
    (``training.trainer.causal_lm_loss``).

    ``mesh``: one rank's share of the tensor-parallel forward (module
    docstring); its logits, hidden states and KV are the rank's heads'
    (the logits and hidden states whole, the KV the rank's Kh/tp)."""
    if attn_impl == "ring":
        raise NotImplementedError(
            "attn_impl='ring' (sequence-parallel attention) is not ported (ROADMAP A5: ring "
            "attention)")
    if attn_impl not in ("ref", "kernel"):
        raise ValueError(f"unknown attn_impl {attn_impl!r} (have 'ref', 'kernel')")
    x = embed_tokens(params, cfg, tokens, mesh)
    if embeds_override is not None:
        inject, inj_mask = embeds_override
        x = torch.where(inj_mask[..., None], inject.to(x.dtype), x)
    cos, sin = rope_sincos(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    # a window that can't bind within this sequence length is a no-op
    win = cfg.sliding_window
    if win is not None and win >= tokens.shape[1]:
        win = None

    def attend(q, k, v):
        if attn_impl == "kernel":
            from agentfield_tpu_torch.ops.cuda.ragged_paged_attention import (
                dense_causal_attention,
            )

            return dense_causal_attention(q, k, v, window=win)
        valid = torch.ones_like(positions, dtype=torch.bool)
        return attention_ref(q, k, v, positions, positions, valid, window=win)

    def body(x, lp):
        h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        q, k, v = qkv_proj(lp, h, cfg, cos, sin)
        x = attn_out(lp, attend(q, k, v), x, mesh)
        return x + mlp_block(lp, x, cfg, valid_mask, capacity_tokens, mesh), k, v

    if remat and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint

        body = functools.partial(checkpoint, body, use_reentrant=False,
                                 preserve_rng_state=False)  # the body draws nothing
    ks, vs = [], []
    for lp in _layers(params, cfg.num_layers):
        x, k, v = body(x, lp)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    kv = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    if return_hidden:
        return rms_norm(x, params["final_norm"], cfg.rms_norm_eps), kv
    if last_idx is not None:
        x = x[torch.arange(x.shape[0], device=x.device), last_idx]
    return unembed(params, cfg, x, mesh), kv


# ---------------------------------------------------------------------------
# Contiguous cache (the greedy oracle)
# ---------------------------------------------------------------------------


def make_contiguous_cache(cfg: LlamaConfig, batch: int, max_len: int,
                          dtype: str | torch.dtype | None = None,
                          device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    dt = resolve_dtype(dtype or cfg.dtype)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


@torch.no_grad()
def forward_with_cache(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B, S]
    cache: dict[str, torch.Tensor],
    offset: int,  # write position (rows aligned; ragged batches are the engine's)
):
    """Incremental forward over a contiguous KV cache, the JAX
    ``forward_with_cache``: a correctness oracle for the paged engine, with
    the plain ``attention_ref`` over the whole cache (slots past ``offset +
    S`` masked). The new K/V are written into ``cache`` in place; returns
    ``(logits [B, S, V] float32, cache)``."""
    B, S = tokens.shape
    T = cache["k"].shape[2]
    dev = tokens.device
    positions = offset + torch.arange(S, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    x = embed_tokens(params, cfg, tokens)
    cos, sin = rope_sincos(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    k_pos = torch.arange(T, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    k_valid = k_pos < (offset + S)
    win = cfg.sliding_window
    if win is not None and win >= T:
        win = None  # can't bind within this cache budget
    for i in range(cfg.num_layers):
        lp = layer(params, i)
        h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        q, k, v = qkv_proj(lp, h, cfg, cos, sin)
        ck, cv = cache["k"][i], cache["v"][i]
        ck[:, offset:offset + S] = k
        cv[:, offset:offset + S] = v
        x = attn_out(lp, attention_ref(q, ck, cv, positions, k_pos, k_valid, window=win), x)
        x = x + mlp_block(lp, x, cfg)
    return unembed(params, cfg, x), cache


def generate_greedy(params: Params, cfg: LlamaConfig, prompt: torch.Tensor, num_steps: int,
                    max_len: int) -> torch.Tensor:
    """Greedy decode via the contiguous cache — a correctness oracle for the
    continuous-batching engine, not the serving path. ``prompt [B, S]``;
    returns ``[B, num_steps]`` int32 on the prompt's device."""
    B, S = prompt.shape
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    # The final generated token is returned but never written to the cache,
    # so only S + num_steps - 1 slots are needed.
    if S + num_steps - 1 > max_len:
        raise ValueError(
            f"prompt ({S}) + num_steps ({num_steps}) - 1 exceeds max_len ({max_len}); "
            "the cache write would run past its end"
        )
    cache = make_contiguous_cache(cfg, B, max_len, device=prompt.device)
    logits, cache = forward_with_cache(params, cfg, prompt, cache, 0)
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    out = [tok]
    for i in range(num_steps - 1):
        logits, cache = forward_with_cache(params, cfg, tok[:, None], cache, S + i)
        tok = logits[:, -1].argmax(-1).to(torch.int32)
        out.append(tok)
    return torch.stack(out, dim=1)
