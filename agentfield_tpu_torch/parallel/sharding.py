"""Megatron-style tensor-parallel sharding of Llama parameter trees —
counterpart of ``agentfield_tpu/parallel/sharding.py``.

The partition specs are the JAX package's, written as tuples of axis names
(``None`` for an axis that is not sharded): qkv and gate/up projections are
column-parallel (output dim on ``model``), ``wo`` and ``w_down`` are
row-parallel (input dim on ``model``), the embedding shards the vocab (it
doubles as the tied unembed's column-parallel matrix) and ``lm_head`` its
output (vocab) dim. In JAX, ``shard_params`` places the whole tree on the
mesh and XLA inserts the collectives; here ``shard_params`` returns ONE
rank's slice of every leaf, and ``models.llama`` calls the collectives
itself (``parallel.mesh.Mesh``). Rank r's slice of an axis of size n is
``[r * n / tp, (r + 1) * n / tp)``: the block ``jax.device_put`` gives the
r-th device of the ``model`` axis.
"""

from __future__ import annotations

from typing import Any

import torch

from agentfield_tpu_torch.models.configs import LlamaConfig
from agentfield_tpu_torch.parallel.mesh import AXIS_EXPERT, AXIS_MODEL

Spec = tuple  # a partition spec: one axis name (or None) per tensor axis


def param_pspecs(cfg: LlamaConfig) -> dict[str, Any]:
    """The partition-spec tree matching ``models.llama.init_params`` (the
    JAX ``param_pspecs``, leaf for leaf). Layer leaves lead with the stacked
    layer axis, never sharded. A MoE config's expert specs (experts on
    ``expert``, the ffn dim on ``model``) are kept for the tree's shape;
    ``shard_params`` refuses them until expert parallelism is ported."""
    m = AXIS_MODEL
    if cfg.num_experts > 0:
        ex = AXIS_EXPERT
        mlp_specs: dict[str, Any] = {
            "router": (None, None, None),
            "w_gate": (None, ex, None, m),
            "w_up": (None, ex, None, m),
            "w_down": (None, ex, m, None),
        }
    else:
        mlp_specs = {
            "w_gate": (None, None, m),
            "w_up": (None, None, m),
            "w_down": (None, m, None),
        }
    specs: dict[str, Any] = {
        "embed": (m, None),  # vocab-sharded; doubles as the tied lm_head
        "layers": {
            "attn_norm": (None, None),
            "mlp_norm": (None, None),
            "wq": (None, None, m),
            "wk": (None, None, m),
            "wv": (None, None, m),
            "wo": (None, m, None),
            **mlp_specs,
        },
        "final_norm": (None,),
    }
    if cfg.attn_bias:
        specs["layers"]["bq"] = (None, m)
        specs["layers"]["bk"] = (None, m)
        specs["layers"]["bv"] = (None, m)
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, m)
    return specs


def _quant_aware(specs: Any, params: Any) -> Any:
    """Expand weight specs to match int8-quantized leaves (the JAX
    ``_quant_aware``): a ``QuantW`` of ``(q [L, in, out], scale [L, out])``
    takes ``(spec, spec minus its contraction axis)``, so the scale of a
    column-parallel weight shards with its columns and the scale of a
    row-parallel one (``wo``, ``w_down``) is replicated — it commutes out
    of the partial sums."""
    from agentfield_tpu_torch.models.quant import QuantW

    if isinstance(specs, dict):
        return {k: _quant_aware(s, params[k]) if k in params else s for k, s in specs.items()}
    if isinstance(params, QuantW):
        return (specs, specs[:-2] + specs[-1:])
    return specs


def refuse_experts(cfg: LlamaConfig, tp: int) -> None:
    """A MoE config under a mesh of tp > 1 raises: expert parallelism is a
    later slice."""
    if cfg.num_experts > 0 and tp > 1:
        raise NotImplementedError(
            "MoE under a mesh: expert parallelism is not ported (ROADMAP A5: EP and Mixtral "
            "under a mesh)")


def shard_slice(n: int, tp: int, rank: int) -> slice:
    """Rank ``rank``'s block of an axis of size ``n`` split ``tp`` ways."""
    if n % tp:
        raise ValueError(f"tp={tp} does not divide an axis of size {n}")
    k = n // tp
    return slice(rank * k, (rank + 1) * k)


def shard_tensor(t: torch.Tensor, spec: Spec, tp: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s slice of ``t`` under ``spec`` (a contiguous copy when
    an axis is sharded; ``t`` itself when none is)."""
    if AXIS_MODEL not in spec or tp == 1:
        return t
    if len(spec) != t.dim():
        raise ValueError(f"spec {spec} does not match a tensor of shape {tuple(t.shape)}")
    ax = spec.index(AXIS_MODEL)
    sl = shard_slice(t.shape[ax], tp, rank)
    return t.narrow(ax, sl.start, sl.stop - sl.start).contiguous()


def shard_quantw(w, specs: tuple[Spec, Spec], tp: int, rank: int):
    """Rank ``rank``'s slice of a ``QuantW`` under its ``(q spec, scale
    spec)`` (``_quant_aware``): q cut on the sharded axis (output for a
    column-parallel weight, input for a row-parallel one), scale cut with
    the output axis or kept whole, and, for a q packed for the kernel, the
    slice packed again (``pack_int8_weight`` at the slice's own width)."""
    from agentfield_tpu_torch.models.quant import QuantW, pack_quantw

    q_spec, s_spec = specs
    if AXIS_MODEL not in q_spec or tp == 1:
        return w
    out = QuantW(shard_tensor(w.logical(), q_spec, tp, rank),
                 shard_tensor(w.scale, s_spec, tp, rank))
    return pack_quantw(out) if w.packed is not None else out


def shard_params(params: dict[str, Any], cfg: LlamaConfig, mesh) -> dict[str, Any]:
    """One rank's slice of every leaf of an unsharded tree (``mesh.tp``,
    ``mesh.rank``; the JAX ``shard_params`` places all of them at once). A
    ``QuantW`` leaf is cut by ``shard_quantw``."""
    from agentfield_tpu_torch.models.quant import QuantW

    tp, rank = mesh.tp, mesh.rank
    refuse_experts(cfg, tp)

    def cut(p, s):
        if isinstance(p, dict):
            return {k: cut(v, s[k]) for k, v in p.items()}
        if isinstance(p, QuantW):
            return shard_quantw(p, s, tp, rank)
        return shard_tensor(p, s, tp, rank)

    return cut(params, _quant_aware(param_pspecs(cfg), params))


def check_rank_slice(params: dict[str, Any], cfg: LlamaConfig, tp: int) -> None:
    """Raise ``ValueError`` unless every leaf of ``params`` has the shape of
    one rank's slice at ``tp`` (``shard_params``'s, a loader's ``shard=``):
    the whole shape (``models.convert.param_shapes``) with each sharded
    axis divided by ``tp``; a ``QuantW`` by its logical shape."""
    from agentfield_tpu_torch.models.convert import param_shapes

    def walk(prefix, p, spec, whole):
        if isinstance(p, dict):
            for k, v in p.items():
                walk(f"{prefix}{k}.", v, spec[k], whole[k])
            return
        if isinstance(spec[0], tuple):  # a QuantW's (q spec, scale spec)
            spec = spec[0]
        want = tuple(n // tp if ax == AXIS_MODEL else n for n, ax in zip(whole, spec))
        if tuple(p.shape) != want:
            raise ValueError(
                f"param {prefix[:-1]}: shape {tuple(p.shape)} is not one rank's slice "
                f"{want} of {tuple(whole)} at tp={tp} (a mesh takes each rank's slice: "
                "parallel.sharding.shard_params)")

    walk("", params, _quant_aware(param_pspecs(cfg), params), param_shapes(cfg))


def check_divisibility(cfg: LlamaConfig, tp: int, paged_kv: bool = False) -> None:
    """The TP degree must divide every model-sharded dimension (the JAX
    check and its messages). The paged KV pool shards the head axes too
    (``paged_kv=True``)."""
    dims = [
        ("q_dim", cfg.q_dim),
        ("kv_dim", cfg.kv_dim),
        ("intermediate_size", cfg.intermediate_size),
        ("vocab_size", cfg.vocab_size),
    ]
    if paged_kv:
        dims += [("num_heads", cfg.num_heads), ("num_kv_heads", cfg.num_kv_heads)]
    for name, dim in dims:
        if dim % tp:
            raise ValueError(f"tp={tp} does not divide {name}={dim} for this config")
