"""The canonical ragged-attention shape mixes and parity bounds — the port's
copy of ``SHAPES`` and ``PARITY_TOL`` from the JAX package's kernel gate
(``tools/perf/kernel_gate.py``), plus ``build_case``, which packs a mix with
the port's own ``pack_ragged_rows`` so both packages are measured and held on
the same descriptors."""

from __future__ import annotations

import numpy as np
import torch

# One entry per canonical mix: ``fast`` is the CPU-sized tier, ``full`` the
# bench size. All shapes honor the allocator invariant (live rows own
# disjoint pages; page 0 garbage).
SHAPES: dict[str, dict] = {
    # B decode rows, each mid-generation over a paged context
    "pure_decode": dict(
        fast=dict(rows=16, ctx=200, page_size=16, maxp=16, kh=2, rep=2, hd=64),
        full=dict(rows=32, ctx=440, page_size=16, maxp=32, kh=4, rep=2, hd=64),
    ),
    # one fresh chunk (ctx 0): intra-chunk causality rides the new-key phase
    "pure_prefill": dict(
        fast=dict(chunk=128, ctx=0, page_size=16, maxp=16, kh=2, rep=2, hd=64),
        full=dict(chunk=256, ctx=0, page_size=16, maxp=32, kh=4, rep=2, hd=64),
    ),
    # decode slots + two admitting chunks in one launch (the mixed tick)
    "mixed_ragged": dict(
        fast=dict(rows=8, ctx=120, chunk=48, chunks=2, page_size=16, maxp=16, kh=2, rep=2, hd=64),
        full=dict(rows=16, ctx=200, chunk=112, chunks=2, page_size=16, maxp=32, kh=4, rep=2, hd=64),
    ),
    # few rows, long cached context: the page-walk-bound corner
    "long_context_paged": dict(
        fast=dict(rows=2, ctx=760, page_size=16, maxp=48, kh=2, rep=2, hd=64),
        full=dict(rows=4, ctx=2040, page_size=16, maxp=128, kh=4, rep=2, hd=64),
    ),
}

# The quantized mixes: the decode and mixed shapes again over int8/fp8
# pools, under the JAX gate's names. The gate keeps them in SHAPES; here they
# stand apart because ``build_case`` returns their pools as torch tensors.
QUANT_SHAPES: dict[str, dict] = {
    f"{base}_{dt}": {tier: dict(params, kv_dtype=dt) for tier, params in SHAPES[base].items()}
    for base, dt in (
        ("pure_decode", "int8"),
        ("mixed_ragged", "int8"),
        ("pure_decode", "fp8"),
        ("mixed_ragged", "fp8"),
    )
}

# kernel vs plain attention parity bound per KV dtype ("none" = bf16/f32 pools)
PARITY_TOL = {"none": 2e-3, "int8": 2e-2, "fp8": 6e-2}


def build_case(name: str, fast: bool = True, seed: int = 0, params: dict | None = None):
    """Materialize one shape mix as numpy arrays ``(q, k_new, v_new, k_pages,
    v_pages, page_tables, row_starts, n_tokens, ctx_lens, seq_ids)`` — the
    same draws, in the same order, as the JAX gate's ``build_case``.
    ``params`` overrides the mix's parameters (custom shapes): ``served``
    lists one decode row per context, ``chunk_list`` one prefill chunk per
    ``(cached tokens, chunk tokens)``, ``pad_to`` pads the launch with empty
    rows up to that many. A mix with a
    ``kv_dtype`` ("int8" | "fp8") quantizes the pools with the port's
    ``kv_quantize`` and appends ``(k_scales, v_scales)``; its four pool
    arrays are CPU torch tensors, since numpy has no float8 type."""
    from agentfield_tpu_torch.serving.kv_cache import pack_ragged_rows

    if params is None:
        params = {**SHAPES, **QUANT_SHAPES}[name]["fast" if fast else "full"]
    p = params
    ps, maxp, kh, rep, hd = p["page_size"], p["maxp"], p["kh"], p["rep"], p["hd"]
    H = kh * rep
    entries = [(c, 1) for c in p.get("served", ())]  # (start, n_tokens) per entry
    if "rows" in p:
        for r in range(p["rows"]):
            entries.append((p["ctx"] + (r % 7), 1))
    for _ in range(p.get("chunks", 1 if "chunk" in p else 0)):
        entries.append((p["ctx"], p["chunk"]))
    entries += [tuple(c) for c in p.get("chunk_list", ())]
    n_seqs = len(entries)
    P = n_seqs * maxp + 1
    rng = np.random.default_rng(seed)
    perm = rng.permutation(P - 1) + 1
    seq_tables = perm[: n_seqs * maxp].reshape(n_seqs, maxp)
    W = p.get("W") or min(max(n for _, n in entries), 128)
    need = sum(-(-n // W) for _, n in entries)
    rr = pack_ragged_rows(
        [(seq_tables[sid], start, [0] * n) for sid, (start, n) in enumerate(entries)],
        maxp,
        budget=max(need, p.get("pad_to", 0)) * W,
        block_q=W,
    )
    R = rr.row_starts.shape[0]
    q = rng.standard_normal((R, W, H, hd)).astype(np.float32) * 0.3
    kn = rng.standard_normal((R, W, kh, hd)).astype(np.float32) * 0.3
    vn = rng.standard_normal((R, W, kh, hd)).astype(np.float32) * 0.3
    kp = rng.standard_normal((P, kh, ps, hd)).astype(np.float32) * 0.3
    vp = rng.standard_normal((P, kh, ps, hd)).astype(np.float32) * 0.3
    case = (
        q, kn, vn, kp, vp,
        rr.page_tables, rr.row_starts, rr.n_tokens, rr.ctx_lens, rr.seq_ids,
    )
    kv_dtype = p.get("kv_dtype", "none")
    if kv_dtype == "none":
        return case
    from agentfield_tpu_torch.ops.kv_quant import kv_quantize

    kq, ks = kv_quantize(torch.from_numpy(kp), kv_dtype)
    vq, vs = kv_quantize(torch.from_numpy(vp), kv_dtype)
    return case[:3] + (kq, vq) + case[5:] + (ks, vs)
