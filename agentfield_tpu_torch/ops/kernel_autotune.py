"""Ragged-row packing widths — the port's copy of the JAX package's
``ops/pallas/kernel_autotune.py`` table (``KernelBlocks``, ``DEFAULT_TABLE``,
``lookup_blocks``).

Only its ROW-PACKING meaning carries over: ``block_q`` is how many query
tokens one ragged row holds when the engine splits a prefill chunk (suffix
prefill) or a dense prompt (``dense_causal_attention``) into rows, so the
port packs the same descriptors the JAX engine does. The CUDA kernel's own
tile sizes are fixed in ``csrc/ragged_paged_attention.cu`` and do not come
from here. No sweep and no environment override are ported.
"""

from __future__ import annotations

import typing


class KernelBlocks(typing.NamedTuple):
    block_q: int
    block_n: int


KV_DTYPES = ("none", "int8", "fp8")

# (page_size, head_dim, bucket) -> blocks, copied from the JAX package.
_BASE_TABLE: dict[tuple[int, int, int], KernelBlocks] = {
    (16, 64, 16): KernelBlocks(block_q=16, block_n=16),
    (16, 64, 32): KernelBlocks(block_q=32, block_n=32),
    (16, 64, 64): KernelBlocks(block_q=64, block_n=64),
    (16, 64, 128): KernelBlocks(block_q=128, block_n=128),
    (16, 64, 256): KernelBlocks(block_q=256, block_n=128),
    (16, 64, 512): KernelBlocks(block_q=512, block_n=128),
    (16, 128, 16): KernelBlocks(block_q=16, block_n=16),
    (16, 128, 32): KernelBlocks(block_q=32, block_n=32),
    (16, 128, 64): KernelBlocks(block_q=64, block_n=64),
    (16, 128, 128): KernelBlocks(block_q=128, block_n=128),
    (16, 128, 256): KernelBlocks(block_q=256, block_n=128),
    (16, 128, 512): KernelBlocks(block_q=256, block_n=128),
    (8, 32, 16): KernelBlocks(block_q=16, block_n=16),
    (8, 32, 32): KernelBlocks(block_q=32, block_n=32),
    (8, 64, 16): KernelBlocks(block_q=16, block_n=16),
    (8, 64, 32): KernelBlocks(block_q=32, block_n=32),
    (8, 64, 64): KernelBlocks(block_q=64, block_n=64),
    (128, 64, 128): KernelBlocks(block_q=128, block_n=128),
    (128, 64, 256): KernelBlocks(block_q=256, block_n=128),
    (128, 64, 512): KernelBlocks(block_q=512, block_n=128),
    (128, 128, 128): KernelBlocks(block_q=128, block_n=128),
    (128, 128, 256): KernelBlocks(block_q=256, block_n=128),
    (128, 128, 512): KernelBlocks(block_q=256, block_n=128),
}

DEFAULT_TABLE: dict[tuple[int, int, int, str], KernelBlocks] = {
    (*key, dt): blocks for key, blocks in _BASE_TABLE.items() for dt in KV_DTYPES
}


def _heuristic(page_size: int, head_dim: int, bucket: int) -> KernelBlocks:
    """Fallback when no table entry exists: one row per chunk capped at 512
    rows, new-key slices capped at 128."""
    del page_size, head_dim
    return KernelBlocks(block_q=max(16, min(bucket, 512)), block_n=max(16, min(bucket, 128)))


def _clamp(blocks: KernelBlocks, bucket: int) -> KernelBlocks:
    bq = max(1, min(blocks.block_q, max(bucket, 1)))
    bn = max(1, min(blocks.block_n, max(bucket, 1)))
    return KernelBlocks(block_q=bq, block_n=bn)


def lookup_blocks(
    page_size: int, head_dim: int, bucket: int, kv_dtype: str = "none"
) -> KernelBlocks:
    """Table entry for one launch shape, else the heuristic (an unmeasured
    quantized key falls back to the bf16 entry first)."""
    entry = DEFAULT_TABLE.get((page_size, head_dim, bucket, kv_dtype))
    if entry is None and kv_dtype != "none":
        entry = DEFAULT_TABLE.get((page_size, head_dim, bucket, "none"))
    if entry is not None:
        return _clamp(entry, bucket)
    return _heuristic(page_size, head_dim, bucket)
