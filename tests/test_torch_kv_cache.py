"""The port's page allocators and row packer against the JAX package's: the
same script of calls gives the same page ids, refcounts, evictions and
descriptors."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from agentfield_tpu.serving import kv_cache as jax_kv
from agentfield_tpu_torch.models.configs import get_config
from agentfield_tpu_torch.serving import kv_cache as kv


def _prompt(seed: int, n: int, head: list[int] | None = None) -> list[int]:
    toks = np.random.default_rng(seed).integers(1, 500, n).tolist()
    return (head or []) + toks


def _pool_script(pool, out: list):
    """Alloc / publish / lookup / free / forget / evict, recording
    every result and the full refcount state after each call."""
    ps = pool.page_size
    n = pool.num_pages

    def rec(tag, value):
        out.append((tag, value, [pool.refcount(p) for p in range(n)], pool.free_pages,
                    pool.cached_pages, pool.shared_pages))

    shared = _prompt(0, 3 * ps)
    a = pool.alloc(4)
    rec("alloc a", a)
    rec("publish a", pool.publish(shared + [7], a))
    rec("peek", pool.peek(shared + _prompt(1, 5)))
    m, cnt = pool.lookup(shared + _prompt(2, ps + 3))
    rec("lookup b", (m, cnt))
    b_extra = pool.alloc(2)
    rec("alloc b extra", b_extra)
    rec("publish b", pool.publish(shared + _prompt(2, ps + 3), m + b_extra))
    rec("is_shared", [pool.is_shared(p) for p in range(n)])
    pool.free(a)
    rec("free a", None)
    pool.free(m + b_extra)
    rec("free b", None)
    # drain the free list so allocation must evict cached pages (LRU order)
    big = pool.alloc(pool.free_pages - 3)
    rec("alloc big", big)
    c = pool.alloc(3)
    rec("alloc c (evicts)", c)
    rec("lookup after evict", pool.lookup(shared))
    rec("alloc too many", pool.alloc(10_000))
    pool.forget(c[0])
    rec("forget", None)
    pool.free(c + big)
    rec("free all", None)
    # preemption: park a live sequence (full pages cached, the tail freed),
    # then the evictable overlap of a prompt over the parked prefix
    d = pool.alloc(3)
    parked = _prompt(5, 2 * ps + 3)
    rec("park d", pool.park(parked, d))
    rec("evictable", pool.evictable_prefix_pages(parked + [1]))
    resumed, n = pool.lookup(parked)
    rec("resume d", (resumed, n))
    rec("evictable after", pool.evictable_prefix_pages(parked + [1]))
    pool.free(resumed)
    rec("free resumed", None)
    with pytest.raises(ValueError):
        pool.free([c[1]])
    with pytest.raises(ValueError):
        pool.free([0])


@pytest.mark.parametrize("num_pages,ps", [(16, 4), (24, 8)])
def test_prefix_page_pool_same_script_same_state(num_pages, ps):
    js, ts = {}, {}
    want, got = [], []
    _pool_script(jax_kv.PrefixPagePool(num_pages, ps, stats=js), want)
    _pool_script(kv.PrefixPagePool(num_pages, ps, stats=ts), got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w, g[0]
    for k in ("prefix_pages_published", "prefix_pages_evicted", "prefix_pages_reused"):
        assert ts[k] == js[k], k
    assert ts["prefix_pages_evicted"] > 0


def test_page_allocator_same_ids():
    j, t = jax_kv.PageAllocator(12), kv.PageAllocator(12)
    for step in ([3], [5], [4], [2]):
        assert t.alloc(step[0]) == j.alloc(step[0])
    assert t.free_pages == j.free_pages
    for pages in ([2, 5], [9]):
        j.free(pages)
        t.free(pages)
        assert t.alloc(2) == j.alloc(2)
    assert t.alloc(99) is None and j.alloc(99) is None
    for bad in ([0], [12], [1, 1]):
        with pytest.raises(ValueError):
            kv.PageAllocator(12).free(bad)


@pytest.mark.parametrize("block_q", [1, 4, 16])
def test_pack_ragged_rows_array_equal(block_q):
    rng = np.random.default_rng(block_q)
    maxp = 6
    entries = [
        (rng.integers(1, 50, maxp).astype(np.int32), int(s), rng.integers(0, 500, n).tolist())
        for s, n in ((0, 9), (17, 1), (5, 33), (40, 4))
    ]
    budget = 64 * block_q
    want = jax_kv.pack_ragged_rows(entries, maxp, budget, block_q)
    got = kv.pack_ragged_rows(entries, maxp, budget, block_q)
    for f in ("tokens", "page_tables", "row_starts", "n_tokens", "ctx_lens", "seq_ids"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.last_flat == want.last_flat
    with pytest.raises(ValueError):
        kv.pack_ragged_rows(entries, maxp, budget=block_q, block_q=block_q)


def test_build_page_table_same():
    np.testing.assert_array_equal(
        kv.build_page_table([3, 1, 4], 6), jax_kv.build_page_table([3, 1, 4], 6)
    )
    with pytest.raises(ValueError):
        kv.build_page_table([1] * 7, 6)


def test_paged_kv_cache_layout():
    cfg = get_config("llama-tiny")
    c = kv.PagedKVCache.create(cfg, num_pages=10, page_size=8, device="cpu")
    assert tuple(c.k_pages.shape) == (cfg.num_layers, 10, cfg.num_kv_heads, 8, cfg.head_dim)
    assert c.k_pages.dtype == torch.float32 and c.num_pages == 10
    assert c.v_pages.shape == c.k_pages.shape and not c.k_pages.any()
    assert c.page_size == 8
