"""Paged KV cache: device page pool + host-side allocators — counterpart of
``agentfield_tpu/serving/kv_cache.py``.

Layout: ``[num_layers, num_pages, num_kv_heads, page_size, head_dim]`` (the
JAX package's logical layout: one page of one KV head is a contiguous
``[page_size, head_dim]`` block, the unit the kernel streams). Page 0 is a
garbage sink: padding and over-budget tokens route there, its content is
undefined. With ``kv_quant`` ("int8" | "fp8") each pool is an
``ops.kv_quant.QuantPages``: values of that dtype plus ``[L, P, Kh, ps]``
f32 per-slot scales.

``PrefixPagePool`` is ported for the device (HBM) tier only: refcounts, the
refcount-0 LRU, the content index over chained page hashes, ``park`` (the
preemption primitive) and the HBM ``kv_quant_*`` counters. The host tier,
demotion (also of parked pages), peer adoption, the fault hooks and the
host/wire ``kv_quant_*`` counters are not ported yet.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Iterator, Sequence

import numpy as np
import torch

from agentfield_tpu_torch.models.configs import LlamaConfig
from agentfield_tpu_torch.models.llama import resolve_dtype
from agentfield_tpu_torch.ops.kv_quant import QuantPages, quant_value_dtype
from agentfield_tpu_torch.ops.paged_attention import RaggedRows
from agentfield_tpu_torch.prefix_hash import chain_hash, page_chain_hashes


@dataclasses.dataclass
class PagedKVCache:
    # [L, P, Kh, ps, hd] tensors, or QuantPages (values + [L, P, Kh, ps]
    # scales) when kv_quant != "none"; written in place
    k_pages: torch.Tensor | QuantPages
    v_pages: torch.Tensor | QuantPages
    page_size: int
    kv_quant: str = "none"

    @property
    def num_pages(self) -> int:
        return self.k_pages.shape[1]

    @staticmethod
    def create(
        cfg: LlamaConfig,
        num_pages: int,
        page_size: int,
        dtype: str | torch.dtype | None = None,
        device: str | torch.device = "cuda",
        kv_quant: str = "none",
    ) -> "PagedKVCache":
        """``kv_quant`` ("int8" | "fp8") stores the pages quantized with
        per-slot scales; scales start at 0, so fresh pages dequantize to the
        zeros a plain pool holds (``dtype`` is then unused)."""
        shape = (cfg.num_layers, num_pages, cfg.num_kv_heads, page_size, cfg.head_dim)
        if kv_quant != "none":
            qdt = quant_value_dtype(kv_quant)

            def mk():
                return QuantPages(
                    torch.zeros(shape, dtype=qdt, device=device),
                    torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                )

            k, v = mk(), mk()
        else:
            dt = resolve_dtype(dtype or cfg.dtype)
            k = torch.zeros(shape, dtype=dt, device=device)
            v = torch.zeros(shape, dtype=dt, device=device)
        return PagedKVCache(k_pages=k, v_pages=v, page_size=page_size, kv_quant=kv_quant)

    def leaves(self) -> list[torch.Tensor]:
        """Every tensor of the two pools: values, and scales when quantized."""
        return [t for pool in (self.k_pages, self.v_pages)
                for t in (pool if isinstance(pool, QuantPages) else (pool,))]

    def layer(self, i: int):
        """Layer ``i``'s ``(K, V)`` pools (views; ``QuantPages`` when
        quantized)."""
        return tuple(QuantPages(p.q[i], p.scale[i]) if isinstance(p, QuantPages) else p[i]
                     for p in (self.k_pages, self.v_pages))

    def hbm_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.leaves())

    def page_bytes(self) -> int:
        """Bytes ONE page occupies across all layers, K+V, including the
        per-slot scales of a quantized pool."""
        return sum(t.numel() // t.shape[1] * t.element_size() for t in self.leaves())


class PageAllocator:
    """Host-side free-list allocator over the device page pool. Page 0 is
    never handed out (garbage sink); pops yield 1, 2, ... like the JAX one."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self._free: list[int] = list(range(num_pages - 1, 0, -1))  # pop() yields 1,2,...
        self.num_pages = num_pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """Allocate n pages or None (all-or-nothing)."""
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: list[int]) -> None:
        for p in pages:
            if p == 0 or p >= self.num_pages:
                raise ValueError(f"invalid page id {p}")
            if p in self._free:
                raise ValueError(f"double free of page {p}")
            self._free.append(p)


def build_page_table(pages: list[int], max_pages: int) -> np.ndarray:
    """Fixed-width page-table row; unused entries point at garbage page 0."""
    if len(pages) > max_pages:
        raise ValueError(f"{len(pages)} pages exceed table width {max_pages}")
    row = np.zeros((max_pages,), np.int32)
    row[: len(pages)] = pages
    return row


def pack_ragged_rows(
    rows: Sequence[tuple[np.ndarray, int, Sequence[int]]],
    max_pages: int,
    budget: int,
    block_q: int = 1,
) -> RaggedRows:
    """Pack ragged ``(page_table_row, start_pos, tokens)`` entries into the
    kernel's descriptor: each entry becomes ``ceil(len(tokens) / block_q)``
    rows of width ``block_q`` sharing a launch-local ``seq_id``;
    ``ctx_lens`` is the entry's ``start_pos`` for every row it spans.
    Padding rows carry ``n_tokens`` 0 / ``seq_id`` -1. Capacity is
    ``budget // block_q`` rows; overflow raises."""
    W = max(1, block_q)
    R = budget // W
    tokens = np.zeros((R, W), np.int32)
    tables = np.zeros((R, max_pages), np.int32)
    row_starts = np.zeros((R,), np.int32)
    n_tokens = np.zeros((R,), np.int32)
    ctx_lens = np.zeros((R,), np.int32)
    seq_ids = np.full((R,), -1, np.int32)
    last_flat: list[int] = []
    r = 0
    for sid, (row, start, toks) in enumerate(rows):
        n = len(toks)
        if n == 0:
            raise ValueError("ragged entry with zero tokens")
        need = -(-n // W)
        if r + need > R:
            raise ValueError(
                f"ragged rows need {r + need}+ rows > capacity {R} (budget {budget} / block_q {W})"
            )
        for i in range(need):
            chunk = toks[i * W : (i + 1) * W]
            tokens[r, : len(chunk)] = np.asarray(chunk, np.int32)
            tables[r] = row
            row_starts[r] = start + i * W
            n_tokens[r] = len(chunk)
            ctx_lens[r] = start
            seq_ids[r] = sid
            r += 1
        last_flat.append((r - 1) * W + (n - 1) % W)
    return RaggedRows(
        tokens=tokens,
        page_tables=tables,
        row_starts=row_starts,
        n_tokens=n_tokens,
        ctx_lens=ctx_lens,
        seq_ids=seq_ids,
        last_flat=last_flat,
    )


@dataclasses.dataclass
class PageRecord:
    """One content-addressed page: its chain hash and the token ids behind it
    (kept to verify against hash collisions)."""

    page: int
    chain: bytes
    tokens: tuple[int, ...]


class PrefixPagePool:
    """Refcounted, content-addressed page pool (device tier).

    Page states: **free** (free list, garbage content); **live** (refcount
    >= 1, may also be indexed — a published prompt page of a running
    request); **cached** (refcount 0 but indexed: KV valid and reusable, on
    an LRU that allocation evicts only when the free list is empty). Every
    ``alloc``/``lookup`` reference is balanced by one ``free``; over-release
    raises. Not thread-safe: the engine serializes calls under its session
    lock."""

    def __init__(self, num_pages: int, page_size: int, stats: dict | None = None):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        if page_size < 1:
            raise ValueError(f"page_size={page_size} must be >= 1")
        self.num_pages = num_pages
        self.page_size = page_size
        self._refs = [0] * num_pages
        self._free: list[int] = list(range(num_pages - 1, 0, -1))  # pop() yields 1,2,...
        self._by_hash: dict[bytes, PageRecord] = {}
        self._by_page: dict[int, PageRecord] = {}
        # refcount-0 cached pages in eviction order (oldest first)
        self._lru: collections.OrderedDict[int, None] = collections.OrderedDict()
        self.stats = stats if stats is not None else {}
        for k in (
            "prefix_pages_published", "prefix_pages_evicted", "prefix_pages_reused",
            # quantized KV pages: always present, zero with quantization off;
            # bytes saved are against the dense page layout at the same count
            "kv_quant_pages_total", "kv_quant_bytes_saved_total",
        ):
            self.stats.setdefault(k, 0)
        self._quant_hbm_saved = 0  # bytes one quantized page saves (configure_quant)

    # -- gauges ---------------------------------------------------------

    @property
    def free_pages(self) -> int:
        """Allocatable pages: the free list plus refcount-0 cached pages."""
        return len(self._free) + len(self._lru)

    @property
    def cached_pages(self) -> int:
        """Pages resident in the content index (live shared + refcount-0)."""
        return len(self._by_page)

    @property
    def shared_pages(self) -> int:
        """Indexed pages currently referenced by 2+ holders."""
        return sum(1 for p in self._by_page if self._refs[p] > 1)

    def refcount(self, page: int) -> int:
        return self._refs[page]

    def is_shared(self, page: int) -> bool:
        """True when writing this page could be observed by someone else:
        it is content-addressed or another holder references it."""
        return page in self._by_page or self._refs[page] > 1

    def configure_quant(self, hbm_saved_per_page: int) -> None:
        """Arm the quantized-page counters (the engine does, when its
        kv_quant_dtype is not "none"): every page handed out stores its KV
        quantized, so ``alloc`` counts ``kv_quant_pages_total`` and adds the
        per-page saving to ``kv_quant_bytes_saved_total``."""
        self._quant_hbm_saved = max(0, int(hbm_saved_per_page))

    # -- allocation -----------------------------------------------------

    def alloc(self, n: int) -> list[int] | None:
        """Allocate n pages (refcount 1 each) or None — all-or-nothing.
        Evicts LRU cached pages when the free list runs dry."""
        if n > self.free_pages:
            return None
        out = []
        for _ in range(n):
            if self._free:
                p = self._free.pop()
            else:
                p, _ = self._lru.popitem(last=False)  # oldest cached page
                rec = self._by_page.pop(p)
                del self._by_hash[rec.chain]
                self.stats["prefix_pages_evicted"] += 1
            self._refs[p] = 1
            out.append(p)
        if self._quant_hbm_saved:
            self.stats["kv_quant_pages_total"] += n
            self.stats["kv_quant_bytes_saved_total"] += n * self._quant_hbm_saved
        return out

    def free(self, pages: list[int]) -> None:
        """Release one reference per page. Refcount-0 pages return to the
        free list unless indexed — those stay cached on the LRU."""
        for p in pages:
            if p == 0 or p >= self.num_pages:
                raise ValueError(f"invalid page id {p}")
            if self._refs[p] <= 0:
                raise ValueError(f"over-free of page {p} (refcount already 0)")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                if p in self._by_page:
                    self._lru[p] = None  # newest cached entry
                else:
                    self._free.append(p)

    # -- content index --------------------------------------------------

    def _prefix_chain(
        self, tokens: Sequence[int], hashes: list[bytes] | None = None
    ) -> Iterator[PageRecord]:
        """Walk the longest indexed full-page prefix chain of `tokens` (the
        tuple compare guards hash collisions)."""
        ps = self.page_size
        if hashes is None:
            hashes = page_chain_hashes(tokens, ps)
        for i, h in enumerate(hashes):
            rec = self._by_hash.get(h)
            if rec is None or rec.tokens != tuple(tokens[i * ps : (i + 1) * ps]):
                return
            yield rec

    def peek(self, tokens: Sequence[int], hashes: list[bytes] | None = None) -> int:
        """Length (tokens) of the longest indexed full-page prefix of
        `tokens`, without taking references."""
        return sum(1 for _ in self._prefix_chain(tokens, hashes)) * self.page_size

    def evictable_prefix_pages(
        self, tokens: Sequence[int], hashes: list[bytes] | None = None
    ) -> int:
        """Of the longest indexed full-page prefix of `tokens`, how many
        pages are refcount-0 (on the LRU)? They count in ``free_pages``, but
        an admission's ``lookup`` increfs them out of the evictable pool, so
        a capacity probe that subtracts the cached prefix from a request's
        need subtracts this overlap from ``free_pages`` too."""
        return sum(1 for rec in self._prefix_chain(tokens, hashes) if self._refs[rec.page] == 0)

    def lookup(
        self, tokens: Sequence[int], hashes: list[bytes] | None = None
    ) -> tuple[list[int], int]:
        """Longest indexed full-page prefix of `tokens`: returns (pages,
        matched token count); the caller owns one reference per page."""
        pages: list[int] = []
        for rec in self._prefix_chain(tokens, hashes):
            if self._refs[rec.page] == 0:
                self._lru.pop(rec.page, None)
            self._refs[rec.page] += 1
            pages.append(rec.page)
        self.stats["prefix_pages_reused"] += len(pages)
        return pages, len(pages) * self.page_size

    def publish(self, tokens: Sequence[int], pages: list[int]) -> int:
        """Register the full pages of `tokens` (KV resident in position-
        ordered `pages`) under their chain hashes; chains already indexed
        keep their incumbent page. Publish only FINAL content: an indexed
        page is never rewritten (writers copy-on-write). Returns the number
        of newly indexed pages."""
        ps = self.page_size
        h = b""
        n_new = 0
        for i in range(min(len(tokens) // ps, len(pages))):
            page_toks = tuple(tokens[i * ps : (i + 1) * ps])
            h = chain_hash(h, page_toks)
            rec = self._by_hash.get(h)
            if rec is not None:
                if rec.tokens == page_toks and self._refs[rec.page] == 0:
                    self._lru.move_to_end(rec.page)
                continue  # same chain cached, or a collision: keep incumbent
            p = pages[i]
            if p in self._by_page:
                continue  # page already names another chain (defensive)
            self._by_page[p] = self._by_hash[h] = PageRecord(page=p, chain=h, tokens=page_toks)
            if self._refs[p] == 0:
                self._lru[p] = None
            n_new += 1
            self.stats["prefix_pages_published"] += 1
        return n_new

    def park(self, tokens: Sequence[int], pages: list[int]) -> int:
        """Preemption primitive: publish the full pages of `tokens` into the
        content index, then release the caller's reference on every page.
        Indexed pages land on the refcount-0 LRU with their KV valid (the
        preempted request's resume reuses them), partial tail pages return
        to the free list. Returns the pages left cached."""
        self.publish(tokens, pages)
        self.free(pages)
        return sum(1 for p in pages if p in self._by_page)

    def forget(self, page: int) -> None:
        """Drop a page from the content index (its KV is about to change).
        Live references are unaffected; a refcount-0 page moves to free."""
        rec = self._by_page.pop(page, None)
        if rec is None:
            return
        del self._by_hash[rec.chain]
        if page in self._lru:
            del self._lru[page]
        if self._refs[page] == 0:
            self._free.append(page)
