"""Paged KV cache: device page pool + host-side allocators — counterpart of
``agentfield_tpu/serving/kv_cache.py``.

Layout: ``[num_layers, num_pages, num_kv_heads, page_size, head_dim]`` (the
JAX package's logical layout: one page of one KV head is a contiguous
``[page_size, head_dim]`` block, the unit the kernel streams). Page 0 is a
garbage sink: padding and over-budget tokens route there, its content is
undefined. With ``kv_quant`` ("int8" | "fp8") each pool is an
``ops.kv_quant.QuantPages``: values of that dtype plus ``[L, P, Kh, ps]``
f32 per-slot scales.

``PrefixPagePool`` is the JAX pool: refcounts (``alloc``/``incref``/
``free``), the refcount-0 LRU, the content index over chained page hashes,
``park`` (the preemption primitive), the HBM ``kv_quant_*`` counters, and
the host (offload) tier: refcount-0 indexed pages (parked ones included)
demote to host RAM through an offload worker and restore at the next lookup
in one batched upload. The pool stays device-agnostic: the engine supplies
the ``capture``/``fetch``/``upload`` callbacks. The cluster tier rides the
same store: ``sketch`` summarizes the index for a node's heartbeat,
``export_prep`` serves a peer's fetch, ``adopt_host_pages`` installs the
pages a peer sent (``enable_restore`` arms the restore half without the
demote worker).
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Any, Callable, Iterator, Sequence

import numpy as np
import torch

from agentfield_tpu_torch.models.configs import LlamaConfig
from agentfield_tpu_torch.models.llama import resolve_dtype
from agentfield_tpu_torch.ops.kv_quant import QuantPages, quant_value_dtype
from agentfield_tpu_torch.ops.paged_attention import RaggedRows
from agentfield_tpu_torch.prefix_hash import chain_hash, page_chain_hashes, sketch_digest
from agentfield_tpu_torch.serving import faults


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


TIER_HBM = "hbm"
TIER_HOST = "host"

# Bound on queued demotes: each entry pins a captured device-side copy of its
# page until the worker has moved it, so an unbounded queue under a stalled
# worker would double the device memory the tier exists to reclaim.
_DEMOTE_QUEUE_MAX = 64


@dataclasses.dataclass
class PageRecord:
    """One content-addressed page: its chain hash and the token ids behind it
    (kept to verify against hash collisions). ``tier`` is where its KV lives:
    TIER_HBM in device page ``page``; TIER_HOST in the pool's host store
    under ``chain`` (``page`` is -1 until a restore re-adopts it). ``depth``
    is the page's index in its prefix chain (0 = leading page)."""

    page: int
    chain: bytes
    tokens: tuple[int, ...]
    tier: str = TIER_HBM
    depth: int = 0


class PrefixPagePool:
    """Refcounted, content-addressed page pool with an optional host tier.

    Page states: **free** (free list, garbage content); **live** (refcount
    >= 1, may also be indexed — a published prompt page of a running
    request); **cached** (refcount 0 but indexed: KV valid and reusable, on
    an LRU that allocation evicts only when the free list is empty). Every
    ``alloc``/``lookup``/``incref`` reference is balanced by one ``free``;
    over-release raises. With the host tier on, cached pages demote to host
    RAM (``demote_lru``, ``demote_pages``, the watermark in ``alloc``) and a
    lookup that meets a host record restores it into a fresh page; the
    refcount-0 LRU and the host store form one LRU spanning both tiers.
    Not thread-safe: the engine serializes calls under its session lock (the
    offload worker takes that lock only for its queue pops and commits)."""

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
            # the host tier's counters: always present, zero with the tier off
            "kv_offload_demoted", "kv_offload_restored", "kv_offload_restore_fail",
            "kv_offload_demote_fail", "kv_offload_host_evicted",
            "kv_offload_restore_ms_total",  # host ms of the batched restores
            # the cluster tier: the heartbeat sketch and the cross-node
            # page transfer, always present, zero on a node that never fetches
            "prefix_sketch_truncated_total", "kv_fetch_requested_total",
            "kv_fetch_served_total", "kv_fetch_failed_total", "kv_fetch_bytes_total",
            "kv_fetch_pages_adopted_total",
            # quantized KV pages: always present, zero with quantization off;
            # bytes saved are against the dense page layout at the same count
            # (in the pool, in the host store, on the wire of a served fetch)
            "kv_quant_pages_total", "kv_quant_bytes_saved_total",
            "kv_quant_host_bytes_saved_total", "kv_quant_wire_bytes_saved_total",
        ):
            self.stats.setdefault(k, 0)
        # bytes one quantized page saves in the pool and in the host store
        # (configure_quant)
        self._quant_hbm_saved = self._quant_host_saved = 0
        # -- host tier, inert until enable_host_tier() wires the callbacks
        self._host_enabled = False  # the demote worker runs
        # chain hash -> payload, insertion-ordered: the oldest demotion drops
        # first under budget pressure
        self._host: collections.OrderedDict[bytes, Any] = collections.OrderedDict()
        self._host_bytes = 0
        # (chain, page, captured handle) awaiting the worker's copy; chains
        # queued or mid-copy, so a page is never captured twice
        self._demote_q: collections.deque[tuple[bytes, int, Any]] = collections.deque()
        self._demote_inflight: set[bytes] = set()
        self._host_budget = 0
        self._page_bytes = 1
        self._demote_watermark = 0
        self._ext_lock: Any = None  # the owner's serializer (engine _session_lock)
        self._capture: Callable[[int], Any] | None = None
        self._fetch: Callable[[Any], Any] | None = None
        self._upload: Callable[[list[Any], list[int]], None] | None = None
        self._restore_alloc: Callable[[], list[int] | None] | None = None
        self._offload_wake = threading.Event()
        self._offload_stop = False
        self._offload_thread: threading.Thread | None = None

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
    def host_pages(self) -> int:
        """Host-tier entries. Not allocatable: each restore takes a fresh
        device page, so they never count in ``free_pages``."""
        return len(self._host)

    @property
    def host_bytes(self) -> int:
        return self._host_bytes

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

    def configure_quant(self, hbm_saved_per_page: int,
                        host_saved_per_page: int | None = None) -> None:
        """Arm the quantized-page counters (the engine does, when its
        kv_quant_dtype is not "none"): every page handed out stores its KV
        quantized, so ``alloc`` counts ``kv_quant_pages_total`` and adds the
        per-page saving to ``kv_quant_bytes_saved_total``; a demotion or a
        peer page adopted into the host store adds the host saving (the
        same by default) to ``kv_quant_host_bytes_saved_total``."""
        self._quant_hbm_saved = max(0, int(hbm_saved_per_page))
        self._quant_host_saved = (self._quant_hbm_saved if host_saved_per_page is None
                                  else max(0, int(host_saved_per_page)))

    # -- allocation -----------------------------------------------------

    def alloc(self, n: int) -> list[int] | None:
        """Allocate n pages (refcount 1 each) or None — all-or-nothing.
        Evicts LRU cached pages when the free list runs dry; with the host
        tier on, a free list under the watermark starts demoting the LRU's
        oldest pages first, so that eviction stays the rare path."""
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
        if self._host_enabled and len(self._free) < self._demote_watermark:
            self.demote_lru(8)  # enqueues only: the copies run on the worker
        return out

    def incref(self, pages: list[int]) -> None:
        """One more reference on each page (a fork sharing its parent's
        pages); a cached page gaining a holder leaves the LRU."""
        for p in pages:
            if p == 0 or p >= self.num_pages:
                raise ValueError(f"invalid page id {p}")
            if self._refs[p] == 0:
                if p not in self._by_page:
                    raise ValueError(f"incref of unowned, uncached page {p}")
                self._lru.pop(p, None)
            self._refs[p] += 1

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
        """Walk the longest indexed full-page prefix chain of `tokens`, both
        tiers (the tuple compare guards hash collisions)."""
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
        `tokens`, without taking references (host entries count: they
        restore)."""
        return sum(1 for _ in self._prefix_chain(tokens, hashes)) * self.page_size

    def evictable_prefix_pages(
        self, tokens: Sequence[int], hashes: list[bytes] | None = None
    ) -> int:
        """Of the longest indexed full-page prefix of `tokens`, how many
        pages are refcount-0 on the device tier? They count in
        ``free_pages``, but an admission's ``lookup`` increfs them out of the
        evictable pool, so a capacity probe that subtracts the cached prefix
        from a request's need subtracts this overlap from ``free_pages``
        too. Host entries are not evictable: their restore takes a page."""
        return sum(1 for rec in self._prefix_chain(tokens, hashes)
                   if rec.tier == TIER_HBM and self._refs[rec.page] == 0)

    def host_prefix_pages(
        self, tokens: Sequence[int], hashes: list[bytes] | None = None
    ) -> int:
        """Of the longest indexed full-page prefix of `tokens`, how many
        entries are host-tier (each needs a fresh device page to restore
        into)."""
        if not self._host:
            return 0
        return sum(1 for rec in self._prefix_chain(tokens, hashes) if rec.tier == TIER_HOST)

    def sketch(self, max_bytes: int) -> dict[str, Any]:
        """The prefix index as a node's heartbeat publishes it: the
        truncated digests (``sketch_digest``) of every indexed record of
        both tiers (a host page is fetchable too), leading pages first. The
        gateway scores a node by how many leading pages of a request's chain
        it finds here. ``max_bytes`` caps the JSON (about 19 bytes a digest
        and 64 of envelope): overflow drops the deepest records and counts
        ``prefix_sketch_truncated_total``."""
        cap = max(0, (int(max_bytes) - 64) // 19)
        recs = sorted(self._by_hash.values(), key=lambda r: r.depth)
        truncated = len(recs) > cap
        if truncated:
            self.stats["prefix_sketch_truncated_total"] += 1
            recs = recs[:cap]
        return {"v": 1, "page_size": self.page_size,
                "digests": [sketch_digest(r.chain) for r in recs],
                "truncated": int(truncated)}

    def lookup(
        self, tokens: Sequence[int], hashes: list[bytes] | None = None
    ) -> tuple[list[int], int]:
        """Longest indexed full-page prefix of `tokens`: returns (pages,
        matched token count); the caller owns one reference per page.
        Host entries restore on the way, into freshly allocated pages, in
        one batched upload; a restore that cannot proceed (no page, an
        injected ``kv.restore_fail``, an upload error) ends the match there
        and the caller re-prefills the rest."""
        pages: list[int] = []
        pending: list[tuple[PageRecord, int, Any]] = []  # awaiting the upload
        for rec in self._prefix_chain(tokens, hashes):
            if rec.tier == TIER_HOST:
                prep = self._prepare_restore(rec)
                if prep is None:
                    break
                pending.append(prep)
                pages.append(prep[1])  # its allocation is our reference
                continue
            if self._refs[rec.page] == 0:
                self._lru.pop(rec.page, None)
            self._refs[rec.page] += 1
            pages.append(rec.page)
        if pending and not self._commit_restores(pending):
            # the upload failed: cut the match at the first pending restore
            # (its tentative pages were never indexed: they go back free)
            cut = pages.index(pending[0][1])
            self.free(pages[cut:])
            pages = pages[:cut]
        self.stats["prefix_pages_reused"] += len(pages)
        return pages, len(pages) * self.page_size

    def publish(self, tokens: Sequence[int], pages: list[int]) -> int:
        """Register the full pages of `tokens` (KV resident in position-
        ordered `pages`) under their chain hashes; chains already indexed
        keep their incumbent page — except a host record, which re-adopts
        the publisher's page (its host copy drops). Publish only FINAL
        content: an indexed page is never rewritten (writers copy-on-write).
        Returns the number of newly indexed pages."""
        ps = self.page_size
        h = b""
        n_new = 0
        for i in range(min(len(tokens) // ps, len(pages))):
            page_toks = tuple(tokens[i * ps : (i + 1) * ps])
            h = chain_hash(h, page_toks)
            rec = self._by_hash.get(h)
            if rec is not None:
                if rec.tokens == page_toks:
                    if rec.tier == TIER_HOST:
                        p = pages[i]
                        if p not in self._by_page:
                            if self._host.pop(rec.chain, None) is not None:
                                self._host_bytes -= self._page_bytes
                            rec.tier, rec.page = TIER_HBM, p
                            self._by_page[p] = rec
                            if self._refs[p] == 0:
                                self._lru[p] = None
                    elif self._refs[rec.page] == 0:
                        self._lru.move_to_end(rec.page)
                continue  # same chain cached, or a collision: keep incumbent
            p = pages[i]
            if p in self._by_page:
                continue  # page already names another chain (defensive)
            self._by_page[p] = self._by_hash[h] = PageRecord(
                page=p, chain=h, tokens=page_toks, depth=i)
            if self._refs[p] == 0:
                self._lru[p] = None
            n_new += 1
            self.stats["prefix_pages_published"] += 1
        return n_new

    def park(self, tokens: Sequence[int], pages: list[int]) -> int:
        """Preemption primitive: publish the full pages of `tokens` into the
        content index, then release the caller's reference on every page.
        Indexed pages land on the refcount-0 LRU with their KV valid (the
        preempted request's resume reuses them; the host tier may demote
        them like any cached page), partial tail pages return to the free
        list. Returns the pages left cached."""
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

    # -- host (offload) tier -------------------------------------------
    #
    # Two halves: the restore half (``enable_restore``: a host store with a
    # budget and the batched upload; pages a peer node sent land here
    # through ``adopt_host_pages``) and the demote half (``enable_host_tier``
    # arms both and starts the offload worker). One page's life: HBM cached (refcount-0 LRU) --enqueue (watermark or
    # idle-session expiry)--> demote queue --worker: device-to-host copy
    # outside the lock, then a commit under it, which aborts if the page was
    # reused, incref'd or evicted meanwhile--> HOST (record.tier = HOST, the
    # device page back on the free list) --lookup: fresh page + upload-->
    # HBM cached again, or --host budget pressure--> dropped.

    def enable_host_tier(
        self,
        *,
        budget_bytes: int,
        page_bytes: int,
        lock: Any,
        capture: Callable[[int], Any],
        fetch: Callable[[Any], Any],
        upload: Callable[[list[Any], list[int]], None],
        restore_alloc: Callable[[], list[int] | None] | None = None,
    ) -> None:
        """Arm the host tier and start its offload worker. ``capture(page)``
        snapshots a page's KV as an opaque handle whose content is fixed at
        capture (called under the lock); ``fetch(handle)`` is the blocking
        device-to-host copy (worker thread, no lock held) returning the
        payload; ``upload(payloads, pages)`` is the batched restore (caller
        thread, under the lock). ``restore_alloc`` supplies a restore's
        target page (the engine's session-evicting allocator). ``lock`` must
        be the lock that serializes every other pool call."""
        if budget_bytes <= 0:
            raise ValueError(f"budget_bytes={budget_bytes} must be > 0")
        if self._host_enabled:
            raise RuntimeError("host tier already enabled")
        if self._offload_thread is not None:
            raise RuntimeError("previous offload worker still draining")
        self.enable_restore(budget_bytes=budget_bytes, page_bytes=page_bytes, upload=upload,
                            restore_alloc=restore_alloc)
        self._ext_lock = lock
        self._capture, self._fetch = capture, fetch
        # demote while this many free pages remain: early enough that the
        # copy usually beats hard eviction, late enough that a lightly
        # loaded pool never copies
        self._demote_watermark = max(2, self.num_pages // 8)
        self._offload_stop = False
        self._host_enabled = True
        self._offload_thread = threading.Thread(target=self._offload_worker, name="kv-offload",
                                                daemon=True)
        self._offload_thread.start()

    def enable_restore(
        self,
        *,
        budget_bytes: int,
        page_bytes: int,
        upload: Callable[[list[Any], list[int]], None],
        restore_alloc: Callable[[], list[int] | None] | None = None,
    ) -> None:
        """Arm the restore half only: the upload, the restore allocator and
        a byte budget for host-resident payloads, with no demote worker.
        The cluster tier rides it (peer pages adopted by
        ``adopt_host_pages`` restore through the ordinary lookup), with or
        without local demotion; ``enable_host_tier`` calls it, so "restore
        is armed" has one definition."""
        if budget_bytes <= 0:
            raise ValueError(f"budget_bytes={budget_bytes} must be > 0")
        if page_bytes <= 0:
            raise ValueError(f"page_bytes={page_bytes} must be > 0")
        self._host_budget = int(budget_bytes)
        self._page_bytes = int(page_bytes)
        self._upload = upload
        self._restore_alloc = restore_alloc

    def adopt_host_pages(
        self, entries: Sequence[tuple[bytes, int, tuple[int, ...], Any]]
    ) -> int:
        """Install pages a peer node sent into the host store (caller holds
        the external lock): each entry is ``(chain, depth, tokens,
        payload)``, as a local demotion would have left it. A chain already
        indexed is skipped (local content wins); the next admission's lookup
        restores the rest; budget overflow drops the oldest host entries.
        Returns the number adopted (0 when restore is not armed). The
        caller derives ``chain`` and ``tokens`` from its own prompt, so a
        corrupt peer can only waste host budget: the index never lies about
        the tokens a chain names."""
        if self._upload is None:
            return 0
        n = 0
        for chain, depth, tokens, payload in entries:
            if chain in self._by_hash:
                continue
            self._by_hash[chain] = PageRecord(page=-1, chain=chain, tokens=tuple(tokens),
                                              tier=TIER_HOST, depth=int(depth))
            self._host[chain] = payload
            self._host_bytes += self._page_bytes
            n += 1
            self.stats["kv_fetch_pages_adopted_total"] += 1
            if self._quant_host_saved:
                self.stats["kv_quant_host_bytes_saved_total"] += self._quant_host_saved
        self._evict_host_over_budget()
        return n

    def export_prep(
        self, chains: Sequence[bytes], capture: Callable[[int], Any]
    ) -> list[tuple[bytes, int, Any, str]]:
        """First phase of serving a peer's fetch (caller holds the external
        lock): ``(chain, depth, obj, kind)`` for each requested chain that
        is indexed: ``kind`` "host" with the host payload, or "handle" with
        ``capture(page)`` of a device page (its content fixed at capture,
        so the caller copies it to the host outside the lock). Unknown
        chains are left out, and so is a page whose capture raised: the
        answer is best effort, the requester re-prefills what is missing."""
        out: list[tuple[bytes, int, Any, str]] = []
        for chain in chains:
            rec = self._by_hash.get(chain)
            if rec is None:
                continue
            if rec.tier == TIER_HOST:
                payload = self._host.get(rec.chain)
                if payload is not None:
                    out.append((rec.chain, rec.depth, payload, "host"))
                continue
            try:
                out.append((rec.chain, rec.depth, capture(rec.page), "handle"))
            except Exception:  # noqa: BLE001 — a shorter answer; the peer re-prefills
                continue
        return out

    def _evict_host_over_budget(self) -> None:
        """Over budget, the oldest host entries drop: the far end of the
        spanning LRU (a re-prefill recreates them)."""
        while self._host_bytes > self._host_budget and self._host:
            old_chain, _ = self._host.popitem(last=False)
            self._host_bytes -= self._page_bytes
            self._by_hash.pop(old_chain, None)
            self.stats["kv_offload_host_evicted"] += 1

    def demote_lru(self, n: int | None = None) -> int:
        """Enqueue up to `n` (all, when None) of the oldest refcount-0
        cached pages for demotion; returns the number enqueued (the copies
        land asynchronously: ``offload_drain`` waits). A full queue is a
        no-op, and the bounded form scans at most 4n LRU entries."""
        if not self._host_enabled or len(self._demote_q) >= _DEMOTE_QUEUE_MAX:
            return 0
        scan = iter(self._lru) if n is None else itertools.islice(self._lru, 4 * n)
        count = 0
        for p in list(scan):
            if n is not None and count >= n:
                break
            if self._enqueue_demote(p):
                count += 1
        return count

    def demote_pages(self, pages: Sequence[int]) -> int:
        """Enqueue specific pages for demotion (idle-session expiry); pages
        that are not refcount-0 indexed entries are skipped."""
        if not self._host_enabled:
            return 0
        return sum(1 for p in pages if self._enqueue_demote(p))

    def _enqueue_demote(self, page: int) -> bool:
        rec = self._by_page.get(page)
        if (
            rec is None
            or self._refs[page] != 0
            or rec.chain in self._demote_inflight
            or len(self._demote_q) >= _DEMOTE_QUEUE_MAX
            or self._page_bytes > self._host_budget
        ):
            return False
        try:
            handle = self._capture(page)
        except Exception:
            self.stats["kv_offload_demote_fail"] += 1
            return False
        self._demote_q.append((rec.chain, page, handle))
        self._demote_inflight.add(rec.chain)
        self._offload_wake.set()
        return True

    def _offload_worker(self) -> None:
        """Drain the demote queue: the copy outside the lock, an O(1) commit
        under it."""
        while True:
            self._offload_wake.wait(timeout=0.5)
            self._offload_wake.clear()
            if self._offload_stop:
                return
            while True:
                with self._ext_lock:
                    if not self._demote_q:
                        break
                    chain, page, handle = self._demote_q.popleft()
                try:
                    payload = self._fetch(handle)  # blocking copy, no lock
                except Exception:
                    with self._ext_lock:
                        self._demote_inflight.discard(chain)
                        self.stats["kv_offload_demote_fail"] += 1  # the page stays cached
                    continue
                del handle  # the captured device copy goes now
                fault = faults.fire("kv.offload_stall")
                if fault is not None and fault.delay_s > 0:
                    time.sleep(fault.delay_s)
                with self._ext_lock:
                    self._demote_inflight.discard(chain)
                    self._commit_demote(chain, page, payload)

    def _commit_demote(self, chain: bytes, page: int, payload: Any) -> None:
        if self._offload_stop:
            return  # close() stopped demotion: a late copy commits nothing
        rec = self._by_hash.get(chain)
        if rec is None or rec.tier != TIER_HBM or rec.page != page or self._refs[page] != 0:
            # evicted, reallocated or incref'd while the copy was in flight:
            # the device state wins and the copy is discarded
            return
        self._host[chain] = payload
        self._host_bytes += self._page_bytes
        del self._by_page[page]
        self._lru.pop(page, None)
        self._free.append(page)
        rec.tier, rec.page = TIER_HOST, -1
        self.stats["kv_offload_demoted"] += 1
        if self._quant_host_saved:
            self.stats["kv_quant_host_bytes_saved_total"] += self._quant_host_saved
        self._evict_host_over_budget()

    def _prepare_restore(self, rec: PageRecord) -> tuple[PageRecord, int, Any] | None:
        """A restore's first phase (under the lock): the fault schedule, the
        payload, the target page. None keeps the host entry (a later attempt
        may succeed; a re-prefill's publish re-adopts the chain)."""
        if faults.fire("kv.restore_fail") is not None:
            self.stats["kv_offload_restore_fail"] += 1
            return None
        payload = self._host.get(rec.chain)
        if payload is None:
            return None
        got = self._restore_alloc() if self._restore_alloc is not None else self.alloc(1)
        if got is None:
            self.stats["kv_offload_restore_fail"] += 1  # too full to restore into
            return None
        return rec, got[0], payload

    def _commit_restores(self, pending: list[tuple[PageRecord, int, Any]]) -> bool:
        """One batched upload for every page the walk matched on the host
        tier, then the index flips. All or nothing: on an upload failure
        nothing commits (entries kept, the caller cuts its match)."""
        t0 = time.perf_counter()
        try:
            self._upload([p for _, _, p in pending], [pg for _, pg, _ in pending])
        except Exception:
            self.stats["kv_offload_restore_fail"] += 1
            return False
        self.stats["kv_offload_restore_ms_total"] += (time.perf_counter() - t0) * 1e3
        for rec, page, _ in pending:
            del self._host[rec.chain]
            self._host_bytes -= self._page_bytes
            rec.tier, rec.page = TIER_HBM, page
            self._by_page[page] = rec
            self.stats["kv_offload_restored"] += 1
        return True

    def offload_drain(self, timeout: float = 10.0) -> bool:
        """Block until the demote queue is empty and no copy is in flight.
        Call it without the external lock held: the worker needs it."""
        if not self._host_enabled:
            return True
        deadline = time.monotonic() + timeout
        self._offload_wake.set()
        while time.monotonic() < deadline:
            with self._ext_lock:
                if not self._demote_q and not self._demote_inflight:
                    return True
            time.sleep(0.002)
        return False

    def close(self) -> None:
        """Stop the offload worker (idempotent). Host entries still restore;
        only demotion stops: the tier disarms and the queue clears before
        the join, so a worker stalled past it can never commit."""
        t = self._offload_thread
        if t is None:
            return
        self._offload_stop = True
        self._offload_wake.set()
        with self._ext_lock:
            self._host_enabled = False
            self._demote_q.clear()  # drop the captured device copies
            self._demote_inflight.clear()
        t.join(timeout=5.0)
        if not t.is_alive():
            self._offload_thread = None
