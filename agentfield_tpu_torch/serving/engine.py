"""Continuous-batching inference engine — counterpart of the JAX package's
``agentfield_tpu/serving/engine.py``, classic tick.

Scheduling is the JAX engine's: bounded admission with backpressure; up to
``prefill_batch`` fresh prompts coalesce into one batched prefill; cache-hit
prompts (session or shared-prefix index) and long (chunked) prompts take the
single-request path, their suffix prefilled over the cached pages; a tick
that admits nothing dispatches ``decode_span`` decode steps. Finished
requests publish their full pages into the shared-prefix index and retain
their KV as a session for the next turn.

The decode tick is the JAX engine's default: with ``async_decode`` a
one-deep pipeline (step N is dispatched before step N-1's tokens are read;
admission and any change of membership harvest the step in flight first; a
slot that finished discards its in-flight token); with ``decode_buckets``
few active slots decode in a compact batch of the smallest bucket width
that holds them (padding rows inert, ``seq_len`` 0). The control state lives
on the device and chains from step to step (``serving.decode_step``): on the
card the step — every layer's forward through the kernel, the unembed,
grammar mask, sampler and logprob gather, the advance of tokens and lengths
— is one CUDA graph per (width, sampler variant, mode), captured
at first use and replayed after. With ``grammar_slots`` the engine keeps the
JAX engine's int16 transition bank of ``Request.grammar`` automata
(``serving.grammar``) and masks each constrained row's logits in the step.

Every attention call goes through the hand-written kernel on the card: dense
prefill through ``dense_causal_attention`` (the JAX ``prefill_impl="flash"``),
suffix/chunked prefill and decode through ``ragged_paged_attention`` with
the KV write fused (JAX ``chunk_attn_impl="pallas"``, ``attn_impl="pallas"``).
``prefill_chunk`` resolves to ``min(512, max_context)`` when unset, as the
JAX engine does on its kernel path. On CPU tensors the same calls take the
plain versions. ``kv_quant_dtype`` ("int8" | "fp8") stores the KV pages
quantized with per-slot scales: the dense-prefill scatter quantizes through
``ops.kv_quant.write_pages``, and the kernel dequantizes cached pages and
quantizes its fused write.

Overload control is the JAX engine's: the pending queue is kept in priority
tiers (``Request.priority``, FIFO within a tier); ``request_cancel`` frees a
pending, mid-prefill or active request at the next step; ``Request.
deadline_s`` ends a request with ``finish_reason="deadline_exceeded"`` (a
pending one is shed before it admits) and ``deadline_all_now`` gives every
live request that end; a higher-priority request starved for
``preempt_fence_ticks`` ticks preempts the lowest-priority slot, whose KV is
parked in the shared-prefix index and whose request re-queues with its
generated tokens folded into the prompt, to resume through a prefix hit.

With ``mixed_step`` (the JAX token-budget tick), prompts that arrive while
decodes are in flight prefill chunk by chunk inside the decode tick: one
ragged launch a layer packs one token row per active slot and up to
``mixed_step_budget - n_active`` prefill-chunk token rows (``n_tokens`` 1
each, a chunk's rows sharing a ``seq_id``), through the kernel's
split-context path on the card. ``scheduler_stats()`` gives the
inter-token latency percentiles and the tokens carried per tick.

With ``spec_k`` and a draft model (``InferenceEngine(draft=(params,
cfg))``), the JAX engine's speculative decoding: each eligible dispatch runs
one ``serving.spec_decode`` step (the draft proposes ``spec_k`` tokens, the
target verifies them in one ``spec_k + 1``-wide ragged forward, each row
emits 1..spec_k+1 tokens), one CUDA graph per (width, sampler variant, k) on
the card. The draft keeps its own page pool on the target's page ids (one
allocator governs both): every prefill replays onto it, a copy-on-write
copies both, and rows that fell back to plain decode (a grammar row in the
batch) replay their missed tokens through the draft before the next spec
step (``_resync_draft``).

With ``host_cache_bytes`` (the JAX engine's host tier) refcount-0 cached
pages demote to host RAM when an idle session expires (``gc_sessions``) and
under allocation pressure: the page is cloned on the engine's stream
(``_capture_page_kv``: the pool is written in place, so a view read later
could see a reused page), the offload worker copies the clone into pinned
host slots on a stream of its own (``_fetch_page_kv``), and a later prefix
lookup restores the pages into the same pool storage, one ``index_copy_`` a
leaf on the engine's stream (``_upload_page_kv``), so the decode graphs that
hold the pool's addresses read the restored pages. int8/fp8 pages and
their scales round-trip as raw bytes.

``Request.n_branches`` forks a just-prefilled request into siblings (the
JAX engine's branch decoding): the prompt's full pages are shared through
``incref``, the partial tail page is copied, and each sibling samples its
first token from the same logits and decodes as an ordinary batch-mate
(``serving.branching`` ids). ``request_fork`` clones a live slot the same
way inside ``step()`` (beam re-forks); a fork that cannot land ends with a
``fork_failed`` terminal. The ``engine.page_pressure`` and
``engine.preempt_storm`` fault points are consulted as in the JAX engine.

A MoE model (Mixtral, ``cfg.num_experts > 0``) runs the JAX engine's split:
decode, the mixed tick and the speculative verify always soft-route (every
expert's weights stream each step anyway); prefill forwards (dense,
suffix, the draft's replays) run under ``prefill_cfg``, which
``EngineConfig.moe_prefill_impl="sparse"`` flips to capacity-based
dispatch. Prefill padding is masked out of dispatch, and expert capacity is
sized from the token count the JAX engine's prefill has for the same
prompts (its bucket, times ``prefill_batch`` rows for a batch), so the same
entries overflow in both engines.

Observability is the JAX engine's: a ``Request.trace`` context gets the
lifecycle spans of ``agentfield_tpu_torch.tracing`` (``engine.queue_wait``,
``engine.prefill``, ``engine.decode``, ``engine.park`` across a preemption,
``engine.fork``, ``engine.kv_restore``) at the JAX engine's points:
``engine.prefill`` closes at the install, where the host reads the request's
first sampled token, and ``engine.decode`` at the event that finishes it
(under the pipelined decode, the harvest one step after that token's
dispatch). Every tick with work appends one row to ``flight``, the flight
recorder; a tick that raises appends an ``error`` row first.

``Request.mm_embeds`` (the JAX engine's multimodal seam): a prompt whose
placeholder spans take a vision or audio tower's embeddings prefills whole
through ``_dense_prefill`` (one ``dense_causal_attention`` launch a layer,
whatever its length: ``prefill_chunk`` does not cut it), the embeddings
substituted after the token embedding; a draft prefills the placeholder
ids. Such a request is kept out of the session and shared-prefix caches,
batch admission, forks, preemption and the mixed tick, as in the JAX
engine.

The cluster tier is the JAX engine's: ``prefix_sketch`` summarizes the
prefix index for the node's heartbeat, ``export_kv_pages`` serves a peer
node's fetch (the pages captured under the session lock, copied to the host
outside it), and ``adopt_kv_pages`` puts the pages a peer sent into the host
store, whence the next admission's prefix walk restores them as it restores
demoted pages (``enable_restore`` arms that half of the tier on every
shared-prefix engine, whether or not ``host_cache_bytes`` starts a demote
worker). ``page_payload_spec`` and ``build_page_payload`` are the wire
contract of one page: the pool's leaves in the JAX order (K, V; values then
scales when quantized) under the JAX dtype names.

Two-phase dispatch (the JAX engine's live-slot handoff): a request with
``handoff_export`` prefills, samples its first token, publishes its full
pages, stashes its partial tail page with the sampler state, frees its pages
and ends with ``finish_reason="handoff"`` (``pop_handoff_desc`` gives the
descriptor, ``export_handoff_tail`` the tail once); a request with
``handoff`` whose prefix walk matched every full prompt page and whose tail
was adopted (``adopt_handoff_tail``) installs its slot live with the
phase-1 token and no prefill. Every shortfall falls back to the ordinary
path, which re-samples the same first token under greedy.

Agent-aware serving (``spec_prefill``, the JAX engine's keep-warm): a
request with ``expect_followup`` pins its session when it finishes (exempt
from ``session_ttl`` and from the eviction ladder's first rung until the
follow-up admits or ``spec_pin_ttl`` passes), and each of its
``followup_candidates`` is prefilled over the session by a bottom-priority
internal job whose pages stash in the session's speculation state; the
follow-up's admission absorbs the winner through the prefix index and frees
the losers. The ``spec.fail`` and ``spec.stall`` fault points veto or defer
the jobs.

Tensor parallelism (``InferenceEngine(mesh=)``, the JAX engine's ``mesh={
"model": tp}``): the JAX engine is one controller over sharded arrays; here
one process per rank holds its slice (``parallel.sharding``), and rank 0's
engine owns everything on the host — scheduler, prefix index, sampler,
clock, deadlines, threads. Each device operation at the boundary where the
engine reaches the model (``_tp_op``: the dense and suffix prefills, the
draft's catch-up, the mixed tick's forward, a decode state's load, a decode
step's run or graph replay, a page copy, an embed forward) is first sent to
the ranks 1..tp-1 (``parallel.worker``), whose engines run the same method
on their shards, so every collective of the model is met in the same order
on every rank. Rank 0 alone samples: a decode or speculative step
broadcasts its sampled tokens (the acceptance counts and corrections of a
speculative step) to the workers, whose steps take them. Under gloo the
collectives cannot be captured in a CUDA graph, so the decode runs eager
(``graph_stats()["eager"]`` says why); under NCCL every rank captures and
replays its own graph of the same key, the collectives inside. MoE is not
ported under a mesh and raises ``NotImplementedError`` naming its ROADMAP
item.

The host tier, the cluster tier and handoff run under a mesh too, rank 0's
pool deciding every demotion, restore, export and adoption, and no
collective runs off the tick thread: a demotion's copy runs on the pool's
offload thread and a peer's fetch on the node's, and a collective issued
there would interleave with the tick's, so the ranks would meet different
collectives. So each rank keeps its own heads of a page. A capture is an
operation of the ordered stream (``_tp_capture``): every rank clones its
slice at the same point relative to the kernel's fused in-place writes, and
a worker copies its slice to its own host store at once and keeps it under
rank 0's capture id until rank 0 drops the page (``_TPRef``, released in
the stream). A restore is one operation (``_tp_upload``): each rank uploads
its own slice, or its heads of a page that came from the wire, which rank 0
cuts and sends in the operation. Whole pages exist only at the wire:
``page_payload_spec``, ``export_kv_pages`` and ``page_payload_bytes`` give
every KV head in global order (a quantized pool's scales whole), rank 0
asking the workers for their slices over their pipes (``Workers.query``),
so a TP node, a TP=1 node and a JAX node exchange pages and handoff tails
in both directions. The pipe carries one message at a time under a lock, in
the order rank 0 sent it, from any thread (``parallel.worker``). The other
design, gathering each page inside the stream at capture, would move every
demoted page's other heads through rank 0 and back, and hold the demoting
thread until the tick's turn. A multimodal prompt's embeddings cross the
pipe as host float32 arrays inside its dense prefill (``_host_embeds``:
exact for a bf16 tower; a CUDA tensor is never pickled); the towers and
heads run on rank 0 only.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import itertools
import math
import threading
import time
import weakref
from typing import Any, Sequence

import numpy as np
import torch

from agentfield_tpu_torch.branching import branch_rid
from agentfield_tpu_torch.models import llama
from agentfield_tpu_torch.models.configs import LlamaConfig
from agentfield_tpu_torch.ops.kernel_autotune import lookup_blocks
from agentfield_tpu_torch.ops.kv_quant import (
    KV_QUANT_DTYPES,
    bits,
    quant_mode_supported,
    write_pages,
)
from agentfield_tpu_torch.ops.paged_attention import ragged_paged_attention
from agentfield_tpu_torch.parallel.worker import PerRank, for_rank
from agentfield_tpu_torch.prefix_hash import page_chain_hashes
from agentfield_tpu_torch.serving.decode_step import MAX_STOP_IDS, DecodeGraphs, DecodeState
from agentfield_tpu_torch.serving.faults import fire as _engine_fault
from agentfield_tpu_torch.serving.grammar import Grammar
from agentfield_tpu_torch.serving.kv_cache import (
    PagedKVCache,
    PrefixPagePool,
    build_page_table,
    pack_ragged_rows,
)
from agentfield_tpu_torch.serving.sampler import SamplingParams, sample_tokens, sampler_variant
from agentfield_tpu_torch.serving.spec_decode import PagedModel, rows_forward, spec_step
from agentfield_tpu_torch import tracing
from agentfield_tpu_torch.tracing import HistogramSet

_MASKED = -1e30  # logit value for grammar-disallowed tokens


def _dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype under the JAX package's name ("bfloat16", "int8",
    "float8_e4m3fn", ...): the dtype strings of the KV wire format."""
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_batch: int = 32  # concurrent decode slots
    page_size: int = 16
    num_pages: int = 2048
    max_pages_per_seq: int = 32  # max context = max_pages_per_seq * page_size
    max_pending: int = 1024  # admission queue bound
    prefill_batch: int = 8  # fresh prompts admitted per tick as ONE prefill
    admit_window: int = 8  # look this many requests past a page-starved head
    head_starve_fifo_ticks: int = 256  # then collapse the window to strict FIFO
    enable_prefix_cache: bool = True  # retain session KV across turns
    shared_prefix_cache: bool = True  # cross-request content-addressed reuse
    prefill_chunk: int | None = None  # chunk long prefills (None → min(512, max_context))
    decode_buckets: tuple[int, ...] | None = None  # e.g. (4, 16): fewer active
    # slots than a bucket decode in a compact batch of that width (one CUDA
    # graph per width on the card)
    grammar_slots: int = 0  # rows of the constrained-decoding transition bank
    # (0 disables Request.grammar; each grammar takes n_states rows)
    decode_span: int = 1  # decode steps per dispatch (one host readback per span)
    async_decode: bool = True  # pipeline decode: dispatch step N before reading
    # step N-1's tokens (token events arrive one tick later); False waits
    session_ttl: float = 600.0  # idle sessions release their pages (0 disables)
    dtype: str | None = None  # KV page dtype (default: the params' dtype)
    kv_quant_dtype: str = "none"  # "int8" | "fp8": quantized KV pages with
    # per-(slot, KV head) f32 scales, ~1.9x the pages per HBM byte
    mixed_step: bool | str = False  # token-budget mixed ticks while prompts
    # wait behind active decodes; "auto" turns them on unless speculative
    # decoding owns the tick (spec_k > 0, where True is refused). Paused
    # while a grammar-constrained request is active
    mixed_step_budget: int = 512  # token rows a mixed tick carries at most
    # (decode + prefill-chunk); must be >= max_batch + 16
    preempt_fence_ticks: int = 64  # a pending request of higher priority
    # than an active slot, starved this many consecutive ticks, preempts the
    # lowest-priority slot (0 disables preemption)
    spec_k: int = 0  # speculative decoding: draft proposals per step (0
    # disables; needs InferenceEngine(draft=...)). A dispatch speculates when
    # no grammar row is active and some row can accept (greedy or plain
    # temperature); it emits 1..spec_k+1 tokens a row
    moe_prefill_impl: str = "dense"  # MoE FFN during PREFILL forwards:
    # "dense" soft-routes (exact) | "sparse" capacity-based top-k dispatch
    # (FLOPs ∝ top_k, not num_experts; over-capacity tokens lose that
    # expert's contribution, cfg.moe_capacity_factor sizes the headroom).
    # Decode always soft-routes
    host_cache_bytes: int = 0  # byte budget of the host-RAM KV tier under
    # the shared-prefix pool: refcount-0 cached pages demote to it (idle
    # session expiry, allocation pressure) and restore at the next prefix
    # hit instead of a re-prefill. 0 disables the tier (no worker thread);
    # needs shared_prefix_cache
    prefix_sketch_bytes: int = 4096  # byte cap of the prefix-index sketch
    # each heartbeat publishes (the gateway's affinity routing reads it);
    # overflow drops the deepest pages (prefix_sketch_truncated_total); 0
    # publishes none
    spec_prefill: bool = True  # agent-aware serving: keep-warm session pins
    # and speculative next-step prefill for expect_followup requests (False
    # takes every such path off; default traffic never takes one)
    spec_pin_ttl: float = 120.0  # seconds a keep-warm pin waits for its
    # follow-up before it releases its speculative pages
    spec_pin_budget: int = 32  # pinned sessions at most: past it the oldest
    # pin spills, and page pressure spills pins before an allocation fails
    spec_max_candidates: int = 4  # declared follow-up candidates prefilled
    # speculatively per step, at most
    # The JAX engine's implementation switches, under its names and values.
    # The port has one path for each: the hand-written kernel for a tensor
    # on the card, its plain version for one on the CPU, whatever the value
    # (no value selects the plain version on the card); ``resolve_impls``
    # refuses what the JAX engine refuses, with its words, and what has no
    # port yet ("ring", ROADMAP A5 c) with NotImplementedError
    attn_impl: str = "ref"  # "ref" | "pallas": the decode tick's attention
    prefill_impl: str = "ref"  # "ref" | "flash": prefill attention
    chunk_attn_impl: str = "auto"  # "auto" | "pallas" | "ref": chunk launches
    kv_write_impl: str | None = None  # removed in the JAX engine: any value raises
    compile_cache_dir: str | None = None  # where built kernels persist (the
    # JAX engine's compilation cache): the kernel build directory
    # (``ops/cuda/build.BUILD_DIR``) for libraries not built yet

    @property
    def max_context(self) -> int:
        return self.max_pages_per_seq * self.page_size

    def prefill_bucket(self, n: int) -> int:
        b = 16
        while b < n:
            b *= 2
        return min(b, self.max_context)

    def mixed_bucket(self, n: int) -> int:
        """Rows of a mixed tick carrying n real tokens: powers of two from
        16, capped at the budget."""
        b = 16
        while b < min(n, self.mixed_step_budget):
            b *= 2
        return min(b, self.mixed_step_budget)


# Live-slot handoff stashes: how long a phase-1 export waits for its tail
# fetch (and an adopted tail for its phase-2 admission), and how many
# entries either stash holds (each pins one host page copy).
_HANDOFF_TTL_S = 60.0
_HANDOFF_STASH_MAX = 64

# Admission priority of the engine's speculative prefill jobs: below every
# caller's tier, so speculation takes idle capacity only and is the first
# preemption victim.
_SPEC_PRIORITY = -(1 << 30)


def _sparse_prefill_cfg(cfg: LlamaConfig, ecfg: EngineConfig) -> LlamaConfig:
    """The cfg a prefill forward runs under: sparse-dispatch MoE when
    ``moe_prefill_impl`` asks for it (one constructor for target and draft)."""
    if ecfg.moe_prefill_impl == "sparse" and cfg.num_experts > 0:
        return dataclasses.replace(cfg, moe_impl="sparse")
    return cfg


IMPL_VALUES = {  # the values the JAX engine accepts without a mesh
    "attn_impl": ("ref", "pallas"),
    "prefill_impl": ("ref", "flash"),
    "chunk_attn_impl": ("auto", "pallas", "ref"),
}


def resolve_impls(ecfg: EngineConfig) -> EngineConfig:
    """``ecfg`` with ``chunk_attn_impl`` "auto" resolved as the JAX engine
    resolves it, after the JAX engine's checks of the implementation names;
    ``prefill_impl="ring"`` raises NotImplementedError (ROADMAP A5 c), and a
    ``prefill_impl`` the JAX engine would pass to its reference path
    unchecked raises ValueError here."""
    if ecfg.kv_write_impl is not None:
        raise ValueError(
            f"EngineConfig.kv_write_impl={ecfg.kv_write_impl!r} was "
            "removed: the ragged kernel fuses the decode KV write into "
            "the attention launch — set attn_impl='pallas' to run the "
            "kernel path (docs/KERNELS.md)"
        )
    if ecfg.prefill_impl == "ring":
        raise NotImplementedError(
            "prefill_impl='ring' (sequence-parallel prefill) is not ported: "
            "ROADMAP A5: ring attention")
    if ecfg.chunk_attn_impl == "auto":
        resolved = "pallas" if ecfg.attn_impl == "pallas" or ecfg.prefill_impl == "flash" else "ref"
        ecfg = dataclasses.replace(ecfg, chunk_attn_impl=resolved)
    if ecfg.chunk_attn_impl not in ("pallas", "ref"):
        raise ValueError(
            f"chunk_attn_impl={ecfg.chunk_attn_impl!r} must be "
            "'auto', 'pallas', or 'ref'"
        )
    if ecfg.attn_impl not in ("pallas", "ref"):
        raise ValueError(
            f"attn_impl={ecfg.attn_impl!r} must be 'pallas' or 'ref'"
        )
    if ecfg.prefill_impl not in IMPL_VALUES["prefill_impl"]:
        raise ValueError(f"prefill_impl={ecfg.prefill_impl!r} must be 'ref' or 'flash'")
    if ecfg.compile_cache_dir:
        import os
        from pathlib import Path

        from agentfield_tpu_torch.ops.cuda import build

        build.BUILD_DIR = Path(os.path.expanduser(ecfg.compile_cache_dir))
    return ecfg


@dataclasses.dataclass
class Request:
    id: str
    prompt: list[int]
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    # session affinity for prefix-cache reuse: a session's cached tokens are
    # a prefix of its next prompt
    session_id: str | None = None
    # constrained decoding: schema-invalid tokens are masked before sampling
    # (serving/grammar.py); needs sampling.stop_token_ids and grammar_slots
    grammar: Grammar | None = None
    # wall-clock budget in seconds from submit: on expiry a terminal event
    # with finish_reason "deadline_exceeded" (token -1) ends the request; a
    # request still pending is shed before it admits. None = no deadline
    deadline_s: float | None = None
    # admission tier: higher admits first (FIFO within a tier); a starved
    # higher tier may preempt a lower-priority slot
    priority: int = 0
    # tokens generated by an earlier incarnation (set when a preempted
    # request re-queues with them folded into its prompt): event indexes
    # continue from here. 0 for every caller-submitted request
    resumed_from: int = 0
    # branch decoding: > 1 forks the request into this many siblings once
    # its prompt is prefilled (ids ``branching.branch_rid(id, j)``; branch 0
    # keeps this id). Exclusive with grammar; siblings drop session_id
    n_branches: int = 1
    # request-scoped tracing: the gateway's TraceContext ({"trace_id", ...},
    # ``tracing.valid_context``); the engine records its lifecycle spans
    # against the id. None = untraced
    trace: dict | None = None
    # multimodal early fusion: (offset, [k, hidden_size] embeddings) spans
    # that replace the prompt's placeholder positions [offset, offset + k)
    # (a tower's output, numpy or a tensor). The prompt prefills whole
    # through the dense path; such a request never touches the session or
    # shared-prefix caches, never forks or branches, is never a preemption
    # victim and never a mixed-tick prefill job (its KV depends on more
    # than its token ids)
    mm_embeds: list[tuple[int, Any]] | None = None
    # two-phase dispatch, phase one: prefill, sample the first token, publish
    # the prompt's full pages, stash the tail page and end with ONE event,
    # finish_reason "handoff". An ineligible request (grammar, media,
    # branches, a prompt under 2 tokens, a first token that ends it, the
    # shared-prefix cache off) decodes here instead
    handoff_export: bool = False
    # phase two: the phase-1 descriptor ({"id", "t0", "logprob",
    # "prompt_tokens", "pages", "page_size"}). With every full prompt page
    # matched and the tail adopted, the slot installs live (no prefill,
    # first token t0); otherwise the request admits as usual
    handoff: dict | None = None
    # agent-aware serving: a follow-up on this session is coming; at finish
    # the session is pinned warm (needs a session_id and spec_prefill)
    expect_followup: bool = False
    # candidate next-step suffixes (token lists), each prefilled
    # speculatively over the session after it finishes; the follow-up
    # absorbs the winner through the prefix index
    followup_candidates: list[list[int]] | None = None
    # internal: this request is a speculative prefill job of request
    # ``spec_parent`` (never set by callers)
    spec_parent: str | None = None


@dataclasses.dataclass
class TokenEvent:
    request_id: str
    token: int
    index: int  # 0-based index among generated tokens
    finished: bool
    finish_reason: str | None = None  # "stop" | "length" | "deadline_exceeded"
    # | "fork_failed" (a deadline or fork_failed terminal carries token -1
    # and index -1) | "handoff" (phase one of a two-phase dispatch)
    logprob: float | None = None  # log P(token) under the raw-logit distribution


@dataclasses.dataclass
class _Slot:
    req: Request
    pages: list[int]
    length: int  # tokens whose K/V are (or will be) cached, incl. pending last token
    generated: int
    last_token: int
    tokens: list[int] = dataclasses.field(default_factory=list)  # prompt + generated
    last_emit_t: float = 0.0  # perf_counter of the last emitted token (ITL window)
    draft_len: int = 0  # tokens whose KV the draft pool holds (plain-decode
    # fallback steps advance the target only; _resync_draft replays the gap)


@dataclasses.dataclass
class _PrefillJob:
    """An admitting request whose prompt prefills chunk by chunk across
    mixed ticks: it owns its pages, reserves one decode slot by count
    (``_slots_available``) and installs into a slot when its last prompt
    token's logits come back."""

    req: Request
    pages: list[int]
    row: np.ndarray  # page-table row [max_pages_per_seq]
    start: int  # cached-prefix length: prefill begins here
    pos: int  # next absolute position to prefill
    lead_hash: bytes | None = None  # chain hash of the prompt's first full
    # page: pending requests sharing it defer until this job publishes


@dataclasses.dataclass
class _SessionEntry:
    pages: list[int]
    tokens: list[int]  # tokens whose KV is resident (prompt + generated[:-1])
    last_used: float


class QueueFullError(Exception):
    """Admission queue at capacity — surfaced as backpressure."""


class RequestTooLongError(Exception):
    pass


class GrammarCapacityError(Exception):
    """The engine's grammar bank has no room for another schema's states."""


def _binding_window(cfg: LlamaConfig, ecfg: EngineConfig) -> int | None:
    """The sliding window, or None when it cannot bind within the context."""
    w = cfg.sliding_window
    if w is None or w >= ecfg.max_context:
        return None
    return w


def _page_shape(t: torch.Tensor, tp: int = 1) -> tuple[int, ...]:
    """One page's shape of pool leaf ``t`` ([L, P, Kh, ps(, hd)]):
    ``(L, Kh * tp, ps(, hd))``, every rank's heads with ``tp``."""
    return (t.shape[0], t.shape[2] * tp) + tuple(t.shape[3:])


class _HostPage:
    """One demoted page's host copy: a slot of a ``_HostPageStore`` seen as
    one tensor per pool leaf (values, and scales when quantized; fp8 as raw
    bytes). ``done[0]`` is the event of the last device copy that read the
    slot: the slot is reused only after it passed. On rank 0 of a
    tensor-parallel engine a page captured here holds rank 0's heads only,
    and ``tp`` is the claim on the other ranks' slices of it (``_TPRef``);
    a page that came from the wire holds every head, and ``tp`` is None."""

    __slots__ = ("leaves", "done", "tp", "__weakref__")

    def __init__(self, leaves: list[torch.Tensor]):
        self.leaves = leaves
        self.done: list[Any] = [None]
        self.tp: _TPRef | None = None


class _TPRef:
    """Rank 0's claim on the workers' host slices of one captured page,
    kept by their capture id: the capture's handle and the host page made
    from it hold it, and when the last of them goes the id is queued in
    ``released``, which the next operation sent tells the workers
    (``InferenceEngine._tp_release``; a finalizer only appends, so it may
    run on any thread, inside any lock)."""

    __slots__ = ("id", "__weakref__")

    def __init__(self, tid: int, released: collections.deque):
        self.id = tid
        weakref.finalize(self, released.append, tid).atexit = False


class _HostPageStore:
    """Host memory of the KV tier: page-sized slots carved from slabs of
    ``SLAB_PAGES`` pages, pinned when the pool is on the card (a pageable
    source makes a device copy synchronous, and one pinned allocation a page
    would cost more than the copy). A slot returns to the free list when
    the pool drops its ``_HostPage``. Thread-safe: the offload worker takes
    slots, any thread may drop them."""

    SLAB_PAGES = 64
    _ALIGN = 256

    def __init__(self, leaves: list[torch.Tensor], pin: bool, tp: int = 1):
        # per pool leaf ([L, P, Kh, ps(, hd)]): (dtype, one page's shape,
        # byte offset in the slot, bytes); ``tp`` ranks' heads a page (the
        # wire's whole pages on rank 0 of a mesh)
        self._layout = []
        off = 0
        for t in leaves:
            dtype, shape = t.dtype, _page_shape(t, tp)
            nbytes = dtype.itemsize * math.prod(shape)
            self._layout.append((dtype, shape, off, nbytes))
            off += -(-nbytes // self._ALIGN) * self._ALIGN
        self.slot_bytes = off
        self._pin = pin
        self._lock = threading.Lock()
        self._slabs: list[torch.Tensor] = []
        self._free: list[tuple[int, int, Any]] = []  # (slab, slot, read event)
        self.alloc_s = 0.0  # host seconds spent allocating slabs

    @property
    def host_bytes(self) -> int:
        """Bytes of every slab allocated so far (pinned on the card)."""
        return len(self._slabs) * self.SLAB_PAGES * self.slot_bytes

    def take(self) -> _HostPage:
        with self._lock:
            if not self._free:
                t0 = time.perf_counter()
                self._slabs.append(torch.empty(self.SLAB_PAGES * self.slot_bytes,
                                               dtype=torch.uint8, pin_memory=self._pin))
                self.alloc_s += time.perf_counter() - t0
                n = len(self._slabs) - 1
                self._free = [(n, j, None) for j in reversed(range(self.SLAB_PAGES))]
            slab, slot, ev = self._free.pop()
            base = self._slabs[slab][slot * self.slot_bytes : (slot + 1) * self.slot_bytes]
        if ev is not None:
            ev.synchronize()  # the last restore that read this slot is done
        page = _HostPage([base[off : off + n].view(dtype).view(shape)
                          for dtype, shape, off, n in self._layout])
        weakref.finalize(page, self._give_back, slab, slot, page.done)
        return page

    def _give_back(self, slab: int, slot: int, done: list) -> None:
        with self._lock:
            self._free.append((slab, slot, done[0]))


def _tp_op(method):
    """A device operation of the tensor-parallel boundary: on rank 0 of a
    serving mesh the call (its host arguments; a ``PerRank`` argument as
    each rank's value) is first sent to every worker, which runs the same
    method on its own engine (module docstring). Such a method must not
    call another one."""
    name = method.__name__

    @functools.wraps(method)
    def run(self, *args, **kwargs):
        if self.mesh is not None and self.mesh.workers is not None:
            ids = []
            while self._tp_released:  # another sender may empty it meanwhile
                try:
                    ids.append(self._tp_released.popleft())
                except IndexError:
                    break
            if ids:
                self.mesh.workers.send(("_tp_release", (ids,), {}))
            self.mesh.workers.send((name, args, kwargs))
            args, kwargs = for_rank(args, kwargs, 0)
        return method(self, *args, **kwargs)

    return run


def _host_embeds(spans) -> list[tuple[int, np.ndarray]]:
    """``Request.mm_embeds`` as host float32 arrays (exact for a bf16, f16
    or f32 tower's output): what crosses a tensor-parallel engine's pipe,
    where a CUDA tensor must never be pickled."""
    out = []
    for off, emb in spans:
        if isinstance(emb, torch.Tensor):
            emb = emb.detach().to("cpu", torch.float32).numpy()
        out.append((int(off), np.asarray(emb, np.float32)))
    return out


def _tree_bytes(tree) -> int:
    """Device bytes of a param tree's leaves (a QuantW's q and scale)."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    leaves = (tree.q, tree.scale) if hasattr(tree, "scale") else (tree,)
    return sum(t.numel() * t.element_size() for t in leaves)


class InferenceEngine:
    def __init__(
        self,
        params: dict[str, Any],
        cfg: LlamaConfig,
        ecfg: EngineConfig | None = None,
        seed: int = 0,
        device: str | torch.device | None = None,
        draft: tuple[dict[str, Any], LlamaConfig] | None = None,
        restore_budget_bytes: int | None = None,
        mesh=None,
    ):
        """``params`` in the port's layout (``models.llama.init_params`` or
        ``models.convert.params_from_numpy``), already on ``device`` (default:
        where the params are). ``draft`` is the ``(params, cfg)`` of the
        speculative-decoding draft model (needed when ``ecfg.spec_k > 0``),
        on the same device. ``restore_budget_bytes`` caps the host store
        that pages fetched from a peer node wait in (pinned on the card,
        allocated as it fills) when ``host_cache_bytes`` is 0; None sizes
        it as the JAX engine does: two admission windows of whole prompts,
        ``max(32, 2 * max_batch * max_pages_per_seq)`` pages.

        ``mesh`` (a ``parallel.mesh.Mesh`` with a process group, tp > 1):
        this engine is one rank of a tensor-parallel engine (module
        docstring). The config checks come first; ``params`` (and a
        draft's) are this rank's slice (``parallel.sharding.shard_params``,
        ``init_params(shard=)``, a loader's ``shard=``), and a tree of
        other shapes raises ``ValueError``. Rank 0's mesh
        holds the workers (``parallel.worker.start_workers``), and
        ``close`` stops them."""
        self.cfg = cfg
        self.ecfg = resolve_impls(ecfg or EngineConfig())
        self.mesh = mesh if mesh is not None and mesh.tp > 1 else None
        if self.mesh is not None:
            self._check_tp(params, draft)
        self.device = torch.device(device) if device is not None else params["embed"].device
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, engine on {self.device}")
        if cfg.moe_impl != "dense":
            raise ValueError(
                f"engine model cfg has moe_impl={cfg.moe_impl!r}: the DECODE "
                "path always soft-routes (weight-bound, exact) and takes no "
                "padding mask — use EngineConfig.moe_prefill_impl='sparse' "
                "to run sparse dispatch on prefill forwards"
            )
        if self.ecfg.moe_prefill_impl not in ("dense", "sparse"):
            raise ValueError(
                f"moe_prefill_impl={self.ecfg.moe_prefill_impl!r} must be "
                "'dense' or 'sparse'"
            )
        # prefill forwards may run sparse dispatch; decode always soft-routes
        self.prefill_cfg = _sparse_prefill_cfg(cfg, self.ecfg)
        if self.ecfg.prefill_chunk is None:
            # every prefill rides the kernel path: cap chunks at 512 rows
            self.ecfg = dataclasses.replace(
                self.ecfg, prefill_chunk=min(512, self.ecfg.max_context)
            )
        if self.ecfg.prefill_chunk < 16:
            raise ValueError(f"prefill_chunk={self.ecfg.prefill_chunk} must be >= 16 (one tile) or None")
        if self.ecfg.decode_span < 1:
            raise ValueError(f"decode_span={self.ecfg.decode_span} must be >= 1")
        if self.ecfg.kv_quant_dtype not in KV_QUANT_DTYPES:
            raise ValueError(
                f"kv_quant_dtype={self.ecfg.kv_quant_dtype!r} must be one of {KV_QUANT_DTYPES}"
            )
        if not quant_mode_supported(self.ecfg.kv_quant_dtype):
            raise ValueError(
                f"kv_quant_dtype={self.ecfg.kv_quant_dtype!r} is not supported by this "
                "torch build (no float8_e4m3fn) — use 'int8' or 'none'"
            )
        if self.ecfg.mixed_step not in (True, False, "auto"):
            raise ValueError(
                f"mixed_step={self.ecfg.mixed_step!r} must be True, False, or 'auto'"
            )
        if self.ecfg.mixed_step == "auto":
            # speculative decoding owns its ticks (draft + verify is already
            # a multi-token dispatch); auto turns mixing on everywhere else
            self.ecfg = dataclasses.replace(self.ecfg, mixed_step=self.ecfg.spec_k == 0)
        if self.ecfg.mixed_step and self.ecfg.spec_k > 0:
            raise ValueError(
                "mixed_step=True is incompatible with spec_k > 0 "
                "(speculative decoding owns the tick); use mixed_step='auto' "
                "to fall back automatically"
            )
        if self.ecfg.mixed_step and self.ecfg.mixed_step_budget < self.ecfg.max_batch + 16:
            raise ValueError(
                f"mixed_step_budget={self.ecfg.mixed_step_budget} must be >= "
                f"max_batch+16={self.ecfg.max_batch + 16}: a full decode batch "
                "must still leave prefill-chunk room in the tick"
            )
        if self.ecfg.max_pages_per_seq > self.ecfg.num_pages - 1:
            raise ValueError(
                f"max_pages_per_seq={self.ecfg.max_pages_per_seq} cannot exceed "
                f"num_pages-1={self.ecfg.num_pages - 1} (page 0 is reserved)"
            )
        self.params = params
        cache_dtype = self.ecfg.dtype or params["embed"].dtype
        quant = self.ecfg.kv_quant_dtype
        self.cache = PagedKVCache.create(
            cfg, self.ecfg.num_pages, self.ecfg.page_size, cache_dtype, device=self.device,
            kv_quant=quant, mesh=self.mesh,
        )
        if quant == "none" and self.cache.k_pages.dtype != params["embed"].dtype:
            raise ValueError("KV page dtype must match the params' compute dtype")
        self._target = PagedModel(params, cfg, self.cache, _binding_window(cfg, self.ecfg),
                                  self.mesh)
        # speculative decoding: the draft's own pool on the target's page ids
        self.draft_params = self.draft_cfg = self.draft_cache = self._draft = None
        if self.ecfg.spec_k < 0:
            raise ValueError(f"spec_k={self.ecfg.spec_k} must be >= 0")
        if self.ecfg.spec_k > 0:
            if draft is None:
                raise ValueError(
                    f"spec_k={self.ecfg.spec_k} needs a draft model: "
                    "InferenceEngine(draft=(params, cfg))"
                )
            self.draft_params, self.draft_cfg = draft
            if self.draft_cfg.moe_impl != "dense":
                raise ValueError(
                    f"draft cfg has moe_impl={self.draft_cfg.moe_impl!r}: "
                    "draft decode soft-routes like the target's — use "
                    "EngineConfig.moe_prefill_impl='sparse' instead"
                )
            if self.draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {self.draft_cfg.vocab_size} != target "
                    f"vocab {cfg.vocab_size} (speculation compares token ids)"
                )
            if self.draft_params["embed"].device != self.device:
                raise ValueError(
                    f"draft params live on {self.draft_params['embed'].device}, "
                    f"engine on {self.device}")
            self.draft_cache = PagedKVCache.create(
                self.draft_cfg, self.ecfg.num_pages, self.ecfg.page_size, cache_dtype,
                device=self.device, kv_quant=quant, mesh=self.mesh,
            )
            if quant == "none" and self.draft_cache.k_pages.dtype != self.draft_params["embed"].dtype:
                raise ValueError("KV page dtype must match the draft params' compute dtype")
            self._draft = PagedModel(self.draft_params, self.draft_cfg, self.draft_cache,
                                     _binding_window(self.draft_cfg, self.ecfg), self.mesh)
        self.draft_prefill_cfg = (_sparse_prefill_cfg(self.draft_cfg, self.ecfg)
                                  if self.draft_cfg is not None else None)
        # the dense page layout at the same geometry: the yardstick of the
        # kv_quant_bytes_saved_total counter
        self.kv_page_bytes_dense = (
            2 * cfg.num_layers * cfg.num_kv_heads * self.ecfg.page_size * cfg.head_dim
            * llama.resolve_dtype(cache_dtype).itemsize
        )
        self.kv_page_bytes = self.cache.page_bytes()
        self.window = self._target.window
        self.stats = {
            "prefill_tokens": 0,
            "decode_tokens": 0,
            "decode_steps": 0,
            "requests_finished": 0,
            "backpressure_total": 0,
            "prefix_cache_hits": 0,
            "prefix_tokens_reused": 0,
            "sessions_evicted": 0,
            "prefill_batches": 0,
            "admission_reorders": 0,
            "prefix_index_hits": 0,
            "prefix_index_misses": 0,
            "prefix_cow_copies": 0,
            "prefix_pages_unpublished": 0,
            "prefix_batch_deferrals": 0,
            "grammar_evictions": 0,
            "grammar_capacity_errors": 0,
            "requests_cancelled": 0,
            "mixed_ticks": 0,  # ticks that ran the packed ragged forward
            "mixed_tokens": 0,  # real tokens (decode + prefill-chunk) they carried
            "deadline_exceeded": 0,  # requests ended by Request.deadline_s
            "cancels_unknown": 0,  # request_cancel of an id the engine does not hold
            "drains_total": 0,  # graceful drains started (the node's drain())
            "drain_cancelled": 0,  # requests deadline-outed by a drain
            "preemptions_total": 0,  # slots preempted for a starved higher tier
            "resume_prefix_hits_total": 0,  # preempted requests that resumed
            # over cached pages instead of a full re-prefill
            "shed_pending_deadline_total": 0,  # pending requests shed at their
            # deadline before they ever admitted (a subset of deadline_exceeded)
            "spec_steps": 0,  # speculative dispatches
            "spec_emitted": 0,  # tokens they emitted (rate = emitted /
            # (steps * (spec_k+1)))
            "page_pressure_injected": 0,  # allocations denied by the
            # engine.page_pressure fault point
            "preempt_storm_injected": 0,  # preemptions forced by the
            # engine.preempt_storm fault point
            "branch_forks_total": 0,  # sibling slots forked (install-time
            # forks and live re-forks), each on its parent's shared pages
            "branch_forks_degraded_total": 0,  # install-time forks that
            # found no slot or pages and re-queued (they re-admit through
            # the prefix index)
            "branch_fork_failed_total": 0,  # live forks refused (source
            # gone or no capacity): a fork_failed terminal each
            "branch_pruned_total": 0,  # branches a pruning policy cancelled
            "branch_verifier_calls_total": 0,  # group resolutions scored by a
            # control-plane verifier reasoner instead of the logprob sum
            # two-phase dispatch, always present
            "kv_handoff_initiated_total": 0,  # phase-1 prefills that ended
            # in a handoff terminal (tail and first token stashed)
            "kv_handoff_completed_total": 0,  # phase-2 admissions installed
            # live from an adopted tail (no prefill)
            "kv_handoff_failed_total": 0,  # handoffs that fell back to the
            # ordinary path (still token-exact under greedy), by cause:
            "kv_handoff_bytes_total": 0,  # tail bytes this node served
            "kv_handoff_fail_walk_total": 0,  # the prefix walk fell short
            "kv_handoff_fail_stash_total": 0,  # no adopted tail (or aged out)
            "kv_handoff_fail_upload_total": 0,  # the tail's upload raised
            "kv_handoff_fail_export_total": 0,  # phase one declined to export
            # agent-aware serving (speculative next-step prefill, not
            # speculative decoding), always present
            "spec_started_total": 0,  # speculative prefill jobs enqueued
            "spec_hit_total": 0,  # follow-ups that absorbed a speculated prefix
            "spec_wasted_tokens_total": 0,  # candidate tokens prefilled for losers
            "spec_cancelled_total": 0,  # jobs cancelled or stashes dropped
            "spec_fail_injected": 0,  # spec.fail vetoes (keep-warm only)
            "spec_stall_injected": 0,  # jobs deferred by spec.stall
            "session_pins_active": 0,  # gauge: sessions pinned warm
        }
        # Host wall time of prefills (each ends in a device→host read), of
        # decode dispatches and harvests (a harvest waits for its step) and
        # of the offload worker's page copies.
        self.timing = {"prefill_s": 0.0, "decode_s": 0.0, "offload_s": 0.0}
        self.ttft_ms: collections.deque[float] = collections.deque(maxlen=4096)
        # the JAX engine's always-on latency histograms, shipped on every
        # heartbeat under ``latency_hist`` (``latency_histograms``)
        self.latency = HistogramSet(("ttft_ms", "itl_ms", "queue_wait_ms", "tick_ms"))
        # one row a tick with work (``step``), and the lifecycle spans of
        # traced requests: request id -> its open span anchors (_tr_*)
        self.flight = tracing.FlightRecorder()
        self._tracer = tracing.tracer()
        self._traces: dict[str, dict] = {}
        self._tick_mode = "decode"  # scheduler-thread state of the tick in progress
        self._tick_carried = 0
        self._shared_prefix = bool(
            self.ecfg.enable_prefix_cache and self.ecfg.shared_prefix_cache
        )
        self.allocator = PrefixPagePool(  # guarded by: _session_lock
            self.ecfg.num_pages, self.ecfg.page_size, stats=self.stats
        )
        if quant != "none":
            self.allocator.configure_quant(max(0, self.kv_page_bytes_dense - self.kv_page_bytes))
        self._req_hashes: dict[str, list[bytes]] = {}
        # live-slot handoff stashes, TTL-bounded and capped: phase-1 exports
        # awaiting their tail fetch (request id -> (expiry, descriptor, host
        # tail)) and adopted tails awaiting their phase-2 admission (handoff
        # id -> (expiry, host tail)); an entry that ages out only means a
        # re-prefill on the other side
        self._handoff_out: dict[str, tuple[float, dict, Any]] = {}  # guarded by: _session_lock
        self._handoff_in: dict[str, tuple[float, Any]] = {}  # guarded by: _session_lock
        B, maxp = self.ecfg.max_batch, self.ecfg.max_pages_per_seq
        self.page_tables = np.zeros((B, maxp), np.int32)
        self.seq_lens = np.zeros((B,), np.int32)
        self.last_tokens = np.zeros((B,), np.int32)
        self.temps = np.zeros((B,), np.float32)
        self.top_ks = np.zeros((B,), np.int32)
        self.top_ps = np.ones((B,), np.float32)
        # constrained decoding: per-slot bank-global DFA state (0 = free) and
        # stop ids (-1 padded); the int16 transition bank is host-built (rows
        # shifted to bank-global ids) and mirrored on the device row range by
        # row range
        self.grammar_states = np.zeros((B,), np.int32)
        self.eos_ids = np.full((B, MAX_STOP_IDS), -1, np.int32)
        S = max(1, self.ecfg.grammar_slots)
        if S > np.iinfo(np.int16).max:
            raise ValueError(f"grammar_slots={S} exceeds int16 bank capacity")
        self._gbank_trans = np.zeros((S, cfg.vocab_size), np.int16)  # row 0: free
        self._gbank_accept = np.zeros((S,), bool)
        self._gbank_accept[0] = True
        # entries hold a strong reference to each Grammar (its id() stays
        # valid); refcounts gate eviction
        self._gbank_entries: dict[int, dict[str, Any]] = {}  # guarded by: _session_lock
        self._gbank_free: list[tuple[int, int]] = [(1, S - 1)] if S > 1 else []
        self._gbank_dirty_rows: list[tuple[int, int]] = []  # (offset, n) to upload
        self._gbank_clock = 0.0  # LRU tiebreaker for eviction
        self._gbank_dev = None
        if self.ecfg.grammar_slots > 0:
            self._gbank_dev = {
                "trans": torch.zeros((S, cfg.vocab_size), dtype=torch.int16, device=self.device),
                "accept": torch.from_numpy(self._gbank_accept.copy()).to(self.device),
            }
        self.slots: list[_Slot | None] = [None] * B
        self.pending: collections.deque[Request] = collections.deque()
        self._sessions: dict[str, _SessionEntry] = {}  # guarded by: _session_lock
        # step() runs on a worker thread while submit()/free_session() run on
        # request threads: session + allocator mutations are serialized here
        self._session_lock = threading.RLock()
        self._pending_lock = threading.Lock()
        # the host KV tier: the pool owns its state and offload worker; the
        # engine gives it the device-copy callbacks and its session lock
        self._host_store: _HostPageStore | None = None
        # pages that came from the wire (a peer's or a handoff's): every
        # head; the host store itself unless this engine is a rank of a mesh
        self._wire_store: _HostPageStore | None = None
        self._copy_stream = None  # device-to-host copies (offload worker, exports)
        self._restore_timed: collections.deque = collections.deque(maxlen=4096)
        # tensor parallelism: rank 0 numbers its page captures and queues
        # the ids whose pages it dropped (``_TPRef``); a worker keeps its
        # host slice of each capture by id until rank 0 releases it
        self._tp_ids = itertools.count(1)
        self._tp_released: collections.deque[int] = collections.deque()
        self._tp_slices: dict[int, _HostPage] = {}
        if self.ecfg.host_cache_bytes > 0 and not self._shared_prefix:
            raise ValueError(
                f"host_cache_bytes={self.ecfg.host_cache_bytes} requires "
                "enable_prefix_cache and shared_prefix_cache: the host "
                "tier is content-addressed"
            )
        if self._shared_prefix:
            on_card = self.device.type == "cuda"
            leaves = [bits(t) for t in self.cache.leaves()]
            self._host_store = self._wire_store = _HostPageStore(leaves, pin=on_card)
            if self.mesh is not None and self.mesh.is_root:
                self._wire_store = _HostPageStore(leaves, pin=on_card, tp=self.mesh.tp)
            if on_card:
                self._copy_stream = torch.cuda.Stream(device=self.device)
        if self._tp_worker:
            pass  # rank 0's pool decides every demotion and restore
        elif self.ecfg.host_cache_bytes > 0:
            self.allocator.enable_host_tier(
                budget_bytes=self.ecfg.host_cache_bytes,
                page_bytes=self.kv_page_bytes,  # scales included
                lock=self._session_lock,
                capture=self._capture_page_kv,
                fetch=self._fetch_page_kv,
                upload=self._upload_page_kv,
                # a restore serves a live request: it may evict idle sessions
                restore_alloc=lambda: self._alloc_with_eviction(1),
            )
        elif self._shared_prefix:
            # no demotion, but the cluster tier's pages still land in the
            # host store and restore at admission: a staging budget of two
            # admission windows of whole prompts (a phase-2 burst adopts
            # every prompt before any admits)
            staging = max(32, 2 * self.ecfg.max_batch * self.ecfg.max_pages_per_seq)
            self.allocator.enable_restore(
                budget_bytes=(restore_budget_bytes if restore_budget_bytes is not None
                              else staging * self.kv_page_bytes),
                page_bytes=self.kv_page_bytes,
                upload=self._upload_page_kv,
                restore_alloc=lambda: self._alloc_with_eviction(1),
            )
        # live-fork commands (src_id, new_id) from request_fork, applied in
        # step() on the scheduler thread
        self._fork_cmds: list[tuple[str, str]] = []  # guarded by: _pending_lock
        self._submit_t: dict[str, float] = {}
        self._head_starved_ticks = 0
        # cancellation requests, drained inside step() on the scheduler thread
        self._cancels: set[str] = set()
        # request id -> monotonic expiry (written at submit, scanned each step)
        self._deadline_at: dict[str, float] = {}  # guarded by: _pending_lock
        self._drain_sweep = False  # deadline_all_now, applied at the next step
        # preemption fence: consecutive starved ticks of the current queue
        # head, and the head the previous probe saw (scheduler-thread state)
        self._preempt_starved_ticks = 0
        self._preempt_last_head: str | None = None
        # mixed ticks: admitting requests mid-chunked-prefill
        self._prefill_jobs: list[_PrefillJob] = []
        # scheduler telemetry: inter-token gaps (s) and tokens per dispatch
        self._telemetry_lock = threading.Lock()
        self._itl_window: collections.deque[float] = collections.deque(maxlen=4096)  # guarded by: _telemetry_lock
        self._tick_tokens: collections.deque[int] = collections.deque(maxlen=1024)  # guarded by: _telemetry_lock
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        # the decode pipeline: the dispatched-but-unread step, the device
        # control state per batch width, and its validity (the full-width
        # state is stale while ``_dirty``; the compact state holds
        # ``_compact_key``'s rows)
        self._inflight: dict[str, Any] | None = None
        self._states: dict[int, DecodeState] = {}
        self._dirty = True
        self._compact_key: tuple | None = None
        self._graphs = DecodeGraphs(
            self._graph_step, self._gen,
            eager=("gloo collectives cannot be captured in a CUDA graph: the tensor-parallel "
                   "decode runs eager" if self.mesh is not None and self.mesh.backend == "gloo"
                   else None))
        # device ms of each replayed decode step, of each replayed spec step
        # and of each mixed tick's forward and sampling (CUDA events)
        self.decode_step_ms: collections.deque[float] = collections.deque(maxlen=4096)
        self.spec_step_ms: collections.deque[float] = collections.deque(maxlen=4096)
        self.mixed_tick_ms: collections.deque[float] = collections.deque(maxlen=4096)
        # CUDA events around each decode step of a tensor-parallel rank
        self._rank_step_events: collections.deque = collections.deque(maxlen=4096)
        # agent-aware serving: session id -> pinned-at wall time (exempt from
        # gc and the eviction ladder's first rung); session id -> its
        # speculation state (parent id, candidates by job id, finished jobs'
        # page stashes, trace anchors); spec.stall-deferred jobs as
        # (ready-at monotonic, request), scheduler-thread state
        self._pins: dict[str, float] = {}  # guarded by: _session_lock
        self._spec_by_session: dict[str, dict] = {}  # guarded by: _session_lock
        self._spec_stalled: list[tuple[float, Request]] = []

    def _check_tp(self, params, draft) -> None:
        """The tensor-parallel config checks (the JAX engine's order):
        divisibility of the sharded dims and heads, then what this slice
        does not port, then the shapes of this rank's slices."""
        from agentfield_tpu_torch.parallel.sharding import (
            check_divisibility, check_rank_slice, refuse_experts)

        tp = self.mesh.tp
        check_divisibility(self.cfg, tp, paged_kv=True)
        refuse_experts(self.cfg, tp)
        if draft is not None:
            check_divisibility(draft[1], tp, paged_kv=True)
        check_rank_slice(params, self.cfg, tp)
        if draft is not None:
            check_rank_slice(draft[0], draft[1], tp)

    @property
    def _tp_worker(self) -> bool:
        return self.mesh is not None and not self.mesh.is_root

    # ------------------------------------------------------------------
    # host-side scheduling
    # ------------------------------------------------------------------

    def submit(self, req: Request) -> None:
        """Enqueue a request. Raises QueueFullError at capacity and
        RequestTooLongError if it can never fit the page budget."""
        if not req.prompt:
            raise ValueError(f"request {req.id}: prompt must be non-empty")
        if req.mm_embeds:
            D = self.cfg.hidden_size
            for off, emb in req.mm_embeds:
                shape = tuple(emb.shape)
                if len(shape) != 2 or shape[1] != D:
                    raise ValueError(
                        f"request {req.id}: mm_embeds must be [k, {D}] arrays, "
                        f"got shape {shape}"
                    )
                if off < 0 or off + shape[0] > len(req.prompt):
                    raise ValueError(
                        f"request {req.id}: mm span [{off}, {off + shape[0]}) "
                        f"outside the {len(req.prompt)}-token prompt"
                    )
        if req.grammar is not None:
            if self.ecfg.grammar_slots <= 0:
                raise ValueError(
                    f"request {req.id}: carries a grammar but the engine was "
                    "built with grammar_slots=0 (constrained decoding disabled)"
                )
            if not req.sampling.stop_token_ids:
                raise ValueError(
                    f"request {req.id}: grammar-constrained requests need "
                    "stop_token_ids — EOS is the only legal terminator once "
                    "the value is complete"
                )
            if len(req.sampling.stop_token_ids) > MAX_STOP_IDS:
                raise ValueError(
                    f"request {req.id}: at most {MAX_STOP_IDS} stop_token_ids "
                    f"are supported with a grammar (got "
                    f"{len(req.sampling.stop_token_ids)})"
                )
        if req.deadline_s is not None and (
            not math.isfinite(req.deadline_s) or req.deadline_s <= 0
        ):
            # before _grammar_acquire: a rejected request pins no bank rows
            raise ValueError(
                f"request {req.id}: deadline_s={req.deadline_s} must be a "
                "positive finite number"
            )
        if type(req.n_branches) is not int or req.n_branches < 1:
            raise ValueError(
                f"request {req.id}: n_branches must be an int >= 1 "
                f"(got {req.n_branches!r})"
            )
        if req.n_branches > 1 and (req.grammar is not None or req.mm_embeds):
            # a mid-schema automaton state cannot be forked by re-sampling
            # the first token, and a multimodal prompt is kept out of every
            # KV-reuse path a fork rides
            raise ValueError(
                f"request {req.id}: n_branches > 1 is incompatible with "
                "grammar-constrained or multimodal requests"
            )
        if req.handoff is not None and not isinstance(req.handoff, dict):
            # anything else wrong with a descriptor degrades at admission to
            # an ordinary prefill: only its type is checked here
            raise ValueError(
                f"request {req.id}: handoff must be a descriptor dict "
                f"(got {type(req.handoff).__name__})"
            )
        if type(req.priority) is not int:  # a bool is a flag, not a tier
            raise ValueError(
                f"request {req.id}: priority must be an int "
                f"(got {type(req.priority).__name__})"
            )
        needed = self._pages_needed(req)
        if needed > self.ecfg.max_pages_per_seq:
            raise RequestTooLongError(
                f"request {req.id}: {len(req.prompt)} prompt + "
                f"{req.sampling.max_new_tokens} new tokens needs {needed} pages "
                f"> max_pages_per_seq={self.ecfg.max_pages_per_seq}"
            )
        if req.grammar is not None:
            # acquire last, so a rejected request never pins bank rows; may
            # raise GrammarCapacityError (after evicting idle grammars)
            with self._session_lock:
                self._grammar_acquire(req.grammar)
        try:
            with self._pending_lock:
                if len(self.pending) >= self.ecfg.max_pending:
                    self.stats["backpressure_total"] += 1
                    raise QueueFullError(f"pending queue at capacity {self.ecfg.max_pending}")
                # stamped before the enqueue: the drive thread may admit the
                # request the moment it lands in the queue
                self._submit_t[req.id] = time.monotonic()
                self._tr_submit(req)
                self._enqueue_locked(req)
                if req.deadline_s is not None:
                    self._deadline_at[req.id] = time.monotonic() + req.deadline_s
        except QueueFullError:
            with self._session_lock:
                self._grammar_release(req.grammar)
            raise

    def _enqueue_locked(self, req: Request, senior: bool = False) -> None:  # guarded by: _pending_lock
        """Insert into the priority-tier-ordered pending queue: non-increasing
        in priority, FIFO within a tier (flat-priority traffic is a plain
        append). ``senior`` puts the request at the front of its tier
        instead: a preempted victim keeps its seniority."""
        p = req.priority
        if not senior and (not self.pending or self.pending[-1].priority >= p):
            self.pending.append(req)
            return
        for i, r in enumerate(self.pending):
            if (r.priority < p) if not senior else (r.priority <= p):
                self.pending.insert(i, req)
                return
        self.pending.append(req)

    def _pages_needed(self, req: Request) -> int:
        total = len(req.prompt) + req.sampling.max_new_tokens
        return -(-total // self.ecfg.page_size)

    # ------------------------------------------------------------------
    # request-scoped tracing: the JAX engine's lifecycle marks, each a dict
    # miss and a return for an untraced request
    # ------------------------------------------------------------------

    def _tr_submit(self, req: Request) -> None:
        ctx = tracing.valid_context(req.trace)
        if ctx is None:
            return
        self._traces[req.id] = {"tid": ctx["trace_id"], "enq_w": time.time(),
                                "enq_m": time.perf_counter()}

    def _tr_dequeue(self, req: Request, start: int = 0) -> None:
        """The request leaves the queue: close its queue-wait span (or, a
        preempted request re-admitting, its park span) and anchor the
        prefill span; ``start`` is the cached prefix the prefill skips."""
        e = self._traces.get(req.id)
        if e is None:
            return
        now_m = time.perf_counter()
        parked = e.pop("parked", None)
        if parked is not None:
            self._tracer.record_span("engine.park", e["tid"], parked[0],
                                     (now_m - parked[1]) * 1e3,
                                     {"resumed_tokens": req.resumed_from})
        else:
            self._tracer.record_span("engine.queue_wait", e["tid"], e["enq_w"],
                                     (now_m - e["enq_m"]) * 1e3)
        e["pf_w"], e["pf_m"] = time.time(), now_m
        e["start"] = start

    def _tr_first_token(self, req: Request) -> None:
        """The first sampled token reached the host: close the prefill span,
        anchor the decode span."""
        e = self._traces.get(req.id)
        if e is None:
            return
        now_m = time.perf_counter()
        pf_m, pf_w = e.pop("pf_m", None), e.pop("pf_w", None)
        if pf_m is not None:
            self._tracer.record_span("engine.prefill", e["tid"], pf_w, (now_m - pf_m) * 1e3,
                                     {"tokens": len(req.prompt), "cached": e.pop("start", 0)})
        e["dec_w"], e["dec_m"] = time.time(), now_m

    def _tr_close(self, rid: str, reason: str, generated: int | None = None) -> None:
        """A terminal (finish, cancel, deadline): close the decode span and
        drop the entry; a request that never decoded (shed from the queue)
        closes its queue-wait span instead."""
        e = self._traces.pop(rid, None)
        if e is None:
            return
        now_m = time.perf_counter()
        if e.get("dec_m") is not None:
            attrs: dict[str, Any] = {"finish": reason}
            if generated is not None:
                attrs["tokens"] = generated
            self._tracer.record_span("engine.decode", e["tid"], e["dec_w"],
                                     (now_m - e["dec_m"]) * 1e3, attrs)
        elif e.get("pf_m") is None:
            parked = e.get("parked")
            t0w, t0m = (parked[0], parked[1]) if parked else (e["enq_w"], e["enq_m"])
            self._tracer.record_span("engine.queue_wait", e["tid"], t0w, (now_m - t0m) * 1e3,
                                     {"finish": reason})

    def _tr_preempt(self, slot: _Slot) -> None:
        """A preemption: close the decode segment (``preempted``) and start
        the park clock, which the resume's dequeue closes."""
        e = self._traces.get(slot.req.id)
        if e is None:
            return
        now_m = time.perf_counter()
        if e.get("dec_m") is not None:
            self._tracer.record_span("engine.decode", e["tid"], e["dec_w"],
                                     (now_m - e["dec_m"]) * 1e3,
                                     {"finish": "preempted", "tokens": slot.generated})
        for k in ("dec_m", "dec_w", "pf_m", "pf_w"):
            e.pop(k, None)
        e["parked"] = (time.time(), now_m)

    def _tr_fork(self, parent_id: str, child_id: str, degraded: bool = False) -> None:
        """A branch fork: the child inherits the parent's trace, so a whole
        group (winner and pruned branches) lands in one waterfall. A
        degraded fork (re-queued) starts in the queue, a live one decodes
        now."""
        e = self._traces.get(parent_id)
        if e is None:
            return
        now_w, now_m = time.time(), time.perf_counter()
        attrs: dict[str, Any] = {"branch": child_id}
        if degraded:
            attrs["degraded"] = 1
        self._tracer.record_span("engine.fork", e["tid"], now_w, 0.0, attrs)
        child = {"tid": e["tid"], "enq_w": now_w, "enq_m": now_m}
        if not degraded:
            child["dec_w"], child["dec_m"] = now_w, now_m
        self._traces[child_id] = child

    def gc_sessions(self, at: float | None = None) -> int:
        """Release pages of sessions idle longer than session_ttl. A pinned
        session is exempt while its pin lives; a pin older than
        ``spec_pin_ttl`` expires here first (its speculative pages go) and
        the session rejoins the ttl clock."""
        t = at if at is not None else time.time()
        with self._session_lock:
            for sid in [s for s, p in self._pins.items() if t - p > self.ecfg.spec_pin_ttl]:
                self._unpin_session_locked(sid)
        ttl = self.ecfg.session_ttl
        if not ttl:
            return 0
        with self._session_lock:
            dead = [sid for sid, s in self._sessions.items()
                    if t - s.last_used > ttl and sid not in self._pins]
            demote: list[int] = []
            for sid in dead:
                pages = self._sessions.pop(sid).pages
                self.allocator.free(pages)
                self.stats["sessions_evicted"] += 1
                demote += pages
            if demote:
                # idle-session expiry is the canonical demote trigger: the
                # session's published pages just went refcount-0 (a no-op
                # with the tier off; unindexed tail pages skip)
                self.allocator.demote_pages(demote)
        return len(dead)

    def free_session(self, session_id: str) -> bool:
        """Explicitly drop a session's cached prefix, and its keep-warm pin
        and speculation state (thread-safe vs step())."""
        with self._session_lock:
            if session_id in self._pins or session_id in self._spec_by_session:
                self._unpin_session_locked(session_id)
            sess = self._sessions.pop(session_id, None)
            if sess is None:
                return False
            self.allocator.free(sess.pages)
            return True

    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self.slots)

    def has_work(self) -> bool:
        # queued live-fork commands need a step to apply (or to fail), and
        # spec.stall-deferred jobs one to enqueue (or to cancel)
        return (bool(self.pending) or self.num_active > 0 or self._inflight is not None
                or bool(self._prefill_jobs) or bool(self._fork_cmds)
                or bool(self._spec_stalled))

    def _slots_available(self) -> int:
        """Free slots not reserved by prefill jobs (a job must find a slot
        when its prompt completes)."""
        return sum(s is None for s in self.slots) - len(self._prefill_jobs)

    def _alloc_with_eviction(self, n: int) -> list[int] | None:  # guarded by: _session_lock
        """Allocate n pages, evicting if needed (cached prefixes are
        best-effort; live requests win), down the pressure ladder: unpinned
        idle sessions, LRU first; then speculative stashes; then pinned
        sessions, oldest pin first."""
        if _engine_fault("engine.page_pressure") is not None:
            # behave as a pool with no free page
            self.stats["page_pressure_injected"] += 1
            return None
        pages = self.allocator.alloc(n)
        while pages is None:
            unpinned = [s for s in self._sessions if s not in self._pins]
            if unpinned:
                lru_sid = min(unpinned, key=lambda s: self._sessions[s].last_used)
                self.allocator.free(self._sessions.pop(lru_sid).pages)
                self.stats["sessions_evicted"] += 1
            elif self._spec_by_session:
                self._spec_release_locked(next(iter(self._spec_by_session)))
            elif self._pins:
                spill = min(self._pins, key=self._pins.get)
                self._unpin_session_locked(spill)
                sess = self._sessions.pop(spill, None)
                if sess is not None:
                    self.allocator.free(sess.pages)
                    self.stats["sessions_evicted"] += 1
            else:
                break
            pages = self.allocator.alloc(n)
        return pages

    def _session_hit(self, req: Request) -> tuple[_SessionEntry, int] | None:  # guarded by: _session_lock
        """(entry, reusable-token count) on a session prefix hit, without
        mutating the entry (admission may still fail on page starvation)."""
        if not req.session_id or not self.ecfg.enable_prefix_cache or req.mm_embeds:
            return None
        sess = self._sessions.get(req.session_id)
        if sess is None:
            return None
        cl = len(sess.tokens)
        if 0 < cl < len(req.prompt) and req.prompt[:cl] == sess.tokens:
            return sess, cl
        if 0 < len(req.prompt) <= cl and sess.tokens[: len(req.prompt)] == req.prompt:
            # fully resident prompt (e.g. a retry): re-prefill its last token
            # for the sampling logits (the KV rewrite is idempotent)
            return sess, len(req.prompt) - 1
        # mismatched history (edited conversation): drop the entry
        self.allocator.free(self._sessions.pop(req.session_id).pages)
        return None

    # ------------------------------------------------------------------
    # agent-aware serving: keep-warm pins and speculative next-step prefill,
    # under the session lock beside the sessions; every failure falls back
    # to the cold path (no pin, a full prefill of the follow-up)
    # ------------------------------------------------------------------

    def _pin_session_locked(self, sid: str) -> None:  # guarded by: _session_lock
        """Pin a session warm until its follow-up admits or ``spec_pin_ttl``
        passes; past ``spec_pin_budget`` the oldest pin spills."""
        budget = max(1, self.ecfg.spec_pin_budget)
        while sid not in self._pins and len(self._pins) >= budget:
            self._unpin_session_locked(min(self._pins, key=self._pins.get))
        self._pins[sid] = time.time()
        self.stats["session_pins_active"] = len(self._pins)

    def _unpin_session_locked(self, sid: str) -> None:  # guarded by: _session_lock
        """Drop a session's pin and its speculation state (idempotent)."""
        self._pins.pop(sid, None)
        self.stats["session_pins_active"] = len(self._pins)
        self._spec_release_locked(sid)

    def _spec_release_locked(self, sid: str) -> None:  # guarded by: _session_lock
        """Tear down a session's speculative prefills: finished jobs' page
        stashes are freed now, jobs still queued or prefilling cancel at the
        next step."""
        st = self._spec_by_session.pop(sid, None)
        if st is None:
            return
        for rid in st["cands"]:
            pages = st["stashes"].pop(rid, None)
            if pages is None:
                self._cancels.add(rid)
            else:
                self._free_spec_stash_locked(pages)
            self.stats["spec_cancelled_total"] += 1

    def _free_spec_stash_locked(self, pages: list[int]) -> None:  # guarded by: _session_lock
        """Free a speculative page chain now: a page the stash alone holds
        leaves the index first (no refcount-0 ghost of a wrong guess stays
        cached); pages the session or another stash hold just lose a
        reference."""
        for p in pages:
            if self.allocator.is_shared(p) and self.allocator.refcount(p) <= 1:
                self.allocator.forget(p)
        self.allocator.free(pages)

    def _agent_keepwarm_locked(self, sid: str, slot: _Slot) -> None:  # guarded by: _session_lock
        """A request with ``expect_followup`` finished and its session was
        retained: pin it, then enqueue one bottom-priority prefill job per
        declared candidate over the whole transcript (the session holds
        ``tokens[:-1]``, so each job re-prefills the last token too and
        publishes the chain the follow-up walks). ``spec.fail`` vetoes the
        jobs (keep-warm only); ``spec.stall`` defers them by its delay."""
        self._pin_session_locked(sid)
        cands = slot.req.followup_candidates or []
        if not cands or not self._shared_prefix:
            return
        if _engine_fault("spec.fail") is not None:
            self.stats["spec_fail_injected"] += 1
            return
        if sid not in self._sessions:
            return
        stall = _engine_fault("spec.stall")
        st = {"parent": slot.req.id, "base_len": len(slot.tokens), "cands": {}, "stashes": {},
              "t0": {}, "tid": (tracing.valid_context(slot.req.trace) or {}).get("trace_id")}
        for j, cand in enumerate(cands[: max(0, self.ecfg.spec_max_candidates)]):
            if not cand:
                continue
            srid = f"{slot.req.id}!spec{j}"
            sreq = Request(id=srid, prompt=list(slot.tokens) + list(cand),
                           sampling=SamplingParams(max_new_tokens=1, temperature=0.0),
                           priority=_SPEC_PRIORITY, spec_parent=slot.req.id)
            if self._pages_needed(sreq) > self.ecfg.max_pages_per_seq:
                continue  # the speculated step would not fit a slot
            if stall is not None:
                self.stats["spec_stall_injected"] += 1
                self._spec_stalled.append((time.monotonic() + stall.delay_s, sreq))
            elif not self._spec_submit(sreq):
                continue  # the queue is full: speculation yields
            st["cands"][srid] = list(cand)
            st["t0"][srid] = (time.time(), time.perf_counter())
            self.stats["spec_started_total"] += 1
        if st["cands"]:
            self._spec_by_session[sid] = st

    def _spec_submit(self, sreq: Request) -> bool:
        """Enqueue a speculative job unless the queue is full (it never
        takes a caller's backpressure budget)."""
        with self._pending_lock:
            if len(self.pending) >= self.ecfg.max_pending:
                return False
            self._enqueue_locked(sreq)
        return True

    def _drain_spec_stalled(self) -> None:
        """Enqueue the deferred jobs whose delay passed (top of a step); a
        job that finds the queue full retries at the next step."""
        if not self._spec_stalled:
            return
        now = time.monotonic()
        ready = [(rt, r) for rt, r in self._spec_stalled if rt <= now]
        if not ready:
            return
        self._spec_stalled = [(rt, r) for rt, r in self._spec_stalled if rt > now]
        for rt, r in ready:
            if not self._spec_submit(r):
                self._spec_stalled.append((rt, r))

    def _spec_absorb(self, req: Request, start: int) -> None:
        """The follow-up of a pinned session left the queue: the pin goes,
        the winning candidate's stash drops its references (the follow-up
        holds its own), the losers' pages are freed, jobs still running
        cancel; ``spec_hit_total`` when the walk matched past the session."""
        sid = req.session_id
        with self._session_lock:
            if sid not in self._pins and sid not in self._spec_by_session:
                return
            self._pins.pop(sid, None)
            self.stats["session_pins_active"] = len(self._pins)
            st = self._spec_by_session.pop(sid, None)
            if st is None:
                return
            suffix = req.prompt[st["base_len"]:]
            winner = next((rid for rid, cand in st["cands"].items()
                           if rid in st["stashes"] and suffix[: len(cand)] == cand), None)
            if winner is not None and start > st["base_len"]:
                self.stats["spec_hit_total"] += 1
            for rid, cand in st["cands"].items():
                pages = st["stashes"].pop(rid, None)
                if pages is None:
                    self._cancels.add(rid)  # still prefilling: disposable
                    self.stats["spec_cancelled_total"] += 1
                elif rid == winner:
                    self.allocator.free(pages)
                else:
                    self.stats["spec_wasted_tokens_total"] += len(cand)
                    self.stats["spec_cancelled_total"] += 1
                    self._free_spec_stash_locked(pages)

    def _prompt_hashes(self, req: Request) -> list[bytes]:
        """Memoized page-chain hashes of the matchable prompt prefix (prompt
        minus its last token)."""
        hs = self._req_hashes.get(req.id)
        if hs is None:
            hs = page_chain_hashes(req.prompt[: len(req.prompt) - 1], self.ecfg.page_size)
            self._req_hashes[req.id] = hs
        return hs

    def _cached_prefix_len(self, req: Request) -> int:
        """How many prompt tokens a session or shared-prefix hit would skip
        (no references taken). Drives cache-aware admission ordering."""
        if req.mm_embeds or not self.ecfg.enable_prefix_cache or len(req.prompt) < 2:
            return 0
        with self._session_lock:
            if req.session_id and req.session_id in self._sessions:
                sess = self._sessions[req.session_id]
                cl = len(sess.tokens)
                if 0 < cl < len(req.prompt) and req.prompt[:cl] == sess.tokens:
                    return cl
                if 0 < len(req.prompt) <= cl and sess.tokens[: len(req.prompt)] == req.prompt:
                    return len(req.prompt) - 1
                return 0
            if self._shared_prefix:
                return self.allocator.peek(
                    req.prompt[: len(req.prompt) - 1], hashes=self._prompt_hashes(req)
                )
        return 0

    def _try_admit(self) -> list[TokenEvent]:
        """Admit pending requests (the JAX engine's ``_try_admit``): the
        window candidate of the top priority tier with the longest cached
        prefix admits first on the single path; otherwise up to
        ``prefill_batch`` fresh prompts coalesce into one batched prefill,
        deferring fresh prompts whose leading page a batch-mate is about to
        publish. The queue is priority-tier-ordered, so the positional scan
        is the priority scan. A page-starved request does not block the
        queue: admission scans up to ``admit_window`` entries past it,
        collapsing to strict FIFO after ``head_starve_fifo_ticks`` ticks of
        starving the head."""
        if not self.pending:
            return []
        avail = self._slots_available()  # prefill jobs' reservations excluded
        if avail <= 0:
            return []
        N = min(max(1, self.ecfg.prefill_batch), avail)
        window = max(1, self.ecfg.admit_window)
        if self._head_starved_ticks >= self.ecfg.head_starve_fifo_ticks:
            window = 1  # anti-starvation fence: freed pages go to the head
        with self._pending_lock:
            cands = [self.pending[i] for i in range(min(window + N, len(self.pending)))]
        head = cands[0]
        best = None  # (cached_len, window index, req), top priority tier only
        for i in range(min(window, len(cands))):
            if cands[i].priority != head.priority:
                break  # tiers are contiguous: nothing below is top-tier
            cl = self._cached_prefix_len(cands[i])
            if cl > 0 and (best is None or cl > best[0]):
                best = (cl, i, cands[i])
        if best is not None:
            _, i, req = best
            free_slot = next(j for j, s in enumerate(self.slots) if s is None)
            single = self._admit_single(req, free_slot)
            if single:
                if i > 0:
                    self.stats["admission_reorders"] += 1
                    self._head_starved_ticks += 1  # bypassing the head ages the fence
                else:
                    self._head_starved_ticks = 0
                return single
        batch: list[tuple[Request, int, list[int]]] = []  # (req, slot, pages)
        batch_chains: set[bytes] = set()  # leading-page chain hashes in `batch`
        claimed: set[int] = set()
        head_starved = False
        skipped_starved = False
        skips = 0
        for req in cands:
            if len(batch) >= N or skips >= window:
                break
            free_slot = next(
                (j for j, s in enumerate(self.slots) if s is None and j not in claimed), None
            )
            if free_slot is None:
                break
            # branched requests take the single path: the fork needs the
            # request's own last-prompt-token logits; so do both handoff
            # phases (the export samples from them, the adoption installs
            # live without a prefill)
            chunked = (len(req.prompt) > self.ecfg.prefill_chunk or req.n_branches > 1
                       or req.handoff is not None or req.handoff_export)
            with self._session_lock:
                has_sess = (
                    req.session_id is not None
                    and self.ecfg.enable_prefix_cache
                    and req.session_id in self._sessions
                )
                index_hit = False
                if not (chunked or has_sess or req.mm_embeds) and self._shared_prefix:
                    index_hit = (
                        self.allocator.peek(
                            req.prompt[: len(req.prompt) - 1], hashes=self._prompt_hashes(req)
                        )
                        > 0
                    )
            if chunked or has_sess or req.mm_embeds or index_hit:
                if batch:
                    break  # flush the fresh batch first; single path next tick
                single = self._admit_single(req, free_slot)
                if single:
                    if skipped_starved:
                        self.stats["admission_reorders"] += 1
                    if req is head:
                        self._head_starved_ticks = 0
                    elif head_starved:
                        self._head_starved_ticks += 1
                    return single
                skipped_starved = True
                head_starved = head_starved or req is head
                skips += 1
                continue
            h1 = None
            if self._shared_prefix and len(req.prompt) > self.ecfg.page_size:
                h1 = self._prompt_hashes(req)[0]
                if h1 in batch_chains:
                    # a batch-mate is about to prefill (and publish) this same
                    # leading page: defer one tick and reuse it instead
                    self.stats["prefix_batch_deferrals"] += 1
                    skips += 1
                    continue
            with self._session_lock:
                pages = self._alloc_with_eviction(self._pages_needed(req))
            if pages is None:
                skipped_starved = True
                head_starved = head_starved or req is head
                skips += 1
                continue
            if h1 is not None:
                batch_chains.add(h1)
                self.stats["prefix_index_misses"] += 1
            with self._pending_lock:
                self.pending.remove(req)
            self._req_hashes.pop(req.id, None)
            self._observe_queue_wait(req)
            self._tr_dequeue(req)
            claimed.add(free_slot)
            batch.append((req, free_slot, pages))
        if head_starved and batch:
            self.stats["admission_reorders"] += 1
        if head_starved and self.pending and self.pending[0] is head:
            self._head_starved_ticks += 1
        else:
            self._head_starved_ticks = 0
        if not batch:
            return []
        if len(batch) == 1:
            req, slot_idx, pages = batch[0]
            row = build_page_table(pages, self.ecfg.max_pages_per_seq)
            last_logits = self._prefill(req.prompt, 0, row)
            self.stats["prefill_tokens"] += len(req.prompt)
            return self._sample_first_and_install(req, slot_idx, pages, row, last_logits)
        return self._admit_batch(batch)

    def _admit_batch(self, batch: list[tuple[Request, int, list[int]]]) -> list[TokenEvent]:
        """One batched prefill for >= 2 fresh requests, then one first-token
        sample across the rows."""
        rows = [build_page_table(pages, self.ecfg.max_pages_per_seq) for _, _, pages in batch]
        last = self._dense_prefill([req.prompt for req, _, _ in batch], rows)
        toks, lps = self._sample([req.sampling for req, _, _ in batch], last,
                                 [self._first_token_mask(req) for req, _, _ in batch])
        n_tok = sum(len(req.prompt) for req, _, _ in batch)
        self.stats["prefill_tokens"] += n_tok
        self.stats["prefill_batches"] += 1
        with self._telemetry_lock:
            self._tick_tokens.append(n_tok)
        return [
            self._install(req, slot_idx, pages, rows[j], toks[j], lps[j])
            for j, (req, slot_idx, pages) in enumerate(batch)
        ]

    def _acquire_pages(self, req: Request) -> tuple[list[int], int, str] | None:
        """``_acquire_pages_impl``, with an ``engine.kv_restore`` span for a
        traced request whose acquisition restored pages from the host tier."""
        e = self._traces.get(req.id)
        if e is None:
            return self._acquire_pages_impl(req)
        r0 = self.stats.get("kv_offload_restored", 0)
        t0_w, t0_m = time.time(), time.perf_counter()
        acq = self._acquire_pages_impl(req)
        restored = self.stats.get("kv_offload_restored", 0) - r0
        if restored and acq is not None:
            self._tracer.record_span("engine.kv_restore", e["tid"], t0_w,
                                     (time.perf_counter() - t0_m) * 1e3, {"pages": restored})
        return acq

    def _acquire_pages_impl(self, req: Request) -> tuple[list[int], int, str] | None:
        """Page acquisition for one request: session prefix hit (with
        copy-on-write privatization of shared pages in the write range),
        shared-prefix index lookup, or fresh allocation. Returns ``(pages,
        start, kind)`` — ``kind`` in {"session", "index", "fresh"}, ``start``
        the cached-prefix length prefill skips — or None on page starvation
        (acquisition state restored)."""
        ps = self.ecfg.page_size
        index_hit = False
        with self._session_lock:
            hit = self._session_hit(req)
            if (hit is not None and self.ecfg.spec_prefill and self._shared_prefix
                    and not req.mm_embeds and len(req.prompt) > 1
                    and self.allocator.peek(req.prompt[: len(req.prompt) - 1],
                                            hashes=self._prompt_hashes(req)) > hit[1]):
                # the index holds more of this prompt than the session: a
                # speculative prefill published the follow-up's tokens, so
                # the index walk absorbs them (the session entry stays and
                # is re-retained when this request finishes)
                hit = None
            total_pages = self._pages_needed(req)
            if hit is not None:
                sess, start = hit
                # claim the session FIRST so eviction can't free its pages
                self._sessions.pop(req.session_id, None)
                extra_needed = total_pages - len(sess.pages)
                extra = self._alloc_with_eviction(extra_needed) if extra_needed > 0 else []
                if extra is None:
                    self._sessions[req.session_id] = sess  # restore; retry later
                    return None
                pages = list(sess.pages + extra)
                # copy-on-write: every page from start//ps on will be written
                widx0 = start // ps
                cow_idx = []
                for k in range(widx0, min(len(pages), total_pages)):
                    if not self.allocator.is_shared(pages[k]):
                        continue
                    if self.allocator.refcount(pages[k]) <= 1:
                        self.allocator.forget(pages[k])
                        self.stats["prefix_pages_unpublished"] += 1
                    else:
                        cow_idx.append(k)
                if cow_idx:
                    fresh = self._alloc_with_eviction(len(cow_idx))
                    if fresh is None:
                        if extra:
                            self.allocator.free(extra)
                        self._sessions[req.session_id] = sess
                        return None
                    for k, new_page in zip(cow_idx, fresh):
                        if k == widx0 and start % ps:
                            # the only page whose earlier slots are still read
                            self._copy_page(pages[k], new_page)
                        self.allocator.free([pages[k]])
                        pages[k] = new_page
                    self.stats["prefix_cow_copies"] += len(cow_idx)
                if len(pages) > total_pages:
                    # a retry shorter than the history: drop the tail beyond
                    # this request's own page budget
                    self.allocator.free(pages[total_pages:])
                    pages = pages[:total_pages]
            else:
                matched: list[int] = []
                start = 0
                if self._shared_prefix and not req.mm_embeds and len(req.prompt) > 1:
                    matched, start = self.allocator.lookup(
                        req.prompt[: len(req.prompt) - 1], hashes=self._prompt_hashes(req)
                    )
                if matched:
                    extra_needed = total_pages - len(matched)
                    extra = self._alloc_with_eviction(extra_needed) if extra_needed > 0 else []
                    if extra is None:
                        self.allocator.free(matched)
                        return None
                    pages = matched + extra
                    index_hit = True
                else:
                    pages = self._alloc_with_eviction(total_pages)
                    if pages is None:
                        return None
                    if self._shared_prefix and len(req.prompt) > ps:
                        self.stats["prefix_index_misses"] += 1
        kind = "session" if hit is not None else ("index" if index_hit else "fresh")
        return pages, start, kind

    def _dequeue_acquired(self, req: Request, kind: str, start: int) -> None:
        """After a successful acquisition (classic single path or a mixed
        prefill job): the request leaves the pending queue (by identity) and
        its cache hit is counted."""
        with self._pending_lock:
            self.pending.remove(req)
        self._req_hashes.pop(req.id, None)
        self._observe_queue_wait(req)
        self._tr_dequeue(req, start)
        if kind == "session":
            self.stats["prefix_cache_hits"] += 1
            self.stats["prefix_tokens_reused"] += start
        elif kind == "index":
            self.stats["prefix_index_hits"] += 1
            self.stats["prefix_tokens_reused"] += start
        if req.resumed_from > 0 and kind != "fresh" and start > 0:
            # a preempted request resumed over its parked pages
            self.stats["resume_prefix_hits_total"] += 1
        if self.ecfg.spec_prefill and req.session_id and req.spec_parent is None:
            # a follow-up on a pinned session settles the pin and its
            # speculative prefills
            self._spec_absorb(req, start)

    def _admit_single(self, req: Request, free_slot: int) -> list[TokenEvent]:
        """Single-request admission: session reuse, shared-prefix reuse
        (both suffix-only prefill) and chunked long prompts."""
        acq = self._acquire_pages(req)
        if acq is None:
            return []  # page-starved; decode will free pages
        pages, start, kind = acq
        if req.handoff is not None:
            live = self._try_handoff_install(req, free_slot, pages, start, kind)
            if live is not None:
                return live
            # a shortfall: the ordinary suffix prefill below re-samples the
            # same first token under greedy
            self.stats["kv_handoff_failed_total"] += 1
        self._dequeue_acquired(req, kind, start)
        row = build_page_table(pages, self.ecfg.max_pages_per_seq)
        if req.mm_embeds:
            # the whole prompt in one dense prefill, whatever its length:
            # the inject buffer is positioned against the full prompt
            spans = req.mm_embeds if self.mesh is None else _host_embeds(req.mm_embeds)
            last_logits = self._dense_prefill([req.prompt], [row], spans)[0]
        else:
            last_logits = self._prefill(req.prompt[start:], start, row)
        self.stats["prefill_tokens"] += len(req.prompt) - start
        with self._telemetry_lock:
            self._tick_tokens.append(len(req.prompt) - start)
        return self._sample_first_and_install(req, free_slot, pages, row, last_logits)

    def _sample(self, samplings: list[SamplingParams], logits: torch.Tensor,
                masks: list[np.ndarray | None] | None = None):
        """Sample one token per row of ``logits`` [n, V], a grammar row only
        among its ``masks`` entry's allowed tokens; returns host lists
        (tokens, raw-logit logprobs)."""
        toks, lps = self._sample_on_device(samplings, logits, masks)
        return toks.tolist(), lps.tolist()

    def _sample_on_device(self, samplings, logits, masks=None):
        """``_sample`` without the read-back: (tokens, logprobs) tensors."""
        temps = torch.tensor([s.temperature for s in samplings], dtype=torch.float32)
        top_ks = torch.tensor([s.top_k for s in samplings], dtype=torch.int32)
        top_ps = torch.tensor([s.top_p for s in samplings], dtype=torch.float32)
        sample_from = logits
        if masks is not None and any(m is not None for m in masks):
            allowed = np.ones(logits.shape, bool)
            for j, m in enumerate(masks):
                if m is not None:
                    allowed[j] = m
            sample_from = torch.where(torch.from_numpy(allowed).to(logits.device), logits, _MASKED)
        toks = sample_tokens(sample_from, self._gen, temps, top_ks, top_ps)
        lps = torch.gather(torch.log_softmax(logits, dim=-1), 1, toks[:, None].long())[:, 0]
        return toks, lps

    def _sample_first_and_install(
        self, req: Request, slot_idx: int, pages: list[int], row: np.ndarray, last_logits
    ) -> list[TokenEvent]:
        toks, lps = self._sample([req.sampling], last_logits[None], [self._first_token_mask(req)])
        if req.handoff_export:
            ev = self._try_handoff_export(req, pages, toks[0], lps[0])
            if ev is not None:
                return [ev]
            # declined (ineligible, an injected fault, a failed copy): this
            # node decodes the request itself
            self.stats["kv_handoff_failed_total"] += 1
            self.stats["kv_handoff_fail_export_total"] += 1
        if req.n_branches <= 1:
            return [self._install(req, slot_idx, pages, row, toks[0], lps[0])]
        # branch 0 samples first, so its draw is the unforked request's; the
        # siblings fork before it installs, while admission still owns
        # `pages` (a branch 0 that stops on its first token frees them)
        siblings = self._fork_at_install(req, slot_idx, pages, last_logits)
        return [self._install(req, slot_idx, pages, row, toks[0], lps[0])] + siblings

    def _fork_at_install(
        self, req: Request, parent_slot: int, parent_pages: list[int], last_logits
    ) -> list[TokenEvent]:
        """Fork ``req.n_branches - 1`` siblings off a just-prefilled prompt:
        each shares the prompt's full pages (``incref``), copies the partial
        tail page it will both read and write, samples its first token from
        the same logits with its own draw, and installs as a decode
        batch-mate. A sibling that finds no free slot or pages re-queues at
        the front of its tier instead (it re-admits through the prefix
        index branch 0's install publishes)."""
        ps = self.ecfg.page_size
        full = len(req.prompt) // ps
        total = self._pages_needed(req)
        events: list[TokenEvent] = []
        with self._pending_lock:
            parent_exp = self._deadline_at.get(req.id)  # siblings share it
        for j in range(1, req.n_branches):
            sub = dataclasses.replace(req, id=branch_rid(req.id, j), n_branches=1,
                                      session_id=None)
            slot_idx = next((i for i, sl in enumerate(self.slots)
                             if sl is None and i != parent_slot), None)
            pages_j = fresh = None
            if slot_idx is not None and self._slots_available() > 1:
                # > 1: never the last slot a mixed prefill job reserved
                with self._session_lock:
                    fresh = self._alloc_with_eviction(total - full)
                    if fresh is not None:
                        self.allocator.incref(parent_pages[:full])
                        pages_j = parent_pages[:full] + fresh
            if pages_j is None:
                with self._pending_lock:
                    self._enqueue_locked(sub, senior=True)
                    if parent_exp is not None:
                        self._deadline_at[sub.id] = parent_exp
                self.stats["branch_forks_degraded_total"] += 1
                self._tr_fork(req.id, sub.id, degraded=True)
                continue
            if len(req.prompt) % ps:
                self._copy_page(parent_pages[full], fresh[0])
            toks, lps = self._sample([req.sampling], last_logits[None])
            if parent_exp is not None:
                with self._pending_lock:
                    self._deadline_at[sub.id] = parent_exp
            row_j = build_page_table(pages_j, self.ecfg.max_pages_per_seq)
            self._tr_fork(req.id, sub.id)
            events.append(self._install(sub, slot_idx, pages_j, row_j, toks[0], lps[0]))
            self.stats["branch_forks_total"] += 1
        return events

    @_tp_op
    def _copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write: duplicate page `src` into `dst` across all layers
        (values and, for a quantized pool, their scales), in the target pool
        and, with speculation on, the draft pool, so the draft's view of a
        privatized page stays in sync."""
        for cache in (self.cache, self.draft_cache):
            for t in cache.leaves() if cache is not None else ():
                b = bits(t)
                b[:, dst] = b[:, src]

    # ------------------------------------------------------------------
    # the host KV tier: the pool's device-copy callbacks. Under a mesh each
    # rank keeps its own heads of a page: a capture is an operation of the
    # stream, so every rank clones its slice at the same point relative to
    # the kernel's in-place writes; a worker copies its slice to its own
    # host store at once, and rank 0 assembles whole pages only at the wire
    # (``_whole_pages``) and cuts them again for a restore (``_upload_page_kv``)
    # ------------------------------------------------------------------

    def _capture_page_kv(self, page: int):
        """A page's capture for a demotion, a peer's fetch or a handoff tail
        (under the session lock): ``(clones, event, claim)``, the clones
        and event of ``_clone_page``, and on rank 0 of a mesh the claim on
        the workers' slices of the same capture (``_TPRef``; else None)."""
        if self.mesh is None:
            return (*self._clone_page(page), None)
        tid = next(self._tp_ids)
        clones, ev = self._tp_capture(tid, page)
        return clones, ev, _TPRef(tid, self._tp_released)

    @_tp_op
    def _tp_capture(self, tid: int, page: int):
        """A mesh's capture of ``page``, numbered ``tid`` by rank 0: every
        rank clones its slice; a worker copies it to its own host store now
        (its loop runs nothing else meanwhile) and keeps it under ``tid``
        until rank 0 releases it."""
        handle = self._clone_page(page)
        if self._tp_worker:
            self._tp_slices[tid] = self._fetch_page_kv((*handle, None))
        return handle

    def _tp_release(self, tids: list[int]) -> None:
        """A worker drops its slices of the captures rank 0 let go."""
        for tid in tids:
            self._tp_slices.pop(tid, None)

    def _tp_slice_bytes(self, tids: list[int]) -> list[list[np.ndarray]]:
        """A worker's host slices of captures ``tids`` (a query of rank 0:
        ``_whole_pages``), each leaf's raw bytes."""
        return [[t.view(torch.uint8).numpy() for t in self._tp_slices[tid].leaves]
                for tid in tids]

    def _clone_page(self, page: int):
        """A clone of the page's leaves on the device's current stream, and
        an event after it. The pool is written in place (the kernel's fused
        write, ``_copy_page``, restores), so only a copy made now keeps the
        page's content at capture. Target pool only, as in the JAX engine:
        a restored page's draft twin stays stale, which can only lower
        acceptance."""
        clones = [bits(t)[:, page].clone(memory_format=torch.contiguous_format)
                  for t in self.cache.leaves()]
        ev = None
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            # the clones' stream, whichever thread captures (a peer's fetch
            # is served off the engine's thread)
            ev.record(torch.cuda.current_stream(self.device))
        return clones, ev

    def _fetch_page_kv(self, handle) -> _HostPage:
        """The device-to-host copy of one captured page (on the offload
        worker, or on the thread serving a fetch or exporting a handoff):
        wait for the capture's event on the copy stream, copy into
        a host slot (pinned on the card), wait for the copy. The host page
        keeps the capture's claim on the workers' slices."""
        t0 = time.perf_counter()
        clones, ev, claim = handle
        page = self._host_store.take()
        if ev is None:
            for dst, src in zip(page.leaves, clones):
                dst.copy_(src)
        else:
            stream = self._copy_stream
            stream.wait_event(ev)
            with torch.cuda.stream(stream):
                for dst, src in zip(page.leaves, clones):
                    dst.copy_(src, non_blocking=True)
            stream.synchronize()
        page.tp = claim
        self.timing["offload_s"] += time.perf_counter() - t0
        return page

    def _upload_page_kv(self, payloads: list[_HostPage], pages: list[int]) -> None:
        """Restore host pages into device ``pages`` (under the session
        lock). Under a mesh one operation of the stream: every rank uploads
        its heads of each page, from its own host slice when the page was
        captured here (a worker's by capture id), or from its heads of a
        whole page that came from the wire, which rank 0 cuts and sends."""
        if self.mesh is None:
            return self._upload_leaves([p.leaves for p in payloads], [p.done for p in payloads],
                                       pages)
        tp, kh = self.mesh.tp, self.cache.leaves()[0].shape[2]
        sources: list[list] = [[] for _ in range(tp)]
        for p in payloads:
            for r in range(tp):
                if p.tp is not None:  # captured here: each rank's own slice
                    sources[r].append(p.leaves if r == 0 else p.tp.id)
                    continue
                cut = [t[:, r * kh:(r + 1) * kh] for t in p.leaves]
                sources[r].append(cut if r == 0 else
                                  [c.contiguous().view(torch.uint8).numpy() for c in cut])
        self._tp_upload(PerRank(sources), pages,
                        PerRank([[p.done for p in payloads]] + [None] * (tp - 1)))

    @_tp_op
    def _tp_upload(self, sources: list, pages: list[int], done: list | None = None) -> None:
        """A mesh's restore on one rank: per page its leaves (rank 0), or on
        a worker a capture id (its own host slice) or its heads' raw bytes
        (a page from the wire, cut by rank 0)."""
        leaves = []
        if self._tp_worker:
            done = []
            for src in sources:
                if isinstance(src, int):
                    leaves.append(self._tp_slices[src].leaves)
                    done.append(self._tp_slices[src].done)
                else:
                    leaves.append([torch.from_numpy(a).view(bits(t).dtype)
                                   .view(_page_shape(t))
                                   for a, t in zip(src, self.cache.leaves())])
        else:
            leaves = sources
        self._upload_leaves(leaves, done, pages)

    def _upload_leaves(self, leaves: list[list[torch.Tensor]], done: list[list],
                       pages: list[int]) -> None:
        """The restore upload, on the engine's stream: per leaf, the host
        pages into one staging tensor, then one ``index_copy_`` into the
        pool's own storage (the decode graphs hold its addresses; a new
        pool tensor would leave them reading stale memory). Each host slot
        is reused only after the copy's event (``done``, one list a host
        slot read)."""
        on_card = self.device.type == "cuda"
        timed = None
        if on_card:
            timed = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            timed[0].record()
        idx = torch.tensor(pages, dtype=torch.int64).to(self.device)
        for li, t in enumerate(self.cache.leaves()):
            pool = bits(t)
            stage = torch.empty((len(pages),) + pool.shape[:1] + pool.shape[2:],
                                dtype=pool.dtype, device=self.device)
            for j, p in enumerate(leaves):
                stage[j].copy_(p[li], non_blocking=on_card)
            pool.index_copy_(1, idx, stage.transpose(0, 1))
        if on_card:
            timed[1].record()
            for d in done:
                d[0] = timed[1]
            self._restore_timed.append((len(pages), timed))

    def _whole_pages(self, payloads: list[_HostPage]) -> list[_HostPage]:
        """Each page with every head (the wire's form): on rank 0 of a mesh
        a page captured here is assembled in the wire store from rank 0's
        slice and the workers' (one query for all of them); a page from the
        wire, and every page without a mesh, is already whole."""
        mine = [p for p in payloads if p.tp is not None]
        if not mine:
            return list(payloads)
        theirs = self.mesh.workers.query("_tp_slice_bytes", [p.tp.id for p in mine])
        kh = self.cache.leaves()[0].shape[2]
        whole: dict[int, _HostPage] = {}
        for j, p in enumerate(mine):
            w = self._wire_store.take()
            for li, (dst, t) in enumerate(zip(w.leaves, self.cache.leaves())):
                dst[:, :kh] = p.leaves[li]
                for r, ans in enumerate(theirs, start=1):
                    dst[:, r * kh:(r + 1) * kh] = torch.from_numpy(ans[j][li]).view(
                        bits(t).dtype).view(_page_shape(t))
            whole[id(p)] = w
        return [whole.get(id(p), p) for p in payloads]

    def page_kv_bytes(self, pages: list[int]) -> list[list[np.ndarray]]:
        """This rank's heads of device ``pages``, each leaf's raw bytes (a
        check of a restore against its capture, per rank; rank 0 reads a
        worker's through ``Workers.query``)."""
        return [[bits(t)[:, page].contiguous().cpu().view(torch.uint8).numpy()
                 for t in self.cache.leaves()] for page in pages]

    def page_kv_digests(self, pages: list[int]) -> list[str]:
        """A digest of this rank's heads of each device page
        (``page_kv_bytes``, hashed here: a full-width check moves no page
        through the pipe)."""
        import hashlib

        out = []
        for leaves in self.page_kv_bytes(pages):
            h = hashlib.blake2b(digest_size=16)
            for a in leaves:
                h.update(a.tobytes())
            out.append(h.hexdigest())
        return out

    # ------------------------------------------------------------------
    # the cluster tier: the heartbeat sketch, serving a peer's fetch, and
    # adopting what a peer sent; one page payload is a host-store page
    # (``_HostPage``), its wire form the pool's leaves (JAX order and dtype
    # names, every head under a mesh) as raw bytes
    # ------------------------------------------------------------------

    def prefix_sketch(self) -> dict | None:
        """The prefix index's sketch for a heartbeat (``PrefixPagePool.
        sketch``), or None with the shared-prefix cache off or
        ``prefix_sketch_bytes`` 0 (the node then attracts no affinity
        traffic)."""
        if not self._shared_prefix or self.ecfg.prefix_sketch_bytes <= 0:
            return None
        with self._session_lock:
            return self.allocator.sketch(self.ecfg.prefix_sketch_bytes)

    def peek_prefix(self, tokens: Sequence[int]) -> int:
        """Tokens of the longest full-page prefix of ``tokens`` indexed here
        (both tiers, no reference taken): a prefetch asks for the rest
        only."""
        if not self._shared_prefix:
            return 0
        with self._session_lock:
            return self.allocator.peek(tokens)

    def page_payload_spec(self) -> list[tuple[str, tuple[int, ...]]]:
        """``(dtype name, shape)`` of each leaf of one page's payload, the
        wire contract of a cross-node transfer: K and V, each values then
        per-slot scales when quantized, shapes ``(L, Kh, ps, hd)`` and
        ``(L, Kh, ps)`` with every KV head (under a mesh too: a TP node, a
        TP=1 node and a JAX node exchange pages), dtypes named as the JAX
        package names them."""
        tp = 1 if self.mesh is None else self.mesh.tp
        return [(_dtype_name(t.dtype), _page_shape(t, tp)) for t in self.cache.leaves()]

    def page_payload_segs(self) -> list[int]:
        """Bytes of each leaf of one page's payload (``page_payload_spec``)."""
        return [getattr(torch, name).itemsize * math.prod(shape)
                for name, shape in self.page_payload_spec()]

    def build_page_payload(self, leaves: Sequence[torch.Tensor]) -> _HostPage:
        """One host-store page from its wire leaves (host tensors of the
        spec's dtypes and shapes, e.g. ``torch.frombuffer`` views of the
        received bytes, aligned or not): copied byte for byte into a slot of
        the wire store (the host store; rank 0's store of whole pages under
        a mesh)."""
        spec = self.page_payload_spec()
        if len(leaves) != len(spec):
            raise ValueError(f"{len(leaves)} payload leaves, the pool has {len(spec)}")
        page = self._wire_store.take()
        for dst, src, (name, shape) in zip(page.leaves, leaves, spec):
            if (_dtype_name(src.dtype), tuple(src.shape)) != (name, shape):
                raise ValueError(f"leaf {_dtype_name(src.dtype)}{tuple(src.shape)} != "
                                 f"expected {name}{shape}")
            dst.view(torch.uint8).view(-1).copy_(bits(src).reshape(-1).view(torch.uint8))
        return page

    def page_payload_bytes(self, payload: _HostPage) -> bytes:
        """The wire bytes of one host-store page: its leaves' bytes, one
        after another, every head (``_whole_pages``)."""
        whole = self._whole_pages([payload])[0]
        return b"".join(memoryview(t.contiguous().view(torch.uint8).numpy()).cast("B")
                        for t in whole.leaves)

    def adopt_kv_pages(self, entries: Sequence[tuple[bytes, int, tuple[int, ...], Any]]) -> int:
        """Put pages a peer sent, ``(chain, depth, tokens, payload)``, into
        the host store; the next admission's prefix walk restores them (a
        failed restore shortens the walk: a re-prefill, token-exact under
        greedy). Returns the number adopted."""
        if not self._shared_prefix:
            return 0
        with self._session_lock:
            return self.allocator.adopt_host_pages(entries)

    def export_kv_pages(self, chains: Sequence[bytes],
                        max_pages: int = 64) -> list[tuple[bytes, int, _HostPage]]:
        """Serve a peer's fetch: ``(chain, depth, payload)`` for each of
        ``chains`` indexed here, every payload whole. Two phases, as a
        demotion: the device pages are captured under the session lock
        (their content fixed then), and copied to the host outside it, so a
        peer's fetch never stalls the tick; under a mesh the workers'
        slices join them there. A page whose copy fails is left out (the
        peer re-prefills it)."""
        if not self._shared_prefix:
            return []
        with self._session_lock:
            prepped = self.allocator.export_prep(list(chains)[: max(0, int(max_pages))],
                                                 self._capture_page_kv)
        out: list[tuple[bytes, int, _HostPage]] = []
        for chain, depth, obj, kind in prepped:
            if kind == "host":
                out.append((chain, depth, obj))
                continue
            try:
                out.append((chain, depth, self._fetch_page_kv(obj)))
            except Exception:  # noqa: BLE001 — a shorter answer; the peer re-prefills
                continue
        whole = self._whole_pages([p for _, _, p in out])
        return [(c, d, w) for (c, d, _), w in zip(out, whole)]

    # ------------------------------------------------------------------
    # live-slot handoff (two-phase dispatch): the full prompt pages travel
    # by the ordinary publish -> fetch -> adopt path; what ships here is
    # what that path cannot carry, the partial tail page and the sampler
    # state (first token and its logprob)
    # ------------------------------------------------------------------

    def _gc_handoffs_locked(self) -> None:  # guarded by: _session_lock
        """Expire and bound both stashes, oldest first (a shed entry is a
        re-prefill on the other side)."""
        now = time.monotonic()
        for stash in (self._handoff_out, self._handoff_in):
            for key in [k for k, v in stash.items() if v[0] < now]:
                del stash[key]
            while len(stash) >= _HANDOFF_STASH_MAX:
                del stash[next(iter(stash))]

    def pop_handoff_desc(self, request_id: str) -> dict | None:
        """The descriptor of a request that ended ``finish_reason="handoff"``
        (its tail stays stashed for the decode node's fetch)."""
        with self._session_lock:
            entry = self._handoff_out.get(request_id)
        return dict(entry[1]) if entry is not None else None

    def export_handoff_tail(self, handoff_id: str) -> tuple[dict, _HostPage] | None:
        """Pop the stashed (descriptor, tail payload) of one handoff, once;
        None if it aged out or was never exported."""
        with self._session_lock:
            self._gc_handoffs_locked()
            entry = self._handoff_out.pop(handoff_id, None)
        return None if entry is None else (entry[1], entry[2])

    def adopt_handoff_tail(self, handoff_id: str, payload: _HostPage) -> bool:
        """Stash a fetched tail (already checked against
        ``page_payload_spec``) for its phase-2 admission."""
        if not self._shared_prefix:
            return False
        with self._session_lock:
            self._gc_handoffs_locked()
            self._handoff_in[handoff_id] = (time.monotonic() + _HANDOFF_TTL_S, payload)
        return True

    def _try_handoff_export(self, req: Request, pages: list[int], tok: int,
                            first_logprob: float) -> TokenEvent | None:
        """Phase one: publish the prompt's full pages (the decode node pulls
        them by fetch), capture and stash the tail page with the first
        token, release every page and return the one "handoff" event. None
        declines (ineligible, ``kv.handoff_fail``, a failed copy): the
        caller installs the slot and this node decodes."""
        s = req.sampling
        if (not self._shared_prefix or req.grammar is not None or req.mm_embeds
                or req.n_branches > 1 or len(req.prompt) < 2
                # a resumed incarnation already decoded here: its state is
                # not the phase-2 request's (the original prompt)
                or req.resumed_from > 0
                or tok in s.stop_token_ids or s.max_new_tokens <= 1):
            return None
        if _engine_fault("kv.handoff_fail") is not None:
            return None
        ps = self.ecfg.page_size
        L = len(req.prompt)
        k = (L - 1) // ps  # the tail page holds positions [k * ps, L)
        t0_w, t0_m = time.time(), time.perf_counter()
        try:
            with self._session_lock:
                handle = self._capture_page_kv(pages[k])
            payload = self._fetch_page_kv(handle)
        except Exception:  # noqa: BLE001 — declined: decode here, pages still owned
            return None
        desc = {"id": req.id, "t0": tok, "logprob": first_logprob, "prompt_tokens": L,
                "pages": k, "page_size": ps}
        with self._session_lock:
            # the full pages stay cached (refcount 0, indexed), the tail and
            # the growth pages go free
            self.allocator.publish(req.prompt, pages)
            self.allocator.free(pages)
            self._gc_handoffs_locked()
            self._handoff_out[req.id] = (time.monotonic() + _HANDOFF_TTL_S, desc, payload)
        self.stats["kv_handoff_initiated_total"] += 1
        st = self._submit_t.pop(req.id, None)
        if st is not None:  # phase one's TTFT: submit to the handed-off token
            self.ttft_ms.append((time.monotonic() - st) * 1e3)
            self.latency.observe("ttft_ms", self.ttft_ms[-1])
        self._tr_first_token(req)
        e = self._traces.get(req.id)
        if e is not None:
            self._tracer.record_span(
                "engine.kv_export", e["tid"], t0_w, (time.perf_counter() - t0_m) * 1e3,
                {"pages": k, "tail_bytes": self.kv_page_bytes})
        self._tr_close(req.id, "handoff", generated=1)
        self.stats["requests_finished"] += 1
        with self._pending_lock:
            self._deadline_at.pop(req.id, None)
        return TokenEvent(request_id=req.id, token=tok, index=req.resumed_from, finished=True,
                          finish_reason="handoff", logprob=first_logprob)

    def _try_handoff_install(self, req: Request, free_slot: int, pages: list[int], start: int,
                             kind: str) -> list[TokenEvent] | None:
        """Phase two: with every full prompt page matched and the phase-1
        tail adopted, upload the tail into its page and install the slot
        with the phase-1 token, no prefill: the slot is the one the prefill
        node would have decoded. A shortfall returns None (the caller keeps
        the pages and prefills the suffix)."""
        desc = req.handoff
        ps = self.ecfg.page_size
        L = len(req.prompt)
        k = (L - 1) // ps
        t0 = desc.get("t0") if isinstance(desc, dict) else None
        if (not isinstance(desc, dict) or desc.get("page_size") != ps
                or desc.get("prompt_tokens") != L or desc.get("pages") != k
                or not isinstance(t0, int) or isinstance(t0, bool) or start != k * ps):
            self.stats["kv_handoff_fail_walk_total"] += 1
            return None
        with self._session_lock:
            entry = self._handoff_in.pop(str(desc.get("id")), None)
        if entry is None or entry[0] < time.monotonic():
            self.stats["kv_handoff_fail_stash_total"] += 1
            return None
        try:
            with self._session_lock:
                self._upload_page_kv([entry[1]], [pages[k]])
        except Exception:  # noqa: BLE001 — the fallback prefill rewrites the tail page
            self.stats["kv_handoff_fail_upload_total"] += 1
            return None
        self._dequeue_acquired(req, kind, start)
        row = build_page_table(pages, self.ecfg.max_pages_per_seq)
        self.stats["kv_handoff_completed_total"] += 1
        lp = desc.get("logprob")
        return [self._install(req, free_slot, pages, row, t0,
                              float(lp) if lp is not None else 0.0)]

    def restore_upload_ms(self) -> list[tuple[int, float]]:
        """(pages, device ms) of each batched restore upload so far (CUDA
        events around it; empty off the card)."""
        return [(n, a.elapsed_time(b)) for n, (a, b) in list(self._restore_timed)]

    def host_tier_bytes(self) -> int:
        """Host bytes the KV tier has allocated (pinned on the card)."""
        return self._host_store.host_bytes if self._host_store is not None else 0

    def close(self) -> None:
        """Stop the offload worker (idempotent; the engine stays steppable,
        host pages still restore, demotion stops). Takes no engine lock: the
        worker needs the session lock to finish its last commit. Rank 0 of
        a tensor-parallel engine also stops and joins its workers."""
        self.allocator.close()
        if self.mesh is not None:
            self.mesh.close()

    # ------------------------------------------------------------------
    # constrained decoding: the grammar transition bank
    # ------------------------------------------------------------------

    def grammar_bank_stats(self) -> dict[str, int]:
        """Capacity gauges of the constrained-decoding bank: rows free and
        used, grammars resident and pinned by requests."""
        if self.ecfg.grammar_slots <= 0:
            return {
                "grammar_bank_rows": 0,
                "grammar_bank_rows_free": 0,
                "grammar_bank_rows_used": 0,
                "grammar_bank_grammars": 0,
                "grammar_bank_grammars_in_use": 0,
            }
        with self._session_lock:
            free = sum(n for _, n in self._gbank_free)
            usable = self.ecfg.grammar_slots - 1  # row 0 = unconstrained state
            return {
                "grammar_bank_rows": usable,
                "grammar_bank_rows_free": free,
                "grammar_bank_rows_used": usable - free,
                "grammar_bank_grammars": len(self._gbank_entries),
                "grammar_bank_grammars_in_use": sum(
                    1 for e in self._gbank_entries.values() if e["refs"] > 0
                ),
            }

    def _gbank_alloc_range(self, n: int) -> int | None:  # guarded by: _session_lock
        """First fit over the free list (ranges never move, so active
        bank-global state ids stay valid)."""
        for i, (off, size) in enumerate(self._gbank_free):
            if size >= n:
                if size == n:
                    self._gbank_free.pop(i)
                else:
                    self._gbank_free[i] = (off + n, size - n)
                return off
        return None

    def _gbank_free_range(self, off: int, n: int) -> None:  # guarded by: _session_lock
        merged: list[tuple[int, int]] = []
        for o, size in sorted(self._gbank_free + [(off, n)]):
            if merged and merged[-1][0] + merged[-1][1] == o:
                merged[-1] = (merged[-1][0], merged[-1][1] + size)
            else:
                merged.append((o, size))
        self._gbank_free = merged

    def _grammar_acquire(self, g: Grammar) -> int:  # guarded by: _session_lock
        """Register (if new) and reference a grammar's bank rows; under
        capacity pressure unreferenced grammars evict, least recently used
        first. Balanced by ``_grammar_release`` when the request leaves."""
        self._gbank_clock += 1.0
        ent = self._gbank_entries.get(id(g))
        if ent is not None:
            ent["refs"] += 1
            ent["used"] = self._gbank_clock
            return ent["off"]
        if g.trans.shape[1] != self.cfg.vocab_size:
            raise ValueError(
                f"grammar vocab {g.trans.shape[1]} != model vocab {self.cfg.vocab_size}"
            )
        n = g.n_states
        off = self._gbank_alloc_range(n)
        while off is None:
            idle = [k for k, e in self._gbank_entries.items() if e["refs"] <= 0]
            if not idle:
                self.stats["grammar_capacity_errors"] += 1
                raise GrammarCapacityError(
                    f"grammar needs {n} states; bank capacity "
                    f"{self.ecfg.grammar_slots} is exhausted by in-use grammars"
                )
            victim = self._gbank_entries.pop(min(idle, key=lambda k: self._gbank_entries[k]["used"]))
            self._gbank_free_range(victim["off"], victim["n"])
            self.stats["grammar_evictions"] += 1
            off = self._gbank_alloc_range(n)
        self._gbank_trans[off : off + n] = np.where(g.trans >= 0, g.trans + off, -1).astype(np.int16)
        self._gbank_accept[off : off + n] = g.accept
        self._gbank_entries[id(g)] = {"grammar": g, "off": off, "n": n, "refs": 1,
                                      "used": self._gbank_clock}
        self._gbank_dirty_rows.append((off, n))
        return off

    def _grammar_release(self, g: Grammar | None) -> None:  # guarded by: _session_lock
        if g is None:
            return
        ent = self._gbank_entries.get(id(g))
        if ent is not None and ent["refs"] > 0:
            ent["refs"] -= 1  # rows stay cached until capacity pressure evicts them

    def _gbank_device(self) -> dict[str, torch.Tensor]:
        """The device bank, its newly written row ranges copied in first (in
        place: a captured step reads the bank through fixed pointers)."""
        with self._session_lock:
            for off, n in self._gbank_dirty_rows:
                rows = slice(off, off + n)
                for name, host in (("trans", self._gbank_trans), ("accept", self._gbank_accept)):
                    src = torch.from_numpy(host[rows].copy())
                    dev = self._gbank_dev[name]
                    if dev.is_cuda:
                        src = src.pin_memory()
                    dev[rows].copy_(src, non_blocking=dev.is_cuda)
            self._gbank_dirty_rows.clear()
        return self._gbank_dev

    def _first_token_mask(self, req: Request) -> np.ndarray | None:
        """Allowed tokens [V] for the token sampled from prefill logits, or
        None for a free request (its grammar is referenced since submit)."""
        g = req.grammar
        if g is None:
            return None
        allowed = g.trans[g.start] >= 0
        if g.accept[g.start]:
            allowed[list(req.sampling.stop_token_ids)] = True
        return allowed

    def scheduler_stats(self) -> dict[str, float]:
        """Scheduler-latency gauges: inter-token arrival percentiles over a
        rolling window (the stall a mixed tick bounds) and tokens carried
        per device dispatch."""
        with self._telemetry_lock:
            w = sorted(self._itl_window)
            tt = list(self._tick_tokens)

        def pct(p: float) -> float:
            return w[min(len(w) - 1, int(len(w) * p))] * 1e3 if w else 0.0

        return {
            "itl_ms_p50": round(pct(0.50), 3),
            "itl_ms_p99": round(pct(0.99), 3),
            "tokens_per_tick": round(sum(tt) / len(tt), 2) if tt else 0.0,
        }

    def prefix_cache_stats(self) -> dict[str, int]:
        """Gauges of the shared-prefix page pool (counters live in stats)."""
        with self._session_lock:
            a = self.allocator
            return {
                "prefix_cached_pages": a.cached_pages,
                "prefix_shared_pages": a.shared_pages,
                "cached_sessions": len(self._sessions),
                "kv_offload_host_pages": a.host_pages,  # demoted entries held
            }

    def _install(
        self, req: Request, slot_idx: int, pages: list[int], row: np.ndarray, tok: int,
        logprob: float,
    ) -> TokenEvent:
        if self._shared_prefix and not req.mm_embeds:
            # the prompt's KV is final: content-address its full pages now so
            # the rest of a burst reuses them while this one decodes
            with self._session_lock:
                self.allocator.publish(req.prompt, pages)
        st = self._submit_t.pop(req.id, None)
        if st is not None:
            # TTFT as the engine sees it: submit to first sampled token
            self.ttft_ms.append((time.monotonic() - st) * 1e3)
            self.latency.observe("ttft_ms", self.ttft_ms[-1])
        self._tr_first_token(req)
        slot = _Slot(
            req=req, pages=pages, length=len(req.prompt), generated=1, last_token=tok,
            tokens=list(req.prompt) + [tok],
            draft_len=len(req.prompt),  # every prefill replays onto the draft pool
        )
        event = self._emit(slot_idx, slot, tok, logprob)
        if not event.finished:
            s = req.sampling
            self.slots[slot_idx] = slot
            self.page_tables[slot_idx] = row
            self.seq_lens[slot_idx] = slot.length
            self.last_tokens[slot_idx] = tok
            self.temps[slot_idx] = s.temperature
            self.top_ks[slot_idx] = s.top_k
            self.top_ps[slot_idx] = s.top_p
            if req.grammar is not None:
                g = req.grammar
                with self._session_lock:
                    off = self._gbank_entries[id(g)]["off"]
                local = int(g.trans[g.start, tok])
                self.grammar_states[slot_idx] = off + local if local >= 0 else 0
                ids = list(s.stop_token_ids)[:MAX_STOP_IDS]
                self.eos_ids[slot_idx, : len(ids)] = ids
        self._dirty = True
        self._compact_key = None  # membership changed
        return event

    # ------------------------------------------------------------------
    # device work
    # ------------------------------------------------------------------

    @_tp_op
    def _dense_prefill(self, prompts: list[list[int]], rows: list[np.ndarray],
                       mm_embeds=None) -> torch.Tensor:
        """Whole-prompt prefill of fresh prompts from position 0 (one row per
        prompt, padded to the longest): dense causal attention through the
        kernel, then each valid token's K/V scattered into its pages; then
        the same onto the draft pool (its logits discarded). ``mm_embeds``
        (one prompt's ``Request.mm_embeds``) replaces the target's token
        embeddings at its spans; the draft, which has no projector for
        them, prefills the placeholder ids. Returns the target's last-token
        logits [n, V]."""
        t0 = time.perf_counter()
        n, S = len(prompts), max(len(p) for p in prompts)
        ps, dev = self.ecfg.page_size, self.device
        tokens = np.zeros((n, S), np.int64)
        lengths = np.array([len(p) for p in prompts], np.int64)
        for j, p in enumerate(prompts):
            tokens[j, : len(p)] = p
        positions = np.broadcast_to(np.arange(S), (n, S))
        valid = positions < lengths[:, None]
        page_ids = np.take_along_axis(np.stack(rows), positions // ps, axis=1)[valid]
        slot_ids = (positions % ps)[valid]
        # sparse MoE capacity: the JAX engine's prefill of these prompts has
        # one row of the bucket, or prefill_batch rows for a batch
        cap_tokens = (1 if n == 1 else self.ecfg.prefill_batch) * self.ecfg.prefill_bucket(S)
        args = (
            torch.from_numpy(tokens).to(dev), torch.from_numpy(np.array(positions)).to(dev),
            torch.from_numpy(lengths - 1).to(dev), torch.from_numpy(valid).to(dev),
            torch.from_numpy(page_ids.astype(np.int64)).to(dev),
            torch.from_numpy(slot_ids.astype(np.int64)).to(dev), cap_tokens,
        )
        override = None
        if mm_embeds:
            inject = torch.zeros((1, S, self.cfg.hidden_size), dtype=self._target.params[
                "embed"].dtype, device=dev)
            mask = torch.zeros((1, S), dtype=torch.bool, device=dev)
            for off, emb in mm_embeds:
                if not isinstance(emb, torch.Tensor):
                    emb = torch.tensor(np.asarray(emb))  # a copy: JAX arrays are read-only
                inject[0, off:off + emb.shape[0]] = emb.to(device=dev, dtype=inject.dtype)
                mask[0, off:off + emb.shape[0]] = True
            override = (inject, mask)
        logits = self._dense_forward(self._target, *args, embeds_override=override)
        if self._draft is not None:
            self._dense_forward(self._draft, *args)
        self.timing["prefill_s"] += time.perf_counter() - t0
        return logits

    def _dense_forward(self, m: PagedModel, tokens, positions, last_idx, vmask, pid, sid,
                       cap_tokens: int, embeds_override=None):
        """``_dense_prefill``'s forward of one model into its own pool, under
        its prefill cfg (padding masked out of sparse MoE dispatch)."""
        logits, (ks, vs) = llama.forward(m.params, _sparse_prefill_cfg(m.cfg, self.ecfg), tokens,
                                         positions, attn_impl="kernel", last_idx=last_idx,
                                         valid_mask=vmask, capacity_tokens=cap_tokens,
                                         embeds_override=embeds_override, mesh=m.mesh)
        # ks/vs [L, n, S, Kh, hd] -> valid tokens [N, L, Kh, hd]; 1-D index
        # tensors at pool dims 1 and 3 put the token dim first. A quantized
        # pool quantizes each slot on the way in.
        write_pages(m.cache.k_pages, ks.permute(1, 2, 0, 3, 4)[vmask], pid, sid)
        write_pages(m.cache.v_pages, vs.permute(1, 2, 0, 3, 4)[vmask], pid, sid)
        return logits

    @_tp_op
    def _suffix_prefill(self, piece: list[int], start: int, row: np.ndarray) -> torch.Tensor:
        """Prefill ``piece`` at absolute positions ``start...`` over the
        cached pages (``_suffix_forward``), in the target's pool and then the
        draft's. Returns the target's last-position logits [V]."""
        t0 = time.perf_counter()
        logits = self._suffix_forward(self._target, piece, start, row)
        if self._draft is not None:
            self._suffix_forward(self._draft, piece, start, row, unembed=False)
        self.timing["prefill_s"] += time.perf_counter() - t0
        return logits

    def _suffix_forward(self, m: PagedModel, piece: list[int], start: int, row: np.ndarray,
                        unembed: bool = True) -> torch.Tensor | None:
        """One model's suffix prefill into its pool: the chunk packs as
        ragged rows of the table's ``block_q`` width sharing one seq_id, so
        the kernel serves the cached context from its page walk,
        intra-chunk causality from its new-key phase, and writes the chunk's
        K/V in the same launch. Returns the last position's logits [V] (None
        without ``unembed``). The FFN runs under the model's prefill cfg,
        its expert capacity sized from the JAX engine's bucket."""
        cfg, ecfg, dev = m.cfg, self.ecfg, self.device
        pcfg = _sparse_prefill_cfg(cfg, ecfg)
        n = len(piece)
        bucket = ecfg.prefill_bucket(n)
        W = min(
            lookup_blocks(ecfg.page_size, cfg.head_dim, bucket, ecfg.kv_quant_dtype).block_q,
            bucket,
        )
        R = -(-n // W)
        n_pad = R * W - n
        offs = np.arange(R, dtype=np.int32) * W
        tables = torch.from_numpy(np.repeat(row[None], R, axis=0)).to(dev)
        row_starts = torch.from_numpy(start + offs).to(dev)
        n_toks = torch.from_numpy(np.clip(n - offs, 0, W).astype(np.int32)).to(dev)
        ctx_lens = torch.full((R,), start, dtype=torch.int32, device=dev)
        seq_ids = torch.zeros((R,), dtype=torch.int32, device=dev)
        tokens = torch.tensor([piece], dtype=torch.int64, device=dev)
        positions = start + torch.arange(n, device=dev)[None]
        x = llama.embed_tokens(m.params, cfg, tokens, m.mesh)
        cos, sin = llama.rope_sincos(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)

        def as_rows(t):  # [1, n, ...] -> [R, W, ...]
            t = t[0]
            if n_pad:
                t = torch.cat([t, t.new_zeros((n_pad,) + t.shape[1:])])
            return t.reshape((R, W) + t.shape[1:]).contiguous()

        for i in range(cfg.num_layers):
            lp = llama.layer(m.params, i)
            h = llama.rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
            q, k, v = llama.qkv_proj(lp, h, cfg, cos, sin)
            attn, _, _ = ragged_paged_attention(
                as_rows(q), as_rows(k), as_rows(v), *m.cache.layer(i), tables,
                row_starts, n_toks, ctx_lens, seq_ids, window=m.window, mesh=m.mesh,
            )
            attn = attn.reshape(R * W, -1, cfg.head_dim)[:n][None]
            x = llama.attn_out(lp, attn, x, m.mesh)
            x = x + llama.mlp_block(lp, x, pcfg, capacity_tokens=bucket, mesh=m.mesh)
        return llama.unembed(m.params, cfg, x[:, -1], m.mesh)[0] if unembed else None

    def _prefill(self, tokens: list[int], start: int, row: np.ndarray) -> torch.Tensor:
        """Prefill `tokens` from absolute position `start`, in
        ``prefill_chunk`` pieces. A whole prompt from position 0 in one piece
        takes the dense path; everything else the suffix path over cached
        pages. Returns the final position's logits."""
        chunk = self.ecfg.prefill_chunk
        if len(tokens) <= chunk:
            pieces = [(start, list(tokens))]
        else:
            pieces = [
                (start + off, list(tokens[off : off + chunk]))
                for off in range(0, len(tokens), chunk)
            ]
        last_logits = None
        for piece_start, piece in pieces:
            if piece_start == 0 and len(pieces) == 1:
                last_logits = self._dense_prefill([piece], [row])[0]
            else:
                last_logits = self._suffix_prefill(piece, piece_start, row)
        return last_logits

    def forced_decode_logits(self, prompts: list[list[int]],
                             forced: list[list[int]]) -> torch.Tensor:
        """Teacher forcing through the serving path: every prompt prefilled
        over pages of its own (``_prefill``, the path a node with
        ``prefill_batch=1`` admits it by), then ``n = len(forced[0])``
        decode steps over all the rows at once (``_decode_forward``, the
        decode kernel), step s feeding row b the token ``forced[b][s]``
        whatever its logits said. Returns the logits of the prefill and of
        every step, ``[B, 1 + n, V]`` float32 on the host, and frees the
        pages. Runs on the engine's thread (a node's ``_on_engine_thread``)
        between steps; under a mesh every rank runs the same operations."""
        n = len(forced[0]) if forced else 0
        if len(forced) != len(prompts) or any(len(f) != n for f in forced):
            raise ValueError("forced: one token list per prompt, all of one length")
        pages: list[list[int]] = []
        try:
            for p in prompts:
                with self._session_lock:
                    got = self._alloc_with_eviction(-(-(len(p) + n) // self.ecfg.page_size))
                if got is None:
                    raise RuntimeError("forced_decode_logits: no free pages for the prompts")
                pages.append(got)
            rows = [build_page_table(pg, self.ecfg.max_pages_per_seq) for pg in pages]
            steps = [torch.stack([self._prefill(p, 0, r) for p, r in zip(prompts, rows)])]
            tables = np.stack(rows)
            for s in range(n):
                steps.append(self._forced_step(np.array([f[s] for f in forced], np.int64),
                                               np.array([len(p) + s for p in prompts], np.int32),
                                               tables))
            return torch.stack([t.float().cpu() for t in steps], dim=1)
        finally:
            with self._session_lock:
                for pg in pages:
                    self.allocator.free(pg)

    @_tp_op
    def _forced_step(self, tokens: np.ndarray, seq_lens: np.ndarray,
                     tables: np.ndarray) -> torch.Tensor:
        """A decode step of ``forced_decode_logits``: row b's token at
        position ``seq_lens[b]``. Returns logits [B, V]."""
        dev = self.device
        return self._decode_forward(torch.from_numpy(tokens).to(dev),
                                    torch.from_numpy(seq_lens).to(dev),
                                    torch.from_numpy(tables).to(dev))

    def _decode_forward(self, tokens, seq_lens, page_tables) -> torch.Tensor:
        """One decode step's forward over a batch of slots: row b's single
        new token sits at position seq_lens[b] over seq_lens[b] cached keys;
        inactive slots (seq_len 0) are padding rows. Returns logits [B, V]."""
        n_toks = (seq_lens > 0).to(torch.int32)
        return rows_forward(self._target, tokens[:, None], seq_lens, n_toks, page_tables)[:, 0]

    def _graph_step(self, st: DecodeState, variant: str, mode: str) -> None:
        """The step ``DecodeGraphs`` runs for a key's mode: "free" and
        "grammar" (``_decode_step``) or "spec<k>" (``_spec_step``)."""
        if mode.startswith("spec"):
            self._spec_step(st, variant)
        else:
            self._decode_step(st, variant, mode == "grammar")

    def _spec_step(self, st: DecodeState, variant: str) -> None:
        """One speculative step over ``st`` on the device only (the function
        a CUDA graph captures): ``spec_decode.spec_step``, its outputs into
        the state's spec buffers, the next tokens and lengths written back."""
        out = spec_step(self._target, self._draft, st.tokens, st.seq_lens, st.page_tables,
                        st.temps, st.top_ks, st.top_ps, self.ecfg.spec_k, self._gen, variant,
                        share=None if self.mesh is None else self.mesh.broadcast)
        st.spec_tokens.copy_(out.emitted)
        st.spec_logprobs.copy_(out.logprobs)
        st.spec_counts.copy_(out.counts)
        st.seq_lens.copy_(out.new_seq_lens)
        st.tokens.copy_(out.next_tokens)

    def _decode_step(self, st: DecodeState, variant: str, grammar: bool) -> None:
        """``decode_span`` decode steps over ``st``, on the device only (the
        function a CUDA graph captures): forward, the grammar mask (bank row
        of each slot's state; stop ids allowed in accepting states), the
        sampler ``variant``, the raw-logit logprob, then the next tokens,
        lengths and grammar states written back into ``st``."""
        for s in range(self.ecfg.decode_span):
            logits = self._decode_forward(st.tokens, st.seq_lens, st.page_tables)
            if self._tp_worker:  # rank 0 samples; this rank takes its tokens
                st.tokens.copy_(self.mesh.broadcast(torch.empty_like(st.tokens)))
                st.seq_lens.add_((st.seq_lens > 0).to(torch.int32))
                continue
            sample_from = logits
            if grammar:
                bank = self._gbank_dev
                g = st.gstates.long()
                rows = bank["trans"][g].to(torch.int32)  # [B, V]
                stop = torch.zeros_like(rows).scatter_add_(
                    1, st.eos_ids.clamp(0, rows.shape[1] - 1).long(), (st.eos_ids >= 0).to(torch.int32)
                )
                allowed = (rows >= 0) | ((stop > 0) & bank["accept"][g][:, None])
                sample_from = torch.where(allowed, logits, _MASKED)
            toks = sample_tokens(sample_from, self._gen, st.temps, st.top_ks, st.top_ps,
                                 variant=variant)
            if self.mesh is not None:
                self.mesh.broadcast(toks.long())  # the workers' next tokens
            if grammar:
                st.gstates.copy_(torch.gather(rows, 1, toks[:, None].long())[:, 0].clamp(min=0))
            st.out_logprobs[s].copy_(
                torch.gather(torch.log_softmax(logits, dim=-1), 1, toks[:, None].long())[:, 0]
            )
            st.out_tokens[s].copy_(toks)
            st.tokens.copy_(toks)
            st.seq_lens.add_((st.seq_lens > 0).to(torch.int32))  # active rows advance

    def _state(self, width: int) -> DecodeState:
        st = self._states.get(width)
        if st is None:
            st = self._states[width] = DecodeState(
                width, self.ecfg.max_pages_per_seq, self.ecfg.decode_span, self.device,
                spec_k=self.ecfg.spec_k,
            )
        return st

    def _host_rows(self, idx) -> dict[str, np.ndarray]:
        return {
            "tokens": self.last_tokens[idx], "seq_lens": self.seq_lens[idx],
            "page_tables": self.page_tables[idx], "temps": self.temps[idx],
            "top_ks": self.top_ks[idx], "top_ps": self.top_ps[idx],
            "gstates": self.grammar_states[idx], "eos_ids": self.eos_ids[idx],
        }

    def _dev_state(self) -> DecodeState:
        """Full-width control state, rewritten from the host shadows when
        dirty (admission, release, or a compact step since)."""
        st = self._state(self.ecfg.max_batch)
        if self._dirty:
            self._load_state(st.width, self._host_rows(slice(None)))
            self._dirty = False
        return st

    def _compact_state(self, active_idx: list[int], bucket: int) -> DecodeState:
        """The active slots' rows gathered into a ``bucket``-wide state
        (padding rows inert: seq_len 0, no write, zero attention), kept on
        the device while membership is stable."""
        st = self._state(bucket)
        key = (tuple(active_idx), bucket)
        if self._compact_key != key:
            rows = {}
            for name, arr in self._host_rows(active_idx).items():
                fill = {"top_ps": 1.0, "eos_ids": -1}.get(name, 0)  # a free slot's values
                rows[name] = np.full((bucket,) + arr.shape[1:], fill, arr.dtype)
                rows[name][: len(active_idx)] = arr
            self._load_state(bucket, rows)
            self._compact_key = key
        return st

    @_tp_op
    def _load_state(self, width: int, rows: dict[str, np.ndarray]) -> None:
        """Write host rows into the ``width`` decode state's buffers."""
        self._state(width).load(rows)

    @_tp_op
    def _run_graph(self, width: int, variant: str, mode: str) -> bool:
        """One decode (or speculative) step over the ``width`` state, a
        graph replay after the key's first use on the card. Under a mesh on
        the card each rank times its steps (``rank_report``)."""
        timed = self.mesh is not None and self.device.type == "cuda"
        if timed:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        replayed = self._graphs.run(self._state(width), variant, mode)
        if timed:
            ev[1].record()
            self._rank_step_events.append(ev)
        return replayed

    def rank_report(self, reset: bool = False) -> dict:
        """This rank's share of a tensor-parallel engine (rank 0 reads the
        workers' through ``Workers.query``): its weight bytes, the
        hand-written kernels' launch counts in this process, the device ms
        of each decode step it ran (CUDA events), and its collectives
        (count, bytes, host seconds: under gloo the data is staged through
        the host, so these are not performance figures of the card).
        ``reset`` zeroes the counts and timings after reading them."""
        from agentfield_tpu_torch.ops.cuda import ragged_paged_attention as rpa

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out = {
            "rank": 0 if self.mesh is None else self.mesh.rank,
            "weight_bytes": _tree_bytes(self.params),
            "launches": rpa.launch_counts(),
            "step_ms": [a.elapsed_time(b) for a, b in self._rank_step_events],
            "collectives": dict(self.mesh.stats) if self.mesh is not None else {},
            "offload_s": self.timing["offload_s"],  # device-to-host page copies
            "host_slices": len(self._tp_slices),  # a worker's captures held for rank 0
        }
        if reset:
            rpa.reset_launches()
            self._rank_step_events.clear()
            if self.mesh is not None:
                self.mesh.stats.update(calls=0, bytes=0, host_s=0.0)
        return out

    def _pick_decode_bucket(self, n_active: int) -> int | None:
        if not self.ecfg.decode_buckets:
            return None
        for b in sorted(self.ecfg.decode_buckets):
            if n_active <= b < self.ecfg.max_batch:
                return b
        return None

    def graph_stats(self) -> dict:
        """Decode-step CUDA graphs: how many were captured, the host seconds
        their first uses took (eager step and capture), replays per key."""
        return self._graphs.stats()

    def _spec_eligible(self, active_idx: list[int]) -> bool:
        """Speculate this dispatch? Not without a draft, and not while a
        grammar row is active (draft proposals are unsampleable
        mid-schema); and some row must be able to accept proposals (greedy
        or plain temperature): an all-truncated batch would pay k + 1 draft
        forwards and the wide verify for one token a row."""
        if self._draft is None or not active_idx:
            return False
        idx = np.asarray(active_idx)
        if (self.grammar_states[idx] != 0).any():
            return False
        if any(self.slots[i].req.grammar is not None for i in active_idx):
            return False
        can_accept = (self.temps[idx] <= 0) | ((self.top_ks[idx] == 0) & (self.top_ps[idx] >= 1.0))
        return bool(can_accept.any())

    def _resync_draft(self, active_idx: list[int]) -> None:
        """Replay the tokens the draft pool missed (plain-decode fallback
        steps advance the target only) through a draft suffix prefill, so
        speculation resumes with full-context proposals."""
        for i in active_idx:
            slot = self.slots[i]
            if slot.draft_len >= slot.length:
                continue
            self._draft_catch_up(slot.tokens[slot.draft_len : slot.length], slot.draft_len,
                                 self.page_tables[i])
            slot.draft_len = slot.length

    @_tp_op
    def _draft_catch_up(self, missing: list[int], start: int, row: np.ndarray) -> None:
        """The draft's suffix prefill of tokens it missed (``_resync_draft``)."""
        self._suffix_forward(self._draft, missing, start, row, unembed=False)

    def _dispatch_decode(self) -> None:
        """Dispatch one decode span, or one speculative step when
        ``_spec_eligible`` (no host sync), and record it in flight."""
        t0 = time.perf_counter()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        spec = self._spec_eligible(active)
        if spec:
            self._resync_draft(active)
        bucket = self._pick_decode_bucket(len(active))
        st = self._compact_state(active, bucket) if bucket is not None else self._dev_state()
        variant = sampler_variant(self.temps[active], self.top_ks[active], self.top_ps[active])
        grammar = any(self.slots[i].req.grammar is not None for i in active)
        if grammar:
            self._gbank_device()
        mode = f"spec{self.ecfg.spec_k}" if spec else ("grammar" if grammar else "free")
        timed = None
        if st.tokens.is_cuda:
            timed = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            timed[0].record()
        replayed = self._run_graph(st.width, variant, mode)
        if timed is not None:
            timed[1].record()
        if bucket is not None:
            self._dirty = True  # the full-width state did not advance
        toks, lps, counts, done = st.outputs_to_host(spec=spec)
        if spec:
            self._tick_mode = "spec"
            self.stats["decode_steps"] += 1
            self.stats["spec_steps"] += 1
        else:
            self.stats["decode_steps"] += self.ecfg.decode_span
        self._inflight = {
            "tokens": toks, "logprobs": lps, "counts": counts, "done": done,
            "timed": timed if replayed else None,
            "slots": [(i, self.slots[i]) for i in active],
            "compact": bucket is not None,
        }
        self.timing["decode_s"] += time.perf_counter() - t0

    def _harvest_inflight(self) -> list[TokenEvent]:
        prev, self._inflight = self._inflight, None
        return self._apply_harvest(prev)

    def _apply_harvest(self, inf: dict | None) -> list[TokenEvent]:
        """Read a dispatched span's tokens and apply them: advance the host
        shadows, emit events, release finished slots. A slot replaced since
        dispatch (finished) discards its token: object identity is the
        liveness check."""
        if inf is None:
            return []
        t0 = time.perf_counter()
        if inf["done"] is not None:
            inf["done"].synchronize()
        counts = inf["counts"].numpy() if inf["counts"] is not None else None
        if inf["timed"] is not None:
            ms = inf["timed"][0].elapsed_time(inf["timed"][1])
            if counts is not None:
                self.spec_step_ms.append(ms)
            else:
                self.decode_step_ms.append(ms / self.ecfg.decode_span)
        toks, lps = inf["tokens"].numpy(), inf["logprobs"].numpy()  # [span or k+1, width]
        out: list[TokenEvent] = []
        for t in range(toks.shape[0]):
            for j, (i, slot) in enumerate(inf["slots"]):
                if self.slots[i] is not slot:
                    continue  # finished: discard its later span tokens
                row = j if inf["compact"] else i
                if counts is not None:
                    # a spec step emits a variable number of tokens a row
                    if t >= counts[row]:
                        continue
                    self.stats["spec_emitted"] += 1
                tok = int(toks[t, row])
                slot.length += 1
                if counts is not None:
                    slot.draft_len = slot.length  # a spec step writes both pools
                slot.generated += 1
                slot.last_token = tok
                slot.tokens.append(tok)
                self.seq_lens[i] = slot.length
                self.last_tokens[i] = tok
                if slot.req.grammar is not None:
                    # mirror the device-side DFA advance for a later rebuild
                    self.grammar_states[i] = max(int(self._gbank_trans[self.grammar_states[i], tok]), 0)
                self.stats["decode_tokens"] += 1
                out.append(self._emit(i, slot, tok, float(lps[t, row])))
        with self._telemetry_lock:
            self._tick_tokens.append(len(out))
        self.timing["decode_s"] += time.perf_counter() - t0
        return out

    def _emit(self, slot_idx: int, slot: _Slot, tok: int, logprob: float | None = None) -> TokenEvent:
        # inter-token latency: the gap between consecutive token arrivals of
        # one request as a stream consumer sees them
        now = time.perf_counter()
        if slot.last_emit_t > 0.0:
            with self._telemetry_lock:
                self._itl_window.append(now - slot.last_emit_t)
            self.latency.observe("itl_ms", (now - slot.last_emit_t) * 1e3)
        slot.last_emit_t = now
        s = slot.req.sampling
        reason = None
        if tok in s.stop_token_ids:
            reason = "stop"
        elif slot.generated >= s.max_new_tokens:
            reason = "length"
        ev = TokenEvent(
            request_id=slot.req.id, token=tok,
            index=slot.req.resumed_from + slot.generated - 1,  # one sequence across preemptions
            finished=reason is not None, finish_reason=reason, logprob=logprob,
        )
        if ev.finished:
            self._tr_close(slot.req.id, reason, generated=slot.generated)
            self._release(slot_idx, slot)
        return ev

    def _release(self, slot_idx: int, slot: _Slot) -> None:
        if slot.req.spec_parent is not None:
            self._release_spec(slot_idx, slot)
            return
        sid = slot.req.session_id
        with self._session_lock:
            mm = bool(slot.req.mm_embeds)
            if self._shared_prefix and not mm and len(slot.tokens) > 1:
                # publish the GENERATED full pages too (the prompt's were
                # published at install); the last token's KV was never written
                self.allocator.publish(slot.tokens[:-1], slot.pages)
            if sid and self.ecfg.enable_prefix_cache and len(slot.tokens) > 1 and not mm:
                # retain the KV for the next turn; free the tail pages that
                # hold no KV (early stop-token finishes)
                cached = slot.tokens[:-1]
                keep = -(-len(cached) // self.ecfg.page_size)
                if keep < len(slot.pages):
                    self.allocator.free(slot.pages[keep:])
                old = self._sessions.pop(sid, None)
                if old is not None:
                    self.allocator.free(old.pages)
                self._sessions[sid] = _SessionEntry(
                    pages=slot.pages[:keep], tokens=cached, last_used=time.time()
                )
                if self.ecfg.spec_prefill and slot.req.expect_followup:
                    self._agent_keepwarm_locked(sid, slot)
            else:
                self.allocator.free(slot.pages)
        self.stats["requests_finished"] += 1
        with self._pending_lock:
            self._deadline_at.pop(slot.req.id, None)
        if self.slots[slot_idx] is slot:
            self.slots[slot_idx] = None
        self._clear_slot(slot_idx)
        with self._session_lock:
            self._grammar_release(slot.req.grammar)

    def _release_spec(self, slot_idx: int, slot: _Slot) -> None:
        """A speculative job finished: publish its pages (the candidate is
        now content-addressed for the follow-up's walk) and stash its
        references in the session's speculation state, which the absorb or
        the teardown settles; a job whose state is gone frees its pages. Not
        counted in ``requests_finished`` (internal work)."""
        with self._session_lock:
            st = next((e for e in self._spec_by_session.values()
                       if slot.req.id in e["cands"]), None)
            if st is not None and self._shared_prefix and len(slot.tokens) > 1:
                self.allocator.publish(slot.tokens[:-1], slot.pages)
                st["stashes"][slot.req.id] = slot.pages
                t0 = st["t0"].get(slot.req.id)
                if st["tid"] is not None and t0 is not None:
                    # the speculative window, on the parent's trace
                    self._tracer.record_span(
                        "engine.spec_prefill", st["tid"], t0[0],
                        (time.perf_counter() - t0[1]) * 1e3,
                        {"parent": st["parent"], "tokens": len(st["cands"][slot.req.id])})
            else:
                self.allocator.free(slot.pages)
        with self._pending_lock:
            self._deadline_at.pop(slot.req.id, None)
        if self.slots[slot_idx] is slot:
            self.slots[slot_idx] = None
        self._clear_slot(slot_idx)

    def _clear_slot(self, slot_idx: int) -> None:
        """Reset a freed slot's host shadows (a free slot's values) and mark
        the device control state stale: membership changed."""
        self.page_tables[slot_idx] = 0
        self.seq_lens[slot_idx] = 0
        self.temps[slot_idx] = 0.0
        self.top_ks[slot_idx] = 0
        self.top_ps[slot_idx] = 1.0
        self.grammar_states[slot_idx] = 0
        self.eos_ids[slot_idx] = -1
        self._dirty = True
        self._compact_key = None

    # ------------------------------------------------------------------
    # overload control: cancellation, deadlines, priority preemption
    # ------------------------------------------------------------------

    def request_cancel(self, request_id: str) -> None:
        """Cancel a pending, mid-prefill or active request: its slot and
        pages release at the next step() with no terminal event (thread-
        safe)."""
        self._cancels.add(request_id)

    def request_fork(self, src_id: str, new_id: str) -> None:
        """Fork the live slot running ``src_id`` into a new slot ``new_id``
        at the next step(): full pages shared, the partial tail page copied,
        decoding on from the same state with its own draws; its event
        indexes continue from the source's. A source that is gone, or no
        capacity, gives a ``fork_failed`` terminal for ``new_id``
        (thread-safe)."""
        with self._pending_lock:
            self._fork_cmds.append((src_id, new_id))

    def _apply_forks(self) -> list[TokenEvent]:
        """Drain the queued live forks (scheduler thread; the caller
        harvested the step in flight)."""
        with self._pending_lock:
            cmds, self._fork_cmds = self._fork_cmds, []
        events: list[TokenEvent] = []
        for src, new in cmds:
            if not self._fork_live(src, new):
                self.stats["branch_fork_failed_total"] += 1
                events.append(TokenEvent(request_id=new, token=-1, index=-1, finished=True,
                                         finish_reason="fork_failed"))
        return events

    def _fork_live(self, src_id: str, new_id: str) -> bool:
        """Clone the live slot of ``src_id`` into a free slot as ``new_id``.
        Its first ``length`` positions hold KV: the full pages among them
        are shared (decode writes land past them), the partial tail page is
        copied; the pending last token decodes in both from the next step."""
        found = next(((i, s) for i, s in enumerate(self.slots)
                      if s is not None and s.req.id == src_id), None)
        if found is None:
            return False
        _, slot = found
        if slot.req.grammar is not None or slot.req.mm_embeds:
            return False  # the install-time exclusions
        slot_idx = next((i for i, s in enumerate(self.slots) if s is None), None)
        if slot_idx is None or self._slots_available() <= 0:
            return False
        ps = self.ecfg.page_size
        full = slot.length // ps
        with self._session_lock:
            fresh = self._alloc_with_eviction(len(slot.pages) - full)
            if fresh is None:
                return False
            self.allocator.incref(slot.pages[:full])
        pages = slot.pages[:full] + fresh
        if slot.length % ps:
            self._copy_page(slot.pages[full], fresh[0])
        child_req = dataclasses.replace(slot.req, id=new_id, n_branches=1, session_id=None)
        child = _Slot(req=child_req, pages=pages, length=slot.length, generated=slot.generated,
                      last_token=slot.last_token, tokens=list(slot.tokens),
                      draft_len=slot.draft_len)
        self.slots[slot_idx] = child
        self.page_tables[slot_idx] = build_page_table(pages, self.ecfg.max_pages_per_seq)
        self.seq_lens[slot_idx] = child.length
        self.last_tokens[slot_idx] = child.last_token
        s = child_req.sampling
        self.temps[slot_idx] = s.temperature
        self.top_ks[slot_idx] = s.top_k
        self.top_ps[slot_idx] = s.top_p
        self.grammar_states[slot_idx] = 0
        self.eos_ids[slot_idx] = -1
        with self._pending_lock:
            exp = self._deadline_at.get(src_id)  # the clone inherits the budget
            if exp is not None:
                self._deadline_at[new_id] = exp
        self._dirty = True
        self._compact_key = None  # membership changed
        self.stats["branch_forks_total"] += 1
        self._tr_fork(src_id, new_id)
        return True

    def live_request_ids(self) -> list[str]:
        """Ids the engine holds (pending, mid-prefill, active); advisory
        from other threads."""
        with self._pending_lock:
            ids = [r.id for r in self.pending]
        ids += [j.req.id for j in list(self._prefill_jobs)]
        ids += [s.req.id for s in list(self.slots) if s is not None]
        return ids

    def deadline_all_now(self) -> int:
        """Graceful-drain helper: at the next step() every live request gets
        an expired deadline and ends with a ``deadline_exceeded`` terminal
        event (the sweep runs on the scheduler thread). Returns an advisory
        count of live requests."""
        self._drain_sweep = True
        return len(self.live_request_ids())

    def _expire_deadlines(self) -> list[str]:
        """Expired ``deadline_s`` ids (after a pending drain sweep): routed
        through the cancel path; the caller emits their terminal events. A
        request expiring while still pending (and never admitted) counts
        as a queue-time shed."""
        if self._drain_sweep:
            self._drain_sweep = False
            t0 = time.monotonic()
            with self._pending_lock:
                ids = [r.id for r in self.pending]
            ids += [j.req.id for j in self._prefill_jobs]
            ids += [s.req.id for s in self.slots if s is not None]
            with self._pending_lock:
                for rid in ids:
                    self._deadline_at[rid] = t0
        t = time.monotonic()
        with self._pending_lock:
            if not self._deadline_at:
                return []
            expired = [rid for rid, exp in self._deadline_at.items() if exp <= t]
            for rid in expired:
                del self._deadline_at[rid]
            if expired:
                # a preempted-and-resumed request did admit: not a queue shed
                pending_ids = {r.id for r in self.pending if r.resumed_from == 0}
                self.stats["shed_pending_deadline_total"] += sum(
                    1 for rid in expired if rid in pending_ids)
        if expired:
            self._cancels.update(expired)
        return expired

    def _drain_cancels(self, expected: set[str] | None = None) -> None:
        """Apply queued cancels (the caller harvested the step in flight).
        ``expected`` ids (deadline expiries) do not count as unknown."""
        if not self._cancels:
            return
        cancels, self._cancels = self._cancels, set()
        matched: set[str] = set()
        with self._pending_lock:
            for rid in cancels:
                self._deadline_at.pop(rid, None)
            dropped = [r for r in self.pending if r.id in cancels]
            self.pending = collections.deque(r for r in self.pending if r.id not in cancels)
            self.stats["requests_cancelled"] += len(dropped)
        if dropped:
            with self._session_lock:
                for r in dropped:
                    self._grammar_release(r.grammar)
                    if r.session_id and (r.session_id in self._pins
                                         or r.session_id in self._spec_by_session):
                        # a cancelled follow-up leaves no session warm
                        self._unpin_session_locked(r.session_id)
            for r in dropped:
                self._req_hashes.pop(r.id, None)
                matched.add(r.id)
        for job in [j for j in self._prefill_jobs if j.req.id in cancels]:
            # a partial prompt: release its pages without publishing
            with self._session_lock:
                self.allocator.free(job.pages)
            self._prefill_jobs.remove(job)
            self.stats["requests_cancelled"] += 1
            matched.add(job.req.id)
        for i, slot in enumerate(self.slots):
            if slot is not None and slot.req.id in cancels:
                matched.add(slot.req.id)
                # incomplete output: release without session retention
                with self._session_lock:
                    self.allocator.free(slot.pages)
                    self._grammar_release(slot.req.grammar)
                    sid = slot.req.session_id
                    if sid and (sid in self._pins or sid in self._spec_by_session):
                        self._unpin_session_locked(sid)
                self.slots[i] = None
                self._clear_slot(i)
                self.stats["requests_cancelled"] += 1
        if self._spec_stalled:
            # deferred speculative jobs cancel before they ever enqueue
            live = [e for e in self._spec_stalled if e[1].id not in cancels]
            if len(live) != len(self._spec_stalled):
                for _t, r in self._spec_stalled:
                    if r.id in cancels:
                        matched.add(r.id)
                        self.stats["requests_cancelled"] += 1
                self._spec_stalled = live
        for rid in matched:
            self._submit_t.pop(rid, None)
            self._tr_close(
                rid, "deadline_exceeded" if expected and rid in expected else "cancelled")
        unknown = cancels - matched - (expected or set())
        if unknown:  # the client thinks a request is in flight that is not
            self.stats["cancels_unknown"] += len(unknown)

    def _victim_slot(self) -> tuple[int, _Slot] | None:
        """The slot a preemption evicts: lowest priority, then the most
        pages, then the highest index. Grammar-constrained and multimodal
        slots are never preempted (a mid-schema automaton state cannot
        resume through a prompt, and a re-prefill from token ids would lose
        the media)."""
        best = None
        for i, s in enumerate(self.slots):
            if s is None or s.req.grammar is not None or s.req.mm_embeds:
                continue
            key = (s.req.priority, -len(s.pages), -i)
            if best is None or key < best[0]:
                best = (key, i, s)
        return (best[1], best[2]) if best is not None else None

    def _cand_starved(self, cand: Request) -> bool:
        """Would ``cand`` fail to admit this tick? No free slot, or fewer
        allocatable pages than its need beyond its cached prefix. A cached
        prefix on the LRU counts in ``free_pages`` but admission increfs it
        out of that pool, so the overlap is subtracted from the pages free;
        a host-tier prefix page counts as cached but its restore takes a
        fresh page, so those are added back to the need."""
        if self._slots_available() <= 0:
            return True
        with self._session_lock:
            cached_pages = self._cached_prefix_len(cand) // self.ecfg.page_size
            overlap = host = 0
            if (cached_pages and self._shared_prefix
                    and not (cand.session_id and cand.session_id in self._sessions)):
                prefix, hashes = cand.prompt[: len(cand.prompt) - 1], self._prompt_hashes(cand)
                overlap = self.allocator.evictable_prefix_pages(prefix, hashes=hashes)
                host = self.allocator.host_prefix_pages(prefix, hashes=hashes)
            return (self._pages_needed(cand) - cached_pages + host
                    > self.allocator.free_pages - overlap)

    def _maybe_preempt(self) -> list[TokenEvent]:
        """When the queue head out-prioritizes the lowest-priority active
        slot and has been starved for ``preempt_fence_ticks`` consecutive
        ticks of its own, park that slot's KV and re-queue its request
        (``_preempt_slot``; no terminal event). The ``engine.preempt_storm``
        fault point forces a preemption regardless of priority or
        starvation. Returns the events of the step in flight, harvested
        before the slot is touched."""
        if not self.pending:
            self._preempt_starved_ticks = 0
            self._preempt_last_head = None
            return []
        victim = self._victim_slot()
        if victim is None:
            self._preempt_starved_ticks = 0
            self._preempt_last_head = None
            return []
        vi, vslot = victim
        storm = _engine_fault("engine.preempt_storm") is not None
        cand = None
        if storm:
            self.stats["preempt_storm_injected"] += 1
        else:
            if self.ecfg.preempt_fence_ticks <= 0:
                return []  # preemption disabled
            with self._pending_lock:
                cand = self.pending[0] if self.pending else None
            if cand is None or cand.priority <= vslot.req.priority:
                self._preempt_starved_ticks = 0
                self._preempt_last_head = None
                return []
            # starved: the capacity probe says so, or the head is still the
            # one the previous probe saw (admission ran and refused it)
            head_stuck = cand.id == self._preempt_last_head
            if self.ecfg.mixed_step and not self._mixed_eligible(cand):
                # a grammar head admits only on classic ticks: its wait is
                # mode ineligibility, not capacity starvation
                head_stuck = False
            self._preempt_last_head = cand.id
            if not head_stuck:
                self._preempt_starved_ticks = 0  # the fence is per head
                if not self._cand_starved(cand):
                    return []
            self._preempt_starved_ticks += 1
            if self._preempt_starved_ticks < self.ecfg.preempt_fence_ticks:
                return []
        events = self._harvest_inflight()
        if self.slots[vi] is not vslot:
            if not storm:
                # the harvest finished the victim: the capacity came on its own
                self._preempt_starved_ticks = 0
                return events
            # a fired storm still preempts whatever remains preemptable
            victim = self._victim_slot()
            if victim is None:
                return events
            vi, vslot = victim
        if not storm:
            with self._session_lock:
                free = self.allocator.free_pages
            if self._slots_available() > 0 and free >= self._pages_needed(cand):
                # another slot finished in the harvest: admission is certain
                self._preempt_starved_ticks = 0
                return events
        self._preempt_slot(vi, vslot)
        self._preempt_starved_ticks = 0
        return events

    def _preempt_slot(self, slot_idx: int, slot: _Slot) -> None:
        """Evict one active slot without a terminal event: park its KV in
        the prefix index (the last sampled token's KV was never written, so
        the parked prefix is ``tokens[:-1]``) and re-queue the request at the
        front of its tier with the generated tokens folded into its prompt.
        Its resume re-prefills only the last token over the parked pages,
        recomputing the logits the next decode step would have used."""
        req = slot.req
        with self._session_lock:
            if self._shared_prefix:
                self.allocator.park(slot.tokens[:-1], slot.pages)
            else:  # nothing to park into: the resume re-prefills it all
                self.allocator.free(slot.pages)
        resumed = dataclasses.replace(
            req,
            prompt=list(slot.tokens),
            sampling=dataclasses.replace(
                req.sampling, max_new_tokens=req.sampling.max_new_tokens - slot.generated),
            resumed_from=req.resumed_from + slot.generated,
            # forking happens once, at install: a preempted group parent
            # resumes as the single branch it now is
            n_branches=1,
        )
        with self._pending_lock:
            self._enqueue_locked(resumed, senior=True)
        self._req_hashes.pop(req.id, None)  # the prompt changed
        self.slots[slot_idx] = None
        self._clear_slot(slot_idx)
        self.stats["preemptions_total"] += 1
        self._tr_preempt(slot)

    # ------------------------------------------------------------------
    # mixed token-budget ticks
    # ------------------------------------------------------------------

    def _mixed_eligible(self, req: Request) -> bool:
        """Prefill jobs carry plain prompts: a grammar request's first-token
        mask, a multimodal request's inject buffer, a branched request's
        fork (it needs the prompt's last-token logits) and both handoff
        phases (the export samples from those logits, the adoption installs
        without a prefill) are classic-tick features (they admit through
        the classic path)."""
        return (req.grammar is None and not req.mm_embeds and req.n_branches <= 1
                and req.handoff is None and not req.handoff_export)

    def _mixed_tick_ready(self) -> bool:
        """Run the packed mixed tick? While prefill jobs are mid-prompt, or
        when an eligible head waits behind active decodes with a slot free.
        Never while a grammar request is active (its mask is a classic-tick
        feature)."""
        if not self.ecfg.mixed_step:
            return False
        if any(s is not None and s.req.grammar is not None for s in self.slots):
            return False
        if self._prefill_jobs:
            return True
        if not self.pending or self.num_active == 0 or self._slots_available() <= 0:
            return False
        with self._pending_lock:
            head = self.pending[0] if self.pending else None
        return head is not None and self._mixed_eligible(head)

    def _start_mixed_jobs(self, room: int) -> None:
        """Admit pending requests into prefill jobs while the tick has token
        room (the acquisition's cached-prefix probe decides each job's
        start). Fairness as in ``_try_admit``: a starved or ineligible head
        does not block the window, bypasses age the same head-starvation
        fence, and candidates whose leading page an in-flight job is about
        to publish defer (``prefix_batch_deferrals``)."""
        window = max(1, self.ecfg.admit_window)
        if self._head_starved_ticks >= self.ecfg.head_starve_fifo_ticks:
            window = 1  # freed pages go to the head
        job_leads = {j.lead_hash for j in self._prefill_jobs if j.lead_hash}
        with self._pending_lock:
            cands = [self.pending[i]
                     for i in range(min(window + self.ecfg.max_batch, len(self.pending)))]
        head = cands[0] if cands else None
        head_pending = head is not None
        head_blocked = False  # page-starved or ineligible head
        admitted_past_head = False
        skips = 0
        for req in cands:
            if room <= 0 or self._slots_available() <= 0 or skips >= window:
                break
            if not self._mixed_eligible(req):
                head_blocked = head_blocked or req is head
                skips += 1
                continue
            lead = None
            if self._shared_prefix and len(req.prompt) > self.ecfg.page_size:
                lead = self._prompt_hashes(req)[0]
                if lead in job_leads:
                    self.stats["prefix_batch_deferrals"] += 1
                    skips += 1
                    continue
            acq = self._acquire_pages(req)
            if acq is None:
                head_blocked = head_blocked or req is head
                skips += 1
                continue  # page-starved: scan past it
            pages, start, kind = acq
            if kind != "fresh":
                lead = None  # reused pages are published already
            self._dequeue_acquired(req, kind, start)
            row = build_page_table(pages, self.ecfg.max_pages_per_seq)
            self._prefill_jobs.append(_PrefillJob(req=req, pages=pages, row=row, start=start,
                                                  pos=start, lead_hash=lead))
            if lead is not None:
                job_leads.add(lead)
            if req is head:
                head_pending = False
            elif skips > 0:
                admitted_past_head = True
                self.stats["admission_reorders"] += 1
            room -= len(req.prompt) - start
        if admitted_past_head and head_blocked:
            self._head_starved_ticks += 1
        elif head is not None and not head_pending:
            self._head_starved_ticks = 0

    def _mixed_tick(self) -> list[TokenEvent] | None:
        """One token-budget tick: every active slot decodes one token and
        admitting prompts advance by up to ``budget - n_active`` chunk
        tokens, in one packed forward of ``mixed_bucket`` W=1 rows. Returns
        None when no chunk token fits (the caller runs a classic tick)."""
        budget = self.ecfg.mixed_step_budget
        active = [(i, s) for i, s in enumerate(self.slots) if s is not None]
        n_active = len(active)
        committed = sum(len(j.req.prompt) - j.pos for j in self._prefill_jobs)
        self._start_mixed_jobs(budget - n_active - committed)
        committed = sum(len(j.req.prompt) - j.pos for j in self._prefill_jobs)
        bucket = self.ecfg.mixed_bucket(n_active + committed)
        room = bucket - n_active
        chunks: list[tuple[_PrefillJob, int]] = []
        for job in self._prefill_jobs:  # FIFO: head jobs drain first
            if room <= 0:
                break
            n = min(len(job.req.prompt) - job.pos, room)
            if n > 0:
                chunks.append((job, n))
                room -= n
        if not chunks:
            return None
        rows = [(self.page_tables[i], int(self.seq_lens[i]), [int(self.last_tokens[i])])
                for i, _ in active]
        rows += [(job.row, job.pos, job.req.prompt[job.pos : job.pos + n]) for job, n in chunks]
        rr = pack_ragged_rows(rows, self.ecfg.max_pages_per_seq, bucket)
        # the rows whose logits are sampled: every decode row, and a chunk's
        # last row when it reaches its prompt's last token (its request's
        # first generated token)
        done = [j for j, (job, n) in enumerate(chunks) if job.pos + n == len(job.req.prompt)]
        flat = [rr.last_flat[j] for j in range(n_active)] + [rr.last_flat[n_active + j] for j in done]
        samplings = [s.req.sampling for _, s in active] + [chunks[j][0].req.sampling for j in done]
        timed = None
        if self.device.type == "cuda":
            timed = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            timed[0].record()
        toks, lps = self._sample_on_device(samplings, self._mixed_logits(rr, flat))
        if timed is not None:
            timed[1].record()
        toks, lps = toks.tolist(), lps.tolist()
        if timed is not None:
            self.mixed_tick_ms.append(timed[0].elapsed_time(timed[1]))
        events: list[TokenEvent] = []
        for j, (i, slot) in enumerate(active):
            tok = toks[j]
            slot.length += 1
            slot.generated += 1
            slot.last_token = tok
            slot.tokens.append(tok)
            self.seq_lens[i] = slot.length
            self.last_tokens[i] = tok
            self.stats["decode_tokens"] += 1
            events.append(self._emit(i, slot, tok, lps[j]))
        first = dict(zip(done, range(n_active, len(flat))))
        for j, (job, n) in enumerate(chunks):
            job.pos += n
            self.stats["prefill_tokens"] += n
            if j in first:
                self._prefill_jobs.remove(job)
                free_slot = next(i for i, s in enumerate(self.slots) if s is None)
                k = first[j]
                events.append(self._install(job.req, free_slot, job.pages, job.row, toks[k], lps[k]))
        if n_active:
            self.stats["decode_steps"] += 1
        carried = n_active + sum(n for _, n in chunks)
        self._tick_mode = "mixed"
        self._tick_carried = carried
        self.stats["mixed_ticks"] += 1
        self.stats["mixed_tokens"] += carried
        with self._telemetry_lock:
            self._tick_tokens.append(carried)
        # the host shadows advanced outside the device-chained decode state:
        # the next classic dispatch rebuilds it
        self._dirty = True
        self._compact_key = None
        return events

    @_tp_op
    def _mixed_logits(self, rr, flat: list[int]) -> torch.Tensor:
        """The packed forward of a mixed tick over ``rr``'s W=1 rows (token
        r at position ``row_starts[r]``; a chunk's rows share a ``seq_id``
        and its ``ctx_len``), each layer's attention one ragged launch with
        the KV write fused in; the logits [len(flat), V] of the rows
        ``flat`` only (the JAX tick unembeds and samples every row, and the
        host reads these)."""
        cfg, dev = self.cfg, self.device

        def on_dev(a, dtype=None):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return (t if dtype is None else t.to(dtype)).to(dev)

        starts, n_toks = on_dev(rr.row_starts), on_dev(rr.n_tokens)
        ctx_lens, seq_ids, tables = on_dev(rr.ctx_lens), on_dev(rr.seq_ids), on_dev(rr.page_tables)
        x = llama.embed_tokens(self.params, cfg, on_dev(rr.tokens[:, 0], torch.int64),
                               self.mesh)[:, None, :]
        cos, sin = llama.rope_sincos(starts[:, None], cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
        for i in range(cfg.num_layers):
            lp = llama.layer(self.params, i)
            h = llama.rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
            q, k, v = llama.qkv_proj(lp, h, cfg, cos, sin)  # [N, 1, ...]
            attn, _, _ = ragged_paged_attention(
                q, k, v, *self.cache.layer(i), tables, starts, n_toks, ctx_lens, seq_ids,
                window=self.window, mesh=self.mesh,
            )
            x = llama.attn_out(lp, attn, x, self.mesh)
            x = x + llama.mlp_block(lp, x, cfg, mesh=self.mesh)
        return llama.unembed(self.params, cfg, x[on_dev(np.asarray(flat, np.int64))],
                             self.mesh)[:, 0]

    @_tp_op
    def embed_rows(self, rows: list[list[int]], pooling: str = "mean") -> torch.Tensor:
        """The node's embedding forward of token ``rows`` on this engine's
        weights (``model_node.embed_rows``): ``[B, D]`` float32, unit norm."""
        from agentfield_tpu_torch.serving.model_node import embed_rows

        return embed_rows(self.params, self.cfg, rows, pooling, mesh=self.mesh)

    def step(self) -> list[TokenEvent]:
        """One scheduler tick (``_step_inner``). A tick with work is timed
        into the ``tick_ms`` histogram and appends one flight-recorder row
        (the JAX engine's keys: its mode "decode" | "prefill" | "mixed" |
        "spec", batch, token load, free and host pages, the overload
        counters; ``budget_util`` on a mixed tick); a tick that raises
        appends an ``error`` row first."""
        t0 = time.perf_counter()
        self._tick_mode = "decode"
        self._tick_carried = 0
        try:
            events = self._step_inner()
        except Exception as e:
            self.flight.record({
                "t": round(time.time(), 3), "mode": "error", "error": repr(e)[:300],
                "dur_ms": round((time.perf_counter() - t0) * 1e3, 3),
                "active": self.num_active, "pending": len(self.pending),
                "jobs": len(self._prefill_jobs), "free_pages": self.allocator.free_pages,
            })
            raise
        dur_ms = (time.perf_counter() - t0) * 1e3
        active = self.num_active
        if events or active or self._prefill_jobs or self.pending:
            self.latency.observe("tick_ms", dur_ms)
            row = {
                "t": round(time.time(), 3),
                "mode": self._tick_mode,
                "dur_ms": round(dur_ms, 3),
                "active": active,
                "pending": len(self.pending),
                "jobs": len(self._prefill_jobs),
                "events": len(events),
                "finished": sum(1 for ev in events if ev.finished),
                "tokens": self._tick_carried or len(events),
                "free_pages": self.allocator.free_pages,
                "host_pages": self.allocator.host_pages,
                "preemptions_total": self.stats["preemptions_total"],
                "shed_pending_deadline_total": self.stats["shed_pending_deadline_total"],
                "deadline_exceeded": self.stats["deadline_exceeded"],
            }
            if self._tick_mode == "mixed":
                row["budget_util"] = round(
                    self._tick_carried / max(1, self.ecfg.mixed_step_budget), 3)
            self.flight.record(row)
        return events

    def latency_histograms(self) -> dict:
        """Snapshots of the TTFT / inter-token / queue-wait / tick-duration
        histograms (ms buckets), the heartbeat's ``latency_hist``."""
        return self.latency.snapshot()

    def _observe_queue_wait(self, req: Request) -> None:
        st = self._submit_t.get(req.id)
        if st is not None:
            self.latency.observe("queue_wait_ms", (time.monotonic() - st) * 1e3)

    def _step_inner(self) -> list[TokenEvent]:
        """One scheduler tick (the JAX engine's ``_step_inner``): expire
        deadlines; harvest the step in flight if cancels are queued; drain
        the cancels; emit one ``deadline_exceeded`` terminal per expired
        request that did not just finish naturally; maybe preempt; then a
        mixed tick when prompts contend with active decodes (``mixed_step``),
        else admit (prefill) if a slot is free and a request can be
        admitted, else decode. With ``async_decode`` decode is a one-deep
        pipeline: dispatch step N, then read step N-1's tokens while the
        device runs N. Admission, a mixed tick, and a change of membership
        since the dispatch harvest the step in flight first, so the host
        shadows and the device state agree before membership changes. A
        slot that finished has one token in flight; it is discarded at
        harvest, and its KV write lands before any reuse of its freed pages
        because every page write runs in dispatch order on the engine's
        stream."""
        events: list[TokenEvent] = []
        expired = self._expire_deadlines()  # no-op when no deadline is set
        if (self._cancels or self._fork_cmds) and self._inflight is not None:
            # cancels and forks change slots: read the step in flight first
            events += self._harvest_inflight()
        self._drain_cancels(expected=set(expired))
        self._drain_spec_stalled()  # spec.stall's deferred jobs (no-op when none)
        if self._fork_cmds:
            # after the cancels: a prune-then-refork burst of a branch group
            # forks onto the pages its pruned branches just freed
            events += self._apply_forks()
        finished_now = {e.request_id for e in events if e.finished}
        for rid in expired:
            if rid in finished_now:
                continue  # it got its real terminal from the harvest above
            self.stats["deadline_exceeded"] += 1
            events.append(TokenEvent(request_id=rid, token=-1, index=-1, finished=True,
                                     finish_reason="deadline_exceeded"))
        events += self._maybe_preempt()
        if self._mixed_tick_ready():
            events += self._harvest_inflight()  # the packed rows read current shadows
            mixed = self._mixed_tick()
            if mixed is not None:
                return events + mixed
        if self.pending and self._slots_available() > 0:
            # only when a slot is free: under full occupancy this drain would
            # serialize the pipeline every tick for an admission that cannot
            # happen
            events += self._harvest_inflight()
            admitted = self._try_admit()
            if admitted:
                self._tick_mode = "prefill"
                return events + admitted
        if self.num_active == 0:
            return events + self._harvest_inflight()
        inf = self._inflight
        if inf is not None and (
            len(inf["slots"]) != self.num_active
            or any(self.slots[i] is not slot for i, slot in inf["slots"])
        ):
            # membership changed since dispatch: the chained device state no
            # longer matches the host shadows a rebuild reads
            events += self._harvest_inflight()
            if self.num_active == 0:
                return events
        prev, self._inflight = self._inflight, None
        self._dispatch_decode()
        events += self._apply_harvest(prev)
        if not self.ecfg.async_decode:
            events += self._harvest_inflight()
        return events

    def run_to_completion(self, requests: list[Request]) -> dict[str, list[int]]:
        """Submit everything, step until drained, return generated tokens."""
        for r in requests:
            self.submit(r)
        results: dict[str, list[int]] = {r.id: [] for r in requests}
        while self.has_work():
            for ev in self.step():
                if ev.token >= 0:  # a deadline terminal carries no token
                    results.setdefault(ev.request_id, []).append(ev.token)
        return results
