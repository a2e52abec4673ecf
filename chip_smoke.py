#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``agentfield_tpu_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py              # needs one CUDA card

Every run drives every phase, in order; any failure exits non-zero before
the result line:

1. ``device``  require CUDA; print ``nvidia-smi`` name and power limit.
2. ``build``   compile every kernel from ``agentfield_tpu_torch/csrc`` (one
               nvcc per library, in parallel: the attention source once per
               head dim 16/32/64/96/128/256); print the build seconds and
               the tensor-core instructions (HMMA/HGMMA) that ``cuobjdump
               -sass`` finds in each built library (the int8-weight
               library must hold both: wgmma for bf16 x, mma.sync for f32).
3. ``check``   hold each kernel against its plain PyTorch version on the card
               at the canonical mixes (fast and full) and at the Llama-3-8B
               main-path shapes, in float32 and bfloat16: every output element
               within its bound (``elem_bound``), pools bit-equal outside the
               garbage page 0. The shapes reach both kernel paths at their
               edges: decode (the split-context path) at contexts of 0, under
               one split, not a multiple of the split, with a window across
               split edges, and at the served decode shape (32 rows, 9 live
               at the serve's contexts); dense prefill (the tensor-core tile)
               at hd 32/64/128, rep 1/4/8, S not a multiple of 64, with and
               without a window, and at every forward of the api phase's
               embeds (B 1-4, S 480-1500). The head dims of the other presets (96
               phi-3-mini, 256 gemma-2b and gemma-7b, 16 llama-tiny-tp8) at
               each preset's own heads and window: decode at contexts of
               2100 (also over int8 and fp8 pools), a 512-token chunk over
               1024 cached tokens and dense prefill. Show at the 2k-context
               decode shapes (Llama-3-8B and gemma-2b) that the bound
               rejects a kernel fed a quarter of zeroed cached pages or a
               zeroed own key/value. The mixed tick's launch (``mixed_shapes``):
               512 W = 1 rows at Llama-3-8B heads, 16 decode rows at
               contexts 500-2000 and chunks of 240 tokens over 1024 cached
               and 256 over none (also over int8 and fp8 pools, and where
               the two faults must be rejected too), and the same packing at
               phi-3-mini's heads (hd 96) with its window binding. The
               speculative step's launches (``spec_shapes``): the verify at
               Llama-3-8B heads, one row of W = k + 1 tokens a sequence
               over contexts 1900 to 2048 - W, k = 1 and 3 at 4 and 16 rows
               (k = 3 at 4 rows also rejects the two faults), and the
               draft's decode at llama-3.2-draft's heads (hd 64, Kh 2, 16
               rows). Quantized (int8, fp8) pools, at the
               quantized mixes and the Llama-3-8B shapes, in float32 and
               bfloat16 compute, pass three checks: (a) pool values and
               scales bit-equal to the plain version's outside page 0; (b)
               every output element within ``elem_bound`` of the plain
               version run with the kernel's semantics (cached pages
               dequantized to float32, the launch's own K/V unquantized:
               ``dequantized_ref``), which must reject the same two faults;
               (c) outputs within ``PARITY_TOL[mode]`` of the plain version
               proper (the JAX package's semantics: own K/V read back
               quantized). The int8-weight matmul (``csrc/
               int8_weight_matmul.cu``) at every Llama-3-8B projection for
               M of 1-2048 rows and a phi-3-mini width (``w8_shapes``), bf16
               and f32 x, on the packed weight ``quantize_weight`` makes on
               the card, within ``w8_elem_bound`` of the plain version
               computed in f32 from the same (logical) q and scale, each row
               printing its launch plan; the bound rejects a zeroed K tile
               of q and a doubled column scale, both made in the logical q
               and then packed (``W8_FAULT_SHAPES``); one w_gate product at
               M = 32 raises the peak memory by its output and no more (no
               widened copy of q, no workspace); a split-K product captured
               in a CUDA graph, replayed after wider eager products, still
               matches and writes nowhere else (``_check_w8_graph``).
4. ``time``    per shape: the kernel's device time (``ms``: CUDA-event
               median over replays of one wrapper call captured in a CUDA
               graph, so the Python host work of the call is not in it), the
               eager wrapper call (``call_ms``: CUDA events around the call,
               host work included where the host is slower than the card) and
               the plain version, beside the shape's bound (bytes over 3.35
               TB/s or FLOPs over the dtype's peak, whichever is larger; a
               quantized pool moves 1 byte per value plus a 4-byte scale per
               slot); for the dense path ``scaled_dot_product_attention`` as
               the library call; for the ragged shapes, as a yardstick only,
               SDPA over K/V gathered beforehand into contiguous rows (the
               gather not timed; the port never calls it).
5. ``serve``   full-width ``llama-3-8b`` with random bf16 weights drawn on the
               card from ``--seed``, behind the port's HTTP server, with the
               JAX node's decode tick (pipelined, ``decode_buckets`` (4, 16),
               a grammar bank of 256 rows; every decode step after a key's
               first use replayed from its CUDA graph): concurrent requests
               (64-1500-token prompts, one sampled with top-p, one
               ``response_schema`` request whose answer ``match_bytes`` must
               accept) plus a second session turn; every request answered;
               launch counts per path (decode, dense prefill, suffix
               prefill) must all be > 0, and per kernel path:
               decode through the split-context kernel and its combine,
               both prefills through the tensor-core tile. Then the same
               requests on the same weights and geometry with
               ``kv_quant_dtype`` "int8" and "fp8": the quantized kernel
               launched on the decode and suffix-prefill paths, the bf16
               variant never, ``kv_quant_pages_total`` > 0, and peak memory
               below the bf16 serve's. Prints TTFT p50, decode tokens/s,
               decode steps, the mean device ms of a replayed decode step
               (CUDA events around replays), the graphs captured, their
               capture seconds and replays, and peak memory per mode.
5b. ``quant``  weight-only int8 on the serve's weights (``phase_quant``):
               the serve's requests through ``build_model_node(quant=
               "int8")`` (every path through the int8-weight kernel, 7 L
               launches in each decode step's graph, each step counted), the
               replayed width-8 decode step on int8 and bf16 weights (device
               ms, split by kernel kind), full-width logits kernel vs plain
               (both int8), weight bytes int8 vs bf16, a mixed-tick burst and
               a speculative pass (k = 3, fp draft) on the int8 target.
6. ``forward`` one full-width forward with the kernel and with the plain
               attention, compared on logits.
7. ``graph``   the serve's weights in a small engine: a replayed decode
               step against the eager step on the same chained state (same
               greedy tokens; a graph of the forward alone within the
               forward phase's bf16 bound of the eager logits), the
               replay's launches counted, two sampled replays drawing
               differently; the replayed and the eager step timed.
8. ``burst``   a prompt burst (300-1500 tokens, one past the 512-token
               budget, the last a ``response_schema`` request) into 8
               in-flight decodes, on the serve's weights and geometry,
               through the classic tick and then the mixed tick (budget
               512): every request answered, every page returned; the mixed
               engine runs mixed ticks, a chunk spans several, every mixed
               tick's attention goes through the split-context kernel and
               its combine, and captures + replays + mixed ticks with decode
               rows equal its decode steps; one mixed tick's decode-row
               logits within the forward phase's bf16 bound of the classic
               step's. Prints TTFT p50/p99 of the burst, ITL p50/p99 and
               tokens per tick over it, the mixed tick's device ms and peak
               memory per engine.
9. ``overload`` on the same weights, mixed ticks on: a priority-1 request
               starved in a 42-page pool preempts a priority-0 slot (the
               victim still gives all its tokens, the pages balance); a
               pending request's 1 ms deadline sheds it; a cancel in the
               middle of a chunked prompt frees its pages.
10. ``spec``    speculative decoding on the same weights and bf16 pages
               (``phase_spec``): plain, a self draft at k = 3 (more than 2
               tokens a row per spec step; the verify's position-0 logits
               within the forward phase's bf16 bound of the replayed plain
               step's), a random ``llama-3.2-draft`` at k = 3 and 1 beside a
               temperature, a top-k and a schema row (no spec step while
               the schema row decodes, the draft's replay after it); every
               replay counts the launches its graph must make.
11. ``tier``    the host KV tier on the same weights (``phase_tier``): eight
               1536-token sessions over a 640-page pool with 4 GiB of host
               tier, each expiring and demoting before the next; four
               1500-token prompts churn the pool; each session's second
               turn restores its pages. bf16 and int8 (and fp8 for the bit
               check): restored pages bit-equal to their capture, a replay
               after a restore equal to the eager step, no failed restore,
               pages balanced; the resumed turns' greedy tokens equal to an
               HBM-resident engine's. Prints pages and GiB demoted, demote
               GB/s, restore device and host ms, TTFT p50 of the resume
               against a tier-off re-prefill and an HBM hit, peak device
               memory and the host tier's pinned bytes.
12. ``fork``    branch forks through the node (``phase_fork``): a 1000-token
               prompt, 64 new tokens, as 8 best-of-N branches against 8
               separate requests, greedy 4 branches against the unforked
               request (branch 0's first token and logprob equal), and a
               beam request over HTTP (live re-forks between replays):
               tails bit-equal to their parent's, one terminal per branch,
               one winner, no page leaked. Prints pages held at peak, TTFT,
               decode tok/s and the ragged launches per replay.
13. ``api``     the node as the SDK and the control plane call it
               (``phase_api``), on the same weights: ``Agent.ai()``'s
               payload with a prompt and with ``messages`` (tokens equal
               to the plain prompt's and the rendered transcript's), a
               2248-token prompt under "truncate_left" (equal to the
               explicit tail) and "error" (a 4xx), the SSE stream (equal
               to the unary request; TTFT at the first frame), ``embed`` of
               one prompt and of 8 prompts of 64-1500 tokens over HTTP
               (the node's forwards of at most 2048 padded tokens; unit
               norms, 32 dense launches a forward, device ms) and during a
               live decode (its tokens unchanged; the largest frame gap:
               one forward at most), and a stand-in
               control plane that must see the registration, heartbeats
               with the engine's stats, a tracked request's callback and
               the goodbye; then the embeddings through the plain attention
               (cosine at least ``API_COSINE_MIN``).
13a. ``channel`` the gateway's channel, traces and drain (``phase_channel``),
               on the same weights, the gateway played by the port's
               WebSocket client: 8 streamed ``generate`` executions of
               64-1500-token prompts over one socket (one terminal each, seq
               rising by one, tokens equal to the unary channel execution's
               and a direct POST's: each mode sent with the drive thread
               held, so the engine schedules the same queue; first token
               frame host ms against the engine's TTFT), a dropped socket
               reattached without loss or repeat, a cancel freeing its slot,
               a traced execution's waterfall, the decode step with tracing
               on and off, ``/debug/flight``, a ``/profile`` capture's
               kernel events beside the launch counters, and
               ``stop(grace_s=1)`` with a 400-token SSE stream and channel
               execution open (both get a terminal, a late request 503).
               ``[channel]`` line.
13b. ``cluster`` KV that crosses nodes (``phase_cluster``): a prefill node
               and a decode node on the same weights (each its own
               1024-page pool and 1 GiB restore budget), the stand-in
               gateway relaying ``kv_fetch``/``kv_pages`` and page blobs
               between their channels: 8 token prompts of 200-1500 through
               two-phase dispatch (tokens equal to a single-node run, the
               decode node installs each live with no prefill; the gap from
               the phase-1 terminal to its first token frame); 4 prompts of
               1536 tokens held by the prefill node, fetched by the decode
               node under the ``kv_peer`` hint its heartbeat sketch gives
               (tokens equal to the holder's HBM hit, pages bit-equal, fetch
               GB/s, first-frame ms against the hit and a cold re-prefill),
               and on an int8-KV pair; ``kv.fetch_fail``, ``kv.fetch_stall``,
               ``kv.handoff_fail``, ``kv.handoff_stall`` token-exact with no
               page kept; a 3-step agent chain's follow-ups under a
               speculation hit, keep-warm only and cold; one decode launch
               over adopted pages against the plain version. ``[cluster]``
               lines.
13c. ``media``  multimodal serving on the same weights (``phase_media``):
               a vision tower at CLIP ViT-L/14-336 geometry (576 positions
               an image), an audio tower at Whisper-large-v3 encoder
               geometry (1500 positions for 30 s), ``tts-base`` and
               ``imagegen-base``, random bf16 weights; over HTTP an
               ``Agent.ai()`` payload with a PNG and a baseline JPEG of
               seeded 640x480 pictures (the node's own codecs), a 30 s WAV,
               both in one prompt (each injected prefill one
               ``dense_causal_attention`` launch a layer, its TTFT beside a
               text prompt of its length), ``output`` "audio", "speech" and
               "image" (parts decoded back), and a live decode while towers
               run (tokens unchanged, its largest frame gap); the injected
               prompt's last logits, kernel vs plain, within the forward
               phase's bf16 bound. ``[media]`` lines: tower ms, TTFTs,
               launches, the frame gap, peak memory, the phase's seconds.
13d. ``ckpt``   the serve's weights as a Hugging Face checkpoint
               (``phase_ckpt``): written in bf16 as Meta-Llama-3-8B's four
               shards with the index, the published ``config.json``, a
               Llama-3-form ``tokenizer.json`` (merges the smoke learns from
               seeded text) and the Instruct chat template; loaded by
               ``build_model_node(checkpoint=)`` bit-equal (load GB/s, the
               peak above the tree); the serve's script through it, its
               greedy tokens one at a time equal to a ``params=`` node's; a
               ``messages`` payload, a schema request and text round trips
               through the checkpoint's tokenizer; int8 on load (layers 0
               and 31 bit-equal to ``quantize_weight``, 224 int8 launches a
               replayed step); a ``llama-3.2-draft`` checkpoint as a k = 3
               draft. ``phase_ckpt_moe`` (before ``moe``): Mixtral-8x7B at 2
               layers written with the ``block_sparse_moe`` names, loaded as
               int8 (every expert bit-equal), served under soft and sparse
               prefill. About 22.5 GB in a temporary directory
               (``--ckpt-dir``), removed at the end. ``[ckpt ...]`` lines.
13e. ``train`` fine-tune → merge → serve (``phase_train``), on the serve's
               weights before they go: LoRA (rank 8, alpha 16, wq/wk/wv/wo,
               f32 adapters, AdamW 1e-3, remat, the plain attention) on
               2 x 2048 random tokens, 8 steps on one batch: the step-0 loss
               equal to the base loss, the loss falling; the adapter saved
               and served by ``build_model_node(lora=)`` in bf16 (greedy
               tokens equal to a ``params=merge_lora(...)`` node's) and
               int8 (the merge quantized; full-width logits kernel vs plain
               within the quant phase's bound); a full fine-tune of
               ``llama-3.2-1b`` (bf16, AdamW, 4 x 2048, 3 steps: the loss
               falls), its train state saved, restored bit-equal into a
               fresh state, two more steps against the uninterrupted run;
               the weights exported as an HF checkpoint and served (greedy
               tokens equal to a ``params=`` node's). About 10 GB in a
               temporary directory (``--ckpt-dir``), removed at the end.
               ``[train ...]`` lines: losses, step device ms, tokens/s,
               peak memory, the phase's seconds.
14. ``gemma-7b``, ``phi-3-mini``  each at full width and 2 layers (random
               bf16 weights): five requests through the engine (phi-3-mini
               with a prompt past its 2047-token window), every decode
               launch through the split-context kernel, then the
               ``forward`` comparison at its width.
15. ``moe``     ``mixtral-8x7b`` with weight-only int8 layer weights
               (``phase_moe``): the node built with the weights drawn one
               matrix at a time, quantized and packed (the draw's peak
               below the int8 tree + 2 GiB); the serve's requests under
               ``moe_prefill_impl`` "dense" and "sparse" (28 L int8
               launches in each replayed decode step); full-width logits,
               kernel vs plain, soft and sparse routing; the width-8
               decode step split by kernel kind; the int8-weight kernel on
               expert slices at M 8, 16, 256 and 512; a self-draft spec
               pass and a mixed-tick burst. Prints ``[moe ...]`` lines.

Prints the card line, then one JSON line of per-kernel numbers, then
``{"ok": true, "device": {...}}`` as the last line. ``--out PATH`` also
writes every phase's details (each shape, the serve run) as JSON.
``--ab-against DIR`` runs only ``build`` and ``phase_ab``: the kernels of
another checkout (unpacked at DIR) against this one's, in turns: the
attention source at the mixed shapes (where the two differ), the
int8-weight matmul at every bf16 ``w8_shapes`` shape and in the replayed
width-8 decode step on full-width Llama-3-8B int8 weights. ``--w8-sweep``
runs only ``build`` and ``phase_w8_sweep``: every launch plan of the
int8-weight kernel at every bf16 shape (the data behind
``quant_matmul.PLAN_TABLE``).
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import traceback
import urllib.error
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # tensor-core bf16; f32 CUDA cores
# Kernel vs plain version, element by element (``elem_bound``): both
# versions accumulate in float32 from the same inputs and round the output to
# its dtype once, so an element may differ by one ulp of the reference's own
# magnitude in that dtype, plus the float32 summation-order difference before
# the rounding. The bound allows 2 ulps plus 1e-5 absolute; in float32 that
# is far inside the kernel gate's PARITY_TOL["none"] = 2e-3.
SIGNIFICAND_BITS = {"float32": 24, "bfloat16": 8}
SUM_ORDER_ATOL = 1e-5
RAGGED_SRC = "agentfield_tpu_torch/csrc/ragged_paged_attention.cu"
TPU_KERNEL = "agentfield_tpu/ops/pallas/ragged_paged_attention_kernel.py"
QUANT_MODES = ("int8", "fp8")
# an instruction of cuobjdump -sass: "/*0a40*/  @P0 HMMA.16816.F32.BF16 R4, ..."
SASS_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)")
# the serve phase's decode: 9 live slots (8 prompts of 64-1500 tokens and a
# second session turn, partway through their answers) among 32 rows
SERVED_CTX = (64, 200, 333, 480, 512, 700, 1100, 1500, 1532)
# presets whose head dims (96, 256, 256, 16) have their own kernel instances
# beside Llama-3-8B's 128: each is checked at its own heads and window
HEAD_DIM_PRESETS = ("phi-3-mini", "gemma-2b", "gemma-7b", "llama-tiny-tp8")
# the mixed tick's launch (one a layer): W = 1 rows of one token each, 16
# decode rows at their own contexts and two prefill chunks whose rows share a
# seq_id, 512 rows in all (the engine's default mixed_step_budget)
MIXED_DECODE_CTX = tuple(500 + 100 * i for i in range(16))  # 500 ... 2000
MIXED_CHUNKS = ((1024, 240), (0, 256))  # (cached tokens, chunk tokens)
MIXED_ROWS = 512
# the speculative verify at Llama-3-8B's heads: one row of W = k + 1 tokens
# a sequence over its own context (1900 ... 2048 - W), at the engine's
# decode buckets of 4 and 16 rows; and the draft's decode
SPEC_VERIFY = ((1, 4), (1, 16), (3, 4), (3, 16))  # (k, rows)
SPEC_DRAFT = "llama-3.2-draft"
# the int8-weight matmul (csrc/int8_weight_matmul.cu): every Llama-3-8B
# projection (K, N) at the main path's row counts M (decode widths 1-32, the
# verify's 64 rows at width 16 and k = 3, a 512-token prefill chunk or mixed
# tick, a 2048-token embed chunk, and two tiled row counts that are no
# multiple of the 128-row tile: 200, split K at wk/wv, and a 1920-token
# embed chunk), plus phi-3-mini's w_gate/w_up (K = 3072)
W8_SRC = "agentfield_tpu_torch/csrc/int8_weight_matmul.cu"
W8_REPLACES = "agentfield_tpu/models/quant.py:65"  # QuantW.__rmatmul__ (no Pallas twin)
W8_PROJECTIONS = {"wq_wo": (4096, 4096), "wk_wv": (4096, 1024), "wgate_wup": (4096, 14336),
                  "wdown": (14336, 4096)}
W8_M = (1, 8, 16, 32, 64, 200, 512, 1920, 2048)
W8_EXTRA = {"phi3_wgate_wup": ((3072, 8192), (16, 512))}
W8_FAULT_SHAPES = ("wgate_wup_M32", "wdown_M8")
K_TILE_ROWS = 64  # a K tile of the kernel's ring (BK in the source)
# Kernel vs plain, element by element (``w8_elem_bound``): the plain version
# sums (x @ q) in float32 on the card (cuBLAS, TF32 off) and scales in
# float32; the kernel sums the same exact products (an int8 times a bf16
# part of x is exact in f32) in another order and rounds once to the output
# dtype. Any order of a float32 sum of K products errs by at most (K - 1)
# units of 2^-24 times sum |x_k q_k|; the tensor core's accumulation (which
# may truncate) and the plain version each stay within that, so the bound
# is 2 ulps of the output dtype plus 2 K 2^-24 (|x| @ |q|) * scale.
W8_SUM_TERMS = 2
W8_MEMORY_SLACK = 1 << 20  # the w_gate M = 32 call may allocate y plus this
# phase_quant (b), full-width logits of the int8 model, kernel against plain.
# float32: both sum the same exact products in another order (the kernel
# splits x into three bf16 parts, each product exact), 1e-4 of max |logit|
# as phase_forward. bfloat16: the plain version rounds x @ q to bf16 before
# the scale, the kernel scales in float32 and rounds once, at each of the 7
# projections of every layer; each path lies about one bf16 rounding
# distance from the float32 logits in a direction of its own, so the two
# are held within twice the plain path's own bf16-vs-f32 distance (the
# triangle bound).
W8_LOGITS_F32_REL = 1e-4
W8_LOGITS_BF16_FACTOR = 2.0

# shapes at which the bound must reject the two injected faults
FAULT_SHAPES = ("llama3_decode_ctx2k", "gemma-2b_decode_ctx2k", "llama3_mixed_w1",
                "llama3_verify_k3_b4_ctx2k")


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` over ``n`` timed runs (CUDA events
    around each eager call: host work shows where the card waits for it)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, n: int = 20) -> float:
    """Median device milliseconds of one ``fn`` call: ``fn`` captured once in
    a CUDA graph (after two warm-up calls on a side stream), the graph
    replayed ``n`` times between CUDA events. The Python host work of the
    call is not in it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    del g
    return statistics.median(times)


# --------------------------------------------------------------------------
# shapes


def ragged_shapes():
    """name -> build_case params. Canonical mixes (fast and full) plus the
    Llama-3-8B main-path shapes (Kh 8, rep 4, hd 128, ps 16, 128-page
    tables): decode of 32 slots at ~512 and ~2k context, and a 512-token
    prefill chunk over 1024 cached tokens in the engine's 256-wide rows."""
    from agentfield_tpu_torch.ops.kernel_shapes import SHAPES

    out = {}
    for name, tiers in SHAPES.items():
        for tier, p in tiers.items():
            out[f"{name}/{tier}"] = dict(p)
    out["mixed_ragged/fast+window"] = dict(SHAPES["mixed_ragged"]["fast"], window=50)
    l3 = dict(page_size=16, maxp=128, kh=8, rep=4, hd=128)
    out["llama3_decode_ctx512"] = dict(l3, rows=32, ctx=512)
    out["llama3_decode_ctx2k"] = dict(l3, rows=32, ctx=2040)
    out["llama3_chunk512_over1k"] = dict(l3, chunk=512, ctx=1024, W=256)
    # the served decode shape, and the split-context decode path's edges
    # (its splits hold 256 cached keys): contexts from 0 (row 0) to 6, under
    # one split, not a multiple of it, and a window across split edges
    out["llama3_served_decode"] = dict(l3, served=SERVED_CTX, pad_to=32)
    out["llama3_decode_ctx0"] = dict(l3, rows=8, ctx=0)
    out["llama3_decode_ctx100"] = dict(l3, rows=8, ctx=100)
    out["llama3_decode_ctx300"] = dict(l3, rows=8, ctx=300)
    out["llama3_decode_ctx1000+window300"] = dict(l3, rows=8, ctx=1000, window=300)
    out.update(mixed_shapes())
    out.update(head_dim_shapes())
    out.update(spec_shapes())
    return out


def verify_ctx(rows: int, W: int) -> tuple[int, ...]:
    """Contexts of a verify launch's rows: 1900 up to 2048 - W, spread."""
    return tuple(1900 + (2048 - W - 1900) * r // (rows - 1) for r in range(rows))


def spec_shapes():
    """The speculative step's launches: the verify (``SPEC_VERIFY``: W = 2
    rides the split-context path, W = 4 the tensor-core tile) and the
    draft's W = 1 decode of 16 rows at contexts 2040-2046 (Kh 2, rep 4, hd
    64: the 4-row split instance)."""
    l3 = dict(page_size=16, maxp=128, kh=8, rep=4, hd=128)
    out = {f"llama3_verify_k{k}_b{rows}_ctx2k": dict(
        l3, W=k + 1, chunk_list=tuple((c, k + 1) for c in verify_ctx(rows, k + 1)))
        for k, rows in SPEC_VERIFY}
    (kh, rep, hd), _ = _preset_heads(SPEC_DRAFT)
    out[f"{SPEC_DRAFT}_decode_ctx2k"] = dict(page_size=16, maxp=128, kh=kh, rep=rep, hd=hd,
                                             rows=16, ctx=2040)
    return out


def mixed_shapes():
    """The mixed tick's W = 1 launch: at Llama-3-8B's heads (``MIXED_*``),
    and at phi-3-mini's (hd 96, rep 1) with its window of 2047 binding on
    decode rows at contexts up to 2400 and a 240-token chunk over 2100
    cached tokens."""
    (kh, rep, hd), window = _preset_heads("phi-3-mini")
    return {
        "llama3_mixed_w1": dict(page_size=16, maxp=128, kh=8, rep=4, hd=128,
                                served=MIXED_DECODE_CTX, chunk_list=MIXED_CHUNKS, W=1,
                                pad_to=MIXED_ROWS),
        "phi-3-mini_mixed_w1+window": dict(
            page_size=16, maxp=160, kh=kh, rep=rep, hd=hd, window=window,
            served=tuple(600 + 120 * i for i in range(16)), chunk_list=((2100, 240), (0, 256)),
            W=1, pad_to=MIXED_ROWS),
    }


def _preset_heads(preset: str):
    """(kh, rep, hd) of a preset and its sliding window (or None)."""
    from agentfield_tpu_torch.models.configs import get_config

    cfg = get_config(preset)
    return (cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.head_dim), cfg.sliding_window


def head_dim_shapes():
    """The new head dims' ragged shapes, at each preset's own heads and
    window: decode of 8 rows at contexts 2100-2106 (phi-3-mini's window of
    2047 binds), and a 512-token chunk over 1024 cached tokens in the rows
    the engine packs (``block_q`` of its kernel table)."""
    from agentfield_tpu_torch.ops.kernel_autotune import lookup_blocks

    out = {}
    for preset in HEAD_DIM_PRESETS:
        (kh, rep, hd), window = _preset_heads(preset)
        base = dict(page_size=16, maxp=136, kh=kh, rep=rep, hd=hd)
        if window is not None:
            base["window"] = window
        out[f"{preset}_decode_ctx2k"] = dict(base, rows=8, ctx=2100)
        out[f"{preset}_chunk512_over1k"] = dict(
            base, chunk=512, ctx=1024, W=min(lookup_blocks(16, hd, 512).block_q, 512))
    return out


def quant_shapes():
    """name -> build_case params over int8/fp8 pools: the quantized mixes
    (fast and full, and a windowed one) and the three Llama-3-8B shapes in
    each mode."""
    from agentfield_tpu_torch.ops.kernel_shapes import QUANT_SHAPES

    out = {f"{name}/{tier}": dict(p) for name, tiers in QUANT_SHAPES.items()
           for tier, p in tiers.items()}
    for mode in QUANT_MODES:
        out[f"mixed_ragged_{mode}/fast+window"] = dict(
            QUANT_SHAPES[f"mixed_ragged_{mode}"]["fast"], window=50)
    decode_new_hd = tuple(f"{p}_decode_ctx2k" for p in HEAD_DIM_PRESETS)
    for name in ("llama3_decode_ctx512", "llama3_decode_ctx2k", "llama3_chunk512_over1k",
                 "llama3_served_decode", "llama3_decode_ctx300",
                 "llama3_decode_ctx1000+window300", "llama3_mixed_w1") + decode_new_hd + tuple(
                     spec_shapes()):
        for mode in QUANT_MODES:
            out[f"{name}_{mode}"] = dict(ragged_shapes()[name], kv_dtype=mode)
    return out


def dense_shapes():
    """(B, S, H, Kh, hd, window) of the dense-prefill checks: the Llama-3-8B
    batch, then hd 32/64, rep 1/4/8, S not a multiple of 64, windows; then
    two 512-token prompts at each ``HEAD_DIM_PRESETS`` preset's heads; then
    every Llama-3-8B forward of ``phase_api``'s embeds."""
    new_hd = []
    for preset in HEAD_DIM_PRESETS:
        (kh, rep, hd), _ = _preset_heads(preset)
        new_hd.append((2, 512, kh * rep, kh, hd, None))
    embeds = tuple((B, S, 32, 8, 128, None) for B, S in api_embed_forwards())
    return ((4, 512, 32, 8, 128, None), (2, 200, 8, 2, 64, None), (2, 100, 4, 4, 32, None),
            (1, 333, 16, 2, 64, None), (2, 200, 8, 2, 64, 50), (1, 333, 16, 2, 64, 100),
            (2, 100, 4, 4, 32, 7)) + tuple(new_hd) + embeds


def ragged_work(case, es: int, window, pool_es: int | None = None):
    """(bytes, flops) the ragged launch must move/do on these inputs: q,
    new K/V and output once, each sequence's cached keys once, the written
    K/V slots once; FLOPs 4*H*hd per (query, attended key). ``es`` is the
    element size of q, new K/V and output; a quantized pool (``pool_es``
    bytes per value) also holds a 4-byte scale per slot and KV head."""
    q, kn, _, kp, _, tables, starts, ntok, ctx, seqs = case[:10]
    H, hd = q.shape[2], q.shape[3]
    Kh = kn.shape[2]
    slot = Kh * hd * es if pool_es is None else Kh * (hd * pool_es + 4)  # one K or V slot
    nq = int(ntok.sum())
    keys = 0
    cached = {}
    for r in range(len(ntok)):
        for w in range(int(ntok[r])):
            p = int(starts[r]) + w
            keys += min(p + 1, window) if window else p + 1
        if ntok[r] > 0:
            lo = int(starts[r]) - window + 1 if window else 0
            cached[int(seqs[r])] = max(0, int(ctx[r]) - max(0, lo))
    bytes_ = (
        es * nq * H * hd * 2  # q in, out
        + es * nq * Kh * hd * 2  # k_new/v_new in
        + nq * slot * 2  # written K and V slots out
        + sum(cached.values()) * slot * 2  # cached K and V
    ) + 4 * (tables.size + 4 * len(ntok))
    return bytes_, 4 * H * hd * keys


def elem_bound(o_r, dtype_name: str):
    """Per-element bound of |kernel - plain|: 2 ulps of |o_r| in the output
    dtype plus ``SUM_ORDER_ATOL`` (exact zeros, as in padding rows, get no
    ulp term)."""
    import torch

    r = o_r.float().abs()
    _, e = torch.frexp(r)  # r = m * 2^e, m in [0.5, 1): ulp = 2^(e - bits)
    ulp = torch.exp2((e - SIGNIFICAND_BITS[dtype_name]).float())
    return 2 * torch.where(r > 0, ulp, 0.0) + SUM_ORDER_ATOL


def compare(o_k, o_r, dtype_name: str):
    """(within bound, max |kernel - plain|, max of |kernel - plain| / bound)."""
    import torch

    d = (o_k.float() - o_r.float()).abs()
    ratio = float((d / elem_bound(o_r, dtype_name)).max())
    ok = ratio <= 1.0 and bool(torch.isfinite(o_k.float()).all())
    return ok, float(d.max()), ratio


def bound_ms(bytes_, flops, dtype_name):
    t_bytes = bytes_ / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------------
# phases


def phase_build(results):
    import shutil

    from agentfield_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    libs = build.build_all(verbose=True)
    secs = time.perf_counter() - t0
    log(f"[build] {len(libs)} source(s) in {secs:.2f} s: {sorted(libs)}")
    results["build_s"] = secs
    # tensor-core instructions in the built code (sm_90a SASS)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = {}
    for name, path in sorted(libs.items()):
        if not os.path.exists(tool):
            log(f"[build] cuobjdump not found: SASS of {name} not read")
            continue
        out = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                             timeout=300, check=True).stdout
        ops = [m.group(1) for m in SASS_OP.finditer(out)]
        sass[name] = {op: ops.count(op) for op in ("HMMA", "HGMMA")}
        log(f"[build] {name}: SASS tensor-core instructions {sass[name]}")
    for name, ops in sass.items():
        if name.startswith(("ragged_paged_attention", "int8_weight_matmul")):
            assert ops["HMMA"] > 0, f"no HMMA in the library {name}"
        if name.startswith("int8_weight_matmul"):  # the bf16 paths run on wgmma
            assert ops["HGMMA"] > 0, f"no HGMMA in the library {name}"
    results["sass_mma"] = sass


def _to(t, dtype, dev):
    import torch

    t = torch.from_numpy(t).to(dev)
    return t.to(dtype) if t.is_floating_point() else t


def fault_check(case, dname, o_r, window, attn):
    """Show that ``compare`` rejects a faulty kernel output at this shape:
    run ``attn`` (the kernel's wrapper) once with every fourth cached page
    of each row zeroed (values, and scales of a quantized pool), and once
    with the rows' own new key/value zeroed, and compare each with the
    intact plain output ``o_r``. ``case`` is ``(q, k_new, v_new, k_pages,
    v_pages, 5 descriptors[, k_scales, v_scales])``. Returns, per fault, the
    largest |faulty - plain| and its largest ratio to ``elem_bound``."""
    import torch

    from agentfield_tpu_torch.ops.kv_quant import bits

    q, kn, vn = case[:3]
    desc = case[5:10]
    pools = list(case[3:5]) + list(case[10:])  # K, V values (then scales)
    tables, ctx = desc[0], desc[3]
    ps = case[3].shape[2]
    out = {}
    t, c = tables.cpu(), ctx.cpu()
    dead = torch.tensor(sorted({int(t[r, p]) for r in range(t.shape[0])
                                for p in range(0, -(-int(c[r]) // ps), 4)}), device=q.device)
    bad = [x.clone() for x in pools]
    for x in bad:
        bits(x)[dead] = 0
    o_f = attn(q, kn, vn, bad[0], bad[1], *desc, *bad[2:], window=window)[0]
    out["quarter_pages_zeroed"] = compare(o_f, o_r, dname)[1:]
    fresh = [x.clone() for x in pools]
    o_f = attn(q, torch.zeros_like(kn), torch.zeros_like(vn), fresh[0], fresh[1], *desc,
               *fresh[2:], window=window)[0]
    out["own_kv_zeroed"] = compare(o_f, o_r, dname)[1:]
    return out


def dequantized_ref(case, window):
    """The plain version with the quantized kernel's semantics: cached pages
    dequantized to float32 (value * slot scale), the launch's own K/V
    unquantized. ``case`` as in ``fault_check``, with scales; its pools are
    not touched."""
    from agentfield_tpu_torch.ops.kv_quant import kv_dequantize
    from agentfield_tpu_torch.ops.paged_attention import ragged_paged_attention_ref

    q, kn, vn, kp, vp = case[:5]
    ks, vs = case[10:12]
    return ragged_paged_attention_ref(q, kn, vn, kv_dequantize(kp, ks), kv_dequantize(vp, vs),
                                      *case[5:10], window=window)[0]


def pools_bit_equal(a, b) -> bool:
    """Every pool tensor of ``a`` (values, scales) equals ``b``'s byte for
    byte outside the garbage page 0."""
    import torch

    return all(torch.equal(x[1:].view(torch.uint8), y[1:].view(torch.uint8))
               for x, y in zip(a, b))


def phase_check(results):
    import numpy as np
    import torch

    from agentfield_tpu_torch.models.llama import attention_ref
    from agentfield_tpu_torch.ops.cuda.ragged_paged_attention import (
        LAUNCHES,
        PATH_LAUNCHES,
        dense_causal_attention,
        ragged_paged_attention_cuda,
    )
    from agentfield_tpu_torch.ops.kernel_shapes import build_case
    from agentfield_tpu_torch.ops.paged_attention import ragged_paged_attention_ref

    dev = torch.device("cuda")
    rows = results.setdefault("shapes", {})
    failures = []
    for name, p in ragged_shapes().items():
        window = p.pop("window", None)
        case_np = build_case(name, params=p, seed=0)
        for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            case = [_to(a, dtype, dev) for a in case_np]
            q, kn, vn, kp, vp = case[:5]
            desc = case[5:]
            kp_r, vp_r = kp.clone(), vp.clone()
            kp_k, vp_k = kp.clone(), vp.clone()
            o_r, _, _ = ragged_paged_attention_ref(q, kn, vn, kp_r, vp_r, *desc, window=window)
            o_k, _, _ = ragged_paged_attention_cuda(q, kn, vn, kp_k, vp_k, *desc, window=window)
            torch.cuda.synchronize()
            within, err, ratio = compare(o_k, o_r, dname)
            pools_ok = bool(torch.equal(kp_k[1:], kp_r[1:]) and torch.equal(vp_k[1:], vp_r[1:]))
            ok = within and pools_ok
            row = {"kernel": "ragged_paged_attention", "dtype": dname, "max_abs_err": err,
                   "max_err_over_bound": ratio, "max_abs_out": float(o_r.float().abs().max()),
                   "pools_bit_equal": pools_ok, "ok": ok,
                   "R": q.shape[0], "W": q.shape[1], "H": q.shape[2], "Kh": kn.shape[2],
                   "hd": q.shape[3], "window": window}
            if name in FAULT_SHAPES:
                row["faults"] = fault_check(case, dname, o_r, window,
                                            ragged_paged_attention_cuda)
                torch.cuda.synchronize()
                if not all(ratio > 1.0 for _, ratio in row["faults"].values()):
                    failures.append(f"{name}/{dname}: bound missed a fault {row['faults']}")
                log(f"[check] {name} {dname} faulty kernel (max |d|, max |d|/bound): "
                    f"{row['faults']}")
            b, f = ragged_work(case_np, q.element_size(), window)
            row["bound_ms"], row["bound_by"] = bound_ms(b, f, dname)

            def call():
                return ragged_paged_attention_cuda(q, kn, vn, kp_k, vp_k, *desc, window=window)

            row["ms"], row["call_ms"] = graph_ms(call), cuda_ms(call)
            row["plain_ms"] = cuda_ms(lambda: ragged_paged_attention_ref(
                q, kn, vn, kp_r, vp_r, *desc, window=window), n=5, warmup=1)
            row["library_ms"] = None
            row["sdpa_gathered_ms"] = _sdpa_gathered_ms(q, kp, vp, *desc, window=window)
            rows[f"{name}/{dname}"] = row
            log(f"[check] {name:32s} {dname:8s} err={err:.2e} err/bound={ratio:.3f} "
                f"pools={pools_ok} ms={row['ms']:.4f} call={row['call_ms']:.4f} "
                f"plain={row['plain_ms']:.4f} sdpa(gathered)={row['sdpa_gathered_ms']} "
                f"bound={row['bound_ms']:.4f} ({row['bound_by']})")
            if not ok:
                failures.append(f"{name}/{dname}")
            del case, q, kn, vn, kp, vp, kp_r, vp_r, kp_k, vp_k, o_r, o_k
        torch.cuda.empty_cache()

    # dense causal attention (the batched-prefill path) vs its plain version,
    # the model's attention_ref over per-row arange positions
    rng = np.random.default_rng(0)
    for B, S, H, Kh, hd, window in dense_shapes():
        pos = torch.arange(S, device=dev).expand(B, S)
        valid = torch.ones((B, S), dtype=torch.bool, device=dev)
        for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            q = _to((rng.standard_normal((B, S, H, hd)) * 0.3).astype(np.float32), dtype, dev)
            k = _to((rng.standard_normal((B, S, Kh, hd)) * 0.3).astype(np.float32), dtype, dev)
            v = _to((rng.standard_normal((B, S, Kh, hd)) * 0.3).astype(np.float32), dtype, dev)
            o_r = attention_ref(q, k, v, pos, pos, valid, window=window)
            o_k = dense_causal_attention(q, k, v, window=window)
            torch.cuda.synchronize()
            ok, err, ratio = compare(o_k, o_r, dname)
            row = {"kernel": "dense_causal_attention", "dtype": dname, "max_abs_err": err,
                   "max_err_over_bound": ratio, "max_abs_out": float(o_r.float().abs().max()),
                   "ok": ok, "B": B, "S": S, "H": H, "Kh": Kh, "hd": hd, "window": window}
            es = q.element_size()
            b = es * B * S * (2 * H + 2 * Kh) * hd
            keys = sum(min(i + 1, window or S) for i in range(S))  # attended per query row
            f = 4 * B * H * hd * keys
            row["bound_ms"], row["bound_by"] = bound_ms(b, f, dname)

            def call():
                return dense_causal_attention(q, k, v, window=window)

            row["ms"], row["call_ms"] = graph_ms(call), cuda_ms(call)
            row["plain_ms"] = cuda_ms(lambda: attention_ref(q, k, v, pos, pos, valid,
                                                            window=window), n=5, warmup=1)
            row["library_ms"] = _sdpa_ms(q, k, v, window)
            name = f"dense_B{B}_S{S}_H{H}_Kh{Kh}_hd{hd}" + (f"_w{window}" if window else "")
            rows[f"{name}/{dname}"] = row
            log(f"[check] {name:32s} {dname:8s} err={err:.2e} err/bound={ratio:.3f} "
                f"ms={row['ms']:.4f} call={row['call_ms']:.4f} plain={row['plain_ms']:.4f} "
                f"sdpa={row['library_ms']} bound={row['bound_ms']:.4f} ({row['bound_by']})")
            if not ok:
                failures.append(f"{name}/{dname}")
    failures += _check_quant(rows)
    failures += _check_w8_graph(rows)
    failures += _check_w8(rows)
    results["check_launches"] = dict(LAUNCHES)
    results["check_path_launches"] = dict(PATH_LAUNCHES)
    if failures:
        raise AssertionError(f"kernel disagrees with its plain version: {failures}")


def _check_quant(rows) -> list[str]:
    """The quantized variant at every shape of ``quant_shapes``, in float32
    and bfloat16 compute: checks (a), (b), (c) of the module docstring, the
    two faults at the 2k-context decode shape, and times. Returns the
    failures."""
    import torch

    from agentfield_tpu_torch.ops.cuda.ragged_paged_attention import ragged_paged_attention_cuda
    from agentfield_tpu_torch.ops.kernel_shapes import PARITY_TOL, build_case
    from agentfield_tpu_torch.ops.kv_quant import kv_dequantize
    from agentfield_tpu_torch.ops.paged_attention import ragged_paged_attention_ref

    dev = torch.device("cuda")
    failures = []
    for name, p in quant_shapes().items():
        window = p.pop("window", None)
        mode = p["kv_dtype"]
        case_cpu = build_case(name, params=p, seed=0)
        for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            case = [a.to(dev) if isinstance(a, torch.Tensor) else _to(a, dtype, dev)
                    for a in case_cpu]
            q, kn, vn = case[:3]
            desc = case[5:10]
            pools = case[3:5] + case[10:12]  # k, v values; k, v scales
            pr = [t.clone() for t in pools]
            pk = [t.clone() for t in pools]
            o_r = ragged_paged_attention_ref(q, kn, vn, pr[0], pr[1], *desc, *pr[2:],
                                             window=window)[0]
            o_k = ragged_paged_attention_cuda(q, kn, vn, pk[0], pk[1], *desc, *pk[2:],
                                              window=window)[0]
            o_d = dequantized_ref(case, window)
            torch.cuda.synchronize()
            pools_ok = pools_bit_equal(pk, pr)  # (a)
            within, err, ratio = compare(o_k, o_d, dname)  # (b)
            parity = float((o_k.float() - o_r.float()).abs().max())  # (c)
            parity_ok = parity <= PARITY_TOL[mode]
            ok = pools_ok and within and parity_ok
            kernel = f"ragged_paged_attention_{mode}"
            row = {"kernel": kernel, "dtype": dname, "kv_dtype": mode, "max_abs_err": err,
                   "max_err_over_bound": ratio, "max_abs_out": float(o_d.float().abs().max()),
                   "pools_bit_equal": pools_ok, "parity_err": parity,
                   "parity_over_tol": parity / PARITY_TOL[mode], "ok": ok,
                   "R": q.shape[0], "W": q.shape[1], "H": q.shape[2], "Kh": kn.shape[2],
                   "hd": q.shape[3], "window": window}
            if name in tuple(f"{f}_{mode}" for f in FAULT_SHAPES):
                row["faults"] = fault_check(case, dname, o_d, window, ragged_paged_attention_cuda)
                torch.cuda.synchronize()
                if not all(r > 1.0 for _, r in row["faults"].values()):
                    failures.append(f"{name}/{dname}: bound missed a fault {row['faults']}")
                log(f"[check] {name} {dname} faulty kernel (max |d|, max |d|/bound): "
                    f"{row['faults']}")
            b, f = ragged_work(case_cpu, q.element_size(), window, pool_es=1)
            row["bound_ms"], row["bound_by"] = bound_ms(b, f, dname)
            def call():
                return ragged_paged_attention_cuda(q, kn, vn, pk[0], pk[1], *desc, *pk[2:],
                                                   window=window)

            row["ms"], row["call_ms"] = graph_ms(call), cuda_ms(call)
            row["plain_ms"] = cuda_ms(lambda: ragged_paged_attention_ref(
                q, kn, vn, pr[0], pr[1], *desc, *pr[2:], window=window), n=5, warmup=1)
            row["library_ms"] = None
            row["sdpa_gathered_ms"] = _sdpa_gathered_ms(
                q, kv_dequantize(pools[0], pools[2]).to(q.dtype),
                kv_dequantize(pools[1], pools[3]).to(q.dtype), *desc, window=window)
            rows[f"{name}/{dname}"] = row
            log(f"[check] {name:32s} {dname:8s} (b) err={err:.2e} err/bound={ratio:.3f} "
                f"(a) pools={pools_ok} (c) parity={parity:.2e} /tol={row['parity_over_tol']:.3f} "
                f"ms={row['ms']:.4f} call={row['call_ms']:.4f} plain={row['plain_ms']:.4f} "
                f"sdpa(gathered)={row['sdpa_gathered_ms']} "
                f"bound={row['bound_ms']:.4f} ({row['bound_by']})")
            if not ok:
                failures.append(f"{name}/{dname}")
            del case, q, kn, vn, pools, pr, pk, o_r, o_k, o_d
        torch.cuda.empty_cache()
    return failures


def w8_shapes() -> dict:
    """name -> (M, K, N) of the int8-weight matmul checks."""
    out = {f"{name}_M{M}": (M, K, N) for name, (K, N) in W8_PROJECTIONS.items() for M in W8_M}
    for name, ((K, N), ms) in W8_EXTRA.items():
        out.update({f"{name}_M{M}": (M, K, N) for M in ms})
    return out


def w8_elem_bound(y_r, s_abs, K: int, dtype_name: str):
    """Per-element bound of |kernel - plain| for the int8-weight matmul: 2
    ulps of |y_r| in the output dtype plus ``W8_SUM_TERMS * K * 2^-24 *
    s_abs`` (``s_abs = (|x| @ |q|) * scale``, float32)."""
    return (elem_bound(y_r, dtype_name) - SUM_ORDER_ATOL
            + W8_SUM_TERMS * K * 2.0**-24 * s_abs)


def w8_compare(y_k, y_r, s_abs, K, dtype_name):
    """(within bound, max |kernel - plain|, max of |kernel - plain| / bound)."""
    import torch

    d = (y_k.float() - y_r.float()).abs()
    ratio = float((d / w8_elem_bound(y_r, s_abs, K, dtype_name)).max())
    return ratio <= 1.0 and bool(torch.isfinite(y_k.float()).all()), float(d.max()), ratio


def w8_library_ms(x, q, scale):
    """One PyTorch call computing the same function, where the card's torch
    has one: ``torch._weight_int8pack_mm(x, q^T, scale)`` (timed only; the
    port never calls it). None when it is missing or refuses CUDA."""
    import torch

    fn = getattr(torch, "_weight_int8pack_mm", None)
    if fn is None:
        return None
    w, sc = q.t().contiguous(), scale.to(x.dtype)
    try:
        fn(x, w, sc)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as e:
        log(f"[time] torch._weight_int8pack_mm unavailable on CUDA here: {type(e).__name__}")
        return None
    return cuda_ms(lambda: fn(x, w, sc), n=5, warmup=1)


def _check_w8_graph(rows) -> list[str]:
    """A split-K product captured into a CUDA graph at a decode width (wk/wv
    at M = 8, the first int8-weight products of the run) and replayed after
    eager products that split wider (every projection at M 64, 200 and 1920)
    and after fresh tensors took whatever memory those freed: the replay
    must match the plain version within ``w8_elem_bound`` and leave the
    fresh tensors untouched (a split product sums its partials in its
    cluster's shared memory: no memory outside y is written). Returns the
    failures."""
    import torch

    from agentfield_tpu_torch.models.quant import quantize_weight
    from agentfield_tpu_torch.ops.cuda.quant_matmul import int8_weight_matmul_cuda, plan

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    K, N = W8_PROJECTIONS["wk_wv"]
    qw = quantize_weight(torch.empty((K, N), device=dev).normal_(0.0, 0.02, generator=g))
    q = qw.logical()
    x = torch.empty((8, K), device=dev, dtype=torch.bfloat16).normal_(0.0, 1.0, generator=g)
    p = plan(8, K, N, torch.cuda.get_device_properties(dev).multi_processor_count)
    int8_weight_matmul_cuda(x, qw.q, qw.scale)  # eager first: sets up the device
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_g = int8_weight_matmul_cuda(x, qw.q, qw.scale)
    for name, (k, n) in W8_PROJECTIONS.items():
        w = quantize_weight(torch.empty((k, n), device=dev).normal_(0.0, 0.02, generator=g))
        for M in (64, 200, 1920):
            int8_weight_matmul_cuda(
                torch.empty((M, k), device=dev, dtype=torch.bfloat16).normal_(generator=g),
                w.q, w.scale)
        del w
    torch.cuda.synchronize()
    # tensors of the M = 8 product's partials' size, where freed memory goes
    fresh = [torch.full((p["splits"] * 8 * N,), 7.0, device=dev) for _ in range(8)]
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    y_r = (x.float() @ q.float()) * qw.scale
    s_abs = (x.float().abs() @ q.float().abs()) * qw.scale
    ok, err, ratio = w8_compare(y_g, y_r, s_abs, K, "bfloat16")
    untouched = all(bool((f == 7.0).all()) for f in fresh)
    rows["w8_graph_after_larger_products"] = {
        "kernel": "int8_weight_matmul", "dtype": "bfloat16", "M": 8, "K": K, "N": N, "plan": p,
        "max_abs_err": err, "max_err_over_bound": ratio, "fresh_tensors_untouched": untouched,
        "ok": ok and untouched}
    log(f"[check] w8 graph at wk_wv M = 8 replayed after wider products: err={err:.2e} "
        f"err/bound={ratio:.3f} fresh tensors untouched={untouched} plan={p}")
    del graph, fresh
    torch.cuda.empty_cache()
    return [] if ok and untouched else [
        f"w8 graph replay after wider products: err/bound {ratio}, untouched {untouched}"]


def _check_w8(rows) -> list[str]:
    """The int8-weight matmul at every ``w8_shapes`` shape, bf16 and f32 x,
    on the packed weight ``quantize_weight`` makes on the card: held against
    the plain version (``(x.float() @ q.float()) * scale`` on the card, q
    the logical layout) within ``w8_elem_bound``; at ``W8_FAULT_SHAPES`` the
    bound must reject a kernel fed q with one 64-row K tile zeroed and one
    fed one column's scale doubled (both made in the logical q, then
    packed); each row prints its plan; times (``ms`` replayed from a graph, ``call_ms``
    eager, the plain version, ``torch._weight_int8pack_mm`` where it runs on
    CUDA, and cuBLAS bf16 ``x @ w`` at the same shape as a yardstick only);
    and the memory rise of one w_gate call at M = 32 within y's bytes plus
    ``W8_MEMORY_SLACK``. Returns the failures."""
    import torch

    from agentfield_tpu_torch.models.quant import quantize_weight
    from agentfield_tpu_torch.ops.cuda import quant_matmul as qm
    from agentfield_tpu_torch.ops.cuda.quant_matmul import (
        int8_weight_matmul_cuda,
        pack_int8_weight,
        plan,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    failures = []
    weights = {}
    for name, (M, K, N) in w8_shapes().items():
        if (K, N) not in weights:
            weights.clear()
            torch.cuda.empty_cache()
            w = torch.empty((K, N), device=dev).normal_(0.0, 0.02, generator=g)
            qw = quantize_weight(w)
            weights[(K, N)] = (qw.q, qw.logical(), qw.scale, w.to(torch.bfloat16))
            del w
        qp, q, scale, w16 = weights[(K, N)]
        x32 = torch.empty((M, K), device=dev).normal_(0.0, 1.0, generator=g)
        p = plan(M, K, N, torch.cuda.get_device_properties(dev).multi_processor_count)
        for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            x = x32.to(dtype)
            y_r = (x.float() @ q.float()) * scale
            s_abs = (x.float().abs() @ q.float().abs()) * scale
            y_k = int8_weight_matmul_cuda(x, qp, scale)
            torch.cuda.synchronize()
            ok, err, ratio = w8_compare(y_k, y_r, s_abs, K, dname)
            row = {"kernel": "int8_weight_matmul", "dtype": dname, "M": M, "K": K, "N": N,
                   "plan": p, "max_abs_err": err, "max_err_over_bound": ratio,
                   "max_abs_out": float(y_r.abs().max()), "ok": ok}
            if name in W8_FAULT_SHAPES:
                bad_q = q.clone()
                k0 = K_TILE_ROWS * ((K // K_TILE_ROWS) // 2)
                bad_q[k0:k0 + K_TILE_ROWS] = 0
                bad_q = pack_int8_weight(bad_q)
                bad_s = scale.clone()
                col = int(y_r.abs().amax(0).argmax())
                bad_s[col] *= 2
                row["faults"] = {
                    "k_tile_skipped": w8_compare(int8_weight_matmul_cuda(x, bad_q, scale), y_r,
                                                 s_abs, K, dname)[1:],
                    "column_scale_2x": w8_compare(int8_weight_matmul_cuda(x, qp, bad_s), y_r,
                                                  s_abs, K, dname)[1:],
                }
                torch.cuda.synchronize()
                del bad_q, bad_s
                if not all(r > 1.0 for _, r in row["faults"].values()):
                    failures.append(f"{name}/{dname}: bound missed a fault {row['faults']}")
                log(f"[check] {name} {dname} faulty kernel (max |d|, max |d|/bound): "
                    f"{row['faults']}")
            es = x.element_size()
            row["bound_ms"], row["bound_by"] = bound_ms(
                K * N + 4 * N + es * (M * K + M * N), 2 * M * K * N, dname)
            row["ms"] = graph_ms(lambda: int8_weight_matmul_cuda(x, qp, scale))
            row["call_ms"] = cuda_ms(lambda: int8_weight_matmul_cuda(x, qp, scale))
            row["plain_ms"] = cuda_ms(lambda: (x.float() @ q.float()) * scale, n=5, warmup=1)
            row["library_ms"] = w8_library_ms(x, q, scale)
            row["cublas_bf16_ms"] = (cuda_ms(lambda: x @ w16) if dtype == torch.bfloat16
                                     else None)
            rows[f"w8_{name}/{dname}"] = row
            log(f"[check] w8 {name:22s} {dname:8s} err={err:.2e} err/bound={ratio:.3f} "
                f"ms={row['ms']:.4f} call={row['call_ms']:.4f} plain={row['plain_ms']:.4f} "
                f"int8pack={row['library_ms']} cublas_bf16={row['cublas_bf16_ms']} "
                f"bound={row['bound_ms']:.4f} ({row['bound_by']}) plan={p}")
            if not ok:
                failures.append(f"w8_{name}/{dname}")
            del x, y_r, s_abs, y_k
    del qp, q, scale, w16
    weights.clear()
    torch.cuda.empty_cache()
    # no widened copy of the weight: one w_gate product at M = 32 allocates
    # its output (and nothing near the 117 MB of a bf16 copy of q)
    K, N = W8_PROJECTIONS["wgate_wup"]
    w = torch.empty((K, N), device=dev).normal_(0.0, 0.02, generator=g)
    qw = quantize_weight(w)
    del w
    x = torch.empty((32, K), device=dev, dtype=torch.bfloat16).normal_(0.0, 1.0, generator=g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    y = int8_weight_matmul_cuda(x, qw.q, qw.scale)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    limit = y.numel() * y.element_size() + W8_MEMORY_SLACK
    rows["w8_memory_wgate_M32"] = {"kernel": "int8_weight_matmul", "dtype": "bfloat16",
                                   "rise_bytes": rise, "limit_bytes": limit,
                                   "bf16_weight_bytes": K * N * 2, "ok": rise <= limit,
                                   "plan": plan(32, K, N, qm._sms[y.device.index]),
                                   "workspace_bytes": 0}
    log(f"[check] w8 memory: one w_gate call at M = 32 raised the peak by {rise} bytes "
        f"(limit {limit}: y plus 1 MiB; a bf16 copy of q would be {K * N * 2}); the kernel "
        f"keeps no workspace (split partials meet in the cluster's shared memory)")
    if rise > limit:
        failures.append(f"w8 memory rise {rise} > {limit}")
    return failures


def _sdpa_ms(q, k, v, window=None):
    """One PyTorch call computing the same dense causal GQA attention:
    scaled_dot_product_attention on [B, H, S, hd] views, causal or, with a
    window, under the window's boolean mask (timed only; the port never
    calls it)."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kw = {"is_causal": True}
    if window:
        i = torch.arange(q.shape[1], device=q.device)
        kw = {"attn_mask": (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)}
    try:
        return cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **kw))
    except (TypeError, RuntimeError) as e:
        log(f"[time] sdpa unavailable here: {e!r}")
        return None


def _sdpa_gathered_ms(q, k_pages, v_pages, tables, starts, ntok, ctx, seqs, window=None):
    """Yardstick for a ragged launch, gather excluded: each row's page-table
    context gathered beforehand into contiguous ``[R, Kh, T, hd]`` K/V (not
    timed), then one scaled_dot_product_attention over it with the plain
    version's boolean mask (causal on absolute positions, padding rows and
    tokens, window) and GQA. It does not write the pool and is not the
    kernel's function; the port never calls it."""
    import torch
    import torch.nn.functional as F

    del ctx, seqs
    R, W, H, hd = q.shape
    _, Kh, ps, _ = k_pages.shape
    T = tables.shape[1] * ps
    t = tables.long()
    k = k_pages[t].permute(0, 2, 1, 3, 4).reshape(R, Kh, T, hd).contiguous()
    v = v_pages[t].permute(0, 2, 1, 3, 4).reshape(R, Kh, T, hd).contiguous()
    pos = starts.long()[:, None] + torch.arange(W, device=q.device)  # [R, W]
    kpos = torch.arange(T, device=q.device)
    keep = (kpos <= pos[..., None]) & (torch.arange(W, device=q.device) < ntok[:, None])[..., None]
    if window:
        keep = keep & (kpos > pos[..., None] - window)
    qt = q.transpose(1, 2)
    try:
        return cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, k, v, attn_mask=keep[:, None], enable_gqa=True))
    except (TypeError, RuntimeError) as e:
        log(f"[time] sdpa unavailable here: {e!r}")
        return None


def _post(port: int, payload: dict, timeout: float = 900.0) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/reasoners/generate",
        data=json.dumps({"input": payload}).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


# the serve's constrained request: a bounded schema (booleans and an enum),
# so even random weights complete a value inside the token budget
SERVE_SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"},
                                                 "mode": {"enum": ["fast", "slow"]}},
                "required": ["ok", "mode"]}


def grammar_accepts(g, tokens) -> bool:
    """Does the token-level grammar ``g`` accept ``tokens`` (a complete
    value)?"""
    s = g.start
    for t in tokens:
        s = int(g.trans[s, t])
        if s < 0:
            return False
    return bool(g.accept[s])


def w8_launches_per_step(cfg) -> int:
    """int8-weight launches of one decode step: wq, wk, wv, wo and the
    gated FFN's three products a layer, the FFN once per expert for a MoE
    config (soft routing: 4 + 3 E a layer, 28 L for Mixtral)."""
    return (4 + 3 * max(cfg.num_experts, 1)) * cfg.num_layers


def phase_serve(results, state, seed: int, model="llama-3-8b", device="cuda", ecfg=None,
                lengths=(64, 200, 333, 480, 512, 700, 1100, 1500), max_new=32,
                kv_quant="none", weight_quant=None, node=None, label=None):
    """Serve the requests: the prompts of ``lengths`` (greedy), one sampled
    request (temperature 0.8, top-p 0.9), one ``response_schema`` request
    (``SERVE_SCHEMA``), then a second session turn. With ``kv_quant``
    "int8" | "fp8" the node reuses the weights and the engine geometry of
    the plain serve before it (``state``) and the results go to
    ``results["serve_<mode>"]``. With ``weight_quant="int8"`` the node is
    built with ``build_model_node(quant="int8")`` from ``state``'s weights
    and geometry (the quantized tree goes to ``state["w8_params"]``, the
    results to ``results["serve_w8"]``): every projection of every path
    goes through the int8-weight kernel, ``7 * L`` launches in each decode
    step's graph, each step counted. The engine runs the JAX node's decode
    tick: pipelined, decode buckets (4, 16), the step replayed from CUDA
    graphs. ``node`` serves an already built ``(server, backend)`` (with
    ``weight_quant``: int8 weights, ``w8_launches_per_step`` launches a
    decode step) and ``label`` names its results ``serve_<label>``."""
    import dataclasses

    import numpy as np
    import torch

    from agentfield_tpu_torch.ops.cuda import ragged_paged_attention as rpa
    from agentfield_tpu_torch.serving.engine import EngineConfig
    from agentfield_tpu_torch.serving.grammar import match_bytes
    from agentfield_tpu_torch.serving.model_node import GRAMMAR_SLOTS, build_model_node

    on_card = torch.device(device).type == "cuda"
    gc.collect()  # an earlier serve's engine (and its KV pool) is garbage now
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    label = label or ("w8" if weight_quant else kv_quant)
    if node is not None:
        params = None
    elif weight_quant:  # the bf16 serve's weights and geometry, bf16 pages
        ecfg = dataclasses.replace(state["ecfg"], kv_quant_dtype="none")
        params = state["params"]
    elif kv_quant == "none":
        if ecfg is None:
            # context 128 pages x 16 = 2048 tokens; 4096 pages = 8 GiB of bf16
            # KV; the decode buckets of the JAX engine's docstring example
            ecfg = EngineConfig(max_batch=32, page_size=16, num_pages=4096, max_pages_per_seq=128,
                                decode_buckets=(4, 16), grammar_slots=GRAMMAR_SLOTS)
        params = None
    else:
        ecfg = dataclasses.replace(state["ecfg"], kv_quant_dtype=kv_quant)
        params = state["params"]
    if node is None:
        server, backend = build_model_node(model, seed=seed, ecfg=ecfg, device=device,
                                           params=params, quant=weight_quant)
    else:
        server, backend = node
        ecfg = backend.engine.ecfg
    if on_card:
        torch.cuda.synchronize()
        log(f"[serve {label}] {model} node built in {time.perf_counter() - t0:.1f} s; "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated (weights + KV pool)")
    eng = backend.engine
    if weight_quant:
        state["w8_params"] = eng.params
    else:
        state["params"], state["cfg"], state["ecfg"] = eng.params, eng.cfg, ecfg

    # per-path launch tallies: wrap the engine's three device paths
    tally = {"decode": {}, "dense_prefill": {}, "suffix_prefill": {}}

    def wrap(path, attr):
        orig = getattr(eng, attr)

        def counted(*a, **k):
            before = rpa.launch_counts()
            try:
                return orig(*a, **k)
            finally:
                for key, n in rpa.launch_counts().items():
                    tally[path][key] = tally[path].get(key, 0) + n - before[key]

        setattr(eng, attr, counted)

    wrap("decode", "_dispatch_decode")
    wrap("dense_prefill", "_dense_prefill")
    wrap("suffix_prefill", "_suffix_prefill")
    mixed_decode_ticks = count_mixed_decode_ticks(eng)

    V = eng.cfg.vocab_size
    rng = np.random.default_rng(seed)
    lengths = list(lengths)
    prompts = [rng.integers(1, V, n).tolist() for n in lengths]
    payloads = [{"tokens": p, "max_new_tokens": max_new, "session_id": "sess-0" if i == 0 else None}
                for i, p in enumerate(prompts)]
    i_sampled, i_schema = len(payloads), len(payloads) + 1
    payloads.append({"tokens": rng.integers(1, V, 300).tolist(), "max_new_tokens": max_new,
                     "temperature": 0.8, "top_p": 0.9})
    payloads.append({"prompt": "Reply with a JSON object.", "max_new_tokens": 64,
                     "response_schema": SERVE_SCHEMA})
    port = server.start()
    answers: dict[int, dict] = {}
    errors: list[str] = []
    try:
        rpa.reset_launches()  # count only the main path from here

        def send(i):
            try:
                answers[i] = _post(port, payloads[i])
            except Exception as e:  # noqa: BLE001 — collected and failed below
                errors.append(f"request {i}: {e!r}")

        t1 = time.perf_counter()
        threads = [threading.Thread(target=send, args=(i,)) for i in range(len(payloads))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        burst_s = time.perf_counter() - t1
        if errors:
            raise AssertionError(f"requests failed: {errors}")
        # second turn on the session: prompt = turn 1 + its answer + new text
        first = answers[0]["result"]["tokens"]
        turn2 = prompts[0] + first + rng.integers(1, V, 50).tolist()
        t2 = time.perf_counter()
        second = _post(port, {"tokens": turn2, "max_new_tokens": max_new, "session_id": "sess-0"})
        turn2_s = time.perf_counter() - t2
        health = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=60).read())
    finally:
        server.stop()
    launches = dict(rpa.LAUNCHES)
    path_launches = dict(rpa.PATH_LAUNCHES)
    w8_launches = {k: n for k, n in rpa.launch_counts().items() if k not in launches
                   and k not in path_launches}
    for i in range(len(payloads)):
        res = answers[i]["result"]
        if i != i_schema:
            assert len(res["tokens"]) == max_new and res["finish_reason"] == "length", (
                i, res["finish_reason"])
        assert all(0 <= t < V for t in res["tokens"])
        assert all(np.isfinite(lp) for lp in res["logprobs"])
    # the constrained answer: a complete value of the schema, then the stop id
    schema_res = answers[i_schema]["result"]
    g = backend._grammar_for(SERVE_SCHEMA)
    token_bytes = backend.tokenizer.token_bytes(V)  # the byte tokenizer: id b is byte b
    body = b"".join(token_bytes[t] for t in schema_res["tokens"])
    assert schema_res["finish_reason"] == "stop", schema_res
    assert grammar_accepts(g, schema_res["tokens"]), body
    json.loads(body.decode())
    res2 = second["result"]
    assert len(res2["tokens"]) == max_new and all(np.isfinite(lp) for lp in res2["logprobs"])
    assert health["status"] == "ok"
    st = eng.stats
    assert st["prefix_cache_hits"] >= 1, "the second turn did not hit its session"
    graphs = eng.graph_stats()
    if on_card:  # every decode step after a key's first use replays its graph
        assert graphs["graphs_captured"] > 0 and sum(graphs["replays"].values()) > 0, graphs
        check_step_identity(eng, mixed_decode_ticks)
        assert any(k.endswith("/grammar") for k in graphs["replays"]), graphs
        assert any("/truncated/" in k for k in graphs["replays"]), graphs
    log(f"[serve {label}] launches {launches}; kernel paths {path_launches}; int8-weight "
        f"matmul {w8_launches}; by engine path {tally}")
    w8_per_step = w8_launches_per_step(eng.cfg)
    if weight_quant and on_card:
        # every path through the int8-weight kernel; each decode step's graph
        # holds 7 L of its launches, and each step (an eager first use, or a
        # replay) counted them
        for path in ("decode", "dense_prefill", "suffix_prefill"):
            assert tally[path].get("int8_weight_matmul", 0) > 0, f"no int8 matmul on {path}"
        for key, (_, counted) in eng._graphs.graphs.items():
            assert counted["int8_weight_matmul"] == w8_per_step, (key, counted)
        steps = graphs["graphs_captured"] + sum(graphs["replays"].values())
        assert tally["decode"]["int8_weight_matmul"] == w8_per_step * steps, (
            tally["decode"], steps)
    elif not weight_quant:
        assert w8_launches["int8_weight_matmul"] == 0, "the int8 matmul ran on fp weights"
    ragged = "ragged_paged_attention" + ("" if kv_quant == "none" else f"_{kv_quant}")
    if on_card:  # CPU tensors take the plain versions: nothing is launched
        for path, key in (("decode", ragged),
                          ("dense_prefill", "dense_causal_attention"),
                          ("suffix_prefill", ragged)):
            n = tally[path].get(key, 0)
            assert n > 0, f"{key} was not launched on the {path} path"
        for key, n in launches.items():
            if key in (ragged, "dense_causal_attention"):
                assert n > 0, f"{key} was never launched on the main path"
            else:  # another pool kind's variant: never on this path
                assert n == 0, f"{key} was launched {n} times serving kv_quant_dtype={kv_quant}"
        # kernel paths: decode through the split-context kernel and its combine,
        # both prefills through the tensor-core tile, never the f32 tile
        for path, keys in (("decode", ("ragged_decode_split", "ragged_decode_combine")),
                           ("dense_prefill", ("ragged_tiles_tc",)),
                           ("suffix_prefill", ("ragged_tiles_tc",))):
            for key in keys:
                assert tally[path].get(key, 0) > 0, f"{key} was not launched on the {path} path"
        assert path_launches["ragged_tiles_f32"] == 0, "the f32 tile ran in a bf16 serve"
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
    if kv_quant != "none" and not weight_quant:
        assert st["kv_quant_pages_total"] > 0, "no quantized page was allocated"
        if on_card:
            assert peak < results["serve"]["peak_mem_gib"], (
                f"{kv_quant} serve peaked at {peak:.2f} GiB, not below the bf16 serve's "
                f"{results['serve']['peak_mem_gib']:.2f} GiB")
    ttft = sorted(eng.ttft_ms)
    out = {
        "requests": len(payloads) + 1,
        "prompt_lengths": lengths,
        "burst_wall_s": burst_s,
        "turn2_wall_s": turn2_s,
        "ttft_ms_p50": statistics.median(ttft),
        "ttft_ms_max": ttft[-1],
        "decode_tokens": st["decode_tokens"],
        "decode_s": eng.timing["decode_s"],
        "decode_tok_per_s": st["decode_tokens"] / eng.timing["decode_s"],
        "decode_steps": st["decode_steps"],
        "decode_step_device_ms_mean": (statistics.fmean(eng.decode_step_ms)
                                       if eng.decode_step_ms else None),
        "decode_step_replays_timed": len(eng.decode_step_ms),
        "graphs": graphs,
        "sampled_tokens": answers[i_sampled]["result"]["tokens"],
        "greedy_tokens": [answers[i]["result"]["tokens"] for i in range(len(lengths))],
        "schema_text": body.decode(),
        "prefill_tokens": st["prefill_tokens"],
        "prefill_s": eng.timing["prefill_s"],
        "prefix_cache_hits": st["prefix_cache_hits"],
        "prefix_tokens_reused": st["prefix_tokens_reused"],
        "peak_mem_gib": peak,
        "kv_quant_dtype": kv_quant,
        "kv_pool_gib": eng.cache.hbm_bytes() / 2**30,
        "kv_quant_pages_total": st["kv_quant_pages_total"],
        "kv_quant_bytes_saved_total": st["kv_quant_bytes_saved_total"],
        "launches": launches,
        "path_launches": path_launches,
        "w8_launches": w8_launches,
        "launches_by_path": tally,
    }
    if weight_quant:
        out["w8_launches_per_decode_step"] = w8_per_step
    results["serve" if label == "none" else f"serve_{label}"] = out
    log(f"[serve {label}] {out['requests']} requests answered; TTFT p50 "
        f"{out['ttft_ms_p50']:.1f} ms, decode {out['decode_tok_per_s']:.1f} tok/s over "
        f"{out['decode_steps']} steps, decode step {out['decode_step_device_ms_mean']} device ms "
        f"(mean of {out['decode_step_replays_timed']} replays), peak {out['peak_mem_gib']} GiB, "
        f"KV pool {out['kv_pool_gib']:.2f} GiB; graphs {graphs['graphs_captured']} captured in "
        f"{graphs['capture_s']:.2f} s, replays {graphs['replays']}; schema answer "
        f"{out['schema_text']!r}")


def phase_forward(results, state, seed: int, key: str = "forward", S: int = 512,
                  bf16_noise_factor: float = 1.0):
    """One full-width forward of ``state``'s model with the kernel and with
    the plain attention, compared on logits (``results[key]``). The bf16
    logits are held within ``bf16_noise_factor`` times the plain path's own
    bf16-vs-float32 distance (see the bounds below)."""
    import torch

    from agentfield_tpu_torch.models import llama

    gc.collect()  # the serve phase's engine (and its KV pool) is garbage now
    params, cfg = state["params"], state["cfg"]
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (1, S), device="cuda", generator=g)
    pos = torch.arange(S, device="cuda")[None]

    def both(p):
        with torch.no_grad():
            lk, _ = llama.forward(p, cfg, tokens, pos, attn_impl="kernel", collect_kv=False)
            lr, _ = llama.forward(p, cfg, tokens, pos, attn_impl="ref", collect_kv=False)
        torch.cuda.synchronize()
        assert lk.shape == (1, S, cfg.vocab_size) and bool(torch.isfinite(lk).all())
        return lk, lr

    lk16, lr16 = both(params)
    # the same weights widened to float32 (32 GB): there the two attentions
    # differ only by float32 summation order
    p32 = {k: ({n: t.float() for n, t in v.items()} if isinstance(v, dict) else v.float())
           for k, v in params.items()}
    lk32, lr32 = both(p32)
    del p32
    torch.cuda.empty_cache()
    err16 = float((lk16 - lr16).abs().max())
    err32 = float((lk32 - lr32).abs().max())
    # bf16 rounding of the whole forward, measured on the plain path alone
    noise16 = float((lr16 - lr32).abs().max())
    kernel16_to_f32 = float((lk16 - lr32).abs().max())
    scale = float(lr32.abs().max())
    agree = float((lk16.argmax(-1) == lr16.argmax(-1)).float().mean())
    # Bounds. float32: 1e-4 of max |logit| — the kernel and the plain
    # version sum in another order (~1e-7 relative per op) and 32 random
    # layers amplify that by far less than 1e3. bfloat16: the two attentions
    # round to bf16 at different elements (each within 1 ulp), and 32
    # random-weight layers amplify such rounding steps; the kernel's bf16
    # logits must lie no farther from the plain bf16 logits than the plain
    # bf16 logits lie from the float32 ones, i.e. within the forward's own
    # bf16 rounding noise. The attention faults this cannot see are held by
    # the element-wise check phase and by the float32 comparison.
    # A model of a few layers (the reduced-depth presets) has no shared
    # rounding of 32 layers to dominate: there each bf16 path lies about one
    # bf16 rounding distance from the float32 logits in a direction of its
    # own, so the two are held within twice that distance (the triangle
    # bound; factor 2). Llama-3-8B keeps factor 1.
    tol32 = 1e-4 * scale
    tol16 = bf16_noise_factor * noise16
    results[key] = {
        "S": S, "max_abs_logit": scale, "max_abs_err_f32": err32, "tol_f32": tol32,
        "max_abs_err_bf16": err16, "bf16_vs_f32_noise": noise16, "tol_bf16": tol16,
        "bf16_noise_factor": bf16_noise_factor,
        "kernel_bf16_vs_f32": kernel16_to_f32,
        "argmax_agreement_bf16": agree,
    }
    log(f"[{key}] full-width logits kernel vs plain: float32 max|d|={err32:.4e} "
        f"(tol {tol32:.4e}); bfloat16 max|d|={err16:.4e} (tol {tol16:.4e} = {bf16_noise_factor} x "
        f"the plain path's bf16-vs-f32 distance; the kernel's bf16 path is {kernel16_to_f32:.4e} from "
        f"f32); max|logit| {scale:.4e}; bf16 argmax agreement {agree:.3f}")
    assert err32 <= tol32, "full-width float32 forward: kernel and plain attention disagree"
    assert err16 <= tol16, "full-width bfloat16 forward: kernel and plain attention disagree"


# presets served at full width and reduced depth beside Llama-3-8B: their
# head dims (256, 96) have their own kernel instances
REDUCED_DEPTH_PRESETS = ("gemma-7b", "phi-3-mini")
REDUCED_LAYERS = 2


def phase_reduced_depth(results, preset: str, seed: int):
    """Serve ``preset`` at full width and ``REDUCED_LAYERS`` layers (random
    bf16 weights from ``seed``) through the engine with the JAX node's
    decode tick: a burst of requests, a prompt longer than the sliding
    window where the preset has one (chunked prefill over windowed pages),
    every decode launch through the split-context kernel; then its
    full-width forward, kernel against plain (``phase_forward``)."""
    import dataclasses

    import numpy as np
    import torch

    from agentfield_tpu_torch.models.configs import get_config
    from agentfield_tpu_torch.models.llama import init_params
    from agentfield_tpu_torch.ops.cuda import ragged_paged_attention as rpa
    from agentfield_tpu_torch.serving.engine import EngineConfig, InferenceEngine, Request
    from agentfield_tpu_torch.serving.sampler import SamplingParams

    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    full = get_config(preset)
    cfg = dataclasses.replace(full, num_layers=REDUCED_LAYERS)
    params = init_params(cfg, seed=seed, device="cuda")
    window = full.sliding_window
    ctx_pages = 160 if window else 64  # 2560 tokens: the window binds
    eng = InferenceEngine(params, cfg, EngineConfig(
        max_batch=8, page_size=16, num_pages=8 * ctx_pages + 1, max_pages_per_seq=ctx_pages,
        decode_buckets=(4,)), seed=seed, device="cuda")
    rng = np.random.default_rng(seed + 3)
    lengths = [40, 300, 700] + ([2200] if window else [900])
    reqs = [Request(f"{preset}-{i}", rng.integers(1, cfg.vocab_size, n).tolist(),
                    SamplingParams(max_new_tokens=16)) for i, n in enumerate(lengths)]
    reqs.append(Request(f"{preset}-sampled", rng.integers(1, cfg.vocab_size, 64).tolist(),
                        SamplingParams(max_new_tokens=16, temperature=0.8, top_p=0.9)))
    rpa.reset_launches()
    t0 = time.perf_counter()
    out = eng.run_to_completion(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in reqs:
        toks = out[r.id]
        assert len(toks) == 16 and all(0 <= t < cfg.vocab_size for t in toks), (r.id, toks)
    paths = dict(rpa.PATH_LAUNCHES)
    assert paths["ragged_decode_split"] > 0 and paths["ragged_decode_combine"] > 0, paths
    assert paths["ragged_tiles_tc"] > 0 and paths["ragged_tiles_f32"] == 0, paths
    graphs = eng.graph_stats()
    assert sum(graphs["replays"].values()) > 0, graphs
    assert graphs["graphs_captured"] + sum(graphs["replays"].values()) == eng.stats["decode_steps"]
    key = f"serve_{preset}"
    results[key] = {
        "layers": REDUCED_LAYERS, "reduced_from": full.num_layers, "hd": cfg.head_dim,
        "heads": [cfg.num_heads, cfg.num_kv_heads], "window": window, "prompt_lengths": lengths,
        "wall_s": wall, "decode_steps": eng.stats["decode_steps"],
        "decode_tokens": eng.stats["decode_tokens"], "path_launches": paths,
        "launches": dict(rpa.LAUNCHES), "graphs": graphs,
        "decode_step_device_ms_mean": (statistics.fmean(eng.decode_step_ms)
                                       if eng.decode_step_ms else None),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    log(f"[{key}] {cfg.num_layers} of {full.num_layers} layers at full width (hd {cfg.head_dim}, "
        f"H {cfg.num_heads}, Kh {cfg.num_kv_heads}, window {window}): {len(reqs)} requests "
        f"answered in {wall:.2f} s, {eng.stats['decode_steps']} decode steps, kernel paths "
        f"{paths}, graphs {graphs}")
    del eng
    phase_forward(results, {"params": params, "cfg": cfg}, seed, key=f"forward_{preset}",
                  S=2200 if window else 512, bf16_noise_factor=2.0)


def phase_graph(results, state, seed: int):
    """The decode step replayed from its CUDA graph against the eager step
    on the same chained state (Llama-3-8B weights of the serve): the
    replayed greedy step's tokens equal the argmax of the eager forward's
    logits, a graph of the forward alone gives the eager logits within the
    forward phase's bf16 bound, a replay adds the graph's launches to
    ``PATH_LAUNCHES``, and two replays of a sampling step from one state
    draw different tokens. Times the replayed step (device) and the eager
    step (CUDA events around the call, host work included)."""
    import numpy as np
    import torch

    from agentfield_tpu_torch.ops.cuda import ragged_paged_attention as rpa
    from agentfield_tpu_torch.serving.engine import EngineConfig, InferenceEngine, Request
    from agentfield_tpu_torch.serving.sampler import SamplingParams

    gc.collect()
    cfg = state["cfg"]
    eng = InferenceEngine(state["params"], cfg, EngineConfig(
        max_batch=8, page_size=16, num_pages=513, max_pages_per_seq=64), seed=seed, device="cuda")
    rng = np.random.default_rng(seed + 7)
    for i in range(6):
        eng.submit(Request(f"g{i}", rng.integers(1, cfg.vocab_size, 100 + 150 * i).tolist(),
                           SamplingParams(max_new_tokens=64)))
    while eng._inflight is None:  # admissions, then the first dispatch (its capture)
        eng.step()
    eng._harvest_inflight()
    st = eng._dev_state()
    toks0, lens0 = st.tokens.clone(), st.seq_lens.clone()
    active = lens0 > 0

    def restore():
        st.tokens.copy_(toks0)
        st.seq_lens.copy_(lens0)

    with torch.no_grad():
        logits_e = eng._decode_forward(st.tokens, st.seq_lens, st.page_tables)
        before = rpa.launch_counts()
        assert eng._graphs.run(st, "greedy", "free"), "the greedy step did not replay"
        after = rpa.launch_counts()
        toks_g = st.out_tokens[0].clone()
        restore()
        fwd = torch.cuda.CUDAGraph()
        with torch.cuda.graph(fwd, capture_error_mode="thread_local"):
            logits_static = eng._decode_forward(st.tokens, st.seq_lens, st.page_tables)
        fwd.replay()
        torch.cuda.synchronize()
        same_tokens = bool(torch.equal(toks_g[active], logits_e.argmax(-1).int()[active]))
        err = float((logits_static - logits_e)[active].abs().max())
        tol = results["forward"]["tol_bf16"]
        per_replay = after["ragged_decode_split"] - before["ragged_decode_split"]
        # device time of the replayed step against the eager step
        greedy_graph = eng._graphs.graphs[(st.width, "greedy", "free")][0]
        step_ms = graph_replay_ms(greedy_graph, restore)
        eager_ms = cuda_ms(lambda: (restore(), eng._decode_step(st, "greedy", False)), n=10)
        breakdown = profile_replays(greedy_graph, restore)
        # fresh draws: two replays of a sampling step from one state
        st.temps.fill_(1.0)
        restore()
        eng._graphs.run(st, "sampled", "free")  # first use: eager step, capture
        draws = []
        for _ in range(2):
            restore()
            assert eng._graphs.run(st, "sampled", "free")
            draws.append(st.out_tokens[0].clone())
        torch.cuda.synchronize()
    fresh = bool((draws[0] != draws[1])[active].any())
    results["graph"] = {
        "width": st.width, "live_rows": int(active.sum()), "same_greedy_tokens": same_tokens,
        "logits_max_abs_err": err, "tol_bf16": tol, "split_launches_per_replay": per_replay,
        "replayed_step_device_ms": step_ms, "eager_step_call_ms": eager_ms,
        "sampled_replays_differ": fresh, "step_breakdown": breakdown,
    }
    log(f"[graph] width {st.width}, {int(active.sum())} live: replayed greedy step tokens = eager "
        f"argmax: {same_tokens}; forward graph vs eager logits max|d| {err:.4e} (tol {tol:.4e}); "
        f"{per_replay} split launches counted per replay; step {step_ms:.3f} ms replayed (device) "
        f"vs {eager_ms:.3f} ms eager; two sampled replays differ: {fresh}")
    log(f"[graph] replayed step by kernel kind (torch.profiler, device ms a step): "
        f"{breakdown and breakdown['by_kind_ms']}; top kernels "
        f"{breakdown and breakdown['top_kernels_ms']}")
    assert same_tokens, "the replayed decode step disagrees with the eager forward"
    assert err <= tol, "the captured forward disagrees with the eager forward"
    assert per_replay == cfg.num_layers, "a replay did not count its kernel launches"
    assert fresh, "two replays of a sampling step repeated the same draws"


def count_mixed_decode_ticks(eng) -> dict:
    """Wrap ``eng._mixed_tick`` to count the mixed ticks that carried decode
    rows (each counts one decode step, outside the decode graphs) and, per
    request, the mixed ticks its prefill job lived through (before or after
    the tick: 2 or more means its prompt spanned several ticks). Returns the
    live tallies."""
    tally = {"with_decode": 0, "ticks": 0, "job_ticks": {}}
    orig = eng._mixed_tick

    def counted():
        before = {j.req.id for j in eng._prefill_jobs}
        active = eng.num_active
        out = orig()
        if out is not None:
            tally["ticks"] += 1
            tally["with_decode"] += active > 0
            for rid in before | {j.req.id for j in eng._prefill_jobs}:
                tally["job_ticks"][rid] = tally["job_ticks"].get(rid, 0) + 1
        return out

    eng._mixed_tick = counted
    return tally


def check_step_identity(eng, mixed: dict) -> None:
    """Every decode step is a graph capture, a replay, or a mixed tick with
    decode rows (decode_span 1 counts one step per dispatch)."""
    g = eng.graph_stats()
    steps = g["graphs_captured"] + sum(g["replays"].values()) + mixed["with_decode"]
    assert steps == eng.stats["decode_steps"] // eng.ecfg.decode_span, (
        g, mixed["with_decode"], eng.stats["decode_steps"])


# the burst phase: decodes in flight, then prompts of 300-1500 tokens (one
# past the 512-token budget), the last a response_schema request
BURST_DECODES = 8  # of prompts of 64-400 tokens, 160 new tokens each
BURST_PROMPTS = (520, 700, 900, 1200, 1500)
BURST_SCHEMA_PROMPT = 300
MIXED_BUDGET = 512


def phase_burst(results, state, seed: int, max_new: int = 32):
    """A prompt burst into in-flight decodes on the serve's full-width
    Llama-3-8B weights and geometry, through two engines one after the
    other: the classic tick and the mixed token-budget tick (budget 512).
    Both answer every request (the schema answer a value of
    ``SERVE_SCHEMA``) and return every page. The mixed engine runs mixed
    ticks, a chunk spans several of them, every mixed tick's attention goes
    through the split-context kernel and its combine, and captures +
    replays + mixed ticks with decode rows equal its decode steps. Then one
    mixed tick's decode-row logits are held against the classic step's on
    the same state within the forward phase's bf16 bound. Prints per engine
    the burst's TTFT p50/p99, ``scheduler_stats`` over the burst, the mixed
    tick's device ms and peak memory. The ITL and tokens-per-tick window
    runs from the burst's submission until every burst request has its
    first token and every decode its next token after that."""
    import numpy as np
    import torch

    from agentfield_tpu_torch.serving.grammar import compile_json_schema
    from agentfield_tpu_torch.serving.tokenizer import ByteTokenizer

    V = state["cfg"].vocab_size
    tok = ByteTokenizer(V)
    grammar = compile_json_schema(SERVE_SCHEMA, tok.token_bytes(V))
    rng = np.random.default_rng(seed + 11)
    # two rounds of fresh random prompts (no prefix hit between them): the
    # first warms the engine (decode graphs of every width it meets), the
    # second is measured
    rounds = [([rng.integers(1, V, int(n)).tolist() for n in rng.integers(64, 400, BURST_DECODES)],
               [rng.integers(1, V, n).tolist() for n in BURST_PROMPTS],
               rng.integers(1, V, BURST_SCHEMA_PROMPT).tolist()) for _ in range(2)]
    out = {}
    for mode in ("classic", "mixed"):
        gc.collect()  # the previous engine (and its KV pool) is garbage now
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out[mode] = _burst_engine(results, state, seed, mode, rounds, grammar, rng, max_new)
    results["burst"] = out


def _burst_engine(results, state, seed, mode, rounds, grammar, rng, max_new) -> dict:
    """One engine of ``phase_burst`` (``mode`` "classic" or "mixed") on bf16
    KV pages: every round of ``rounds`` run and checked, the last one
    measured; its printed row."""
    import dataclasses

    import torch

    from agentfield_tpu_torch.ops.cuda import ragged_paged_attention as rpa
    from agentfield_tpu_torch.serving.engine import InferenceEngine, Request
    from agentfield_tpu_torch.serving.grammar import match_bytes
    from agentfield_tpu_torch.serving.sampler import SamplingParams
    from agentfield_tpu_torch.serving.tokenizer import ByteTokenizer

    params, cfg = state["params"], state["cfg"]
    V = cfg.vocab_size
    tok = ByteTokenizer(V)
    ecfg = dataclasses.replace(state["ecfg"], kv_quant_dtype="none", mixed_step=mode == "mixed",
                               mixed_step_budget=MIXED_BUDGET)
    eng = InferenceEngine(params, cfg, ecfg, seed=seed, device="cuda")
    mixed = count_mixed_decode_ticks(eng)
    mixed_paths = {}
    orig_logits = eng._mixed_logits

    def tallied(*a, **k):
        before = rpa.launch_counts()
        try:
            return orig_logits(*a, **k)
        finally:
            for key, n in rpa.launch_counts().items():
                mixed_paths[key] = mixed_paths.get(key, 0) + n - before[key]

    eng._mixed_logits = tallied
    first: dict[str, float] = {}
    answers: dict[str, list] = {}
    finals: dict[str, str] = {}

    def run(until):
        while not until():
            for ev in eng.step():
                first.setdefault(ev.request_id, time.perf_counter())
                if ev.token >= 0 and ev.finish_reason != "stop":  # a stop id is no content
                    answers.setdefault(ev.request_id, []).append(ev.token)
                if ev.finished:
                    finals[ev.request_id] = ev.finish_reason

    for rnd, (decodes, burst, schema_prompt) in enumerate(rounds):
        dec = [f"r{rnd}dec{i}" for i in range(len(decodes))]
        for rid, p in zip(dec, decodes):
            eng.submit(Request(rid, p, SamplingParams(max_new_tokens=160)))
        run(lambda: all(d in first for d in dec) and eng.stats["decode_steps"] >= 8)
        with eng._telemetry_lock:  # scheduler_stats over the burst only
            eng._itl_window.clear()
            eng._tick_tokens.clear()
        eng.mixed_tick_ms.clear()
        eng.decode_step_ms.clear()
        rpa.reset_launches()
        mixed_paths.clear()
        base = {k: eng.stats[k] for k in ("mixed_ticks", "mixed_tokens", "decode_steps")}
        base["with_decode"] = mixed["with_decode"]
        t_sub = {}
        for i, p in enumerate(burst):
            t_sub[f"r{rnd}b{i}"] = time.perf_counter()
            eng.submit(Request(f"r{rnd}b{i}", p, SamplingParams(max_new_tokens=max_new)))
        schema = f"r{rnd}schema"
        t_sub[schema] = time.perf_counter()
        eng.submit(Request(schema, schema_prompt,
                           SamplingParams(max_new_tokens=64, stop_token_ids=(tok.eos_token_id,)),
                           grammar=grammar))
        t0 = time.perf_counter()
        run(lambda: all(r in first for r in t_sub))
        burst_ttft_s = time.perf_counter() - t0
        # a decode stalled behind the burst shows its gap once its next token comes
        marks = {d: len(answers[d]) for d in dec}
        run(lambda: all(len(answers[d]) > n for d, n in marks.items()))
        sched = eng.scheduler_stats()
        run(lambda: not eng.has_work())
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        paths = dict(rpa.PATH_LAUNCHES)
        for d in dec:
            assert len(answers[d]) == 160 and finals[d] == "length", d
        for i in range(len(burst)):
            assert len(answers[f"r{rnd}b{i}"]) == max_new and finals[f"r{rnd}b{i}"] == "length", i
        body = bytes(answers[schema])
        assert finals[schema] == "stop" and match_bytes(grammar.trans, grammar.accept, body), body
        assert all(0 <= t < V for a in answers.values() for t in a)
        assert eng.allocator.free_pages == ecfg.num_pages - 1, "pages did not balance"
    if eng.device.type == "cuda":  # steps of the CPU run are not replays
        check_step_identity(eng, mixed)
    ttft = sorted((first[r] - t_sub[r]) * 1e3 for r in t_sub)
    row = {
        "ttft_ms_p50": statistics.median(ttft), "ttft_ms_p99": ttft[-1],
        "ttft_ms": ttft, "burst_first_tokens_s": burst_ttft_s, "wall_s": wall,
        **sched,
        # the measured round's counts
        "mixed_ticks": eng.stats["mixed_ticks"] - base["mixed_ticks"],
        "mixed_tokens": eng.stats["mixed_tokens"] - base["mixed_tokens"],
        "mixed_ticks_with_decode": mixed["with_decode"] - base["with_decode"],
        "max_ticks_of_one_chunk": max(mixed["job_ticks"].values(), default=0),
        "mixed_tick_device_ms_mean": (statistics.fmean(eng.mixed_tick_ms)
                                      if eng.mixed_tick_ms else None),
        "mixed_tick_device_ms_max": max(eng.mixed_tick_ms, default=None),
        "decode_step_device_ms_mean": (statistics.fmean(eng.decode_step_ms)
                                       if eng.decode_step_ms else None),
        "decode_steps": eng.stats["decode_steps"] - base["decode_steps"],
        "graphs": eng.graph_stats(),
        "path_launches": paths, "mixed_tick_path_launches": mixed_paths,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "schema_text": body.decode(),
    }
    if mode == "mixed":
        assert row["mixed_ticks"] > 0, "the mixed engine ran no mixed tick"
        assert row["max_ticks_of_one_chunk"] >= 2, "no prompt spanned several mixed ticks"
        for key in ("ragged_decode_split", "ragged_decode_combine"):
            assert mixed_paths.get(key, 0) > 0, f"mixed ticks never launched {key}"
        assert mixed_paths.get("ragged_tiles_tc", 0) == 0 == mixed_paths.get(
            "ragged_tiles_f32", 0), mixed_paths
        row["logits_check"] = _mixed_vs_classic_logits(eng, rng, results["forward"]["tol_bf16"])
    else:
        assert row["mixed_ticks"] == 0
    log(f"[burst {mode}] {len(t_sub)} prompts into {BURST_DECODES} decodes: TTFT p50 "
        f"{row['ttft_ms_p50']:.1f} ms p99 {row['ttft_ms_p99']:.1f} ms; ITL p50 "
        f"{row['itl_ms_p50']} ms p99 {row['itl_ms_p99']} ms; tokens/tick "
        f"{row['tokens_per_tick']}; mixed ticks {row['mixed_ticks']} (with decode rows "
        f"{row['mixed_ticks_with_decode']}, longest chunk {row['max_ticks_of_one_chunk']} ticks), "
        f"mixed tick device ms mean {row['mixed_tick_device_ms_mean']} max "
        f"{row['mixed_tick_device_ms_max']}; decode step {row['decode_step_device_ms_mean']} "
        f"device ms; kernel paths {paths} (mixed ticks: {mixed_paths}); peak "
        f"{row['peak_mem_gib']:.2f} GiB; wall {wall:.2f} s")
    return row


def _mixed_vs_classic_logits(eng, rng, tol: float) -> dict:
    """On ``eng`` (Llama-3-8B, bf16): four live decode slots; their logits
    from the classic decode forward, then from a mixed tick's packed forward
    that also carries a 256-token chunk over fresh pages (W = 1 rows through
    the split-context kernel). Both write the same pending-token slots,
    which the next real step rewrites. Held within ``tol`` (the forward
    phase's bf16 bound); the engine then drains and its pages balance."""
    import numpy as np
    import torch

    from agentfield_tpu_torch.serving.engine import Request
    from agentfield_tpu_torch.serving.kv_cache import build_page_table, pack_ragged_rows
    from agentfield_tpu_torch.serving.sampler import SamplingParams

    V = eng.cfg.vocab_size
    for i in range(4):
        eng.submit(Request(f"lg{i}", rng.integers(1, V, 100 + 100 * i).tolist(),
                           SamplingParams(max_new_tokens=8)))
    while eng.num_active < 4 or eng.pending or eng._prefill_jobs:
        eng.step()
    eng._harvest_inflight()
    active = [i for i, s in enumerate(eng.slots) if s is not None]
    dev = eng.device
    with torch.no_grad():
        logits_c = eng._decode_forward(
            torch.from_numpy(eng.last_tokens[active].astype(np.int64)).to(dev),
            torch.from_numpy(eng.seq_lens[active].copy()).to(dev),
            torch.from_numpy(eng.page_tables[active].copy()).to(dev))
        maxp, ps = eng.ecfg.max_pages_per_seq, eng.ecfg.page_size
        with eng._session_lock:
            pages = eng.allocator.alloc(256 // ps)
        rows = [(eng.page_tables[i], int(eng.seq_lens[i]), [int(eng.last_tokens[i])])
                for i in active]
        rows.append((build_page_table(pages, maxp), 0, rng.integers(1, V, 256).tolist()))
        rr = pack_ragged_rows(rows, maxp, eng.ecfg.mixed_bucket(len(active) + 256))
        logits_m = eng._mixed_logits(rr, rr.last_flat[: len(active)])
        torch.cuda.synchronize()
    with eng._session_lock:
        eng.allocator.free(pages)
    err = float((logits_m.float() - logits_c.float()).abs().max())
    agree = float((logits_m.argmax(-1) == logits_c.argmax(-1)).float().mean())
    while eng.has_work():
        eng.step()
    assert eng.allocator.free_pages == eng.ecfg.num_pages - 1
    log(f"[burst mixed] decode-row logits, mixed tick ({rr.row_starts.shape[0]} W=1 rows) vs "
        f"classic step: max|d| {err:.4e} (tol {tol:.4e}), argmax agreement {agree:.3f}")
    assert err <= tol, "a mixed tick's decode rows disagree with the classic decode step"
    return {"rows": int(rr.row_starts.shape[0]), "max_abs_err": err, "tol_bf16": tol,
            "argmax_agreement": agree}


def phase_overload(results, state, seed: int):
    """Overload control on the card, Llama-3-8B weights, mixed ticks on:
    (1) preemption: a pool of 42 pages where a priority-1 rival starves
    behind a priority-0 victim; the victim is preempted, still produces all
    of its tokens, and every page returns; (2) a pending request whose 1 ms
    deadline passes while every slot is busy is shed with one
    ``deadline_exceeded`` terminal; (3) a cancel in the middle of a chunked
    prompt frees the job's pages."""
    import dataclasses

    import numpy as np
    import torch

    from agentfield_tpu_torch.serving.engine import EngineConfig, InferenceEngine, Request
    from agentfield_tpu_torch.serving.sampler import SamplingParams

    params, cfg = state["params"], state["cfg"]
    V = cfg.vocab_size
    rng = np.random.default_rng(seed + 13)
    gc.collect()
    torch.cuda.empty_cache()
    # victim: 300 + 64 tokens = 23 pages; rival: 300 + 16 = 20 pages. With
    # 42 usable pages the rival starves (19 free) until the victim parks.
    base = EngineConfig(max_batch=4, page_size=16, num_pages=43, max_pages_per_seq=32,
                        mixed_step=True, mixed_step_budget=MIXED_BUDGET, preempt_fence_ticks=2)
    out = {}

    def drain(eng):
        evs = []
        while eng.has_work():
            evs += eng.step()
        return evs

    eng = InferenceEngine(params, cfg, base, seed=seed, device="cuda")
    evs = []
    eng.submit(Request("victim", rng.integers(1, V, 300).tolist(), SamplingParams(max_new_tokens=64)))
    for _ in range(4):
        evs += eng.step()
    eng.submit(Request("rival", rng.integers(1, V, 300).tolist(),
                       SamplingParams(max_new_tokens=16), priority=1))
    evs += drain(eng)
    got = {r: [e for e in evs if e.request_id == r] for r in ("victim", "rival")}
    out["preempt"] = {
        "preemptions_total": eng.stats["preemptions_total"],
        "resume_prefix_hits_total": eng.stats["resume_prefix_hits_total"],
        "victim_tokens": len(got["victim"]), "rival_tokens": len(got["rival"]),
        "free_pages": eng.allocator.free_pages,
    }
    assert eng.stats["preemptions_total"] >= 1, out["preempt"]
    assert [e.index for e in got["victim"]] == list(range(64)), "the victim lost tokens"
    assert got["victim"][-1].finish_reason == "length" and len(got["rival"]) == 16
    assert eng.allocator.free_pages == base.num_pages - 1, "pages did not balance"

    # (2) every slot busy, then a pending request with a 1 ms deadline
    for i in range(4):
        eng.submit(Request(f"busy{i}", rng.integers(1, V, 64).tolist(),
                           SamplingParams(max_new_tokens=24)))
    eng.step()
    eng.submit(Request("shed", rng.integers(1, V, 64).tolist(), SamplingParams(max_new_tokens=4),
                       deadline_s=0.001))
    time.sleep(0.01)
    evs = drain(eng)
    shed = [e for e in evs if e.request_id == "shed"]
    out["deadline"] = {"shed_pending_deadline_total": eng.stats["shed_pending_deadline_total"],
                       "events": [(e.finish_reason, e.token) for e in shed]}
    assert [(e.finish_reason, e.token) for e in shed] == [("deadline_exceeded", -1)], shed
    assert eng.stats["shed_pending_deadline_total"] == 1
    assert eng.allocator.free_pages == base.num_pages - 1
    del eng

    # (3) a cancel mid-chunk: a 1500-token prompt through 512-row ticks
    gc.collect()
    eng = InferenceEngine(params, cfg, dataclasses.replace(base, num_pages=201,
                                                           max_pages_per_seq=128),
                          seed=seed, device="cuda")
    eng.submit(Request("dec", rng.integers(1, V, 200).tolist(), SamplingParams(max_new_tokens=32)))
    eng.step()
    eng.submit(Request("long", rng.integers(1, V, 1500).tolist(), SamplingParams(max_new_tokens=4)))
    eng.step()
    mid = [(j.req.id, j.pos) for j in eng._prefill_jobs]
    assert mid and mid[0][0] == "long" and 0 < mid[0][1] < 1500, mid
    with eng._session_lock:
        held = eng.allocator.free_pages
    eng.request_cancel("long")
    eng.step()
    with eng._session_lock:
        freed = eng.allocator.free_pages - held
    evs = drain(eng)
    out["cancel"] = {"job_pos_at_cancel": mid[0][1], "pages_freed": freed,
                     "requests_cancelled": eng.stats["requests_cancelled"],
                     "free_pages": eng.allocator.free_pages}
    assert not eng._prefill_jobs and eng.stats["requests_cancelled"] == 1
    assert freed >= -(-1504 // 16) - 2, out["cancel"]  # the job's pages (less a step's use)
    assert not any(e.request_id == "long" for e in evs)
    assert eng.allocator.free_pages == 200, "pages did not balance"
    results["overload"] = out
    log(f"[overload] preempt {out['preempt']}; deadline {out['deadline']}; cancel {out['cancel']}")
    del eng


# the spec phase: 4 concurrent greedy prompts, SPEC_MAX_NEW new tokens each;
# the independent-draft runs add a temperature, a top-k and a schema row
SPEC_PROMPTS = (200, 600, 1000, 1500)
SPEC_MAX_NEW = 128
SPEC_PAGES = 1024  # 2 GiB of bf16 KV a pool: the target's and a self draft's fit


def watch_spec(eng) -> dict:
    """Wrap ``eng``'s decode-graph runs and spec eligibility: per dispatch
    its width, sampler variant, mode, whether it replayed a graph and the
    launches it counted; the rows of each speculative dispatch; the tokens
    each ``_resync_draft`` call replays. Returns the live records."""
    from agentfield_tpu_torch.ops.cuda import ragged_paged_attention as rpa

    rec = {"runs": [], "spec_rows": [], "resync_gaps": []}
    run, eligible, resync = eng._graphs.run, eng._spec_eligible, eng._resync_draft

    def counted_run(st, variant, mode):
        before = rpa.launch_counts()
        replayed = run(st, variant, mode)
        rec["runs"].append({"width": st.width, "variant": variant, "mode": mode,
                            "replayed": replayed,
                            "launches": {k: n - before[k] for k, n in rpa.launch_counts().items()}})
        return replayed

    def counted_eligible(active_idx):
        ok = eligible(active_idx)
        if ok:
            rec["spec_rows"].append(len(active_idx))
        return ok

    def counted_resync(active_idx):
        rec["resync_gaps"].append(sum(eng.slots[i].length - eng.slots[i].draft_len
                                      for i in active_idx))
        resync(active_idx)

    eng._graphs.run, eng._spec_eligible, eng._resync_draft = (
        counted_run, counted_eligible, counted_resync)
    return rec


def expected_replay_launches(eng, mode: str) -> dict:
    """The launches one replay of a decode-step graph must count: L target
    layers of one ragged launch (W = k + 1 for a spec step, on the path the
    kernel's ``afp_attention_path`` gives it), and for a spec step (k + 1)
    draft steps of L_draft W = 1 launches each (the split-context path)."""
    import torch

    from agentfield_tpu_torch.ops.cuda import ragged_paged_attention as rpa

    dcode = 1 if eng.params["embed"].dtype == torch.bfloat16 else 0
    out = {k: 0 for k in rpa.launch_counts()}
    k = int(mode[4:]) if mode.startswith("spec") else 0
    plan = [(eng.cfg, k + 1, eng.cfg.num_layers)]
    if k:
        plan.append((eng.draft_cfg, 1, (k + 1) * eng.draft_cfg.num_layers))
    for cfg, W, n in plan:
        path = rpa._entry(cfg.head_dim)[2](W, cfg.num_heads, cfg.num_kv_heads, dcode)
        out["ragged_paged_attention"] += n
        for key in rpa._PATH_KEYS[path]:
            out[key] += n
    return out


def phase_spec(results, state, seed: int, max_new: int = SPEC_MAX_NEW,
               prompt_lengths=SPEC_PROMPTS, draft_preset: str = SPEC_DRAFT,
               device: str = "cuda"):
    """Speculative decoding on the serve's full-width Llama-3-8B weights,
    bf16 pages, decode buckets (4, 16), over one script: ``SPEC_PROMPTS``
    greedy prompts at once, ``max_new`` tokens each. Run (a): plain
    (``spec_k=0``). Run (b): ``spec_k=3`` with the target's own tensors as
    the draft (its own pool): more than 2 tokens a row per spec step, and
    the verify's position-0 logits within the forward phase's bf16 bound of
    the plain replayed step's on the same state. Runs (c): a random
    ``llama-3.2-draft`` at ``spec_k`` 3 and 1, the script plus a
    temperature row, a top-k row and a ``response_schema`` row: no spec
    step while the schema row is active, the draft replays the missed tokens
    (``_resync_draft``) and spec steps resume after it. Every request
    answered and every page returned; every replay counts the launches
    ``expected_replay_launches`` gives. Prints per run decode tok/s, TTFT
    p50, spec steps, tokens per spec step (and per row), the spec and plain
    steps' device ms per width, graphs captured, peak memory and the
    break-even tokens per row and step (``t_spec / t_plain``). ``device``
    "cpu" rehearses the phase on a small model (no graphs, no device
    times)."""
    import dataclasses

    import numpy as np
    import torch

    from agentfield_tpu_torch.ops.cuda import ragged_paged_attention as rpa
    from agentfield_tpu_torch.serving.engine import EngineConfig, InferenceEngine, Request
    from agentfield_tpu_torch.serving.grammar import compile_json_schema, match_bytes
    from agentfield_tpu_torch.serving.model_node import GRAMMAR_SLOTS, load_draft_model
    from agentfield_tpu_torch.serving.sampler import SamplingParams
    from agentfield_tpu_torch.serving.tokenizer import ByteTokenizer

    params, cfg = state["params"], state["cfg"]
    V = cfg.vocab_size
    tok = ByteTokenizer(V)
    grammar = compile_json_schema(SERVE_SCHEMA, tok.token_bytes(V))
    rng = np.random.default_rng(seed + 17)
    prompts = [rng.integers(1, V, n).tolist() for n in prompt_lengths]
    extras = [rng.integers(1, V, n).tolist() for n in (300, 400, 250)]
    base = EngineConfig(max_batch=32, page_size=16, num_pages=SPEC_PAGES, max_pages_per_seq=128,
                        decode_buckets=(4, 16), grammar_slots=GRAMMAR_SLOTS)
    on_card = torch.device(device).type == "cuda"
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    rand_draft = load_draft_model(draft_preset, V, seed=seed + 4, device=device,
                                  dtype=params["embed"].dtype)
    runs = [("a_plain", 0, None, False), ("b_self_k3", 3, (params, cfg), False),
            ("c_draft_k3", 3, rand_draft, True), ("c_draft_k1", 1, rand_draft, True)]
    out = {"prompt_lengths": list(prompt_lengths), "max_new": max_new, "draft": draft_preset}
    launches = {k: 0 for k in rpa.launch_counts()}
    greedy_ref = None
    for name, k, draft, with_extras in runs:
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        eng = InferenceEngine(params, cfg, dataclasses.replace(base, spec_k=k), seed=seed,
                              device=device, draft=draft)
        rec = watch_spec(eng)
        reqs = [Request(f"g{i}", p, SamplingParams(max_new_tokens=max_new))
                for i, p in enumerate(prompts)]
        if with_extras:
            reqs += [
                Request("temp", extras[0], SamplingParams(max_new_tokens=max_new, temperature=0.8)),
                Request("topk", extras[1], SamplingParams(max_new_tokens=max_new, temperature=0.8,
                                                          top_k=40)),
                Request("schema", extras[2], SamplingParams(
                    max_new_tokens=64, stop_token_ids=(tok.eos_token_id,)), grammar=grammar),
            ]
        answers: dict[str, list[int]] = {}
        finals: dict[str, str] = {}
        rpa.reset_launches()  # count this run's main path only
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        while eng.has_work():
            for ev in eng.step():
                if ev.token >= 0 and ev.finish_reason != "stop":
                    answers.setdefault(ev.request_id, []).append(ev.token)
                if ev.finished:
                    finals[ev.request_id] = ev.finish_reason
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run_launches = rpa.launch_counts()
        for key, n in run_launches.items():
            launches[key] += n
        st = eng.stats
        for r in reqs:
            if r.id == "schema":
                body = bytes(answers[r.id])
                assert finals[r.id] == "stop" and match_bytes(grammar.trans, grammar.accept, body), body
            else:
                assert len(answers[r.id]) == max_new and finals[r.id] == "length", (name, r.id)
        assert all(0 <= t < V for a in answers.values() for t in a)
        assert eng.allocator.free_pages == base.num_pages - 1, f"{name}: pages did not balance"
        # the launch identity: every replay counted its graph's launches
        bad = []
        for r in rec["runs"]:
            if r["replayed"]:
                want = expected_replay_launches(eng, r["mode"])
                if {key: n for key, n in r["launches"].items() if n} != {
                        key: n for key, n in want.items() if n}:
                    bad.append((r["width"], r["mode"], r["launches"], want))
        assert not bad, f"{name}: replays counted other launches than expected: {bad[:2]}"
        per_replay = {m: {key: n for key, n in expected_replay_launches(eng, m).items() if n}
                      for m in sorted({r["mode"] for r in rec["runs"] if r["replayed"]})}
        spec_runs = [r for r in rec["runs"] if r["mode"].startswith("spec")]
        plain_runs = [r for r in rec["runs"] if not r["mode"].startswith("spec")]
        assert len(spec_runs) == st["spec_steps"] and len(rec["runs"]) == st["decode_steps"]

        def by_width(runs_, times):  # replayed dispatches align with the timed steps
            widths = [r["width"] for r in runs_ if r["replayed"]]
            assert len(widths) == len(times), (len(widths), len(times))
            per = {}
            for w, ms in zip(widths, times):
                per.setdefault(w, []).append(ms)
            return {w: statistics.fmean(v) for w, v in sorted(per.items())}

        spec_ms = by_width(spec_runs, list(eng.spec_step_ms))
        plain_ms = by_width(plain_runs, list(eng.decode_step_ms))
        row_steps = sum(rec["spec_rows"])
        row = {
            "spec_k": k, "requests": len(reqs), "wall_s": wall,
            "ttft_ms_p50": statistics.median(eng.ttft_ms),
            "decode_tokens": st["decode_tokens"], "decode_steps": st["decode_steps"],
            "decode_tok_per_s": st["decode_tokens"] / eng.timing["decode_s"],
            "spec_steps": st["spec_steps"], "spec_emitted": st["spec_emitted"],
            "tokens_per_spec_step": st["spec_emitted"] / st["spec_steps"] if st["spec_steps"] else None,
            "tokens_per_row_spec_step": st["spec_emitted"] / row_steps if row_steps else None,
            "spec_step_device_ms_by_width": spec_ms, "plain_step_device_ms_by_width": plain_ms,
            "graphs": eng.graph_stats(),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30 if on_card else None,
            "resync_tokens": sum(rec["resync_gaps"]), "launches": run_launches,
            "launches_per_replay": per_replay,
            "verify_launches_by_width": {
                w: sum(1 for r in spec_runs if r["width"] == w) * cfg.num_layers
                for w in sorted({r["width"] for r in spec_runs})},
        }
        if greedy_ref is None:
            greedy_ref = {r.id: answers[r.id] for r in reqs}
        else:
            same = [a == b for rid in greedy_ref for a, b in zip(answers[rid], greedy_ref[rid])]
            row["greedy_tokens_equal_to_plain"] = sum(same) / len(same)
        if k:
            assert st["spec_steps"] > 0, f"{name}: no spec step"
        if on_card:  # every step after a key's first use replays its graph
            assert len(rec["runs"]) == row["graphs"]["graphs_captured"] + sum(
                row["graphs"]["replays"].values()), row["graphs"]
        if name == "b_self_k3":
            assert row["tokens_per_row_spec_step"] > 2.0, row
            row["verify_logits_check"] = _verify_vs_plain_logits(
                eng, rng, results["forward"]["tol_bf16"])
        if with_extras:
            # the schema row held speculation off; after it the draft caught up
            modes = [r["mode"] for r in rec["runs"]]
            first_spec = next(i for i, m in enumerate(modes) if m.startswith("spec"))
            assert "grammar" in modes[:first_spec], modes[:first_spec + 1]
            assert row["resync_tokens"] > 0, "_resync_draft replayed nothing"
        # against this run's plain steps at the width, else run (a)'s
        ref = {**out.get("a_plain", {}).get("plain_step_device_ms_by_width", {}), **plain_ms}
        row["break_even_tokens_per_row_step"] = {w: spec_ms[w] / ref[w] for w in spec_ms if w in ref}
        out[name] = row
        log(f"[spec {name}] {len(reqs)} requests, k={k}: decode {row['decode_tok_per_s']:.1f} tok/s, "
            f"TTFT p50 {row['ttft_ms_p50']:.1f} ms; spec steps {row['spec_steps']} emitting "
            f"{row['tokens_per_spec_step']} tokens a step ({row['tokens_per_row_spec_step']} a row); "
            f"device ms a step by width: spec {spec_ms}, plain {plain_ms}; break-even tokens a row "
            f"and step {row['break_even_tokens_per_row_step']}; greedy tokens equal to run (a): "
            f"{row.get('greedy_tokens_equal_to_plain')}; draft replayed {row['resync_tokens']} tokens; "
            f"graphs {row['graphs']['graphs_captured']} captured, replays {row['graphs']['replays']}; "
            f"launch identity held on {sum(r['replayed'] for r in rec['runs'])} replays "
            f"(per replay: {per_replay}); peak "
            f"{row['peak_mem_gib']} GiB; wall {wall:.2f} s")
        del eng
    out["launches"] = launches
    results["spec"] = out


def _verify_vs_plain_logits(eng, rng, tol: float) -> dict:
    """On a spec engine (Llama-3-8B, bf16): four live slots; their logits
    from the plain decode forward replayed from a CUDA graph, and the
    position-0 logits of the verify's (k + 1)-wide forward on the same
    state (random proposals behind position 0, which it cannot see). Both
    write the pending-token slots, which the next real step rewrites; the
    verify's later positions land past the cached length, where nothing
    reads before a rewrite. Held within ``tol``; the engine then drains and
    its pages balance."""
    import numpy as np
    import torch

    from agentfield_tpu_torch.serving.engine import Request
    from agentfield_tpu_torch.serving.sampler import SamplingParams
    from agentfield_tpu_torch.serving.spec_decode import rows_forward

    V, k = eng.cfg.vocab_size, eng.ecfg.spec_k
    for i in range(4):
        eng.submit(Request(f"vl{i}", rng.integers(1, V, 150 + 200 * i).tolist(),
                           SamplingParams(max_new_tokens=16)))
    while eng.num_active < 4 or eng.pending:
        eng.step()
    eng._harvest_inflight()
    active = [i for i, s in enumerate(eng.slots) if s is not None]
    dev = eng.device
    toks = torch.from_numpy(eng.last_tokens[active].astype(np.int64)).to(dev)
    lens = torch.from_numpy(eng.seq_lens[active].copy()).to(dev)
    tables = torch.from_numpy(eng.page_tables[active].copy()).to(dev)
    props = torch.from_numpy(rng.integers(1, V, (len(active), k))).to(dev)
    with torch.no_grad():
        logits_p = eng._decode_forward(toks, lens, tables)  # eager: the CPU's answer
        if toks.is_cuda:  # the card's: the forward replayed from a CUDA graph
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                logits_p = eng._decode_forward(toks, lens, tables)
            graph.replay()
        logits_v = rows_forward(eng._target, torch.cat([toks[:, None], props], dim=1), lens,
                                torch.full_like(lens, k + 1), tables)[:, 0]
    err = float((logits_v.float() - logits_p.float()).abs().max())
    agree = float((logits_v.argmax(-1) == logits_p.argmax(-1)).float().mean())
    while eng.has_work():
        eng.step()
    assert eng.allocator.free_pages == eng.ecfg.num_pages - 1
    log(f"[spec b_self_k3] verify position-0 logits (W={k + 1}) vs the replayed plain step: "
        f"max|d| {err:.4e} (tol {tol:.4e}), argmax agreement {agree:.3f}")
    assert err <= tol, "the verify's position-0 logits disagree with the plain decode step"
    return {"max_abs_err": err, "tol_bf16": tol, "argmax_agreement": agree}


# the tier phase: sessions whose KV outgrows the HBM pool resume from host RAM
TIER_SESSIONS = 8
TIER_PROMPT = 1536  # 96 pages of 16: 192 MiB of bf16 KV at Llama-3-8B width
TIER_NEW = 32
TIER_TURN2_NEW = 16  # new prompt tokens of a session's second turn
TIER_CHURN = (1500, 1500, 1500, 1500)
TIER_PAGES = 640  # 1.25 GiB of bf16 KV: less than the sessions hold
TIER_HOST_BYTES = 4 << 30
TIER_MODES = ("none", "int8", "fp8")  # fp8: the bit-equality check alone


def _tier_ecfg(num_pages: int, host_bytes: int, kv_quant: str):
    from agentfield_tpu_torch.serving.engine import EngineConfig

    return EngineConfig(max_batch=8, page_size=16, num_pages=num_pages,
                        max_pages_per_seq=min(128, num_pages - 1),
                        decode_buckets=(4,), host_cache_bytes=host_bytes,
                        kv_quant_dtype=kv_quant)


def _run_one(eng, rid, prompt, max_new, session=None, probe=None) -> list[int]:
    """Submit one greedy request and step the engine until it is idle;
    returns the request's tokens. ``probe(eng)`` runs once, after the first
    step that left a decode step in flight, and returns the events it
    harvested."""
    from agentfield_tpu_torch.serving.engine import Request
    from agentfield_tpu_torch.serving.sampler import SamplingParams

    eng.submit(Request(rid, prompt, SamplingParams(max_new_tokens=max_new), session_id=session))
    out = []
    while eng.has_work():
        evs = eng.step()
        if probe is not None and eng._inflight is not None:
            evs, probe = evs + probe(eng), None
        out += [ev.token for ev in evs if ev.request_id == rid and ev.token >= 0]
    return out


def _replay_vs_eager(eng, result: dict) -> list:
    """The decode step replayed from its CUDA graph against the eager
    forward on the same chained state, right after a restore: the replayed
    greedy tokens must equal the eager argmax (a pool tensor reassigned by
    the restore would leave the graph reading stale memory). The state is
    put back, so the engine continues as if nothing ran. Fills ``result``;
    returns the events of the step it harvested first."""
    import torch

    events = eng._harvest_inflight()
    active = [i for i, s in enumerate(eng.slots) if s is not None]
    bucket = eng._pick_decode_bucket(len(active))
    st = eng._compact_state(active, bucket) if bucket is not None else eng._dev_state()
    toks0, lens0 = st.tokens.clone(), st.seq_lens.clone()
    live = lens0 > 0
    with torch.no_grad():
        logits_e = eng._decode_forward(st.tokens, st.seq_lens, st.page_tables)
        replayed = eng._graphs.run(st, "greedy", "free")
        toks_g = st.out_tokens[0].clone()
        st.tokens.copy_(toks0)
        st.seq_lens.copy_(lens0)
    same = bool(torch.equal(toks_g[live], logits_e.argmax(-1).int()[live]))
    result.update(replayed=replayed, live_rows=int(live.sum()), same_tokens=same)
    return events


class _TierWatch:
    """Instruments a tier engine's pool for ``phase_tier``. Every page the
    offload worker copies while ``check_fetch`` is on is held against its
    capture (the host payload bit-equal to the captured clone; the phase
    turns it off before the timed second turns, whose restored pages were
    all demoted before), and every restored page against its payload once
    its turn is over (``check_restored``): so a restored page equals its
    bytes at capture, values and scales, matched by chain hash.
    Times each restore walk (``lookup``), and inside the walks the target
    allocations and the demote captures they trigger, and each batched
    upload's host ms (``_commit_restores``)."""

    def __init__(self, eng):
        self.eng, p = eng, eng.allocator
        self.fetched = self.fetch_mismatch = self.checked = 0
        self.mismatch: list = []
        self.host_ms: list[float] = []
        self.pages: list[int] = []
        self.walk_ms: list[float] = []
        self.walk = {"capture_ms": 0.0, "captures": 0, "alloc_ms": 0.0}
        self._todo: list = []
        self._in_walk = False
        self.check_fetch = True
        self._orig = {k: getattr(p, k) for k in
                      ("_capture", "_fetch", "_restore_alloc", "_commit_restores", "lookup")}
        p._capture, p._fetch, p._restore_alloc = self._capture, self._fetch, self._restore_alloc
        p._commit_restores, p.lookup = self._commit, self._lookup

    def _capture(self, page):
        t0 = time.perf_counter()
        handle = self._orig["_capture"](page)
        if self._in_walk:
            self.walk["capture_ms"] += (time.perf_counter() - t0) * 1e3
            self.walk["captures"] += 1
        return handle

    def _fetch(self, handle):
        import contextlib

        import torch

        payload = self._orig["_fetch"](handle)  # the worker thread
        if not self.check_fetch:
            return payload
        stream = self.eng._copy_stream
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            for host, clone in zip(payload.leaves, handle[0]):
                self.fetched += 1
                self.fetch_mismatch += not torch.equal(host, clone.cpu())
        return payload

    def _restore_alloc(self):
        t0 = time.perf_counter()
        got = self._orig["_restore_alloc"]()
        self.walk["alloc_ms"] += (time.perf_counter() - t0) * 1e3
        return got

    def _commit(self, pending):
        t0 = time.perf_counter()
        ok = self._orig["_commit_restores"](pending)
        self.host_ms.append((time.perf_counter() - t0) * 1e3)
        self.pages.append(len(pending))
        if ok:
            self._todo += [(rec.depth, page, payload) for rec, page, payload in pending]
        return ok

    def _lookup(self, tokens, hashes=None):
        t0 = time.perf_counter()
        self._in_walk = True
        try:
            return self._orig["lookup"](tokens, hashes)
        finally:
            self._in_walk = False
            self.walk_ms.append((time.perf_counter() - t0) * 1e3)

    def check_restored(self):
        """After a turn: the session still holds its restored pages, which
        nothing rewrote; each must equal the payload it came from."""
        import torch

        from agentfield_tpu_torch.ops.kv_quant import bits

        for depth, page, payload in self._todo:
            for li, t in enumerate(self.eng.cache.leaves()):
                self.checked += 1
                if not torch.equal(bits(t)[:, page].cpu(), payload.leaves[li]):
                    self.mismatch.append((depth, li))
        self._todo = []


def phase_tier(results, state, seed: int, device: str = "cuda", sessions: int = TIER_SESSIONS,
               prompt_len: int = TIER_PROMPT, max_new: int = TIER_NEW,
               turn2_new: int = TIER_TURN2_NEW, churn=TIER_CHURN, num_pages: int = TIER_PAGES,
               host_bytes: int = TIER_HOST_BYTES, modes=TIER_MODES):
    """The host KV tier on the serve's weights, pages of 16. Per mode (bf16
    "none", int8; fp8 for the bit check alone), the tier engine (a
    ``num_pages`` pool the sessions outgrow, ``host_bytes`` of host tier):
    each session sends a ``prompt_len``-token prompt (``max_new`` greedy
    tokens) and expires (``gc_sessions`` at now + ttl + 1, then
    ``offload_drain``, then ``demote_lru`` and a drain until nothing is
    left: expiry enqueues at most the demote queue's 64 pages) before the
    next arrives — under allocation pressure the engine evicts idle
    sessions without demoting them, so expiry is what moves a session to
    host RAM; then ``churn`` unrelated prompts
    overwrite the freed pages; then each session's second turn (history +
    ``turn2_new`` tokens) one at a time, which restores its pages. Checks:
    every restored page's values and scales bit-equal to its bytes at
    capture (matched by chain hash), a replayed decode step after a
    restore equal to the eager step, no ``kv_offload_restore_fail``, and
    ``free_pages`` back to its start after ``free_session`` of every
    session. bf16 and int8 also run the same turns on a tier-off engine of
    the same pool (a re-prefill) and on a tier-off engine whose pool holds
    everything (an HBM hit): each resumed turn's greedy tokens must equal
    the HBM hit's. Prints pages and GiB demoted, demote GB/s (the worker's
    copy time), restore device ms per session (CUDA events around each
    upload) and host ms (``_commit_restores``), TTFT p50 of the resume, the
    re-prefill and the HBM hit, peak device memory and pinned host bytes.
    bf16 and int8 also run the engine's own path on a second tier engine:
    expiry and drain with no ``demote_lru``, so a session longer than the
    demote queue keeps its last pages on the HBM LRU, where the churn
    evicts them. It prints per session the pages restored and the prompt
    tokens re-prefilled, its resume TTFT p50, and how many resumed turns
    equal the HBM hit's (printed, not held: the re-prefilled tail runs
    another bf16 path), and holds its restored pages bit-equal, no failed
    restore and the pages balanced.
    ``device`` "cpu" rehearses the phase on a small model."""
    import numpy as np
    import torch

    from agentfield_tpu_torch.ops.cuda import ragged_paged_attention as rpa
    from agentfield_tpu_torch.serving.engine import InferenceEngine

    params, cfg = state["params"], state["cfg"]
    V = cfg.vocab_size
    on_card = torch.device(device).type == "cuda"
    rng = np.random.default_rng(seed + 23)
    turn1 = [rng.integers(1, V, prompt_len).tolist() for _ in range(sessions)]
    extra = [rng.integers(1, V, turn2_new).tolist() for _ in range(sessions)]
    churns = [rng.integers(1, V, n).tolist() for n in churn]
    hit_pages = 1 + sessions * (-(-(prompt_len + max_new + turn2_new + max_new) // 16)) + sum(
        -(-(n + max_new) // 16) for n in churn)
    out = {"sessions": sessions, "prompt_len": prompt_len, "max_new": max_new,
           "churn": list(churn), "num_pages": num_pages, "host_bytes": host_bytes,
           "hbm_hit_pages": hit_pages}
    launches = {k: 0 for k in rpa.launch_counts()}

    def session_script(eng, name, watch=None, probe=None, drain_all=True):
        """Turn 1, expiry and drain per session; the churn; the second
        turns one at a time (``watch``'s fetch check off, its restore check
        after each). ``drain_all`` False leaves what expiry did not enqueue
        on the HBM LRU. Returns (turn-1 tokens, turn-2 tokens, the turn-2
        TTFTs, pages demoted before turn 2, per second turn the pages
        restored and the prompt tokens prefilled)."""
        clock = time.time()
        first = []
        for i, p in enumerate(turn1):
            first.append(_run_one(eng, f"{name}-s{i}-t1", p, max_new, session=f"s{i}"))
            clock += eng.ecfg.session_ttl + 1
            eng.gc_sessions(at=clock)
            # expiry enqueues at most the demote queue's bound (64 pages, as
            # in the JAX pool); ``drain_all`` moves the rest from the LRU
            while True:
                assert eng.allocator.offload_drain(120.0), f"{name}: offload worker wedged"
                with eng._session_lock:
                    if not drain_all or not eng.allocator.demote_lru():
                        break
        for j, p in enumerate(churns):
            _run_one(eng, f"{name}-churn{j}", p, max_new)
        assert eng.allocator.offload_drain(120.0)
        demoted = eng.stats["kv_offload_demoted"]
        if watch is not None:
            watch.check_fetch = False  # every page turn 2 restores was checked
        ttft0 = len(eng.ttft_ms)
        second, per_turn = [], []
        for i, p in enumerate(turn1):
            t2 = p + first[i] + extra[i]
            before = (eng.stats["kv_offload_restored"], eng.stats["prefill_tokens"])
            # the last session's turn holds a replay against the eager step
            second.append(_run_one(eng, f"{name}-s{i}-t2", t2, max_new, session=f"s{i}",
                                   probe=probe if i == sessions - 1 else None))
            per_turn.append((eng.stats["kv_offload_restored"] - before[0],
                             eng.stats["prefill_tokens"] - before[1]))
            if watch is not None:
                watch.check_restored()
        return first, second, list(eng.ttft_ms)[ttft0:], demoted, per_turn

    for mode in modes:
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        base_gib = torch.cuda.memory_allocated() / 2**30 if on_card else None
        eng = InferenceEngine(params, cfg, _tier_ecfg(num_pages, host_bytes, mode), seed=seed,
                              device=device)
        watch = _TierWatch(eng)
        replay = {}
        rpa.reset_launches()  # this run's main path only
        t0 = time.perf_counter()
        first, second, ttfts, demoted_turn1, per_turn = session_script(
            eng, "tier", watch, probe=(lambda e, r=replay: _replay_vs_eager(e, r)) if on_card else None)
        wall = time.perf_counter() - t0
        for key, n in rpa.launch_counts().items():
            launches[key] += n
        if on_card:
            torch.cuda.synchronize()
        st = eng.stats
        page_bytes = eng.kv_page_bytes
        uploads = eng.restore_upload_ms()
        row = {
            "wall_s": wall, "page_bytes": page_bytes,
            "demoted_pages": st["kv_offload_demoted"],
            "demoted_gib": st["kv_offload_demoted"] * page_bytes / 2**30,
            "demote_gb_per_s": (st["kv_offload_demoted"] * page_bytes / 1e9 / eng.timing["offload_s"]
                                if eng.timing["offload_s"] else None),
            "worker_copy_s": eng.timing["offload_s"],
            "slab_alloc_s": eng._host_store.alloc_s,
            "demote_gb_per_s_without_slab_alloc": (
                st["kv_offload_demoted"] * page_bytes / 1e9
                / (eng.timing["offload_s"] - eng._host_store.alloc_s)),
            "restored_pages": st["kv_offload_restored"],
            "restore_fail": st["kv_offload_restore_fail"],
            "host_evicted": st["kv_offload_host_evicted"],
            "restore_pages_per_commit": watch.pages,
            "restore_device_ms": [ms for _, ms in uploads],
            "restore_host_ms": watch.host_ms,
            "leaves_fetched_checked": watch.fetched, "fetch_mismatches": watch.fetch_mismatch,
            "leaves_checked": watch.checked, "leaf_mismatches": watch.mismatch[:8],
            "ttft_ms_p50_resume": statistics.median(ttfts),
            "ttft_ms_resume": ttfts,
            "restored_prefilled_per_turn": per_turn,
            "restore_walk_host_ms": watch.walk_ms[-sessions:],
            "restore_walks": watch.walk,  # inside them: target allocations, demote captures
            "demoted_in_turn2": st["kv_offload_demoted"] - demoted_turn1,
            "replay_vs_eager": replay,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30 if on_card else None,
            "mem_at_start_gib": base_gib,
            "host_tier_bytes": eng.host_tier_bytes(),
            "prefix_index_hits": st["prefix_index_hits"],
        }
        assert not watch.mismatch and not watch.fetch_mismatch, (
            f"{mode}: restored pages differ from their capture")
        assert watch.checked > 0 and watch.fetched > 0, row
        assert st["kv_offload_restored"] >= sessions, row
        assert st["kv_offload_restore_fail"] == 0, row
        if on_card:
            assert replay.get("replayed") and replay.get("same_tokens"), replay
        row["sessions_left"] = sum(eng.free_session(f"s{i}") for i in range(sessions))
        assert eng.allocator.offload_drain(120.0)
        with eng._session_lock:
            row["free_pages_end"] = eng.allocator.free_pages
        assert row["free_pages_end"] == num_pages - 1, "pages did not balance"
        eng.close()
        del eng, watch
        if mode != "fp8":
            # the engine's own path: expiry alone demotes (no demote_lru)
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
            eng = InferenceEngine(params, cfg, _tier_ecfg(num_pages, host_bytes, mode),
                                  seed=seed, device=device)
            watch = _TierWatch(eng)
            rpa.reset_launches()
            _, own_second, own_ttfts, own_demoted, own_turns = session_script(
                eng, "own", watch, drain_all=False)
            for key, n in rpa.launch_counts().items():
                launches[key] += n
            own = {"demoted_pages": own_demoted,
                   "restored_prefilled_per_turn": own_turns,
                   "ttft_ms_p50_resume": statistics.median(own_ttfts),
                   "ttft_ms_resume": own_ttfts,
                   "restore_fail": eng.stats["kv_offload_restore_fail"],
                   "leaves_checked": watch.checked}
            assert not watch.mismatch and not watch.fetch_mismatch, (
                f"{mode}: own path: restored pages differ from their capture")
            assert own["restore_fail"] == 0, own
            for i in range(sessions):
                eng.free_session(f"s{i}")
            assert eng.allocator.offload_drain(120.0)
            with eng._session_lock:
                assert eng.allocator.free_pages == num_pages - 1, "own path: pages did not balance"
            eng.close()
            del eng, watch
            row["own_path"] = own
            # the same turns on a tier-off engine (same pool: a re-prefill) and
            # on one whose pool holds everything (an HBM hit)
            seconds = {"own_path": own_second}
            for name, pages in (("reprefill", num_pages), ("hbm_hit", hit_pages)):
                gc.collect()
                if on_card:
                    torch.cuda.empty_cache()
                other = InferenceEngine(params, cfg, _tier_ecfg(pages, 0, mode), seed=seed,
                                        device=device)
                rpa.reset_launches()
                f2, s2, t2, _, turns2 = session_script(other, name)
                for key, n in rpa.launch_counts().items():
                    launches[key] += n
                row[f"ttft_ms_p50_{name}"] = statistics.median(t2)
                row[f"prefix_index_hits_{name}"] = other.stats["prefix_index_hits"]
                row[f"restored_prefilled_per_turn_{name}"] = turns2
                seconds[name] = s2
                if name == "hbm_hit":
                    assert other.stats["prefix_pages_evicted"] == 0, "the HBM-hit pool evicted"
                    assert f2 == first, f"{mode}: turn 1 differs between engines"
                    same = [a == b for a, b in zip(second, s2)]
                    row["resumed_equal_hbm_hit"] = sum(same)
                    assert all(same), f"{mode}: resumed turns differ from the HBM hit: {same}"
                    for key in ("own_path", "reprefill"):
                        row[f"{key}_equal_hbm_hit"] = sum(
                            a == b for a, b in zip(seconds[key], s2))
                del other
            log(f"[tier {mode}] engine's own path (expiry alone, no demote_lru): demoted "
                f"{own['demoted_pages']} pages before turn 2; per turn (pages restored, prompt "
                f"tokens prefilled) {own['restored_prefilled_per_turn']} against the forced "
                f"drain's {per_turn}; TTFT p50 resume {own['ttft_ms_p50_resume']:.1f} ms "
                f"(forced drain {row['ttft_ms_p50_resume']:.1f}); resumed tokens = HBM hit: own "
                f"path {row['own_path_equal_hbm_hit']}/{sessions}, re-prefill "
                f"{row['reprefill_equal_hbm_hit']}/{sessions}, forced drain "
                f"{row['resumed_equal_hbm_hit']}/{sessions}")
        out[mode] = row
        log(f"[tier {mode}] {sessions} sessions x {prompt_len} tokens over a {num_pages}-page "
            f"pool: demoted {row['demoted_pages']} pages ({row['demoted_gib']:.3f} GiB) at "
            f"{row['demote_gb_per_s']} GB/s (worker copy {row['worker_copy_s']:.3f} s, of it "
            f"{row['slab_alloc_s']:.3f} s allocating pinned slabs: "
            f"{row['demote_gb_per_s_without_slab_alloc']} GB/s without); restored "
            f"{row['restored_pages']} (fail {row['restore_fail']}) in commits of "
            f"{row['restore_pages_per_commit']} pages, device ms {row['restore_device_ms']}, host "
            f"ms {[round(x, 3) for x in row['restore_host_ms']]}; {row['leaves_checked']} leaves "
            f"bit-equal to capture; TTFT p50 resume {row['ttft_ms_p50_resume']:.1f} ms, "
            f"re-prefill {row.get('ttft_ms_p50_reprefill')}, HBM hit "
            f"{row.get('ttft_ms_p50_hbm_hit')}; resumed tokens = HBM hit: "
            f"{row.get('resumed_equal_hbm_hit')}/{sessions}; replay vs eager {replay}; peak "
            f"{row['peak_mem_gib']} GiB (at start {row['mem_at_start_gib']}), host tier {row['host_tier_bytes'] / 2**30:.3f} GiB; "
            f"wall {wall:.1f} s")
    out["launches"] = launches
    results["tier"] = out


# the fork phase: one prompt, branched against separate requests
FORK_PROMPT = 1000
FORK_NEW = 64
FORK_N = 8
FORK_PAGES = 1024


def phase_fork(results, state, seed: int, device: str = "cuda", prompt_len: int = FORK_PROMPT,
               max_new: int = FORK_NEW, n: int = FORK_N, num_pages: int = FORK_PAGES):
    """Branch forks on the serve's weights, bf16 pages, through the node.
    One ``prompt_len``-token prompt, ``max_new`` new tokens, four ways:
    (a) ``n_branches=n`` best-of-N at temperature 0.8; (b) the same prompt
    as ``n`` separate requests; (c) greedy ``n_branches=4`` against the
    unforked greedy request: branch 0's first token and logprob equal the
    unforked request's (the same prefill logits); (d) a beam request
    (``beam_width`` 2, ``beam_interval`` 8) over the node's HTTP route, so
    live forks and their tail copies run between graph replays. Every
    forked tail page is bit-equal to its parent's tail at fork time, every
    branch gets one terminal and the caller one winner result, no page
    leaks after a group resolves, and every replay counts the launches its
    graph must make. Prints pages held at peak, TTFT and decode tok/s for
    (a) against (b), and the ragged launches per replay."""
    import numpy as np
    import torch

    from agentfield_tpu_torch.ops.cuda import ragged_paged_attention as rpa
    from agentfield_tpu_torch.ops.kv_quant import bits
    from agentfield_tpu_torch.serving.engine import EngineConfig
    from agentfield_tpu_torch.serving.model_node import ModelBackend, ModelNodeServer
    from agentfield_tpu_torch.serving.tokenizer import ByteTokenizer

    params, cfg = state["params"], state["cfg"]
    V = cfg.vocab_size
    on_card = torch.device(device).type == "cuda"
    rng = np.random.default_rng(seed + 29)
    prompt = rng.integers(1, V, prompt_len).tolist()
    ecfg = EngineConfig(max_batch=16, page_size=16, num_pages=num_pages,
                        max_pages_per_seq=min(128, num_pages - 1),
                        decode_buckets=(4, 16))
    out = {"prompt_len": prompt_len, "max_new": max_new, "n": n}
    launches = {k: 0 for k in rpa.launch_counts()}

    def run(name, requests, http=False):
        """Serve ``requests`` (generate kwargs) at once on a fresh node;
        returns (results, the engine's observations)."""
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        backend = ModelBackend(params, cfg, ecfg, tokenizer=ByteTokenizer(V), seed=seed,
                               device=device)
        eng = backend.engine
        rec = watch_spec(eng)  # per-dispatch launches of every graph run
        obs = {"held_max": 0, "events": [], "tail_copies": 0, "tail_mismatch": 0,
               "copies_after_replay": 0}
        step = eng.step

        def observed_step():
            evs = step()
            obs["events"] += evs
            obs["held_max"] = max(obs["held_max"], num_pages - 1 - eng.allocator.free_pages)
            return evs

        copy = eng._copy_page

        def checked_copy(src, dst):
            copy(src, dst)
            obs["tail_copies"] += 1
            obs["copies_after_replay"] += any(r["replayed"] for r in rec["runs"])
            for t in eng.cache.leaves():
                if not torch.equal(bits(t)[:, dst], bits(t)[:, src]):
                    obs["tail_mismatch"] += 1

        eng.step, eng._copy_page = observed_step, checked_copy
        answers = [None] * len(requests)
        errors = []
        server = ModelNodeServer(backend) if http else None
        port = server.start() if http else backend.start()

        def send(i):
            try:
                if http:
                    answers[i] = _post(port, requests[i])["result"]
                else:
                    answers[i] = backend.generate(**requests[i])
            except Exception as e:  # noqa: BLE001 — collected and failed below
                errors.append(f"{name} request {i}: {e!r}")

        rpa.reset_launches()  # this run's main path only
        d0 = (eng.stats["decode_tokens"], eng.timing["decode_s"])
        threads = [threading.Thread(target=send, args=(i,)) for i in range(len(requests))]
        try:
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        finally:
            (server or backend).stop()
        for key, k in rpa.launch_counts().items():
            launches[key] += k
        assert not errors, errors
        st = eng.stats
        terminals: dict[str, int] = {}
        for ev in obs["events"]:
            if ev.finished:
                terminals[ev.request_id] = terminals.get(ev.request_id, 0) + 1
        bad = []
        for r in rec["runs"]:
            if r["replayed"]:
                want = {k: v for k, v in expected_replay_launches(eng, r["mode"]).items() if v}
                if {k: v for k, v in r["launches"].items() if v} != want:
                    bad.append((r["width"], r["launches"], want))
        assert not bad, f"{name}: replays counted other launches than expected: {bad[:2]}"
        per_replay = {m: {k: v for k, v in expected_replay_launches(eng, m).items() if v}
                      for m in sorted({r["mode"] for r in rec["runs"] if r["replayed"]})}
        graphs = eng.graph_stats()
        decode_s = eng.timing["decode_s"] - d0[1]
        row = {
            "requests": len(requests), "pages_held_max": obs["held_max"],
            "ttft_ms_p50": statistics.median(eng.ttft_ms),
            "decode_tok_per_s": (st["decode_tokens"] - d0[0]) / decode_s,
            # the same without the first step's eager run and capture
            "decode_tok_per_s_replays": (st["decode_tokens"] - d0[0]) / (
                decode_s - graphs["capture_s"]),
            "decode_step_device_ms_mean": (statistics.fmean(eng.decode_step_ms)
                                           if eng.decode_step_ms else None),
            "decode_steps": st["decode_steps"], "forks": st["branch_forks_total"],
            "forks_degraded": st["branch_forks_degraded_total"],
            "fork_failed": st["branch_fork_failed_total"], "pruned": st["branch_pruned_total"],
            "tail_copies": obs["tail_copies"], "tail_copies_after_a_replay":
                obs["copies_after_replay"],
            "terminals": terminals, "graphs": graphs,
            "ragged_launches_per_replay": per_replay,
            "free_pages_end": eng.allocator.free_pages,
        }
        assert obs["tail_mismatch"] == 0, f"{name}: a forked tail differs from its parent's"
        assert all(c == 1 for c in terminals.values()), f"{name}: terminals {terminals}"
        assert row["free_pages_end"] == num_pages - 1, f"{name}: pages leaked"
        assert not backend._groups and not backend._group_sinks
        return answers, row, obs["events"]

    samp = dict(tokens=prompt, max_new_tokens=max_new)
    # the unforked greedy request first: (c)'s reference, and the warm-up of
    # this prompt's prefill shapes before (a) and (b) are timed
    res_u, out["c_unforked"], ev_u = run("c_unforked", [dict(samp)])
    # (a) n branches, best of N, temperature 0.8; (b) the same as n requests
    res_a, out["a_branched"], _ = run("a", [dict(samp, temperature=0.8, n_branches=n)])
    assert res_a[0]["branches"]["n"] == n and len(res_a[0]["tokens"]) <= max_new
    assert len(out["a_branched"]["terminals"]) == n
    assert out["a_branched"]["forks"] == n - 1
    res_b, out["b_separate"], _ = run("b", [dict(samp, temperature=0.8)] * n)
    assert all(len(r["tokens"]) == max_new for r in res_b)
    # (c) greedy: branch 0 against the unforked request
    res_c, out["c_greedy"], ev_c = run("c", [dict(samp, n_branches=4)])

    def first_event(evs):
        e = next(e for e in evs if e.index == 0 and "#" not in e.request_id)
        return e.token, e.logprob

    fu, fc = first_event(ev_u), first_event(ev_c)
    out["c_greedy"]["first_token_logprob"] = {"unforked": fu, "branch0": fc}
    assert fu == fc, f"branch 0's first token/logprob {fc} != the unforked request's {fu}"
    out["c_greedy"]["tokens_equal_unforked"] = res_c[0]["tokens"] == res_u[0]["tokens"]
    assert out["c_greedy"]["tail_copies"] == (3 if prompt_len % 16 else 0)
    # (d) beam through the HTTP route: prunes, live re-forks between replays
    res_d, out["d_beam"], _ = run("d", [dict(samp, temperature=0.8, n_branches=4, branch_policy={
        "type": "beam", "beam_width": 2, "beam_interval": 8})], http=True)
    d = res_d[0]["branches"]
    out["d_beam"]["branches"] = d
    assert d["policy"] == "beam" and d["pruned"] >= 1 and d["forked"] > 4, d
    assert out["d_beam"]["forks"] > 3, "no live re-fork ran"
    if on_card:
        assert out["d_beam"]["tail_copies_after_a_replay"] > 0, "no fork ran between replays"
    out["launches"] = launches
    results["fork"] = out
    a, b = out["a_branched"], out["b_separate"]
    log(f"[fork] {prompt_len}-token prompt, {max_new} new: (a) {n} branches: pages held at peak "
        f"{a['pages_held_max']}, TTFT {a['ttft_ms_p50']:.1f} ms, decode "
        f"{a['decode_tok_per_s']:.1f} tok/s ({a['decode_tok_per_s_replays']:.1f} without the "
        f"capture; step {a['decode_step_device_ms_mean']} device ms); (b) {n} requests: pages "
        f"{b['pages_held_max']}, TTFT p50 {b['ttft_ms_p50']:.1f} ms, decode "
        f"{b['decode_tok_per_s']:.1f} tok/s ({b['decode_tok_per_s_replays']:.1f}; step "
        f"{b['decode_step_device_ms_mean']} device ms); unforked TTFT "
        f"{out['c_unforked']['ttft_ms_p50']:.1f} ms; (c) branch 0 "
        f"first token/logprob {fc} = unforked {fu}, whole greedy answer equal: "
        f"{out['c_greedy']['tokens_equal_unforked']}; (d) beam {d}, forks "
        f"{out['d_beam']['forks']}, tail copies {out['d_beam']['tail_copies']} "
        f"({out['d_beam']['tail_copies_after_a_replay']} after a replay); ragged launches per "
        f"replay {a['ragged_launches_per_replay']}")


# the api phase: the SDK's request surface, the token stream, embed and the
# control plane, through the node's HTTP routes
API_NEW = 16
API_LIVE_NEW = 64
API_EMBED_LENS = (64, 200, 333, 480, 700, 1000, 1200, 1500)
# prompt lengths: (a) the prompt, (a) the user message, (c), (e), (d) the single embed
API_PROMPTS = (150, 160, 300, 400, 500)
API_COSINE_MIN = 0.999  # embed through the kernel against the plain attention, bf16
API_PAGES = 1024
# the input properties of the JAX node's reasoners (the JAX SDK builds them
# from ModelBackend.generate and .embed); tests/test_torch_node_api.py holds
# these names against the JAX node itself
JAX_GENERATE_PROPS = (
    "prompt", "tokens", "messages", "max_new_tokens", "temperature", "top_k", "top_p",
    "stop_token_ids", "session_id", "response_schema", "context_overflow", "images", "audios",
    "output", "deadline_s", "priority", "n_branches", "branch_policy", "kv_peer",
    "handoff_export", "handoff", "trace", "expect_followup", "followup_candidates")
JAX_EMBED_PROPS = ("prompt", "tokens", "pooling", "context_overflow", "prompts")
# what a heartbeat carries beside the engine's counter dicts
HEARTBEAT_KEYS = ("active_slots", "pending_requests", "free_pages", "draining", "latency_hist")


def api_embed_forwards(embed_lens: tuple | None = None, single: int | None = None) -> list[tuple[int, int]]:
    """(rows, padded length) of each embed forward ``phase_api`` makes: the
    single prompt, then the batch's chunks (``embed_chunks``)."""
    from agentfield_tpu_torch.serving.model_node import EMBED_CHUNK_TOKENS, embed_chunks

    lens = API_EMBED_LENS if embed_lens is None else embed_lens
    chunks = embed_chunks(list(lens), EMBED_CHUNK_TOKENS)
    return [(1, API_PROMPTS[4] if single is None else single)] + [
        (len(c), max(lens[i] for i in c)) for c in chunks]


def sdk_payload(**over) -> dict:
    """The input ``Agent.ai()`` sends for a text call (``sdk/agent.py``
    :728-744), with its defaults: null media, text output,
    ``context_overflow`` "truncate_left"."""
    doc = {"prompt": None, "tokens": None, "messages": None, "images": None, "audios": None,
           "output": "text", "max_new_tokens": 128, "temperature": 0.0, "top_k": 0,
           "top_p": 1.0, "stop_token_ids": [], "session_id": None, "response_schema": None,
           "context_overflow": "truncate_left"}
    doc.update(over)
    return doc


class StandInControlPlane:
    """A stdlib stand-in for the control-plane routes a model node calls:
    ``POST /api/v1/nodes`` (register), ``POST /api/v1/nodes/{id}/heartbeat``
    (404 for a node it does not know), ``DELETE /api/v1/nodes/{id}`` and
    ``POST /api/v1/executions/{id}/status``. It records every body with its
    arrival time.

    Its gateway half plays the JAX gateway's channel side for the cluster
    tier: ``attach`` opens a channel to a node (``ChannelClient``), whose
    ``kv_fetch``, ``kv_pages`` and page-blob frames it relays to the peer
    a fetch names and back, under a fetch id of its own (the JAX
    ``relay_kv_fetch``/``relay_kv_pages``/``relay_kv_blob``: the chains and
    ``max_bytes`` capped, blob headers rewritten, payload bytes untouched);
    ``two_phase`` is the JAX gateway's two-phase dispatch."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.specs: list[dict] = []
        self.nodes: dict[str, dict] = {}
        self.heartbeats: list[tuple[float, str, dict]] = []
        self.deleted: list[str] = []
        self.statuses: dict[str, dict] = {}
        self.cv = threading.Condition()
        self.channels: dict[str, ChannelClient] = {}
        # gateway fetch id -> (requesting node, its fetch id)
        self.kv_relays: dict[str, tuple[str, str]] = {}
        self.kv_stats = {"kv_relay_fetches_total": 0, "kv_relay_frames_total": 0,
                         "kv_relay_errors_total": 0}
        self._relay_lock = threading.Lock()
        cp = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _reply(self, status, doc):
                raw = json.dumps(doc).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def _body(self):
                n = int(self.headers.get("Content-Length") or 0)
                return json.loads(self.rfile.read(n)) if n else {}

            def do_POST(self):
                body, parts = self._body(), self.path.strip("/").split("/")
                with cp.cv:
                    if parts == ["api", "v1", "nodes"]:
                        cp.specs.append(body)
                        cp.nodes[body["node_id"]] = body
                        status, doc = 201, {"node": body}
                    elif parts[:3] == ["api", "v1", "nodes"] and parts[4:] == ["heartbeat"]:
                        if parts[3] not in cp.nodes:
                            status, doc = 404, {"error": "unknown node; re-register"}
                        else:
                            cp.heartbeats.append((time.perf_counter(), parts[3], body))
                            status, doc = 200, {"status": body.get("status", "active")}
                    elif parts[:3] == ["api", "v1", "executions"] and parts[4:] == ["status"]:
                        cp.statuses[parts[3]] = body
                        status, doc = 200, {}
                    else:
                        status, doc = 404, {"error": "not found"}
                    cp.cv.notify_all()
                self._reply(status, doc)

            def do_DELETE(self):
                parts = self.path.strip("/").split("/")
                with cp.cv:
                    found = cp.nodes.pop(parts[3], None) is not None
                    cp.deleted.append(parts[3])
                    cp.cv.notify_all()
                self._reply(200 if found else 404, {"deleted": found})

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True,
                                        name="stand-in-cp")

    def start(self) -> str:
        self._thread.start()
        return f"http://127.0.0.1:{self._httpd.server_address[1]}"

    def stop(self) -> None:
        for ch in list(self.channels.values()):
            ch.close()
        self.channels.clear()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10.0)

    def wait(self, pred, timeout: float) -> bool:
        with self.cv:
            return self.cv.wait_for(pred, timeout=timeout)

    # -- the gateway's channel half ----------------------------------------

    def attach(self, node_id: str, port: int) -> "ChannelClient":
        ch = self.channels[node_id] = ChannelClient(port, relay=self, node_id=node_id)
        return ch

    def _kv_error_to(self, requester: str, fid: str, err: str) -> None:
        self.kv_stats["kv_relay_errors_total"] += 1
        ch = self.channels.get(requester)
        if ch is not None:
            ch.send({"kind": "kv_pages", "fetch_id": fid, "error": err, "done": True})

    def relay_kv_fetch(self, requester: str, frame: dict) -> None:
        from agentfield_tpu_torch.serving import channel as chmod

        fid, peer, chains = frame.get("fetch_id"), frame.get("peer"), frame.get("chains")
        if not isinstance(fid, str) or not isinstance(peer, str) or not isinstance(chains, list):
            return
        ch = self.channels.get(peer)
        if ch is None:
            self._kv_error_to(requester, fid, f"peer {peer!r} unknown or channel-less")
            return
        with self._relay_lock:
            gw_fid = f"kvr_{len(self.kv_relays) + 1}"
            self.kv_relays[gw_fid] = (requester, fid)
            self.kv_stats["kv_relay_fetches_total"] += 1
        relayed = {"kind": "kv_fetch", "fetch_id": gw_fid,
                   "chains": chains[:chmod.KV_FETCH_MAX_CHAINS],
                   "max_bytes": min(int(frame.get("max_bytes") or chmod.KV_FETCH_MAX_BYTES),
                                    chmod.KV_FETCH_MAX_BYTES)}
        if isinstance(frame.get("handoff"), str):
            relayed["handoff"] = frame["handoff"]
        ch.send(relayed)

    def relay_kv_pages(self, server: str, frame: dict) -> None:
        entry = self.kv_relays.get(frame.get("fetch_id"))
        if entry is None:
            return
        self.kv_stats["kv_relay_frames_total"] += 1
        self.channels[entry[0]].send({**frame, "fetch_id": entry[1]})

    def relay_kv_blob(self, server: str, data: bytes) -> None:
        from agentfield_tpu_torch.serving.channel import kv_blob_header, unpack_kv_blob

        parsed = unpack_kv_blob(data)
        entry = self.kv_relays.get(parsed[0]) if parsed is not None else None
        if entry is None:
            return
        self.kv_stats["kv_relay_frames_total"] += 1
        # the header rewritten, the payload passed on as it came
        self.channels[entry[0]].ws.send_binary(kv_blob_header(entry[1], parsed[1]), parsed[2])

    def execute(self, node_id: str, eid: str, payload: dict, stream: bool = False,
                timeout: float = 600.0) -> dict:
        """Send one ``generate`` execution to a node's channel; its
        terminal frame (completed, or an AssertionError)."""
        ch = self.channels[node_id]
        ch.submit(eid, payload, stream=stream)
        term = ch.terminal(eid, timeout)
        assert term["status"] == "completed", term
        return term

    def two_phase(self, eid: str, payload: dict, prefill: str, decode: str) -> dict:
        """The JAX gateway's two-phase dispatch of a token prompt: phase one
        unary to ``prefill`` with ``handoff_export``; a "handoff" terminal's
        descriptor sends phase two, streamed, to ``decode`` with it and the
        ``kv_peer`` hint that pulls the prompt's pages and the live tail; a
        declined export's result completes as it is. Returns the result,
        whether it was handed off, and the gap from the phase-1 terminal to
        the first token frame of phase two (host ms)."""
        p1 = self.execute(prefill, f"{eid}.p1", {**payload, "handoff_export": True})
        res1 = p1["result"]
        desc = res1.get("handoff")
        if res1.get("finish_reason") != "handoff":
            return {"result": res1, "handed_off": False, "gap_ms": None}
        assert isinstance(desc, dict), res1  # the stash lives 60 s: never aged out here
        ch1 = self.channels[prefill]
        t_term = ch1.arrivals[f"{eid}.p1"][ch1.frames[f"{eid}.p1"].index(p1)]
        hint = {"node_id": prefill, "pages": desc["pages"], "page_size": desc["page_size"],
                "handoff": desc["id"]}
        p2 = self.execute(decode, f"{eid}.p2", {**payload, "handoff": desc, "kv_peer": hint},
                          stream=True)
        ch2 = self.channels[decode]
        frames = ch2.frames[f"{eid}.p2"]
        k = next(j for j, f in enumerate(frames) if f["kind"] == "token")
        return {"result": p2["result"], "handed_off": True, "phase1": res1,
                "gap_ms": (ch2.arrivals[f"{eid}.p2"][k] - t_term) * 1e3,
                "tokens": channel_tokens([f for f in frames if f["kind"] != "accepted"])}


def _http(port: int, method: str, path: str, body=None, headers=None,
          timeout: float = 900.0) -> tuple[int, dict | None]:
    """One request to the node; returns (status, JSON body or None)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            raw = resp.read()
            return resp.status, json.loads(raw) if raw else None
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, json.loads(raw) if raw else None


def _sse(port: int, body: dict, on_frame=None, timeout: float = 900.0):
    """POST ``/generate/stream``; returns (data frames, host ms from the
    request to the first frame). ``on_frame(i, frame)`` runs per frame."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    t0 = time.perf_counter()
    conn.request("POST", "/generate/stream", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200, (resp.status, resp.read()[:300])
    frames, first_ms = [], None
    try:
        for line in resp:
            if not line.startswith(b"data: "):
                continue
            if first_ms is None:
                first_ms = (time.perf_counter() - t0) * 1e3
            frames.append(json.loads(line[6:]))
            if on_frame is not None:
                on_frame(len(frames) - 1, frames[-1])
            if frames[-1]["finished"]:
                break
    finally:
        conn.close()
    return frames, first_ms


def phase_api(results, state, seed: int, device: str = "cuda", model_name: str = "llama-3-8b",
              new: int = API_NEW, live_new: int = API_LIVE_NEW,
              embed_lens: tuple = API_EMBED_LENS, prompts: tuple = API_PROMPTS,
              num_pages: int = API_PAGES,
              max_pages_per_seq: int = 128, heartbeat_interval: float = 2.0):
    """The node as the control plane and the SDK call it, on the serve's
    weights (bf16 pages, decode buckets (4, 16); the shared-prefix cache
    off, so a repeated prompt runs the same shapes and its greedy tokens
    can be compared), behind a stand-in control plane. One run, counts
    reset before it:
    (a) ``Agent.ai()``'s payload (``sdk_payload``) with a prompt and with
        ``messages``: 200, greedy tokens equal to a plain request of the
        prompt and of the rendered transcript;
    (b) a prompt of ``max_context`` + 200 tokens under "truncate_left":
        ``truncated_prompt_tokens`` = its excess over ``max_context - new``
        and the explicit tail's tokens; under "error" a 4xx;
    (c) the SSE stream: its tokens equal the unary request's; TTFT at the
        first frame (host clock) against the engine's TTFT of both;
    (d) ``embed``: one prompt and a batch of ``len(embed_lens)`` prompts
        (forwards of ``api_embed_forwards``): unit norms within 1e-3, one
        ``dense_causal_attention`` launch a layer a forward, the forwards'
        device ms (CUDA events);
    (e) ``embed`` during a live SSE decode: the decode's tokens equal an
        idle run's, no failed request;
    (f) the stand-in receives the JAX-shaped registration, heartbeats with
        the engine's stats (``latency_hist`` counts > 0 after (a)-(c)), a
        tracked request's (202) "completed" callback, and at stop a
        "stopping" heartbeat and the deregistration.
    After the counts are read: the batch's embeddings in one forward
    through ``attn_impl="ref"``, their cosine to the kernel's at least
    ``API_COSINE_MIN`` on the card (the plain version itself on the CPU);
    and the kernel's one forward against the node's chunked forwards (its
    rows back in their order), a cosine at least ``API_COSINE_MIN`` too.
    The kernel itself is held element by element at these shapes in
    ``phase_check``."""
    import numpy as np
    import torch

    from agentfield_tpu_torch.ops.cuda import ragged_paged_attention as rpa
    from agentfield_tpu_torch.serving.channel import STAT_KEYS as CHANNEL_STAT_KEYS
    from agentfield_tpu_torch.serving.engine import EngineConfig
    from agentfield_tpu_torch.serving.model_node import (
        GRAMMAR_SLOTS,
        ModelBackend,
        ModelNodeServer,
        embed_rows,
    )
    from agentfield_tpu_torch.serving.tokenizer import ByteTokenizer

    params, cfg = state["params"], state["cfg"]
    V = cfg.vocab_size
    on_card = torch.device(device).type == "cuda"
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    rng = np.random.default_rng(seed + 31)
    n_prompt, n_user, n_sse, n_live, n_single = prompts

    def text(n: int) -> str:  # ASCII letters: one byte-tokenizer token each
        return "".join(chr(c) for c in rng.integers(97, 123, n))

    ecfg = EngineConfig(max_batch=16, page_size=16, num_pages=num_pages,
                        max_pages_per_seq=max_pages_per_seq, decode_buckets=(4, 16),
                        shared_prefix_cache=False, grammar_slots=GRAMMAR_SLOTS)
    max_ctx = ecfg.max_context
    cp = StandInControlPlane()
    cp_url = cp.start()
    backend = ModelBackend(params, cfg, ecfg, tokenizer=ByteTokenizer(V), seed=seed,
                           model_name=model_name, device=device)
    server = ModelNodeServer(backend, node_id="api-node", control_plane=cp_url,
                             heartbeat_interval=heartbeat_interval)
    out: dict = {"max_context": max_ctx, "new": new}
    port = server.start()
    try:
        rpa.reset_launches()  # this phase's main path only
        t_main = time.perf_counter()

        def gen(payload):
            st, doc = _http(port, "POST", "/reasoners/generate", {"input": payload})
            assert st == 200, (st, doc)
            return doc["result"]

        # (a) the SDK's payload, with a prompt and with messages
        msgs = [{"role": "system", "content": "Answer tersely."},
                {"role": "user", "content": text(n_user)}]
        user_prompt = text(n_prompt)
        a_prompt = gen(sdk_payload(prompt=user_prompt, max_new_tokens=new))
        a_msgs = gen(sdk_payload(messages=msgs, max_new_tokens=new))
        plain_prompt = gen({"prompt": user_prompt, "max_new_tokens": new})
        plain_msgs = gen({"prompt": backend.apply_chat_template(msgs), "max_new_tokens": new})
        assert len(a_prompt["tokens"]) == new and a_prompt["finish_reason"] == "length"
        assert a_prompt["tokens"] == plain_prompt["tokens"], "SDK payload != plain prompt"
        assert a_msgs["tokens"] == plain_msgs["tokens"], "messages != rendered transcript"
        assert "truncated_prompt_tokens" not in a_prompt
        # (b) an over-long prompt
        long = rng.integers(1, V, max_ctx + 200).tolist()
        budget = max_ctx - new
        b_trunc = gen(sdk_payload(tokens=long, max_new_tokens=new))
        b_tail = gen({"tokens": long[-budget:], "max_new_tokens": new})
        assert b_trunc["truncated_prompt_tokens"] == len(long) - budget, b_trunc.get(
            "truncated_prompt_tokens")
        assert b_trunc["tokens"] == b_tail["tokens"], "truncated != explicit tail"
        b_err, b_err_doc = _http(port, "POST", "/reasoners/generate", {
            "input": sdk_payload(tokens=long, max_new_tokens=new, context_overflow="error")})
        assert 400 <= b_err < 500, (b_err, b_err_doc)
        out["b"] = {"prompt": len(long), "truncated_prompt_tokens":
                    b_trunc["truncated_prompt_tokens"], "error_status": b_err}
        # (c) the token stream against the unary request
        sse_prompt = text(n_sse)
        unary = gen({"prompt": sse_prompt, "max_new_tokens": new})
        ttft_unary = backend.engine.ttft_ms[-1]
        frames, first_ms = _sse(port, {"prompt": sse_prompt, "max_new_tokens": new})
        ttft_stream = backend.engine.ttft_ms[-1]
        streamed = [f["token"] for f in frames if f["token"] >= 0]
        assert streamed == unary["tokens"], "SSE tokens != unary tokens"
        assert frames[-1]["finish_reason"] == "length" and sum(f["finished"] for f in frames) == 1
        out["c"] = {"first_frame_ms": first_ms, "engine_ttft_ms_stream": ttft_stream,
                    "engine_ttft_ms_unary": ttft_unary}
        t_c = time.perf_counter()
        # (d) embed: one prompt and a batch
        d0 = rpa.LAUNCHES["dense_causal_attention"]
        st, single = _http(port, "POST", "/reasoners/embed", {"input": {"prompt": text(n_single)}})
        assert st == 200, single
        batch_prompts = [text(n) for n in embed_lens]
        n_ms = len(backend.embed_ms)
        st, batch = _http(port, "POST", "/reasoners/embed", {"input": {"prompts": batch_prompts}})
        assert st == 200, batch
        embed_launches = rpa.LAUNCHES["dense_causal_attention"] - d0
        batch_ms = list(backend.embed_ms)[n_ms:]
        forwards = api_embed_forwards(embed_lens, n_single)
        single, batch = single["result"], batch["result"]
        vecs = [single["embedding"]] + batch["embeddings"]
        norms = [float(np.linalg.norm(v)) for v in vecs]
        assert all(abs(n - 1.0) <= 1e-3 for n in norms), norms
        assert all(np.isfinite(v).all() for v in vecs)
        assert single["dim"] == cfg.hidden_size and batch["tokens_used"] == list(embed_lens)
        if on_card:
            assert embed_launches == len(forwards) * cfg.num_layers, embed_launches
            assert len(batch_ms) == len(forwards) - 1, batch_ms
        out["d"] = {"norm_max_dev": max(abs(n - 1.0) for n in norms),
                    "dense_launches": embed_launches, "forwards": forwards,
                    "batch_chunk_ms": batch_ms, "batch_ms": sum(batch_ms)}
        # (e) embed while a decode streams
        live_prompt = text(n_live)
        idle = gen({"prompt": live_prompt, "max_new_tokens": live_new})
        started, seen, arrivals = threading.Event(), {}, []

        def on_frame(i, frame):
            arrivals.append(time.perf_counter())
            seen["n"] = i + 1
            started.set()

        live: dict = {}

        def stream_live():
            try:
                live["frames"], _ = _sse(port, {"prompt": live_prompt,
                                               "max_new_tokens": live_new}, on_frame)
            except BaseException as e:  # noqa: BLE001 — failed below
                live["error"] = repr(e)
                started.set()

        th = threading.Thread(target=stream_live)
        th.start()
        assert started.wait(600), "the live stream never started"
        st, during = _http(port, "POST", "/reasoners/embed", {"input": {"prompts": batch_prompts}})
        frames_at_embed_end = seen.get("n", 0)
        th.join()
        assert "error" not in live, live
        assert st == 200, during
        live_tokens = [f["token"] for f in live["frames"] if f["token"] >= 0]
        assert frames_at_embed_end < live_new, "the decode ended before the embed: no overlap"
        assert live_tokens == idle["tokens"], "an embed during the decode changed its tokens"
        gaps = [(b - a) * 1e3 for a, b in zip(arrivals, arrivals[1:])]
        out["e"] = {"frames_when_embed_returned": frames_at_embed_end, "live_new": live_new,
                    "max_frame_gap_ms": max(gaps), "median_frame_gap_ms": statistics.median(gaps)}
        # (f) a tracked request: 202 now, the outcome posted back
        eid = "exec-api-0"
        st, _ = _http(port, "POST", "/reasoners/generate",
                      {"input": {"prompt": user_prompt, "max_new_tokens": new},
                       "execution_id": eid}, headers={"X-Execution-ID": eid})
        assert st == 202, st
        assert cp.wait(lambda: eid in cp.statuses, 600), "no status callback"
        cb = cp.statuses[eid]
        assert cb["status"] == "completed", cb
        assert cb["result"]["tokens"] == plain_prompt["tokens"]
        main_s = time.perf_counter() - t_main
        # two heartbeats at least, one after (a)-(c) with its histograms counted
        assert cp.wait(lambda: len(cp.heartbeats) >= 2
                       and any(t > t_c for t, _, _ in cp.heartbeats),
                       6 * heartbeat_interval + 10), "no heartbeat after (c)"
        launches = rpa.launch_counts()  # the main path's, read now
    finally:
        server.stop()
        cp.stop()
    eng = backend.engine
    # (f) what the control plane saw
    assert len(cp.specs) == 1, cp.specs
    spec = cp.specs[0]
    assert spec["node_id"] == "api-node" and spec["kind"] == "model"
    assert spec["base_url"] == f"http://127.0.0.1:{port}"
    assert spec["metadata"] == {"model": model_name, "modalities": ["text"], "role": "mixed",
                                "channel": True}
    props = {r["id"]: tuple(r["input_schema"]["properties"]) for r in spec["reasoners"]}
    assert props == {"generate": JAX_GENERATE_PROPS, "embed": JAX_EMBED_PROPS}, props
    beats = [b for _, _, b in cp.heartbeats if "stats" in b]
    assert len(beats) >= 2, f"{len(beats)} heartbeats"
    want = (set(eng.stats) | set(eng.grammar_bank_stats()) | set(eng.prefix_cache_stats())
            | set(eng.scheduler_stats()) | set(HEARTBEAT_KEYS) | set(CHANNEL_STAT_KEYS))
    for b in beats:
        assert set(b["stats"]) == want, set(b["stats"]) ^ want
    last = [b for t, _, b in cp.heartbeats if t > t_c and "stats" in b][-1]["stats"]
    hist_counts = {k: v["count"] for k, v in last["latency_hist"].items()}
    assert all(n > 0 for n in hist_counts.values()), hist_counts
    assert [b.get("status") for _, _, b in cp.heartbeats][-1] == "stopping"
    assert cp.deleted == ["api-node"] and not cp.nodes
    assert not any(t.name == "heartbeat" and t.is_alive() for t in threading.enumerate())
    if on_card:  # both hand kernels, each of their paths, on this phase's main path
        for key in ("ragged_paged_attention", "dense_causal_attention", "ragged_decode_split",
                    "ragged_decode_combine", "ragged_tiles_tc"):
            assert launches[key] > 0, f"{key} was not launched by the api phase"
    # after the counts: the batch through the plain attention
    rows = [ByteTokenizer(V).encode(p) for p in batch_prompts]
    v_kernel = embed_rows(params, cfg, rows)
    v_ref = embed_rows(params, cfg, rows, attn_impl="ref")
    cosine = (v_kernel * v_ref).sum(-1).min().item()
    assert cosine >= API_COSINE_MIN, f"embed kernel vs plain cosine {cosine}"
    cosine_chunked = (v_kernel.cpu() * torch.tensor(batch["embeddings"])).sum(-1).min().item()
    assert cosine_chunked >= API_COSINE_MIN, f"one forward vs chunks cosine {cosine_chunked}"
    out.update({
        # device ms of every embed forward: (d) single, (d) batch, (e) batch
        "embed_device_ms": list(backend.embed_ms),
        "launches": launches, "main_s": main_s, "heartbeats": len(beats),
        "latency_hist_counts": hist_counts, "embed_cosine_min": cosine,
        "embed_cosine_chunked_min": cosine_chunked,
        "graphs": eng.graph_stats(),
    })
    results["api"] = out
    card = results.get("card", "no card")
    log(f"[api] {card}: (a) SDK payload and messages = plain prompts ({new} tokens); (b) "
        f"{len(long)}-token prompt truncated by {out['b']['truncated_prompt_tokens']} = explicit "
        f"tail, 'error' -> {b_err}; (c) SSE = unary, first frame {first_ms:.1f} ms host "
        f"(engine TTFT stream {ttft_stream:.1f} / unary {ttft_unary:.1f} ms); (d) embed norms "
        f"within {out['d']['norm_max_dev']:.2e} of 1, {embed_launches} dense launches over "
        f"forwards (rows, length) {forwards}, the batch {out['d']['batch_ms']:.1f} device ms "
        f"(chunks {batch_ms}; every forward {out['embed_device_ms']}), kernel vs plain cosine "
        f">= {cosine:.6f} (one forward vs the node's chunks {cosine_chunked:.6f}); (e) embed returned after {frames_at_embed_end} of {live_new} "
        f"frames, frame gap max {out['e']['max_frame_gap_ms']:.1f} ms (median "
        f"{out['e']['median_frame_gap_ms']:.1f}), tokens = idle run; "
        f"(f) {len(beats)} heartbeats, latency_hist counts {hist_counts}, tracked 202 completed; "
        f"main path {main_s:.1f} s, launches {launches}")


CHANNEL_PROMPTS = (64, 200, 333, 480, 700, 1000, 1200, 1500)  # (a): 8 at once
CHANNEL_NEW = 64
CHANNEL_LONG_NEW = 256  # (b) the reattach, (c) the cancel
CHANNEL_DRAIN_NEW = 400  # (f) the streams open at stop()
CHANNEL_GRACE_S = 1.0
CHANNEL_PAGES = 1024
# the hand-written kernels a served request runs, as the profiler names them
CHANNEL_KERNELS = ("decode_split_kernel", "decode_combine_kernel", "tc_tile_kernel")
CHANNEL_WATERFALL = ("node.generate", "engine.queue_wait", "engine.prefill", "engine.decode")
# the keys of a flight-recorder row of the JAX engine (``step()``; a mixed
# tick adds ``budget_util``); tests/test_torch_tracing.py holds both engines'
# rows to them
JAX_FLIGHT_KEYS = frozenset({
    "t", "mode", "dur_ms", "active", "pending", "jobs", "events", "finished", "tokens",
    "free_pages", "host_pages", "preemptions_total", "shed_pending_deadline_total",
    "deadline_exceeded"})


class ChannelClient:
    """The gateway's side of one channel connection, over the port's
    WebSocket client: a reader thread files the node's frames by execution,
    with their host arrival times, and hands its KV frames (``kv_fetch``,
    ``kv_pages``, page blobs) to ``relay`` (a ``StandInControlPlane``) as
    coming from ``node_id``."""

    def __init__(self, port: int, relay=None, node_id: str | None = None):
        from agentfield_tpu_torch.serving.websocket import connect

        self.ws = connect("127.0.0.1", port, "/channel")
        self.relay, self.node_id = relay, node_id
        self.frames: dict[str, list[dict]] = {}
        self.arrivals: dict[str, list[float]] = {}
        self.sent: dict[str, float] = {}
        self.cv = threading.Condition()
        self.thread = threading.Thread(target=self._read, daemon=True, name="channel-client")
        self.thread.start()

    def _read(self):
        from agentfield_tpu_torch.serving.websocket import OP_TEXT

        while (msg := self.ws.recv()) is not None:
            if msg[0] != OP_TEXT:  # a page blob on its way to the fetching node
                if self.relay is not None:
                    self.relay.relay_kv_blob(self.node_id, msg[1])
                continue
            frame, t = json.loads(msg[1]), time.perf_counter()
            if self.relay is not None and frame.get("kind") in ("kv_fetch", "kv_pages"):
                relay = (self.relay.relay_kv_fetch if frame["kind"] == "kv_fetch"
                         else self.relay.relay_kv_pages)
                relay(self.node_id, frame)
                continue
            eid = frame.get("exec_id")
            if eid is None:
                continue  # a pong
            with self.cv:
                self.frames.setdefault(eid, []).append(frame)
                self.arrivals.setdefault(eid, []).append(t)
                self.cv.notify_all()

    def send(self, frame: dict) -> None:
        self.ws.send_text(json.dumps(frame))

    def submit(self, eid: str, payload: dict, stream: bool = True, trace=None) -> None:
        frame = {"kind": "submit", "exec_id": eid, "target": "generate", "input": payload,
                 "headers": {}, "stream": stream}
        if trace is not None:
            frame["trace"] = trace  # the gateway sends it in the input too
        self.sent[eid] = time.perf_counter()
        self.send(frame)

    def count(self, eid: str, kind: str) -> int:
        return sum(f.get("kind") == kind for f in self.frames.get(eid, ()))

    def wait(self, pred, timeout: float = 600.0) -> None:
        with self.cv:
            assert self.cv.wait_for(pred, timeout), "channel: no frame in time"

    def terminal(self, eid: str, timeout: float = 600.0) -> dict:
        self.wait(lambda: self.count(eid, "terminal") > 0, timeout)
        return next(f for f in self.frames[eid] if f["kind"] == "terminal")

    def close(self) -> None:
        self.ws.close()
        self.thread.join(30)
        self.ws.release()


def channel_tokens(frames: list[dict]) -> list[int]:
    """An execution's streamed content tokens, after checking its frames:
    seq 1, 2, ... over token and terminal frames, exactly one terminal,
    last, whose result holds the same tokens."""
    seqs = [f["seq"] for f in frames if "seq" in f]
    assert seqs == list(range(1, len(seqs) + 1)), f"seq not rising by one: {seqs}"
    terms = [f for f in frames if f["kind"] == "terminal"]
    assert len(terms) == 1 and frames[-1] is terms[0], [f["kind"] for f in frames]
    assert terms[0]["status"] == "completed", terms[0]
    toks = [f["data"]["token"] for f in frames if f["kind"] == "token"
            and f["data"]["token"] >= 0
            and not (f["data"]["finished"] and f["data"]["finish_reason"] == "stop")]
    assert toks == terms[0]["result"]["tokens"], "streamed tokens != the terminal's result"
    return toks


def held_burst(backend, submits) -> None:
    """Send ``submits`` (one request each) while the engine's drive thread
    is held between two ticks, each landing in the pending queue before the
    next goes; then let the engine run. The engine then schedules the same
    queue the same way whatever transport carried it, so greedy tokens of
    the same payloads compare exactly (bf16 rounds with the batch)."""
    gate, held = threading.Event(), threading.Event()

    def hold():
        held.set()
        gate.wait(600)

    holder = threading.Thread(target=backend._on_engine_thread, args=(hold,), daemon=True)
    holder.start()
    assert held.wait(600), "the drive thread never took the hold"
    try:
        for i, send in enumerate(submits):
            send()
            t0 = time.monotonic()
            while len(backend.engine.pending) < i + 1:
                assert time.monotonic() - t0 < 120, "a request never reached the queue"
                time.sleep(0.0005)
    finally:
        gate.set()
        holder.join(600)


def _wait_idle(backend, timeout: float = 600.0) -> None:
    """Until the node's engine holds no work and no stream is open. The
    engine is asked on its drive thread, between two ticks: inside a tick a
    request mid-prefill is neither pending nor in a slot, so another
    thread would read no work (an internal speculative job has no stream
    to show it either)."""
    t0 = time.monotonic()
    while backend._on_engine_thread(backend.engine.has_work) or backend._streams:
        assert time.monotonic() - t0 < timeout, "the engine never went idle"
        time.sleep(0.005)


def phase_channel(results, state, seed: int, device: str = "cuda",
                  model_name: str = "llama-3-8b", prompts: tuple = CHANNEL_PROMPTS,
                  new: int = CHANNEL_NEW, long_new: int = CHANNEL_LONG_NEW,
                  drain_new: int = CHANNEL_DRAIN_NEW, grace_s: float = CHANNEL_GRACE_S,
                  num_pages: int = CHANNEL_PAGES, max_pages_per_seq: int = 128):
    """The node's gateway channel, request traces and drain on the serve's
    weights (bf16 pages, decode buckets (4, 16), the shared-prefix cache off,
    as ``phase_api``), the gateway played by the port's WebSocket client
    (``ChannelClient``). One run, counts reset before it and read after
    the node's stop:
    (a) ``len(prompts)`` streamed ``generate`` executions over one socket
        (``new`` greedy tokens each): each one terminal, seq rising by one,
        its tokens equal to the same payload's unary channel execution and
        direct ``POST /reasoners/generate`` (each mode sent as a
        ``held_burst``); the first token frame's host ms (from the submit
        frame) against the engine's TTFT of the same execution (its
        queue-wait and prefill spans);
    (b) a ``long_new``-token execution whose socket closes after 3 token
        frames, reattached on a new one with the last seq seen: nothing
        lost or repeated (its tokens equal the unary run's), one terminal,
        the reattach counter up; an unknown id gets ``reattach_fail``;
    (c) ``cancel`` mid-stream: terminal failed "cancelled by gateway",
        ``active_slots`` and ``free_pages`` back to their earlier values;
    (d) a traced execution's terminal carries ``CHANNEL_WATERFALL`` in
        wall-clock order, stamped with the node and attempt; the decode
        step's device ms (CUDA events) and the engine tick's host ms (the
        flight recorder's decode rows) with tracing on and off, the same
        burst each; ``/debug/flight`` rows with the JAX keys;
    (e) a ``/profile`` capture around 2 requests: the Chrome trace's events
        of ``CHANNEL_KERNELS`` beside the attention launch counters over
        the same window;
    (f) a ``drain_new``-token SSE stream and channel execution open at
        ``server.stop(grace_s)``: both get a terminal, a request during the
        drain gets 503, ``stop`` returns within the grace plus 10 s with
        the engine empty."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from agentfield_tpu_torch import tracing
    from agentfield_tpu_torch.ops.cuda import ragged_paged_attention as rpa
    from agentfield_tpu_torch.serving.channel import CANCELLED
    from agentfield_tpu_torch.serving.engine import EngineConfig
    from agentfield_tpu_torch.serving.model_node import (
        GRAMMAR_SLOTS,
        ModelBackend,
        ModelNodeServer,
    )
    from agentfield_tpu_torch.serving.tokenizer import ByteTokenizer

    params, cfg = state["params"], state["cfg"]
    on_card = torch.device(device).type == "cuda"
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    rng = np.random.default_rng(seed + 41)

    def text(n: int) -> str:  # ASCII letters: one byte-tokenizer token each
        return "".join(chr(c) for c in rng.integers(97, 123, n))

    ecfg = EngineConfig(max_batch=16, page_size=16, num_pages=num_pages,
                        max_pages_per_seq=max_pages_per_seq, decode_buckets=(4, 16),
                        shared_prefix_cache=False, grammar_slots=GRAMMAR_SLOTS)
    backend = ModelBackend(params, cfg, ecfg, tokenizer=ByteTokenizer(cfg.vocab_size),
                           seed=seed, model_name=model_name, device=device)
    server = ModelNodeServer(backend, node_id="channel-node")
    port = server.start()
    eng = backend.engine
    out: dict = {"prompts": list(prompts), "new": new}
    trace_dir = tempfile.mkdtemp(prefix="channel_profile_")
    client = ChannelClient(port)
    stopped = False
    try:
        rpa.reset_launches()  # this phase's main path only
        t_main = time.perf_counter()
        # (a) streamed, unary over the channel, direct POST: the same queue
        payloads = [{"prompt": text(n), "max_new_tokens": new} for n in prompts]
        ctxs = [{"trace_id": f"tr_chan_a{i}", "attempt": 1, "node": "channel-node"}
                for i in range(len(prompts))]
        held_burst(backend, [
            functools.partial(client.submit, f"a{i}", {**p, "trace": ctxs[i]}, True, ctxs[i])
            for i, p in enumerate(payloads)])
        streamed = []
        for i in range(len(prompts)):
            client.terminal(f"a{i}")
            streamed.append(channel_tokens(client.frames[f"a{i}"]))
        held_burst(backend, [functools.partial(client.submit, f"u{i}", p, False)
                             for i, p in enumerate(payloads)])
        unary = [client.terminal(f"u{i}") for i in range(len(prompts))]
        assert all(client.count(f"u{i}", "token") == 0 for i in range(len(prompts)))
        posted: dict = {}

        def post(i, p):
            th = threading.Thread(target=lambda: posted.__setitem__(
                i, _http(port, "POST", "/reasoners/generate", {"input": p})))
            th.start()
            posted.setdefault("threads", []).append(th)

        held_burst(backend, [functools.partial(post, i, p) for i, p in enumerate(payloads)])
        for th in posted.pop("threads"):
            th.join(600)
        for i in range(len(prompts)):
            assert unary[i]["status"] == "completed", unary[i]
            st, doc = posted[i]
            assert st == 200, (st, doc)
            assert len(streamed[i]) == new, (i, len(streamed[i]))
            assert streamed[i] == unary[i]["result"]["tokens"] == doc["result"]["tokens"], (
                f"execution {i}: streamed, unary and POST tokens differ")
        first_ms, ttft_ms = [], []
        for i in range(len(prompts)):
            eid = f"a{i}"
            k = next(j for j, f in enumerate(client.frames[eid]) if f["kind"] == "token")
            first_ms.append((client.arrivals[eid][k] - client.sent[eid]) * 1e3)
            spans = {s["name"]: s for s in client.terminal(eid)["trace"]["spans"]}
            ttft_ms.append(spans["engine.queue_wait"]["dur_ms"] + spans["engine.prefill"]["dur_ms"])
        out["a"] = {"first_frame_ms": first_ms, "engine_ttft_ms": ttft_ms,
                    "over_ttft_ms": [f - t for f, t in zip(first_ms, ttft_ms)]}
        _wait_idle(backend)
        # (b) a reattach after the socket drops mid-stream
        long_payload = {"prompt": text(prompts[1]), "max_new_tokens": long_new}
        client.submit("b_ref", long_payload, stream=False)
        ref = client.terminal("b_ref")["result"]["tokens"]
        reattaches = server.channel.stats_snapshot()["channel_server_reattaches_total"]
        drop = ChannelClient(port)
        drop.submit("b", long_payload)
        drop.wait(lambda: drop.count("b", "token") >= 3)
        drop.ws.abort()  # the link dies: no close handshake
        drop.thread.join(30)
        drop.ws.release()
        before = list(drop.frames["b"])
        last_seq = max(f.get("seq", 0) for f in before)
        again = ChannelClient(port)
        again.send({"kind": "reattach", "exec_id": "b", "last_seq": last_seq})
        again.send({"kind": "reattach", "exec_id": "no-such-execution", "last_seq": 0})
        again.terminal("b")
        again.wait(lambda: again.count("no-such-execution", "reattach_fail") == 1)
        after = again.frames["b"]
        assert after[0] == {"kind": "reattach_ok", "exec_id": "b", "from_seq": last_seq}, after[0]
        b_tokens = channel_tokens([f for f in before if f["kind"] != "accepted"] + after[1:])
        assert b_tokens == ref, "the reattach lost or repeated tokens"
        assert (server.channel.stats_snapshot()["channel_server_reattaches_total"]
                == reattaches + 1)
        again.close()
        out["b"] = {"frames_before_drop": len(before) - 1, "last_seq": last_seq,
                    "replayed": len(after) - 1, "tokens": len(b_tokens)}
        _wait_idle(backend)
        # (c) cancel mid-stream frees the slot and its pages
        free0, active0 = eng.allocator.free_pages, eng.num_active
        client.submit("c", {"prompt": text(prompts[2]), "max_new_tokens": long_new})
        client.wait(lambda: client.count("c", "token") >= 3)
        client.send({"kind": "cancel", "exec_id": "c"})
        term = client.terminal("c")
        assert (term["status"], term["error"]) == ("failed", CANCELLED), term
        _wait_idle(backend)
        assert (eng.allocator.free_pages, eng.num_active) == (free0, active0), (
            eng.allocator.free_pages, free0)
        out["c"] = {"tokens_before_cancel": client.count("c", "token"), "free_pages": free0}
        # (d) a traced execution's waterfall; tracing on and off
        ctx = {"trace_id": tracing.new_trace_id(), "attempt": 1, "node": "channel-node"}
        client.submit("d", {"prompt": text(prompts[3]), "max_new_tokens": new, "trace": ctx},
                      trace=ctx)
        term = client.terminal("d")
        spans = sorted(term["trace"]["spans"], key=lambda s: (s["t0"], -s["dur_ms"]))
        assert term["trace"]["trace_id"] == ctx["trace_id"]
        assert [s["name"] for s in spans] == list(CHANNEL_WATERFALL), [s["name"] for s in spans]
        assert all(s["node"] == "channel-node" and s["attempt"] == 1 for s in spans)
        timing = {}
        for mode in ("on", "off", "off", "on"):  # in turns
            n0, f0 = len(eng.decode_step_ms), eng.flight.ticks_recorded
            tag = f"d_{mode}{len(timing.get(mode, ()))}"
            sub = []
            for i, n in enumerate(prompts[:4]):
                c = ({"trace_id": tracing.new_trace_id(), "attempt": 1, "node": "channel-node"}
                     if mode == "on" else None)
                p = {"prompt": text(n), "max_new_tokens": new, **({"trace": c} if c else {})}
                sub.append(functools.partial(client.submit, f"{tag}_{i}", p, True, c))
            held_burst(backend, sub)
            for i in range(len(sub)):
                client.terminal(f"{tag}_{i}")
            _wait_idle(backend)
            n_rows = eng.flight.ticks_recorded - f0
            rows = eng.flight.snapshot()[-n_rows:] if n_rows else []
            timing.setdefault(mode, []).append({
                "device_ms": list(eng.decode_step_ms)[n0:],
                "tick_ms": [r["dur_ms"] for r in rows if r["mode"] == "decode"]})
        flight_status, flight = _http(port, "GET", "/debug/flight?last=16")
        assert flight_status == 200 and len(flight["ticks"]) == 16
        assert set(flight) == {"node_id", "max_ticks", "ticks_recorded", "trace_buffer_spans",
                               "trace_spans_dropped", "ticks"}, set(flight)
        for r in flight["ticks"]:
            want = JAX_FLIGHT_KEYS | ({"budget_util"} if r["mode"] == "mixed" else set())
            assert set(r) == want, set(r) ^ want

        def mean(xs):
            return statistics.fmean(xs) if xs else float("nan")

        out["d"] = {
            mode: {"device_ms_per_step": mean([x for w in ws for x in w["device_ms"]]),
                   "tick_ms_decode": mean([x for w in ws for x in w["tick_ms"]]),
                   "steps": sum(len(w["device_ms"]) for w in ws)}
            for mode, ws in timing.items()}
        out["d"]["flight_dur_ms_decode_median"] = statistics.median(
            [r["dur_ms"] for r in flight["ticks"] if r["mode"] == "decode"] or [float("nan")])
        # (e) a profiler capture around 2 requests
        c0 = rpa.launch_counts()
        st, doc = _http(port, "POST", "/profile/start", {"dir": trace_dir})
        assert (st, doc) == (200, {"tracing": True, "dir": trace_dir}), (st, doc)
        for i, n in enumerate(prompts[1:3]):
            client.submit(f"e{i}", {"prompt": text(n), "max_new_tokens": new}, stream=False)
        for i in range(2):
            client.terminal(f"e{i}")
        st, doc = _http(port, "POST", "/profile/stop", {})
        assert st == 200 and doc["tracing"] is False, (st, doc)
        c1 = rpa.launch_counts()
        with open(doc["file"]) as f:
            events = json.load(f)["traceEvents"]
        kernel_events = {k: sum(1 for e in events if k in str(e.get("name", "")))
                         for k in CHANNEL_KERNELS}
        graph_launches = sum(1 for e in events if e.get("name") == "cudaGraphLaunch")
        window = {k: c1[k] - c0[k] for k in ("ragged_decode_split", "ragged_decode_combine",
                                            "ragged_tiles_tc", "dense_causal_attention",
                                            "ragged_paged_attention")}
        out["e"] = {"kernel_events": kernel_events, "launch_counters": window,
                    "cudaGraphLaunch_events": graph_launches, "events": len(events),
                    "trace_bytes": os.path.getsize(doc["file"])}
        if on_card:
            assert kernel_events["tc_tile_kernel"] > 0, kernel_events
        # (f) drain with a stream and a channel execution open
        sse_frames: list = []
        sse_err: dict = {}

        def sse():
            try:
                frames, _ = _sse(port, {"prompt": text(prompts[2]), "max_new_tokens": drain_new},
                                 lambda i, fr: sse_frames.append(fr))
            except BaseException as e:  # noqa: BLE001 — failed below
                sse_err["e"] = repr(e)

        sse_th = threading.Thread(target=sse)
        sse_th.start()
        client.submit("f", {"prompt": text(prompts[3]), "max_new_tokens": drain_new})
        client.wait(lambda: client.count("f", "token") >= 1 and len(sse_frames) >= 1)
        summary: dict = {}
        t_stop = time.perf_counter()
        stopper = threading.Thread(target=lambda: summary.update(server.stop(grace_s)))
        stopper.start()
        stopped = True
        t0 = time.monotonic()
        while not backend._draining:
            assert time.monotonic() - t0 < 30
            time.sleep(0.001)
        late, late_doc = _http(port, "POST", "/reasoners/generate",
                               {"input": {"prompt": "late", "max_new_tokens": 4}})
        assert late == 503, (late, late_doc)
        stopper.join(grace_s + 60)
        stop_s = time.perf_counter() - t_stop
        sse_th.join(60)
        assert not stopper.is_alive() and not sse_th.is_alive() and "e" not in sse_err, sse_err
        assert stop_s <= grace_s + 10, stop_s
        f_term = client.terminal("f", timeout=30)
        assert f_term["status"] == "completed", f_term
        assert sum(f["finished"] for f in sse_frames) == 1 and sse_frames[-1]["finished"]
        assert not eng.has_work()
        out["f"] = {"stop_s": stop_s, "summary": summary,
                    "sse_finish": sse_frames[-1]["finish_reason"],
                    "channel_finish": f_term["result"]["finish_reason"],
                    "sse_tokens": sum(f["token"] >= 0 for f in sse_frames),
                    "channel_tokens": client.count("f", "token"), "late_status": late}
        main_s = time.perf_counter() - t_main
        launches = rpa.launch_counts()  # the main path's, read now
    finally:
        client.close()
        if not stopped:
            server.stop(grace_s)
        shutil.rmtree(trace_dir, ignore_errors=True)
    if on_card:  # both hand kernels, each of their paths, on this phase's main path
        for key in ("ragged_paged_attention", "dense_causal_attention", "ragged_decode_split",
                    "ragged_decode_combine", "ragged_tiles_tc"):
            assert launches[key] > 0, f"{key} was not launched by the channel phase"
    assert not any(t.name.startswith("channel-") and t.is_alive()
                   for t in threading.enumerate()), "a channel thread outlived the node"
    out.update({"launches": launches, "main_s": main_s,
                "channel_stats": server.channel.stats_snapshot(), "graphs": eng.graph_stats()})
    results["channel"] = out
    card = results.get("card", "no card")
    a, d, e, f = out["a"], out["d"], out["e"], out["f"]
    log(f"[channel] {card}: (a) {len(prompts)} streamed = unary = POST ({new} tokens each), "
        f"first token frame host ms p50 {statistics.median(a['first_frame_ms']):.2f} against "
        f"the engine's TTFT p50 {statistics.median(a['engine_ttft_ms']):.2f} (frame - TTFT "
        f"{min(a['over_ttft_ms']):.2f}..{max(a['over_ttft_ms']):.2f} ms); (b) socket dropped "
        f"after {out['b']['frames_before_drop']} frames, reattach replayed "
        f"{out['b']['replayed']}, {out['b']['tokens']} tokens = unary, unknown id refused; "
        f"(c) cancel after {out['c']['tokens_before_cancel']} frames, slot and "
        f"{out['c']['free_pages']} free pages back; (d) waterfall {list(CHANNEL_WATERFALL)}, "
        f"decode step device ms tracing on {d['on']['device_ms_per_step']:.3f} / off "
        f"{d['off']['device_ms_per_step']:.3f}, engine tick host ms on "
        f"{d['on']['tick_ms_decode']:.3f} / off {d['off']['tick_ms_decode']:.3f}, flight "
        f"dur_ms p50 {d['flight_dur_ms_decode_median']:.3f}; (e) profile: kernel events "
        f"{e['kernel_events']}, cudaGraphLaunch {e['cudaGraphLaunch_events']}, launch counters "
        f"{e['launch_counters']}; (f) stop({grace_s}) in {f['stop_s']:.2f} s: SSE "
        f"{f['sse_finish']} after {f['sse_tokens']} tokens, channel {f['channel_finish']} "
        f"after {f['channel_tokens']}, drain {f['summary']}, late request {f['late_status']}; "
        f"main path {main_s:.1f} s, launches {launches}")


# the cluster phase: two nodes of one fleet on the card (the serve's weights
# shared), their KV crossing over the stand-in gateway's relay
CLUSTER_A_PROMPTS = 4
CLUSTER_A_PROMPT = 1536  # 96 pages of 16: 192 MiB of bf16 KV at Llama-3-8B width
CLUSTER_A_SUFFIX = 32
CLUSTER_A_NEW = 16
CLUSTER_B_PROMPTS = (200, 385, 571, 757, 942, 1128, 1314, 1500)
CLUSTER_B_NEW = 64
CLUSTER_D = dict(prompt=600, cand=96, tool=24, new=16)  # the keep-warm chain's sizes
CLUSTER_PAGES = 1024  # 2 GiB of bf16 KV a node
CLUSTER_RESTORE_BYTES = 1 << 30  # pinned host memory a node's fetched pages wait in
CLUSTER_FETCH_BYTES = 256 << 20  # a fetch's byte cap ($AGENTFIELD_KV_FETCH_MAX_BYTES)
CLUSTER_SKETCH_BYTES = 16384  # the heartbeat sketch's cap: 858 digests
CLUSTER_STALL_S = 1.0
CLUSTER_FETCH_TIMEOUT_S = 0.25  # the fetching node's timeout under the stall faults


def affinity_pages(sketch: dict, tokens: list[int], page_size: int) -> int:
    """The JAX gateway's affinity walk: how many leading pages of the
    prompt's matchable prefix (minus its last token) a node's heartbeat
    sketch advertises, to the first gap."""
    from agentfield_tpu_torch.prefix_hash import page_chain_hashes, sketch_digest

    digests = set(sketch["digests"])
    n = 0
    for h in page_chain_hashes(tokens[: len(tokens) - 1], page_size):
        if sketch_digest(h) not in digests:
            break
        n += 1
    return n


def first_frame_ms(ch: "ChannelClient", eid: str) -> float:
    """Host ms from a streamed execution's submit to its first token frame."""
    k = next(j for j, f in enumerate(ch.frames[eid]) if f["kind"] == "token")
    return (ch.arrivals[eid][k] - ch.sent[eid]) * 1e3


def phase_cluster(results, state, seed: int, device: str = "cuda",
                  model_name: str = "llama-3-8b", a_prompts: int = CLUSTER_A_PROMPTS,
                  a_prompt: int = CLUSTER_A_PROMPT, a_suffix: int = CLUSTER_A_SUFFIX,
                  a_new: int = CLUSTER_A_NEW, int8_prompts: int = 2,
                  b_prompts: tuple = CLUSTER_B_PROMPTS, b_new: int = CLUSTER_B_NEW,
                  d: dict = CLUSTER_D, num_pages: int = CLUSTER_PAGES,
                  max_pages_per_seq: int = 128, page_size: int = 16,
                  restore_bytes: int = CLUSTER_RESTORE_BYTES,
                  fetch_bytes: int = CLUSTER_FETCH_BYTES, stall_s: float = CLUSTER_STALL_S,
                  fetch_timeout_s: float = CLUSTER_FETCH_TIMEOUT_S,
                  heartbeat_interval: float = 0.5):
    """Two port nodes of one fleet on the serve's weights (shared tensors):
    node A (role prefill) and node B (role decode), each with its own pool
    of ``num_pages`` pages, a restore budget of ``restore_bytes`` of host
    memory, ``decode_buckets=(16,)`` (a row's decode runs at one width
    whatever else is live, so greedy tokens compare across nodes), behind
    the stand-in control plane (registration, heartbeats with the prefix
    sketch, and its gateway half: the KV relay and two-phase dispatch), and
    a mixed node C that runs the single-node references. A fetch may carry
    ``fetch_bytes`` (``channel.KV_FETCH_MAX_BYTES``, restored after). Counts
    reset before (b) and read after (d):
    (b) ``len(b_prompts)`` token prompts through two-phase dispatch at once
        (``b_new`` greedy tokens): all handed off, tokens equal to C's
        single-node runs, B's ``kv_handoff_completed_total`` = their number
        and its ``prefill_tokens`` 0; the gap from the phase-1 terminal to
        B's first token frame;
    (a) ``a_prompts`` prompts of ``a_prompt`` tokens warmed on A; B gets
        each plus an ``a_suffix``-token suffix with the ``kv_peer`` hint the
        JAX gateway's affinity walk computes from A's heartbeat sketch: B's
        tokens equal A's own (an HBM hit) for the same input, every page
        fetched; the fetch's pages, bytes and GB/s, B's first-frame ms
        against A's hit and B's cold re-prefill of a prompt as long; the
        same on an int8-KV pair (``int8_prompts``; four leaves a page, wire
        bytes saved); every adopted page bit-equal to A's;
    (c) ``kv.fetch_fail``, ``kv.fetch_stall``, ``kv.handoff_fail`` and
        ``kv.handoff_stall`` once each (stalls of ``stall_s`` against a
        ``fetch_timeout_s`` fetch): token-exact, counted, and both nodes'
        ``free_pages`` back to their values before (c);
    (d) a 3-step agent chain on C with ``expect_followup`` and two
        ``followup_candidates`` of which the next step sends the first:
        each step's first-frame ms and engine TTFT on a speculation hit,
        under keep-warm only (``spec.fail``), with no session (the
        shared-prefix index alone) and cold (nothing cached matches), the
        median of two chains a mode run in turns; pins and speculation
        state released, no page held;
    (e) one decode launch over B's adopted pages against the plain version
        within ``elem_bound`` (on the card)."""
    import dataclasses as dc

    import numpy as np
    import torch

    from agentfield_tpu_torch.ops.cuda import ragged_paged_attention as rpa
    from agentfield_tpu_torch.ops.kv_quant import bits
    from agentfield_tpu_torch.prefix_hash import page_chain_hashes
    from agentfield_tpu_torch.serving import channel as chmod
    from agentfield_tpu_torch.serving import faults
    from agentfield_tpu_torch.serving.engine import EngineConfig
    from agentfield_tpu_torch.serving.model_node import ModelBackend, ModelNodeServer
    from agentfield_tpu_torch.serving.tokenizer import ByteTokenizer

    params, cfg = state["params"], state["cfg"]
    on_card = torch.device(device).type == "cuda"
    card = results.get("card", "no card")
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    rng = np.random.default_rng(seed + 43)

    def toks(n: int) -> list[int]:
        return rng.integers(0, cfg.vocab_size, n).tolist()

    ecfg = EngineConfig(max_batch=16, page_size=page_size, num_pages=num_pages,
                        max_pages_per_seq=max_pages_per_seq, decode_buckets=(16,),
                        prefix_sketch_bytes=CLUSTER_SKETCH_BYTES)
    cp = StandInControlPlane()
    url = cp.start()
    nodes: dict[str, tuple] = {}

    def node(nid: str, role: str, kv_quant: str = "none"):
        be = ModelBackend(params, cfg, dc.replace(ecfg, kv_quant_dtype=kv_quant),
                          tokenizer=ByteTokenizer(cfg.vocab_size), seed=seed,
                          model_name=model_name, device=device, restore_budget_bytes=restore_bytes)
        srv = ModelNodeServer(be, node_id=nid, control_plane=url,
                              heartbeat_interval=heartbeat_interval, role=role)
        cp.attach(nid, srv.start())
        nodes[nid] = (srv, be)
        return be

    def stop(nid: str) -> None:
        srv, be = nodes.pop(nid)
        cp.channels.pop(nid).close()
        srv.stop(grace_s=0.0)

    def idle(*bes) -> None:
        for be in bes:
            _wait_idle(be)

    def run(nid: str, eid: str, payload: dict, stream: bool = True) -> list[int]:
        return cp.execute(nid, eid, payload, stream=stream)["result"]["tokens"]

    out: dict = {"pages": num_pages, "restore_bytes": restore_bytes, "fetch_bytes": fetch_bytes}
    old_cap = chmod.KV_FETCH_MAX_BYTES
    chmod.KV_FETCH_MAX_BYTES = fetch_bytes
    t_phase = time.perf_counter()
    try:
        A = node("cluster-a", "prefill")
        B = node("cluster-b", "decode")
        C = node("cluster-c", "mixed")
        assert [cp.nodes[n]["metadata"]["role"] for n in ("cluster-a", "cluster-b", "cluster-c")
                ] == ["prefill", "decode", "mixed"]
        # (b) two-phase dispatch, against single-node references on C
        prompts = [toks(n) for n in b_prompts]
        refs = [run("cluster-c", f"b_ref{i}", {"tokens": p, "max_new_tokens": b_new}, False)
                for i, p in enumerate(prompts)]
        rpa.reset_launches()  # this phase's main path only
        t_main = time.perf_counter()
        got: dict = {}
        ths = [threading.Thread(target=lambda i=i, p=p: got.__setitem__(i, cp.two_phase(
            f"b{i}", {"tokens": p, "max_new_tokens": b_new}, "cluster-a", "cluster-b")))
            for i, p in enumerate(prompts)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(600)
        assert len(got) == len(prompts), sorted(got)
        for i in range(len(prompts)):
            assert got[i]["handed_off"], (i, got[i]["result"])
            assert got[i]["tokens"] == got[i]["result"]["tokens"] == refs[i], (
                f"handoff {i}: tokens differ from the single-node run")
        sa, sb = A.engine.stats, B.engine.stats
        assert sb["kv_handoff_completed_total"] == len(prompts), sb["kv_handoff_completed_total"]
        assert sb["prefill_tokens"] == 0 and sb["kv_handoff_failed_total"] == 0
        assert sa["kv_handoff_initiated_total"] == len(prompts)
        assert sa["kv_handoff_bytes_total"] > 0
        out["b"] = {"gap_ms": [got[i]["gap_ms"] for i in range(len(prompts))],
                    "handoff_bytes": sa["kv_handoff_bytes_total"],
                    "pages_adopted": sb["kv_fetch_pages_adopted_total"],
                    "fetches": sb["kv_fetch_requested_total"],
                    "a_ttft_ms": list(A.engine.ttft_ms)[-len(prompts):]}
        _cluster_report("b", out, card)
        idle(A, B)
        # (a) a prefix another node holds: B pulls it; A's own hit; B cold
        def cross(pa, pb, n_prompts: int, tag: str) -> dict:
            bea, beb = nodes[pa][1], nodes[pb][1]
            ps_ = [toks(a_prompt) for _ in range(n_prompts)]
            for i, p in enumerate(ps_):
                run(pa, f"{tag}_warm{i}", {"tokens": p, "max_new_tokens": 4}, False)
            idle(bea)
            t_hb = time.perf_counter()
            assert cp.wait(lambda: any(
                t > t_hb and nid == pa and "prefix_sketch" in (b.get("stats") or {})
                for t, nid, b in cp.heartbeats), 60), "no heartbeat with a prefix sketch"
            sketch = next(b["stats"]["prefix_sketch"] for t, nid, b in reversed(cp.heartbeats)
                          if nid == pa and t > t_hb)
            rows = []
            for i, p in enumerate(ps_):
                full = p + toks(a_suffix)
                pages = affinity_pages(sketch, full, page_size)
                assert pages == a_prompt // page_size, (pages, sketch["truncated"])
                hint = {"node_id": pa, "pages": pages, "page_size": page_size}
                n0 = len(beb.kv_fetch_log)
                tb = run(pb, f"{tag}_b{i}", {"tokens": full, "max_new_tokens": a_new,
                                             "kv_peer": hint})
                b_ms = first_frame_ms(cp.channels[pb], f"{tag}_b{i}")
                b_eng = beb.engine.ttft_ms[-1]  # submit (after the fetch) to first token
                ta = run(pa, f"{tag}_a{i}", {"tokens": full, "max_new_tokens": a_new})
                assert tb == ta, f"{tag} {i}: B's tokens over fetched pages differ from A's"
                a_ms, a_eng = first_frame_ms(cp.channels[pa], f"{tag}_a{i}"), bea.engine.ttft_ms[-1]
                run(pb, f"{tag}_cold{i}", {"tokens": toks(len(full)), "max_new_tokens": a_new})
                cold_ms = first_frame_ms(cp.channels[pb], f"{tag}_cold{i}")
                cold_eng = beb.engine.ttft_ms[-1]
                assert len(beb.kv_fetch_log) == n0 + 1, "B adopted nothing"
                fp, fb, fs = beb.kv_fetch_log[-1]
                assert fp == pages, (fp, pages)
                # the adopted pages hold A's bytes, bit for bit
                ha = page_chain_hashes(p, page_size)
                with bea.engine._session_lock, beb.engine._session_lock:
                    pa_ids = [bea.engine.allocator._by_hash[h].page for h in ha]
                    pb_ids = [beb.engine.allocator._by_hash[h].page for h in ha]
                for la, lb in zip(bea.engine.cache.leaves(), beb.engine.cache.leaves()):
                    assert torch.equal(bits(la)[:, pa_ids], bits(lb)[:, pb_ids]), (
                        f"{tag} {i}: an adopted page differs from its source")
                rows.append({"pages": fp, "bytes": fb, "fetch_s": fs, "gbps": fb / fs / 1e9,
                             "b_ms": b_ms, "a_hit_ms": a_ms, "b_cold_ms": cold_ms,
                             "engine_ttft_ms": {"b": b_eng, "a_hit": a_eng, "b_cold": cold_eng},
                             "b_pages": pb_ids})
            return {"rows": rows, "sketch_digests": len(sketch["digests"]),
                    "sketch_truncated": sketch["truncated"]}

        out["a"] = cross("cluster-a", "cluster-b", a_prompts, "a")
        restore = B.engine.restore_upload_ms()
        out["a"]["restore_ms"] = [ms for _, ms in restore[-a_prompts:]]
        _cluster_report("a", out, card)
        # (e)'s inputs: layer 0 of B's adopted pages, copied now (later
        # allocations may reuse them), behind a page 0 for the launch's write
        ids = torch.tensor([pid for r in out["a"]["rows"] for pid in r.pop("b_pages")])
        e_pools = [torch.cat([t[0][:1], t[0][ids.to(t.device)], torch.zeros_like(
            t[0][:a_prompts])]) for t in (B.engine.cache.k_pages, B.engine.cache.v_pages)]
        node("cluster-a8", "mixed", "int8")
        node("cluster-b8", "mixed", "int8")
        out["a_int8"] = cross("cluster-a8", "cluster-b8", int8_prompts, "a8")
        a8, b8 = nodes["cluster-a8"][1], nodes["cluster-b8"][1]
        assert len(b8.engine.page_payload_spec()) == 4
        out["a_int8"]["wire_bytes_saved"] = a8.engine.stats["kv_quant_wire_bytes_saved_total"]
        assert out["a_int8"]["wire_bytes_saved"] > 0
        _cluster_report("a_int8", out, card)
        idle(a8, b8)
        stop("cluster-a8")
        stop("cluster-b8")
        del a8, b8
        # (c) faults: each degrades token-exact, no page kept
        idle(A, B, C)
        free0 = (A.engine.allocator.free_pages, B.engine.allocator.free_pages)
        out["c"] = {}

        def faulted(spec: dict, fn):
            faults.install(faults.FaultInjector(seed=seed, spec=spec))
            try:
                return fn()
            finally:
                faults.install(None)

        for point, timeout in (("kv.fetch_fail", 5.0), ("kv.fetch_stall", fetch_timeout_s)):
            p = toks(a_prompt)
            full = p + toks(a_suffix)
            run("cluster-a", f"c_warm_{point}", {"tokens": p, "max_new_tokens": 4}, False)
            idle(A)
            s0 = dict(B.engine.stats)
            B.kv_fetch_timeout_s = timeout
            try:
                tb = faulted({point: {"times": 1, "delay_s": stall_s}}, lambda: run(
                    "cluster-b", f"c_b_{point}", {"tokens": full, "max_new_tokens": a_new,
                                                  "kv_peer": {"node_id": "cluster-a",
                                                              "pages": a_prompt // page_size,
                                                              "page_size": page_size}}))
            finally:
                B.kv_fetch_timeout_s = 5.0
            # B's cold re-prefill of this very prompt, fetch time included
            b_ms, b_eng = first_frame_ms(cp.channels["cluster-b"], f"c_b_{point}"), \
                B.engine.ttft_ms[-1]
            ta = run("cluster-a", f"c_a_{point}", {"tokens": full, "max_new_tokens": a_new})
            assert tb == ta, f"{point}: tokens differ"
            d_ = {k: B.engine.stats[k] - s0[k] for k in (
                "kv_fetch_failed_total", "kv_fetch_pages_adopted_total", "prefill_tokens")}
            d_.update(b_first_frame_ms=b_ms, b_engine_ttft_ms=b_eng)
            assert d_["kv_fetch_failed_total"] == 1 and d_["kv_fetch_pages_adopted_total"] == 0
            assert d_["prefill_tokens"] == len(full), d_
            out["c"][point] = d_
        for point, timeout in (("kv.handoff_fail", 5.0), ("kv.handoff_stall", fetch_timeout_s)):
            p = toks(b_prompts[-1])
            ref = run("cluster-c", f"c_ref_{point}", {"tokens": p, "max_new_tokens": b_new}, False)
            sa0, sb0 = dict(A.engine.stats), dict(B.engine.stats)
            B.kv_fetch_timeout_s = timeout
            try:
                r = faulted({point: {"times": 1, "delay_s": stall_s}}, lambda: cp.two_phase(
                    f"c_{point}", {"tokens": p, "max_new_tokens": b_new},
                    "cluster-a", "cluster-b"))
            finally:
                B.kv_fetch_timeout_s = 5.0
            assert r["result"]["tokens"] == ref, f"{point}: tokens differ"
            d_ = {"handed_off": r["handed_off"]} | {
                f"a_{k}": A.engine.stats[k] - sa0[k] for k in (
                    "kv_handoff_initiated_total", "kv_handoff_fail_export_total")} | {
                f"b_{k}": B.engine.stats[k] - sb0[k] for k in (
                    "kv_handoff_completed_total", "kv_handoff_failed_total",
                    "kv_fetch_failed_total", "prefill_tokens")}
            if point == "kv.handoff_fail":
                assert not r["handed_off"] and d_["a_kv_handoff_fail_export_total"] == 1, d_
            else:
                assert r["handed_off"] and d_["b_kv_handoff_completed_total"] == 0, d_
                assert d_["b_kv_fetch_failed_total"] == 1 and d_["b_prefill_tokens"] == len(p)
            out["c"][point] = d_
        time.sleep(stall_s + 0.5)  # the stalled serves answer into nothing
        idle(A, B)
        free1 = (A.engine.allocator.free_pages, B.engine.allocator.free_pages)
        assert free1 == free0, (free1, free0)
        out["c"]["free_pages"] = free0
        _cluster_report("c", out, card)
        # (d) keep-warm and speculative next-step prefill on C
        runs: dict = {}
        s0 = dict(C.engine.stats)
        for k, mode in enumerate(("hit", "keepwarm", "index", "cold") * 2):  # twice, in turns
            sid = f"agent-{mode}{k}" if mode in ("hit", "keepwarm") else None
            prompt, ttft = toks(d["prompt"]), []
            spec = {"spec.fail": {}} if mode == "keepwarm" else {}
            for step in range(3):
                cands = [toks(d["cand"]), toks(d["cand"])]
                last = step == 2
                # "index": no session, but the index still holds the step's
                # published pages; "cold": a first token of its own, so
                # nothing cached matches (the whole transcript prefills)
                sent = toks(1) + prompt[1:] if mode == "cold" else prompt
                payload = {"tokens": sent, "max_new_tokens": d["new"], "session_id": sid,
                           "expect_followup": bool(sid) and not last,
                           "followup_candidates": cands if sid and not last else None}
                eid = f"d_{mode}{k}_{step}"
                res = faulted(spec, lambda: run("cluster-c", eid, payload))
                ttft.append((first_frame_ms(cp.channels["cluster-c"], eid),
                             C.engine.ttft_ms[-1]))
                idle(C)  # the tool runs: the speculative jobs finish meanwhile
                prompt = prompt + res + cands[0] + toks(d["tool"])
            runs.setdefault(mode, []).append(ttft)
            if sid:
                C.engine.free_session(sid)
        # per step, the median of the runs' (first frame, engine TTFT)
        chains = {mode: [tuple(statistics.median(x[s][j] for x in rs) for j in (0, 1))
                         for s in range(3)] for mode, rs in runs.items()}
        ds = {k: C.engine.stats[k] - s0[k] for k in (
            "spec_started_total", "spec_hit_total", "spec_wasted_tokens_total",
            "spec_cancelled_total", "spec_fail_injected")}
        assert ds["spec_hit_total"] == 4 and ds["spec_fail_injected"] == 4, ds
        with C.engine._session_lock:
            assert not C.engine._pins and not C.engine._spec_by_session
            assert not C.engine._spec_stalled and not C.engine._sessions
            assert C.engine.allocator.free_pages == num_pages - 1
        out["d"] = {"ttft_ms": chains, "runs": runs, "counters": ds}
        _cluster_report("d", out, card)
        main_s = time.perf_counter() - t_main
        launches = rpa.launch_counts()  # the main path's, read now
        # (e) one decode launch over B's adopted pages, kernel against plain
        if on_card:
            from agentfield_tpu_torch.ops.paged_attention import ragged_paged_attention_ref

            R, ctx = a_prompts, a_prompt
            n = ctx // page_size
            tables = torch.zeros((R, max_pages_per_seq), dtype=torch.int32)
            for r in range(R):  # the adopted pages of prompt r, then a page of its own
                tables[r, :n] = 1 + r * n + torch.arange(n, dtype=torch.int32)
                tables[r, n] = 1 + R * n + r  # for the launch's write
            g = torch.Generator().manual_seed(seed + 44)
            H, Kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
            q, kn, vn = (torch.randn((R, 1, h, hd), generator=g).mul_(0.3).to(
                device=device, dtype=torch.bfloat16) for h in (H, Kh, Kh))
            desc = [t.to(device) for t in (
                tables, torch.full((R,), ctx, dtype=torch.int32),
                torch.ones((R,), dtype=torch.int32), torch.full((R,), ctx, dtype=torch.int32),
                torch.arange(R, dtype=torch.int32))]
            kp, vp = e_pools
            kp_k, vp_k, kp_r, vp_r = kp.clone(), vp.clone(), kp.clone(), vp.clone()
            o_k, _, _ = rpa.ragged_paged_attention_cuda(q, kn, vn, kp_k, vp_k, *desc)
            o_r, _, _ = ragged_paged_attention_ref(q, kn, vn, kp_r, vp_r, *desc)
            torch.cuda.synchronize()
            within, err, ratio = compare(o_k, o_r, "bfloat16")
            out["e"] = {"rows": R, "ctx": ctx, "max_abs_err": err, "err_over_bound": ratio}
            _cluster_report("e", out, card)
            assert within, f"the decode over adopted pages disagrees: {err} ({ratio} of bound)"
            del kp_k, vp_k, kp_r, vp_r
        del e_pools
        stats = {n: {k: v for k, v in be.engine.stats.items()
                     if k.startswith(("kv_fetch", "kv_handoff", "spec_", "prefill_tokens"))}
                 for n, (_, be) in nodes.items()}
    finally:
        chmod.KV_FETCH_MAX_BYTES = old_cap
        faults.install(None)
        for nid in list(nodes):
            stop(nid)
        cp.stop()
    if on_card:  # the path's kernels, each launched by this phase's main path
        for key in ("ragged_paged_attention", "ragged_paged_attention_int8",
                    "dense_causal_attention", "ragged_decode_split", "ragged_decode_combine",
                    "ragged_tiles_tc"):
            assert launches[key] > 0, f"{key} was not launched by the cluster phase"
    assert not any(t.name.startswith("channel-") and t.is_alive()
                   for t in threading.enumerate()), "a channel thread outlived its node"
    out.update({"launches": launches, "main_s": main_s, "stats": stats,
                "relay": dict(cp.kv_stats), "phase_s": time.perf_counter() - t_phase})
    results["cluster"] = out
    log(f"[cluster] {results.get('card', 'no card')}: main path {main_s:.1f} s, phase "
        f"{out['phase_s']:.1f} s, launches {launches}, relay {out['relay']}")


def _cluster_report(key: str, out: dict, card: str) -> None:
    """Log one section of ``phase_cluster`` as it completes."""
    def med(xs):
        return statistics.median(xs) if xs else float("nan")

    r = out[key]
    if key == "b":
        log(f"[cluster (b)] {card}: {len(r['gap_ms'])} two-phase dispatches = the single-node "
            f"runs; B installed all live, prefill_tokens 0; phase-1 terminal to B's first token "
            f"frame ms p50 {med(r['gap_ms']):.2f} (min {min(r['gap_ms']):.2f}, max "
            f"{max(r['gap_ms']):.2f}); tail bytes {r['handoff_bytes']}, pages adopted "
            f"{r['pages_adopted']} in {r['fetches']} fetches")
    elif key in ("a", "a_int8"):
        rows = r["rows"]
        log(f"[cluster ({key})] {card}: {len(rows)} prompts, pages fetched "
            f"{[x['pages'] for x in rows]}, bytes {rows[0]['bytes']} a prompt, fetch GB/s p50 "
            f"{med([x['gbps'] for x in rows]):.3f} (host s {med([x['fetch_s'] for x in rows]):.4f})"
            f"; first-frame ms B over fetched pages p50 {med([x['b_ms'] for x in rows]):.2f}, "
            f"A's HBM hit {med([x['a_hit_ms'] for x in rows]):.2f}, B cold "
            f"{med([x['b_cold_ms'] for x in rows]):.2f} (engine TTFT p50 B "
            f"{med([x['engine_ttft_ms']['b'] for x in rows]):.2f}, A "
            f"{med([x['engine_ttft_ms']['a_hit'] for x in rows]):.2f}, B cold "
            f"{med([x['engine_ttft_ms']['b_cold'] for x in rows]):.2f}); tokens B = A, pages "
            f"bit-equal; sketch "
            f"{r['sketch_digests']} digests"
            + (f"; restore upload device ms {[round(x, 3) for x in r['restore_ms']]}"
               if r.get("restore_ms") else "")
            + (f"; wire bytes saved {r['wire_bytes_saved']}" if "wire_bytes_saved" in r else ""))
    elif key == "c":
        log(f"[cluster (c)] {card}: the four faults token-exact "
            f"{ {k: v for k, v in r.items() if k != 'free_pages'} }, free pages A/B back to "
            f"{r['free_pages']}")
    elif key == "d":
        def steps(mode):
            return ", ".join(f"{f:.1f}/{e:.1f}" for f, e in r["ttft_ms"][mode])

        log(f"[cluster (d)] {card}: steps 1-3, first-frame ms / engine TTFT ms (medians of 2 "
            f"chains each): hit {steps('hit')}; keep-warm only {steps('keepwarm')}; no session "
            f"(the index only) {steps('index')}; cold {steps('cold')}; {r['counters']}; pins and "
            f"speculation released, no page held")
    else:
        log(f"[cluster (e)] {card}: decode over adopted pages, {r['rows']} rows ctx {r['ctx']}: "
            f"err {r['max_abs_err']:.3e}, {r['err_over_bound']:.3f} of elem_bound")

# the quant phase's mixed-tick burst and speculative pass on the int8 target
W8_BURST_DECODES = (64, 200, 333, 400)  # in flight, 48 new tokens each
W8_BURST_PROMPTS = (700, 1100)  # then these arrive (chunks of the 512 budget)
W8_SPEC_PROMPTS = (200, 600, 1000, 1500)


# the media phase's towers at the geometry of their published checkpoints,
# as models.vision.load_clip_vision maps openai/clip-vit-large-patch14-336
# and models.audio.load_whisper_encoder maps openai/whisper-large-v3 (random
# weights from the seed; out_dim is Llama-3-8B's width)
MEDIA_VISION = dict(image_size=336, patch_size=14, hidden_size=1024, num_layers=24,
                    num_heads=16, mlp_ratio=4, out_dim=4096, layer_norm_eps=1e-5,
                    dtype="bfloat16", class_token=True, pre_ln=True, final_ln=False,
                    act="quick_gelu", pixel_mean=(0.48145466, 0.4578275, 0.40821073),
                    pixel_std=(0.26862954, 0.26130258, 0.27577711))
MEDIA_AUDIO = dict(sample_rate=16000, n_fft=400, hop=160, n_mels=128, max_seconds=30.0,
                   hidden_size=1280, num_layers=32, num_heads=20, mlp_ratio=4, out_dim=4096,
                   dtype="bfloat16", frontend="conv", mel_impl="whisper", gelu_exact=True)
MEDIA_IMAGE_HW = (480, 640)  # the seeded pictures, written as PNG and baseline JPEG
MEDIA_WAV_S = 30.0
MEDIA_NEW = 16
MEDIA_LIVE_NEW = 256  # the decode that streams while towers run
MEDIA_PAGES = 1024
MEDIA_PAGES_PER_SEQ = 160  # 2560 tokens: an image, a 30 s clip and text
# phase_media at llama-tiny size on the CPU (tests/test_torch_multimodal_serving.py)
MEDIA_REHEARSAL = dict(
    vision=dict(image_size=32, patch_size=8, hidden_size=64, num_layers=2, num_heads=4,
                out_dim=128, dtype="float32", class_token=True, pre_ln=True, final_ln=False,
                act="quick_gelu", pixel_mean=MEDIA_VISION["pixel_mean"],
                pixel_std=MEDIA_VISION["pixel_std"]),
    audio=dict(n_fft=128, hop=64, n_mels=16, max_seconds=1.0, hidden_size=32, num_layers=2,
               num_heads=2, out_dim=128, dtype="float32", frontend="conv", mel_impl="whisper",
               gelu_exact=True),
    tts="tts-tiny", imagegen="imagegen-tiny", image_hw=(48, 64), wav_s=1.0, new=4,
    live_new=200, live_prompt_len=100, num_pages=128, max_pages_per_seq=32)


def media_picture(rng, hw: tuple[int, int]):
    """A seeded [H, W, 3] uint8 picture: smooth colour fields (a coarse
    random grid upsampled bicubically) plus fine noise, as a photo or a
    screenshot has both."""
    import numpy as np

    from agentfield_tpu_torch.models import media_codec

    h, w = hw
    coarse = rng.integers(0, 256, (max(2, h // 32), max(2, w // 32), 3), dtype=np.uint8)
    base = media_codec.resize_bicubic(coarse, (w, h)).astype(np.int16)
    return np.clip(base + rng.integers(-12, 13, (h, w, 3)), 0, 255).astype(np.uint8)


def media_screenshot(rng, hw: tuple[int, int]):
    """A seeded screenshot of 16 flat colours as a 4-bit palette PNG, the
    way Pillow writes an image of up to 16 colours (rows unfiltered, as
    libpng leaves palette rows); returns (PNG bytes, its [H, W, 3] pixels)."""
    import struct
    import zlib

    import numpy as np

    from agentfield_tpu_torch.models import media_codec

    h, w = hw
    palette = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    blocks = rng.integers(0, 16, (-(-h // 16), -(-w // 16)), dtype=np.uint8)
    idx = np.repeat(np.repeat(blocks, 16, axis=0), 16, axis=1)[:h, :w]
    even = np.pad(idx, ((0, 0), (0, w % 2)))
    rows = np.concatenate([np.zeros((h, 1), np.uint8), (even[:, 0::2] << 4) | even[:, 1::2]], axis=1)
    png = (media_codec.PNG_SIG
           + media_codec._png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 4, 3, 0, 0, 0))
           + media_codec._png_chunk(b"PLTE", palette.tobytes())
           + media_codec._png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
           + media_codec._png_chunk(b"IEND", b""))
    return png, palette[idx]


def media_clip(rng, seconds: float, rate: int = 16000):
    """A seeded voice-note stand-in: three gliding tones under noise, in (-1, 1)."""
    import numpy as np

    t = np.arange(int(seconds * rate)) / rate
    f = rng.uniform(120, 900, 3)
    x = sum(np.sin(2 * np.pi * (fi + 40 * np.sin(0.3 * t)) * t) for fi in f) / 4
    return (x + 0.05 * rng.standard_normal(len(t))).astype(np.float32)


def phase_media(results, state, seed: int, device: str = "cuda", vision=None, audio=None,
                tts: str = "tts-base", imagegen: str = "imagegen-base",
                image_hw: tuple[int, int] = MEDIA_IMAGE_HW, wav_s: float = MEDIA_WAV_S,
                new: int = MEDIA_NEW, live_new: int = MEDIA_LIVE_NEW, live_prompt_len: int = 300,
                num_pages: int = MEDIA_PAGES, max_pages_per_seq: int = MEDIA_PAGES_PER_SEQ):
    """Multimodal serving on the serve's weights (``results["media"]``): the
    node built with a vision tower at CLIP ViT-L/14-336 geometry, an audio
    tower at Whisper-large-v3 encoder geometry (``MEDIA_VISION``,
    ``MEDIA_AUDIO``), ``tts-base`` and ``imagegen-base``, random weights
    from the seed in bf16; a PNG and a baseline JPEG of seeded 640x480
    pictures (``media_codec``'s own encoders, decoded back and checked), a
    4-bit palette PNG screenshot (``media_screenshot``) and a 30 s WAV. Counts reset, then over HTTP:
    (a) ``Agent.ai()``'s payload with both pictures (2 x 576 positions);
    (b) the 30 s clip (1500 positions); (c) the screenshot and the clip in
        one prompt; each injected prefill adds one ``dense_causal_attention``
        launch a layer, and its TTFT is set beside a text prompt of the same
        token count;
    (d) ``output`` "audio", "speech" and "image": their WAV and PNG parts
        decode back through ``media_codec``/``wave`` at the heads' sizes;
    (e) a 256-token decode streams while an image and a clip request run:
        its tokens equal an idle run's, and its largest frame gap is the
        tower forwards and the injected prefill between two of its ticks.
    After the counts: (a)'s injected prompt in one forward with the kernel
    and with ``attn_impl="ref"``, the last logits within the bound
    ``phase_forward`` held full-width logits to (1e-4 of max |logit| on
    the CPU, float32). Prints ``[media]`` lines: each tower's and head's
    device ms (CUDA events), the TTFTs, the launches, the frame gap, peak
    device memory and the phase's seconds."""
    import base64
    import io
    import wave

    import numpy as np
    import torch

    from agentfield_tpu_torch.models import audio as audio_mod
    from agentfield_tpu_torch.models import llama, media_codec
    from agentfield_tpu_torch.models.vision import VisionConfig
    from agentfield_tpu_torch.ops.cuda import ragged_paged_attention as rpa
    from agentfield_tpu_torch.serving.engine import EngineConfig
    from agentfield_tpu_torch.serving.model_node import (
        ModelBackend,
        ModelNodeServer,
        _prompt_byte_ids,
    )
    from agentfield_tpu_torch.serving.tokenizer import ByteTokenizer

    t_phase = time.perf_counter()
    params, cfg = state["params"], state["cfg"]
    V = cfg.vocab_size
    on_card = torch.device(device).type == "cuda"
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(seed + 41)
    vcfg = VisionConfig(**(MEDIA_VISION if vision is None else vision))
    acfg = audio_mod.AudioConfig(**(MEDIA_AUDIO if audio is None else audio))
    ecfg = EngineConfig(max_batch=16, page_size=16, num_pages=num_pages,
                        max_pages_per_seq=max_pages_per_seq, decode_buckets=(4, 16),
                        shared_prefix_cache=False)
    t_build = time.perf_counter()
    backend = ModelBackend(params, cfg, ecfg, tokenizer=ByteTokenizer(V), seed=seed,
                           model_name="llama-3-8b", device=device, vision=vcfg, audio=acfg,
                           tts=tts, imagegen=imagegen)
    if on_card:
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build
    tower_bytes = {k: sum(t.numel() * t.element_size() for t in _leaves(p)) for k, p in (
        ("vision", backend.vision_params), ("audio", backend.audio_params),
        ("tts", backend.tts_params), ("imagegen", backend.imagegen_params))}
    server = ModelNodeServer(backend, node_id="media-node")
    assert server.metadata["modalities"] == ["text", "image-in", "audio-in", "audio-out",
                                             "image-out"], server.metadata
    # the media, written and read back by the node's own codecs
    t_codec = time.perf_counter()
    pics = [media_picture(rng, image_hw) for _ in range(2)]
    png = media_codec.encode_png(pics[0])  # a filter a row by libpng's rule
    jpeg = media_codec.encode_jpeg(pics[1], quality=90, subsampling="4:2:0")
    shot, shot_px = media_screenshot(rng, image_hw)
    decode_ms, decoded = {}, {}
    for name, fn, data in (("png", media_codec.decode_png, png), ("jpeg", media_codec.decode_jpeg,
                                                                    jpeg),
                           ("shot", media_codec.decode_png, shot)):
        t0 = time.perf_counter()
        decoded[name] = fn(data)
        decode_ms[name] = (time.perf_counter() - t0) * 1e3  # host ms, as the node decodes it
    assert np.array_equal(decoded["png"], pics[0]), "PNG round trip"
    assert np.array_equal(decoded["shot"], shot_px), "palette PNG round trip"
    jpeg_err = float(np.abs(decoded["jpeg"].astype(np.float64) - pics[1]).mean())
    assert jpeg_err < 8.0, f"JPEG round trip mean |d| {jpeg_err}"
    wav = audio_mod.float_to_wav(media_clip(rng, wav_s), acfg.sample_rate)
    encode_s = time.perf_counter() - t_codec
    b64 = {"png": base64.b64encode(png).decode(), "jpeg": base64.b64encode(jpeg).decode(),
           "shot": base64.b64encode(shot).decode(), "wav": base64.b64encode(wav).decode()}
    P, A = vcfg.num_patches, acfg.n_tokens

    def text(n: int) -> str:  # ASCII letters: one byte-tokenizer token each
        return "".join(chr(c) for c in rng.integers(97, 123, n))

    prompts = {
        "image": "Describe these two pictures:\n<image>\n<image>\nWhat differs between them?",
        "audio": "Transcribe this voice note:\n<audio>",
        "mixed": "Here is a screenshot:\n<image>\nand a voice note about it:\n<audio>\nReply.",
    }
    media = {"image": dict(images=[{"b64": b64["png"]}, {"b64": b64["jpeg"]}]),
             "audio": dict(audios=[{"b64": b64["wav"]}]),
             "mixed": dict(images=[{"b64": b64["shot"]}], audios=[{"b64": b64["wav"]}])}
    n_media = {"image": 2 * P, "audio": A, "mixed": P + A}
    out: dict = {"build_s": build_s, "tower_bytes": tower_bytes, "positions": {
        "image": P, "audio": A}, "png_bytes": len(png), "jpeg_bytes": len(jpeg), "shot_bytes": len(shot),
        "wav_bytes": len(wav), "jpeg_round_trip_mean_abs": jpeg_err, "encode_s": encode_s,
        "decode_ms": decode_ms}
    port = server.start()
    try:
        rpa.reset_launches()  # this phase's main path only
        t_main = time.perf_counter()

        def gen(payload):
            st, doc = _http(port, "POST", "/reasoners/generate", {"input": payload})
            assert st == 200, (st, doc)
            return doc["result"]

        answered, mm_ttft, text_ttft, dense, host_ms = [], {}, {}, {}, {}
        # (a)-(c): the injected prefills, each twice (the first pays the
        # towers' and libraries' first use: cuFFT, cuDNN), beside a text
        # prompt of its length
        for kind in ("image", "audio", "mixed"):
            runs = []
            for _ in range(2):
                d0 = rpa.LAUNCHES["dense_causal_attention"]
                t0 = time.perf_counter()
                res = gen(sdk_payload(prompt=prompts[kind], max_new_tokens=new, **media[kind]))
                runs.append(((time.perf_counter() - t0) * 1e3, backend.engine.ttft_ms[-1],
                             rpa.LAUNCHES["dense_causal_attention"] - d0, res["tokens"]))
                assert len(res["tokens"]) == new and res["finish_reason"] == "length", res
            assert runs[0][3] == runs[1][3], f"{kind}: the same request gave other tokens"
            host_ms[kind] = [r[0] for r in runs]
            mm_ttft[kind] = [r[1] for r in runs]
            dense[kind] = [r[2] for r in runs]
            n_tok = n_media[kind] + len(re.sub("<image>|<audio>", "", prompts[kind]).encode())
            gen({"prompt": text(n_tok), "max_new_tokens": new})
            text_ttft[kind] = (n_tok, backend.engine.ttft_ms[-1])
            answered.append(kind)
        if on_card:
            for kind, n in dense.items():
                assert n == [cfg.num_layers] * 2, f"{kind}: {n} dense launches a prefill"
        # (d) the output heads
        tcfg, icfg = backend.tts_cfg, backend.imagegen_cfg
        spoken = "Your build passed; two tests were skipped."
        r_audio = gen(sdk_payload(prompt=spoken, output="audio"))
        r_speech = gen(sdk_payload(prompt=text(40), max_new_tokens=new, output="speech"))
        r_image = gen(sdk_payload(prompt="a lighthouse on a cliff at dusk", output="image"))
        answered += ["audio_out", "speech", "image_out"]
        for r, said in ((r_audio, spoken), (r_speech, r_speech["text"])):
            [part] = r["parts"]
            assert part["mime"] == "audio/wav", part["mime"]
            n_bytes = max(1, _prompt_byte_ids(said, tcfg.max_chars)[1])
            with wave.open(io.BytesIO(base64.b64decode(part["data_b64"])), "rb") as w:
                assert (w.getframerate(), w.getnchannels()) == (tcfg.sample_rate, 1)
                assert w.getnframes() == n_bytes * tcfg.frames_per_char * tcfg.samples_per_frame
        assert len(r_speech["tokens"]) == new
        [part] = r_image["parts"]
        img = media_codec.decode_png(base64.b64decode(part["data_b64"]))
        assert img.shape == (icfg.image_size, icfg.image_size, 3), img.shape
        # (e) a live decode while the towers run between its ticks
        live_prompt = text(live_prompt_len)
        idle = gen({"prompt": live_prompt, "max_new_tokens": live_new})
        started, arrivals, live = threading.Event(), [], {}

        def on_frame(i, frame):
            arrivals.append(time.perf_counter())
            started.set()

        def stream_live():
            try:
                live["frames"], _ = _sse(port, {"prompt": live_prompt,
                                               "max_new_tokens": live_new}, on_frame)
            except BaseException as e:  # noqa: BLE001 — failed below
                live["error"] = repr(e)
                started.set()

        th = threading.Thread(target=stream_live)
        th.start()
        assert started.wait(600), "the live stream never started"
        n_ms = len(backend.media_ms)
        t_during = time.perf_counter()
        gen(sdk_payload(prompt=prompts["image"], max_new_tokens=new, **media["image"]))
        gen(sdk_payload(prompt=prompts["audio"], max_new_tokens=new, **media["audio"]))
        during_ms = (time.perf_counter() - t_during) * 1e3
        frames_at_end = len(arrivals)
        th.join()
        assert "error" not in live, live
        assert frames_at_end < live_new, "the decode ended before the media requests: no overlap"
        tower_ms_during = list(backend.media_ms)[n_ms:]
        live_tokens = [f["token"] for f in live["frames"] if f["token"] >= 0]
        assert live_tokens == idle["tokens"], "media requests during the decode changed its tokens"
        gaps = [(b - a) * 1e3 for a, b in zip(arrivals, arrivals[1:])]
        main_s = time.perf_counter() - t_main
        launches = rpa.launch_counts()  # the main path's, read now
    finally:
        server.stop()
    eng = backend.engine
    assert eng.allocator.free_pages == num_pages - 1, eng.allocator.free_pages
    by_kind: dict = {}
    for kind, ms in backend.media_ms:
        by_kind.setdefault(kind, []).append(ms)
    # after the counts: (a)'s injected prompt, kernel vs plain attention
    toks, spans = backend._fuse_media(prompts["image"], *[media["image"].get(k) for k in (
        "images", "audios")])
    S = len(toks)
    inject = torch.zeros((1, S, cfg.hidden_size), dtype=params["embed"].dtype, device=device)
    mask = torch.zeros((1, S), dtype=torch.bool, device=device)
    for off, emb in spans:
        inject[0, off:off + emb.shape[0]] = emb.to(inject.dtype)
        mask[0, off:off + emb.shape[0]] = True
    t = torch.tensor([toks], device=device)
    pos = torch.arange(S, device=device)[None]
    last = torch.tensor([S - 1], device=device)
    with torch.inference_mode():
        lk, _ = llama.forward(params, cfg, t, pos, attn_impl="kernel", collect_kv=False,
                              last_idx=last, embeds_override=(inject, mask))
        lr, _ = llama.forward(params, cfg, t, pos, attn_impl="ref", collect_kv=False,
                              last_idx=last, embeds_override=(inject, mask))
    logit_err = float((lk - lr).abs().max())
    scale = float(lr.abs().max())
    tol = results["forward"]["tol_bf16"] if on_card else 1e-4 * scale
    assert bool(torch.isfinite(lk).all()) and logit_err <= tol, (logit_err, tol)
    if on_card:  # the hand kernels' paths on this phase's main path
        for key in ("ragged_paged_attention", "dense_causal_attention", "ragged_decode_split",
                    "ragged_decode_combine"):
            assert launches[key] > 0, f"{key} was not launched by the media phase"
    peak = torch.cuda.max_memory_allocated() if on_card else None
    del backend, server, spans, inject
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    out.update({
        "answered": answered, "host_ms": host_ms, "ttft_ms": mm_ttft,
        "text_ttft_ms": text_ttft, "dense_launches": dense,
        "dense_launches_per_prefill": cfg.num_layers if on_card else None,
        "tower_device_ms": by_kind, "during": {
            "frames_when_done": frames_at_end, "live_new": live_new, "requests_ms": during_ms,
            "max_frame_gap_ms": max(gaps), "median_frame_gap_ms": statistics.median(gaps),
            "tower_ms": tower_ms_during},
        "logits": {"S": S, "max_abs_err": logit_err, "tol": tol, "max_abs_logit": scale},
        "launches": launches, "main_s": main_s, "peak_bytes": peak,
        "phase_s": time.perf_counter() - t_phase, "graphs": eng.graph_stats(),
    })
    results["media"] = out
    card = results.get("card", "no card")

    def ms(kind):
        v = by_kind.get(kind)
        return "not measured" if not v else "/".join(f"{x:.2f}" for x in v)

    log(f"[media] {card}: towers built in {build_s:.1f} s ({ {k: round(v / 1e9, 3) for k, v in tower_bytes.items()} } GB); "
        f"device ms, each call: vision {ms('vision')} (2 or 1 x {P} positions), audio "
        f"{ms('audio')} ({A} positions), tts {ms('tts')}, imagegen {ms('imagegen')}")
    def pair(v):
        return "/".join(f"{x:.1f}" for x in v)

    log(f"[media] {card}: injected prefill TTFT ms (engine; first/second run) image "
        f"{pair(mm_ttft['image'])}, audio {pair(mm_ttft['audio'])}, mixed "
        f"{pair(mm_ttft['mixed'])} vs text of the same length "
        f"{[(n, round(v, 1)) for n, v in text_ttft.values()]}; request host ms image "
        f"{pair(host_ms['image'])}, audio {pair(host_ms['audio'])}, mixed "
        f"{pair(host_ms['mixed'])} (host decode ms: PNG {decode_ms['png']:.1f}, JPEG "
        f"{decode_ms['jpeg']:.1f}, palette PNG {decode_ms['shot']:.1f}); dense launches a "
        f"prefill {dense}; last logits kernel vs "
        f"plain max|d| {logit_err:.4e} (tol {tol:.4e}, S={S})")
    log(f"[media] {card}: live decode during media requests: {frames_at_end} of {live_new} "
        f"frames by their end, frame gap max {max(gaps):.1f} ms (median "
        f"{statistics.median(gaps):.1f}; the towers {tower_ms_during} ms meanwhile), tokens = "
        f"idle run; outputs audio/speech/image "
        f"decoded; peak {'not measured' if peak is None else f'{peak / 2**30:.2f} GiB'}; "
        f"phase {out['phase_s']:.1f} s (main path {main_s:.1f} s); launches {launches}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def plain_w8_params(params):
    """``params`` with every ``QuantW`` leaf replaced by one whose ``@``
    runs the plain version (``int8_weight_matmul_ref``, the JAX formula) on
    any device, reading a packed q through ``unpack_int8_weight``: the
    kernel's comparison on the card. An expert stack's ``expert_einsum``
    goes through that ``@`` one expert at a time (``QuantW.expert_einsum``
    on the card), so only one expert's matrix is unpacked and widened."""
    from agentfield_tpu_torch.models.quant import QuantW
    from agentfield_tpu_torch.ops.cuda.quant_matmul import int8_weight_matmul_ref

    class PlainQuantW(QuantW):
        __slots__ = ()

        def __rmatmul__(self, x):
            return int8_weight_matmul_ref(x, self.logical(), self.scale)

    layers = {k: PlainQuantW(v.q, v.scale, v.packed) if isinstance(v, QuantW) else v
              for k, v in params["layers"].items()}
    return {**params, "layers": layers}


def f32_params(params):
    """``params`` with every fp leaf widened to float32 (QuantW leaves kept:
    their x @ q then runs on float32 activations)."""
    from agentfield_tpu_torch.models.quant import QuantW

    def widen(t):
        return t if isinstance(t, QuantW) else t.float()

    return {k: ({n: widen(t) for n, t in v.items()} if isinstance(v, dict) else widen(v))
            for k, v in params.items()}


def weight_bytes(params) -> int:
    """Bytes of every weight leaf (a ``QuantW`` counts its q and its scale)."""
    from agentfield_tpu_torch.models.quant import QuantW

    def leaves(t):
        if isinstance(t, dict):
            for v in t.values():
                yield from leaves(v)
        elif isinstance(t, QuantW):
            yield from (t.q, t.scale)
        else:
            yield t

    return sum(t.numel() * t.element_size() for t in leaves(params))


def _step_device_ms(params, cfg, seed: int) -> dict:
    """A small engine on ``params`` (phase_graph's script: 6 prompts of
    100-850 tokens, width 8): the greedy decode step's graph replayed, its
    device ms (CUDA events), its launches and its split by kernel kind
    (``profile_replays``)."""
    import numpy as np

    from agentfield_tpu_torch.serving.engine import EngineConfig, InferenceEngine, Request
    from agentfield_tpu_torch.serving.sampler import SamplingParams

    gc.collect()
    eng = InferenceEngine(params, cfg, EngineConfig(
        max_batch=8, page_size=16, num_pages=513, max_pages_per_seq=64), seed=seed, device="cuda")
    rng = np.random.default_rng(seed + 7)
    for i in range(6):
        eng.submit(Request(f"g{i}", rng.integers(1, cfg.vocab_size, 100 + 150 * i).tolist(),
                           SamplingParams(max_new_tokens=64)))
    while eng._inflight is None:  # admissions, then the first dispatch (its capture)
        eng.step()
    eng._harvest_inflight()
    st = eng._dev_state()
    toks0, lens0 = st.tokens.clone(), st.seq_lens.clone()

    def restore():
        st.tokens.copy_(toks0)
        st.seq_lens.copy_(lens0)

    graph, launches = eng._graphs.graphs[(st.width, "greedy", "free")]
    out = {"width": st.width, "live_rows": int((lens0 > 0).sum()),
           "step_device_ms": graph_replay_ms(graph, restore),
           "launches_per_replay": {k: n for k, n in launches.items() if n},
           "breakdown": profile_replays(graph, restore)}
    eng.close()
    return out


def mixed_burst(params, cfg, base, seed: int, burst, device: str, rng) -> dict:
    """A mixed-tick burst on ``params`` (``base`` geometry, mixed ticks of
    ``MIXED_BUDGET`` rows): ``burst = (decodes, prompts)``, the decodes (48
    new tokens each) in flight first, then the prompts (16 new tokens),
    chunked into mixed ticks. Every answer complete, the pages balanced, a
    mixed tick run and, on the card with int8 weights, each mixed tick
    through the int8-weight kernel (``w8_launches_per_step`` at least).
    Returns the tick count, the launches in mixed ticks and their mean
    device ms."""
    import dataclasses

    from agentfield_tpu_torch.models.quant import is_quantized
    from agentfield_tpu_torch.ops.cuda import ragged_paged_attention as rpa
    from agentfield_tpu_torch.serving.engine import InferenceEngine, Request
    from agentfield_tpu_torch.serving.sampler import SamplingParams

    V = cfg.vocab_size
    ecfg = dataclasses.replace(base, mixed_step=True, mixed_step_budget=MIXED_BUDGET)
    eng = InferenceEngine(params, cfg, ecfg, seed=seed, device=device)
    mixed_launches: dict = {}
    orig_logits = eng._mixed_logits

    def tallied(*a, **k):
        before = rpa.launch_counts()
        try:
            return orig_logits(*a, **k)
        finally:
            for key, n in rpa.launch_counts().items():
                mixed_launches[key] = mixed_launches.get(key, 0) + n - before[key]

    eng._mixed_logits = tallied
    decodes, prompts = burst
    answers: dict = {}
    for i, n in enumerate(decodes):
        eng.submit(Request(f"d{i}", rng.integers(1, V, n).tolist(),
                           SamplingParams(max_new_tokens=48)))
    while len(answers) < len(decodes) or eng.stats["decode_steps"] < 4:
        for ev in eng.step():
            answers.setdefault(ev.request_id, []).append(ev.token)
    for i, n in enumerate(prompts):
        eng.submit(Request(f"b{i}", rng.integers(1, V, n).tolist(),
                           SamplingParams(max_new_tokens=16)))
    while eng.has_work():
        for ev in eng.step():
            answers.setdefault(ev.request_id, []).append(ev.token)
    assert all(len(answers[f"d{i}"]) == 48 for i in range(len(decodes)))
    assert all(len(answers[f"b{i}"]) == 16 for i in range(len(prompts)))
    assert eng.allocator.free_pages == ecfg.num_pages - 1, "pages did not balance"
    out = {"mixed_ticks": eng.stats["mixed_ticks"],
           "mixed_tick_launches": {k: n for k, n in mixed_launches.items() if n},
           "mixed_tick_device_ms_mean": (statistics.fmean(eng.mixed_tick_ms)
                                         if eng.mixed_tick_ms else None)}
    assert out["mixed_ticks"] > 0, "no mixed tick ran"
    if eng.device.type == "cuda" and is_quantized(params):
        assert mixed_launches.get("int8_weight_matmul", 0) >= w8_launches_per_step(cfg), (
            mixed_launches)
    eng.close()
    return out


def w8_logits_vs_plain(qp, fp_params, cfg, seed: int, S: int, device: str, tag: str) -> dict:
    """Full-width logits at ``S`` seeded tokens of the int8 tree ``qp``,
    kernel against plain (both int8, ``plain_w8_params``): in bf16 within
    ``W8_LOGITS_BF16_FACTOR`` times the plain path's own bf16-vs-f32
    distance, in f32 within ``W8_LOGITS_F32_REL`` of max |logit|; the
    distance to the fp tree ``fp_params`` and the greedy agreement with it
    for information (random weights). Logs one ``tag`` line, then raises
    ``AssertionError`` past a bound."""
    import torch

    from agentfield_tpu_torch.models import llama

    on_card = torch.device(device).type == "cuda"
    V = cfg.vocab_size
    g = torch.Generator(device=device)
    g.manual_seed(seed + 1)
    tokens = torch.randint(0, V, (1, S), device=device, generator=g)
    pos = torch.arange(S, device=device)[None]

    def fwd(p):
        with torch.no_grad():
            lg, _ = llama.forward(p, cfg, tokens, pos, attn_impl="kernel", collect_kv=False)
        if on_card:
            torch.cuda.synchronize()
        assert lg.shape == (1, S, V) and bool(torch.isfinite(lg).all())
        return lg

    plain = plain_w8_params(qp)
    lk16, lp16, lb16 = fwd(qp), fwd(plain), fwd(fp_params)
    lk32, lp32 = fwd(f32_params(qp)), fwd(f32_params(plain))
    scale = float(lp32.abs().max())
    err16, err32 = float((lk16 - lp16).abs().max()), float((lk32 - lp32).abs().max())
    noise16 = float((lp16 - lp32).abs().max())
    tol16, tol32 = W8_LOGITS_BF16_FACTOR * noise16, W8_LOGITS_F32_REL * scale
    out = {
        "S": S, "max_abs_logit": scale, "max_abs_err_bf16": err16, "tol_bf16": tol16,
        "plain_bf16_vs_f32": noise16, "max_abs_err_f32": err32, "tol_f32": tol32,
        "int8_vs_bf16_max_abs": float((lk16 - lb16).abs().max()),
        "int8_vs_bf16_argmax_agreement": float((lk16.argmax(-1) == lb16.argmax(-1)).float().mean()),
        "kernel_vs_plain_argmax_agreement": float(
            (lk16.argmax(-1) == lp16.argmax(-1)).float().mean()),
    }
    log(f"{tag} full-width logits at {S} tokens, kernel vs plain (int8): bf16 max|d| "
        f"{err16:.4e} (tol {tol16:.4e} = {W8_LOGITS_BF16_FACTOR} x the plain path's bf16-vs-f32 "
        f"{noise16:.4e}); f32 max|d| {err32:.4e} (tol {tol32:.4e}); int8 vs bf16 weights max|d| "
        f"{out['int8_vs_bf16_max_abs']:.4e}, greedy agreement "
        f"{out['int8_vs_bf16_argmax_agreement']:.3f} (information: random weights)")
    del lk16, lp16, lb16, lk32, lp32, plain
    assert err32 <= tol32, f"{tag} full-width f32 forward: int8 kernel and plain disagree"
    assert err16 <= tol16, f"{tag} full-width bf16 forward: int8 kernel and plain disagree"
    return out


def phase_quant(results, state, seed: int, device: str = "cuda", model: str = "llama-3-8b",
                lengths=(64, 200, 333, 480, 512, 700, 1100, 1500), max_new: int = 32, S: int = 512,
                burst=(W8_BURST_DECODES, W8_BURST_PROMPTS), spec_prompts=W8_SPEC_PROMPTS,
                draft_preset: str = SPEC_DRAFT):
    """Weight-only int8 serving on ``state``'s weights (full-width
    Llama-3-8B bf16 on the card), quantized by ``build_model_node(quant=
    "int8")`` (``models.quant.quantize_params`` on the device):

    (a) the serve's requests through the int8 node (``phase_serve`` with
        ``weight_quant="int8"``: every answer complete, ``7 L`` kernel
        launches in each decode step's graph, each step counted); then the
        replayed greedy step of a width-8 engine on the int8 and on the bf16
        weights, device ms and split by kernel kind, in this run;
    (b) full-width logits at ``S`` tokens, kernel against plain (both int8,
        ``plain_w8_params``), in bf16 within ``W8_LOGITS_BF16_FACTOR`` times
        the plain path's own bf16-vs-f32 distance and in f32 within
        ``W8_LOGITS_F32_REL`` of max |logit|; the int8-vs-bf16 logit
        distance and greedy agreement for information (random weights);
    (c) the weight bytes on the device, int8 against bf16, and peak memory;
    (d) one mixed-tick burst (``burst``: decodes in flight, then prompts
        chunked into mixed ticks of the 512-token budget) and one
        speculative pass (k = 3, the ``draft_preset`` draft kept fp) on the
        int8 target: each path launches the kernel (mixed ticks; every spec
        replay ``7 L`` times).

    ``device="cpu"`` rehearses the phase on a small model (no graphs, no
    device times; the plain version on both sides)."""
    import dataclasses

    import numpy as np
    import torch

    from agentfield_tpu_torch.models.quant import QUANT_KEYS, is_quantized
    from agentfield_tpu_torch.serving.engine import InferenceEngine, Request
    from agentfield_tpu_torch.serving.model_node import load_draft_model
    from agentfield_tpu_torch.serving.sampler import SamplingParams

    on_card = torch.device(device).type == "cuda"
    params, cfg = state["params"], state["cfg"]
    V = cfg.vocab_size
    w8_per_step = w8_launches_per_step(cfg)
    out: dict = {}
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated() if on_card else None

    # (a) the serve through build_model_node(quant="int8")
    phase_serve(results, state, seed, model=model, device=device, lengths=lengths,
                max_new=max_new, weight_quant="int8")
    qp = state.pop("w8_params")
    assert is_quantized(qp) and not is_quantized(params)
    serve = results["serve_w8"]
    gc.collect()  # the serve's engine (and its KV pool) is garbage now
    tree_bytes = torch.cuda.memory_allocated() - mem0 if on_card else None
    out["decode_step_device_ms_int8"] = serve["decode_step_device_ms_mean"]
    out["decode_step_device_ms_bf16"] = results.get("serve", {}).get("decode_step_device_ms_mean")
    if on_card:
        out["step_int8"] = _step_device_ms(qp, cfg, seed)
        out["step_bf16"] = _step_device_ms(params, cfg, seed)
        assert out["step_int8"]["launches_per_replay"]["int8_weight_matmul"] == w8_per_step
        assert "int8_weight_matmul" not in out["step_bf16"]["launches_per_replay"]
        log(f"[quant] (a) replayed width-8 step: int8 {out['step_int8']['step_device_ms']:.3f} "
            f"device ms vs bf16 {out['step_bf16']['step_device_ms']:.3f}; by kind int8 "
            f"{out['step_int8']['breakdown'] and out['step_int8']['breakdown']['by_kind_ms']} / "
            f"bf16 {out['step_bf16']['breakdown'] and out['step_bf16']['breakdown']['by_kind_ms']}; "
            f"serve decode step {out['decode_step_device_ms_int8']} vs "
            f"{out['decode_step_device_ms_bf16']} device ms")

    # (c) weight bytes, int8 against bf16
    layer_fp = sum(params["layers"][k].numel() * params["layers"][k].element_size()
                   for k in QUANT_KEYS)
    layer_q = sum(qp["layers"][k].q.numel() + 4 * qp["layers"][k].scale.numel()
                  for k in QUANT_KEYS)
    out["weights"] = {"bf16_bytes": weight_bytes(params), "int8_bytes": weight_bytes(qp),
                      "layer_bf16_bytes": layer_fp, "layer_int8_bytes": layer_q,
                      "int8_tree_device_bytes": tree_bytes,
                      "serve_peak_gib": serve["peak_mem_gib"],
                      "serve_peak_note": "the bf16 tree stays resident beside the int8 one"}
    log(f"[quant] (c) weights {out['weights']['int8_bytes'] / 2**30:.3f} GiB int8 vs "
        f"{out['weights']['bf16_bytes'] / 2**30:.3f} GiB bf16 (layers {layer_q / 2**30:.3f} vs "
        f"{layer_fp / 2**30:.3f}); the int8 tree holds {out['weights']['int8_tree_device_bytes']} "
        f"device bytes of its own; int8 serve peak {serve['peak_mem_gib']} GiB")

    # (b) full-width logits, kernel against plain, both int8
    out["logits"] = w8_logits_vs_plain(qp, params, cfg, seed, S, device, "[quant] (b)")

    # (d) a mixed-tick burst and a speculative pass on the int8 target
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    rng = np.random.default_rng(seed + 29)
    base = dataclasses.replace(state["ecfg"], kv_quant_dtype="none")
    out["mixed"] = mixed_burst(qp, cfg, base, seed, burst, device, rng)
    mixed_launches = out["mixed"]["mixed_tick_launches"]
    gc.collect()
    draft = load_draft_model(draft_preset, V, seed=seed + 4, device=device,
                             dtype=params["embed"].dtype)
    eng = InferenceEngine(qp, cfg, dataclasses.replace(base, spec_k=3), seed=seed,
                          device=device, draft=draft)
    rec = watch_spec(eng)
    reqs = [Request(f"s{i}", rng.integers(1, V, n).tolist(), SamplingParams(max_new_tokens=max_new))
            for i, n in enumerate(spec_prompts)]
    spec_out = eng.run_to_completion(reqs)
    assert all(len(spec_out[r.id]) == max_new for r in reqs)
    st = eng.stats
    assert st["spec_steps"] > 0, "no speculative step on the int8 target"
    replays = [r for r in rec["runs"] if r["replayed"]]
    if on_card:
        assert replays and all(r["launches"]["int8_weight_matmul"] == w8_per_step
                               for r in replays), [r["launches"] for r in replays[:2]]
    out["spec"] = {"spec_steps": st["spec_steps"], "spec_emitted": st["spec_emitted"],
                   "replays": len(replays),
                   "spec_step_device_ms_mean": (statistics.fmean(eng.spec_step_ms)
                                                if eng.spec_step_ms else None),
                   "w8_launches": sum(r["launches"].get("int8_weight_matmul", 0)
                                      for r in rec["runs"])}
    eng.close()
    del eng, draft
    log(f"[quant] (d) mixed burst: {out['mixed']['mixed_ticks']} mixed ticks, launches in them "
        f"{out['mixed']['mixed_tick_launches']}, {out['mixed']['mixed_tick_device_ms_mean']} "
        f"device ms a tick; spec k=3 ({draft_preset} draft, fp): {st['spec_steps']} spec steps "
        f"emitting {st['spec_emitted']} tokens, {len(replays)} replays of {w8_per_step} int8 "
        f"launches each, {out['spec']['spec_step_device_ms_mean']} device ms a spec step")
    out["launches"] = {"int8_weight_matmul": serve["w8_launches"]["int8_weight_matmul"]
                       + mixed_launches.get("int8_weight_matmul", 0) + out["spec"]["w8_launches"]}
    results["quant"] = out
    del qp
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()


# Mixtral-8x7B, weight-only int8 (phase_moe): the node's build, the serve
# under both prefill modes, full-width logits, the decode step's split, the
# int8-weight kernel on expert slices at the new row counts, a self-draft
# spec pass and a mixed-tick burst
MOE_MODEL = "mixtral-8x7b"
MOE_BUILD_SLACK = 2 << 30  # the weight draw may pass the int8 tree by this much
MOE_HELD_BEFORE = 2 << 30  # device bytes still allocated when the draw starts
# the int8-weight kernel on one expert's packed slice: soft-routed decode at
# widths 8 and 16 (every expert takes every row), the sparse capacity of a
# 512-token chunk (ceil(512 * 2 / 8 * 2) = 256 rows an expert), and the
# soft-routed prefill of that chunk (512 rows an expert)
MOE_W8_M = (8, 16, 256, 512)
MOE_W8_SLICES = (("w_gate", 0, 0), ("w_down", -1, -1))  # (leaf, layer, expert)
MOE_SPEC_PROMPTS = (300, 900)
MOE_SPEC_PAGES = 1024  # 2 GiB of bf16 KV a pool at Mixtral's width: target and self draft
MOE_BURST = ((64, 200, 333, 400), (700,))
# small kernels of the soft-routed FFN, by name in the profiler's records
MOE_KERNEL_NAMES = {"top-k": ("topk", "sort"), "softmax": ("softmax",),
                    "scatter (router weights)": ("scatter",),
                    "stack (expert outputs)": ("catarray",)}


def _moe_small_kernels(kernels: dict) -> dict:
    """ms a replay in the soft-routed FFN's small kernels, by
    ``MOE_KERNEL_NAMES`` (case-insensitive substrings of kernel names)."""
    out = {}
    for label, keys in MOE_KERNEL_NAMES.items():
        out[label] = sum(ms for name, ms in kernels.items()
                         if any(k in name.lower() for k in keys))
    return out


def _moe_op_ms(qp, cfg, width: int, seed: int) -> dict:
    """Device ms (replayed from a CUDA graph) of the soft-routed FFN's
    routing ops at one decode width, times L for a step: the router
    product, ``topk_router_weights`` (top-k, softmax, scatter) and the
    weighted combine of the expert outputs."""
    import torch

    from agentfield_tpu_torch.models.moe import topk_router_weights

    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 11)
    d, E, L = cfg.hidden_size, cfg.num_experts, cfg.num_layers
    h = torch.empty((width, 1, d), device="cuda", dtype=torch.bfloat16).normal_(generator=g)
    router = qp["layers"]["router"][0]
    logits = (h @ router).float()
    w = topk_router_weights(logits, cfg.num_experts_per_tok).to(torch.bfloat16)
    y = torch.empty((width, E, 1, d), device="cuda", dtype=torch.bfloat16).normal_(generator=g)
    return {k: L * graph_ms(fn) for k, fn in (
        ("router_matmul", lambda: h @ router),
        ("topk_router_weights", lambda: topk_router_weights(logits, cfg.num_experts_per_tok)),
        ("combine", lambda: torch.einsum("bse,besd->bsd", w, y)))}


def _moe_w8_slices(results, qp, seed: int, on_card: bool) -> dict:
    """The int8-weight kernel on expert slices of the stacked leaves
    (``MOE_W8_SLICES``: ``QuantW[l][e]``, the packed matrix the engine's
    per-expert launch reads) at ``MOE_W8_M`` rows, bf16 x, against the plain
    version computed in f32 from the same logical q and scale, within
    ``w8_elem_bound``; on the card timed as ``_check_w8`` times a shape
    (rows into ``results["shapes"]``). Returns the rows. On the CPU the
    wrapper's output is the plain version's (bf16) and only shapes and
    slicing are exercised."""
    import torch

    from agentfield_tpu_torch.models.quant import int8_weight_matmul

    dev = qp["embed"].device
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 13)
    rows = {}
    for leaf, li, ei in MOE_W8_SLICES:
        li, ei = li % qp["layers"][leaf].shape[0], ei % qp["layers"][leaf].shape[1]
        w = qp["layers"][leaf][li][ei]
        q, scale = w.logical(), w.scale
        K, N = q.shape
        w16 = (q.float() * scale).to(torch.bfloat16) if on_card else None
        for M in MOE_W8_M:
            x = torch.empty((M, K), device=dev).normal_(0.0, 1.0, generator=g).to(torch.bfloat16)
            s_abs = (x.float().abs() @ q.float().abs()) * scale
            y_k = int8_weight_matmul(x, w)
            # on the CPU the wrapper runs the plain version itself: held to it
            y_r = (x.float() @ q.float()) * scale if on_card else y_k.float()
            ok, err, ratio = w8_compare(y_k, y_r, s_abs, K, "bfloat16")
            name = f"w8_moe_{leaf}_l{li}e{ei}_M{M}/bfloat16"
            row = {"kernel": "int8_weight_matmul", "dtype": "bfloat16", "M": M, "K": K, "N": N,
                   "leaf": leaf, "layer": li, "expert": ei, "max_abs_err": err,
                   "max_err_over_bound": ratio, "ok": ok}
            if on_card:
                from agentfield_tpu_torch.ops.cuda.quant_matmul import plan

                row["plan"] = plan(M, K, N, torch.cuda.get_device_properties(dev)
                                   .multi_processor_count)
                row["bound_ms"], row["bound_by"] = bound_ms(
                    K * N + 4 * N + 2 * (M * K + M * N), 2 * M * K * N, "bfloat16")
                row["ms"] = graph_ms(lambda: int8_weight_matmul(x, w))
                row["call_ms"] = cuda_ms(lambda: int8_weight_matmul(x, w))
                row["plain_ms"] = cuda_ms(lambda: (x.float() @ q.float()) * scale, n=5, warmup=1)
                row["library_ms"] = w8_library_ms(x, q, scale)
                row["cublas_bf16_ms"] = cuda_ms(lambda: x @ w16)
                results["shapes"][name] = row
            rows[name] = row
            log(f"[moe] (e) {name} err={err:.2e} err/bound={ratio:.3f} "
                + (f"ms={row['ms']:.4f} call={row['call_ms']:.4f} plain={row['plain_ms']:.4f} "
                   f"int8pack={row['library_ms']} cublas_bf16={row['cublas_bf16_ms']:.4f} "
                   f"bound={row['bound_ms']:.4f} ({row['bound_by']}) plan={row['plan']}"
                   if on_card else "(plain on both sides: CPU)"))
            assert ok, f"{name}: the int8-weight kernel and the plain version disagree"
            del x, y_r, s_abs, y_k
        del q, w16
    return rows


class RoutingReplay:
    """Routing held fixed across forwards of a MoE model: in "record" mode
    every call of ``models.moe.topk_router_weights`` and ``sparse_plan``
    (in forward order: one a layer) notes the experts it chooses; in
    "replay" mode the i-th call sets every other expert's logit to -inf
    before the real function runs, so it chooses the recorded experts and
    weights them by the replaying forward's own logits. ``flips`` counts
    the (token, layer) choices a replaying forward would have made
    otherwise. Two arithmetic paths (kernel and plain, bf16 and f32) are
    compared on one routing: top-k is discontinuous, and a near tie that
    the two paths' roundings resolve differently moves that token by a
    whole expert's contribution, which no rounding bound covers."""

    def __init__(self):
        from agentfield_tpu_torch.models import moe

        self.moe, self.orig = moe, (moe.topk_router_weights, moe.sparse_plan)
        self.recorded: list = []
        self.mode, self.i, self.flips, self.choices = "record", 0, 0, 0

    def start(self, mode: str) -> None:
        if mode == "record":
            self.recorded = []
        self.mode, self.i, self.flips, self.choices = mode, 0, 0, 0

    def _route(self, logits, k):
        import torch

        own = torch.topk(logits, k, dim=-1, sorted=True).indices
        if self.mode == "record":
            self.recorded.append(own)
            return logits
        idx = self.recorded[self.i]
        self.i += 1
        self.flips += int((own.sort(-1).values != idx.sort(-1).values).any(-1).sum())
        self.choices += own[..., 0].numel()
        chosen = torch.zeros_like(logits, dtype=torch.bool).scatter(-1, idx, True)
        return torch.where(chosen, logits, float("-inf"))

    def __enter__(self):
        topk, plan = self.orig
        self.moe.topk_router_weights = lambda logits, k: topk(self._route(logits, k), k)
        self.moe.sparse_plan = (lambda logits, k, capacity, valid=None:
                                plan(self._route(logits, k), k, capacity, valid))
        return self

    def __exit__(self, *exc):
        self.moe.topk_router_weights, self.moe.sparse_plan = self.orig


def release_cublas_workspaces() -> None:
    """Free cuBLAS's per-stream workspaces: 32 MiB on the card for every
    stream that ran a cuBLAS call, kept for the life of the process (each
    engine's worker stream leaves one: about 60 by the MoE phase, 1.9 GiB).
    They are a cache cuBLAS makes again at its next call on a stream, not
    data of an earlier phase, but ``memory_allocated`` counts them."""
    import torch

    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()


def phase_moe(results, seed: int, device: str = "cuda", model: str = MOE_MODEL,
              lengths=(64, 200, 333, 480, 512, 700, 1100, 1500), max_new: int = 32,
              S: int = 512, spec_prompts=MOE_SPEC_PROMPTS, burst=MOE_BURST, ecfg=None):
    """Mixtral-8x7B on one card with weight-only int8 layer weights, run
    after the 8B weights are freed:

    (a) ``build_model_node(model, quant="int8")``: the weights drawn one
        matrix at a time, quantized and packed (``init_params(quantize=
        True)``); the seconds, the weight bytes on the card and the peak
        while drawing, which must stay below the int8 tree plus
        ``MOE_BUILD_SLACK`` (no bf16 stack is ever held);
    (b) the serve's requests over HTTP (``phase_serve``), under
        ``moe_prefill_impl`` "dense" and then "sparse" (a second node on the
        same weights): every answer complete and finite, each decode
        step's graph ``w8_launches_per_step`` (28 L) int8 launches, each
        step counted, the attention through the split-context kernel and
        the tensor-core tile; TTFT p50, decode tok/s and the decode step's
        device ms of both;
    (c) full-width, full-depth logits at ``S`` tokens, kernel against plain
        (``plain_w8_params``, its expert products one expert at a time),
        soft and sparse routing, within PR 12's bounds (bf16:
        ``W8_LOGITS_BF16_FACTOR`` times the plain path's own bf16-vs-f32
        distance; f32: ``W8_LOGITS_F32_REL`` of max |logit|), all four
        forwards on the experts the kernel's bf16 forward chose
        (``RoutingReplay``; the choices each would have made otherwise are
        counted); sparse at factor E against soft, for information;
    (d) the replayed width-8 decode step: device ms, split by kernel kind,
        the routing ops named (profiler names and each op replayed alone);
    (e) the int8-weight kernel on expert slices at ``MOE_W8_M`` rows
        (``_moe_w8_slices``);
    (f) a self-draft speculative pass (k = 3, the same param tree) on
        ``spec_prompts``: each replay ``(k + 2) * 28 L`` int8 launches;
    (g) a mixed-tick burst (``mixed_burst``): the node's default ticks are
        classic.

    ``device="cpu"`` rehearses the phase on a small MoE preset (no graphs,
    no device times; the plain version on both sides)."""
    import dataclasses

    import numpy as np
    import torch

    from agentfield_tpu_torch.models import llama
    from agentfield_tpu_torch.models.configs import get_config
    from agentfield_tpu_torch.models.quant import QUANT_KEYS, QuantW, is_quantized
    from agentfield_tpu_torch.serving import model_node
    from agentfield_tpu_torch.serving.engine import EngineConfig, InferenceEngine, Request
    from agentfield_tpu_torch.serving.sampler import SamplingParams

    on_card = torch.device(device).type == "cuda"
    cfg = get_config(model)
    L, E, V = cfg.num_layers, cfg.num_experts, cfg.vocab_size
    assert E > 0, f"{model} is not a MoE preset"
    w8_per_step = w8_launches_per_step(cfg)
    if ecfg is None:  # the serve's geometry: 4096 pages of 2 MiB at Mixtral's width
        ecfg = EngineConfig(max_batch=32, page_size=16, num_pages=4096, max_pages_per_seq=128,
                            decode_buckets=(4, 16), grammar_slots=model_node.GRAMMAR_SLOTS)
    out: dict = {"model": model, "w8_launches_per_decode_step": w8_per_step}
    results["moe"] = out

    # (a) the node, its weights drawn quantized matrix by matrix
    gc.collect()
    held = 0
    if on_card:
        torch.cuda.empty_cache()
        release_cublas_workspaces()
        held = torch.cuda.memory_allocated()
        assert held < MOE_HELD_BEFORE, f"{held} bytes still allocated before the MoE build"
        torch.cuda.reset_peak_memory_stats()
    draw: dict = {}
    init = model_node.init_params

    def watched_init(*a, **k):  # the draw's peak, before the engine takes its pool
        t = time.perf_counter()
        p = init(*a, **k)
        if on_card:
            torch.cuda.synchronize()
            draw["peak_bytes"] = torch.cuda.max_memory_allocated() - held
        draw["seconds"] = time.perf_counter() - t
        return p

    model_node.init_params = watched_init
    t0 = time.perf_counter()
    try:
        node = model_node.build_model_node(
            model, seed=seed, ecfg=dataclasses.replace(ecfg, moe_prefill_impl="dense"),
            device=device, quant="int8")
    finally:
        model_node.init_params = init
    if on_card:
        torch.cuda.synchronize()
    qp = node[1].engine.params
    assert is_quantized(qp) and not isinstance(qp["layers"]["router"], QuantW)
    assert qp["layers"]["w_gate"].shape == (L, E, cfg.hidden_size, cfg.intermediate_size)
    wbytes = weight_bytes(qp)
    build = {"node_seconds": time.perf_counter() - t0, "draw_seconds": draw["seconds"],
             "weight_bytes": wbytes,
             "layer_int8_bytes": sum(qp["layers"][k].q.numel() + 4 * qp["layers"][k].scale.numel()
                                     for k in QUANT_KEYS),
             "kv_pool_bytes": node[1].engine.cache.hbm_bytes()}
    out["build"] = build
    if on_card:
        build["draw_peak_bytes"] = draw["peak_bytes"]
        build["draw_peak_bound"] = wbytes + MOE_BUILD_SLACK
        build["allocated_after_node"] = torch.cuda.memory_allocated()
        log(f"[moe] (a) {model} int8 node built in {build['node_seconds']:.1f} s (weights drawn, "
            f"quantized and packed in {build['draw_seconds']:.1f} s): weights {wbytes} bytes on "
            f"the card (layers {build['layer_int8_bytes']}), draw peak {draw['peak_bytes']} bytes "
            f"(bound {build['draw_peak_bound']}: the int8 tree + {MOE_BUILD_SLACK}), KV pool "
            f"{build['kv_pool_bytes']} bytes, {build['allocated_after_node'] / 2**30:.2f} GiB "
            f"allocated")
        assert draw["peak_bytes"] < build["draw_peak_bound"], build

    # (b) the serve, soft-routed prefill then sparse dispatch
    launches: dict = {}

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    for mode in ("dense", "sparse"):
        if mode == "sparse":
            node = model_node.build_model_node(
                model, seed=seed, ecfg=dataclasses.replace(ecfg, moe_prefill_impl="sparse"),
                device=device, params=qp, quant="int8")
        eng = node[1].engine
        assert eng.params is qp or eng.params["layers"]["w_gate"] is qp["layers"]["w_gate"]
        assert eng.prefill_cfg.moe_impl == ("sparse" if mode == "sparse" else "dense")
        assert eng.cfg.moe_impl == "dense"  # decode always soft-routes
        del eng
        phase_serve(results, {}, seed, model=model, device=device, lengths=lengths,
                    max_new=max_new, weight_quant="int8", node=node, label=f"moe_{mode}")
        del node
        gc.collect()
        r = results[f"serve_moe_{mode}"]
        add(r["launches"])
        add(r["w8_launches"])
        log(f"[moe] (b) prefill {mode}: {r['requests']} requests answered; TTFT p50 "
            f"{r['ttft_ms_p50']:.1f} ms, decode {r['decode_tok_per_s']:.1f} tok/s, decode step "
            f"{r['decode_step_device_ms_mean']} device ms, {w8_per_step} int8 launches a step")
    out["serve"] = {m: {k: results[f"serve_moe_{m}"][k] for k in (
        "ttft_ms_p50", "decode_tok_per_s", "decode_step_device_ms_mean", "peak_mem_gib")}
        for m in ("dense", "sparse")}
    if on_card:
        torch.cuda.empty_cache()

    # (c) full-width logits, kernel against plain, soft and sparse routing
    g = torch.Generator(device=device)
    g.manual_seed(seed + 1)
    tokens = torch.randint(0, V, (1, S), device=device, generator=g)
    pos = torch.arange(S, device=device)[None]

    def fwd(p, c):
        with torch.no_grad():
            lg, _ = llama.forward(p, c, tokens, pos, attn_impl="kernel", collect_kv=False)
        if on_card:
            torch.cuda.synchronize()
        assert lg.shape == (1, S, V) and bool(torch.isfinite(lg).all())
        return lg

    plain = plain_w8_params(qp)
    qp32, plain32 = f32_params(qp), f32_params(plain)
    out["logits"] = {}
    soft16 = None
    replay = RoutingReplay()
    for mode, c in (("soft", cfg), ("sparse", dataclasses.replace(cfg, moe_impl="sparse"))):
        # the kernel's bf16 forward chooses the experts; the other three
        # forwards take the same ones (RoutingReplay)
        runs, flips = {}, {}
        with replay:
            for name, p in (("kernel16", qp), ("plain16", plain), ("kernel32", qp32),
                            ("plain32", plain32)):
                replay.start("record" if name == "kernel16" else "replay")
                runs[name] = fwd(p, c)
                if name != "kernel16":
                    flips[name] = replay.flips
        lk16, lp16, lk32, lp32 = (runs[n] for n in ("kernel16", "plain16", "kernel32", "plain32"))
        scale = float(lp32.abs().max())
        err16, err32 = float((lk16 - lp16).abs().max()), float((lk32 - lp32).abs().max())
        noise16 = float((lp16 - lp32).abs().max())
        tol16, tol32 = W8_LOGITS_BF16_FACTOR * noise16, W8_LOGITS_F32_REL * scale
        out["logits"][mode] = {
            "S": S, "max_abs_logit": scale, "max_abs_err_bf16": err16, "tol_bf16": tol16,
            "plain_bf16_vs_f32": noise16, "max_abs_err_f32": err32, "tol_f32": tol32,
            "routing_choices": replay.choices, "routing_flips_if_free": flips,
            "kernel_vs_plain_argmax_agreement": float(
                (lk16.argmax(-1) == lp16.argmax(-1)).float().mean())}
        log(f"[moe] (c) {mode} routing, full-width logits at {S} tokens, kernel vs plain on the "
            f"kernel's bf16 routing: bf16 max|d| {err16:.4e} (tol {tol16:.4e} = "
            f"{W8_LOGITS_BF16_FACTOR} x the plain path's bf16-vs-f32 {noise16:.4e}); f32 max|d| "
            f"{err32:.4e} (tol {tol32:.4e}); of {replay.choices} (token, layer) choices each "
            f"forward would have chosen otherwise at {flips}")
        assert err32 <= tol32, f"full-width f32 forward ({mode}): int8 kernel and plain disagree"
        assert err16 <= tol16, f"full-width bf16 forward ({mode}): int8 kernel and plain disagree"
        if mode == "soft":
            soft16 = lk16
        del runs, lk16, lp16, lk32, lp32
    roomy = dataclasses.replace(cfg, moe_impl="sparse", moe_capacity_factor=float(E))
    d_roomy = float((fwd(qp, roomy) - soft16).abs().max())
    out["logits"]["sparse_factor_E_vs_soft_bf16"] = d_roomy
    log(f"[moe] (c) sparse dispatch at factor E = {E} against soft routing, bf16 kernel "
        f"logits, each routing freely: max|d| {d_roomy:.4e} (information: the two sum in "
        f"another order, and near ties of the top-k then resolve differently)")
    del plain, qp32, plain32, soft16
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # (d) the width-8 decode step, split by kernel kind
    if on_card:
        step = _step_device_ms(qp, cfg, seed)
        assert step["launches_per_replay"]["int8_weight_matmul"] == w8_per_step, step
        bd = step["breakdown"]
        if bd is not None:
            bd["moe_small_kernels_ms"] = _moe_small_kernels(bd["kernels_ms"])
        step["routing_ops_ms_per_step"] = _moe_op_ms(qp, cfg, step["width"], seed)
        out["step"] = step
        log(f"[moe] (d) replayed width-{step['width']} decode step ({step['live_rows']} live "
            f"rows): {step['step_device_ms']:.3f} device ms; by kind "
            f"{bd and bd['by_kind_ms']}; routing kernels {bd and bd['moe_small_kernels_ms']}; "
            f"each routing op replayed alone, x L: {step['routing_ops_ms_per_step']}; top "
            f"kernels {bd and bd['top_kernels_ms'][:5]}")
        gc.collect()
        torch.cuda.empty_cache()

    # (e) the int8-weight kernel on expert slices at the new row counts
    out["w8_slices"] = _moe_w8_slices(results, qp, seed, on_card)

    # (f) a self-draft speculative pass, k = 3
    rng = np.random.default_rng(seed + 31)
    k = 3
    eng = InferenceEngine(qp, cfg, dataclasses.replace(
        ecfg, num_pages=min(ecfg.num_pages, MOE_SPEC_PAGES), spec_k=k, grammar_slots=0),
        seed=seed, device=device, draft=(qp, cfg))
    rec = watch_spec(eng)
    reqs = [Request(f"s{i}", rng.integers(1, V, n).tolist(), SamplingParams(max_new_tokens=max_new))
            for i, n in enumerate(spec_prompts)]
    spec_out = eng.run_to_completion(reqs)
    assert all(len(spec_out[r.id]) == max_new for r in reqs)
    st = eng.stats
    assert st["spec_steps"] > 0, "no speculative step on the MoE target"
    replays = [r for r in rec["runs"] if r["replayed"]]
    if on_card:
        assert replays and all(r["launches"]["int8_weight_matmul"] == (k + 2) * w8_per_step
                               for r in replays if r["mode"].startswith("spec")), (
            [r["launches"] for r in replays[:2]])
    for r in rec["runs"]:
        add(r["launches"])
    out["spec"] = {"spec_steps": st["spec_steps"], "spec_emitted": st["spec_emitted"],
                   "replays": len(replays), "k": k,
                   "spec_step_device_ms_mean": (statistics.fmean(eng.spec_step_ms)
                                                if eng.spec_step_ms else None),
                   "w8_launches_per_spec_replay": (k + 2) * w8_per_step}
    eng.close()
    del eng
    gc.collect()
    log(f"[moe] (f) self-draft spec k={k}: {st['spec_steps']} spec steps emitting "
        f"{st['spec_emitted']} tokens, {len(replays)} replays of {(k + 2) * w8_per_step} int8 "
        f"launches each, {out['spec']['spec_step_device_ms_mean']} device ms a spec step")

    # (g) a mixed-tick burst
    out["mixed"] = mixed_burst(qp, cfg, ecfg, seed, burst, device, rng)
    add(out["mixed"]["mixed_tick_launches"])
    log(f"[moe] (g) mixed burst: {out['mixed']['mixed_ticks']} mixed ticks, launches in them "
        f"{out['mixed']['mixed_tick_launches']}, {out['mixed']['mixed_tick_device_ms_mean']} "
        f"device ms a tick")
    out["launches"] = {k: n for k, n in launches.items() if n}
    log(f"[moe] launches on the phase's main path: {out['launches']}")
    del qp
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase_ckpt: a Hugging Face checkpoint written, loaded and served
# ---------------------------------------------------------------------------

CKPT_SHARDS = 4  # Meta-Llama-3-8B's own shard count
CKPT_SPECIALS = 256  # Llama-3's special tokens: the last 256 ids of the model's vocab
CKPT_MERGES = 4000  # BPE merges the smoke's trainer learns from its seeded text
CKPT_TEXT_CHARS = 400_000  # of seeded text for the trainer
CKPT_MOE_LAYERS = 2  # Mixtral-8x7B written at 2 of its 32 layers (about 6.3 GB)
CKPT_MOE_LENGTHS = (64, 333, 700, 1500)
CKPT_DRAFT_PROMPTS = (200, 600, 1000)
# meta-llama/Meta-Llama-3-8B, config.json (the keys config_from_hf reads and
# those the loader ignores)
LLAMA3_8B_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "attention_bias": False, "attention_dropout": 0.0,
    "bos_token_id": 128000, "eos_token_id": 128001, "hidden_act": "silu", "hidden_size": 4096,
    "initializer_range": 0.02, "intermediate_size": 14336, "max_position_embeddings": 8192,
    "model_type": "llama", "num_attention_heads": 32, "num_hidden_layers": 32,
    "num_key_value_heads": 8, "pretraining_tp": 1, "rms_norm_eps": 1e-05, "rope_scaling": None,
    "rope_theta": 500000.0, "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "transformers_version": "4.40.0.dev0", "use_cache": True, "vocab_size": 128256}
# mistralai/Mixtral-8x7B-v0.1, config.json
MIXTRAL_CONFIG = {
    "architectures": ["MixtralForCausalLM"], "attention_dropout": 0.0, "bos_token_id": 1,
    "eos_token_id": 2, "hidden_act": "silu", "hidden_size": 4096, "initializer_range": 0.02,
    "intermediate_size": 14336, "max_position_embeddings": 32768, "model_type": "mixtral",
    "num_attention_heads": 32, "num_experts_per_tok": 2, "num_hidden_layers": 32,
    "num_key_value_heads": 8, "num_local_experts": 8, "output_router_logits": False,
    "rms_norm_eps": 1e-05, "rope_theta": 1000000.0, "router_aux_loss_coef": 0.02,
    "sliding_window": None, "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "transformers_version": "4.36.0.dev0", "use_cache": True, "vocab_size": 32000}
LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
                  r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
# meta-llama/Meta-Llama-3-8B-Instruct, tokenizer_config.json "chat_template"
LLAMA3_CHAT_TEMPLATE = (
    "{% set loop_messages = messages %}{% for message in loop_messages %}{% set content = "
    "'<|start_header_id|>' + message['role'] + '<|end_header_id|>\n\n'+ message['content'] | "
    "trim + '<|eot_id|>' %}{% if loop.index0 == 0 %}{% set content = bos_token + content %}"
    "{% endif %}{{ content }}{% endfor %}{% if add_generation_prompt %}{{ "
    "'<|start_header_id|>assistant<|end_header_id|>\n\n' }}{% endif %}")
CKPT_WORDS = (
    "the a of and to in is that for it as was with be by on not he this are or his from at "
    "which but have an they you were her she there been one all we their has would when if "
    "so no out up into do time only could new them than some other agent tool model token "
    "request answer decode prefill cache page kernel graph replay schema node control plane "
    "session stream call reply user assistant system message JSON value field list number "
    "string object true false null error retry deadline budget batch width layer expert "
    "route weight scale card memory bytes second Hello World Paris Berlin café naïve résumé "
    "straße Привет мир γειά σου 日本語 テキスト 中文 العربية हिन्दी 한국어 it's don't we'll "
    "they're I'm you've she'd 2024 3.14 100000 007 x1 v2 path/to/file.py snake_case CamelCase "
    "(note) [item] {key} <tag> #tag @user $5 50% a+b=c").split()

CKPT_SYLLABLES = [c + v for c in ("", "b", "ch", "d", "f", "g", "k", "l", "m", "n", "p", "r",
                                  "s", "sh", "t", "th", "v", "w", "z", "st", "tr", "pl")
                  for v in ("a", "e", "i", "o", "u", "ai", "ou", "er", "an", "in", "on", "y")]


def ckpt_text(rng, n_chars: int) -> str:
    """Seeded text of about ``n_chars`` characters: words, punctuation glued
    to the word before it, spaces and newlines (no space before a
    punctuation mark, so ``clean_up_tokenization_spaces`` leaves it as it
    is)."""
    out, n = [], 0
    while n < n_chars:
        if rng.random() < 0.5:
            w = CKPT_WORDS[int(rng.integers(len(CKPT_WORDS)))]
        else:  # a made-up word of 1-4 syllables: the vocabulary keeps growing
            w = "".join(CKPT_SYLLABLES[int(i)] for i in rng.integers(len(CKPT_SYLLABLES),
                                                                     size=int(rng.integers(1, 5))))
        r = rng.random()
        w += "." if r < 0.06 else "," if r < 0.12 else "?" if r < 0.14 else ""
        w += "\n" if rng.random() < 0.04 else "\n\n" if rng.random() < 0.01 else " "
        out.append(w)
        n += len(w)
    return "".join(out)[:n_chars]


def train_bpe(text: str, merges: int):
    """A byte-level BPE trainer (Llama-3's pre-tokenization): learns up to
    ``merges`` merges, most frequent pair first (ties to the smaller pair;
    a heap of counts, stale entries skipped), over the words of ``text``.
    Returns ``(vocab, merges)``: the 256 byte characters, then one token a
    merge."""
    import collections
    import heapq

    from agentfield_tpu_torch.serving.tokenizer import BYTE_TO_CHAR, onig_regex

    rx = onig_regex(LLAMA3_PATTERN)
    counts = collections.Counter(
        "".join(BYTE_TO_CHAR[b] for b in m.group().encode("utf-8")) for m in rx.finditer(text))
    words = [list(w) for w in counts]
    freq = [counts[w] for w in counts]
    pairs: collections.Counter = collections.Counter()
    where: dict = collections.defaultdict(set)
    for i, w in enumerate(words):
        for a, b in zip(w, w[1:]):
            pairs[a, b] += freq[i]
            where[a, b].add(i)
    heap = [(-n, p) for p, n in pairs.items()]
    heapq.heapify(heap)
    vocab = {BYTE_TO_CHAR[b]: None for b in sorted(BYTE_TO_CHAR, key=lambda b: ord(BYTE_TO_CHAR[b]))}
    learned = []
    while len(learned) < merges and heap:
        n, best = heapq.heappop(heap)
        if pairs.get(best, 0) != -n:
            continue  # a stale count
        if -n < 2:
            break
        a, b = best
        learned.append([a, b])
        vocab[a + b] = None
        touched = set()
        for i in list(where[best]):
            w, f = words[i], freq[i]
            for x, y in zip(w, w[1:]):  # take the word's pairs out, merge, put them back
                pairs[x, y] -= f
                where[x, y].discard(i)
                touched.add((x, y))
            j, out = 0, []
            while j < len(w):
                if j + 1 < len(w) and w[j] == a and w[j + 1] == b:
                    out.append(a + b)
                    j += 2
                else:
                    out.append(w[j])
                    j += 1
            words[i] = out
            for x, y in zip(out, out[1:]):
                pairs[x, y] += f
                where[x, y].add(i)
                touched.add((x, y))
        for p in touched:
            if pairs[p] > 0:
                heapq.heappush(heap, (-pairs[p], p))
            else:
                del pairs[p]
    return {t: i for i, t in enumerate(vocab)}, learned


def write_llama3_tokenizer(d: str, vocab_size: int, seed: int, n_specials: int = CKPT_SPECIALS,
                           merges: int = CKPT_MERGES) -> dict:
    """Write ``tokenizer.json`` (byte-level BPE in Llama-3's form: its split
    pattern, ``ignore_merges``, the BOS template, its special tokens at the
    last ``n_specials`` ids of the model's vocab) and ``tokenizer_config.json``
    (Llama-3's special tokens and the Instruct chat template) under ``d``.
    The merges are learned from seeded text (the real vocabulary is not on
    the machine)."""
    import numpy as np

    t0 = time.perf_counter()
    first = vocab_size - n_specials
    rng = np.random.default_rng(seed + 29)
    vocab, learned = train_bpe(ckpt_text(rng, CKPT_TEXT_CHARS), min(merges, first - 256))
    n_learned = len(vocab)
    # The rest of the BPE vocab, up to the first special id (the library
    # numbers the added tokens from the vocab's end, so they land there):
    # made-up whole words, with and without a leading space. With
    # ignore_merges a pre-token equal to one is that one id.
    while len(vocab) < first:
        w = "".join(CKPT_SYLLABLES[int(i)] for i in rng.integers(len(CKPT_SYLLABLES),
                                                                 size=int(rng.integers(2, 5))))
        for t in (w, "Ġ" + w, "Ġ" + w.capitalize()):
            if len(vocab) < first and t not in vocab:
                vocab[t] = len(vocab)
    names = ["<|begin_of_text|>", "<|end_of_text|>"] + [
        f"<|reserved_special_token_{i}|>" for i in range(4)] + [
        "<|start_header_id|>", "<|end_header_id|>", "<|reserved_special_token_4|>", "<|eot_id|>"]
    names += [f"<|reserved_special_token_{i}|>" for i in range(5, 5 + n_specials - len(names))]
    names = names[:n_specials]
    added = [{"id": first + i, "content": c, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True} for i, c in enumerate(names)]
    bos = {"SpecialToken": {"id": "<|begin_of_text|>", "type_id": 0}}
    doc = {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_PATTERN}, "behavior": "Isolated",
             "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
             "use_regex": False}]},
        "post_processor": {"type": "Sequence", "processors": [
            {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": False,
             "use_regex": True},
            {"type": "TemplateProcessing",
             "single": [bos, {"Sequence": {"id": "A", "type_id": 0}}],
             "pair": [bos, {"Sequence": {"id": "A", "type_id": 0}}, bos,
                      {"Sequence": {"id": "B", "type_id": 1}}],
             "special_tokens": {"<|begin_of_text|>": {
                 "id": "<|begin_of_text|>", "ids": [first], "tokens": ["<|begin_of_text|>"]}}}]},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                    "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": learned}}
    with open(os.path.join(d, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(doc, f, ensure_ascii=False)
    config = {"bos_token": "<|begin_of_text|>", "eos_token": "<|end_of_text|>",
              "clean_up_tokenization_spaces": True, "model_input_names": ["input_ids",
                                                                          "attention_mask"],
              "model_max_length": 1000000000000000019884624838656,
              "tokenizer_class": "PreTrainedTokenizerFast", "chat_template": LLAMA3_CHAT_TEMPLATE}
    with open(os.path.join(d, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump(config, f, ensure_ascii=False)
    return {"bpe_vocab": len(vocab), "merges": len(learned), "learned_vocab": n_learned,
            "specials": len(names), "first_special": first, "train_s": time.perf_counter() - t0}


def _dir_bytes(d: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))


class WatchedLoad:
    """Wraps ``hf_loader.load_hf_checkpoint`` while in use: the seconds of
    the load, the bytes of the tree it returns and, on the card, its peak
    device memory above what was allocated when it began."""

    def __init__(self, on_card: bool):
        self.on_card, self.out = on_card, {}

    def __enter__(self):
        import torch

        from agentfield_tpu_torch.models import hf_loader

        self._orig = orig = hf_loader.load_hf_checkpoint

        def load(*a, **k):
            if self.on_card:
                torch.cuda.synchronize()
                held = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            cfg, params = orig(*a, **k)
            if self.on_card:
                torch.cuda.synchronize()
                self.out["peak_bytes"] = torch.cuda.max_memory_allocated() - held
            self.out["seconds"] = time.perf_counter() - t
            self.out["tree_bytes"] = weight_bytes(params)
            return cfg, params

        hf_loader.load_hf_checkpoint = load
        return self.out

    def __exit__(self, *exc):
        from agentfield_tpu_torch.models import hf_loader

        hf_loader.load_hf_checkpoint = self._orig
        return False


def _leaves_equal(a: dict, b: dict) -> list[str]:
    """Names of the fp leaves of ``a`` that are not bit-equal to ``b``'s."""
    import torch

    bad = []
    for k, v in a.items():
        if isinstance(v, dict):
            bad += [f"{k}.{n}" for n in _leaves_equal(v, b[k])]
        elif not (v.dtype == b[k].dtype and v.shape == b[k].shape and torch.equal(v, b[k])):
            bad.append(k)
    return bad


def _quant_equal(qw, w) -> bool:
    """A loaded ``QuantW`` matrix against ``quantize_weight`` of the bf16
    matrix it was quantized from: q (packed on the card) and scale bit for
    bit."""
    import torch

    from agentfield_tpu_torch.models.quant import quantize_weight

    ref = quantize_weight(w)
    return (qw.packed == ref.packed and torch.equal(qw.q, ref.q)
            and torch.equal(qw.scale, ref.scale))


def _make_ckpt_dir(root: str | None, need_bytes: int, tag: str) -> str:
    import shutil
    import tempfile

    d = tempfile.mkdtemp(prefix=f"af_ckpt_{tag}_", dir=root)
    free = shutil.disk_usage(d).free
    log(f"[ckpt] {tag}: writing into {d}, {free / 1e9:.1f} GB free, {need_bytes / 1e9:.2f} GB "
        "to write")
    if free < need_bytes * 1.05:
        raise AssertionError(f"{d}: {free} bytes free, the checkpoint needs {need_bytes}")
    return d


def phase_ckpt(results, state, seed: int, device: str = "cuda", root: str | None = None,
               lengths=(64, 200, 333, 480, 512, 700, 1100, 1500), max_new: int = 32,
               draft_preset: str = SPEC_DRAFT, draft_prompts=CKPT_DRAFT_PROMPTS,
               shards: int = CKPT_SHARDS, merges: int = CKPT_MERGES):
    """The serve's model as a Hugging Face checkpoint (``state``'s weights,
    on the card), written, loaded and served through the port's entry
    points; the temporary directories are removed at the end, also on a
    failure:

    (a) the weights written in bf16 as HF tensors (``[out, in]``) in
        ``shards`` shards with ``model.safetensors.index.json``, tensor by
        tensor from the card (``hf_loader.save_hf_checkpoint``); the
        published ``config.json`` (Meta-Llama-3-8B's keys); a byte-level BPE
        ``tokenizer.json`` in Llama-3's form whose merges the smoke learns
        from seeded text (``train_bpe``), special tokens at the last 256 ids,
        and a ``tokenizer_config.json`` with the Llama-3-Instruct template;
    (b) ``build_model_node(checkpoint=DIR)``: ``config_from_hf`` equal to
        the preset, every leaf bit-equal to the param it was written from,
        the load's seconds and GB/s (page cache warm: the files were just
        written) and its peak device memory above the loaded tree (below
        ``MOE_BUILD_SLACK``);
    (c) the serve's script over HTTP through the loaded node
        (``phase_serve(node=...)``, ``tokens=`` so the ids are the serve's:
        every path through the hand-written kernels), and the greedy
        prompts one at a time through the loaded node and a ``params=``
        node on the same weights: the same tokens (the count equal to
        ``phase_serve``'s concurrent answers is printed);
    (d) text through the checkpoint's tokenizer: an ``Agent.ai()`` payload
        with ``messages`` (the template's rendering, encoded and decoded
        back), a ``response_schema`` request whose grammar is built from
        ``token_bytes`` at the model's vocab (compile ms), and
        ``decode(encode(s))`` of a text prompt of each serve length (the
        longest one's encode ms);
    (e) ``quant="int8"`` from the same directory: layers 0 and L-1 of every
        ``QUANT_KEYS`` leaf bit-equal to ``quantize_weight`` of the bf16
        matrices, the load's peak below the int8 tree + ``MOE_BUILD_SLACK``,
        the serve's script (``w8_launches_per_step`` int8 launches in each
        replayed decode step);
    (f) ``draft_preset`` written as a checkpoint directory (tied
        embeddings) and served as the draft of a ``spec_k=3`` node: draft
        leaves bit-equal to what was written, answers complete, each replay
        the launches ``expected_replay_launches`` gives (``phase_spec``'s).
    """
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from agentfield_tpu_torch.models.configs import get_config
    from agentfield_tpu_torch.models.hf_loader import (
        config_from_hf, hf_config_dict, save_hf_checkpoint,
    )
    from agentfield_tpu_torch.models.quant import QUANT_KEYS, QuantW
    from agentfield_tpu_torch.serving.model_node import build_model_node
    from agentfield_tpu_torch.serving.tokenizer import HFTokenizer

    on_card = torch.device(device).type == "cuda"
    params, cfg = state["params"], state["cfg"]
    # the serve's geometry in bf16 pages (the quantized-KV serves leave their
    # kind in state)
    ecfg = dataclasses.replace(state["ecfg"], kv_quant_dtype="none")
    L, V = cfg.num_layers, cfg.vocab_size
    dtype = str(params["embed"].dtype).removeprefix("torch.")
    out: dict = {"card": results.get("card"), "launches": {}}
    results["ckpt"] = out
    dirs: list[str] = []
    t_phase = time.perf_counter()

    def add_launches(serve):
        for counts in (serve["launches"], serve["w8_launches"]):
            for k, n in counts.items():
                out["launches"][k] = out["launches"].get(k, 0) + n

    gc.collect()
    try:
        # (a) write
        d = _make_ckpt_dir(root, weight_bytes(params), "llama")
        dirs.append(d)
        t0 = time.perf_counter()
        save_hf_checkpoint(d, cfg, params, dtype=dtype, shards=shards)
        write_s = time.perf_counter() - t0
        doc = dict(LLAMA3_8B_CONFIG) if cfg == get_config("llama-3-8b") else {
            **hf_config_dict(cfg), "torch_dtype": dtype}
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(doc, f, indent=2)
        tok_info = write_llama3_tokenizer(d, V, seed, n_specials=min(CKPT_SPECIALS, V // 8),
                                          merges=merges)
        ckpt_bytes = _dir_bytes(d)
        out["write"] = {"dir": d, "bytes": ckpt_bytes, "seconds": write_s,
                        "gb_per_s": ckpt_bytes / write_s / 1e9,
                        "files": sorted(os.listdir(d)), "tokenizer": tok_info}
        log(f"[ckpt] (a) {ckpt_bytes} bytes written in {write_s:.2f} s "
            f"({out['write']['gb_per_s']:.2f} GB/s) as {shards} bf16 shards + index; "
            f"tokenizer: {tok_info['bpe_vocab']} BPE tokens ({tok_info['merges']} merges learned, "
            f"the rest made-up whole words; {tok_info['train_s']:.1f} s), {tok_info['specials']} "
            f"specials from id {tok_info['first_special']}")
        assert os.path.exists(os.path.join(d, "model.safetensors.index.json"))
        got_cfg = config_from_hf(d)
        assert dataclasses.replace(got_cfg, dtype=cfg.dtype) == cfg, (got_cfg, cfg)

        # (b) load through the node
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        with WatchedLoad(on_card) as load:
            node = build_model_node(checkpoint=d, ecfg=ecfg, device=device, seed=seed)
        backend = node[1]
        assert isinstance(backend.tokenizer, HFTokenizer) and backend.model_name == d
        bad = _leaves_equal(backend.engine.params, params)
        assert not bad, f"loaded leaves differ from the written params: {bad[:5]}"
        out["load"] = {**load, "gb_per_s": ckpt_bytes / load["seconds"] / 1e9,
                       "leaves_bit_equal": True, "page_cache": "warm (just written)"}
        out["leaves_bit_equal"] = True
        if on_card:
            above = load["peak_bytes"] - load["tree_bytes"]
            out["load"]["peak_above_tree_bytes"] = above
            assert above < MOE_BUILD_SLACK, out["load"]
        log(f"[ckpt] (b) loaded in {load['seconds']:.2f} s ({out['load']['gb_per_s']:.2f} GB/s, "
            f"page cache warm: the files were just written); every leaf bit-equal; peak "
            f"{out['load'].get('peak_above_tree_bytes')} bytes above the loaded tree "
            f"({load['tree_bytes']} bytes; bound {MOE_BUILD_SLACK})")

        # (c) the serve's script, then greedy prompts of its lengths one at a
        # time (other ids: no prefix of the script's is cached for them)
        phase_serve(results, {}, seed, model=d, device=device, lengths=lengths, max_new=max_new,
                    node=node, label="ckpt")
        serve = results["serve_ckpt"]
        add_launches(serve)
        rng = np.random.default_rng(seed + 41)
        prompts = [rng.integers(1, V, n).tolist() for n in lengths]

        def one_by_one(nd):
            port = nd[0].start()
            try:
                return [_post(port, {"tokens": p, "max_new_tokens": max_new})["result"]["tokens"]
                        for p in prompts]
            finally:
                nd[0].stop()

        mine = one_by_one(node)
        ref_node = build_model_node(cfg_name(cfg), ecfg=ecfg, device=device, params=params,
                                    seed=seed)
        ref = one_by_one(ref_node)
        del ref_node
        same = [a == b for a, b in zip(mine, ref)]
        assert all(same), f"greedy tokens differ from the params= node's on {same.count(False)}"
        concurrent = results.get("serve", {}).get("greedy_tokens")
        out["greedy_equal"] = True
        out["serve"] = {k: serve[k] for k in ("ttft_ms_p50", "decode_tok_per_s",
                                              "decode_step_device_ms_mean", "peak_mem_gib")}
        out["serve"]["greedy_equal_to_params_node"] = len(same)
        if concurrent is not None and len(concurrent) == len(mine):
            out["serve"]["greedy_equal_to_phase_serve"] = sum(
                a == b for a, b in zip(serve["greedy_tokens"], concurrent))
        log(f"[ckpt] (c) the serve's script answered through the checkpoint node "
            f"(TTFT p50 {serve['ttft_ms_p50']:.1f} ms, decode step "
            f"{serve['decode_step_device_ms_mean']} device ms); {len(same)} greedy prompts one at "
            f"a time equal to the params= node's; concurrent answers equal to phase_serve's: "
            f"{out['serve'].get('greedy_equal_to_phase_serve')} of {len(lengths)}")

        # (d) text through the checkpoint's tokenizer
        out["text"] = _ckpt_text_checks(node, seed, lengths)
        del node, backend
        gc.collect()

        # (e) int8 on load from the same directory
        if on_card:
            torch.cuda.empty_cache()
        with WatchedLoad(on_card) as load:
            qnode = build_model_node(checkpoint=d, ecfg=dataclasses.replace(ecfg, num_pages=1024),
                                     device=device, seed=seed, quant="int8")
        qp = qnode[1].engine.params
        ok = all(_quant_equal(qp["layers"][k][l], params["layers"][k][l])
                 for k in QUANT_KEYS for l in (0, L - 1))
        assert ok, "int8 on load differs from quantize_weight of the loaded bf16 matrices"
        assert all(isinstance(qp["layers"][k], QuantW) for k in QUANT_KEYS)
        out["int8"] = {**load, "bit_equal": True, "layers_checked": [0, L - 1],
                       "gb_per_s": ckpt_bytes / load["seconds"] / 1e9}
        if on_card:
            bound = load["tree_bytes"] + MOE_BUILD_SLACK
            out["int8"]["peak_bound"] = bound
            out["int8"]["peak_above_tree_bytes"] = load["peak_bytes"] - load["tree_bytes"]
            assert load["peak_bytes"] < bound, out["int8"]
        log(f"[ckpt] (e) int8 on load in {load['seconds']:.2f} s "
            f"({out['int8']['gb_per_s']:.2f} GB/s of bf16 read): int8 tree {load['tree_bytes']} "
            f"bytes, peak {load.get('peak_bytes')} ({out['int8'].get('peak_above_tree_bytes')} "
            f"above the tree; bound the tree + {MOE_BUILD_SLACK}); layers 0 and {L - 1} of every "
            f"projection bit-equal to quantize_weight of the bf16 matrices")
        phase_serve(results, {}, seed, model=d, device=device, lengths=lengths[:4],
                    max_new=max_new, weight_quant="int8", node=qnode, label="ckpt_w8")
        add_launches(results["serve_ckpt_w8"])
        out["int8"]["serve"] = {k: results["serve_ckpt_w8"][k] for k in (
            "ttft_ms_p50", "decode_step_device_ms_mean", "w8_launches_per_decode_step")}
        del qnode, qp
        gc.collect()

        # (f) a draft checkpoint
        out["draft"] = _ckpt_draft(results, state, seed, device, root, dirs, draft_preset,
                                   draft_prompts, max_new)
        for k, n in out["draft"]["launches"].items():
            out["launches"][k] = out["launches"].get(k, 0) + n
        out["phase_s"] = time.perf_counter() - t_phase
        log(f"[ckpt] phase {out['phase_s']:.1f} s; launches {out['launches']}; "
            f"{results.get('card')}")
    finally:
        for x in dirs:
            shutil.rmtree(x, ignore_errors=True)
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()


def cfg_name(cfg) -> str:
    """The preset whose config ``cfg`` is (its dtype aside)."""
    import dataclasses

    from agentfield_tpu_torch.models.configs import PRESETS

    for name, c in PRESETS.items():
        if dataclasses.replace(c, dtype=cfg.dtype) == cfg:
            return name
    raise KeyError(f"no preset has config {cfg}")


def _ckpt_text_checks(node, seed: int, lengths) -> dict:
    """(d) of ``phase_ckpt`` on the loaded node."""
    import numpy as np

    from agentfield_tpu_torch.serving.grammar import compile_json_schema

    server, backend = node
    tok = backend.tokenizer
    V = backend.engine.cfg.vocab_size
    bos = tok.decode([tok.token_to_id("<|begin_of_text|>")])
    out: dict = {}
    # decode(encode(s)) == s for a text prompt of each serve length
    rng = np.random.default_rng(seed + 31)
    texts = [ckpt_text(rng, n) for n in lengths]
    enc_ms = []
    for s in texts:
        t = time.perf_counter()
        ids = tok.encode(s)
        enc_ms.append((time.perf_counter() - t) * 1e3)
        assert ids[0] == tok.token_to_id("<|begin_of_text|>")
        assert tok.decode(ids) == bos + s, s[:80]
    out["round_trip"] = True
    out["encode_ms_longest"] = enc_ms[-1]
    out["encode_tokens_longest"] = len(tok.encode(texts[-1]))
    out["prompt_chars"] = list(lengths)
    # an Agent.ai() payload with messages
    messages = [{"role": "system", "content": "You answer in one short line."},
                {"role": "user", "content": texts[1]}]
    rendered = backend.apply_chat_template(messages)
    want = (bos + "<|start_header_id|>system<|end_header_id|>\n\n"
            + messages[0]["content"].strip() + "<|eot_id|><|start_header_id|>user<|end_header_id|>"
            "\n\n" + messages[1]["content"].strip() + "<|eot_id|>"
            "<|start_header_id|>assistant<|end_header_id|>\n\n")
    assert rendered == want, rendered[:200]
    ids = tok.encode(rendered)
    assert tok.decode(ids) == bos + rendered  # the template's BOS, then the encoder's
    port = server.start()
    try:
        r = _post(port, sdk_payload(messages=messages, max_new_tokens=16))["result"]
        assert len(r["tokens"]) > 0 and r["text"] == tok.decode(r["tokens"]), r
        t = time.perf_counter()
        token_bytes = tok.token_bytes(V)
        out["token_bytes_ms"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        compile_json_schema(SERVE_SCHEMA, token_bytes)  # cold: the node's own is cached
        out["grammar_compile_ms"] = (time.perf_counter() - t) * 1e3
        g = backend._grammar_for(SERVE_SCHEMA)
        s = _post(port, {"prompt": "Reply with a JSON object.", "max_new_tokens": 64,
                         "response_schema": SERVE_SCHEMA})["result"]
    finally:
        server.stop()
    body = b"".join(token_bytes[t] for t in s["tokens"])
    assert s["finish_reason"] == "stop" and grammar_accepts(g, s["tokens"]), (s, body)
    value = json.loads(tok.decode(s["tokens"]))
    assert set(value) == {"ok", "mode"}, value
    out["schema_valid"] = True
    out["schema_text"] = s["text"]
    out["messages_answer_tokens"] = len(r["tokens"])
    out["messages_prompt_tokens"] = len(ids)
    log(f"[ckpt] (d) decode(encode(s)) == s for {len(texts)} prompts of {lengths[0]}-"
        f"{lengths[-1]} chars; the longest ({out['encode_tokens_longest']} tokens) encoded in "
        f"{out['encode_ms_longest']:.2f} ms; messages payload rendered by the template "
        f"({len(ids)} tokens, two BOS) and answered ({len(r['tokens'])} tokens); token_bytes at "
        f"vocab {V} in {out['token_bytes_ms']:.1f} ms, the schema's grammar compiled in "
        f"{out['grammar_compile_ms']:.1f} ms, answer {s['text']!r}")
    return out


def _ckpt_draft(results, state, seed, device, root, dirs, draft_preset, prompts, max_new) -> dict:
    """(f) of ``phase_ckpt``."""
    import dataclasses

    import numpy as np
    import torch

    from agentfield_tpu_torch.models.configs import get_config
    from agentfield_tpu_torch.models.hf_loader import save_hf_checkpoint
    from agentfield_tpu_torch.models.llama import init_params
    from agentfield_tpu_torch.ops.cuda import ragged_paged_attention as rpa
    from agentfield_tpu_torch.serving.engine import EngineConfig
    from agentfield_tpu_torch.serving.model_node import GRAMMAR_SLOTS, build_model_node

    params, cfg = state["params"], state["cfg"]
    dcfg = get_config(draft_preset)
    dparams = init_params(dcfg, seed=seed + 4, device=device, dtype=params["embed"].dtype)
    d = _make_ckpt_dir(root, weight_bytes(dparams), "draft")
    dirs.append(d)
    save_hf_checkpoint(d, dcfg, dparams, dtype=str(params["embed"].dtype).removeprefix("torch."))
    base = EngineConfig(max_batch=32, page_size=16, num_pages=SPEC_PAGES, max_pages_per_seq=128,
                        decode_buckets=(4, 16), grammar_slots=GRAMMAR_SLOTS)
    server, backend = build_model_node(cfg_name(cfg), ecfg=base, device=device, params=params,
                                       seed=seed, spec_draft=d, spec_k=3)
    eng = backend.engine
    bad = _leaves_equal(eng.draft_params, dparams)
    assert not bad, f"draft leaves differ from what was written: {bad[:5]}"
    assert ("lm_head" in eng.draft_params) == (not dcfg.tie_embeddings)
    rec = watch_spec(eng)
    rng = np.random.default_rng(seed + 17)
    reqs = [rng.integers(1, cfg.vocab_size, n).tolist() for n in prompts]
    answers: dict = {}
    errors: list = []
    port = server.start()
    rpa.reset_launches()  # count the draft node's main path only
    try:
        def send(i):
            try:
                answers[i] = _post(port, {"tokens": reqs[i], "max_new_tokens": max_new})["result"]
            except Exception as e:  # noqa: BLE001 — collected and failed below
                errors.append(repr(e))

        threads = [threading.Thread(target=send, args=(i,)) for i in range(len(reqs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        server.stop()
    assert not errors, errors
    launches = rpa.launch_counts()
    for a in answers.values():
        assert len(a["tokens"]) == max_new and a["finish_reason"] == "length", a
    on_card = torch.device(device).type == "cuda"
    replays = [r for r in rec["runs"] if r["replayed"]]
    wrong = [r for r in replays if {k: n for k, n in r["launches"].items() if n} != {
        k: n for k, n in expected_replay_launches(eng, r["mode"]).items() if n}]
    assert not wrong, f"replays counted other launches than expected: {wrong[:2]}"
    per_replay = {m: {k: n for k, n in expected_replay_launches(eng, m).items() if n}
                  for m in sorted({r["mode"] for r in replays})}
    spec_ref = results.get("spec", {}).get("c_draft_k3", {}).get("launches_per_replay", {})
    for m, want in spec_ref.items():
        if m in per_replay:
            assert per_replay[m] == want, (m, per_replay[m], want)
    if on_card:
        assert any(r["mode"].startswith("spec") for r in replays), "no speculative replay"
    out = {"leaves_bit_equal": True, "requests": len(reqs), "spec_steps": eng.stats["spec_steps"],
           "replays": len(replays), "launches_per_replay": per_replay,
           "launches": {k: n for k, n in launches.items() if n}}
    log(f"[ckpt] (f) {draft_preset} from a checkpoint directory as the k = 3 draft: leaves "
        f"bit-equal, {len(reqs)} answers complete, {out['spec_steps']} spec steps, "
        f"{len(replays)} replays each with its expected launches {per_replay}")
    backend.engine.close()
    return out


def phase_ckpt_moe(results, seed: int, device: str = "cuda", model: str = MOE_MODEL,
                   layers: int = CKPT_MOE_LAYERS, root: str | None = None,
                   lengths=CKPT_MOE_LENGTHS, max_new: int = 16, ecfg=None):
    """(g) of ``phase_ckpt``, run after the 8B weights are freed:
    ``model`` at full width and ``layers`` of its layers, random bf16
    weights written with the HF ``block_sparse_moe`` names (the published
    ``config.json`` at the reduced depth), loaded by
    ``build_model_node(checkpoint=DIR, quant="int8")``: every ``QuantW``
    matrix (experts included) bit-equal to ``quantize_weight`` of the bf16
    matrix it was written from, the load's peak below the int8 tree +
    ``MOE_BUILD_SLACK``, the serve's script answered under soft and sparse
    prefill (``w8_launches_per_step`` int8 launches a replayed step)."""
    import dataclasses
    import shutil

    import torch

    from agentfield_tpu_torch.models.configs import get_config
    from agentfield_tpu_torch.models.hf_loader import save_hf_checkpoint
    from agentfield_tpu_torch.models.llama import init_params
    from agentfield_tpu_torch.models.quant import QUANT_KEYS
    from agentfield_tpu_torch.serving.engine import EngineConfig
    from agentfield_tpu_torch.serving.model_node import GRAMMAR_SLOTS, build_model_node

    on_card = torch.device(device).type == "cuda"
    cfg = dataclasses.replace(get_config(model), num_layers=layers)
    if ecfg is None:
        ecfg = EngineConfig(max_batch=32, page_size=16, num_pages=1024, max_pages_per_seq=128,
                            decode_buckets=(4, 16), grammar_slots=GRAMMAR_SLOTS)
    out: dict = {"layers": layers}
    ckpt = results.setdefault("ckpt", {})
    ckpt["moe"] = out
    ckpt.setdefault("launches", {})
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        assert torch.cuda.memory_allocated() < MOE_HELD_BEFORE, torch.cuda.memory_allocated()
    d = None
    t_phase = time.perf_counter()
    try:
        params = init_params(cfg, seed=seed, device=device)
        dtype = str(params["embed"].dtype).removeprefix("torch.")
        d = _make_ckpt_dir(root, weight_bytes(params), "mixtral")
        t0 = time.perf_counter()
        save_hf_checkpoint(d, cfg, params, dtype=dtype, shards=2)
        out["write_s"] = time.perf_counter() - t0
        doc = ({**MIXTRAL_CONFIG, "num_hidden_layers": layers} if model == "mixtral-8x7b" else
               {**json.load(open(os.path.join(d, "config.json"))), "torch_dtype": dtype})
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(doc, f, indent=2)
        out["bytes"] = _dir_bytes(d)
        gc.collect()
        with WatchedLoad(on_card) as load:
            node = build_model_node(checkpoint=d, device=device, seed=seed, quant="int8",
                                    ecfg=dataclasses.replace(ecfg, moe_prefill_impl="dense"))
        qp = node[1].engine.params
        E = cfg.num_experts
        ok = all(_quant_equal(qp["layers"][k][l], params["layers"][k][l])
                 for k in ("wq", "wk", "wv", "wo") for l in range(layers))
        ok = ok and all(_quant_equal(qp["layers"][k][l][e], params["layers"][k][l, e])
                        for k in ("w_gate", "w_up", "w_down") for l in range(layers)
                        for e in range(E))
        assert ok, "int8 expert stacks differ from quantize_weight of the written bf16 matrices"
        assert not _leaves_equal({"router": qp["layers"]["router"]},
                                 {"router": params["layers"]["router"]})
        assert set(QUANT_KEYS) <= set(qp["layers"])
        out["load"] = {**load, "gb_per_s": out["bytes"] / load["seconds"] / 1e9,
                       "bit_equal": True, "experts_checked": layers * E * 3}
        out["bit_equal"] = True
        if on_card:
            out["load"]["peak_bound"] = load["tree_bytes"] + MOE_BUILD_SLACK
            out["load"]["peak_above_tree_bytes"] = load["peak_bytes"] - load["tree_bytes"]
            assert load["peak_bytes"] < out["load"]["peak_bound"], out["load"]
        del params
        gc.collect()
        log(f"[ckpt] (g) {model} at {layers} layers: {out['bytes']} bytes written in "
            f"{out['write_s']:.2f} s, loaded as int8 in {load['seconds']:.2f} s "
            f"({out['load']['gb_per_s']:.2f} GB/s); {layers * E * 3} expert matrices and the "
            f"attention projections bit-equal to quantize_weight; peak {load.get('peak_bytes')} "
            f"bytes ({out['load'].get('peak_above_tree_bytes')} above the int8 tree of "
            f"{load['tree_bytes']}; bound the tree + {MOE_BUILD_SLACK})")
        for mode in ("dense", "sparse"):
            if mode == "sparse":
                gc.collect()
                node = build_model_node(checkpoint=d, device=device, seed=seed, quant="int8",
                                        ecfg=dataclasses.replace(ecfg, moe_prefill_impl="sparse"))
            assert node[1].engine.prefill_cfg.moe_impl == mode
            phase_serve(results, {}, seed, model=d, device=device, lengths=lengths,
                        max_new=max_new, weight_quant="int8", node=node,
                        label=f"ckpt_moe_{mode}")
            r = results[f"serve_ckpt_moe_{mode}"]
            out[mode] = {k: r[k] for k in ("requests", "ttft_ms_p50", "decode_step_device_ms_mean")}
            for counts in (r["launches"], r["w8_launches"]):
                for k, n in counts.items():
                    ckpt["launches"][k] = ckpt["launches"].get(k, 0) + n
            del node
            gc.collect()
        out["phase_s"] = time.perf_counter() - t_phase
        log(f"[ckpt] (g) phase {out['phase_s']:.1f} s; {results.get('card')}")
    finally:
        if d is not None:
            shutil.rmtree(d, ignore_errors=True)
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()


def phase_ckpt_rehearsal(results, model: str, root) -> None:
    """``phase_ckpt`` (or, for a MoE preset, ``phase_ckpt_moe``) on the CPU
    at a small size: ``model`` (a bf16 preset, as the card serves) served by
    ``phase_serve`` first (its weights are what the checkpoint holds),
    llama-tiny's shape as the draft."""
    import dataclasses

    from agentfield_tpu_torch.serving.engine import EngineConfig

    ecfg = EngineConfig(max_batch=8, page_size=16, num_pages=256, max_pages_per_seq=32,
                        decode_buckets=(4,), grammar_slots=64)
    if model.startswith("mixtral"):
        phase_ckpt_moe(results, 0, device="cpu", model=model, layers=2, root=str(root),
                       lengths=(8, 20), max_new=4, ecfg=ecfg)
        return
    state: dict = {}
    phase_serve(results, state, 0, model=model, device="cpu", ecfg=ecfg, lengths=(8, 20, 33),
                max_new=6)
    state["ecfg"] = dataclasses.replace(ecfg, kv_quant_dtype="fp8")  # as the KV serves leave it
    phase_ckpt(results, state, 0, device="cpu", root=str(root), lengths=(8, 20, 33, 60),
               max_new=6, draft_preset="llama-tiny", draft_prompts=(12, 30), shards=2, merges=300)


# Fine-tune -> merge -> serve on the card (phase_train): LoRA on the serve's
# Llama-3-8B weights, its adapter served through build_model_node(lora=) in
# bf16 and int8, a full fine-tune of Llama-3.2-1B with its train-state
# checkpoint resumed, and train -> export -> serve
TRAIN_LORA_BATCH = (2, 2048)  # B x S random tokens, one batch
TRAIN_LORA_STEPS = 8
TRAIN_LORA_LR = 1e-3
TRAIN_FULL_MODEL = "llama-3.2-1b"
TRAIN_FULL_BATCH = (4, 2048)
TRAIN_FULL_STEPS = 3  # before the checkpoint; two more after it on both states
TRAIN_FULL_LR = 3e-4
TRAIN_MIN_DROP = 1e-3  # nats the loss must fall over the LoRA and the full runs
TRAIN_STEP0_RTOL = 1e-6  # step-0 LoRA loss against the base loss (b = 0: the same forward)
TRAIN_RESUME_RTOL = 2e-3  # the second step after a restore against the uninterrupted run's
TRAIN_PROMPTS = (64, 300, 700)
TRAIN_NEW = 16
TRAIN_PAGES = 1024
TRAIN_LOGITS_S = 512
# phase_train on the CPU at a small size (tests/test_torch_trainer.py)
TRAIN_REHEARSAL = dict(
    lora_model="llama-tiny", lora_batch=(2, 32), lora_steps=4, lora_lr=1e-2,
    full_model="llama-nano", full_batch=(2, 32), full_steps=2, full_lr=1e-2,
    prompts=(5, 17, 40), max_new=4, logits_s=16,
    ecfg=dict(max_batch=2, page_size=8, num_pages=64, max_pages_per_seq=8),
)


def _timed_steps(step, state, args, n: int, on_card: bool) -> tuple[list[float], list[float]]:
    """``n`` calls of ``step(state, *args)``: the losses and each step's ms
    (CUDA events around the call on the card, the host clock on the CPU)."""
    import torch

    losses, ms = [], []
    for _ in range(n):
        if on_card:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
        t = time.perf_counter()
        state, m = step(state, *args)
        loss = float(m["loss"])  # waits for the step
        if on_card:
            e1.record()
            e1.synchronize()
            ms.append(e0.elapsed_time(e1))
        else:
            ms.append((time.perf_counter() - t) * 1e3)
        assert math.isfinite(loss), f"step {len(losses)}: loss {loss}"
        losses.append(loss)
    return losses, ms


def _attention_line(rep: dict) -> str:
    a = rep["attention"]
    share = a["plain_step_ms_est"] / rep["step_ms_median_after_first"]
    return (f"the plain attention a layer: forward {a['plain_fwd_ms']:.2f} ms, forward + backward "
            f"{a['plain_fwd_bwd_ms']:.2f} ms, so about {a['plain_step_ms_est']:.0f} ms of the "
            f"step's {rep['step_ms_median_after_first']:.0f} ({share:.0%}); the kernel's forward "
            f"{a['kernel_fwd_ms']:.3f} ms; SDPA forward + backward {a['sdpa_fwd_bwd_ms']} ms "
            "(yardsticks)")


def _first_layer(name: str, t):
    """A stacked layer leaf's layer 0, any other leaf whole."""
    return t[0] if name.startswith("layers.") else t


def _step_report(losses, ms, tokens: int, peak) -> dict:
    warm = ms[1:] or ms  # the first step pays the allocator's growth
    med = statistics.median(warm)
    return {"losses": losses, "step_ms": ms, "step_ms_median_after_first": med,
            "tokens_per_step": tokens, "tokens_per_s": tokens / med * 1e3,
            "peak_mem_gib": None if peak is None else peak / 2**30}


def train_attention_ms(cfg, B: int, S: int, seed: int) -> dict:
    """What the training step's attention costs at ``cfg``'s heads, B x S,
    bf16 on the card: the plain ``attention_ref`` (float32 softmax and
    einsums, what the trainer runs) forward alone and forward + backward a
    layer, the step's share estimated as ``L * (fwd + fwd_bwd)`` (remat runs
    each forward twice); beside it the hand-written kernel's forward
    (``dense_causal_attention``, no backward) and PyTorch's
    ``scaled_dot_product_attention`` forward + backward, yardsticks the port
    does not call. CUDA events, medians of 5."""
    import torch
    import torch.nn.functional as F

    from agentfield_tpu_torch.models.llama import attention_ref
    from agentfield_tpu_torch.ops.cuda.ragged_paged_attention import dense_causal_attention

    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 73)

    def rnd(n):
        return torch.randn((B, S, n, cfg.head_dim), generator=g, device="cuda",
                           dtype=torch.bfloat16)

    q, k, v = rnd(cfg.num_heads), rnd(cfg.num_kv_heads), rnd(cfg.num_kv_heads)
    dout = torch.randn_like(q)
    pos = torch.arange(S, device="cuda").expand(B, S)
    valid = torch.ones((B, S), dtype=torch.bool, device="cuda")
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))

    def plain_fwd():
        with torch.no_grad():
            attention_ref(q, k, v, pos, pos, valid)

    def plain_fwd_bwd():
        attention_ref(qg, kg, vg, pos, pos, valid).backward(dout)

    def kernel_fwd():
        with torch.no_grad():
            dense_causal_attention(q, k, v)

    def sdpa_fwd_bwd():
        t = (x.transpose(1, 2) for x in (qg, kg, vg))
        F.scaled_dot_product_attention(*t, is_causal=True, enable_gqa=True).backward(
            dout.transpose(1, 2))

    out = {"plain_fwd_ms": cuda_ms(plain_fwd, n=5, warmup=1),
           "plain_fwd_bwd_ms": cuda_ms(plain_fwd_bwd, n=5, warmup=1),
           "kernel_fwd_ms": cuda_ms(kernel_fwd, n=5, warmup=1)}
    try:
        out["sdpa_fwd_bwd_ms"] = cuda_ms(sdpa_fwd_bwd, n=5, warmup=1)
    except (TypeError, RuntimeError) as e:
        out["sdpa_fwd_bwd_ms"] = None
        log(f"[train] sdpa unavailable here: {e!r}")
    out["plain_step_ms_est"] = cfg.num_layers * (out["plain_fwd_ms"] + out["plain_fwd_bwd_ms"])
    return out


def phase_train(results, state, seed: int, device: str = "cuda", root: str | None = None,
                lora_model: str = "llama-3-8b", lora_batch=TRAIN_LORA_BATCH,
                lora_steps: int = TRAIN_LORA_STEPS, lora_lr: float = TRAIN_LORA_LR,
                full_model: str = TRAIN_FULL_MODEL, full_batch=TRAIN_FULL_BATCH,
                full_steps: int = TRAIN_FULL_STEPS, full_lr: float = TRAIN_FULL_LR,
                prompts=TRAIN_PROMPTS, max_new: int = TRAIN_NEW,
                logits_s: int = TRAIN_LOGITS_S, ecfg: dict | None = None):
    """Fine-tune → merge → serve through the port's training entry points
    (``agentfield_tpu_torch.training``), in bf16 at full width on the card,
    the plain attention in the forward (the kernels have no backward), remat
    on. ``state`` holds the serve's ``lora_model`` weights (drawn from
    ``seed`` when it does not: the CPU rehearsal). The temporary directories
    (under ``root``) are removed at the end, also on a failure:

    (a) LoRA (``LoRAConfig()``: rank 8, alpha 16, wq/wk/wv/wo, f32 adapters;
        ``adamw(lora_lr)``) on ``lora_batch`` random tokens from the seed,
        ``lora_steps`` steps on the one batch: the step-0 loss equal to
        ``causal_lm_loss`` of the base params (``b`` is zero) within
        ``TRAIN_STEP0_RTOL``, the loss falling by at least
        ``TRAIN_MIN_DROP``, the base bit-identical; each step's ms (CUDA
        events), tokens/s, peak memory, and the share of merged bf16
        elements that differ from the base (a small ``a @ b`` can round
        away);
    (b) ``save_adapter``, then nodes over HTTP, ``prompts`` greedy one at a
        time: ``build_model_node(lora=DIR)`` in bf16 (its targets bit-equal
        to ``merge_lora``'s, its tokens equal to a ``params=merged`` node's)
        and with ``quant="int8"`` (its tree ``quantize_params`` of the merge,
        bit for bit at layers 0 and L-1, every answer complete, full-width
        logits kernel vs plain within the quant phase's bound,
        ``w8_logits_vs_plain``); the kernels' launches counted;
    (c) a full fine-tune of ``full_model`` (``adamw(full_lr)``, bf16 params
        and moments) on ``full_batch`` random tokens, ``full_steps`` steps:
        the loss falls; step ms, tokens/s, peak; ``save_checkpoint``, then
        ``restore_checkpoint`` into a fresh state (other seed): params,
        moments and step bit-equal; two more steps on both states: the
        first's loss equal (the same params, the same forward), the second's
        within ``TRAIN_RESUME_RTOL`` (the embedding's backward sums with
        atomics on the card: the update differs in its last bits);
    (d) ``save_hf_checkpoint`` of (c)'s weights (bf16), a node with
        ``checkpoint=``: leaves bit-equal, greedy tokens equal to a
        ``params=`` node's on the same weights."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch

    from agentfield_tpu_torch.models.configs import get_config
    from agentfield_tpu_torch.models.hf_loader import save_hf_checkpoint
    from agentfield_tpu_torch.models.llama import init_params
    from agentfield_tpu_torch.models.quant import QUANT_KEYS
    from agentfield_tpu_torch.ops.cuda import ragged_paged_attention as rpa
    from agentfield_tpu_torch.serving.engine import EngineConfig
    from agentfield_tpu_torch.serving.model_node import build_model_node
    from agentfield_tpu_torch.training import (
        LoRAConfig, adamw, causal_lm_loss, init_lora_state, init_train_state, make_lm_batch,
        make_lora_train_step, make_train_step, merge_lora, save_adapter,
    )
    from agentfield_tpu_torch.training.checkpoint import restore_checkpoint, save_checkpoint
    from agentfield_tpu_torch.training.trainer import named_leaves

    on_card = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()
    out: dict = {"card": results.get("card"), "launches": {}}
    results["train"] = out
    if "params" in state:
        base, cfg = state["params"], state["cfg"]
        node_ecfg = dataclasses.replace(state["ecfg"], num_pages=TRAIN_PAGES,
                                        kv_quant_dtype="none")
    else:
        cfg = get_config(lora_model)
        base = init_params(cfg, seed=seed, device=device)
        node_ecfg = EngineConfig(**ecfg)
    L, V = cfg.num_layers, cfg.vocab_size
    dirs: list[str] = []

    def tmpdir(tag: str) -> str:
        dirs.append(tempfile.mkdtemp(prefix=f"af_train_{tag}_", dir=root))
        return dirs[-1]

    def peak_reset():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def peak():
        return torch.cuda.max_memory_allocated() if on_card else None

    def random_batch(B: int, S: int, vocab: int, salt: int):
        g = torch.Generator(device=device)
        g.manual_seed(seed + salt)
        return make_lm_batch(torch.randint(0, vocab, (B, S), device=device, generator=g,
                                           dtype=torch.int32))

    rng = np.random.default_rng(seed + 67)
    prompt_ids = [rng.integers(1, min(V, get_config(full_model).vocab_size), n).tolist()
                  for n in prompts]

    def serve(node) -> list[list[int]]:
        """The prompts greedy, one at a time over HTTP; the node's kernel
        launches added to the phase's."""
        before = rpa.launch_counts()
        port = node[0].start()
        try:
            toks = [_post(port, {"tokens": p, "max_new_tokens": max_new})["result"]["tokens"]
                    for p in prompt_ids]
        finally:
            node[0].stop()
        for k, n in rpa.launch_counts().items():
            out["launches"][k] = out["launches"].get(k, 0) + n - before[k]
        assert all(len(t) == max_new for t in toks), [len(t) for t in toks]
        return toks

    try:
        # (a) LoRA on the served weights
        peak_reset()
        mem0 = torch.cuda.memory_allocated() if on_card else None
        B, S = lora_batch
        batch = random_batch(B, S, V, 61)
        # the base's first layer and its other leaves, to show the steps leave them
        before = {n: _first_layer(n, t).clone() for n, t in named_leaves(base)}
        with torch.no_grad():
            base_loss = float(causal_lm_loss(base, cfg, batch)[0])
        lcfg = LoRAConfig()
        opt = adamw(lora_lr)
        lstate = init_lora_state(cfg, lcfg, seed, opt, device=device)
        step = make_lora_train_step(cfg, lcfg, opt)
        losses, ms = _timed_steps(step, lstate, (base, batch), lora_steps, on_card)
        rep = _step_report(losses, ms, B * S, peak())
        if on_card:
            rep["attention"] = train_attention_ms(cfg, B, S, seed)
        rep.update(base_loss=base_loss, lr=lora_lr, batch=[B, S], rank=lcfg.rank,
                   alpha=lcfg.alpha, targets=list(lcfg.targets),
                   adapter_params=sum(t.numel() for _, t in named_leaves(lstate.params)),
                   held_before_gib=None if mem0 is None else mem0 / 2**30)
        step0_gap = abs(losses[0] - base_loss)
        rep["step0_equals_base"] = step0_gap <= TRAIN_STEP0_RTOL * abs(base_loss)
        with torch.no_grad():
            merged = merge_lora(base, lstate.params, lcfg)
        rep["merged_changed_share"] = {
            t: float((merged["layers"][t] != base["layers"][t]).float().mean())
            for t in lcfg.targets}
        base_same = all(torch.equal(_first_layer(n, t), before[n]) for n, t in named_leaves(base))
        del before
        out["lora"] = rep
        log(f"[train (a)] LoRA on {cfg_name(cfg)} (rank {lcfg.rank}, alpha {lcfg.alpha}, "
            f"{list(lcfg.targets)}, {rep['adapter_params']} adapter params), B{B} x S{S}, "
            f"adamw({lora_lr}), remat: step-0 loss {losses[0]:.6f} vs base {base_loss:.6f} "
            f"(|d| {step0_gap:.3e}); losses {[round(x, 4) for x in losses]}; step ms "
            f"{[round(x, 1) for x in ms]} (median after the first {rep['step_ms_median_after_first']:.1f}"
            f"), {rep['tokens_per_s']:.0f} tokens/s, peak {rep['peak_mem_gib']} GiB "
            f"({rep['held_before_gib']} GiB held before); merged elements that differ from the "
            f"base {rep['merged_changed_share']}; {results.get('card')}")
        if on_card:
            log(f"[train (a)] {_attention_line(rep)}")
        assert rep["step0_equals_base"], (losses[0], base_loss)
        assert losses[-1] <= losses[0] - TRAIN_MIN_DROP, f"the LoRA loss did not fall: {losses}"
        assert base_same, "the LoRA step wrote the base weights"

        # (b) the adapter served
        d = tmpdir("adapter")
        save_adapter(d, lstate.params, lcfg)
        out["adapter_bytes"] = _dir_bytes(d)
        name = cfg_name(cfg)
        t0 = time.perf_counter()
        node = build_model_node(name, params=base, lora=d, ecfg=node_ecfg, device=device,
                                seed=seed)
        build_s = time.perf_counter() - t0
        served = node[1].engine.params
        assert all(torch.equal(served["layers"][t], merged["layers"][t]) for t in lcfg.targets)
        mine = serve(node)
        del node, served
        gc.collect()
        ref = serve(build_model_node(name, params=merged, ecfg=node_ecfg, device=device,
                                     seed=seed))
        same = [a == b for a, b in zip(mine, ref)]
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        qnode = build_model_node(name, params=base, lora=d, quant="int8", ecfg=node_ecfg,
                                 device=device, seed=seed)
        qp = qnode[1].engine.params
        q_equal = all(_quant_equal(qp["layers"][k][l], merged["layers"][k][l])
                      for k in QUANT_KEYS for l in (0, L - 1))
        qtoks = serve(qnode)
        del qnode
        gc.collect()
        logits = w8_logits_vs_plain(qp, merged, cfg, seed, logits_s, device, "[train (b)] int8")
        del qp
        out["serve"] = {"adapter_bytes": out["adapter_bytes"], "lora_node_build_s": build_s,
                        "greedy_equal": all(same), "prompts": list(prompts),
                        "max_new": max_new, "int8_tree_is_quantized_merge": q_equal,
                        "int8_tokens": qtoks, "int8_logits": logits,
                        "launches": dict(out["launches"])}
        log(f"[train (b)] adapter {out['adapter_bytes']} bytes; lora= node built in "
            f"{build_s:.1f} s, its targets bit-equal to merge_lora; {sum(same)} of {len(same)} "
            f"greedy prompts equal to a params=merged node's; int8 node: tree = quantize_params "
            f"of the merge at layers 0 and {L - 1}: {q_equal}, answers complete; launches "
            f"{ {k: n for k, n in out['launches'].items() if n} }")
        assert all(same), f"lora= tokens differ from the merged node's on {same.count(False)}"
        assert q_equal, "the int8 lora= node did not quantize the merged weights"
        del merged, lstate
        gc.collect()

        # (c) full fine-tune
        peak_reset()
        fcfg = get_config(full_model)
        B, S = full_batch
        fbatch = random_batch(B, S, fcfg.vocab_size, 71)
        fopt = adamw(full_lr)
        fstate = init_train_state(fcfg, seed + 1, fopt, device=device)
        fstep = make_train_step(fcfg, fopt)
        losses, ms = _timed_steps(fstep, fstate, (fbatch,), full_steps, on_card)
        full = _step_report(losses, ms, B * S, peak())
        if on_card:
            full["attention"] = train_attention_ms(fcfg, B, S, seed)
            log(f"[train (c)] {_attention_line(full)}")
        full.update(lr=full_lr, batch=[B, S], model=full_model,
                    params=sum(t.numel() for _, t in named_leaves(fstate.params)))
        log(f"[train (c)] full fine-tune of {full_model} ({full['params']} params, bf16, "
            f"adamw({full_lr})), B{B} x S{S}, remat: losses {[round(x, 4) for x in losses]}; "
            f"step ms {[round(x, 1) for x in ms]} (median after the first "
            f"{full['step_ms_median_after_first']:.1f}), {full['tokens_per_s']:.0f} tokens/s, "
            f"peak {full['peak_mem_gib']} GiB; {results.get('card')}")
        assert losses[-1] <= losses[0] - TRAIN_MIN_DROP, f"the loss did not fall: {losses}"
        ck = tmpdir("state")
        t0 = time.perf_counter()
        save_checkpoint(ck, fstate)
        full["save_s"] = time.perf_counter() - t0
        full["checkpoint_bytes"] = _dir_bytes(os.path.join(ck, f"step_{fstate.step}"))
        fresh = init_train_state(fcfg, seed + 2, fopt, device=device)
        t0 = time.perf_counter()
        restore_checkpoint(ck, fresh)
        full["restore_s"] = time.perf_counter() - t0
        bad = [n for (n, a), (_, b) in zip(named_leaves(fstate.params), named_leaves(fresh.params))
               if not torch.equal(a, b)]
        for pa, pb in zip(fstate.optimizer.param_groups[0]["params"],
                          fresh.optimizer.param_groups[0]["params"]):
            sa, sb = fstate.optimizer.state[pa], fresh.optimizer.state[pb]
            bad += [k for k in sa if k not in sb or not torch.equal(sa[k], sb[k])]
        full["restored_bit_equal"] = not bad and fresh.step == fstate.step
        cont, _ = _timed_steps(fstep, fstate, (fbatch,), 2, on_card)
        resumed, _ = _timed_steps(fstep, fresh, (fbatch,), 2, on_card)
        full.update(continued_losses=cont, resumed_losses=resumed,
                    resume_rel_diff=[abs(a - b) / abs(a) for a, b in zip(cont, resumed)])
        del fresh
        gc.collect()
        out["full"] = full
        log(f"[train (c)] checkpoint at step {full_steps}: {full['checkpoint_bytes']} bytes "
            f"written in {full['save_s']:.2f} s, restored into a fresh state in "
            f"{full['restore_s']:.2f} s, bit-equal: {full['restored_bit_equal']}; the next two "
            f"losses uninterrupted {cont} vs resumed {resumed} (relative "
            f"{full['resume_rel_diff']}; tol {TRAIN_RESUME_RTOL})")
        assert full["restored_bit_equal"], f"restored state differs: {bad[:5]}"
        assert cont[0] == resumed[0], "the first step after the restore: another loss"
        assert full["resume_rel_diff"][1] <= TRAIN_RESUME_RTOL, full["resume_rel_diff"]

        # (d) train -> export -> serve
        hf = tmpdir("hf")
        t0 = time.perf_counter()
        save_hf_checkpoint(hf, fcfg, fstate.params, dtype="bfloat16")
        export_s = time.perf_counter() - t0
        cnode = build_model_node(checkpoint=hf, ecfg=node_ecfg, device=device, seed=seed)
        bad = _leaves_equal(cnode[1].engine.params, fstate.params)
        from_ckpt = serve(cnode)
        del cnode
        gc.collect()
        from_params = serve(build_model_node(cfg_name(fcfg), params=fstate.params,
                                             ecfg=node_ecfg, device=device, seed=seed))
        same = [a == b for a, b in zip(from_ckpt, from_params)]
        out["export"] = {"export_s": export_s, "bytes": _dir_bytes(hf), "leaves_bit_equal": not bad,
                         "greedy_equal": all(same)}
        del fstate
        log(f"[train (d)] {full_model} exported ({out['export']['bytes']} bytes bf16 in "
            f"{export_s:.2f} s), served by checkpoint=: leaves bit-equal {not bad}, "
            f"{sum(same)} of {len(same)} greedy prompts equal to a params= node's")
        assert not bad, f"exported leaves differ: {bad[:5]}"
        assert all(same), f"checkpoint= tokens differ from params= on {same.count(False)}"
        out["phase_s"] = time.perf_counter() - t_phase
        log(f"[train] phase {out['phase_s']:.1f} s; launches "
            f"{ {k: n for k, n in out['launches'].items() if n} }; {results.get('card')}")
    finally:
        for x in dirs:
            shutil.rmtree(x, ignore_errors=True)
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()


def phase_ab(results, other_root: str, seed: int = 0):
    """A/B against a checkout of another commit unpacked at ``other_root``:
    the attention source (``phase_ab_attention``, skipped where the two
    sources are the same bytes), then the int8-weight matmul
    (``phase_ab_w8``)."""
    same = (open(os.path.join(other_root, RAGGED_SRC), "rb").read()
            == open(os.path.join(ROOT, RAGGED_SRC), "rb").read())
    results["ab"] = {"other_root": other_root, "attention_source_unchanged": same}
    if same:
        log(f"[ab] {RAGGED_SRC} is the same in both checkouts: attention A/B skipped")
    else:
        phase_ab_attention(results, other_root)
    phase_ab_w8(results, other_root, seed)


def phase_ab_attention(results, other_root: str):
    """A/B of the attention source at the mixed W = 1 shapes (bf16, f32):
    the source under ``other_root`` (a checkout of another commit) built for
    hd 128 and 96 and bound in place of this checkout's, in turns (other,
    this, this, other) in one process, each held against the plain version
    with ``elem_bound``."""
    import ctypes
    import hashlib

    import torch

    from agentfield_tpu_torch.ops.cuda import build
    from agentfield_tpu_torch.ops.cuda import ragged_paged_attention as rpa
    from agentfield_tpu_torch.ops.kernel_shapes import build_case
    from agentfield_tpu_torch.ops.paged_attention import ragged_paged_attention_ref

    src = os.path.join(other_root, RAGGED_SRC)
    libs = {}
    procs = {}
    for hd in (128, 96):
        tag = hashlib.sha256(open(src, "rb").read()).hexdigest()[:12]
        so = str(build.BUILD_DIR / f"ab_other.hd{hd}-{tag}.so")
        os.makedirs(build.BUILD_DIR, exist_ok=True)
        procs[hd] = (so, subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, f"-DAFP_HEAD_DIM={hd}",
                                           "-o", so, src]))
    for hd, (so, proc) in procs.items():
        assert proc.wait() == 0, f"nvcc failed on {src} (hd {hd})"
        libs[hd] = rpa.bind(ctypes.CDLL(so), hd)
    dev = torch.device("cuda")
    rows = {}
    for name, p in mixed_shapes().items():
        p = dict(p)
        window = p.pop("window", None)
        hd = p["hd"]
        case_np = build_case(name, params=p, seed=0)
        mine = rpa._entry(hd)
        for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            case = [_to(a, dtype, dev) for a in case_np]
            q, kn, vn, kp, vp = case[:5]
            desc = case[5:]
            o_r = ragged_paged_attention_ref(q, kn, vn, kp.clone(), vp.clone(), *desc, window=window)[0]
            t = {"other": [], "this": []}
            for who in ("other", "this", "this", "other"):
                rpa._entry_fns[hd] = libs[hd] if who == "other" else mine
                o_k = rpa.ragged_paged_attention_cuda(q, kn, vn, kp.clone(), vp.clone(), *desc,
                                                      window=window)[0]
                torch.cuda.synchronize()
                ok, err, ratio = compare(o_k, o_r, dname)
                assert ok, f"{who} kernel at {name}/{dname}: err/bound {ratio}"
                kpk, vpk = kp.clone(), vp.clone()
                t[who].append(graph_ms(lambda: rpa.ragged_paged_attention_cuda(
                    q, kn, vn, kpk, vpk, *desc, window=window)))
            rpa._entry_fns[hd] = mine
            rows[f"{name}/{dname}"] = {"other_ms": t["other"], "this_ms": t["this"]}
            log(f"[ab] {name} {dname}: other {t['other']} ms, this {t['this']} ms")
            del case, q, kn, vn, kp, vp, o_r
        torch.cuda.empty_cache()
    results["ab"]["shapes"] = rows


def _other_w8(other_root: str):
    """The int8-weight wrapper of the checkout at ``other_root``, loaded by
    file path (its ``plan`` and launch signature), bound to its own source
    built here; it reads the logical ``[K, N]`` layout of q (the layout
    before the packed one)."""
    import ctypes
    import hashlib
    import importlib.util

    from agentfield_tpu_torch.ops.cuda import build

    src = os.path.join(other_root, W8_SRC)
    tag = hashlib.sha256(open(src, "rb").read()).hexdigest()[:12]
    so = str(build.BUILD_DIR / f"ab_other.w8-{tag}.so")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", so, src], check=True)
    spec = importlib.util.spec_from_file_location(
        "ab_other_quant_matmul", os.path.join(other_root, "agentfield_tpu_torch/ops/cuda/quant_matmul.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._fns["w8"] = mod.bind(ctypes.CDLL(so))
    return mod


def phase_ab_w8(results, other_root: str, seed: int = 0):
    """A/B of the int8-weight matmul: the source and wrapper of the checkout
    at ``other_root`` (``_other_w8``, the logical layout of q) against this
    checkout's (the packed layout), in turns (other, this, this, other) in
    one process: every bf16 ``w8_shapes`` shape (``ms`` replayed from a
    graph, each within ``w8_elem_bound`` of the plain version), then the
    replayed width-8 decode step of full-width Llama-3-8B on int8 weights
    (``_step_device_ms``: step device ms and its int8 matmuls' ms)."""
    import torch

    from agentfield_tpu_torch.models.configs import get_config
    from agentfield_tpu_torch.models.llama import init_params
    from agentfield_tpu_torch.models.quant import QuantW, quantize_params, quantize_weight
    from agentfield_tpu_torch.ops.cuda.quant_matmul import int8_weight_matmul_cuda

    other = _other_w8(other_root)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    fns = {"other": lambda x, w: other.int8_weight_matmul_cuda(x, w[1], w[2]),
           "this": lambda x, w: int8_weight_matmul_cuda(x, w[0], w[2])}
    rows = {}
    weights = {}
    for name, (M, K, N) in w8_shapes().items():
        if (K, N) not in weights:
            weights.clear()
            torch.cuda.empty_cache()
            qw = quantize_weight(torch.empty((K, N), device=dev).normal_(0.0, 0.02, generator=g))
            weights[(K, N)] = (qw.q, qw.logical(), qw.scale)
        w = weights[(K, N)]
        x = torch.empty((M, K), device=dev).normal_(0.0, 1.0, generator=g).to(torch.bfloat16)
        y_r = (x.float() @ w[1].float()) * w[2]
        s_abs = (x.float().abs() @ w[1].float().abs()) * w[2]
        t = {"other": [], "this": []}
        for who in ("other", "this", "this", "other"):
            ok, err, ratio = w8_compare(fns[who](x, w), y_r, s_abs, K, "bfloat16")
            assert ok, f"{who} int8-weight kernel at {name}: err/bound {ratio}"
            t[who].append(graph_ms(lambda: fns[who](x, w)))
        other_ms, this_ms = statistics.fmean(t["other"]), statistics.fmean(t["this"])
        rows[name] = {"M": M, "K": K, "N": N, "other_ms": t["other"], "this_ms": t["this"],
                      "this_over_other": this_ms / other_ms}
        log(f"[ab] w8 {name:22s} other {t['other'][0]:.4f} {t['other'][1]:.4f} this "
            f"{t['this'][0]:.4f} {t['this'][1]:.4f} ms ({this_ms / other_ms:.3f}x)")
        del x, y_r, s_abs
    weights.clear()
    torch.cuda.empty_cache()

    class OtherQuantW(QuantW):  # x @ w through the other checkout's kernel
        __slots__ = ()

        def __rmatmul__(self, x):
            return other.int8_weight_matmul_cuda(x, self.q, self.scale)

    cfg = get_config("llama-3-8b")
    packed = quantize_params(init_params(cfg, seed=seed, device="cuda"))
    logical = {**packed, "layers": {k: OtherQuantW(v.logical(), v.scale) if isinstance(v, QuantW)
                                    else v for k, v in packed["layers"].items()}}
    # the decode step's 7 L int8 products at 8 rows, chained over every
    # layer's weights (each read cold, as in the step) in one graph: device
    # ms a layer, with no other kernel between them
    xs = {k: torch.empty((8, k), device=dev).normal_(generator=g).to(torch.bfloat16)
          for k in (cfg.hidden_size, cfg.intermediate_size)}
    order = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

    def chain(params):
        ws = [[params["layers"][k][i] for k in order] for i in range(cfg.num_layers)]

        def run():
            for lw in ws:
                for w in lw:
                    w.__rmatmul__(xs[w.shape[0]])
        return graph_ms(run, n=5) / cfg.num_layers

    layer = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        layer[who].append(chain(logical if who == "other" else packed))
    log(f"[ab] w8 the decode step's 7 int8 products at 8 rows, chained over {cfg.num_layers} "
        f"layers: other {layer['other']} ms a layer, this {layer['this']} ms a layer "
        f"(bytes bound {sum(packed['layers'][k].q[0].numel() for k in order) / HBM_BYTES_PER_S * 1e3:.4f})")
    kind = "matmul (int8-weight, hand-written)"
    steps = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        st = _step_device_ms(logical if who == "other" else packed, cfg, seed)
        bd = st["breakdown"]
        steps[who].append({"step_device_ms": st["step_device_ms"],
                           "int8_matmul_ms": bd and bd["by_kind_ms"].get(kind),
                           "by_kind_ms": bd and bd["by_kind_ms"]})
        log(f"[ab] w8 width-{st['width']} replayed step, {who}: {st['step_device_ms']:.3f} device "
            f"ms, int8 matmuls {steps[who][-1]['int8_matmul_ms']} ms")
    del packed, logical
    gc.collect()
    torch.cuda.empty_cache()
    results["ab"]["w8"] = {"shapes": rows, "step": steps, "layer_chain_ms": layer}


def phase_w8_sweep(results, seed: int = 0, cold_bytes: int = 160_000_000):
    """The int8-weight kernel's launch plans on the card, for tuning
    ``quant_matmul.PLAN_TABLE``: at every bf16 ``w8_shapes`` shape, each
    candidate (nx, cw, splits) the source builds, timed as a chain of
    products over distinct weights of ``cold_bytes`` in all (each read
    cold, as in a decode step) in one graph, per product; each candidate
    held within ``w8_elem_bound``. Prints the plan ``quant_matmul.plan``
    takes (the table's or the heuristic's) and the fastest."""
    import itertools

    import torch

    from agentfield_tpu_torch.models.quant import quantize_weight
    from agentfield_tpu_torch.ops.cuda import quant_matmul as qm

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = {}
    weights = {}
    for name, (M, K, N) in w8_shapes().items():
        if (K, N) not in weights:
            weights.clear()
            torch.cuda.empty_cache()
            weights[(K, N)] = [quantize_weight(torch.empty((K, N), device=dev).normal_(
                0.0, 0.02, generator=g)) for _ in range(max(1, -(-cold_bytes // (K * N))))]
        ws = weights[(K, N)]
        x = torch.empty((M, K), device=dev).normal_(0.0, 1.0, generator=g).to(torch.bfloat16)
        q0 = ws[0].logical()
        y_r = (x.float() @ q0.float()) * ws[0].scale
        s_abs = (x.float().abs() @ q0.float().abs()) * ws[0].scale
        nkt = -(-K // qm.K_TILE)
        key = (qm.m_bucket(M), K, N)
        p = qm.plan(M, K, N, sms)
        taken, saved = (p["nx"], p["cw"], p["splits"]), qm.PLAN_TABLE.pop(key, None)
        if M <= qm.STREAM_MAX_M:
            cands = [(taken[0], 1, sp) for sp in (1, 2, 3, 4, 6, 8)]
        else:
            cands = list(itertools.product((128, 256), (1, 2), (1, 2, 4, 8)))
        times = {}
        for nx, cw, sp in cands:
            if sp > max(1, nkt // 2):
                continue
            qm.PLAN_TABLE[key] = (nx, cw, sp)
            ok = w8_compare(qm.int8_weight_matmul_cuda(x, ws[0].q, ws[0].scale), y_r, s_abs, K,
                            "bfloat16")[0]
            assert ok, f"w8 sweep {name} plan {(nx, cw, sp)} missed w8_elem_bound"

            def run():
                for w in ws:
                    qm.int8_weight_matmul_cuda(x, w.q, w.scale)
            times[(nx, cw, sp)] = graph_ms(run, n=10) / len(ws)
        del qm.PLAN_TABLE[key]
        if saved is not None:
            qm.PLAN_TABLE[key] = saved
        best = min(times, key=times.get)
        rows[name] = {"M": M, "K": K, "N": N, "plan": taken, "best": best,
                      "ms": {str(k): v for k, v in times.items()}}
        log(f"[sweep] w8 {name:22s} plan {taken} {times.get(taken, float('nan')):.4f} ms, "
            f"fastest {best} {times[best]:.4f} ms")
        del x, y_r, s_abs, q0
    weights.clear()
    torch.cuda.empty_cache()
    results["w8_sweep"] = rows


def graph_replay_ms(graph, before, n: int = 20) -> float:
    """Median device milliseconds of one replay of ``graph``, ``before()``
    (host-enqueued, untimed) run ahead of each."""
    import torch

    times = []
    for _ in range(n):
        before()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _kernel_kind(name: str) -> str:
    n = name.lower()
    if "w8_" in n:
        return "matmul (int8-weight, hand-written)"
    if any(k in n for k in ("decode_split", "decode_combine", "tc_tile", "ragged_attention",
                            "kv_write")):
        return "attention (hand-written)"
    if any(k in n for k in ("gemm", "gemv", "nvjet", "xmma", "cutlass", "splitk")):
        return "matmul (cuBLAS)"
    return "other (norms, rope, sampler, copies)"


def profile_replays(graph, before, n: int = 5):
    """Device time a replay of ``graph`` spends per kernel kind, in its
    heaviest kernels and in every kernel (``kernels_ms``), from
    ``torch.profiler`` over ``n`` replays, each after ``before()``, in ms
    per replay; None when the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            before()
            graph.replay()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3 / n
    if not kernels:
        return None
    by_kind = {}
    for name, ms in kernels.items():
        by_kind[_kernel_kind(name)] = by_kind.get(_kernel_kind(name), 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"by_kind_ms": by_kind, "total_ms": sum(kernels.values()),
            "kernels": len(kernels), "top_kernels_ms": [(k[:60], v) for k, v in top],
            "kernels_ms": kernels}


def kernels_line(results) -> dict:
    """One entry per kernel wrapper and pool kind: times and bound at its
    main-path shape (bf16, the served dtype; ``ms`` the device time of a
    call, ``call_ms`` the eager call), ``max_abs_err`` the worst over
    every bf16 shape it was held at (for a quantized variant, against the
    plain version with the kernel's semantics, check (b)), ``launches`` from
    the serve phase of its pool kind and the spec, tier, fork, api, channel,
    cluster, media, moe, ckpt and train phases."""
    shapes = results["shapes"]
    picks = [
        ("ragged_paged_attention", "llama3_decode_ctx2k/bfloat16", f"{TPU_KERNEL}:61", "serve"),
        ("dense_causal_attention", "dense_B4_S512_H32_Kh8_hd128/bfloat16", f"{TPU_KERNEL}:485",
         "serve"),
    ] + [(f"ragged_paged_attention_{m}", f"llama3_decode_ctx2k_{m}/bfloat16", f"{TPU_KERNEL}:95",
          f"serve_{m}") for m in QUANT_MODES]
    out = []
    for name, shape, replaces, serve in picks:
        row = shapes[shape]
        held = [r for r in shapes.values() if r["kernel"] == name and r["dtype"] == "bfloat16"]
        entry = {
            "name": name, "route": "cuda", "source": RAGGED_SRC, "replaces": replaces,
            # the serve's launches and those of the spec, tier, fork, api,
            # channel, cluster, media, moe, ckpt and train phases
            "launches": results[serve]["launches"][name] + sum(
                results[p]["launches"][name]
                for p in ("spec", "tier", "fork", "api", "channel", "cluster", "media"))
            + results["moe"]["launches"].get(name, 0)
            + sum(results.get(p, {}).get("launches", {}).get(name, 0) for p in ("ckpt", "train")),
            "max_abs_err": max(r["max_abs_err"] for r in held),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": shape,
            "call_ms": row["call_ms"], "sdpa_gathered_ms": row.get("sdpa_gathered_ms"),
            "path_launches": results[serve]["path_launches"],
        }
        if "parity_over_tol" in row:
            entry["worst_parity_over_tol"] = max(r["parity_over_tol"] for r in held)
        if name == "ragged_paged_attention":
            # the mixed tick's launch: its shape's times, and its launches in
            # the burst phase's mixed engine
            mixed = shapes["llama3_mixed_w1/bfloat16"]
            entry["mixed_tick"] = {
                k: mixed[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                                      "sdpa_gathered_ms", "max_abs_err")}
            entry["mixed_tick"]["launches"] = results["burst"]["mixed"][
                "mixed_tick_path_launches"]["ragged_paged_attention"]
            # the spec step's launches: each verify shape's times, and the
            # verify launches the spec runs made at its width and k
            entry["spec"] = {}
            for shape in spec_shapes():
                r = shapes[f"{shape}/bfloat16"]
                entry["spec"][shape] = {k: r[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms",
                                                         "bound_by", "sdpa_gathered_ms",
                                                         "max_abs_err")}
            for run in ("b_self_k3", "c_draft_k3", "c_draft_k1"):
                row = results["spec"][run]
                entry["spec"][f"verify_launches_{run}"] = row["verify_launches_by_width"]
        out.append(entry)
    out.append(w8_kernel_entry(results))
    return {"kernels": out}


def w8_kernel_entry(results) -> dict:
    """The int8-weight matmul's entry: times and bound at the decode step's
    w_gate/w_up product at 16 rows (bf16), ``max_abs_err`` the worst over
    every bf16 shape (the moe phase's expert slices among them),
    ``launches`` from the quant, moe, ckpt and train phases' main paths (the
    int8 serves, the mixed bursts, the spec passes), and every shape's numbers
    under ``shapes``."""
    shapes = results["shapes"]
    held = {k: r for k, r in shapes.items() if r["kernel"] == "int8_weight_matmul" and "ms" in r}
    row = held["w8_wgate_wup_M16/bfloat16"]
    keys = ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "cublas_bf16_ms",
            "max_abs_err", "max_err_over_bound")
    return {
        "name": "int8_weight_matmul", "route": "cuda", "source": W8_SRC, "replaces": W8_REPLACES,
        "launches": results["quant"]["launches"]["int8_weight_matmul"]
        + results["moe"]["launches"]["int8_weight_matmul"]
        + sum(results.get(p, {}).get("launches", {}).get("int8_weight_matmul", 0)
              for p in ("ckpt", "train")),
        "max_abs_err": max(r["max_abs_err"] for r in held.values() if r["dtype"] == "bfloat16"),
        "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "shape": "w8_wgate_wup_M16/bfloat16", "call_ms": row["call_ms"],
        "cublas_bf16_ms": row["cublas_bf16_ms"],
        "launches_per_decode_step": results["serve_w8"]["w8_launches_per_decode_step"],
        "launches_per_decode_step_moe": results["moe"]["w8_launches_per_decode_step"],
        "shapes": {k: {f: r[f] for f in keys} for k, r in held.items()
                   if r["dtype"] == "bfloat16"},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write every phase's details here (JSON)")
    ap.add_argument("--w8-sweep", action="store_true",
                    help="only build, then time every launch plan of the int8-weight kernel at "
                         "every bf16 shape (phase_w8_sweep, for quant_matmul.PLAN_TABLE)")
    ap.add_argument("--ab-against", default=None, metavar="DIR",
                    help="only build, then time the kernels of the checkout at DIR against "
                         "this one's in turns (phase_ab: the attention source at the mixed W=1 "
                         "shapes where it differs, the int8-weight matmul at every bf16 shape "
                         "and in the replayed decode step)")
    ap.add_argument("--ckpt-dir", default=None, metavar="DIR",
                    help="where the ckpt and train phases make their temporary checkpoint "
                         "directories (default: the system's temporary directory; about 22.5 "
                         "GB, then about 10 GB)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import agentfield_tpu_torch  # noqa: F401 — fails outside a checkout of the repo

    torch.backends.cuda.matmul.allow_tf32 = False  # plain float32 stays float32
    torch.backends.cudnn.allow_tf32 = False
    card = smi_line()
    log(card)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    results: dict = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    state: dict = {}
    t0 = time.perf_counter()
    if args.ab_against or args.w8_sweep:
        phase_build(results)
        if args.w8_sweep:
            phase_w8_sweep(results, args.seed)
        if args.ab_against:
            phase_ab(results, args.ab_against, args.seed)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1, default=str)
        log(card)
        print(json.dumps({k: results[k] for k in ("ab", "w8_sweep") if k in results},
                         default=str), flush=True)
        return 0
    try:
        phase_build(results)
        phase_check(results)
        phase_serve(results, state, args.seed)
        for mode in QUANT_MODES:
            phase_serve(results, state, args.seed, kv_quant=mode)
        phase_quant(results, state, args.seed)
        phase_forward(results, state, args.seed)
        phase_graph(results, state, args.seed)
        phase_burst(results, state, args.seed)
        phase_overload(results, state, args.seed)
        phase_spec(results, state, args.seed)
        phase_tier(results, state, args.seed)
        phase_fork(results, state, args.seed)
        phase_api(results, state, args.seed)
        phase_channel(results, state, args.seed)
        phase_cluster(results, state, args.seed)
        phase_media(results, state, args.seed)
        phase_ckpt(results, state, args.seed, root=args.ckpt_dir)
        phase_train(results, state, args.seed, root=args.ckpt_dir)
        state.clear()  # the 8B weights go before the reduced-depth models
        for preset in REDUCED_DEPTH_PRESETS:
            phase_reduced_depth(results, preset, args.seed)
        phase_ckpt_moe(results, args.seed, root=args.ckpt_dir)
        phase_moe(results, args.seed)
    finally:
        results["wall_s"] = time.perf_counter() - t0
        if args.out:
            out = os.path.abspath(args.out)
            os.makedirs(os.path.dirname(out), exist_ok=True)
            with open(out, "w") as f:
                json.dump(results, f, indent=1, default=str)
    log(card)
    log(f"[wall] the whole script took {results['wall_s']:.1f} s, the build included")
    log(json.dumps(kernels_line(results)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
