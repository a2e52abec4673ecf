"""The engine's decode step on static buffers, replayed from CUDA graphs on
the card — counterpart of the JAX engine's jitted ``_decode_fn`` and its
device-resident control state (``_dev_state``, ``_compact_state``).

``DecodeState`` holds one batch width's control state in device tensors that
never move: tokens, lengths, page tables, the sampling knobs, the grammar
states and stop ids, and the step's outputs. The host writes them only when
the engine's shadows changed (admission, release, a new compact membership);
the step itself writes its next tokens and lengths back into them, so steps
chain on the device with no host work, as the JAX engine's donated control
arrays do.

``DecodeGraphs`` runs a step function over a ``DecodeState``. On the card it
keeps one ``torch.cuda.CUDAGraph`` per key ``(width, sampler variant,
mode)``, the mode "free", "grammar" or "spec<k>" (a speculative step of k
proposals: the draft's k + 1 steps, the verify, the acceptance test and the
sampling in one graph): the first use of a key runs the step eagerly on a side
stream (that dispatch's real step, which also warms cuBLAS and loads the
kernel library), then captures it; every later use replays the graph.
There is no eager fallback on the card: a capture that fails raises. The
engine's ``torch.Generator`` is registered with each sampling graph, so
every replay draws fresh numbers. Launches of the hand-written kernels are
counted in Python (``ops.cuda.ragged_paged_attention.launch_counts``, which
covers the attention and the int8-weight matmul): a capture counts them
once, so the runner takes them back out and adds the graph's count on every
replay. On CPU tensors the step runs eagerly every time, and so it does on
the card when ``eager`` gives a reason (a tensor-parallel engine over gloo,
whose collectives cannot be captured): ``stats()["eager"]`` says why, and
each eager step counts its own launches.
"""

from __future__ import annotations

import collections
import time
from typing import Callable

import numpy as np
import torch

from agentfield_tpu_torch.ops.cuda import ragged_paged_attention as rpa

MAX_STOP_IDS = 8  # per-request stop ids carried into the decode-step EOS mask

_NP_DTYPES = {torch.int64: np.int64, torch.int32: np.int32, torch.float32: np.float32}


class DecodeState:
    """Static control buffers of one decode batch width."""

    INPUTS = ("tokens", "seq_lens", "page_tables", "temps", "top_ks", "top_ps", "gstates",
              "eos_ids")

    def __init__(self, width: int, maxp: int, span: int, device: torch.device,
                 spec_k: int = 0):
        def zeros(shape, dtype, fill=0):
            return torch.full(shape, fill, dtype=dtype, device=device)

        self.width = width
        self.tokens = zeros((width,), torch.int64)
        self.seq_lens = zeros((width,), torch.int32)  # 0 = inert padding row
        self.page_tables = zeros((width, maxp), torch.int32)
        self.temps = zeros((width,), torch.float32)
        self.top_ks = zeros((width,), torch.int32)
        self.top_ps = zeros((width,), torch.float32, 1.0)
        self.gstates = zeros((width,), torch.int32)  # bank-global DFA state, 0 = free
        self.eos_ids = zeros((width, MAX_STOP_IDS), torch.int32, -1)
        self.out_tokens = zeros((span, width), torch.int32)
        self.out_logprobs = zeros((span, width), torch.float32)
        # a speculative step's outputs: up to k + 1 tokens a row, and how many
        self.spec_tokens = zeros((spec_k + 1, width), torch.int32) if spec_k else None
        self.spec_logprobs = zeros((spec_k + 1, width), torch.float32) if spec_k else None
        self.spec_counts = zeros((width,), torch.int32) if spec_k else None

    def load(self, host: dict[str, np.ndarray]) -> None:
        """Write host arrays (``INPUTS`` names) into the buffers, in order on
        the current stream. On the card each source is first copied into a
        fresh pinned buffer that nothing rewrites, then copied without
        blocking the host; the host's own arrays may change at once."""
        for name, arr in host.items():
            buf = getattr(self, name)
            src = torch.from_numpy(np.ascontiguousarray(arr, dtype=_NP_DTYPES[buf.dtype]))
            if buf.is_cuda:
                buf.copy_(src.pin_memory(), non_blocking=True)
            else:
                buf.copy_(src)

    def outputs_to_host(self, spec: bool = False) -> tuple:
        """Copies of the last step's ``(tokens, logprobs, counts)`` on the
        host (``counts`` None unless ``spec``: a speculative step's outputs),
        and the event after which they hold their values (None on the CPU).
        The next step overwrites the buffers, so a pipelined harvest reads
        these copies, never the buffers."""
        bufs = ((self.spec_tokens, self.spec_logprobs, self.spec_counts) if spec
                else (self.out_tokens, self.out_logprobs))
        if not self.tokens.is_cuda:
            out = [b.clone() for b in bufs]
            done = None
        else:
            out = [torch.empty(b.shape, dtype=b.dtype, pin_memory=True) for b in bufs]
            for o, b in zip(out, bufs):
                o.copy_(b, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        return out[0], out[1], out[2] if spec else None, done


class DecodeGraphs:
    """``step_fn(state, variant, mode)`` per key, replayed from CUDA graphs
    on the card (see the module docstring)."""

    def __init__(self, step_fn: Callable[[DecodeState, str, str], None],
                 generator: torch.Generator, eager: str | None = None):
        self.step_fn = step_fn
        self.generator = generator
        self.eager = eager  # why every step runs eagerly on the card, or None
        self.graphs: dict[tuple, tuple[torch.cuda.CUDAGraph, dict[str, int]]] = {}
        self.capture_s = 0.0  # host seconds of first uses: eager step + capture
        self.replays: collections.Counter = collections.Counter()

    def stats(self) -> dict:
        out = {
            "graphs_captured": len(self.graphs),
            "capture_s": self.capture_s,
            "replays": {f"w{w}/{v}/{m}": n for (w, v, m), n in sorted(self.replays.items())},
        }
        if self.eager is not None:
            out["eager"] = self.eager
        return out

    def run(self, state: DecodeState, variant: str, mode: str) -> bool:
        """One decode step over ``state``. Returns True when it was a replay
        of a captured graph (False: the CPU, or a key's first use)."""
        if not state.tokens.is_cuda or self.eager is not None:
            self.step_fn(state, variant, mode)
            return False
        key = (state.width, variant, mode)
        entry = self.graphs.get(key)
        if entry is None:
            self._capture(key, state)
            return False
        graph, launches = entry
        graph.replay()
        rpa.add_launches(launches)
        self.replays[key] += 1
        return True

    def _capture(self, key: tuple, state: DecodeState) -> None:
        _, variant, mode = key
        t0 = time.perf_counter()
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream(device=main.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):  # this dispatch's step, eager
            self.step_fn(state, variant, mode)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        if variant != "greedy":  # the step draws from the engine's generator
            graph.register_generator_state(self.generator)
        before = rpa.launch_counts()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self.step_fn(state, variant, mode)
        launches = {k: n - before[k] for k, n in rpa.launch_counts().items()}
        rpa.add_launches(launches, sign=-1)  # recorded, not launched
        self.graphs[key] = (graph, launches)
        self.capture_s += time.perf_counter() - t0

