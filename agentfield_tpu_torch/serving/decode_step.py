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
grammar on/off)``: the first use of a key runs the step eagerly on a side
stream (that dispatch's real step, which also warms cuBLAS and loads the
kernel library), then captures it; every later use replays the graph.
There is no eager fallback on the card: a capture that fails raises. The
engine's ``torch.Generator`` is registered with each sampling graph, so
every replay draws fresh numbers. Launches of the hand-written kernel are
counted in Python (``ops.cuda.ragged_paged_attention.LAUNCHES``): a capture
counts them once, so the runner takes them back out and adds the graph's
count on every replay. On CPU tensors the step runs eagerly every time.
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

    def __init__(self, width: int, maxp: int, span: int, device: torch.device):
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

    def outputs_to_host(self) -> tuple[torch.Tensor, torch.Tensor, torch.cuda.Event | None]:
        """Copies of the last step's ``(tokens, logprobs)`` on the host, and
        the event after which they hold their values (None on the CPU). The
        next step overwrites the buffers, so a pipelined harvest reads these
        copies, never the buffers."""
        if not self.out_tokens.is_cuda:
            return self.out_tokens.clone(), self.out_logprobs.clone(), None
        toks = torch.empty(self.out_tokens.shape, dtype=torch.int32, pin_memory=True)
        lps = torch.empty(self.out_logprobs.shape, dtype=torch.float32, pin_memory=True)
        toks.copy_(self.out_tokens, non_blocking=True)
        lps.copy_(self.out_logprobs, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return toks, lps, done


class DecodeGraphs:
    """``step_fn(state, variant, grammar)`` per key, replayed from CUDA
    graphs on the card (see the module docstring)."""

    def __init__(self, step_fn: Callable[[DecodeState, str, bool], None],
                 generator: torch.Generator):
        self.step_fn = step_fn
        self.generator = generator
        self.graphs: dict[tuple, tuple[torch.cuda.CUDAGraph, dict[str, int]]] = {}
        self.capture_s = 0.0  # host seconds of first uses: eager step + capture
        self.replays: collections.Counter = collections.Counter()

    def stats(self) -> dict:
        return {
            "graphs_captured": len(self.graphs),
            "capture_s": self.capture_s,
            "replays": {f"w{w}/{v}/{'grammar' if g else 'free'}": n
                        for (w, v, g), n in sorted(self.replays.items())},
        }

    def run(self, state: DecodeState, variant: str, grammar: bool) -> bool:
        """One decode step over ``state``. Returns True when it was a replay
        of a captured graph (False: the CPU, or a key's first use)."""
        if not state.tokens.is_cuda:
            self.step_fn(state, variant, grammar)
            return False
        key = (state.width, variant, grammar)
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
        _, variant, grammar = key
        t0 = time.perf_counter()
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream(device=main.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):  # this dispatch's step, eager
            self.step_fn(state, variant, grammar)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        if variant != "greedy":  # the step draws from the engine's generator
            graph.register_generator_state(self.generator)
        before = rpa.launch_counts()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self.step_fn(state, variant, grammar)
        launches = {k: n - before[k] for k, n in rpa.launch_counts().items()}
        rpa.add_launches(launches, sign=-1)  # recorded, not launched
        self.graphs[key] = (graph, launches)
        self.capture_s += time.perf_counter() - t0

