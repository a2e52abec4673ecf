"""Request-scoped tracing, the engine's flight recorder and its latency
histograms: the port's copy of ``agentfield_tpu/tracing.py``, for the node
and for the port's control plane (``TraceStore``, ``enabled``).

One execution is one trace. The gateway mints the trace id and threads a
small TraceContext dict (``{"trace_id", "attempt", "node"}``) into the node,
on the channel's ``submit`` frame and in the ``generate`` input. The node and
its engine record spans against that id into the process's :class:`Tracer`
buffer: monotonic-clock durations anchored to a wall-clock ``t0``, so spans
from several processes order into one waterfall. The node pops a trace's
spans when the execution ends and sends them back on its terminal frame or
unary result.

Span dict (the wire format, plain JSON)::

    {"name": "engine.prefill", "t0": 1722772800.123, "dur_ms": 14.2,
     "attrs": {"tokens": 128, "cached": 96}, "node": "node-a", "attempt": 1}

Always on:

- :class:`HistogramSet`: TTFT, inter-token gap, queue wait and tick
  duration; the node ships ``snapshot()`` on every heartbeat under
  ``latency_hist``, where the control plane re-exports it as per-node
  Prometheus histograms.
- :class:`FlightRecorder`: a fixed ring of per-tick scheduler rows, served
  at the node's ``GET /debug/flight`` and logged when an engine step fails.

The gateway's :class:`TraceStore` assembles every layer's spans of a trace
into the waterfall of ``GET /api/v1/executions/{id}/trace``.

Knobs: ``AGENTFIELD_TRACE`` (the gateway's master switch, default on: off
mints no trace id, so no ``trace`` key rides any frame or payload),
``AGENTFIELD_TRACE_BUFFER_SPANS`` (the span buffer's cap; the oldest traces
evict whole), ``AGENTFIELD_TRACE_TTL_S`` (the gateway store's retention)
and ``AGENTFIELD_FLIGHT_TICKS`` (the ring's rows). A node traces a request
when its caller sends a context: the gateway decides.
"""

from __future__ import annotations

import bisect
import collections
import os
import threading
import time
import uuid

# one runaway request (a branch fan-out, a preempt storm) must not evict
# every other trace from the buffer
_MAX_SPANS_PER_TRACE = 512


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def enabled() -> bool:
    """Is request-scoped tracing on? ``AGENTFIELD_TRACE`` (default on). The
    gateway reads it per execution; the flight recorder and the histograms
    ignore it."""
    return os.environ.get("AGENTFIELD_TRACE", "1").lower() not in ("0", "false", "no")


def new_trace_id() -> str:
    return f"tr_{uuid.uuid4().hex[:20]}"


def valid_context(ctx) -> dict | None:
    """A TraceContext is a dict with a str ``trace_id`` (``attempt`` and
    ``node`` labels optional); anything else reads as "not traced"."""
    if isinstance(ctx, dict) and isinstance(ctx.get("trace_id"), str):
        return ctx
    return None


def make_span(name: str, t0: float, dur_ms: float, attrs: dict | None = None) -> dict:
    span = {"name": name, "t0": round(t0, 6), "dur_ms": round(dur_ms, 3)}
    if attrs:
        span["attrs"] = attrs
    return span


class Tracer:
    """Bounded per-process span buffer, indexed by trace id. Writers are the
    engine's drive thread and the node's request threads; a reader pops a
    whole trace when its execution ends; one lock serializes both. When the
    total overflows ``max_spans`` the oldest trace evicts whole (a trace with
    half its spans missing reads as corrupt, not as cheap)."""

    def __init__(self, max_spans: int | None = None):
        self.max_spans = max_spans or _env_int("AGENTFIELD_TRACE_BUFFER_SPANS", 8192)
        self._lock = threading.Lock()
        self._traces: collections.OrderedDict[str, list[dict]] = collections.OrderedDict()
        self._total = 0
        self.dropped_spans = 0

    def record_span(self, name: str, trace_id: str | None, t0: float, dur_ms: float,
                    attrs: dict | None = None) -> None:
        """Record one finished span against ``trace_id`` (a no-op when it is
        None, so call sites stay unconditional for untraced requests)."""
        if not trace_id:
            return
        span = make_span(name, t0, dur_ms, attrs)
        with self._lock:
            spans = self._traces.get(trace_id)
            if spans is None:
                spans = self._traces[trace_id] = []
            if len(spans) >= _MAX_SPANS_PER_TRACE:
                self.dropped_spans += 1
                return
            spans.append(span)
            self._total += 1
            while self._total > self.max_spans and len(self._traces) > 1:
                _, evicted = self._traces.popitem(last=False)
                self._total -= len(evicted)
                self.dropped_spans += len(evicted)

    def pop(self, trace_id: str) -> list[dict]:
        """Remove and return a trace's spans."""
        with self._lock:
            spans = self._traces.pop(trace_id, None)
            if spans is None:
                return []
            self._total -= len(spans)
            return spans

    def span_count(self) -> int:
        with self._lock:
            return self._total


_TRACER: Tracer | None = None


def tracer() -> Tracer:
    """The process's span buffer (a process serves one node, whose engine
    and backend share it)."""
    global _TRACER
    if _TRACER is None:
        _TRACER = Tracer()
    return _TRACER


class TraceStore:
    """Gateway-side trace assembly: spans from every layer and every node
    accumulate under their trace id; ``get`` returns the ordered waterfall.
    In memory, retained ``retain_s`` after a trace's last span landed."""

    def __init__(self, retain_s: float | None = None, max_traces: int = 4096):
        self.retain_s = (retain_s if retain_s is not None
                         else float(_env_int("AGENTFIELD_TRACE_TTL_S", 600)))
        self.max_traces = max_traces
        self._lock = threading.Lock()
        self._traces: collections.OrderedDict[str, tuple[float, list[dict]]] = (
            collections.OrderedDict())

    def _purge_locked(self) -> None:
        cutoff = time.monotonic() - self.retain_s
        while self._traces:
            tid, (touched, _) = next(iter(self._traces.items()))
            if touched > cutoff and len(self._traces) <= self.max_traces:
                break
            self._traces.pop(tid, None)

    def record_span(self, name: str, trace_id: str | None, t0: float, dur_ms: float,
                    attrs: dict | None = None, node: str = "gateway") -> None:
        """A gateway-local span (dispatch attempts, queue wait, the root),
        recorded straight into the store."""
        if not trace_id:
            return
        span = make_span(name, t0, dur_ms, attrs)
        span.setdefault("node", node)
        self.extend(trace_id, [span])

    def extend(self, trace_id: str, spans) -> int:
        """Land shipped spans (terminal frames, result payloads), validated
        one by one: one node's malformed payload must not poison the trace."""
        if not isinstance(trace_id, str) or not isinstance(spans, list):
            return 0
        ok = [s for s in spans
              if isinstance(s, dict) and isinstance(s.get("name"), str)
              and isinstance(s.get("t0"), (int, float))
              and isinstance(s.get("dur_ms"), (int, float))]
        if not ok:
            return 0
        with self._lock:
            _, existing = self._traces.pop(trace_id, (0.0, []))
            existing.extend(ok[: max(0, _MAX_SPANS_PER_TRACE - len(existing))])
            self._traces[trace_id] = (time.monotonic(), existing)
            self._purge_locked()
        return len(ok)

    def get(self, trace_id: str) -> list[dict]:
        """The waterfall: spans by wall-clock start, the longer first on ties
        (a parent that began with its child renders above it)."""
        with self._lock:
            entry = self._traces.get(trace_id)
            spans = list(entry[1]) if entry is not None else []
        return sorted(spans, key=lambda s: (s.get("t0", 0.0), -s.get("dur_ms", 0.0)))

    def __len__(self) -> int:
        with self._lock:
            return len(self._traces)


# ms-scale buckets for serving latencies: sub-ms ticks through 30s tails.
MS_BUCKETS = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0,
)


class HistogramSet:
    """A fixed family of fixed-bucket latency histograms, cheap enough for
    the scheduler tick path (one bisect + two adds per observe, one shared
    lock). ``snapshot()`` is the heartbeat payload: cumulative counters, so
    the control plane re-publishes the latest snapshot per node."""

    def __init__(self, names: tuple[str, ...], buckets: tuple[float, ...] = MS_BUCKETS):
        self.buckets = tuple(float(b) for b in buckets)
        self._lock = threading.Lock()
        # per name: per-bucket counts (+1 overflow slot), sum, count
        self._h: dict[str, list] = {
            n: [[0] * (len(self.buckets) + 1), 0.0, 0] for n in names
        }

    def observe(self, name: str, value_ms: float) -> None:
        h = self._h.get(name)
        if h is None:
            raise KeyError(f"histogram {name!r} is not in this set")
        i = bisect.bisect_left(self.buckets, value_ms)
        with self._lock:
            h[0][i] += 1
            h[1] += value_ms
            h[2] += 1

    def snapshot(self) -> dict:
        """{name: {buckets, counts (per-bucket, +Inf last), sum, count}},
        JSON-safe."""
        with self._lock:
            return {
                name: {
                    "buckets": list(self.buckets),
                    "counts": list(h[0]),
                    "sum": round(h[1], 3),
                    "count": h[2],
                }
                for name, h in self._h.items()
            }


class FlightRecorder:
    """Fixed ring of per-tick engine rows: what the engine was doing in the
    ticks before a slow or failed one. Appends are deque-atomic (the drive
    thread); snapshots copy (request threads)."""

    def __init__(self, max_ticks: int | None = None):
        self.max_ticks = max_ticks or _env_int("AGENTFIELD_FLIGHT_TICKS", 512)
        self._ring: collections.deque[dict] = collections.deque(maxlen=self.max_ticks)
        self.ticks_recorded = 0

    def record(self, row: dict) -> None:
        self._ring.append(row)
        self.ticks_recorded += 1

    def snapshot(self, last: int | None = None) -> list[dict]:
        rows = list(self._ring)
        return rows[-last:] if last else rows
