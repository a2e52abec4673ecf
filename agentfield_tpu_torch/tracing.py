"""Always-on latency histograms — the port's copy of ``HistogramSet`` from
``agentfield_tpu/tracing.py``. The engine observes TTFT, inter-token gap,
queue wait and tick duration into one set; the node ships ``snapshot()`` on
every heartbeat under ``latency_hist``, where the control plane re-exports
it as per-node Prometheus histograms. Request-scoped spans and the flight
recorder are not ported yet.
"""

from __future__ import annotations

import bisect
import threading

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
