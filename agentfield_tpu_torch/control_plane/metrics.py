"""Minimal Prometheus-style metrics registry.

Covers the reference's gateway metric surface
(internal/services/execution_metrics.go:14-44: queue depth, worker inflight,
step duration histogram, backpressure counter) plus serving-engine gauges
(tok/s, TTFT) — rendered in Prometheus text exposition format at /metrics
(reference serves the same endpoint, server.go:607).

Gauges and counters take an optional ``labels`` dict (rendered as
``name{k="v"}``); label values are escaped per the exposition format. The
label path exists for per-node engine gauges — a model node's heartbeat
stats (prefix-cache hit/miss/eviction/shared-page counters, the tiered-KV
offload family ``kv_offload_{demoted,restored,restore_fail,host_pages}``
(docs/PREFIX_CACHING.md "Tiered cache"), the cluster-tier transfer family
``kv_fetch_{requested,served,failed,bytes,pages_adopted}_total`` +
``prefix_sketch_truncated_total`` (docs/PREFIX_CACHING.md "Cluster tier"),
the branch-decoding family
``branch_{forks,forks_degraded,fork_failed,pruned,verifier_calls}_total``
(docs/PREFIX_CACHING.md "Fork / COW branches"), and the scheduler-latency
gauges ``itl_ms_p50``/``itl_ms_p99``/``tokens_per_tick`` from the mixed
token-budget scheduler, docs/MIXED_SCHEDULING.md) are re-exported here by
the registry via :func:`export_engine_stats`, so one control-plane
/metrics scrape covers the whole fleet's cache and scheduling behavior.
The gateway's own affinity/relay counters
(``prefix_affinity_hits_total{node=}``,
``kv_relay_{fetches,frames,errors}_total``) are first-party counters on
the same registry.
"""

from __future__ import annotations

import collections
import threading

from agentfield_tpu_torch import tracing as _tracing


def _label_str(labels: dict[str, str] | None) -> str:
    if not labels:
        return ""
    parts = []
    for k, v in sorted(labels.items()):
        v = str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


class Metrics:
    # Per-metric bucket defaults: seconds-scale for the historical
    # ``*_seconds`` histograms, ms-scale for latency metrics named ``*_ms``
    # (the engine's TTFT/ITL/queue-wait/tick families). A caller may still
    # pass explicit buckets — but the FIRST spec registered for a name wins
    # forever, and a later conflicting spec is a hard error instead of the
    # old silent first-caller-wins (a dashboard reading mis-bucketed
    # samples is worse than a crash at the bad call site).
    DEFAULT_BUCKETS = (0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60)
    # ONE ms-bucket layout for the whole /metrics surface: the engine's
    # heartbeat histograms (tracing.HistogramSet) and control-plane-side
    # *_ms observations must agree, or same-scale latency families render
    # with different buckets on one scrape.
    MS_BUCKETS = _tracing.MS_BUCKETS

    def __init__(self, prefix: str = "agentfield"):
        self.prefix = prefix
        self._lock = threading.Lock()
        # keyed (name, label_str) so one metric name can carry many label sets
        self._counters: dict[tuple[str, str], float] = collections.defaultdict(float)
        self._gauges: dict[tuple[str, str], float] = {}
        self._hist: dict[str, list[float]] = {}
        self._hist_buckets: dict[str, tuple[float, ...]] = {}
        # Heartbeat-fed per-node histogram SNAPSHOTS (cumulative bucket
        # counts + sum + count, replaced wholesale per heartbeat — the node
        # owns the counters; see export_engine_histograms).
        self._hist_snap: dict[tuple[str, str], tuple[tuple[float, ...], list[float], float, float]] = {}

    def inc(self, name: str, value: float = 1.0, labels: dict[str, str] | None = None) -> None:
        with self._lock:
            self._counters[(name, _label_str(labels))] += value

    def set_gauge(self, name: str, value: float, labels: dict[str, str] | None = None) -> None:
        with self._lock:
            self._gauges[(name, _label_str(labels))] = value

    def declare_histogram(self, name: str, buckets: tuple[float, ...]) -> None:
        """Register a metric's bucket bounds up front. Conflicting re-
        declaration (or a later ``observe`` with different explicit buckets)
        raises — one name, one bucket layout, forever."""
        b = tuple(float(x) for x in buckets)
        with self._lock:
            self._register_buckets_locked(name, b)

    def _register_buckets_locked(self, name: str, buckets: tuple[float, ...]) -> tuple[float, ...]:
        reg = self._hist_buckets.get(name)
        if reg is not None:
            if buckets != reg:
                raise ValueError(
                    f"histogram {name!r} is registered with buckets {reg}; "
                    f"conflicting spec {buckets} — one metric name has ONE "
                    "bucket layout (declare_histogram at startup if the "
                    "default is wrong)"
                )
            return reg
        self._hist_buckets[name] = buckets
        return buckets

    def observe(self, name: str, value: float, buckets: tuple[float, ...] | None = None) -> None:
        with self._lock:
            if buckets is not None:
                bks = self._register_buckets_locked(
                    name, tuple(float(x) for x in buckets)
                )
            else:
                bks = self._hist_buckets.get(name)
                if bks is None:
                    # ms-scale defaults for latency metrics, seconds-scale
                    # for the rest (the historical *_seconds histograms).
                    bks = self._register_buckets_locked(
                        name,
                        self.MS_BUCKETS if name.endswith("_ms") else self.DEFAULT_BUCKETS,
                    )
            if name not in self._hist:
                self._hist[name] = [0.0] * (len(bks) + 2)  # buckets + sum + count
            h = self._hist[name]
            for i, b in enumerate(bks):
                if value <= b:
                    h[i] += 1
            h[-2] += value
            h[-1] += 1

    def set_histogram_snapshot(
        self,
        name: str,
        labels: dict[str, str] | None,
        buckets: tuple[float, ...],
        counts: list[float],
        total: float,
        count: float,
    ) -> None:
        """Replace one labeled histogram series with a remote snapshot
        (``counts`` are PER-BUCKET with the +Inf overflow last — the
        heartbeat wire shape; rendered cumulatively). This is how a model
        node's engine histograms become real Prometheus histograms on the
        control plane's /metrics without pretending the control plane
        observed the samples."""
        b = tuple(float(x) for x in buckets)
        if len(counts) != len(b) + 1:
            raise ValueError(
                f"histogram snapshot {name!r}: {len(counts)} counts for "
                f"{len(b)} buckets (+Inf slot required)"
            )
        with self._lock:
            self._hist_snap[(name, _label_str(labels))] = (
                b, [float(c) for c in counts], float(total), float(count)
            )

    def counter_value(self, name: str, labels: dict[str, str] | None = None) -> float:
        with self._lock:
            return self._counters.get((name, _label_str(labels)), 0.0)

    def gauge_value(self, name: str, labels: dict[str, str] | None = None) -> float | None:
        with self._lock:
            return self._gauges.get((name, _label_str(labels)))

    def remove_gauges(self, labels: dict[str, str]) -> int:
        """Drop every gauge AND histogram snapshot carrying exactly this
        label set (e.g. a deregistered node's engine series — dead series
        must not accumulate in /metrics forever). Returns the number of
        series removed."""
        ls = _label_str(labels)
        with self._lock:
            keys = [k for k in self._gauges if k[1] == ls]
            for k in keys:
                del self._gauges[k]
            hkeys = [k for k in self._hist_snap if k[1] == ls]
            for k in hkeys:
                del self._hist_snap[k]
        return len(keys) + len(hkeys)

    def render(self) -> str:
        """Prometheus text exposition format (one TYPE line per metric name,
        then every label set's sample)."""
        out = []
        with self._lock:
            for kind, series in (("counter", self._counters), ("gauge", self._gauges)):
                last_name = None
                for (name, ls), v in sorted(series.items()):
                    if name != last_name:
                        out.append(f"# TYPE {self.prefix}_{name} {kind}")
                        last_name = name
                    out.append(f"{self.prefix}_{name}{ls} {v}")
            for name, h in sorted(self._hist.items()):
                buckets = self._hist_buckets[name]
                out.append(f"# TYPE {self.prefix}_{name} histogram")
                cum = 0.0
                for i, b in enumerate(buckets):
                    cum = h[i]
                    out.append(f'{self.prefix}_{name}_bucket{{le="{b}"}} {cum}')
                out.append(f'{self.prefix}_{name}_bucket{{le="+Inf"}} {h[-1]}')
                out.append(f"{self.prefix}_{name}_sum {h[-2]}")
                out.append(f"{self.prefix}_{name}_count {h[-1]}")
            # Heartbeat-fed per-node histogram snapshots (engine TTFT/ITL/
            # queue-wait/tick families): per-bucket counts render cumulative,
            # with the series labels merged into each sample's label set.
            last_name = None
            for (name, ls), (buckets, counts, total, count) in sorted(
                self._hist_snap.items()
            ):
                if name != last_name:
                    out.append(f"# TYPE {self.prefix}_{name} histogram")
                    last_name = name
                base = ls[1:-1] if ls else ""  # strip outer {} to merge le=
                cum = 0.0
                for i, b in enumerate(buckets):
                    cum += counts[i]
                    sep = "," if base else ""
                    out.append(
                        f'{self.prefix}_{name}_bucket{{{base}{sep}le="{b}"}} {cum}'
                    )
                cum += counts[-1]
                sep = "," if base else ""
                out.append(f'{self.prefix}_{name}_bucket{{{base}{sep}le="+Inf"}} {cum}')
                out.append(f"{self.prefix}_{name}_sum{ls} {total}")
                out.append(f"{self.prefix}_{name}_count{ls} {cum}")
        return "\n".join(out) + "\n"


_METRIC_NAME_RE = None  # compiled lazily


def export_engine_stats(metrics: Metrics, node_id: str, stats: dict) -> int:
    """Re-export a node's heartbeat stats as per-node gauges
    (``agentfield_engine_<stat>{node="<id>"}``). The whole numeric dict is
    exported — engine counters monotonically increase on the node, so gauges
    that mirror the latest heartbeat are the honest representation here
    (the node owns the counter; the control plane just re-publishes it).
    Keys that are not valid Prometheus metric-name fragments are dropped:
    heartbeat stats are client-supplied, and one bad key (space, newline)
    interpolated into a metric name would corrupt the whole /metrics
    exposition for every scraper. Returns the number of gauges written."""
    global _METRIC_NAME_RE
    if _METRIC_NAME_RE is None:
        import re

        _METRIC_NAME_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*\Z")
    n = 0
    for k, v in stats.items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        if not isinstance(k, str) or not _METRIC_NAME_RE.match(k):
            continue
        metrics.set_gauge(f"engine_{k}", float(v), labels={"node": node_id})
        n += 1
    return n


def export_engine_histograms(metrics: Metrics, node_id: str, payload: dict) -> int:
    """Re-export a node's heartbeat latency histograms (the engine's
    ``latency_hist`` stats block: TTFT / inter-token / queue-wait /
    tick-duration, docs/OBSERVABILITY.md) as per-node Prometheus histogram
    series ``agentfield_engine_<name>{node=...}``. Snapshot semantics, like
    :func:`export_engine_stats` — the node owns the cumulative counters and
    the control plane republishes the latest heartbeat. Malformed blocks
    are dropped key-by-key (heartbeat stats are client-supplied). Returns
    the number of series written."""
    global _METRIC_NAME_RE
    if _METRIC_NAME_RE is None:
        import re

        _METRIC_NAME_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*\Z")
    n = 0
    if not isinstance(payload, dict):
        return 0
    for name, snap in payload.items():
        if not isinstance(name, str) or not _METRIC_NAME_RE.match(name):
            continue
        if not isinstance(snap, dict):
            continue
        buckets = snap.get("buckets")
        counts = snap.get("counts")
        if not isinstance(buckets, list) or not isinstance(counts, list):
            continue
        if len(counts) != len(buckets) + 1:
            continue
        if not all(isinstance(x, (int, float)) and not isinstance(x, bool) for x in buckets + counts):
            continue
        try:
            metrics.set_histogram_snapshot(
                f"engine_{name}",
                {"node": node_id},
                tuple(buckets),
                list(counts),
                float(snap.get("sum", 0.0)),
                float(snap.get("count", 0.0)),
            )
        except (TypeError, ValueError):
            continue
        n += 1
    return n
