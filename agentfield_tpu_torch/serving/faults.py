"""Deterministic fault injection — the port's copy of the injector contract
of ``agentfield_tpu/control_plane/faults.py``.

Code asks one question at each named injection point, ``fire(point)``, and
gets ``None`` (no injector installed, or the schedule says no: one global
read) or a :class:`Fault`. Each point owns a ``random.Random`` stream seeded
from ``(seed, point)``, so the N-th decision at a point depends only on the
injector's seed and N, as in the JAX package: the same spec drives both
packages' engines through the same failure schedule.

The points the port consults:

``kv.offload_stall``      the offload worker's device-to-host page copy
                          stalls ``delay_s`` before it commits (once per
                          demote, off the scheduler thread)
``kv.restore_fail``       a host-tier restore fails before its upload (once
                          per restore attempt): the prefix walk shortens and
                          the request re-prefills the rest
``engine.page_pressure``  a page allocation is denied as if the pool were
                          exhausted
``engine.preempt_storm``  the scheduler preempts an active slot regardless
                          of priority or starvation (once per tick where a
                          preemption is possible)

Activation is explicit: :func:`install` an injector (the port reads no
environment variable for it).
"""

from __future__ import annotations

import dataclasses
import hashlib
import random
from typing import Any

KNOWN_POINTS = (
    "registry.heartbeat.drop",
    "gateway.agent_call.fail",
    "gateway.agent_call.delay",
    "node.kill",
    "engine.page_pressure",
    "engine.preempt_storm",
    "channel.drop",
    "kv.offload_stall",
    "kv.restore_fail",
    "kv.fetch_fail",
    "kv.fetch_stall",
    "kv.handoff_fail",
    "kv.handoff_stall",
    "spec.fail",
    "spec.stall",
)


@dataclasses.dataclass(frozen=True)
class Fault:
    """One fired fault: the point it fired at and the action parameters."""

    point: str
    delay_s: float = 0.0  # for stall points: how long to stall
    error: str = "injected fault"  # message for synthesized failures


@dataclasses.dataclass
class _PointState:
    prob: float = 1.0  # probability each consultation fires
    times: int | None = None  # stop firing after this many (None = forever)
    after: int = 0  # skip the first `after` consultations
    delay_s: float = 0.0
    fired: int = 0
    calls: int = 0
    rng: random.Random = dataclasses.field(default_factory=random.Random)


class FaultInjector:
    """Seeded, per-point-deterministic fault schedule. ``spec`` maps a point
    name to ``{"prob", "times", "after", "delay_s"}``; an unknown point name
    raises (a typo would otherwise never fire)."""

    def __init__(self, seed: int = 0, spec: dict[str, dict[str, Any]] | None = None):
        self.seed = seed
        self._points: dict[str, _PointState] = {}
        for point, opts in (spec or {}).items():
            if point not in KNOWN_POINTS:
                raise ValueError(f"unknown fault point {point!r}; known: {KNOWN_POINTS}")
            if not isinstance(opts, dict):
                raise ValueError(f"fault spec for {point!r} must be an object")
            st = _PointState(
                prob=float(opts.get("prob", 1.0)),
                times=(int(opts["times"]) if opts.get("times") is not None else None),
                after=int(opts.get("after", 0)),
                delay_s=float(opts.get("delay_s", 0.0)),
            )
            digest = hashlib.blake2b(f"{seed}:{point}".encode(), digest_size=8).digest()
            st.rng = random.Random(int.from_bytes(digest, "big"))
            self._points[point] = st

    def fire(self, point: str) -> Fault | None:
        """Consult the schedule at ``point``; a Fault when it fires."""
        st = self._points.get(point)
        if st is None:
            return None
        st.calls += 1
        if st.calls <= st.after:
            return None
        if st.times is not None and st.fired >= st.times:
            return None
        # draw even at prob 1.0, so `times`/`after` do not shift the stream
        if st.rng.random() >= st.prob:
            return None
        st.fired += 1
        return Fault(point=point, delay_s=st.delay_s,
                     error=f"injected fault at {point} (#{st.fired}, seed={self.seed})")


_active: FaultInjector | None = None


def install(injector: FaultInjector | None) -> None:
    """Install (or clear, with None) the process-wide injector."""
    global _active
    _active = injector


def active() -> FaultInjector | None:
    return _active


def fire(point: str) -> Fault | None:
    """Consult the installed injector (None when none is installed)."""
    inj = _active
    return inj.fire(point) if inj is not None else None
