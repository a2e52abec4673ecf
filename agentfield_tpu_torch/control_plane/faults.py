"""Deterministic fault injection for failure-domain testing.

Production code asks a single question at each NAMED INJECTION POINT —
``faults.fire("gateway.agent_call.fail")`` — and gets back ``None`` (no
fault, the overwhelmingly common case: one dict lookup on a module-level
``None``) or a :class:`Fault` describing what to break. The schedule is
fully deterministic: each point owns its own ``random.Random`` stream seeded
from ``(seed, point)``, so the N-th decision at a point is a pure function
of the injector seed and N — independent of event-loop interleaving, of
other points' call counts, and of wall clock. Same seed → same failure
schedule, which is what lets the chaos tests run in tier-1 without flaking.

Injection points in-tree:

========================== =====================================================
``registry.heartbeat.drop``    the heartbeat is "lost in transit": the lease is
                               not refreshed (the node will look silent)
``gateway.agent_call.fail``    the agent HTTP call raises a transport error
                               before any bytes reach the agent
``gateway.agent_call.delay``   the agent HTTP call is delayed by ``delay_s``
                               before proceeding (slow network / GC pause)
``node.kill``                  harness-level: the fault_storm bench and chaos
                               tests consult this schedule to kill a node
                               mid-burst (the injector never kills anything
                               itself — it only answers "now?")
``engine.page_pressure``       a page allocation is denied as if the pool were
                               exhausted (KV pressure without a real workload)
``engine.preempt_storm``       the engine scheduler force-preempts an active
                               slot (parking its KV in the prefix index and
                               re-queueing the request) regardless of priority
                               or starvation — deterministic preempt/resume
                               churn for overload chaos tests; consulted once
                               per tick where a preemption is possible
``channel.drop``               the gateway↔node data-plane WebSocket is killed
                               abruptly (consulted once per received frame in
                               the gateway's channel receive loop, so ``after``
                               counts frames — a drop lands mid-stream at a
                               deterministic token index); recovery must
                               reattach by exec_id + last seq or apply the
                               frames-delivered failover rule
``kv.offload_stall``           the KV offload worker's device→host page copy
                               stalls ``delay_s`` before committing (consulted
                               once per demote, OFF the scheduler thread) —
                               a stalled copy must never corrupt the pool or
                               block the tick path; meanwhile the page stays
                               HBM-resident and evictable as usual
``kv.restore_fail``            a host-tier KV restore fails before the
                               host→device copy (consulted once per restore
                               attempt; ``times: K`` fails the first K) — the
                               lookup degrades to a shorter cached prefix and
                               the engine re-prefills the rest, token-exact
``kv.fetch_fail``              a cross-node KV page fetch fails on the SERVING
                               node before any page is exported (consulted
                               once per kv_fetch served) — the requester
                               adopts nothing and re-prefills locally,
                               token-exact, zero pages leaked
``kv.fetch_stall``             the serving node stalls ``delay_s`` before
                               answering a kv_fetch — the requester's fetch
                               timeout expires and it re-prefills locally; a
                               late response is discarded by fetch_id
``kv.handoff_fail``            the prefill node's handoff export is vetoed at
                               decision time (consulted once per eligible
                               prefill) — the slot simply keeps decoding
                               locally: single-node prefill+decode, token-
                               exact, zero pages leaked on either node
``kv.handoff_stall``           the serving node stalls ``delay_s`` before
                               answering a kv_fetch that carries a handoff
                               tail — the decode node's fetch times out, it
                               adopts nothing and re-prefills the whole
                               prompt locally (greedy re-samples the same
                               first token); the stale tail stash expires
                               by TTL, zero pages leaked
``spec.fail``                  speculative next-step prefill is vetoed at
                               enqueue time (consulted once per keep-warm
                               release with declared candidates) — the
                               session stays pinned but nothing is
                               speculated: the follow-up pays the ordinary
                               suffix prefill over the retained session,
                               token-exact, zero pages leaked
``spec.stall``                 speculative jobs sit out ``delay_s`` before
                               becoming admissible — a follow-up that wins
                               the race absorbs nothing (the deferred jobs
                               cancel unstarted), token-exact, zero pages
                               leaked
========================== =====================================================

Activation: explicitly via :func:`install` (tests, bench), or process-wide
via the env knob ``AGENTFIELD_FAULTS`` — a JSON spec, e.g.::

    AGENTFIELD_FAULTS='{"gateway.agent_call.fail": {"prob": 0.2, "times": 3}}'
    AGENTFIELD_FAULTS_SEED=7

With the knob unset and nothing installed, every injection point costs a
``None`` check and nothing else — the hot paths are untouched.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
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
    delay_s: float = 0.0  # for *.delay points: how long to stall
    error: str = "injected fault"  # message for synthesized failures


@dataclasses.dataclass
class _PointState:
    prob: float = 1.0  # probability each consultation fires
    times: int | None = None  # stop firing after this many (None = forever)
    after: int = 0  # skip the first `after` consultations (arm late)
    delay_s: float = 0.0
    fired: int = 0
    calls: int = 0
    rng: random.Random = dataclasses.field(default_factory=random.Random)


class FaultInjector:
    """Seeded, per-point-deterministic fault schedule.

    ``spec`` maps point name → options::

        {"gateway.agent_call.fail": {"prob": 0.5, "times": 2, "after": 1},
         "gateway.agent_call.delay": {"prob": 1.0, "delay_s": 0.05}}

    Unknown point names are rejected loudly — a typo'd point would otherwise
    silently never fire and the chaos test would pass vacuously.
    """

    def __init__(self, seed: int = 0, spec: dict[str, dict[str, Any]] | None = None):
        self.seed = seed
        self._points: dict[str, _PointState] = {}
        for point, opts in (spec or {}).items():
            if point not in KNOWN_POINTS:
                raise ValueError(
                    f"unknown fault point {point!r}; known: {KNOWN_POINTS}"
                )
            if not isinstance(opts, dict):
                raise ValueError(f"fault spec for {point!r} must be an object")
            st = _PointState(
                prob=float(opts.get("prob", 1.0)),
                times=(int(opts["times"]) if opts.get("times") is not None else None),
                after=int(opts.get("after", 0)),
                delay_s=float(opts.get("delay_s", 0.0)),
            )
            # Per-point stream: the N-th decision at a point depends only on
            # (seed, point, N) — concurrent tasks consulting OTHER points
            # cannot perturb this one's schedule.
            digest = hashlib.blake2b(
                f"{seed}:{point}".encode(), digest_size=8
            ).digest()
            st.rng = random.Random(int.from_bytes(digest, "big"))
            self._points[point] = st

    def fire(self, point: str) -> Fault | None:
        """Consult the schedule at `point`. Returns a Fault when it fires."""
        st = self._points.get(point)
        if st is None:
            return None
        st.calls += 1
        if st.calls <= st.after:
            return None
        if st.times is not None and st.fired >= st.times:
            return None
        # Draw even when prob==1.0 so `times`/`after` edits don't shift the
        # stream consumed by later decisions at this point.
        if st.rng.random() >= st.prob:
            return None
        st.fired += 1
        return Fault(
            point=point,
            delay_s=st.delay_s,
            error=f"injected fault at {point} (#{st.fired}, seed={self.seed})",
        )

    def stats(self) -> dict[str, dict[str, int]]:
        """Per-point consultation/fire counts (chaos-test assertions)."""
        return {
            p: {"calls": st.calls, "fired": st.fired}
            for p, st in self._points.items()
        }


_active: FaultInjector | None = None
_env_checked = False


def install(injector: FaultInjector | None) -> None:
    """Install (or clear, with None) the process-wide injector."""
    global _active, _env_checked
    _active = injector
    _env_checked = True  # explicit install wins over the env knob


def active() -> FaultInjector | None:
    """The process-wide injector, resolving $AGENTFIELD_FAULTS once."""
    global _active, _env_checked
    if not _env_checked:
        _env_checked = True
        raw = os.environ.get("AGENTFIELD_FAULTS")
        if raw:
            spec = json.loads(raw)
            seed = int(os.environ.get("AGENTFIELD_FAULTS_SEED", "0"))
            _active = FaultInjector(seed=seed, spec=spec)
    return _active


def fire(point: str) -> Fault | None:
    """Module-level convenience: consult the active injector (None-cheap)."""
    inj = active()
    return inj.fire(point) if inj is not None else None
