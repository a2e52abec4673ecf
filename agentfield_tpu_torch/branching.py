"""Branch-decoding policy and group lifecycle (test-time scaling) — the
port's copy of the jax-free ``agentfield_tpu/branching.py``.

The engine forks a request's KV after its prefill (shared full pages, a
copied tail page), so best-of-N and beam decoding cost one prefill plus N
decode batch-mates instead of N full requests. This module holds the
policy half, the same contract as the JAX module's:

- ``validate_branch_spec``: the one validation of ``(n_branches,
  branch_policy)``, with the JAX messages;
- ``branch_rid``: sibling request ids, shared by the engine's forks and the
  group;
- ``BranchGroup``: accumulates each branch's cumulative logprob from its
  ``TokenEvent.logprob``s, applies the policy (``best_of_n``: every branch
  decodes to the end, the best cumulative logprob wins; ``beam``: every
  ``beam_interval`` tokens the top ``beam_width`` live branches survive,
  the rest are cancelled and the survivors re-fork back to N) and tells its
  owner (the model node) which branches to cancel or fork and when to
  resolve. Pure bookkeeping, driven from one thread.

A policy may name a ``verifier`` reasoner; the port has no control-plane
client yet, so its node resolves by cumulative logprob, as the JAX node does
when it has no verifier hook. ``$AGENTFIELD_BRANCH_MAX`` caps
``n_branches`` as in the JAX module.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

# Sibling request ids derive from the parent's: "<parent>#b<j>". The engine
# mints them at fork time and the group coordinator predicts them, so the
# two never need a side channel. "#" cannot appear in node-minted ids
# ("gen_<n>").
BRANCH_SEP = "#b"

_POLICY_TYPES = ("best_of_n", "beam")

_DEFAULT_MAX_BRANCHES = 32


def max_branches() -> int:
    """Upper bound on ``n_branches``. ``$AGENTFIELD_BRANCH_MAX`` overrides
    the default (32): a valve against a client amplifying one request into
    unbounded page pressure."""
    raw = os.environ.get("AGENTFIELD_BRANCH_MAX")
    if raw is None:
        return _DEFAULT_MAX_BRANCHES
    try:
        v = int(raw)
    except ValueError:
        return _DEFAULT_MAX_BRANCHES
    return v if v >= 1 else _DEFAULT_MAX_BRANCHES


def branch_rid(parent: str, j: int) -> str:
    """Request id of branch ``j`` of ``parent`` (branch 0 IS the parent)."""
    return parent if j == 0 else f"{parent}{BRANCH_SEP}{j}"


def validate_branch_spec(
    n_branches: Any, branch_policy: Any
) -> tuple[int, dict[str, Any] | None]:
    """Validate and normalize the (n_branches, branch_policy) pair the model
    node accepts. Returns
    ``(n, policy_dict_or_None)`` — policy is None exactly when n == 1.
    Raises ValueError with a client-presentable message otherwise."""
    if n_branches is None:
        n_branches = 1
    if isinstance(n_branches, bool) or not isinstance(n_branches, int):
        raise ValueError(f"n_branches must be an integer, got {n_branches!r}")
    cap = max_branches()
    if not 1 <= n_branches <= cap:
        raise ValueError(
            f"n_branches={n_branches} must be in [1, {cap}] "
            "(cap: $AGENTFIELD_BRANCH_MAX)"
        )
    if n_branches == 1:
        if branch_policy not in (None, {}, ""):
            raise ValueError("branch_policy requires n_branches > 1")
        return 1, None
    if branch_policy is None:
        branch_policy = "best_of_n"
    if isinstance(branch_policy, str):
        branch_policy = {"type": branch_policy}
    if not isinstance(branch_policy, dict):
        raise ValueError(
            f"branch_policy must be a string or object, got {branch_policy!r}"
        )
    ptype = branch_policy.get("type", "best_of_n")
    if ptype not in _POLICY_TYPES:
        raise ValueError(
            f"branch_policy.type must be one of {_POLICY_TYPES}, got {ptype!r}"
        )
    out: dict[str, Any] = {"type": ptype}
    verifier = branch_policy.get("verifier")
    if verifier is not None:
        if not isinstance(verifier, str) or "." not in verifier:
            raise ValueError(
                "branch_policy.verifier must be a '<node>.<reasoner>' target"
            )
        out["verifier"] = verifier
    if ptype == "beam":
        width = branch_policy.get("beam_width", max(1, n_branches // 2))
        interval = branch_policy.get("beam_interval", 16)
        for name, v in (("beam_width", width), ("beam_interval", interval)):
            if isinstance(v, bool) or not isinstance(v, int) or v < 1:
                raise ValueError(f"branch_policy.{name} must be an int >= 1")
        if width >= n_branches:
            raise ValueError(
                f"beam_width={width} must be < n_branches={n_branches} "
                "(otherwise nothing is ever pruned)"
            )
        out["beam_width"] = width
        out["beam_interval"] = interval
    unknown = set(branch_policy) - {"type", "verifier", "beam_width", "beam_interval"}
    if unknown:
        raise ValueError(f"unknown branch_policy keys: {sorted(unknown)}")
    return n_branches, out


# Terminal finish reasons that make a branch a WINNER CANDIDATE (it produced
# a complete, usable generation). Everything else (deadline_exceeded,
# fork_failed, error:*) still finishes the branch but only wins when no
# candidate exists.
_CANDIDATE_REASONS = ("stop", "length")


@dataclasses.dataclass
class _Branch:
    rid: str
    index: int  # order within the group (branch 0 = parent)
    forked_from: str | None = None  # rid of the refork source (beam children)
    records: list[tuple[int, float | None]] = dataclasses.field(default_factory=list)
    cum_logprob: float = 0.0
    seeded: bool = False  # beam children lazily copy the source's shared
    # prefix records on their first event (the event index names the exact
    # fork point — the engine may have decoded past the decision tick)
    finished: bool = False
    finish_reason: str | None = None
    pruned: bool = False

    @property
    def live(self) -> bool:
        return not self.finished and not self.pruned


class BranchGroup:
    """One branched request's lifecycle. Feed every branch TokenEvent to
    :meth:`on_event`; apply the returned actions (see module docstring).
    All bookkeeping is single-threaded — the owner drives it from its engine
    loop."""

    def __init__(self, parent_rid: str, n: int, policy: dict[str, Any]):
        self.parent = parent_rid
        self.n = n
        self.policy = dict(policy)
        self.resolved = False
        self._next_idx = n  # refork ids are minted only inside on_event
        self._boundary = self.policy.get("beam_interval", 0) or 0
        # the per-branch records: mutated only inside on_event, on the
        # owner's engine loop
        self._branches: dict[str, _Branch] = {}
        for j in range(n):
            rid = branch_rid(parent_rid, j)
            self._branches[rid] = _Branch(rid=rid, index=j)

    # -- owner-facing views -------------------------------------------

    def branch_rids(self) -> list[str]:
        return list(self._branches)

    def branch(self, rid: str) -> _Branch | None:
        return self._branches.get(rid)

    def pruned_count(self) -> int:
        return sum(1 for b in self._branches.values() if b.pruned)

    def candidates(self) -> list[_Branch]:
        """Finished, unpruned branches with a usable generation, best
        cumulative logprob first (ties: lowest branch index — branch 0 wins
        a fully tied greedy group, the parity pin relies on it)."""
        cands = [
            b
            for b in self._branches.values()
            if b.finished
            and not b.pruned
            and b.records
            and b.finish_reason in _CANDIDATE_REASONS
        ]
        return sorted(cands, key=lambda b: (-b.cum_logprob, b.index))

    def fallback_branch(self) -> _Branch | None:
        """When no branch produced a complete generation (all deadline-outed
        or errored): the branch with the most to show for itself, so the
        caller still gets the partial tokens + the real finish_reason."""
        done = [b for b in self._branches.values() if b.finished and not b.pruned]
        if not done:
            done = [b for b in self._branches.values() if not b.pruned]
        if not done:
            done = list(self._branches.values())
        return max(done, key=lambda b: (len(b.records), -b.index), default=None)

    def summary(self, winner: _Branch | None, verifier_used: bool) -> dict[str, Any]:
        """The ``branches`` block attached to a branched result."""
        return {
            "n": self.n,
            "policy": self.policy.get("type"),
            "winner": winner.index if winner is not None else None,
            "pruned": self.pruned_count(),
            "forked": len(self._branches),
            "verifier_used": bool(verifier_used),
            "scores": {
                str(b.index): round(b.cum_logprob, 4)
                for b in self._branches.values()
                if b.records and not b.pruned
            },
        }

    # -- event feed ----------------------------------------------------

    def on_event(self, rid: str, ev: Any) -> list[tuple]:
        """Apply one TokenEvent from branch ``rid``. Returns actions for the
        owner: ``("cancel", rid)`` — prune through request_cancel;
        ``("fork", src_rid, new_rid)`` — beam refork through request_fork
        (the owner must route the new rid back to this group); ``("resolve",)``
        — every branch is settled, pick the winner."""
        b = self._branches.get(rid)
        if b is None or self.resolved or b.finished:
            return []
        if b.forked_from is not None and not b.seeded:
            # Beam child: its first event's index IS the fork point — seed
            # the shared prefix from the source branch's records so scores
            # compare full sequences, not post-fork suffixes.
            b.seeded = True
            src = self._branches.get(b.forked_from)
            if src is not None and ev.index > 0:
                shared = src.records[: ev.index]
                b.records = list(shared)
                b.cum_logprob = sum(lp for _, lp in shared if lp is not None)
        if ev.token >= 0:
            b.records.append((ev.token, ev.logprob))
            if ev.logprob is not None:
                b.cum_logprob += ev.logprob
        if ev.finished:
            b.finished = True
            b.finish_reason = ev.finish_reason
        actions: list[tuple] = []
        if self.policy.get("type") == "beam" and not ev.finished:
            actions += self._maybe_beam_step()
        if all(not br.live for br in self._branches.values()):
            self.resolved = True
            actions.append(("resolve",))
        return actions

    def _maybe_beam_step(self) -> list[tuple]:
        """Beam pruning: once EVERY live branch has reached the current
        token boundary, keep the top ``beam_width`` by cumulative logprob,
        cancel the rest, and refork the survivors (round-robin, best first)
        until the live count is back to N."""
        live = [b for b in self._branches.values() if b.live]
        interval = self.policy.get("beam_interval", 16)
        if not live or min(len(b.records) for b in live) < self._boundary:
            return []
        self._boundary += interval
        width = self.policy.get("beam_width", 1)
        ranked = sorted(live, key=lambda b: (-b.cum_logprob, b.index))
        survivors, losers = ranked[:width], ranked[width:]
        actions: list[tuple] = []
        for b in losers:
            b.pruned = True
            actions.append(("cancel", b.rid))
        refill = self.n - len(survivors)
        for i in range(refill):
            src = survivors[i % len(survivors)]
            new_rid = branch_rid(self.parent, self._next_idx)
            child = _Branch(
                rid=new_rid, index=self._next_idx, forked_from=src.rid
            )
            self._branches[new_rid] = child
            self._next_idx += 1
            actions.append(("fork", src.rid, new_rid))
        return actions
