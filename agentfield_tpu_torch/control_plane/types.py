"""Core control-plane record types.

Mirrors the semantic content of the reference's pkg/types (AgentNode,
Execution, status enums — reference: control-plane/pkg/types/types.go:158,
status machine in pkg/types/status_test.go) without copying its structure:
records here are plain dataclasses serialized to/from SQLite rows and JSON.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import time
import uuid
from typing import Any


def now() -> float:
    return time.time()


def new_id(prefix: str) -> str:
    return f"{prefix}_{uuid.uuid4().hex[:20]}"


class NodeStatus(str, enum.Enum):
    STARTING = "starting"
    ACTIVE = "active"
    INACTIVE = "inactive"
    STOPPING = "stopping"

    @staticmethod
    def valid_transition(old: "NodeStatus", new: "NodeStatus") -> bool:
        """Status state machine (reference: StatusManager.isValidTransition,
        internal/services/status_manager.go:449). Self-transitions allowed."""
        if old == new:
            return True
        allowed = {
            NodeStatus.STARTING: {NodeStatus.ACTIVE, NodeStatus.INACTIVE, NodeStatus.STOPPING},
            NodeStatus.ACTIVE: {NodeStatus.INACTIVE, NodeStatus.STOPPING},
            NodeStatus.INACTIVE: {NodeStatus.ACTIVE, NodeStatus.STARTING, NodeStatus.STOPPING},
            NodeStatus.STOPPING: {NodeStatus.INACTIVE, NodeStatus.STARTING},
        }
        return new in allowed[old]


class ExecutionStatus(str, enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    COMPLETED = "completed"
    FAILED = "failed"
    TIMEOUT = "timeout"
    # Retry budget exhausted on a *node-level* failure (transport error /
    # node down) — the work itself may be fine; operators triage and requeue
    # via POST /api/v1/dead-letter/{id}/requeue (docs/FAULT_TOLERANCE.md).
    DEAD_LETTER = "dead_letter"

    @property
    def terminal(self) -> bool:
        return self in (
            ExecutionStatus.COMPLETED,
            ExecutionStatus.FAILED,
            ExecutionStatus.TIMEOUT,
            ExecutionStatus.DEAD_LETTER,
        )


class TargetType(str, enum.Enum):
    REASONER = "reasoner"
    SKILL = "skill"
    GENERATE = "generate"  # model-node inference target (no reference analogue:
    # this is the in-tree TPU serving path)


@dataclasses.dataclass
class ComponentMeta:
    """A reasoner or skill exposed by a node."""

    id: str
    node_id: str
    kind: str  # "reasoner" | "skill"
    description: str = ""
    input_schema: dict[str, Any] = dataclasses.field(default_factory=dict)
    output_schema: dict[str, Any] = dataclasses.field(default_factory=dict)
    did: str | None = None

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class AgentNode:
    node_id: str
    base_url: str
    status: NodeStatus = NodeStatus.STARTING
    kind: str = "agent"  # "agent" | "model" (TPU serving node)
    reasoners: list[ComponentMeta] = dataclasses.field(default_factory=list)
    skills: list[ComponentMeta] = dataclasses.field(default_factory=list)
    metadata: dict[str, Any] = dataclasses.field(default_factory=dict)
    did: str | None = None
    registered_at: float = dataclasses.field(default_factory=now)
    last_heartbeat: float = dataclasses.field(default_factory=now)

    def component(self, name: str) -> tuple[ComponentMeta, TargetType] | None:
        for r in self.reasoners:
            if r.id == name:
                return r, TargetType.REASONER
        for s in self.skills:
            if s.id == name:
                return s, TargetType.SKILL
        return None

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["status"] = self.status.value
        return d

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "AgentNode":
        d = dict(d)
        d["status"] = NodeStatus(d.get("status", "starting"))
        d["reasoners"] = [ComponentMeta(**r) for r in d.get("reasoners", [])]
        d["skills"] = [ComponentMeta(**s) for s in d.get("skills", [])]
        return AgentNode(**d)


@dataclasses.dataclass
class Execution:
    """One reasoner/skill/generate invocation. The flat parent/run linkage is
    what the workflow DAG is rebuilt from (reference: workflow_dag.go:268
    builds the DAG from executions' parent_execution_id)."""

    execution_id: str
    target: str  # "node_id.component"
    target_type: TargetType
    status: ExecutionStatus
    run_id: str
    parent_execution_id: str | None = None
    session_id: str | None = None
    actor_id: str | None = None
    input: Any = None
    result: Any = None
    error: str | None = None
    webhook_url: str | None = None
    created_at: float = dataclasses.field(default_factory=now)
    started_at: float | None = None
    finished_at: float | None = None
    notes: list[dict[str, Any]] = dataclasses.field(default_factory=list)
    # Failure-recovery bookkeeping (gateway retry/failover — the fields
    # default so pre-existing persisted docs round-trip unchanged):
    attempts: int = 0  # agent-call attempts consumed across all nodes
    nodes_tried: list[str] = dataclasses.field(default_factory=list)
    retry_policy: dict[str, Any] | None = None  # per-execution override of
    # the gateway RetryPolicy (keys: max_attempts, base_backoff, max_backoff)
    # Overload control (docs/FAULT_TOLERANCE.md): higher priority dispatches
    # first on the model node's admission window; deadline_s is a wall-clock
    # budget in seconds from created_at — queued async work whose deadline
    # already passed is SHED before dispatch instead of occupying a worker,
    # and the remaining budget rides to the model node so the engine can
    # deadline-out the request mid-queue or mid-decode.
    priority: int = 0
    deadline_s: float | None = None
    # Branch decoding (test-time scaling, docs/PREFIX_CACHING.md "Fork /
    # COW branches"): validated at the gateway like priority/deadline_s and
    # injected into a model node's generate input — the engine forks the
    # request's KV after one prefill and returns only the winner.
    n_branches: int = 1
    branch_policy: Any = None
    # Streaming data plane (docs/ARCHITECTURE.md): token frames already
    # delivered to the client-visible stream when this execution went
    # terminal. Non-zero means the execution may never be transparently
    # replayed (a retry would duplicate tokens a client consumed) — the
    # gateway dead-letters instead, and operators triaging the dead letter
    # see exactly how much of the stream the caller got.
    frames_delivered: int = 0
    # Request-scoped tracing (docs/OBSERVABILITY.md): the trace id the
    # gateway minted for this execution, persisted so operators can go from
    # any execution row to GET /api/v1/executions/{id}/trace. None when
    # tracing is off (AGENTFIELD_TRACE=0) or for rows predating the trace
    # subsystem. The spans themselves live in the gateway's in-memory
    # TraceStore (TTL-bounded), not the database.
    trace_id: str | None = None
    # Agent-aware serving (docs/OPERATIONS.md "Agent-aware serving"): the
    # caller (or the gateway's DAG-successor inference) declared a follow-up
    # step will reuse this execution's session — the serving node pins the
    # session's KV warm and may speculatively prefill the next step. A pure
    # hint: it can never change results, only latency.
    expect_followup: bool = False

    def to_dict(self) -> dict[str, Any]:
        # Hand-rolled: dataclasses.asdict() deep-copies every nested value
        # and was ~10% of the gateway dispatch hot path (2-3 serializations
        # per request). Containers the gateway mutates in place (notes,
        # nodes_tried, retry_policy) are copied so a snapshot — e.g. a row
        # buffered in the storage group-commit journal — can never change
        # under a later append; input/result are caller-owned payloads the
        # control plane treats as immutable and shares by reference.
        return {
            "execution_id": self.execution_id,
            "target": self.target,
            "target_type": self.target_type.value,
            "status": self.status.value,
            "run_id": self.run_id,
            "parent_execution_id": self.parent_execution_id,
            "session_id": self.session_id,
            "actor_id": self.actor_id,
            "input": self.input,
            "result": self.result,
            "error": self.error,
            "webhook_url": self.webhook_url,
            "created_at": self.created_at,
            "started_at": self.started_at,
            "finished_at": self.finished_at,
            "notes": [dict(n) for n in self.notes],
            "attempts": self.attempts,
            "nodes_tried": list(self.nodes_tried),
            "retry_policy": dict(self.retry_policy) if self.retry_policy else self.retry_policy,
            "priority": self.priority,
            "deadline_s": self.deadline_s,
            "n_branches": self.n_branches,
            "branch_policy": dict(self.branch_policy)
            if isinstance(self.branch_policy, dict)
            else self.branch_policy,
            "frames_delivered": self.frames_delivered,
            "trace_id": self.trace_id,
            "expect_followup": self.expect_followup,
        }

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "Execution":
        d = dict(d)
        d["target_type"] = TargetType(d["target_type"])
        d["status"] = ExecutionStatus(d["status"])
        # Copy the gateway-mutated containers: the source doc may be shared
        # with the storage journal's overlay snapshot, and an in-place
        # append through the returned Execution must not rewrite it (the
        # EMPTY list is exactly the one the first append would mutate, so
        # presence, not truthiness, decides).
        if "notes" in d:
            d["notes"] = [dict(n) for n in d["notes"]]
        if "nodes_tried" in d:
            d["nodes_tried"] = list(d["nodes_tried"])
        return Execution(**d)


def dumps(obj: Any) -> str:
    return json.dumps(obj, separators=(",", ":"), default=str)
