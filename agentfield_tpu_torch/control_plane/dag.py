"""Workflow DAG construction and run-status aggregation.

The flat `executions` table (run_id + parent_execution_id columns) is the
source of truth; the DAG is a pure read-side projection — exactly the
reference's approach (internal/handlers/workflow_dag.go:268 builds from
parent_execution_id; internal/services/workflowstatus/aggregator.go:49 folds
statuses with failure > running > queued precedence). The DAG doubles as the
application-level trace: every agent→agent call and every ai() model call is
a node.
"""

from __future__ import annotations

from typing import Any

from agentfield_tpu_torch.control_plane.storage import SQLiteStorage
from agentfield_tpu_torch.control_plane.types import Execution, ExecutionStatus

# Aggregation precedence (highest wins), mirroring the reference aggregator.
_PRECEDENCE = [
    ExecutionStatus.FAILED,
    ExecutionStatus.DEAD_LETTER,
    ExecutionStatus.TIMEOUT,
    ExecutionStatus.RUNNING,
    ExecutionStatus.QUEUED,
    ExecutionStatus.COMPLETED,
]


def aggregate_status(statuses: list[ExecutionStatus]) -> str:
    """Fold execution statuses into one run status."""
    if not statuses:
        return "empty"
    for s in _PRECEDENCE:
        if s in statuses:
            return s.value
    return "unknown"


def infer_expect_followup(parent_execution_id: str | None, session_id: str | None) -> bool:
    """DAG-successor inference for agent-aware serving (docs/OPERATIONS.md
    "Agent-aware serving"): should dispatch hint the serving node that a
    follow-up on the same session is likely, without the caller saying so?

    The structural signal is the one the flat executions table already
    carries: a NON-ROOT step of a session-carrying chain. A child execution
    (``parent_execution_id`` set) reusing a session is, by construction, an
    agent program mid-flight — reasoner → tool → reasoner — and its session
    will be hit again when the tool result lands. Roots stay cold (a
    one-shot call with a session id is the common non-agent case), so the
    inference never pins single-turn traffic. Pure function of the two
    columns: no storage read on the dispatch hot path."""
    return bool(parent_execution_id) and bool(session_id)


_DAG_LIMIT = 5000


def build_dag(storage: SQLiteStorage, run_id: str, lightweight: bool = False) -> dict[str, Any]:
    """Nodes = executions of the run; edges = parent links. Parents missing
    from the run (cross-run references) surface as dangling edge sources.
    Runs beyond _DAG_LIMIT executions are truncated *newest-first* (so live
    work is never hidden) and flagged."""
    executions = storage.list_executions(run_id=run_id, limit=_DAG_LIMIT, newest_first=True)
    truncated = len(executions) == _DAG_LIMIT
    executions = sorted(executions, key=lambda e: e.created_at)
    known = {e.execution_id for e in executions}

    def node(e: Execution) -> dict[str, Any]:
        base = {
            "execution_id": e.execution_id,
            "target": e.target,
            "target_type": e.target_type.value,
            "status": e.status.value,
            "parent_execution_id": e.parent_execution_id,
            "created_at": e.created_at,
            "finished_at": e.finished_at,
            "duration_s": (e.finished_at - e.started_at)
            if (e.finished_at and e.started_at)
            else None,
        }
        if not lightweight:
            base.update({"input": e.input, "result": e.result, "error": e.error, "notes": e.notes})
        return base

    edges = [
        {"from": e.parent_execution_id, "to": e.execution_id, "dangling": e.parent_execution_id not in known}
        for e in executions
        if e.parent_execution_id
    ]
    roots = [e.execution_id for e in executions if not e.parent_execution_id or e.parent_execution_id not in known]
    return {
        "run_id": run_id,
        "overall_status": aggregate_status([e.status for e in executions]),
        "nodes": [node(e) for e in executions],
        "edges": edges,
        "roots": roots,
        "truncated": truncated,
    }


def run_summaries(storage: SQLiteStorage, limit: int = 50) -> list[dict[str, Any]]:
    """Most-recent runs with aggregate status/counts — pure SQL GROUP BY in
    the storage layer, exact regardless of table size."""
    return storage.run_summaries(limit=limit)
