"""Execution context propagation: the port's copy of
``agentfield_tpu/sdk/context.py``.

Same job as the reference's ExecutionContext
(sdk/python/agentfield/execution_context.py:23-233): a dataclass carrying
run/execution/parent/session/actor identity, serialized to X-* headers on
every outbound call and recovered from headers on every inbound one, with
contextvars giving per-task isolation. The flat parent links are what the
control plane's workflow DAG is reconstructed from.
"""

from __future__ import annotations

import contextvars
import dataclasses
import uuid


def _new(prefix: str) -> str:
    return f"{prefix}_{uuid.uuid4().hex[:20]}"


@dataclasses.dataclass
class ExecutionContext:
    run_id: str
    execution_id: str
    parent_execution_id: str | None = None
    session_id: str | None = None
    actor_id: str | None = None

    @staticmethod
    def new_root(session_id: str | None = None, actor_id: str | None = None) -> "ExecutionContext":
        return ExecutionContext(
            run_id=_new("run"),
            execution_id=_new("exec"),
            session_id=session_id,
            actor_id=actor_id,
        )

    @staticmethod
    def from_headers(headers) -> "ExecutionContext | None":
        h = {k.lower(): v for k, v in headers.items()}
        if "x-execution-id" not in h:
            return None
        return ExecutionContext(
            run_id=h.get("x-run-id") or _new("run"),
            execution_id=h["x-execution-id"],
            parent_execution_id=h.get("x-parent-execution-id") or None,
            session_id=h.get("x-session-id") or None,
            actor_id=h.get("x-actor-id") or None,
        )

    def to_headers(self) -> dict[str, str]:
        out = {"X-Run-ID": self.run_id, "X-Execution-ID": self.execution_id}
        if self.parent_execution_id:
            out["X-Parent-Execution-ID"] = self.parent_execution_id
        if self.session_id:
            out["X-Session-ID"] = self.session_id
        if self.actor_id:
            out["X-Actor-ID"] = self.actor_id
        return out

    def child(self) -> "ExecutionContext":
        """Context for a nested call: same run/session, fresh execution id,
        this execution as parent — the DAG edge."""
        return ExecutionContext(
            run_id=self.run_id,
            execution_id=_new("exec"),
            parent_execution_id=self.execution_id,
            session_id=self.session_id,
            actor_id=self.actor_id,
        )


_current: contextvars.ContextVar[ExecutionContext | None] = contextvars.ContextVar(
    "agentfield_execution_context", default=None
)


def current_context() -> ExecutionContext | None:
    return _current.get()


def set_context(ctx: ExecutionContext | None) -> contextvars.Token:
    return _current.set(ctx)


def reset_context(token: contextvars.Token) -> None:
    _current.reset(token)
