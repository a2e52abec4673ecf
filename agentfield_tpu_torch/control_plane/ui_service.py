"""UI aggregation service layer: per-page server-side summaries. The
port's copy of ``agentfield_tpu/control_plane/ui_service.py``, over the
port's storage and ``cli/packages.py``; the payloads are the JAX module's.

The reference computes page-shaped data on the server (internal/services/
ui_service.go:78-732 node summaries + details, executions_ui_service.go:
112-477 paginated/filtered/grouped executions) so its SPA never fetches raw
lists and re-aggregates client-side — the only approach that survives
10k-execution histories. This module is the TPU build's equivalent: filters,
pagination totals, and group rollups run in SQL (storage.py
count_executions / execution_group_counts), node summaries fold registry +
heartbeat-stat + MCP state once per request, and the zero-build dashboard
(dashboard.py) renders the result as-is.
"""

from __future__ import annotations

import time
from typing import Any

from agentfield_tpu_torch.control_plane.types import ExecutionStatus


def _clamp_page(page: Any, page_size: Any, max_size: int = 200) -> tuple[int, int]:
    try:
        p = max(1, int(page))
    except (TypeError, ValueError):
        p = 1
    try:
        s = min(max(1, int(page_size)), max_size)
    except (TypeError, ValueError):
        s = 25
    return p, s


async def executions_page(
    db,
    *,
    page: Any = 1,
    page_size: Any = 25,
    status: str | None = None,
    target: str | None = None,
    run_id: str | None = None,
    order: str = "desc",
    group_by: str | None = None,
) -> dict[str, Any]:
    """One executions-page payload: the rows for the requested page, the
    exact filtered total (DB COUNT, not len(page)), and optional SQL GROUP BY
    rollups (ref GetExecutionsSummary / GetGroupedExecutions)."""
    page, page_size = _clamp_page(page, page_size)
    st = None
    if status:
        try:
            st = ExecutionStatus(status)
        except ValueError:
            raise ValueError(
                f"unknown status {status!r}; have "
                f"{[s.value for s in ExecutionStatus]}"
            ) from None
    kw = dict(status=st, target=target or None, run_id=run_id or None)
    total = await db.count_executions(**kw)
    rows = await db.list_executions(
        limit=page_size,
        offset=(page - 1) * page_size,
        newest_first=(order != "asc"),
        **kw,
    )
    out: dict[str, Any] = {
        "executions": [_exec_summary(e) for e in rows],
        "total": total,
        "page": page,
        "page_size": page_size,
        "total_pages": max(1, -(-total // page_size)),
        "has_next": page * page_size < total,
        "has_prev": page > 1,
    }
    if group_by:
        out["groups"] = await db.execution_group_counts(group_by, **kw)
    return out


def _exec_summary(e) -> dict[str, Any]:
    """Row shape for the list view: enough to render without the full doc
    (ref convertToUISummary, executions_ui_service.go:284)."""
    d = e.to_dict()
    dur = None
    if d.get("finished_at") and d.get("created_at"):
        dur = round(d["finished_at"] - d["created_at"], 4)
    return {
        "execution_id": d["execution_id"],
        "run_id": d.get("run_id"),
        "parent_execution_id": d.get("parent_execution_id"),
        "target": d.get("target"),
        "status": d.get("status"),
        "created_at": d.get("created_at"),
        "finished_at": d.get("finished_at"),
        "duration_s": dur,
        "error": d.get("error"),
    }


async def node_summaries(cp) -> dict[str, Any]:
    """Per-node rollups for the nodes page: lifecycle + heartbeat age +
    component counts + live engine stats (model nodes push them via enhanced
    heartbeats) + MCP health attribution (ref GetNodesSummary +
    enhanceNodeSummaryWithMCP, ui_service.go:78,501)."""
    nodes = await cp.db.list_nodes()
    mcp = {s["alias"]: s for s in cp.mcp.status()} if cp.mcp else {}
    now = time.time()
    ttl = getattr(getattr(cp, "registry", None), "heartbeat_ttl", 300.0)
    out = []
    for n in nodes:
        stats = n.metadata.get("stats") if isinstance(n.metadata, dict) else None
        age = now - n.last_heartbeat
        # Reconciled status (ref getReconciledNodeStatus, ui_service.go:115):
        # the stored lifecycle status can lag the sweeper; the UI must not
        # paint an active node whose heartbeats died minutes ago as healthy.
        effective = n.status.value
        if effective == "active" and age > ttl:
            effective = "stale"
        summary: dict[str, Any] = {
            "node_id": n.node_id,
            "kind": n.kind,
            "status": n.status.value,
            "effective_status": effective,
            "base_url": n.base_url,
            "did": n.did,
            "reasoners": len(n.reasoners),
            "skills": len(n.skills),
            "registered_at": n.registered_at,
            "last_heartbeat_age_s": round(age, 1),
        }
        if n.kind == "model" and isinstance(stats, dict):
            summary["engine"] = {
                k: stats.get(k)
                for k in (
                    "decode_tokens", "decode_steps", "requests_finished",
                    "active_slots", "free_pages", "backpressure_total",
                    "grammar_bank_rows_used", "grammar_bank_rows",
                )
                if k in stats
            }
        out.append(summary)
    return {
        "nodes": out,
        "total": len(out),
        "active": sum(1 for n in nodes if n.status.value == "active"),
        "mcp_servers": len(mcp),
    }


async def node_details(cp, node_id: str) -> dict[str, Any] | None:
    """Everything the node-detail page needs in one fetch: the node doc,
    per-target SQL metrics for each reasoner/skill, and live stats (ref
    GetNodeDetailsWithMCP, ui_service.go:467)."""
    node = await cp.db.get_node(node_id)
    if node is None:
        return None
    doc = node.to_dict()
    targets = [f"{node_id}.{c.id}" for c in (*node.reasoners, *node.skills)]
    metrics = {}
    for t in targets:
        m = await cp.db.target_metrics(t)
        if m.get("executions"):
            metrics[t] = m
    doc["target_metrics"] = metrics
    doc["last_heartbeat_age_s"] = round(time.time() - node.last_heartbeat, 1)
    # Installed-package attribution (ref GetNodeDetailsWithPackageInfo,
    # ui_service.go:196): if this node came from `af install`, surface the
    # package entry so the detail page links provenance.
    try:
        from agentfield_tpu_torch.cli.packages import load_registry

        reg = load_registry(cp.data_dir)
        if node_id in reg:
            doc["package"] = dict(reg[node_id])
    # afcheck: ignore[except-swallow] package registry is optional context, never a 500
    except Exception:
        pass
    return doc


async def executions_status_bulk(db, ids: list[str]) -> dict[str, Any]:
    """Bulk status refresh (ref executions_ui_service.go RefreshStatuses):
    the SPA refreshes its visible rows in ONE query instead of N detail
    fetches. Unknown ids are reported, not errored — rows may have been
    retention-pruned since render."""
    ids = [str(i) for i in ids]
    overflow = ids[500:]  # bound the IN clause; overflow is REPORTED, not
    # silently dropped (absence must always mean "pruned", never "truncated")
    ids = ids[:500]
    found = await db.get_executions_bulk(ids)
    found_ids = {e.execution_id for e in found}
    return {
        "statuses": {
            e.execution_id: {
                "status": e.status.value,
                "finished_at": e.finished_at,
                "error": e.error,
            }
            for e in found
        },
        "missing": [i for i in ids if i not in found_ids],
        "truncated": overflow,
    }


async def credentials_page(
    db, *, page: Any = 1, page_size: Any = 25, subject_type: str | None = None
) -> dict[str, Any]:
    """Issued-credential explorer (ref CredentialsPage.tsx): persisted VCs,
    newest first, paginated in SQL."""
    page, page_size = _clamp_page(page, page_size)
    total = await db.count_credentials(subject_type=subject_type or None)
    rows = await db.list_credentials(
        subject_type=subject_type or None,
        limit=page_size,
        offset=(page - 1) * page_size,
    )
    return {
        "credentials": rows,
        "total": total,
        "page": page,
        "page_size": page_size,
        "total_pages": max(1, -(-total // page_size)),
    }


def packages_summary(data_dir) -> dict[str, Any]:
    """Installed-package inventory (ref PackagesPage.tsx over the package
    service): the `af install` registry plus each manifest's entrypoint."""
    from agentfield_tpu_torch.cli.packages import load_registry

    reg = load_registry(data_dir)  # flat {name: entry} (packages.py:141)
    pkgs = [dict(entry) for _, entry in sorted(reg.items())]
    return {"packages": pkgs, "total": len(pkgs)}
