"""The port's control-plane storage against the JAX package's, on the CPU.

One operation script runs on the JAX ``SQLiteStorage`` and on the port's
(``agentfield_tpu_torch.control_plane.storage``), each on a file of its own:
executions (the write-behind journal on and off), nodes, the memory KV
across scopes, vectors, webhook rows, locks, config, the dead letter,
``target_metrics`` and ``run_summaries``. What each call returns, and every
row of every table afterwards, must be equal; timestamps the storage takes
from the clock itself (webhook ``created_at``, lock expiries) are replaced by
a placeholder first, nothing else. The schema (``sqlite_master``'s SQL) is
the same text; vector top-k gives the same keys in the same order with
scores within 1e-6 on unit-norm embeddings (the JAX store may take its
C++ scan, the port numpy: float32 sums in another order).
The small modules the storage leans on (``dag``, ``payloads``, ``events``,
``metrics``, ``faults``, ``types``) are held against the JAX ones on the
same inputs too.
"""

from __future__ import annotations

import asyncio
import json
import sqlite3

import unittest.mock as mock

import numpy as np
import pytest

from agentfield_tpu.control_plane import dag as jdag
from agentfield_tpu.control_plane import events as jevents
from agentfield_tpu.control_plane import faults as jfaults
from agentfield_tpu.control_plane import metrics as jmetrics
from agentfield_tpu.control_plane import payloads as jpayloads
from agentfield_tpu.control_plane import storage as jstorage
from agentfield_tpu.control_plane import types as jtypes
from agentfield_tpu_torch.control_plane import dag as tdag
from agentfield_tpu_torch.control_plane import events as tevents
from agentfield_tpu_torch.control_plane import faults as tfaults
from agentfield_tpu_torch.control_plane import metrics as tmetrics
from agentfield_tpu_torch.control_plane import payloads as tpayloads
from agentfield_tpu_torch.control_plane import storage as tstorage
from agentfield_tpu_torch.control_plane import types as ttypes

SIDES = {"jax": (jstorage, jtypes, jdag), "torch": (tstorage, ttypes, tdag)}
T0 = 1_700_000_000.0
SCORE_TOL = 1e-6


def _ex(types, i: int, run: str, status: str, parent=None, session=None, **kw):
    return types.Execution(
        execution_id=f"exec_{i}", target=f"node{i % 2}.{'echo' if i % 3 else 'boom'}",
        target_type=types.TargetType.REASONER, status=types.ExecutionStatus(status),
        run_id=run, parent_execution_id=parent, session_id=session, input={"i": i},
        created_at=T0 + i, started_at=T0 + i + 0.25, **kw)


def _node(types, nid: str, status: str = "active"):
    return types.AgentNode.from_dict({
        "node_id": nid, "base_url": f"http://127.0.0.1:90{nid[-1]}", "status": status,
        "kind": "model" if nid.endswith("1") else "agent",
        "reasoners": [{"id": "echo", "node_id": nid, "kind": "reasoner"}],
        "skills": [{"id": "sum", "node_id": nid, "kind": "skill", "description": "adds"}],
        "metadata": {"model": "llama-tiny", "channel": True}, "registered_at": T0,
        "last_heartbeat": T0 + 5})


def storage_script(side: str, path: str, group_commit_ms: float) -> list:
    """The operation script: what every call returned, in order."""
    st_mod, types, dag = SIDES[side]
    st = st_mod.SQLiteStorage(path, group_commit_ms=group_commit_ms)
    out: list = []
    try:
        for nid in ("n0", "n1", "n2"):
            st.upsert_node(_node(types, nid))
        n1 = st.get_node("n1")
        n1.status = types.NodeStatus.INACTIVE
        n1.metadata["stats"] = {"free_pages": 7}
        st.upsert_node(n1)
        out += [st.get_node("n1").to_dict(), [n.to_dict() for n in st.list_nodes()],
                st.delete_node("n2"), st.delete_node("n2"), st.get_node("n2")]
        # executions: two runs, a parent chain, every status
        statuses = ["queued", "running", "completed", "failed", "timeout", "dead_letter",
                    "completed", "completed"]
        for i, status in enumerate(statuses):
            ex = _ex(types, i, "run_a" if i < 5 else "run_b", status,
                     parent=f"exec_{i - 1}" if i in (1, 2, 6) else None,
                     session="s1" if i in (3, 4) else None, priority=i % 3,
                     nodes_tried=["node0"] * (i % 2), attempts=i % 4)
            st.create_execution(ex)
        try:
            st.create_execution(_ex(types, 0, "run_a", "queued"))
            out.append("no duplicate error")
        except Exception as e:  # noqa: BLE001 — the class name is compared
            out.append(["duplicate", st_mod.is_duplicate_key(e)])
        ex = st.get_execution("exec_1")
        ex.status, ex.result, ex.finished_at = types.ExecutionStatus.COMPLETED, {"ok": 1}, T0 + 9
        ex.notes.append({"note": "n", "ts": T0, "actor": None})
        st.update_execution(ex)
        ex = st.get_execution("exec_0")
        ex.status, ex.error, ex.finished_at = types.ExecutionStatus.FAILED, "boom", T0 + 10
        if st.journal is not None:
            st.journal.write_through(ex)
        else:
            st.update_execution(ex)
        st.flush_executions()
        out += [st.get_execution("exec_1").to_dict(), st.get_execution("missing"),
                [e.execution_id for e in st.get_executions_bulk(["exec_3", "exec_1", "nope"])],
                [e.to_dict() for e in st.list_executions(run_id="run_a")],
                [e.execution_id for e in st.list_executions(
                    status=types.ExecutionStatus.DEAD_LETTER)],
                [e.execution_id for e in st.list_executions(limit=3, offset=2)],
                st.count_executions(), st.execution_counts(),
                st.target_metrics("node0.echo"), st.target_metrics("node1.boom"),
                st.run_summaries(limit=5), dag.run_summaries(st, limit=5),
                dag.build_dag(st, "run_a"), dag.build_dag(st, "run_b", lightweight=True),
                dag.build_dag(st, "no_run")]
        # the memory KV across scopes
        for scope, sid in (("global", ""), ("session", "s1"), ("actor", "a1"),
                           ("workflow", "run_a")):
            st.memory_set(scope, sid, "k1", {"v": scope})
            st.memory_set(scope, sid, "k2", [1, 2, scope])
            st.memory_set(scope, sid, "other", None)
        st.memory_set("session", "s1", "k1", "overwritten")
        out += [st.memory_get("session", "s1", "k1"), st.memory_get("global", "", "k1"),
                st.memory_get("session", "s2", "k1"), st.memory_list("actor", "a1", "k"),
                st.memory_list("workflow", "run_a"), st.memory_delete("global", "", "k2"),
                st.memory_delete("global", "", "k2"), st.memory_list("global", "")]
        # vectors
        rng = np.random.default_rng(0)
        for j in range(12):
            st.vector_set("global", "", f"v{j}", rng.standard_normal(16).astype(float).tolist(),
                          {"j": j})
        st.vector_set("session", "s1", "v0", [1.0] * 16, None)
        st.vector_set("global", "", "wrong_dim", [1.0] * 8, None)
        out += [st.vector_delete("global", "", "v11"), st.vector_delete("global", "", "v11")]
        # webhooks
        st.webhook_create({"id": "wh1", "execution_id": "exec_2", "url": "http://x/h",
                           "secret": "s", "payload": {"a": 1}, "next_attempt_at": T0})
        st.webhook_create({"id": "wh2", "execution_id": "exec_3", "url": "http://x/h",
                           "payload": None, "next_attempt_at": T0 + 1e6})
        out.append([{k: v for k, v in r.items() if k != "created_at"}
                    for r in st.webhook_due(T0 + 1)])
        st.webhook_update("wh1", status="failed", attempts=3, next_attempt_at=T0 + 50,
                          last_error="status 500")
        out.append(st.delete_webhooks_before(0.0))
        # locks and config
        out += [st.acquire_lock("l1", "me", ttl=100), st.acquire_lock("l1", "you", ttl=100),
                st.acquire_lock("l1", "me", ttl=100), st.release_lock("l1", "you"),
                st.release_lock("l1", "me"), st.acquire_lock("l1", "you", ttl=100)]
        st.config_set("c1", {"x": [1, 2]})
        st.config_set("c1", {"x": [3]})
        out += [st.config_get("c1"), st.config_get("c2")]
        out.append(st.delete_executions_before(T0 + 1.5))
        out.append(st.journal_stats() is not None)
        st.drain_executions()
    finally:
        st.close()
    return out


def _rows(path: str) -> dict:
    """Every table's rows, sorted, with the clock's own stamps replaced."""
    con = sqlite3.connect(path)
    con.row_factory = sqlite3.Row
    out = {}
    try:
        tables = [r[0] for r in con.execute(
            "SELECT name FROM sqlite_master WHERE type='table' ORDER BY name")]
        for t in tables:
            rows = []
            for r in con.execute(f"SELECT * FROM {t}"):
                d = dict(r)
                for k in ("created_at", "expires_at", "updated_at"):
                    if t in ("webhooks", "locks", "kv_config", "memory", "vectors") and k in d:
                        d[k] = "<clock>"
                rows.append(json.dumps(d, sort_keys=True, default=repr))
            out[t] = sorted(rows)
    finally:
        con.close()
    return out


def _schema(path: str) -> list:
    con = sqlite3.connect(path)
    try:
        return sorted((r[0], r[1], r[2]) for r in con.execute(
            "SELECT type, name, sql FROM sqlite_master WHERE name NOT LIKE 'sqlite_%'"))
    finally:
        con.close()


@pytest.mark.parametrize("group_commit_ms", [0.0, 5.0], ids=["journal_off", "journal_on"])
def test_storage_script_rows_equal(tmp_path, group_commit_ms):
    got = {}
    for side in SIDES:
        path = str(tmp_path / f"{side}.db")
        got[side] = (storage_script(side, path, group_commit_ms), _rows(path))
    (j_out, j_rows), (t_out, t_rows) = got["jax"], got["torch"]
    assert len(j_out) == len(t_out)
    for i, (a, b) in enumerate(zip(j_out, t_out)):
        assert a == b, f"call {i} differs: {a!r} != {b!r}"
    assert j_rows == t_rows


def test_schema_text_equal(tmp_path):
    for side in SIDES:
        SIDES[side][0].SQLiteStorage(str(tmp_path / f"{side}.db")).close()
    assert _schema(str(tmp_path / "jax.db")) == _schema(str(tmp_path / "torch.db"))
    assert jstorage._SCHEMA == tstorage._SCHEMA


@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_vector_topk_equal(metric):
    # unit-norm embeddings, as the node's embed reasoner returns them: a
    # float32 score near 1 has 6e-8 ulps, so 1e-6 is a few of them
    rng = np.random.default_rng(1)
    rows = rng.standard_normal((200, 64)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    queries = rng.standard_normal((6, 64)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    stores = {s: SIDES[s][0].SQLiteStorage(":memory:") for s in SIDES}
    try:
        for st in stores.values():
            for j, r in enumerate(rows):
                st.vector_set("workflow", "w", f"k{j}", r.astype(float).tolist(), {"j": j})
        for q in queries:
            for k in (1, 5, 17):
                a = stores["jax"].vector_search("workflow", "w", q.tolist(), top_k=k, metric=metric)
                b = stores["torch"].vector_search("workflow", "w", q.tolist(), top_k=k,
                                                  metric=metric)
                assert [x["key"] for x in a] == [x["key"] for x in b]
                assert [x["metadata"] for x in a] == [x["metadata"] for x in b]
                np.testing.assert_allclose([x["score"] for x in b], [x["score"] for x in a],
                                           rtol=0, atol=SCORE_TOL)
        for st in stores.values():
            with pytest.raises(ValueError):
                st.vector_search("workflow", "w", queries[0].tolist(), metric="manhattan")
            assert st.vector_search("global", "", queries[0].tolist()) == []
    finally:
        for st in stores.values():
            st.close()


def test_create_storage_sqlite_and_postgres_refused(tmp_path):
    """A SQLite path opens SQLite; a Postgres URL goes to the Postgres
    provider (``storage_pg``), whose connection is refused where no server
    listens (the provider itself: ``tests/test_torch_storage_pg.py``)."""
    from agentfield_tpu_torch.control_plane import storage_pg
    from tests.helpers_cp import free_port

    st = tstorage.create_storage(str(tmp_path / "a.db"), group_commit_ms=0)
    assert isinstance(st, tstorage.SQLiteStorage) and st.journal is None
    st.close()
    port = free_port()
    for url in (f"postgres://u:p@127.0.0.1:{port}/db", f"postgresql://127.0.0.1:{port}/db"):
        with mock.patch.object(storage_pg, "PgConnection",
                               side_effect=ConnectionRefusedError) as pc:
            with pytest.raises(ConnectionRefusedError):
                tstorage.create_storage(url)
        assert pc.call_args.args[0] == url
        with pytest.raises(ConnectionRefusedError):
            tstorage.create_storage(url)


def test_dag_helpers_equal():
    for parent, session in ((None, None), ("exec_1", None), (None, "s"), ("e", "s")):
        assert (tdag.infer_expect_followup(parent, session)
                == jdag.infer_expect_followup(parent, session))
    for sts in (["completed", "failed"], ["running", "completed"], ["completed"] * 3, [],
                ["queued", "dead_letter"], ["timeout"]):
        assert (tdag.aggregate_status([ttypes.ExecutionStatus(s) for s in sts])
                == jdag.aggregate_status([jtypes.ExecutionStatus(s) for s in sts]))


def test_types_round_trip_equal():
    for status in jtypes.NodeStatus:
        for new in jtypes.NodeStatus:
            assert (ttypes.NodeStatus.valid_transition(ttypes.NodeStatus(status.value),
                                                       ttypes.NodeStatus(new.value))
                    == jtypes.NodeStatus.valid_transition(status, new))
    ex = _ex(jtypes, 3, "r", "running", parent="p", session="s", priority=2,
             branch_policy={"type": "best_of_n"}, n_branches=2, trace_id="tr_x")
    d = ex.to_dict()
    assert ttypes.Execution.from_dict(d).to_dict() == d
    node = _node(jtypes, "n1")
    assert ttypes.AgentNode.from_dict(node.to_dict()).to_dict() == node.to_dict()
    assert [s.value for s in ttypes.ExecutionStatus if s.terminal] == [
        s.value for s in jtypes.ExecutionStatus if s.terminal]


def test_payload_store_equal(tmp_path):
    secret = b"k" * 32
    big = {"blob": "x" * 300_000, "n": 1}
    stores = {"jax": jpayloads.PayloadStore(str(tmp_path / "j"), secret=secret),
              "torch": tpayloads.PayloadStore(str(tmp_path / "t"), secret=secret)}
    stubs = {s: st.offload(big) for s, st in stores.items()}
    assert tpayloads.URI_KEY == jpayloads.URI_KEY and tpayloads.SIG_KEY == jpayloads.SIG_KEY
    # content-addressed: the same file name under each store's base
    names = {s: stub[jpayloads.URI_KEY].split(str(tmp_path))[1][2:] for s, stub in stubs.items()}
    assert names["jax"] == names["torch"]
    for s, st in stores.items():
        assert st.is_stub(stubs[s]) and st.resolve(stubs[s]) == big
        assert st.offload({"small": 1}) == {"small": 1} and st.offload(None) is None
        forged = {**stubs[s], jpayloads.SIG_KEY: "0" * 32}
        assert not st.is_stub(forged) and st.resolve(forged) is forged  # passes through
    for s, mod in (("jax", jpayloads), ("torch", tpayloads)):
        import os

        os.unlink(stubs[s][jpayloads.URI_KEY])
        assert stores[s].resolve(stubs[s])["error"].startswith("offloaded payload missing")
        with pytest.raises(mod.PayloadMissingError):
            stores[s].resolve(stubs[s], strict=True)


def test_event_bus_and_metrics_equal():
    async def run(events, metrics):
        m = metrics.Metrics()
        bus = events.EventBus(maxsize=2, metrics=m)
        q = bus.subscribe("executions")
        for i in range(5):
            bus.publish("executions", {"i": i})
        bus.publish("memory", {"x": 1})
        items = [q.get_nowait() for _ in range(q.qsize())]
        m.inc("gateway_executions_total", 3)
        m.set_gauge("queue_depth", 4.0)
        m.observe("gateway_agent_call_seconds", 0.02)
        metrics.export_engine_stats(m, "n1", {"free_pages": 7, "active_slots": 2,
                                              "nested": {"a": 1}, "name": "x"})
        metrics.export_engine_histograms(m, "n1", {"ttft_ms": {
            "buckets": [1.0, 10.0], "counts": [1, 2, 0], "sum": 12.0, "count": 3}})
        return bus.dropped, dict(bus.dropped_by_topic), items, m.render()

    j = asyncio.run(run(jevents, jmetrics))
    t = asyncio.run(run(tevents, tmetrics))
    assert j == t


def test_fault_injector_equal(monkeypatch):
    spec = {"gateway.agent_call.fail": {"p": 0.5, "error": "boom"},
            "channel.drop": {"p": 0.3}}
    j = jfaults.FaultInjector(seed=7, spec=spec)
    t = tfaults.FaultInjector(seed=7, spec=spec)
    for _ in range(40):
        for point in ("gateway.agent_call.fail", "channel.drop", "nope"):
            a, b = j.fire(point), t.fire(point)
            assert (a is None) == (b is None)
            if a is not None:
                assert a.error == b.error and a.delay_s == b.delay_s
    assert j.stats() == t.stats()
    # the same environment names, read once
    monkeypatch.setenv("AGENTFIELD_FAULTS", json.dumps(spec))
    monkeypatch.setenv("AGENTFIELD_FAULTS_SEED", "3")
    monkeypatch.setattr(tfaults, "_env_checked", False)
    monkeypatch.setattr(tfaults, "_active", None)
    inj = tfaults.active()
    try:
        ref = jfaults.FaultInjector(seed=3, spec=spec)
        for _ in range(20):
            a, b = ref.fire("channel.drop"), tfaults.fire("channel.drop")
            assert (a is None) == (b is None)
        assert inj is not None and inj.stats() == ref.stats()
    finally:
        tfaults.install(None)
