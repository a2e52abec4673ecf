"""Postgres storage provider: the port's copy of
``agentfield_tpu/control_plane/storage_pg.py``, over the port's
``SQLiteStorage`` and its own wire client (``pgwire.py``).

Reference analogue: NewPostgresStorage + the StorageFactory seam
(internal/storage/storage.go:264,289) — the multi-instance deployment
path: several control planes sharing one database, with the DB-backed
locks (storage.py `acquire_lock`) arbitrating singleton work.

Implementation: the SQLite provider's query code is dialect-neutral
(ON CONFLICT upserts, indexed-column filters, JSON docs as TEXT), so this
provider reuses ALL of it and swaps the connection for a pooled
:class:`~agentfield_tpu_torch.control_plane.pgwire.PgConnection` (pure-Python
v3 wire client). Only the DDL differs: BLOB → BYTEA, REAL → DOUBLE
PRECISION (float4 would truncate epoch timestamps), and PRAGMAs drop.

Concurrency: calls run through a fixed-size connection pool (the reference
rides pgx v5 pools, go.mod) with NO provider-level lock — each statement
auto-commits on its own connection. `offload_to_thread = True` tells
AsyncStorage to run every call on a worker thread so a stalled server never
stalls the control plane's event loop.

Vector similarity: when the pgvector extension is installed the provider
searches DB-side with the distance operators (reference:
internal/storage/vector_store_postgres.go) — no row fetch-all. Without the
extension it falls back to the SQLite provider's brute-force numpy scan over
fetched rows.
"""

from __future__ import annotations

import json
import re
from typing import Any, Iterable

import numpy as np

from agentfield_tpu_torch.control_plane.pgwire import PgConnection, PgError
from agentfield_tpu_torch.control_plane.storage import _SCHEMA, SQLiteStorage


def _pg_schema() -> str:
    ddl = re.sub(r"\bBLOB\b", "BYTEA", _SCHEMA)
    return re.sub(r"\bREAL\b", "DOUBLE PRECISION", ddl)


class _NullLock:
    """No-op lock: the Postgres provider's concurrency unit is a pooled
    connection per statement, so the SQLite provider's big RLock would only
    serialize what the pool exists to parallelize."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# pgvector distance operator per metric, and how its distance maps onto the
# provider's "higher is better" score contract.
_PGV_OPS = {
    "cosine": ("<=>", lambda d: 1.0 - d),
    "dot": ("<#>", lambda d: -d),  # <#> is NEGATIVE inner product
    "l2": ("<->", lambda d: -d),
}


class PostgresStorage(SQLiteStorage):
    """StorageProvider over a shared PostgreSQL database."""

    offload_to_thread = True  # AsyncStorage: networked calls leave the loop

    def __init__(
        self,
        dsn: str,
        pool_size: int = 4,
        group_commit_ms: float | None = None,
        **connect_kw,
    ):
        # deliberately NOT calling super().__init__ — same attributes, a
        # pooled connection object behind the same execute() surface
        self._conn = PgConnection(dsn, pool_size=pool_size, **connect_kw)
        self._lock = _NullLock()
        self._conn.executescript(_pg_schema())
        # Group-commit journal (storage.py ExecutionJournal): on Postgres the
        # wire client auto-commits per statement, so the journal's win here
        # is write batching OFF the request path (the flush runs on the
        # journal thread), not one shared fsync.
        self._journal = self._make_journal(group_commit_ms)
        self._pgvector = self._detect_pgvector()
        if self._pgvector:
            # untyped vector column: dims vary per row; the dim filter in
            # vector_search keeps operator comparisons well-defined
            self._conn.execute(
                "ALTER TABLE vectors ADD COLUMN IF NOT EXISTS embedding_vec vector"
            )

    def _detect_pgvector(self) -> bool:
        try:
            self._conn.execute("CREATE EXTENSION IF NOT EXISTS vector")
        except PgError:
            pass  # needs superuser; fine if it's already installed
        try:
            return bool(
                self._conn.execute(
                    "SELECT 1 FROM pg_extension WHERE extname='vector'"
                ).fetchall()
            )
        except PgError:
            return False

    # -- vectors (DB-side when pgvector is available) --------------------

    @staticmethod
    def _vec_literal(vec: np.ndarray) -> str:
        return "[" + ",".join(repr(float(x)) for x in vec.tolist()) + "]"

    def vector_set(
        self, scope: str, scope_id: str, key: str, embedding: Iterable[float], metadata: dict | None = None
    ) -> None:
        if not self._pgvector:
            return super().vector_set(scope, scope_id, key, embedding, metadata)
        vec = np.asarray(list(embedding), np.float32)
        self._conn.execute(
            "INSERT INTO vectors(scope,scope_id,key,embedding,dim,metadata,embedding_vec) "
            "VALUES(?,?,?,?,?,?,?::vector) "
            "ON CONFLICT(scope,scope_id,key) DO UPDATE SET embedding=excluded.embedding, "
            "dim=excluded.dim, metadata=excluded.metadata, "
            "embedding_vec=excluded.embedding_vec",
            (
                scope,
                scope_id,
                key,
                vec.tobytes(),
                vec.size,
                json.dumps(metadata or {}),
                self._vec_literal(vec),
            ),
        )

    def vector_search(
        self,
        scope: str,
        scope_id: str,
        query: Iterable[float],
        top_k: int = 5,
        metric: str = "cosine",
    ) -> list[dict[str, Any]]:
        if not self._pgvector:
            return super().vector_search(scope, scope_id, query, top_k=top_k, metric=metric)
        if metric not in _PGV_OPS:
            raise ValueError(f"unknown metric {metric!r}")
        op, to_score = _PGV_OPS[metric]
        q = np.asarray(list(query), np.float32)
        rows = self._conn.execute(
            f"SELECT key, metadata, (embedding_vec {op} ?::vector) AS dist "
            "FROM vectors WHERE scope=? AND scope_id=? AND dim=? "
            "AND embedding_vec IS NOT NULL ORDER BY dist ASC LIMIT ?",
            (self._vec_literal(q), scope, scope_id, q.size, top_k),
        ).fetchall()
        return [
            {
                "key": r["key"],
                "score": float(to_score(float(r["dist"]))),
                "metadata": json.loads(r["metadata"]),
            }
            for r in rows
        ]


__all__ = ["PostgresStorage"]
