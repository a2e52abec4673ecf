"""Durable webhook dispatcher.

Same contract as the reference's WebhookDispatcher
(internal/services/webhook_dispatcher.go): deliveries are persisted rows, a
poller picks up due rows, POSTs with an HMAC-SHA256 signature header, and
retries with capped exponential backoff; rows survive restarts because the
queue IS the table (webhook_dispatcher.go:150,212,439,470).
"""

from __future__ import annotations

import asyncio

import hashlib
import hmac
import json
import time
from typing import Any

from agentfield_tpu_torch.control_plane import http

from agentfield_tpu_torch.control_plane.metrics import Metrics
from agentfield_tpu_torch.control_plane.storage import AsyncStorage, SQLiteStorage
from agentfield_tpu_torch.control_plane.types import Execution, new_id

SIGNATURE_HEADER = "X-AgentField-Signature"


def sign_payload(secret: str, body: bytes) -> str:
    return "sha256=" + hmac.new(secret.encode(), body, hashlib.sha256).hexdigest()


class WebhookDispatcher:
    def __init__(
        self,
        storage: SQLiteStorage,
        metrics: Metrics,
        poll_interval: float = 1.0,
        max_attempts: int = 6,
        base_backoff: float = 2.0,
        max_backoff: float = 300.0,
        request_timeout: float = 15.0,
        db=None,  # shared AsyncStorage facade (built if absent)
    ):
        self.storage = storage
        self.db = db if db is not None else AsyncStorage(storage)
        self.metrics = metrics
        self.poll_interval = poll_interval
        self.max_attempts = max_attempts
        self.base_backoff = base_backoff
        self.max_backoff = max_backoff
        self.request_timeout = request_timeout
        self._task: asyncio.Task | None = None
        self._session: http.ClientSession | None = None
        self._wake = asyncio.Event()

    async def start(self) -> None:
        self._session = http.ClientSession(
            timeout=http.ClientTimeout(total=self.request_timeout)
        )
        self._task = asyncio.create_task(self._poll_loop())

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            await asyncio.gather(self._task, return_exceptions=True)
        if self._session:
            await self._session.close()

    async def notify(self, ex: Execution, secret: str | None = None) -> None:
        """Persist a delivery row for a finished execution and wake the poller
        (reference: Notify, webhook_dispatcher.go:150)."""
        if not ex.webhook_url:
            return
        await self.db.webhook_create(
            {
                "id": new_id("wh"),
                "execution_id": ex.execution_id,
                "url": ex.webhook_url,
                "secret": secret,
                "payload": {
                    "execution_id": ex.execution_id,
                    "run_id": ex.run_id,
                    "target": ex.target,
                    "status": ex.status.value,
                    "result": ex.result,
                    "error": ex.error,
                    "finished_at": ex.finished_at,
                },
            }
        )
        self._wake.set()

    def backoff(self, attempts: int) -> float:
        return min(self.base_backoff * (2 ** max(attempts - 1, 0)), self.max_backoff)

    async def _poll_loop(self) -> None:
        while True:
            try:
                self._wake.clear()
                processed = await self.process_due()
                if processed == 0:
                    try:
                        # wait_for, not aio_timeout: the backport cancels
                        # the ENCLOSING task at the deadline, so a stop()
                        # cancel in that window was relabeled TimeoutError
                        # and absorbed — the poller hung its own teardown
                        # (afcheck task-lifecycle; the stop()-hang class)
                        await asyncio.wait_for(
                            self._wake.wait(), self.poll_interval
                        )
                    except asyncio.TimeoutError:
                        pass
            except asyncio.CancelledError:
                raise
            except Exception:
                self.metrics.inc("webhook_poller_errors_total")
                await asyncio.sleep(self.poll_interval)

    async def process_due(self, at: float | None = None, concurrency: int = 16) -> int:
        """Deliver all due rows concurrently (bounded) — one slow endpoint
        must not head-of-line-block healthy ones."""
        due = await self.db.webhook_due(at or time.time())
        sem = asyncio.Semaphore(concurrency)

        async def one(row):
            async with sem:
                await self._deliver(row)

        if due:
            await asyncio.gather(*(one(r) for r in due))
        return len(due)

    async def _deliver(self, row: dict[str, Any]) -> None:
        assert self._session is not None
        body = json.dumps(row["payload"]).encode()
        headers = {"Content-Type": "application/json"}
        if row.get("secret"):
            headers[SIGNATURE_HEADER] = sign_payload(row["secret"], body)
        attempts = row["attempts"] + 1
        try:
            async with self._session.post(row["url"], data=body, headers=headers) as resp:
                if 200 <= resp.status < 300:
                    await self.db.webhook_update(row["id"], "delivered", attempts, 0, None)
                    self.metrics.inc("webhook_delivered_total")
                    return
                err = f"status {resp.status}"
        except (http.ClientError, asyncio.TimeoutError) as e:
            err = repr(e)
        if attempts >= self.max_attempts:
            await self.db.webhook_update(row["id"], "failed", attempts, 0, err)
            self.metrics.inc("webhook_failed_total")
        else:
            await self.db.webhook_update(
                row["id"], "pending", attempts, time.time() + self.backoff(attempts), err
            )
            self.metrics.inc("webhook_retries_total")
