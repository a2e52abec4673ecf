"""Control-plane client of the port's model node — counterpart of the node
half of ``agentfield_tpu/sdk/client.py`` (``register_node``, ``heartbeat``,
``deregister_node``, ``post_status``), on ``urllib`` because the card's
machine has no aiohttp. Blocking calls: the node runs them on its heartbeat
and dispatch threads, never on a request the engine waits for.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Any
from urllib.parse import quote

TIMEOUT_S = 30.0  # one control-plane request


class ControlPlaneError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(f"[{status}] {message}")
        self.status = status
        self.message = message


class ControlPlaneClient:
    def __init__(self, base_url: str):
        self.base_url = base_url.rstrip("/")

    def _req(self, method: str, path: str, body: Any = None) -> Any:
        """One request; a status >= 400 raises ControlPlaneError with the
        body's ``error`` (or its first 300 characters); a transport failure
        raises the ``urllib`` error (an ``OSError``)."""
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            self.base_url + path, data=data, method=method,
            headers={"Content-Type": "application/json"} if data is not None else {},
        )
        try:
            with urllib.request.urlopen(req, timeout=TIMEOUT_S) as resp:
                raw = resp.read()
                ctype = resp.headers.get_content_type()
        except urllib.error.HTTPError as e:
            raw = e.read()
            try:
                msg = json.loads(raw).get("error", "")
            except (ValueError, AttributeError):
                msg = raw[:300].decode("utf-8", "replace")
            raise ControlPlaneError(e.code, msg) from None
        if ctype == "application/json":
            return json.loads(raw)
        return raw.decode("utf-8", "replace")

    def register_node(self, spec: dict[str, Any]) -> dict[str, Any]:
        return self._req("POST", "/api/v1/nodes", spec)

    def heartbeat(self, node_id: str, status: str | None = None,
                  stats: dict[str, Any] | None = None) -> dict[str, Any]:
        body: dict[str, Any] = {}
        if status:
            body["status"] = status
        if stats:
            body["stats"] = stats
        return self._req("POST", f"/api/v1/nodes/{quote(node_id)}/heartbeat", body)

    def deregister_node(self, node_id: str) -> None:
        self._req("DELETE", f"/api/v1/nodes/{quote(node_id)}")

    def post_status(self, execution_id: str, status: str, result: Any = None,
                    error: str | None = None) -> None:
        """The execution's completion callback, retried 5 times with backoff
        on a 5xx or a transport failure (a 4xx raises at once)."""
        last: Exception | None = None
        for attempt in range(5):
            try:
                self._req("POST", f"/api/v1/executions/{quote(execution_id)}/status",
                          {"status": status, "result": result, "error": error})
                return
            except ControlPlaneError as e:
                if e.status < 500:
                    raise
                last = e
            except OSError as e:
                last = e
            time.sleep(0.2 * (2**attempt))
        raise last  # type: ignore[misc]
