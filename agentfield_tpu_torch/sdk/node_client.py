"""Blocking control-plane client of the port's model node
(``NodeControlPlaneClient``): the node half of ``agentfield_tpu/sdk/client.py``
(``register_node``, ``heartbeat``, ``deregister_node``, ``post_status``)
and the ``execute`` its branch verifier dispatches through the gateway, on
``urllib``. The node is threaded, so these are blocking calls: it runs them
on its heartbeat, dispatch and verifier threads, never on the engine's
drive thread. The SDK's asyncio client, under the JAX name
``ControlPlaneClient``, is ``sdk/client.py``; both raise its
``ControlPlaneError``.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Any
from urllib.parse import quote

from agentfield_tpu_torch.sdk.client import ControlPlaneError

TIMEOUT_S = 30.0  # one control-plane request
EXECUTE_TIMEOUT_S = 600.0  # one execute: the JAX client session's total


class NodeControlPlaneClient:
    def __init__(self, base_url: str):
        self.base_url = base_url.rstrip("/")

    def _req(self, method: str, path: str, body: Any = None,
             timeout: float = TIMEOUT_S) -> Any:
        """One request; a status >= 400 raises ControlPlaneError with the
        body's ``error`` (or its first 300 characters); a transport failure
        raises the ``urllib`` error (an ``OSError``)."""
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            self.base_url + path, data=data, method=method,
            headers={"Content-Type": "application/json"} if data is not None else {},
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
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

    def execute(self, target: str, payload: Any = None,
                timeout: float = EXECUTE_TIMEOUT_S) -> dict[str, Any]:
        """``POST /api/v1/execute/{target}`` with ``{"input": payload}``:
        the execution's document (``status``, ``result``, ``error``) once
        it ends, as the JAX client's ``execute`` gives it."""
        return self._req("POST", f"/api/v1/execute/{target}", {"input": payload},
                         timeout=timeout)

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
