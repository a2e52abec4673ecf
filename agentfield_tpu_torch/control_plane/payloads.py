"""Payload store: large inputs/results offloaded to files.

Parity with the reference's FilePayloadStore (internal/services/
payload_store.go: payloads beyond a threshold live under the data dir, the
DB row stores a URI). Keeps the executions table slim when agents exchange
multi-MB blobs; small payloads stay inline.

Security: stubs are HMAC-signed with a server secret, so a client-supplied
``{"__payload_uri__": ...}`` dict is just data — resolve() dereferences
nothing it did not itself create, and only paths under the store's base dir.
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import json
import os
from pathlib import Path
from typing import Any

URI_KEY = "__payload_uri__"
SIG_KEY = "__payload_sig__"


class PayloadMissingError(Exception):
    """A genuine stub whose backing file is gone/corrupt (strict resolution —
    callers that must not misattest content, e.g. VC issuance, use this)."""


class PayloadStore:
    def __init__(
        self,
        base_dir: str | Path,
        inline_threshold: int = 64 * 1024,
        secret: bytes | None = None,
    ):
        self.base = Path(os.path.expanduser(str(base_dir))).resolve()
        self.inline_threshold = inline_threshold
        # Persist-capable deployments derive this from the keystore seed so
        # stubs stay resolvable across restarts; ephemeral default otherwise.
        self._secret = secret or os.urandom(32)

    def _sign(self, path: str) -> str:
        return hmac_mod.new(self._secret, path.encode(), hashlib.sha256).hexdigest()[:32]

    def offload(self, payload: Any) -> Any:
        """Return the payload itself (small) or a signed {URI_KEY, SIG_KEY} stub."""
        if payload is None:
            return None
        blob = json.dumps(payload, default=str).encode()
        if len(blob) <= self.inline_threshold:
            return payload
        digest = hashlib.sha256(blob).hexdigest()[:32]
        path = self.base / digest[:2] / f"{digest}.json"
        if not path.exists():
            path.parent.mkdir(parents=True, exist_ok=True)
            # Unique tmp per writer: concurrent offloads of identical content
            # must not truncate each other's in-flight file mid-rename.
            import threading

            tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            tmp.write_bytes(blob)
            tmp.rename(path)  # atomic publish; content-addressed → idempotent
        return {URI_KEY: str(path), SIG_KEY: self._sign(str(path))}

    def is_stub(self, payload: Any) -> bool:
        return (
            isinstance(payload, dict)
            and set(payload) == {URI_KEY, SIG_KEY}
            and hmac_mod.compare_digest(
                str(payload.get(SIG_KEY, "")), self._sign(str(payload.get(URI_KEY, "")))
            )
        )

    def resolve(self, payload: Any, strict: bool = False) -> Any:
        """Inverse of offload. Only genuine (signed, in-base) stubs are
        dereferenced; anything else — including forged client dicts — passes
        through untouched. A missing/corrupt file surfaces as an explicit
        error value (or PayloadMissingError when ``strict`` — for callers
        like VC issuance that must never attest placeholder content)."""
        if not self.is_stub(payload):
            return payload
        path = Path(payload[URI_KEY])
        try:
            if not path.resolve().is_relative_to(self.base):
                raise OSError("outside store")
            return json.loads(path.read_bytes())
        except (OSError, ValueError):
            if strict:
                raise PayloadMissingError(str(path)) from None
            return {"error": f"offloaded payload missing or corrupt: {path}"}

    def gc(self, referenced: set[str]) -> int:
        """Delete files not in `referenced` (caller derives the set from live
        execution rows)."""
        removed = 0
        if not self.base.exists():
            return 0
        for p in self.base.rglob("*.json"):
            if str(p) not in referenced:
                p.unlink(missing_ok=True)
                removed += 1
        return removed
