"""DID + Verifiable Credential audit layer: the port's copy of
``agentfield_tpu/control_plane/identity.py`` on the port's own primitives
(``crypto.py``: Ed25519, HKDF-SHA256, AES-256-GCM on the standard library)
where the JAX module imports the 'cryptography' package.

Everything a peer can see is the JAX module's: the keystore file (nonce ‖
ciphertext+tag, AAD ``b"master-seed"``, the passphrase through HKDF with the
same salt and info), the HKDF paths from the seed to the org, node and
component keys, the did:key encoding, the credential documents, the
canonical JSON the signatures cover, and ``verify``'s reason strings. So
each package opens the other's keystore, derives the same DIDs from one
seed, and verifies the other's credentials. One addition: ``DIDService``
keeps each derived key (its public bytes computed once), so a registration
or a credential of a node seen before derives nothing again.

Capability parity with the reference's identity stack (DIDService with
Ed25519 + derivation from an org master seed, did:key generation, per-agent
and per-component DIDs — internal/services/did_service.go:515-539; W3C VCs
for executions and workflow chains — internal/services/vc_service.go; AES-GCM
keystore — internal/services/keystore_service.go), re-designed rather than
ported: key derivation is HKDF-SHA256 over stable path labels (instead of
BIP32-style chains) and signatures cover RFC-8785-style canonical JSON.

Design note for the TPU build: the "model" is in-tree, so model nodes get
DIDs like any agent and an ai() call's VC names the model node as subject —
the audit chain stays intact with no external-provider gap (SURVEY §7
"hard parts": keeping the DID/VC chain valid with an in-tree model).
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import Any

from agentfield_tpu_torch.control_plane.crypto import (
    AESGCM,
    HKDF,
    Ed25519PrivateKey,
    Ed25519PublicKey,
    InvalidSignature,
)

_B58_ALPHABET = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"


def b58encode(data: bytes) -> str:
    num = int.from_bytes(data, "big")
    out = ""
    while num:
        num, rem = divmod(num, 58)
        out = _B58_ALPHABET[rem] + out
    pad = 0
    for b in data:
        if b == 0:
            pad += 1
        else:
            break
    return "1" * pad + out


def b58decode(s: str) -> bytes:
    num = 0
    for ch in s:
        num = num * 58 + _B58_ALPHABET.index(ch)
    raw = num.to_bytes((num.bit_length() + 7) // 8, "big")
    pad = len(s) - len(s.lstrip("1"))
    return b"\x00" * pad + raw


def canonical_json(obj: Any) -> bytes:
    """Deterministic serialization the signatures cover (sorted keys, minimal
    separators — JCS-style)."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"), ensure_ascii=False).encode()


def did_key_from_public(pub: Ed25519PublicKey) -> str:
    return "did:key:z" + b58encode(b"\xed\x01" + pub.public_bytes_raw())  # multicodec ed25519-pub


def public_from_did_key(did: str) -> Ed25519PublicKey:
    if not did.startswith("did:key:z"):
        raise ValueError(f"unsupported DID {did!r} (only did:key ed25519)")
    raw = b58decode(did[len("did:key:z") :])
    if raw[:2] != b"\xed\x01":
        raise ValueError("not an ed25519 did:key")
    return Ed25519PublicKey.from_public_bytes(raw[2:])


class Keystore:
    """AES-256-GCM encrypted master-seed storage (reference: keystore_service
    + internal/encryption). The encryption key derives from a passphrase via
    HKDF; the sealed seed lives on disk. A wrong passphrase raises
    ``crypto.InvalidTag``."""

    DEV_PASSPHRASE = "agentfield-dev"  # dev-only; operators MUST configure
    # server.keystore_passphrase (or AGENTFIELD_KEYSTORE_PASSPHRASE) — a
    # publicly known constant protects nothing.

    def __init__(self, path: str | Path, passphrase: str | None = None):
        if passphrase is None:
            passphrase = os.environ.get("AGENTFIELD_KEYSTORE_PASSPHRASE")
        if passphrase is None:
            import sys

            print(
                "[agentfield] WARNING: keystore sealed with the PUBLIC dev "
                "passphrase — set server.keystore_passphrase or "
                "AGENTFIELD_KEYSTORE_PASSPHRASE before trusting any VC",
                file=sys.stderr,
            )
            passphrase = self.DEV_PASSPHRASE
        self.path = Path(os.path.expanduser(str(path)))
        self._key = HKDF(length=32, salt=b"agentfield-keystore", info=b"seal").derive(
            passphrase.encode())

    def load_or_create_seed(self) -> bytes:
        if self.path.exists():
            blob = self.path.read_bytes()
            nonce, ct = blob[:12], blob[12:]
            return AESGCM(self._key).decrypt(nonce, ct, b"master-seed")
        seed = os.urandom(32)
        nonce = os.urandom(12)
        ct = AESGCM(self._key).encrypt(nonce, seed, b"master-seed")
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_bytes(nonce + ct)
        self.path.chmod(0o600)
        return seed


class DIDService:
    """Deterministic DID derivation from the org master seed: every node and
    component gets `HKDF(seed, info=path)` as its Ed25519 private key, so the
    whole identity tree is recoverable from the seed alone. Derived keys are
    kept (the newest ``KEY_CACHE``), each with its public bytes."""

    KEY_CACHE = 4096

    def __init__(self, seed: bytes):
        self._seed = seed
        self._cache: OrderedDict[str, Ed25519PrivateKey] = OrderedDict()
        self._mu = threading.Lock()  # a chain may be signed off the loop
        self.org_key = self._derive("org")
        self.org_did = did_key_from_public(self.org_key.public_key())

    def _derive(self, path: str) -> Ed25519PrivateKey:
        with self._mu:
            key = self._cache.get(path)
            if key is not None:
                self._cache.move_to_end(path)
                return key
        material = HKDF(length=32, salt=b"agentfield-did", info=path.encode()).derive(self._seed)
        key = Ed25519PrivateKey.from_private_bytes(material)
        with self._mu:
            self._cache[path] = key
            while len(self._cache) > self.KEY_CACHE:
                self._cache.popitem(last=False)
        return key

    def node_key(self, node_id: str) -> Ed25519PrivateKey:
        return self._derive(f"node/{node_id}")

    def component_key(self, node_id: str, component_id: str) -> Ed25519PrivateKey:
        return self._derive(f"node/{node_id}/component/{component_id}")

    def node_did(self, node_id: str) -> str:
        return did_key_from_public(self.node_key(node_id).public_key())

    def component_did(self, node_id: str, component_id: str) -> str:
        return did_key_from_public(self.component_key(node_id, component_id).public_key())


class VCService:
    """W3C-shaped Verifiable Credentials over executions, signed Ed25519 with
    detached JWS-style proofs over canonical JSON."""

    def __init__(self, did_service: DIDService):
        self.dids = did_service

    def issue_execution_vc(self, execution: dict[str, Any]) -> dict[str, Any]:
        node_id = execution["target"].split(".", 1)[0]
        issuer_key = self.dids.node_key(node_id)
        issuer_did = self.dids.node_did(node_id)
        vc = {
            "@context": ["https://www.w3.org/2018/credentials/v1"],
            "type": ["VerifiableCredential", "AgentExecutionCredential"],
            "issuer": issuer_did,
            "issuanceDate": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "credentialSubject": {
                "execution_id": execution["execution_id"],
                "run_id": execution["run_id"],
                "parent_execution_id": execution.get("parent_execution_id"),
                "target": execution["target"],
                "target_type": execution["target_type"],
                "status": execution["status"],
                "started_at": execution.get("started_at"),
                "finished_at": execution.get("finished_at"),
                "input_digest": self._digest(execution.get("input")),
                "result_digest": self._digest(execution.get("result")),
            },
        }
        sig = issuer_key.sign(canonical_json(vc))
        vc["proof"] = {
            "type": "Ed25519Signature2020",
            "verificationMethod": issuer_did,
            "created": vc["issuanceDate"],
            "proofValue": base64.urlsafe_b64encode(sig).decode().rstrip("="),
        }
        return vc

    @staticmethod
    def _digest(obj: Any) -> str:
        h = hashlib.sha256(canonical_json(obj)).digest()
        return base64.urlsafe_b64encode(h).decode().rstrip("=")

    @staticmethod
    def verify(vc: dict[str, Any]) -> tuple[bool, str]:
        proof = vc.get("proof")
        if not proof:
            return False, "missing proof"
        if not isinstance(proof, dict):
            return False, "malformed proof"
        # The proof key MUST be the claimed issuer's — otherwise an attacker
        # re-signs a tampered credential with their own key and it "verifies".
        issuer = vc.get("issuer")
        if issuer is None:
            return False, "missing issuer"
        if proof.get("verificationMethod") != issuer:
            return False, "proof key does not match issuer"
        try:
            pub = public_from_did_key(proof["verificationMethod"])
            body = {k: v for k, v in vc.items() if k != "proof"}
            sig = base64.urlsafe_b64decode(proof["proofValue"] + "==")
            pub.verify(sig, canonical_json(body))
            return True, "ok"
        except InvalidSignature:
            return False, "signature invalid"
        except Exception as e:
            return False, f"malformed: {e!r}"

    def workflow_chain(self, executions: list[dict[str, Any]]) -> dict[str, Any]:
        """VC per execution + an org-signed envelope binding the whole run
        (reference: VC chain aggregation, vc_service.go)."""
        vcs = [self.issue_execution_vc(e) for e in executions]
        envelope = {
            "type": "WorkflowCredentialChain",
            "issuer": self.dids.org_did,
            "@context": ["https://www.w3.org/2018/credentials/v1"],
            "run_id": executions[0]["run_id"] if executions else None,
            "count": len(vcs),
            "vc_digests": [self._digest(vc) for vc in vcs],
        }
        sig = self.dids.org_key.sign(canonical_json(envelope))
        envelope["proof"] = {
            "type": "Ed25519Signature2020",
            "verificationMethod": self.dids.org_did,
            "proofValue": base64.urlsafe_b64encode(sig).decode().rstrip("="),
        }
        return {"envelope": envelope, "credentials": vcs}
