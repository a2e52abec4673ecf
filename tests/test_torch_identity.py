"""The port's identity layer against the JAX one and the 'cryptography'
package, on the CPU.

``agentfield_tpu_torch/control_plane/crypto.py`` (Ed25519, HKDF-SHA256,
AES-256-GCM on the standard library) is held byte for byte against
cryptography (OpenSSL): public keys and signatures of 64 seeded keys and
messages, and the same verdict on malformed signatures (S >= L, a bit
flipped in R, in A or in the message, an A that decodes to no point, a
non-canonical or small-order A, a non-canonical R, the wrong length).
``identity.py`` is held against the JAX ``identity.py``: each package opens
the other's keystore file and both refuse a wrong passphrase, one seed gives
the same DIDs, each package's credentials verify under the other's
``VCService.verify`` with the same reason strings, and with the issuance
clock frozen the credentials and a chain's envelope are equal byte for byte.
The JAX ``tests/test_did_vc.py`` scripts run on the port (its end-to-end one
with the port's ``Agent`` behind the port's control plane)."""

from __future__ import annotations

import base64
import contextlib
import json
import random

import pytest
from cryptography.exceptions import InvalidSignature as CInvalidSignature
from cryptography.hazmat.primitives import hashes
from cryptography.hazmat.primitives.asymmetric.ed25519 import (
    Ed25519PrivateKey as CPrivateKey,
)
from cryptography.hazmat.primitives.asymmetric.ed25519 import (
    Ed25519PublicKey as CPublicKey,
)
from cryptography.hazmat.primitives.ciphers.aead import AESGCM as CAESGCM
from cryptography.hazmat.primitives.kdf.hkdf import HKDF as CHKDF

from agentfield_tpu.control_plane import identity as jid
from agentfield_tpu_torch.control_plane import crypto
from agentfield_tpu_torch.control_plane import identity as tid
from tests.helpers_cp import async_test
from tests.test_torch_cp_server import frozen_issuance_clock

P, L = crypto.P, crypto.L


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (no torch work here, but
    the port's package may load torch: keep ``-n 6`` workers' cores free)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- Ed25519 against OpenSSL --------------------------------------------------


def test_ed25519_keys_and_signatures_equal_cryptography():
    rng = random.Random(23)
    for i in range(64):
        seed = rng.randbytes(32)
        msg = rng.randbytes(rng.choice((0, 1, 31, 64, 200, 1000)))
        ours, theirs = crypto.Ed25519PrivateKey.from_private_bytes(seed), \
            CPrivateKey.from_private_bytes(seed)
        pub = ours.public_key().public_bytes_raw()
        assert pub == theirs.public_key().public_bytes_raw(), i
        sig = ours.sign(msg)
        assert sig == theirs.sign(msg), i
        ours.public_key().verify(sig, msg)
        CPublicKey.from_public_bytes(pub).verify(sig, msg)


def _openssl_accepts(pub: bytes, sig: bytes, msg: bytes) -> bool:
    try:
        CPublicKey.from_public_bytes(pub).verify(sig, msg)
        return True
    except CInvalidSignature:
        return False


def _port_accepts(pub: bytes, sig: bytes, msg: bytes) -> bool:
    try:
        crypto.Ed25519PublicKey.from_public_bytes(pub).verify(sig, msg)
        return True
    except crypto.InvalidSignature:
        return False


def _enc(v: int) -> bytes:
    return v.to_bytes(32, "little")


def _sB(s: int) -> bytes:
    return crypto._encode(crypto._base_mul(s))


def _malformed_cases(kind: str) -> list[tuple[bytes, bytes, bytes]]:
    rng = random.Random(sum(map(ord, kind)))
    key = CPrivateKey.from_private_bytes(rng.randbytes(32))
    pub = key.public_key().public_bytes_raw()
    msg = rng.randbytes(40)
    sig = key.sign(msg)
    s = int.from_bytes(sig[32:], "little")
    flip = lambda b, bit: bytes(x ^ (1 << (bit % 8)) if i == bit // 8 else x
                                for i, x in enumerate(b))
    ident, ident_signed, ident_noncanon = _enc(1), _enc(1 | 1 << 255), _enc(P + 1)
    if kind == "s_at_least_l":
        return [(pub, sig[:32] + _enc(v), msg) for v in (s + L, L, L + 1, 2**256 - 1, 2**253)]
    if kind == "r_bit_flipped":
        return [(pub, flip(sig, b), msg) for b in range(0, 256, 5)]
    if kind == "a_bit_flipped":
        return [(flip(pub, b), sig, msg) for b in range(0, 256, 5)]
    if kind == "message_bit_flipped":
        return [(pub, sig, flip(msg, b)) for b in range(0, 8 * len(msg), 11)]
    if kind == "a_not_on_curve":
        ys = [y for y in range(2, 400) if crypto._recover_x(y, 0) is None][:12]
        return [(_enc(y | sign << 255), sig, msg) for y in ys for sign in (0, 1)]
    if kind == "wrong_length":
        return [(pub, sig[:n], msg) for n in (0, 1, 32, 63)] + [(pub, sig + b"\0", msg)]
    if kind == "small_order_and_noncanonical_a":
        # the identity, x = 0 with the sign bit set, y >= p, the order-4
        # points (y = 0) and -1 (y = p - 1): OpenSSL decodes all of these
        out = [(a, _sB(k) + _enc(k), b"any")
               for a in (ident, ident_signed, ident_noncanon) for k in (0, 1, 99)]
        out += [(_enc(y | sign << 255), _sB(k) + _enc(k), b"q")
                for y in (0, P - 1) for sign in (0, 1) for k in (0, 5)]
        out += [(_enc((y + P) | sign << 255), sig, msg) for y in range(19) for sign in (0, 1)]
        return out
    if kind == "noncanonical_r":
        return [(ident, _enc(P + 1) + _enc(0), b"x"), (ident, _enc(1 | 1 << 255) + _enc(0), b"x"),
                (ident, _enc(1) + _enc(0), b"x")]
    if kind == "random":
        return [(rng.randbytes(32), rng.randbytes(64), rng.randbytes(5)) for _ in range(40)]
    raise KeyError(kind)


MALFORMED = ("s_at_least_l", "r_bit_flipped", "a_bit_flipped", "message_bit_flipped",
             "a_not_on_curve", "wrong_length", "small_order_and_noncanonical_a",
             "noncanonical_r", "random")


@pytest.mark.parametrize("kind", MALFORMED)
def test_ed25519_verdicts_equal_openssl(kind):
    cases = _malformed_cases(kind)
    verdicts = [(_openssl_accepts(*c), _port_accepts(*c)) for c in cases]
    assert [a for a, _ in verdicts] == [b for _, b in verdicts], verdicts
    if kind == "small_order_and_noncanonical_a":
        assert sum(a for a, _ in verdicts) > 10  # OpenSSL's lenient decoding, accepted
    elif kind == "noncanonical_r":
        assert [a for a, _ in verdicts] == [False, False, True]
    else:
        assert not any(a for a, _ in verdicts), kind


def test_ed25519_fixed_base_table_and_variable_base_agree():
    rng = random.Random(5)
    for _ in range(8):
        k = rng.randrange(L)
        assert _sB(k) == crypto._encode(crypto._var_mul(k, crypto._BASE))
    assert _sB(L) == _enc(1) and _sB(0) == _enc(1)


# -- HKDF and AES-GCM -----------------------------------------------------------


def test_hkdf_rfc5869_vectors_and_cryptography():
    # RFC 5869 A.1 and A.3
    okm = crypto.HKDF(length=42, salt=bytes(range(13)), info=bytes(range(0xF0, 0xFA))).derive(
        b"\x0b" * 22)
    assert okm.hex() == ("3cb25f25faacd57a90434f64d0362f2a2d2d0a90cf1a5a4c5db02d56ecc4c5bf"
                         "34007208d5b887185865")
    okm = crypto.HKDF(length=42, salt=None, info=b"").derive(b"\x0b" * 22)
    assert okm.hex() == ("8da4e775a563c18f715f802a063c5a31b8a11f5c5ee1879ec3454e5f3c738d2d"
                         "9d201395faa4b61a96c8")
    rng = random.Random(7)
    for _ in range(40):
        ikm, salt, info = (rng.randbytes(rng.randrange(1, 80)), rng.randbytes(rng.randrange(0, 40)),
                           rng.randbytes(rng.randrange(0, 40)))
        n = rng.randrange(1, 200)
        assert crypto.HKDF(length=n, salt=salt or None, info=info).derive(ikm) == CHKDF(
            algorithm=hashes.SHA256(), length=n, salt=salt or None, info=info).derive(ikm)


def test_aesgcm_equals_cryptography_and_rejects_tampering():
    rng = random.Random(11)
    for i in range(40):
        key, nonce = rng.randbytes(32), rng.randbytes(12)
        data, aad = rng.randbytes(rng.randrange(0, 100)), rng.randbytes(rng.randrange(0, 40))
        ct = crypto.AESGCM(key).encrypt(nonce, data, aad)
        assert ct == CAESGCM(key).encrypt(nonce, data, aad), i
        assert crypto.AESGCM(key).decrypt(nonce, ct, aad) == data
        for bad in (bytes([ct[0] ^ 1]) + ct[1:], ct[:-1] + bytes([ct[-1] ^ 0x80])):
            with pytest.raises(crypto.InvalidTag):
                crypto.AESGCM(key).decrypt(nonce, bad, aad)
        with pytest.raises(crypto.InvalidTag):
            crypto.AESGCM(key).decrypt(nonce, ct, aad + b"x")
    # FIPS-197 C.3: AES-256 on one block
    rk = crypto._expand_key(bytes(range(32)))
    assert crypto._encrypt_block(rk, bytes.fromhex("00112233445566778899aabbccddeeff")).hex() \
        == "8ea2b7ca516745bfeafc49904b496089"


# -- the keystore, DIDs and credentials across the two packages ----------------


def test_keystores_open_across_packages_and_refuse_a_wrong_passphrase(tmp_path):
    seeds = {}
    for maker, opener, tag in ((jid, tid, "jax"), (tid, jid, "port")):
        path = tmp_path / f"{tag}.bin"
        seeds[tag] = maker.Keystore(path, passphrase="pw").load_or_create_seed()
        blob = path.read_bytes()
        assert len(blob) == 12 + 32 + 16 and (path.stat().st_mode & 0o777) == 0o600
        assert opener.Keystore(path, passphrase="pw").load_or_create_seed() == seeds[tag]
        assert path.read_bytes() == blob  # opened, not rewritten
        for mod in (jid, tid):
            with pytest.raises(Exception) as e:
                mod.Keystore(path, passphrase="wrong").load_or_create_seed()
            assert type(e.value).__name__ == "InvalidTag"
    assert seeds["jax"] != seeds["port"]


def test_keystore_env_passphrase_and_dev_default(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("AGENTFIELD_KEYSTORE_PASSPHRASE", "from-env")
    seed = tid.Keystore(tmp_path / "k.bin").load_or_create_seed()
    assert jid.Keystore(tmp_path / "k.bin", passphrase="from-env").load_or_create_seed() == seed
    monkeypatch.delenv("AGENTFIELD_KEYSTORE_PASSPHRASE")
    seed = tid.Keystore(tmp_path / "dev.bin").load_or_create_seed()
    assert "PUBLIC dev passphrase" in capsys.readouterr().err
    assert jid.Keystore(tmp_path / "dev.bin", passphrase="agentfield-dev").load_or_create_seed() \
        == seed


@pytest.mark.parametrize("seed", [bytes(32), b"\x01" * 32, bytes(range(32)), b"\xfe" * 32])
def test_same_seed_same_dids(seed):
    j, t = jid.DIDService(seed), tid.DIDService(seed)
    assert t.org_did == j.org_did
    for node in ("agent-a", "gw-node", "model", "ünïcode/node"):
        assert t.node_did(node) == j.node_did(node)
        for comp in ("generate", "embed", "say_hello"):
            assert t.component_did(node, comp) == j.component_did(node, comp)
    assert t.node_key("agent-a") is t.node_key("agent-a")  # derived once, kept


def test_did_cache_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(tid.DIDService, "KEY_CACHE", 3)
    svc = tid.DIDService(b"\x09" * 32)
    first = svc.node_key("a")
    for n in ("b", "c", "d"):
        svc.node_key(n)
    assert svc.node_key("a") is not first
    assert svc.node_key("a").public_key().public_bytes_raw() == \
        first.public_key().public_bytes_raw()


def _execution(i: int = 0, **over) -> dict:
    doc = {"execution_id": f"exec_{i}", "run_id": "run_1", "target": "agent-a.say_hello",
           "target_type": "reasoner", "status": "completed", "input": {"name": "x", "i": i},
           "result": f"Hello x {i}", "started_at": 1.5e9 + i, "finished_at": 1.5e9 + i + 0.25,
           "parent_execution_id": None if i == 0 else "exec_0"}
    doc.update(over)
    return doc


def test_frozen_clock_credentials_and_chain_equal_byte_for_byte():
    seed = bytes(range(1, 33))
    jv, tv = jid.VCService(jid.DIDService(seed)), tid.VCService(tid.DIDService(seed))
    with frozen_issuance_clock():
        for i in range(4):
            ex = _execution(i)
            assert jid.canonical_json(tv.issue_execution_vc(ex)) == \
                jid.canonical_json(jv.issue_execution_vc(ex))
        exs = [_execution(i) for i in range(5)]
        tc, jc = tv.workflow_chain(exs), jv.workflow_chain(exs)
    assert json.dumps(tc, sort_keys=True) == json.dumps(jc, sort_keys=True)
    assert tc["envelope"]["count"] == 5 and tc["envelope"]["issuer"] == jv.dids.org_did
    assert jv.workflow_chain([])["envelope"]["run_id"] is None
    with frozen_issuance_clock():
        assert tv.workflow_chain([]) == jv.workflow_chain([])


def test_credentials_verify_across_packages_with_the_same_reasons():
    jv, tv = jid.VCService(jid.DIDService(b"\x03" * 32)), tid.VCService(tid.DIDService(b"\x04" * 32))
    attacker = CPrivateKey.from_private_bytes(b"\x07" * 32)
    for issuer in (jv, tv):
        vc = issuer.issue_execution_vc(_execution(1))
        chain = issuer.workflow_chain([_execution(i) for i in range(3)])
        docs = {"vc": vc, "envelope": chain["envelope"], "chained": chain["credentials"][2]}
        tampered = json.loads(json.dumps(vc))
        tampered["credentialSubject"]["result_digest"] = "A" * 43
        docs["tampered"] = tampered
        resigned = json.loads(json.dumps(tampered))
        body = {k: v for k, v in resigned.items() if k != "proof"}
        resigned["proof"]["verificationMethod"] = jid.did_key_from_public(attacker.public_key())
        resigned["proof"]["proofValue"] = base64.urlsafe_b64encode(
            attacker.sign(jid.canonical_json(body))).decode().rstrip("=")
        docs["foreign key"] = resigned
        both = json.loads(json.dumps(resigned))
        both["issuer"] = both["proof"]["verificationMethod"]
        docs["issuer swapped"] = both  # the issuer is signed: the old signature fails
        docs["no proof"] = {k: v for k, v in vc.items() if k != "proof"}
        docs["proof not a dict"] = {**vc, "proof": [1]}
        docs["no issuer"] = {k: v for k, v in vc.items() if k != "issuer"}
        short = base64.urlsafe_b64encode(b"x" * 63).decode()
        docs["short signature"] = {**vc, "proof": {**vc["proof"], "proofValue": short}}
        docs["bad base64"] = {**vc, "proof": {**vc["proof"], "proofValue": "!!"}}
        docs["no proofValue"] = {**vc, "proof": {k: v for k, v in vc["proof"].items()
                                                 if k != "proofValue"}}
        bad_did = "did:key:z" + jid.b58encode(b"\xed\x01" + b"\x01" * 31)
        docs["31-byte key"] = {**vc, "issuer": bad_did,
                               "proof": {**vc["proof"], "verificationMethod": bad_did}}
        docs["did:web"] = {**vc, "issuer": "did:web:x",
                           "proof": {**vc["proof"], "verificationMethod": "did:web:x"}}
        want = {"vc": "ok", "envelope": "ok", "chained": "ok", "tampered": "signature invalid",
                "foreign key": "proof key does not match issuer",
                "issuer swapped": "signature invalid", "bad base64": "signature invalid",
                "no proof": "missing proof", "proof not a dict": "malformed proof",
                "no issuer": "missing issuer", "short signature": "signature invalid"}
        for name, doc in docs.items():
            got_j, got_t = jid.VCService.verify(doc), tid.VCService.verify(doc)
            assert got_t == got_j, (name, got_j, got_t)
            if name in want:
                assert got_t[1] == want[name], (name, got_t)
            else:
                assert got_t[1].startswith("malformed: "), (name, got_t)


# -- the JAX tests/test_did_vc.py scripts on the port -----------------------------


def test_b58_and_did_key_round_trips_as_jax():
    for data in (b"", b"\x00\x00abc", b"hello world", bytes(range(32))):
        assert tid.b58decode(tid.b58encode(data)) == data
        assert tid.b58encode(data) == jid.b58encode(data)
    svc = tid.DIDService(b"\x01" * 32)
    did = svc.node_did("agent-a")
    pub = tid.public_from_did_key(did)
    assert did.startswith("did:key:z") and tid.did_key_from_public(pub) == did
    assert jid.did_key_from_public(jid.public_from_did_key(did)) == did
    for bad in ("did:web:example.com", "did:key:z" + tid.b58encode(b"\x12\x01" + bytes(32))):
        with pytest.raises(ValueError):
            tid.public_from_did_key(bad)


def test_did_determinism_and_separation():
    a, b, other = tid.DIDService(b"\x01" * 32), tid.DIDService(b"\x01" * 32), \
        tid.DIDService(b"\x02" * 32)
    assert a.node_did("x") == b.node_did("x")
    assert a.node_did("x") != a.node_did("y")
    assert a.node_did("x") != other.node_did("x")
    assert a.component_did("x", "r1") != a.node_did("x")


@async_test
async def test_vc_end_to_end_over_the_port_api(tmp_path):
    """The port's ``Agent`` behind the port's control plane on a keystore
    file: DIDs at registration, an execution's credential, the run's chain
    (verified through the API, by the JAX ``VCService`` and by ``aftpu vc
    verify``'s function), 404 on unknown ids; a second control plane on the
    same keystore has the same org DID."""
    import argparse

    from agentfield_tpu_torch.cli.main import cmd_vc_verify
    from agentfield_tpu_torch.control_plane.server import ControlPlane, run_server
    from agentfield_tpu_torch.sdk import Agent
    from tests.helpers_cp import free_port

    ks = str(tmp_path / "keystore.bin")
    port = free_port()
    runner = await run_server(ControlPlane(keystore_path=ks, keystore_passphrase="pw"),
                              "127.0.0.1", port)
    base = f"http://127.0.0.1:{port}"
    a = Agent("vcagent", base)

    @a.reasoner()
    def greet(name: str) -> str:
        return f"hi {name}"

    await a.start()
    try:
        doc = await a.client.get_did("vcagent")
        assert doc["did"] == jid.DIDService(jid.Keystore(ks, "pw").load_or_create_seed()) \
            .node_did("vcagent")
        assert doc["components"]["greet"].startswith("did:key:z")
        org = (await a.client.get_did("org"))["did"]
        ex = await a.client.execute("vcagent.greet", {"name": "v"})
        vc = await a.client.issue_execution_vc(ex["execution_id"])
        assert vc["credentialSubject"]["target"] == "vcagent.greet"
        assert (await a.client.verify_vc(vc))["valid"]
        assert jid.VCService.verify(vc) == (True, "ok")
        path = tmp_path / "vc.json"
        path.write_text(json.dumps({"vc": vc}))
        assert cmd_vc_verify(None, argparse.Namespace(file=str(path))) == 0
        chain = await a.client.workflow_vc_chain(ex["run_id"])
        assert chain["envelope"]["count"] == 1 and chain["envelope"]["issuer"] == org
        assert (await a.client.verify_vc(chain["envelope"]))["valid"]
        assert (await a.client.verify_vc(chain["credentials"][0]))["valid"]
        async with _post(base, "/api/v1/vc/executions/ghost") as st:
            assert st == 404
        async with _get(base, "/api/v1/vc/workflows/ghost") as (st, _):
            assert st == 404
        port2 = free_port()
        again = await run_server(ControlPlane(keystore_path=ks, keystore_passphrase="pw"),
                                 "127.0.0.1", port2)
        try:
            async with _get(f"http://127.0.0.1:{port2}", "/api/v1/did/org") as (st, d):
                assert st == 200 and d["did"] == org
        finally:
            await again.cleanup()
    finally:
        await a.stop()
        await runner.cleanup()


@contextlib.asynccontextmanager
async def _post(base: str, path: str):
    from agentfield_tpu_torch.control_plane import http

    async with http.ClientSession(base_url=base) as s:
        async with s.post(path) as r:
            yield r.status


@contextlib.asynccontextmanager
async def _get(base: str, path: str):
    from agentfield_tpu_torch.control_plane import http

    async with http.ClientSession(base_url=base) as s:
        async with s.get(path) as r:
            yield r.status, await r.json()
