"""The identity layer's primitives on the standard library: Ed25519
(RFC 8032), HKDF-SHA256 (RFC 5869) and AES-256-GCM (NIST SP 800-38D).

The JAX package takes these from the 'cryptography' package
(``agentfield_tpu/control_plane/identity.py``); the port writes them on
``hashlib``, ``hmac`` and Python integers, so the audit layer runs where that
package is not installed. The classes keep cryptography's names and calls
(``Ed25519PrivateKey.from_private_bytes``, ``.sign``, ``.public_key()``,
``Ed25519PublicKey.verify`` raising ``InvalidSignature``, ``AESGCM``,
``HKDF(...).derive``), so ``identity.py`` reads as the JAX module does.

Ed25519 is held to what cryptography (OpenSSL) does, byte for byte:

- signing is deterministic, so a signature equals OpenSSL's;
- verification is OpenSSL's ``ossl_ed25519_verify``: ``S`` must be below the
  group order ``L``; the public key decodes as OpenSSL's
  ``ge_frombytes_vartime`` does (the top bit is the sign of x, a y at or
  above p is taken mod p, an x of 0 with the sign bit set is accepted, a y
  with no x on the curve is rejected); the check is cofactorless,
  ``encode([S]B - [k]A) == R`` byte for byte, so an ``R`` that is not a
  canonical encoding never verifies.

Speed: signing and key derivation are one fixed-base product each, over a
table of ``j * 16**i * B`` (i < 64, j < 16) in affine Niels form, built on
first use: 64 mixed additions and one inversion. A private key caches its
expanded scalar, prefix and public bytes. Verification adds one
variable-base product (4-bit windows: 252 doublings, 63 additions). None of
this is constant-time: the keys are derived from a seed held by the control
plane, and signatures are over credentials the control plane issues.

AES-GCM seals the 32-byte keystore seed only; it is a plain byte-wise AES
and a bit-serial GHASH.
"""

from __future__ import annotations

import hashlib
import hmac

# ===========================================================================
# Ed25519


class InvalidSignature(Exception):
    """The signature does not verify under the public key."""


P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493  # the base point's order
D = -121665 * pow(121666, P - 2, P) % P
D2 = 2 * D % P
SQRT_M1 = pow(2, (P - 1) // 4, P)
_BY = 4 * pow(5, P - 2, P) % P  # the base point's y; its x is even
_Y_MASK = (1 << 255) - 1


def _recover_x(y: int, sign: int) -> int | None:
    """x of the curve point with this y and x's low bit ``sign``, as
    OpenSSL's ``ge_frombytes_vartime`` finds it; None when there is none."""
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    v3 = v * v * v % P
    x = u * v3 * pow(u * v3 * v3 * v % P, (P - 5) // 8, P) % P
    vxx = v * x * x % P
    if vxx != u:
        if vxx != (-u) % P:
            return None
        x = x * SQRT_M1 % P
    if (x & 1) != sign:
        x = (-x) % P
    return x


_BX = _recover_x(_BY, 0)


def _madd(p, q):
    """Extended point ``p`` plus an affine point in Niels form
    ``q = (y + x, y - x, 2d x y)`` (add-2008-hwcd-3, Z2 = 1)."""
    X1, Y1, Z1, T1 = p
    ypx, ymx, xy2d = q
    a = (Y1 - X1) * ymx % P
    b = (Y1 + X1) * ypx % P
    c = T1 * xy2d % P
    d = 2 * Z1
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _cadd(p, q):
    """Extended point ``p`` plus a point in cached form
    ``q = (Y + X, Y - X, 2Z, 2d T)``."""
    X1, Y1, Z1, T1 = p
    ypx, ymx, z2, t2d = q
    a = (Y1 - X1) * ymx % P
    b = (Y1 + X1) * ypx % P
    c = T1 * t2d % P
    d = Z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _double(p):
    """dbl-2008-hwcd for a = -1 (T of the input unused)."""
    X1, Y1, Z1, _ = p
    a = X1 * X1 % P
    b = Y1 * Y1 % P
    c = 2 * Z1 * Z1 % P
    h = a + b
    s = X1 + Y1
    e = h - s * s % P
    g = a - b
    f = c + g
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _cached(p):
    X, Y, Z, T = p
    return ((Y + X) % P, (Y - X) % P, 2 * Z % P, T * D2 % P)


_IDENTITY = (0, 1, 1, 0)
_BASE = (_BX, _BY, 1, _BX * _BY % P)
_TABLE: list | None = None  # [i][j] = j * 16**i * B, Niels form, j in 1..15


def _base_table() -> list:
    """The fixed-base table, built once: 960 points, normalised to affine
    with one batched inversion."""
    global _TABLE
    if _TABLE is not None:
        return _TABLE
    pts = []
    row_base = _BASE
    for _ in range(64):
        row = [row_base]
        cb = _cached(row_base)
        for _ in range(14):
            row.append(_cadd(row[-1], cb))
        pts.append(row)
        nxt = row_base
        for _ in range(4):
            nxt = _double(nxt)
        row_base = nxt
    flat = [q for row in pts for q in row]
    # Montgomery's trick: one pow() for all the Z inverses
    prefix = [1]
    for q in flat:
        prefix.append(prefix[-1] * q[2] % P)
    inv = pow(prefix[-1], P - 2, P)
    invs = [0] * len(flat)
    for k in range(len(flat) - 1, -1, -1):
        invs[k] = inv * prefix[k] % P
        inv = inv * flat[k][2] % P
    table = []
    for i in range(64):
        row = [None]
        for j in range(15):
            X, Y, _, _ = flat[i * 15 + j]
            zi = invs[i * 15 + j]
            x, y = X * zi % P, Y * zi % P
            row.append(((y + x) % P, (y - x) % P, x * y % P * D2 % P))
        table.append(row)
    _TABLE = table
    return table


def _base_mul(k: int):
    """``k * B`` for 0 <= k < 2**256, from the fixed-base table."""
    table = _base_table()
    r = _IDENTITY
    i = 0
    while k:
        digit = k & 15
        if digit:
            r = _madd(r, table[i][digit])
        k >>= 4
        i += 1
    return r


def _var_mul(k: int, p):
    """``k * p`` for a variable point, 4-bit windows from the top."""
    cache = [None, _cached(p)]
    acc = p
    for _ in range(14):
        acc = _cadd(acc, cache[1])
        cache.append(_cached(acc))
    r = _IDENTITY
    for shift in range((max(k.bit_length(), 1) - 1) // 4 * 4, -1, -4):
        r = _double(_double(_double(_double(r))))
        digit = (k >> shift) & 15
        if digit:
            r = _cadd(r, cache[digit])
    return r


def _encode(p) -> bytes:
    X, Y, Z, _ = p
    zi = pow(Z, P - 2, P)
    x, y = X * zi % P, Y * zi % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _decode(s: bytes):
    """OpenSSL's ``ge_frombytes_vartime``: None when no point has this y."""
    v = int.from_bytes(s, "little")
    y = (v & _Y_MASK) % P
    x = _recover_x(y, v >> 255)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def _sha512_int(*parts: bytes) -> int:
    h = hashlib.sha512()
    for part in parts:
        h.update(part)
    return int.from_bytes(h.digest(), "little")


class Ed25519PublicKey:
    __slots__ = ("_raw",)

    def __init__(self, raw: bytes):
        self._raw = bytes(raw)

    @classmethod
    def from_public_bytes(cls, data: bytes) -> "Ed25519PublicKey":
        if len(data) != 32:
            raise ValueError("An Ed25519 public key is 32 bytes long")
        return cls(data)

    def public_bytes_raw(self) -> bytes:
        return self._raw

    def verify(self, signature: bytes, data: bytes) -> None:
        """Raise ``InvalidSignature`` unless ``signature`` is valid for
        ``data`` (OpenSSL's verdict; see the module's docstring)."""
        if len(signature) != 64:
            raise InvalidSignature()
        r_bytes = bytes(signature[:32])
        s = int.from_bytes(signature[32:], "little")
        if s >= L:
            raise InvalidSignature()
        a = _decode(self._raw)
        if a is None:
            raise InvalidSignature()
        k = _sha512_int(r_bytes, self._raw, bytes(data)) % L
        X, Y, Z, T = a
        neg_a = ((-X) % P, Y, Z, (-T) % P)
        r = _cadd(_base_mul(s), _cached(_var_mul(k, neg_a)))
        if not hmac.compare_digest(_encode(r), r_bytes):
            raise InvalidSignature()


class Ed25519PrivateKey:
    """An Ed25519 key from its 32-byte seed. The expanded scalar, the
    prefix and the public key's bytes are computed once, at construction."""

    __slots__ = ("_a", "_prefix", "_pub")

    def __init__(self, seed: bytes):
        h = hashlib.sha512(bytes(seed)).digest()
        a = int.from_bytes(h[:32], "little")
        a &= (1 << 254) - 8
        a |= 1 << 254
        self._a = a
        self._prefix = h[32:]
        self._pub = _encode(_base_mul(a))

    @classmethod
    def from_private_bytes(cls, data: bytes) -> "Ed25519PrivateKey":
        if len(data) != 32:
            raise ValueError("An Ed25519 private key is 32 bytes long")
        return cls(data)

    def public_key(self) -> Ed25519PublicKey:
        return Ed25519PublicKey(self._pub)

    def sign(self, data: bytes) -> bytes:
        data = bytes(data)
        r = _sha512_int(self._prefix, data) % L
        r_bytes = _encode(_base_mul(r))
        k = _sha512_int(r_bytes, self._pub, data) % L
        s = (r + k * self._a) % L
        return r_bytes + s.to_bytes(32, "little")


# ===========================================================================
# HKDF-SHA256 (RFC 5869)


class HKDF:
    """HKDF with SHA-256: ``HKDF(length=, salt=, info=).derive(key_material)``
    (cryptography's call, the algorithm fixed to SHA-256)."""

    def __init__(self, length: int, salt: bytes | None, info: bytes | None):
        if not 0 < length <= 255 * 32:
            raise ValueError(f"cannot derive {length} bytes with HKDF-SHA256")
        self.length = length
        self.salt = salt if salt else b"\x00" * 32
        self.info = info or b""

    def derive(self, key_material: bytes) -> bytes:
        prk = hmac.new(self.salt, key_material, hashlib.sha256).digest()
        out, block, i = b"", b"", 1
        while len(out) < self.length:
            block = hmac.new(prk, block + self.info + bytes([i]), hashlib.sha256).digest()
            out += block
            i += 1
        return out[: self.length]


# ===========================================================================
# AES-256-GCM (FIPS 197, NIST SP 800-38D)


class InvalidTag(Exception):
    """The GCM tag does not match: wrong key, or the data was altered."""


def _xtime(b: int) -> int:
    b <<= 1
    return (b ^ 0x11B) if b & 0x100 else b


def _gmul8(a: int, b: int) -> int:
    r = 0
    while b:
        if b & 1:
            r ^= a
        a = _xtime(a)
        b >>= 1
    return r


def _make_sbox() -> list[int]:
    inv = [0] * 256
    for x in range(1, 256):
        for y in range(1, 256):
            if _gmul8(x, y) == 1:
                inv[x] = y
                break
    sbox = []
    for x in range(256):
        b = inv[x]
        s = b
        for k in range(1, 5):
            s ^= ((b << k) | (b >> (8 - k))) & 0xFF
        sbox.append(s ^ 0x63)
    return sbox


_SBOX: list[int] | None = None


def _sbox() -> list[int]:
    global _SBOX
    if _SBOX is None:
        _SBOX = _make_sbox()
    return _SBOX


def _expand_key(key: bytes) -> list[list[int]]:
    """AES-256's 15 round keys, each 16 bytes."""
    sbox = _sbox()
    words = [list(key[i:i + 4]) for i in range(0, 32, 4)]
    rcon = 1
    for i in range(8, 60):
        t = list(words[i - 1])
        if i % 8 == 0:
            t = [sbox[b] for b in t[1:] + t[:1]]
            t[0] ^= rcon
            rcon = _xtime(rcon)
        elif i % 8 == 4:
            t = [sbox[b] for b in t]
        words.append([a ^ b for a, b in zip(words[i - 8], t)])
    return [sum(words[4 * r:4 * r + 4], []) for r in range(15)]


def _encrypt_block(round_keys: list[list[int]], block: bytes) -> bytes:
    sbox = _sbox()
    s = [b ^ k for b, k in zip(block, round_keys[0])]
    for rnd in range(1, 15):
        s = [sbox[b] for b in s]
        # ShiftRows on the column-major state
        s = [s[(i + 4 * (i % 4)) % 16] for i in range(16)]
        if rnd != 14:
            cols = []
            for c in range(4):
                a0, a1, a2, a3 = s[4 * c:4 * c + 4]
                cols += [
                    _xtime(a0) ^ (_xtime(a1) ^ a1) ^ a2 ^ a3,
                    a0 ^ _xtime(a1) ^ (_xtime(a2) ^ a2) ^ a3,
                    a0 ^ a1 ^ _xtime(a2) ^ (_xtime(a3) ^ a3),
                    (_xtime(a0) ^ a0) ^ a1 ^ a2 ^ _xtime(a3),
                ]
            s = cols
        s = [b ^ k for b, k in zip(s, round_keys[rnd])]
    return bytes(s)


_R = 0xE1 << 120


def _ghash_mul(x: int, h: int) -> int:
    z, v = 0, h
    for i in range(127, -1, -1):
        if (x >> i) & 1:
            z ^= v
        v = (v >> 1) ^ _R if v & 1 else v >> 1
    return z


def _ghash(h: int, aad: bytes, ct: bytes) -> bytes:
    y = 0
    for data in (aad, ct):
        for i in range(0, len(data), 16):
            y = _ghash_mul(y ^ int.from_bytes(data[i:i + 16].ljust(16, b"\0"), "big"), h)
    lens = (len(aad) * 8).to_bytes(8, "big") + (len(ct) * 8).to_bytes(8, "big")
    y = _ghash_mul(y ^ int.from_bytes(lens, "big"), h)
    return y.to_bytes(16, "big")


class AESGCM:
    """AES-256-GCM with a 12-byte nonce and a 16-byte tag appended to the
    ciphertext (cryptography's ``AESGCM`` for a 32-byte key)."""

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("AESGCM here takes a 256-bit key")
        self._rk = _expand_key(bytes(key))
        self._h = int.from_bytes(_encrypt_block(self._rk, b"\0" * 16), "big")

    def _ctr(self, nonce: bytes, data: bytes) -> bytes:
        out = bytearray()
        for n, i in enumerate(range(0, len(data), 16), start=2):
            ks = _encrypt_block(self._rk, nonce + n.to_bytes(4, "big"))
            out += bytes(a ^ b for a, b in zip(data[i:i + 16], ks))
        return bytes(out)

    def _tag(self, nonce: bytes, aad: bytes, ct: bytes) -> bytes:
        s = _ghash(self._h, aad, ct)
        e = _encrypt_block(self._rk, nonce + b"\0\0\0\1")
        return bytes(a ^ b for a, b in zip(s, e))

    def encrypt(self, nonce: bytes, data: bytes, associated_data: bytes | None) -> bytes:
        if len(nonce) != 12:
            raise ValueError("the nonce must be 12 bytes")
        ct = self._ctr(nonce, bytes(data))
        return ct + self._tag(nonce, associated_data or b"", ct)

    def decrypt(self, nonce: bytes, data: bytes, associated_data: bytes | None) -> bytes:
        if len(nonce) != 12:
            raise ValueError("the nonce must be 12 bytes")
        if len(data) < 16:
            raise InvalidTag()
        ct, tag = bytes(data[:-16]), bytes(data[-16:])
        if not hmac.compare_digest(self._tag(nonce, associated_data or b"", ct), tag):
            raise InvalidTag()
        return self._ctr(nonce, ct)
