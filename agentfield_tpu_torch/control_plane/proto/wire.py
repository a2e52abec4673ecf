"""The protobuf wire format (proto3), written by hand on the standard
library: the port's stand-in for the ``google.protobuf`` runtime, which the
card's machine lacks.

A message class lists its fields (``Field``: name, number, type, and
whether it is repeated or proto3 ``optional``); ``Message`` gives it the
generated classes' surface that the services use: keyword construction,
attribute access, ``SerializeToString``, ``FromString``, ``HasField``,
``MergeFromString``, and repeated fields with ``append``/``extend``/``add``.

Encoding follows protoc's generated code byte for byte:

- fields in field-number order; a singular proto3 field only when it is not
  its type's zero value (for ``float``/``double``: not all-zero bits, so
  ``-0.0`` is written), an ``optional`` one whenever it was set;
- ``int32`` as a varint, a negative one sign-extended to 64 bits (10 bytes);
  ``float`` as fixed32, ``double`` as fixed64; strings, bytes and nested
  messages length-delimited;
- repeated scalars packed (proto3's default); repeated strings, bytes and
  messages one record each.

Decoding accepts a repeated scalar packed or unpacked (proto3 requires
both), merges a repeated singular field as protobuf does (the last scalar
wins, messages merge), and skips unknown fields of every wire type (a known
number on another wire type counts as unknown, as in protobuf; unknown
fields are not kept for re-serialization, which protobuf does). A
``float`` is held as the float32 it travels as: ``temperature=0.7`` reads
back 0.699999988079071, in this package as in protobuf's.
"""

from __future__ import annotations

import operator
import struct
from typing import Any, Callable

VARINT, FIXED64, LEN, SGROUP, EGROUP, FIXED32 = 0, 1, 2, 3, 4, 5

_F32 = struct.Struct("<f")
_F64 = struct.Struct("<d")
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


class DecodeError(ValueError):
    """Bytes that are not a valid encoding of the message."""


def f32(v: float) -> float:
    """``v`` rounded to the float32 it is stored and sent as."""
    return _F32.unpack(_F32.pack(v))[0]


def encode_varint(v: int, out: bytearray) -> None:
    if v < 0:
        v += 1 << 64  # two's complement over 64 bits: 10 bytes
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def decode_varint(buf: bytes | memoryview, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(buf):
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint longer than 10 bytes")


def _to_int32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v & 0x80000000 else v


def _check_int32(v: Any) -> int:
    try:
        v = operator.index(v)  # ints and numpy ints; not floats
    except TypeError:
        raise TypeError(f"{v!r} has type {type(v).__name__}, but expected one of: int") from None
    if not _I32_MIN <= v <= _I32_MAX:
        raise ValueError(f"Value out of range: {v}")
    return v


def _check_float(v: Any) -> float:
    if isinstance(v, bool) or not isinstance(v, (int, float)) and not hasattr(v, "__float__"):
        raise TypeError(f"{v!r} has type {type(v).__name__}, but expected one of: int, float")
    return float(v)


def _check_str(v: Any) -> str:
    if isinstance(v, bytes):
        v = v.decode("utf-8")
    if not isinstance(v, str):
        raise TypeError(f"{v!r} has type {type(v).__name__}, but expected one of: bytes, str")
    return v


def _check_bytes(v: Any) -> bytes:
    if not isinstance(v, (bytes, bytearray, memoryview)):
        raise TypeError(f"{v!r} has type {type(v).__name__}, but expected one of: bytes")
    return bytes(v)


# type name → (wire type, coerce on set, zero value)
_SCALARS: dict[str, tuple[int, Callable[[Any], Any], Any]] = {
    "int32": (VARINT, _check_int32, 0),
    "float": (FIXED32, lambda v: f32(_check_float(v)), 0.0),
    "double": (FIXED64, _check_float, 0.0),
    "string": (LEN, _check_str, ""),
    "bytes": (LEN, _check_bytes, b""),
}
_PACKABLE = ("int32", "float", "double")


class Field:
    """One field of a message: ``kind`` is a scalar type name or a Message
    subclass (a nested message)."""

    __slots__ = ("name", "number", "kind", "repeated", "optional")

    def __init__(self, name: str, number: int, kind: Any, repeated: bool = False,
                 optional: bool = False):
        self.name, self.number, self.kind = name, number, kind
        self.repeated, self.optional = repeated, optional

    @property
    def is_message(self) -> bool:
        return isinstance(self.kind, type) and issubclass(self.kind, Message)


class Repeated(list):
    """A repeated field: a list that checks (and for ``float`` rounds) what
    goes in; ``add(**kw)`` appends a new nested message."""

    def __init__(self, field: Field):
        super().__init__()
        self._field = field

    def _coerce(self, v):
        f = self._field
        if f.is_message:
            if not isinstance(v, f.kind):
                raise TypeError(f"expected {f.kind.__name__}, got {type(v).__name__}")
            return v
        return _SCALARS[f.kind][1](v)

    def append(self, v) -> None:
        super().append(self._coerce(v))

    def extend(self, vs) -> None:
        super().extend(self._coerce(v) for v in vs)

    def add(self, **kw):
        if not self._field.is_message:
            raise AttributeError("add() is for repeated message fields")
        m = self._field.kind(**kw)
        super().append(m)
        return m

    def __setitem__(self, i, v):
        if isinstance(i, slice):
            v = [self._coerce(x) for x in v]
        else:
            v = self._coerce(v)
        super().__setitem__(i, v)


class Message:
    """Base of the hand-written message classes; a subclass sets
    ``FULL_NAME`` and ``FIELDS``."""

    FULL_NAME = ""
    FIELDS: tuple[Field, ...] = ()
    _by_name: dict[str, Field]
    _by_number: dict[int, Field]

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls.FIELDS = tuple(sorted(cls.FIELDS, key=lambda f: f.number))
        cls._by_name = {f.name: f for f in cls.FIELDS}
        cls._by_number = {f.number: f for f in cls.FIELDS}

    def __init__(self, **kw):
        object.__setattr__(self, "_present", set())
        for f in self.FIELDS:
            if f.repeated:
                object.__setattr__(self, f.name, Repeated(f))
            elif f.is_message:
                object.__setattr__(self, f.name, None)
            else:
                object.__setattr__(self, f.name, _SCALARS[f.kind][2])
        for k, v in kw.items():
            f = self._by_name.get(k)
            if f is None:
                raise ValueError(f'Protocol message {type(self).__name__} has no "{k}" field.')
            if f.repeated:
                if v is not None:
                    getattr(self, k).extend(v)
            elif v is not None:
                setattr(self, k, v)

    def __setattr__(self, name: str, value) -> None:
        f = self._by_name.get(name)
        if f is None:
            raise AttributeError(
                f'Protocol message {type(self).__name__} has no "{name}" field.')
        if f.repeated:
            raise AttributeError(
                f"Assignment not allowed to repeated field \"{name}\" in protocol message "
                "object.")
        if f.is_message:
            if not isinstance(value, f.kind):
                raise TypeError(f"expected {f.kind.__name__}, got {type(value).__name__}")
        else:
            value = _SCALARS[f.kind][1](value)
        object.__setattr__(self, name, value)
        self._present.add(name)

    def HasField(self, name: str) -> bool:
        f = self._by_name.get(name)
        if f is None or f.repeated or not (f.optional or f.is_message):
            raise ValueError(f'Protocol message {type(self).__name__} has no non-repeated '
                             f'submessage field "{name}" nor marked as optional')
        return name in self._present

    # -- encoding ------------------------------------------------------

    def SerializeToString(self) -> bytes:
        out = bytearray()
        self._encode(out)
        return bytes(out)

    def _encode(self, out: bytearray) -> None:
        for f in self.FIELDS:
            v = getattr(self, f.name)
            if f.repeated:
                if not v:
                    continue
                if f.is_message or f.kind in ("string", "bytes"):
                    for item in v:
                        _encode_one(f, item, out)
                else:
                    body = bytearray()
                    for item in v:
                        _encode_packed_item(f.kind, item, body)
                    encode_varint(f.number << 3 | LEN, out)
                    encode_varint(len(body), out)
                    out += body
            elif f.is_message:
                if f.name in self._present:
                    _encode_one(f, v, out)
            elif f.optional:
                if f.name in self._present:
                    _encode_one(f, v, out)
            elif not _is_zero(f.kind, v):
                _encode_one(f, v, out)

    # -- decoding ------------------------------------------------------

    @classmethod
    def FromString(cls, data: bytes):
        m = cls()
        m.MergeFromString(data)
        return m

    def MergeFromString(self, data: bytes) -> int:
        buf = memoryview(bytes(data))
        pos, end = 0, len(buf)
        while pos < end:
            key, pos = decode_varint(buf, pos)
            number, wt = key >> 3, key & 7
            if number == 0:
                raise DecodeError("field number 0")
            f = self._by_number.get(number)
            if f is None:
                pos = _skip(buf, pos, wt, number)
                continue
            if f.repeated and f.kind in _PACKABLE and wt == LEN:
                n, pos = decode_varint(buf, pos)
                stop = pos + n
                if stop > end:
                    raise DecodeError("truncated packed field")
                items = getattr(self, f.name)
                while pos < stop:
                    v, pos = _decode_scalar(f.kind, buf, pos)
                    list.append(items, v)
                if pos != stop:
                    raise DecodeError("packed field overruns its length")
                continue
            if wt != (LEN if f.is_message else _SCALARS[f.kind][0]):
                pos = _skip(buf, pos, wt, number)  # protobuf keeps it as an unknown field
                continue
            if f.is_message:
                n, pos = decode_varint(buf, pos)
                if pos + n > end:
                    raise DecodeError("truncated message field")
                chunk = bytes(buf[pos:pos + n])
                pos += n
                if f.repeated:
                    list.append(getattr(self, f.name), f.kind.FromString(chunk))
                else:
                    cur = getattr(self, f.name)
                    if cur is None:
                        cur = f.kind()
                    cur.MergeFromString(chunk)
                    object.__setattr__(self, f.name, cur)
                    self._present.add(f.name)
                continue
            v, pos = _decode_scalar(f.kind, buf, pos)
            if f.repeated:
                list.append(getattr(self, f.name), v)
            else:
                object.__setattr__(self, f.name, v)
                self._present.add(f.name)
        if pos != end:
            raise DecodeError("message overruns its buffer")
        return end

    # -- comparison ----------------------------------------------------

    def __eq__(self, other) -> bool:
        if type(other) is not type(self):
            return NotImplemented
        for f in self.FIELDS:
            a, b = getattr(self, f.name), getattr(other, f.name)
            if f.repeated:
                if list(a) != list(b):
                    return False
            elif a != b:
                return False
            if f.optional and (f.name in self._present) != (f.name in other._present):
                return False
        return True

    __hash__ = None  # mutable, as protobuf's messages are

    def __repr__(self) -> str:
        parts = []
        for f in self.FIELDS:
            v = getattr(self, f.name)
            if (f.repeated and v) or (not f.repeated and (
                    f.name in self._present or (not f.optional and not f.is_message
                                                and not _is_zero(f.kind, v)))):
                parts.append(f"{f.name}={list(v) if f.repeated else v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"


def _is_zero(kind: str, v) -> bool:
    if kind == "float":
        return _F32.pack(v) == b"\0\0\0\0"
    if kind == "double":
        return _F64.pack(v) == b"\0" * 8
    return not v


def _encode_packed_item(kind: str, v, out: bytearray) -> None:
    if kind == "int32":
        encode_varint(v, out)
    elif kind == "float":
        out += _F32.pack(v)
    else:
        out += _F64.pack(v)


def _encode_one(f: Field, v, out: bytearray) -> None:
    if f.is_message:
        body = v.SerializeToString()
        encode_varint(f.number << 3 | LEN, out)
        encode_varint(len(body), out)
        out += body
        return
    wt = _SCALARS[f.kind][0]
    encode_varint(f.number << 3 | wt, out)
    if f.kind == "int32":
        encode_varint(v, out)
    elif f.kind == "float":
        out += _F32.pack(v)
    elif f.kind == "double":
        out += _F64.pack(v)
    else:
        raw = v.encode("utf-8") if f.kind == "string" else v
        encode_varint(len(raw), out)
        out += raw


def _decode_scalar(kind: str, buf: memoryview, pos: int) -> tuple[Any, int]:
    if kind == "int32":
        v, pos = decode_varint(buf, pos)
        return _to_int32(v), pos
    if kind == "float":
        if pos + 4 > len(buf):
            raise DecodeError("truncated fixed32")
        return _F32.unpack_from(buf, pos)[0], pos + 4
    if kind == "double":
        if pos + 8 > len(buf):
            raise DecodeError("truncated fixed64")
        return _F64.unpack_from(buf, pos)[0], pos + 8
    n, pos = decode_varint(buf, pos)
    if pos + n > len(buf):
        raise DecodeError("truncated length-delimited field")
    raw = bytes(buf[pos:pos + n])
    if kind == "string":
        try:
            return raw.decode("utf-8"), pos + n
        except UnicodeDecodeError as e:
            raise DecodeError(f"string field is not UTF-8: {e}") from None
    return raw, pos + n


def _skip(buf: memoryview, pos: int, wt: int, number: int) -> int:
    """Position after an unknown field's value (a group: after its end)."""
    if wt == VARINT:
        return decode_varint(buf, pos)[1]
    if wt == FIXED64:
        pos += 8
    elif wt == FIXED32:
        pos += 4
    elif wt == LEN:
        n, pos = decode_varint(buf, pos)
        pos += n
    elif wt == SGROUP:
        while True:
            key, pos = decode_varint(buf, pos)
            if key & 7 == EGROUP:
                if key >> 3 != number:
                    raise DecodeError("mismatched group end")
                return pos
            pos = _skip(buf, pos, key & 7, key >> 3)
    else:
        raise DecodeError(f"unexpected wire type {wt}")
    if pos > len(buf):
        raise DecodeError("truncated unknown field")
    return pos
