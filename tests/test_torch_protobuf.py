"""The port's hand-written protobuf messages (``control_plane/proto``: the
codec ``wire.py``, ``admin_pb2.py``, ``modelnode_pb2.py``) against protoc's
generated ``agentfield_tpu/control_plane/proto/{admin,modelnode}_pb2.py`` on
the protobuf runtime, on the CPU:

- 200 seeded random messages of each of the eight types, built with the
  same field values on both sides: the port's bytes equal protoc's, and each
  side decodes the other's bytes into the same fields (optional presence
  included);
- repeated scalars sent unpacked (proto3 readers must take both forms)
  decode to what protobuf decodes;
- a negative ``int32`` is a 10-byte varint; a ``float`` rounds through
  float32 (``temperature=0.7`` reads back 0.699999988079071 on both);
- ``HasField``: an unset ``optional`` field is absent and not written, an
  ``optional`` set to its zero value is present and written;
- unknown fields of every wire type, groups included, are skipped;
- truncated bytes raise a decode error on both sides.
"""

from __future__ import annotations

import struct

import numpy as np
import pytest
from google.protobuf.message import DecodeError as PbDecodeError

from agentfield_tpu.control_plane.proto import admin_pb2 as j_admin
from agentfield_tpu.control_plane.proto import modelnode_pb2 as j_model
from agentfield_tpu_torch.control_plane.proto import admin_pb2 as t_admin
from agentfield_tpu_torch.control_plane.proto import modelnode_pb2 as t_model
from agentfield_tpu_torch.control_plane.proto import wire

TYPES = [(j_admin, t_admin, n) for n in ("ListReasonersRequest", "Reasoner",
                                         "ListReasonersResponse", "ListNodesRequest", "Node",
                                         "ListNodesResponse")] + \
        [(j_model, t_model, n) for n in ("GenerateRequest", "GenerateResponse")]
N_MESSAGES = 200


def _rand_str(rng) -> str:
    alphabet = "abcXYZ019 _-./%:é漢ÿ\U0001f600"
    return "".join(rng.choice(list(alphabet), int(rng.integers(0, 12))))


def _rand_scalar(rng, kind: str):
    if kind == "string":
        return _rand_str(rng)
    if kind == "bytes":
        return bytes(rng.integers(0, 256, int(rng.integers(0, 20)), dtype=np.uint8))
    if kind == "int32":
        pick = rng.integers(0, 4)
        return int([0, rng.integers(-(1 << 31), 1 << 31), rng.integers(-300, 300),
                    rng.choice([-(1 << 31), (1 << 31) - 1, -1, 1])][pick])
    if kind == "float":
        return float([0.0, -0.0, float(rng.normal() * 10.0 ** rng.integers(-3, 6)),
                      float("inf"), 0.7][rng.integers(0, 5)])
    return float([0.0, -0.0, float(rng.normal() * 1e9), 1.5e-300][rng.integers(0, 4)])


def _rand_kwargs(rng, t_cls) -> dict:
    kw = {}
    for f in t_cls.FIELDS:
        if f.repeated:
            n = int(rng.integers(0, 5))
            if f.is_message:
                kw[f.name] = [_rand_kwargs(rng, f.kind) for _ in range(n)]
            else:
                kw[f.name] = [_rand_scalar(rng, f.kind) for _ in range(n)]
        elif f.optional:
            if rng.random() < 0.5:
                kw[f.name] = _rand_scalar(rng, f.kind)
        elif rng.random() < 0.8:
            kw[f.name] = _rand_scalar(rng, f.kind)
    return kw


def _build(module, name: str, t_cls, kw: dict):
    """The message ``name`` of ``module`` from kwargs (nested ones built
    through their own classes)."""
    cls = getattr(module, name)
    args = {}
    for f in t_cls.FIELDS:
        if f.name not in kw:
            continue
        v = kw[f.name]
        if f.is_message:
            v = [_build(module, f.kind.__name__, f.kind, x) for x in v]
        args[f.name] = v
    return cls(**args)


def _fields(msg, t_cls) -> dict:
    """Every field's value, optional presence and nested messages included,
    read the same way off either package's message."""
    out = {}
    for f in t_cls.FIELDS:
        v = getattr(msg, f.name)
        if f.repeated:
            v = [_fields(x, f.kind) for x in v] if f.is_message else list(v)
        if f.optional:
            out[f.name + "?"] = msg.HasField(f.name)
        out[f.name] = v
    return out


def _same(a, b) -> bool:
    """Field dicts equal, -0.0 and 0.0 told apart, NaN-free."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float):
        return struct.pack("<d", a) == struct.pack("<d", b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("jmod,tmod,name", TYPES, ids=[t[2] for t in TYPES])
def test_random_messages_byte_equal_both_ways(jmod, tmod, name):
    t_cls = getattr(tmod, name)
    rng = np.random.default_rng(sum(map(ord, name)))
    for i in range(N_MESSAGES):
        kw = _rand_kwargs(rng, t_cls)
        jm = _build(jmod, name, t_cls, kw)
        tm = _build(tmod, name, t_cls, kw)
        jb, tb = jm.SerializeToString(), tm.SerializeToString()
        assert tb == jb, (i, kw)
        j_from_t = getattr(jmod, name).FromString(tb)
        t_from_j = t_cls.FromString(jb)
        assert _same(_fields(t_from_j, t_cls), _fields(jm, t_cls)), (i, kw)
        assert _same(_fields(j_from_t, t_cls), _fields(tm, t_cls)), (i, kw)
        assert t_from_j == tm


def _key(number: int, wt: int) -> bytes:
    out = bytearray()
    wire.encode_varint(number << 3 | wt, out)
    return bytes(out)


def _varint(v: int) -> bytes:
    out = bytearray()
    wire.encode_varint(v, out)
    return bytes(out)


def test_unpacked_repeated_fields_decode_as_protobuf_does():
    tokens = [5, -7, 1 << 30, 0]
    logprobs = [-0.5, 1.25, -3.0]
    resp = b"".join(_key(5, wire.FIXED32) + struct.pack("<f", x) for x in logprobs)
    resp += _key(1, wire.VARINT) + _varint(9) + _key(1, wire.LEN) + _varint(2) + bytes([1, 2])
    j = j_model.GenerateResponse.FromString(resp)
    t = t_model.GenerateResponse.FromString(resp)
    assert list(t.tokens) == list(j.tokens) == [9, 1, 2]  # unpacked then packed, in order
    assert list(t.logprobs) == list(j.logprobs) == logprobs
    only_tokens = b"".join(_key(2, wire.VARINT) + _varint(t) for t in tokens)
    j = j_model.GenerateRequest.FromString(only_tokens)
    t = t_model.GenerateRequest.FromString(only_tokens)
    assert list(t.tokens) == list(j.tokens) == tokens
    # the port re-encodes packed, as protoc does
    assert t.SerializeToString() == j.SerializeToString()


def test_negative_int32_is_ten_bytes():
    for v in (-1, -5, -(1 << 31)):
        t = t_model.GenerateRequest(max_new_tokens=v).SerializeToString()
        j = j_model.GenerateRequest(max_new_tokens=v).SerializeToString()
        assert t == j and len(t) == 1 + 10
        assert t_model.GenerateRequest.FromString(j).max_new_tokens == v
    with pytest.raises(ValueError):
        t_model.GenerateRequest(max_new_tokens=1 << 31)
    with pytest.raises(TypeError):
        t_model.GenerateRequest(max_new_tokens=1.5)


def test_float_rounds_through_f32():
    j = j_model.GenerateRequest(temperature=0.7, top_p=0.9)
    t = t_model.GenerateRequest(temperature=0.7, top_p=0.9)
    assert t.temperature == j.temperature == 0.699999988079071
    assert t.top_p == j.top_p == wire.f32(0.9) != 0.9
    assert t_model.GenerateRequest.FromString(j.SerializeToString()).temperature == j.temperature
    r = t_model.GenerateResponse(logprobs=[0.1, -2.2])
    assert list(r.logprobs) == list(j_model.GenerateResponse(logprobs=[0.1, -2.2]).logprobs)
    n = t_admin.Node(last_heartbeat=1700000000.123456)  # a double keeps its bits
    assert n.last_heartbeat == 1700000000.123456


def test_has_field_presence():
    for mod in (j_model, t_model):
        m = mod.GenerateRequest(tokens=[1])
        assert not m.HasField("top_p") and not m.HasField("temperature")
        assert m.top_p == 0.0
        m.top_p = 0.0  # set to its zero value: present, and written
        assert m.HasField("top_p")
        assert m.SerializeToString() == b"\x12\x01\x01\x35\x00\x00\x00\x00"
        d = mod.GenerateRequest.FromString(m.SerializeToString())
        assert d.HasField("top_p") and not d.HasField("prompt")
        with pytest.raises(ValueError):
            m.HasField("tokens")  # repeated: no presence
    with pytest.raises(ValueError):
        t_model.GenerateResponse().HasField("text")  # proto3 singular: no presence
    t = t_model.GenerateRequest(prompt="")
    assert t.HasField("prompt") and t.SerializeToString() == b"\x0a\x00"


def test_unknown_fields_are_skipped():
    base = j_model.GenerateRequest(prompt="hi", tokens=[1, 2], top_p=0.5).SerializeToString()
    unknown = (_key(100, wire.VARINT) + _varint(12345)
               + _key(101, wire.FIXED64) + b"\x01" * 8
               + _key(102, wire.LEN) + _varint(3) + b"abc"
               + _key(103, wire.FIXED32) + b"\x02" * 4
               + _key(104, wire.SGROUP) + _key(1, wire.VARINT) + _varint(7)
               + _key(104, wire.EGROUP))
    for data in (unknown + base, base + unknown):
        j = j_model.GenerateRequest.FromString(data)
        t = t_model.GenerateRequest.FromString(data)
        assert _same(_fields(t, t_model.GenerateRequest), _fields(j, t_model.GenerateRequest))
        assert t.prompt == "hi" and list(t.tokens) == [1, 2] and t.top_p == 0.5
    # a known number on another wire type is an unknown field too, as in protobuf
    odd = _key(1, wire.VARINT) + _varint(1) + _key(2, wire.FIXED64) + b"\0" * 8
    j = j_model.GenerateRequest.FromString(odd)
    t = t_model.GenerateRequest.FromString(odd)
    assert not j.HasField("prompt") and not t.HasField("prompt")
    assert list(t.tokens) == list(j.tokens) == []


def test_truncated_bytes_raise_on_both():
    full = j_model.GenerateRequest(prompt="hello", tokens=[300, 400],
                                   images=[b"x" * 40]).SerializeToString()
    for cut in (1, 3, len(full) - 1, len(full) - 20):
        with pytest.raises(PbDecodeError):
            j_model.GenerateRequest.FromString(full[:cut])
        with pytest.raises(wire.DecodeError):
            t_model.GenerateRequest.FromString(full[:cut])


def test_repeated_message_add_and_extend():
    for mod in (j_admin, t_admin):
        r = mod.ListReasonersResponse()
        r.reasoners.add(reasoner_id="a", status="active")
        r.reasoners.extend([mod.Reasoner(name="b")])
        assert [x.reasoner_id for x in r.reasoners] == ["a", ""]
    assert (t_admin.ListReasonersResponse(reasoners=[t_admin.Reasoner(name="z")])
            .SerializeToString()
            == j_admin.ListReasonersResponse(reasoners=[j_admin.Reasoner(name="z")])
            .SerializeToString())
    with pytest.raises(AttributeError):
        t_model.GenerateRequest().tokens = [1]  # as protobuf: no assignment to a repeated field
    with pytest.raises(ValueError):
        t_model.GenerateRequest(nope=1)
