"""The port's gRPC transport (``control_plane/grpc_h2.py``, HPACK in
``control_plane/hpack_codec.py``) and its admin service
(``control_plane/admin_grpc.py``), on the CPU, against grpcio:

- HPACK on RFC 7541's examples, written down here from the RFC's text:
  C.1 (integers), C.2 (single fields), C.3 and C.4 (three requests each,
  plain and Huffman-coded, one decoder: the dynamic table carries over),
  C.5 and C.6 (three responses each in a 256-byte table: eviction);
- the Huffman table (Appendix B): a canonical prefix code of 257 symbols
  whose Kraft sum is exactly 1; padding longer than 7 bits, padding that
  is not all ones, and EOS in a string are refused;
- the admin service's interop matrix: the port's server under grpcio's
  client (the JAX package's ``admin_client_call``), the JAX server
  (grpcio, ``start_admin_grpc``) under the port's client, and the port
  against itself, on the same nodes: the three answers are byte-equal;
- on one channel: several calls (grpcio's client indexes every header, so
  its second call refers to the dynamic table), 8 concurrent streams, a
  300 KiB message both ways (flow control: 64 KiB windows, 16 KiB frames),
  every status code with a percent-encoded ``grpc-message``, a deadline
  that cancels the server's handler (RST_STREAM CANCEL), a compressed
  message answered UNIMPLEMENTED, ``grpc-timeout`` into
  ``time_remaining()``;
- ``ControlPlane(admin_grpc_port=)`` serves the admin service from start to
  stop; no thread of the transport is left after a ``stop``.
"""

from __future__ import annotations

import concurrent.futures
import struct
import threading
import time
from concurrent import futures
from fractions import Fraction

import grpc
import numpy as np
import pytest

from agentfield_tpu.control_plane import admin_grpc as j_admin_grpc
from agentfield_tpu.control_plane import storage as j_storage
from agentfield_tpu.control_plane import types as j_types
from agentfield_tpu_torch.control_plane import admin_grpc as t_admin_grpc
from agentfield_tpu_torch.control_plane import grpc_h2 as h2
from agentfield_tpu_torch.control_plane import hpack_codec as hp
from agentfield_tpu_torch.control_plane import storage as t_storage
from agentfield_tpu_torch.control_plane import types as t_types

x = bytes.fromhex

# -- HPACK: RFC 7541 Appendix C ---------------------------------------------

C2 = [  # (hex, headers, table entries after, table size after); fresh decoder each
    ("400a637573746f6d2d6b65790d637573746f6d2d686561646572",
     [("custom-key", "custom-header")], [("custom-key", "custom-header")], 55),
    ("040c2f73616d706c652f70617468", [(":path", "/sample/path")], [], 0),
    ("100870617373776f726406736563726574", [("password", "secret")], [], 0),
    ("82", [(":method", "GET")], [], 0),
]
REQ1 = [(":method", "GET"), (":scheme", "http"), (":path", "/"),
        (":authority", "www.example.com")]
REQ2 = REQ1 + [("cache-control", "no-cache")]
REQ3 = [(":method", "GET"), (":scheme", "https"), (":path", "/index.html"),
        (":authority", "www.example.com"), ("custom-key", "custom-value")]
T1 = [(":authority", "www.example.com")]
T2 = [("cache-control", "no-cache")] + T1
T3 = [("custom-key", "custom-value")] + T2
C3 = [("828684410f7777772e6578616d706c652e636f6d", REQ1, T1, 57),
      ("828684be58086e6f2d6361636865", REQ2, T2, 110),
      ("828785bf400a637573746f6d2d6b65790c637573746f6d2d76616c7565", REQ3, T3, 164)]
C4 = [("828684418cf1e3c2e5f23a6ba0ab90f4ff", REQ1, T1, 57),
      ("828684be5886a8eb10649cbf", REQ2, T2, 110),
      ("828785bf408825a849e95ba97d7f8925a849e95bb8e8b4bf", REQ3, T3, 164)]
DATE1, DATE2 = "Mon, 21 Oct 2013 20:13:21 GMT", "Mon, 21 Oct 2013 20:13:22 GMT"
LOC = "https://www.example.com"
COOKIE = "foo=ASDJKHQKBZXOQWEOPIUAXQWEOIU; max-age=3600; version=1"
RESP1 = [(":status", "302"), ("cache-control", "private"), ("date", DATE1), ("location", LOC)]
RESP2 = [(":status", "307"), ("cache-control", "private"), ("date", DATE1), ("location", LOC)]
RESP3 = [(":status", "200"), ("cache-control", "private"), ("date", DATE2), ("location", LOC),
         ("content-encoding", "gzip"), ("set-cookie", COOKIE)]
RT1 = [("location", LOC), ("date", DATE1), ("cache-control", "private"), (":status", "302")]
RT2 = [(":status", "307"), ("location", LOC), ("date", DATE1), ("cache-control", "private")]
RT3 = [("set-cookie", COOKIE), ("content-encoding", "gzip"), ("date", DATE2)]
C5 = [("4803 3330 3258 0770 7269 7661 7465 611d 4d6f 6e2c 2032 3120 4f63 7420 3230 3133 "
       "2032 303a 3133 3a32 3120 474d 546e 1768 7474 7073 3a2f 2f77 7777 2e65 7861 6d70 "
       "6c65 2e63 6f6d", RESP1, RT1, 222),
      ("4803 3330 37c1 c0bf", RESP2, RT2, 222),
      ("88c1 611d 4d6f 6e2c 2032 3120 4f63 7420 3230 3133 2032 303a 3133 3a32 3220 474d "
       "54c0 5a04 677a 6970 7738 666f 6f3d 4153 444a 4b48 514b 425a 584f 5157 454f 5049 "
       "5541 5851 5745 4f49 553b 206d 6178 2d61 6765 3d33 3630 303b 2076 6572 7369 6f6e "
       "3d31", RESP3, RT3, 215)]
C6 = [("4882 6402 5885 aec3 771a 4b61 96d0 7abe 9410 54d4 44a8 2005 9504 0b81 66e0 82a6 "
       "2d1b ff6e 919d 29ad 1718 63c7 8f0b 97c8 e9ae 82ae 43d3", RESP1, RT1, 222),
      ("4883 640e ffc1 c0bf", RESP2, RT2, 222),
      ("88c1 6196 d07a be94 1054 d444 a820 0595 040b 8166 e084 a62d 1bff c05a 839b d9ab "
       "77ad 94e7 821d d7f2 e6c7 b335 dfdf cd5b 3960 d5af 2708 7f36 72c1 ab27 0fb5 291f "
       "9587 3160 65c0 03ed 4ee5 b106 3d50 07", RESP3, RT3, 215)]


def _huffman_encode(data: bytes) -> bytes:
    """Appendix B's coding, padded with EOS's leading ones (the port's
    encoder sends plain strings; this feeds its decoder)."""
    acc = nbits = 0
    out = bytearray()
    for b in data:
        code, n = hp.HUFFMAN_CODES[b]
        acc, nbits = acc << n | code, nbits + n
        while nbits >= 8:
            nbits -= 8
            out.append(acc >> nbits & 0xFF)
        acc &= (1 << nbits) - 1
    if nbits:
        out.append((acc << (8 - nbits) | (1 << (8 - nbits)) - 1) & 0xFF)
    return bytes(out)


def _table(d: hp.Decoder) -> list[tuple[str, str]]:
    return [(n.decode(), v.decode()) for n, v in d.table]


def test_hpack_integers_c1():
    assert hp.encode_integer(10, 5) == x("0a")
    assert hp.encode_integer(1337, 5) == x("1f9a0a")
    assert hp.encode_integer(42, 8) == x("2a")
    for raw, bits, v in ((x("0a"), 5, 10), (x("1f9a0a"), 5, 1337), (x("2a"), 8, 42)):
        assert hp.decode_integer(raw, 0, bits) == (v, len(raw))


@pytest.mark.parametrize("i", range(len(C2)))
def test_hpack_single_fields_c2(i):
    raw, headers, table, size = C2[i]
    d = hp.Decoder()
    assert d.decode(x(raw)) == headers
    assert _table(d) == table and d.size == size


@pytest.mark.parametrize("vectors,max_size", [(C3, 4096), (C4, 4096), (C5, 256), (C6, 256)],
                         ids=["C.3", "C.4", "C.5", "C.6"])
def test_hpack_sequences(vectors, max_size):
    d = hp.Decoder()
    d.max_size = max_size  # the RFC's examples run with a 256-byte table
    for raw, headers, table, size in vectors:
        assert d.decode(x(raw)) == headers
        assert _table(d) == table and d.size == size


def test_huffman_table_is_a_complete_canonical_code():
    codes = hp.HUFFMAN_CODES
    assert len(codes) == 257 and codes[hp.EOS] == (0x3FFFFFFF, 30)
    assert sum(Fraction(1, 1 << n) for _, n in codes) == 1  # Kraft: complete, no gap
    order = sorted(range(257), key=lambda s: (codes[s][1], s))
    code, prev = 0, codes[order[0]][1]
    for s in order:  # canonical: each code the previous one plus one, shifted
        code <<= codes[s][1] - prev
        prev = codes[s][1]
        assert codes[s][0] == code, s
        code += 1
    assert codes[ord("a")] == (0x3, 5) and codes[ord("0")] == (0x0, 5)


def test_huffman_round_trip_and_refusals():
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 64, 300):
        raw = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        assert hp.huffman_decode(_huffman_encode(raw)) == raw
    assert _huffman_encode(b"www.example.com") == x("f1e3c2e5f23a6ba0ab90f4ff")
    a = _huffman_encode(b"a")  # 00011 + 111 padding
    assert a == bytes([0b00011111])
    with pytest.raises(hp.HPACKError, match="longer than 7"):
        hp.huffman_decode(a + b"\xff")
    with pytest.raises(hp.HPACKError, match="EOS"):
        hp.huffman_decode(bytes([0b00011110]))  # padding not all ones
    with pytest.raises(hp.HPACKError, match="EOS"):
        hp.huffman_decode(b"\xff\xff\xff\xfc")  # the 30-bit EOS itself


def test_hpack_table_size_updates_and_encoder_round_trip():
    d = hp.Decoder(max_allowed=4096)
    d.decode(x(C3[0][0]))
    assert d.size == 57
    assert d.decode(hp.encode_integer(0, 5, 0x20)) == [] and d.size == 0 and not d.table
    d.decode(hp.encode_integer(4096, 5, 0x20))
    with pytest.raises(hp.HPACKError, match="over the allowed"):
        d.decode(hp.encode_integer(8192, 5, 0x20))
    with pytest.raises(hp.HPACKError, match="after a header field"):
        d.decode(x("82") + hp.encode_integer(0, 5, 0x20))
    with pytest.raises(hp.HPACKError, match="index"):
        hp.Decoder().decode(x("80"))
    headers = [(":status", "200"), ("content-type", "application/grpc"), ("grpc-status", "13"),
               ("grpc-message", "x%20y"), ("x-custom", "v" * 200)]
    assert hp.Decoder().decode(hp.encode_headers(headers)) == headers


def test_timeout_and_message_codings():
    assert h2.parse_timeout("1500m") == 1.5 and h2.parse_timeout("2S") == 2.0
    assert h2.parse_timeout("1H") == 3600.0 and h2.parse_timeout("250u") == 250e-6
    for bad in ("", "1x", "123456789S", "-1S"):
        with pytest.raises(ValueError):
            h2.parse_timeout(bad)
    for s in (0.001, 1.5, 600.0, 1e-7, 1e6):
        v = h2.format_timeout(s)
        assert h2.parse_timeout(v) >= s and len(v) <= 9
    msg = "bad ünï\tcode 100% done\r\n"
    enc = h2.percent_encode(msg)
    assert enc.isascii() and "%25" in enc and "%C3%BC" in enc
    assert h2.percent_decode(enc) == msg
    assert h2.percent_decode("50%") == "50%"  # a lone % stays


# -- a test service -----------------------------------------------------------

CODES = [c for c in h2.StatusCode if c is not h2.StatusCode.OK]
DETAILS = "naïve % details — line\nend"


class PortService:
    """Echo, Sleep (until cancelled), Fail/<CODE>, Deadline (time_remaining)."""

    def __init__(self):
        self.cancelled = threading.Event()

    def service(self, d):
        m = d.method
        if m == "/t.S/Echo":
            return h2.unary_unary_rpc_method_handler(lambda r, c: r[::-1])
        if m == "/t.S/Sleep":
            def sleep(r, c):
                c.add_callback(self.cancelled.set)
                time.sleep(float(r.decode() or "0.2"))
                return b"slept"
            return h2.unary_unary_rpc_method_handler(sleep)
        if m == "/t.S/Hang":
            def hang(r, c):
                ev = threading.Event()
                c.add_callback(ev.set)
                ev.wait(10)
                self.cancelled.set()
                return b"late"
            return h2.unary_unary_rpc_method_handler(hang)
        if m == "/t.S/Deadline":
            return h2.unary_unary_rpc_method_handler(
                lambda r, c: repr(c.time_remaining()).encode())
        if m.startswith("/t.S/Fail/"):
            code = h2.StatusCode[m.rsplit("/", 1)[1]]
            return h2.unary_unary_rpc_method_handler(lambda r, c: c.abort(code, DETAILS))
        return None


class GrpcioService(grpc.GenericRpcHandler):
    def service(self, d):
        m = d.method
        if m == "/t.S/Echo":
            return grpc.unary_unary_rpc_method_handler(lambda r, c: r[::-1])
        if m == "/t.S/Sleep":
            def sleep(r, c):
                time.sleep(float(r.decode() or "0.2"))
                return b"slept"
            return grpc.unary_unary_rpc_method_handler(sleep)
        if m.startswith("/t.S/Fail/"):
            code = grpc.StatusCode[m.rsplit("/", 1)[1]]
            return grpc.unary_unary_rpc_method_handler(lambda r, c: c.abort(code, DETAILS))
        return None


def _transport_threads() -> list[threading.Thread]:
    return [t for t in threading.enumerate() if t.name.startswith("grpc-h2")]


@pytest.fixture()
def port_server():
    svc = PortService()
    srv = h2.server(max_workers=8)
    srv.add_generic_rpc_handlers((svc,))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    yield port, svc
    srv.stop(0)
    assert _transport_threads() == [], _transport_threads()


@pytest.fixture()
def grpcio_server():
    srv = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
    srv.add_generic_rpc_handlers((GrpcioService(),))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    yield port
    srv.stop(0).wait()


BIG = bytes(np.random.default_rng(3).integers(0, 256, 300 * 1024, dtype=np.uint8))


def test_port_client_on_port_server(port_server):
    port, _ = port_server
    sent: list[tuple[int, int]] = []
    orig = h2._Connection._send

    def spy(self, data):  # the frames the client writes: (type, length)
        if self.client:
            off = 0
            while off + 9 <= len(data):
                n = int.from_bytes(data[off:off + 3], "big")
                sent.append((data[off + 3], n))
                off += 9 + n
        return orig(self, data)

    with h2.insecure_channel(f"127.0.0.1:{port}") as ch:
        echo = ch.unary_unary("/t.S/Echo")
        for i in range(5):
            assert echo(b"abc%d" % i, timeout=5) == (b"abc%d" % i)[::-1]
        h2._Connection._send = spy
        try:
            assert echo(BIG, timeout=10) == BIG[::-1]
        finally:
            h2._Connection._send = orig
        data = [n for t, n in sent if t == h2.DATA]
        assert sum(data) == len(BIG) + 5 and max(data) <= h2.DEFAULT_MAX_FRAME
        assert len(data) > 65535 // h2.DEFAULT_MAX_FRAME  # it waited on WINDOW_UPDATEs
        conns = {id(ch._conn)}
        for code in CODES:
            with pytest.raises(h2.RpcError) as e:
                ch.unary_unary(f"/t.S/Fail/{code.name}")(b"", timeout=5)
            assert e.value.code() is code and e.value.details() == DETAILS
        with pytest.raises(h2.RpcError) as e:
            ch.unary_unary("/t.S/Nope")(b"", timeout=5)
        assert e.value.code() is h2.StatusCode.UNIMPLEMENTED
        assert {id(ch._conn)} == conns  # one connection all along


def test_grpcio_client_on_port_server(port_server):
    port, _ = port_server
    with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
        echo = ch.unary_unary("/t.S/Echo")
        for i in range(5):  # the second call on refers to grpcio's dynamic table
            assert echo(b"hello%d" % i, timeout=5) == (b"hello%d" % i)[::-1]
        assert echo(BIG, timeout=10) == BIG[::-1]
        for code in CODES:
            with pytest.raises(grpc.RpcError) as e:
                ch.unary_unary(f"/t.S/Fail/{code.name}")(b"", timeout=5)
            assert e.value.code().name == code.name and e.value.details() == DETAILS
        with pytest.raises(grpc.RpcError) as e:
            ch.unary_unary("/t.S/Nope")(b"", timeout=5)
        assert e.value.code() == grpc.StatusCode.UNIMPLEMENTED
        # grpc-timeout into time_remaining(): grpcio sends e.g. "1998m"
        left = float(ch.unary_unary("/t.S/Deadline")(b"", timeout=2.0))
        assert 0.5 < left <= 2.1  # grpcio rounds its grpc-timeout up
        assert ch.unary_unary("/t.S/Deadline")(b"", timeout=None) == b"None"


def test_port_client_on_grpcio_server(grpcio_server):
    port = grpcio_server
    with h2.insecure_channel(f"127.0.0.1:{port}") as ch:
        echo = ch.unary_unary("/t.S/Echo")
        for i in range(5):  # grpcio's answers index their headers: the table again
            assert echo(b"hi%d" % i, timeout=5) == (b"hi%d" % i)[::-1]
        assert echo(BIG, timeout=10) == BIG[::-1]  # its 64 KiB window: WINDOW_UPDATEs
        for code in CODES:
            with pytest.raises(h2.RpcError) as e:
                ch.unary_unary(f"/t.S/Fail/{code.name}")(b"", timeout=5)
            assert e.value.code() is code and e.value.details() == DETAILS
        with pytest.raises(h2.RpcError) as e:
            ch.unary_unary("/t.S/Nope")(b"", timeout=5)
        assert e.value.code() is h2.StatusCode.UNIMPLEMENTED
        with pytest.raises(h2.RpcError) as e:
            ch.unary_unary("/t.S/Sleep")(b"1.0", timeout=0.1)
        assert e.value.code() is h2.StatusCode.DEADLINE_EXCEEDED
        assert echo(b"after", timeout=5) == b"retfa"


@pytest.mark.parametrize("client", ["port", "grpcio"])
def test_eight_concurrent_streams(port_server, client):
    port, _ = port_server
    n, nap = 8, 0.3
    if client == "port":
        ch = h2.insecure_channel(f"127.0.0.1:{port}")
        call = ch.unary_unary("/t.S/Sleep")
    else:
        ch = grpc.insecure_channel(f"127.0.0.1:{port}")
        call = ch.unary_unary("/t.S/Sleep")
    try:
        with concurrent.futures.ThreadPoolExecutor(n) as pool:
            t0 = time.perf_counter()
            outs = list(pool.map(lambda _: call(str(nap).encode(), timeout=10), range(n)))
            wall = time.perf_counter() - t0
        assert outs == [b"slept"] * n
        assert wall < n * nap / 2, wall  # they overlapped on the one connection
    finally:
        ch.close()


@pytest.mark.parametrize("client", ["port", "grpcio"])
def test_deadline_cancels_the_handler(port_server, client):
    port, svc = port_server
    ch = (h2 if client == "port" else grpc).insecure_channel(f"127.0.0.1:{port}")
    try:
        t0 = time.perf_counter()
        with pytest.raises((h2.RpcError, grpc.RpcError)) as e:
            ch.unary_unary("/t.S/Hang")(b"", timeout=0.2)
        assert e.value.code().name == "DEADLINE_EXCEEDED"
        assert time.perf_counter() - t0 < 2.0
        assert svc.cancelled.wait(5), "RST_STREAM CANCEL did not reach the handler"
    finally:
        ch.close()


def test_compressed_message_is_unimplemented(port_server):
    port, _ = port_server
    ch = h2.insecure_channel(f"127.0.0.1:{port}")
    try:
        conn = ch._connection()
        st = conn.open_stream([(":method", "POST"), (":scheme", "http"),
                               (":path", "/t.S/Echo"), (":authority", "x"), ("te", "trailers"),
                               ("content-type", "application/grpc"),
                               ("grpc-encoding", "gzip")], None)
        conn.send_data(st, b"\x01" + struct.pack(">I", 3) + b"abc", end_stream=True)
        assert st.done.wait(5)
        with pytest.raises(h2.RpcError) as e:
            ch._response(st)
        assert e.value.code() is h2.StatusCode.UNIMPLEMENTED and "identity" in e.value.details()
        assert st.trailers is None  # trailers only
    finally:
        ch.close()


def test_unavailable_when_nothing_listens():
    from tests.helpers_cp import free_port

    with h2.insecure_channel(f"127.0.0.1:{free_port()}") as ch:
        with pytest.raises(h2.RpcError) as e:
            ch.unary_unary("/t.S/Echo")(b"", timeout=2)
    assert e.value.code() is h2.StatusCode.UNAVAILABLE
    srv = h2.server()
    port = srv.add_insecure_port("127.0.0.1:0")
    assert h2.server().add_insecure_port(f"127.0.0.1:{port}") == 0  # in use: 0, as grpcio
    srv.stop(0)


def test_stop_cancels_calls_in_flight_and_leaves_no_thread():
    svc = PortService()
    srv = h2.server(max_workers=2)
    srv.add_generic_rpc_handlers((svc,))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    ch = h2.insecure_channel(f"127.0.0.1:{port}")
    box: dict = {}
    th = threading.Thread(target=lambda: box.setdefault("e", _catch(
        lambda: ch.unary_unary("/t.S/Hang")(b"", timeout=30))))
    th.start()
    time.sleep(0.3)
    t0 = time.perf_counter()
    srv.stop(0.1)
    assert time.perf_counter() - t0 < 5
    th.join(5)
    assert isinstance(box["e"], h2.RpcError), box
    assert box["e"].code().name in ("CANCELLED", "UNAVAILABLE")
    assert svc.cancelled.is_set()
    ch.close()
    assert _transport_threads() == []


def _catch(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 — returned to the test
        return e


# -- the admin service --------------------------------------------------------

NODES = [
    {"node_id": "alpha", "base_url": "http://127.0.0.1:9001", "kind": "agent",
     "status": "active", "did": "did:key:zAlpha", "last_heartbeat": 1700000000.25,
     "metadata": {"version": "1.2.3"},
     "reasoners": [{"id": "summarize", "node_id": "alpha", "kind": "reasoner",
                    "description": "short ünïcode"},
                   {"id": "plan", "node_id": "alpha", "kind": "reasoner"}],
     "skills": [{"id": "word_count", "node_id": "alpha", "kind": "skill"}]},
    {"node_id": "beta", "base_url": "http://127.0.0.1:9002", "kind": "model",
     "status": "inactive", "last_heartbeat": 1700000100.5, "metadata": {},
     "reasoners": [{"id": "generate", "node_id": "beta", "kind": "reasoner",
                    "description": "LLM"}],
     "skills": []},
]


def _stores():
    js, ts = j_storage.SQLiteStorage(":memory:"), t_storage.SQLiteStorage(":memory:")
    for d in NODES:
        js.upsert_node(j_types.AgentNode.from_dict(dict(d)))
        ts.upsert_node(t_types.AgentNode.from_dict(dict(d)))
    return js, ts


def test_admin_interop_matrix():
    """grpcio client → port server, port client → JAX (grpcio) server, and
    port → port: the same answers, byte for byte, on the same nodes."""
    js, ts = _stores()
    t_srv = t_admin_grpc.start_admin_grpc(ts, _free())
    t_port = t_srv._listeners[0].getsockname()[1]
    j_port = _free()
    j_srv = j_admin_grpc.start_admin_grpc(js, j_port)
    try:
        for method in ("ListReasoners", "ListNodes"):
            a = j_admin_grpc.admin_client_call(t_port, method)  # grpcio → port
            b = t_admin_grpc.admin_client_call(j_port, method)  # port → grpcio
            c = t_admin_grpc.admin_client_call(t_port, method)  # port → port
            d = j_admin_grpc.admin_client_call(j_port, method)  # the JAX package alone
            assert a.SerializeToString() == b.SerializeToString() == c.SerializeToString() \
                == d.SerializeToString(), method
        r = t_admin_grpc.admin_client_call(t_port, "ListReasoners").reasoners
        assert [(x.agent_node_id, x.reasoner_id, x.description, x.status, x.node_version)
                for x in r] == [("alpha", "summarize", "short ünïcode", "active", "1.2.3"),
                                ("alpha", "plan", "", "active", "1.2.3"),
                                ("beta", "generate", "LLM", "inactive", "")]
        n = t_admin_grpc.admin_client_call(t_port, "ListNodes").nodes
        assert [(x.node_id, x.reasoner_count, x.skill_count, x.last_heartbeat, x.did)
                for x in n] == [("alpha", 2, 1, 1700000000.25, "did:key:zAlpha"),
                                ("beta", 1, 0, 1700000100.5, "")]
        with pytest.raises(OSError, match="could not bind"):
            t_admin_grpc.start_admin_grpc(ts, t_port)
    finally:
        t_srv.stop(0)
        j_srv.stop(0)
        js.close()
        ts.close()
    assert _transport_threads() == []


def _free() -> int:
    from tests.helpers_cp import free_port

    return free_port()


def test_control_plane_serves_admin_grpc_from_start_to_stop():
    from agentfield_tpu_torch.control_plane.server import ControlPlane, ControlPlaneThread

    aport = _free()
    cpt = ControlPlaneThread(ControlPlane(admin_grpc_port=aport))
    cpt.start()
    try:
        for d in NODES:
            cpt.cp.storage.upsert_node(t_types.AgentNode.from_dict(dict(d)))
        got = j_admin_grpc.admin_client_call(aport, "ListNodes")  # grpcio's client
        assert [n.node_id for n in got.nodes] == ["alpha", "beta"]
        assert len(t_admin_grpc.admin_client_call(aport, "ListReasoners").reasoners) == 3
    finally:
        cpt.stop()
    with pytest.raises(h2.RpcError) as e:
        t_admin_grpc.admin_client_call(aport, "ListNodes")
    assert e.value.code() is h2.StatusCode.UNAVAILABLE
    assert _transport_threads() == []
