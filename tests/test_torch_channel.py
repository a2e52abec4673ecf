"""The port's gateway channel on the CPU: ``serving.websocket`` (RFC 6455
over the standard library) and ``serving.channel`` (the node side of
``agentfield_tpu/control_plane/channel.py``), at llama-tiny size.

- WebSocket framing against RFC 6455 itself: the handshake's example key,
  the section 5.7 frame examples, the three length forms, masking,
  fragmentation with a ping between the fragments, close, and the protocol
  errors a server must refuse;
- the channel protocol on the port's node, driven by the port's WebSocket
  client: accepted, token frames with a rising per-execution seq, one
  terminal, ping/pong, a reattach's replay on a new connection, an unknown
  reattach, a duplicate submit, ``fin``, cancel (the slot frees), a
  ``kv_fetch`` of nothing held (an empty answer) and a malformed one (the
  error frame), the JAX server's ``channel_server_*`` counters;
- the JAX control plane (``tests/helpers_cp.CPHarness``) driving the port's
  node as a child process over ``/channel``, as ``tests/test_streaming.py``
  drives the JAX node: streamed tokens equal the unary ones with one
  terminal, a seeded ``channel.drop`` reattaches with nothing lost or
  repeated, an async execution replays from frame 0 at ``GET .../stream``,
  a gateway timeout cancels down the channel (the slot frees), a duplicate
  submit runs once, and SIGTERM during a stream drains: the stream gets its
  terminal, the node deregisters and exits 0.
"""

from __future__ import annotations

import asyncio
import email.message
import io
import json
import os
import pathlib
import re
import signal
import socket
import struct
import sys
import threading
import time

import aiohttp
import pytest
import torch

from agentfield_tpu.control_plane import faults as jax_faults
from agentfield_tpu.control_plane.channel import ChannelServer as JaxChannelServer
from agentfield_tpu_torch.serving import websocket as wsm
from agentfield_tpu_torch.serving.channel import CANCELLED, STAT_KEYS
from agentfield_tpu_torch.serving.engine import EngineConfig
from agentfield_tpu_torch.serving.model_node import build_model_node
from tests.helpers_cp import CPHarness, async_test

ROOT = pathlib.Path(__file__).resolve().parents[1]
ECFG = dict(max_batch=4, page_size=8, num_pages=64, max_pages_per_seq=16)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """llama-tiny gains nothing from intra-op threads; one keeps this file
    off the cores that concurrent test workers time their locks on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- RFC 6455 framing ---------------------------------------------------------


def _headers(**kv) -> email.message.Message:
    m = email.message.Message()
    for k, v in kv.items():
        m[k.replace("_", "-")] = v
    return m


UPGRADE = dict(Upgrade="websocket", Connection="keep-alive, Upgrade",
               Sec_WebSocket_Key="dGhlIHNhbXBsZSBub25jZQ==", Sec_WebSocket_Version="13")


def test_handshake_rfc_example_and_no_extension():
    # RFC 6455 section 1.3's example key and its accept value
    assert wsm.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="
    hdrs = dict(wsm.handshake_headers(_headers(
        **UPGRADE, Sec_WebSocket_Extensions="permessage-deflate; client_max_window_bits")))
    # the offered extension is declined by not echoing it
    assert hdrs == {"Upgrade": "websocket", "Connection": "Upgrade",
                    "Sec-WebSocket-Accept": "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="}


@pytest.mark.parametrize("bad", [
    {"Upgrade": "h2c"}, {"Connection": "keep-alive"}, {"Sec_WebSocket_Version": "8"},
    {"Sec_WebSocket_Key": "c2hvcnQ="}, {"Sec_WebSocket_Key": "not base64 !!"},
], ids=lambda d: next(iter(d)))
def test_handshake_refuses_what_is_not_an_upgrade(bad):
    with pytest.raises(wsm.HandshakeError):
        wsm.handshake_headers(_headers(**(UPGRADE | bad)))


# RFC 6455 section 5.7: (frame bytes, fin, opcode, payload)
RFC_FRAMES = [
    (bytes.fromhex("810548656c6c6f"), True, wsm.OP_TEXT, b"Hello"),
    (bytes.fromhex("818537fa213d7f9f4d5158"), True, wsm.OP_TEXT, b"Hello"),
    (bytes.fromhex("010348656c"), False, wsm.OP_TEXT, b"Hel"),
    (bytes.fromhex("80026c6f"), True, wsm.OP_CONT, b"lo"),
    (bytes.fromhex("890548656c6c6f"), True, wsm.OP_PING, b"Hello"),
    (bytes.fromhex("8a8537fa213d7f9f4d5158"), True, wsm.OP_PONG, b"Hello"),
]


@pytest.mark.parametrize("raw,fin,op,payload", RFC_FRAMES, ids=lambda v: v.hex()
                         if isinstance(v, bytes) and len(v) > 5 else None)
def test_rfc_frame_examples(raw, fin, op, payload):
    masked = bool(raw[1] & 0x80)
    mask = raw[2:6] if masked else None
    assert wsm.encode_frame(op, payload, fin, mask) == raw
    assert wsm.read_frame(io.BytesIO(raw), expect_masked=masked) == (fin, op, payload)


@pytest.mark.parametrize("n,form", [(0, 0), (125, 125), (126, 126), (65535, 126),
                                    (65536, 127), (70000, 127)])
@pytest.mark.parametrize("masked", [False, True])
def test_length_forms_round_trip(n, form, masked):
    payload = os.urandom(n)
    mask = b"\x01\x02\x03\x04" if masked else None
    raw = wsm.encode_frame(wsm.OP_BINARY, payload, True, mask)
    assert raw[1] & 0x7F == form and bool(raw[1] & 0x80) == masked
    head = 2 + {126: 2, 127: 8}.get(form, 0)
    if form == 126:
        assert struct.unpack("!H", raw[2:4])[0] == n
    elif form == 127:
        assert struct.unpack("!Q", raw[2:10])[0] == n
    assert len(raw) == head + (4 if masked else 0) + n
    assert wsm.read_frame(io.BytesIO(raw), masked) == (True, wsm.OP_BINARY, payload)


def _pair():
    a, b = socket.socketpair()
    return wsm.WebSocket(a, a.makefile("rb")), wsm.WebSocket(b, b.makefile("rb"), client=True)


def test_fragments_ping_and_close_over_a_socket():
    server, client = _pair()
    mask = b"abcd"
    try:
        client.sock.sendall(wsm.encode_frame(wsm.OP_TEXT, b"frag", False, mask)
                            + wsm.encode_frame(wsm.OP_CONT, b"men", True, mask)
                            + wsm.encode_frame(wsm.OP_BINARY, b"\x00\x01", True, mask))
        # a ping between two fragments of one message
        client.sock.sendall(wsm.encode_frame(wsm.OP_TEXT, b"par", False, mask)
                            + wsm.encode_frame(wsm.OP_PING, b"are you there", True, mask)
                            + wsm.encode_frame(wsm.OP_CONT, b"ts", True, b"wxyz"))
        assert server.recv() == (wsm.OP_TEXT, "fragmen")
        assert server.recv() == (wsm.OP_BINARY, b"\x00\x01")
        assert server.recv() == (wsm.OP_TEXT, "parts")
        # the pong went out at once, unmasked
        assert wsm.read_frame(client.rfile, False) == (True, wsm.OP_PONG, b"are you there")
        server.send_text("x" * 300)
        assert client.recv() == (wsm.OP_TEXT, "x" * 300)
        client.close(1001, "going away")
        assert server.recv() is None and server.close_code == 1001
        fin, op, payload = wsm.read_frame(client.rfile, False)  # the echo
        assert (op, struct.unpack("!H", payload[:2])[0]) == (wsm.OP_CLOSE, 1001)
        with pytest.raises(ConnectionError):
            server.send_text("after close")
    finally:
        server.release()
        client.release()


PROTOCOL_ERRORS = {
    "unmasked client frame": wsm.encode_frame(wsm.OP_TEXT, b"hi"),
    "reserved bit": bytes([0x80 | 0x40 | wsm.OP_TEXT, 0x80]) + b"abcd",
    "long control frame": wsm.encode_frame(wsm.OP_PING, b"p" * 126, True, b"abcd"),
    "fragmented control frame": wsm.encode_frame(wsm.OP_PING, b"p", False, b"abcd"),
    "lone continuation": wsm.encode_frame(wsm.OP_CONT, b"c", True, b"abcd"),
    "unknown opcode": bytes([0x83, 0x80]) + b"abcd",
    "message inside a message": wsm.encode_frame(wsm.OP_TEXT, b"a", False, b"abcd")
    + wsm.encode_frame(wsm.OP_TEXT, b"b", True, b"abcd"),
}


@pytest.mark.parametrize("name", list(PROTOCOL_ERRORS))
def test_protocol_errors_close_1002(name):
    server, client = _pair()
    try:
        client.sock.sendall(PROTOCOL_ERRORS[name])
        with pytest.raises(wsm.ProtocolError) as err:
            server.recv()
        assert err.value.code == 1002
        fin, op, payload = wsm.read_frame(client.rfile, False)
        assert (op, struct.unpack("!H", payload[:2])[0]) == (wsm.OP_CLOSE, 1002)
    finally:
        server.release()
        client.release()


def test_bad_utf8_text_closes_1007():
    server, client = _pair()
    try:
        client.sock.sendall(wsm.encode_frame(wsm.OP_TEXT, b"\xff\xfe", True, b"abcd"))
        with pytest.raises(wsm.ProtocolError) as err:
            server.recv()
        assert err.value.code == 1007
    finally:
        server.release()
        client.release()


def _small_pair(monkeypatch, send_timeout: float):
    """A pair whose buffers fill after a few KiB and whose sends time out
    after ``send_timeout`` s."""
    monkeypatch.setattr(wsm, "SEND_TIMEOUT_S", send_timeout)
    a, b = socket.socketpair()
    a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
    b.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
    return wsm.WebSocket(a, a.makefile("rb")), wsm.WebSocket(b, b.makefile("rb"), client=True)


def test_a_send_to_a_peer_that_stopped_reading_times_out_and_aborts(monkeypatch):
    server, client = _small_pair(monkeypatch, 0.3)
    try:
        t0 = time.monotonic()
        sent = 0
        with pytest.raises(ConnectionError):
            while time.monotonic() - t0 < 30:
                server.send_text("t" * 200)
                sent += 1
        assert 0.3 <= time.monotonic() - t0 < 5 and sent > 0
        assert server.closed
        with pytest.raises(ConnectionError):
            server.send_text("after the abort")
        # the peer reads what got through, then sees the connection end
        got = 0
        while client.recv() is not None:
            got += 1
        assert 0 < got <= sent
    finally:
        server.release()
        client.release()


def test_close_aborts_when_a_send_holds_the_lock(monkeypatch):
    server, client = _small_pair(monkeypatch, 30.0)
    held, release = threading.Event(), threading.Event()

    def hold():
        with server._send_lock:
            held.set()
            release.wait(30)

    th = threading.Thread(target=hold)
    th.start()
    try:
        held.wait(10)
        t0 = time.monotonic()
        server.close(1001, "node stopping")
        assert wsm.CLOSE_LOCK_S <= time.monotonic() - t0 < wsm.CLOSE_LOCK_S + 2
        assert server.closed and client.recv() is None and client.close_code is None
    finally:
        release.set()
        th.join(10)
        server.release()
        client.release()


# -- the channel protocol on the port's node, in-process ----------------------


@pytest.fixture(scope="module")
def node():
    server, backend = build_model_node("llama-tiny", ecfg=EngineConfig(**ECFG), device="cpu",
                                       seed=3)
    port = server.start(port=0)
    yield server, backend, port
    server.stop(grace_s=0.0)


class Client:
    """The gateway's side of one connection: a reader thread collects the
    node's frames."""

    def __init__(self, port: int):
        self.ws = wsm.connect("127.0.0.1", port, "/channel")
        self.frames: list[dict] = []
        self.cv = threading.Condition()
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self):
        while (msg := self.ws.recv()) is not None:
            with self.cv:
                self.frames.append(json.loads(msg[1]))
                self.cv.notify_all()

    def send(self, **frame):
        self.ws.send_text(json.dumps(frame))

    def wait(self, pred, timeout=60.0) -> list[dict]:
        with self.cv:
            assert self.cv.wait_for(lambda: pred(self.frames), timeout), self.frames
            return list(self.frames)

    def of(self, eid) -> list[dict]:
        return [f for f in self.frames if f.get("exec_id") == eid]

    def close(self):
        self.ws.close()
        self.thread.join(10)
        self.ws.release()
        assert not self.thread.is_alive()


def _terminal(eid):
    return lambda fs: any(f.get("kind") == "terminal" and f.get("exec_id") == eid for f in fs)


def _submit(c, eid, stream=True, **inp):
    c.send(kind="submit", exec_id=eid, target="generate", input=inp, headers={}, stream=stream)


def test_channel_protocol_on_the_port_node(node):
    server, backend, port = node
    want = backend.generate(prompt="over the channel", max_new_tokens=6)
    c = Client(port)
    try:
        _submit(c, "s1", prompt="over the channel", max_new_tokens=6)
        c.send(kind="ping")
        c.wait(_terminal("s1"))
        fs = c.of("s1")
        assert fs[0] == {"kind": "accepted", "exec_id": "s1"}
        toks = [f for f in fs if f["kind"] == "token"]
        assert [f["seq"] for f in fs[1:]] == list(range(1, len(fs)))
        assert [f["data"]["token"] for f in toks] == want["tokens"]
        term = fs[-1]
        assert term["status"] == "completed" and term["seq"] == len(toks) + 1
        assert {k: term["result"][k] for k in ("tokens", "finish_reason", "model", "text")} == {
            k: want[k] for k in ("tokens", "finish_reason", "model", "text")}
        assert {"kind": "pong"} in c.frames
        # unary: one terminal, no token frame, the same result
        _submit(c, "u1", stream=False, prompt="over the channel", max_new_tokens=6)
        c.wait(_terminal("u1"))
        assert [f["kind"] for f in c.of("u1")] == ["accepted", "terminal"]
        assert c.of("u1")[-1]["result"]["tokens"] == want["tokens"]
        # a duplicate submit replays from 0, the work not run twice
        done = backend.engine.stats["requests_finished"]
        _submit(c, "s1", prompt="over the channel", max_new_tokens=6)
        c.wait(lambda f: len(c.of("s1")) == 2 * len(fs))
        assert c.of("s1")[len(fs):] == fs
        assert backend.engine.stats["requests_finished"] == done
        # a reattach on a new connection replays the frames past last_seq
        c2 = Client(port)
        try:
            c2.send(kind="reattach", exec_id="s1", last_seq=2)
            c2.send(kind="reattach", exec_id="nobody", last_seq=0)
            c2.wait(lambda f: any(x["kind"] == "reattach_fail" for x in f))
            got = c2.of("s1")
            assert got[0] == {"kind": "reattach_ok", "exec_id": "s1", "from_seq": 2}
            assert got[1:] == [f for f in fs if f.get("seq", 0) > 2]
            # fin drops the buffer: the execution is unknown from then on
            c2.send(kind="fin", exec_id="s1")
            c2.send(kind="reattach", exec_id="s1", last_seq=0)
            c2.wait(lambda f: sum(x["kind"] == "reattach_fail" for x in f) == 2)
            # a fetch the node holds nothing of: one empty done frame; a
            # malformed one (chains not a list): the JAX server's error frame
            c2.send(kind="kv_fetch", fetch_id="f1", peer="p", chains=["ab"])
            c2.wait(lambda f: any(x["kind"] == "kv_pages" for x in f))
            assert c2.frames[-1] == {"kind": "kv_pages", "fetch_id": "f1", "seq": 1,
                                     "pages": [], "blob_len": 0, "done": True}
            c2.send(kind="kv_fetch", fetch_id="f2", peer="p", chains="ab")
            c2.wait(lambda f: sum(x["kind"] == "kv_pages" for x in f) == 2)
            assert c2.frames[-1] == {"kind": "kv_pages", "fetch_id": "f2",
                                     "error": "node serves no KV export", "done": True}
        finally:
            c2.close()
        # cancel mid-stream: the terminal says so and the slot frees
        _submit(c, "long", prompt="cancel me", max_new_tokens=100)
        c.wait(lambda f: sum(x["kind"] == "token" and x["exec_id"] == "long" for x in f) >= 2)
        c.send(kind="cancel", exec_id="long")
        c.wait(_terminal("long"))
        term = c.of("long")[-1]
        assert (term["status"], term["error"]) == ("failed", CANCELLED)
        assert sum(f["kind"] == "terminal" for f in c.of("long")) == 1
        for _ in range(500):
            if not backend.engine.has_work():
                break
            time.sleep(0.01)
        assert backend.engine.num_active == 0
        assert backend.engine.allocator.free_pages == ECFG["num_pages"] - 1
    finally:
        c.close()
    stats = server.heartbeat_stats()
    assert set(STAT_KEYS) == set(JaxChannelServer(invoke=None).stats) <= set(stats)
    assert stats["channel_server_connections_total"] >= 2
    assert stats["channel_server_submits_total"] >= 4
    assert stats["channel_server_reattaches_total"] == 1
    assert stats["channel_server_cancels_total"] == 1
    assert stats["channel_server_kv_fetches_total"] == 2
    assert stats["channel_server_kv_fetch_errors_total"] == 1
    # the duplicate's replay sent old frames: no new ones
    assert stats["channel_server_frames_total"] == sum(
        1 for f in c.frames if "seq" in f) - (len(fs) - 1)


def test_channel_traced_execution_and_failures(node):
    server, backend, port = node
    ctx = {"trace_id": "tr_chan", "attempt": 2, "node": "torch-n"}
    c = Client(port)
    try:
        c.send(kind="submit", exec_id="t1", target="generate", headers={}, stream=True,
               input={"prompt": "traced", "max_new_tokens": 4, "trace": ctx}, trace=ctx)
        c.send(kind="submit", exec_id="bad", target="generate", headers={}, stream=True,
               input={"prompt": "x", "max_new_tokens": 0})
        c.send(kind="submit", exec_id="nope", target="nope", headers={}, stream=False, input={})
        c.send(kind="submit", exec_id="emb", target="embed", headers={}, stream=True,
               input={"prompt": "vector"})
        for eid in ("t1", "bad", "nope", "emb"):
            c.wait(_terminal(eid))
    finally:
        c.close()
    term = c.of("t1")[-1]
    assert "trace" not in term["result"]
    spans = term["trace"]["spans"]
    assert term["trace"]["trace_id"] == "tr_chan"
    assert [s["name"] for s in spans] == ["engine.queue_wait", "engine.prefill", "engine.decode",
                                          "node.generate"]
    assert all(s["node"] == "torch-n" and s["attempt"] == 2 for s in spans)
    assert spans[-1]["attrs"] == {"rid": spans[-1]["attrs"]["rid"], "finish": "length",
                                  "stream": 1}
    assert c.of("bad")[-1]["status"] == "failed" and "ValueError" in c.of("bad")[-1]["error"]
    assert "LookupError" in c.of("nope")[-1]["error"]
    emb = c.of("emb")
    assert [f["kind"] for f in emb] == ["accepted", "terminal"]  # no stream handler
    assert emb[-1]["status"] == "completed"
    assert len(emb[-1]["result"]["embedding"]) == backend.cfg.hidden_size


def test_unary_channel_generate_is_generate(node):
    """A unary ``generate`` execution goes through ``generate`` itself: its
    parameters (``timeout``-free, the routing hints too: a ``kv_peer`` hint
    on a text prompt is a no-op, ``handoff_export`` makes the request phase
    one of a two-phase dispatch) and its result, an unknown key refused as
    the HTTP route refuses it, and a cancel ends the request in the
    engine."""
    server, backend, port = node
    want = backend.generate(prompt="unary hints", max_new_tokens=5)
    c = Client(port)
    try:
        _submit(c, "h1", stream=False, prompt="unary hints", max_new_tokens=5,
                kv_peer={"node": "elsewhere"})
        _submit(c, "h2", stream=False, prompt="x", bogus=1)
        _submit(c, "h3", stream=False, prompt="unary hints", max_new_tokens=5,
                handoff_export=True)
        for eid in ("h1", "h2", "h3"):
            c.wait(_terminal(eid))
        got = c.of("h1")[-1]["result"]
        assert set(got) == set(want)
        # the repeat's prefill hits the prefix cache: the same tokens, the
        # logprobs to float rounding
        assert {k: v for k, v in got.items() if k != "logprobs"} == {
            k: v for k, v in want.items() if k != "logprobs"}
        assert got["logprobs"] == pytest.approx(want["logprobs"], rel=1e-5)
        assert c.of("h2")[-1]["status"] == "failed" and "bogus" in c.of("h2")[-1]["error"]
        p1 = c.of("h3")[-1]["result"]
        n = len(backend.tokenizer.encode("unary hints"))
        assert (p1["finish_reason"], p1["tokens"]) == ("handoff", want["tokens"][:1])
        assert p1["handoff"] == {"id": p1["handoff"]["id"], "t0": want["tokens"][0],
                                 "logprob": pytest.approx(want["logprobs"][0], rel=1e-5),
                                 "prompt_tokens": n, "pages": (n - 1) // ECFG["page_size"],
                                 "page_size": ECFG["page_size"]}
        assert backend.engine.export_handoff_tail(p1["handoff"]["id"]) is not None
        _submit(c, "u2", stream=False, prompt="cancel me unary", max_new_tokens=100)
        for _ in range(1000):
            if backend.engine.num_active:
                break
            time.sleep(0.005)
        c.send(kind="cancel", exec_id="u2")
        c.wait(_terminal("u2"))
        assert [f["kind"] for f in c.of("u2")] == ["accepted", "terminal"]
        assert (c.of("u2")[-1]["status"], c.of("u2")[-1]["error"]) == ("failed", CANCELLED)
        for _ in range(500):
            if not backend.engine.has_work():
                break
            time.sleep(0.01)
        assert backend.engine.num_active == 0 and not backend._streams
        assert backend.engine.allocator.free_pages == ECFG["num_pages"] - 1
    finally:
        c.close()


def test_a_plain_get_of_the_channel_is_refused(node):
    _, _, port = node
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", "/channel")
        resp = conn.getresponse()
        assert resp.status == 400 and "Upgrade" in json.loads(resp.read())["error"]
    finally:
        conn.close()


# -- the JAX control plane against the port's node (a child process) -----------


async def _start_child(cp_url: str, node_id: str, extra_env: dict | None = None):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               **(extra_env or {}))
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "agentfield_tpu_torch.serving.model_node", "--device", "cpu",
        "--model", "llama-tiny", "--port", "0", "--control-plane", cp_url, "--node-id", node_id,
        cwd=str(ROOT), env=env, stdout=asyncio.subprocess.PIPE,
        stderr=asyncio.subprocess.STDOUT)
    lines: list[str] = []
    while True:
        line = (await asyncio.wait_for(proc.stdout.readline(), 60)).decode()
        assert line, f"the node exited: {lines}"
        lines.append(line)
        m = re.search(r"serving on (http://\S+)", line)
        if m:
            return proc, m.group(1), lines


async def _stop_child(proc, lines: list[str]) -> int:
    if proc.returncode is None:
        proc.send_signal(signal.SIGTERM)
    async for line in proc.stdout:
        lines.append(line.decode())
    return await asyncio.wait_for(proc.wait(), 60)


def _toks(frames):
    """Content tokens of a gateway stream (stop tokens terminate, a token
    < 0 carries none), as ``tests/test_streaming.py`` counts them."""
    return [f["token"] for f in frames if f.get("kind") == "token" and f.get("token", -1) >= 0
            and not (f.get("finished") and f.get("finish_reason") == "stop")]


async def _collect_stream(http, target, body):
    frames = []
    async with http.post(f"/api/v1/execute/{target}", json=body) as r:
        assert r.status == 200, await r.text()
        async for line in r.content:
            if line.startswith(b"data: "):
                frames.append(json.loads(line[6:]))
                if frames[-1].get("kind") in ("terminal", "dropped"):
                    break
    return frames


async def _node_stats(base: str, pred=lambda s: True, timeout: float = 30.0) -> dict:
    """The node's ``GET /stats``, once ``pred`` holds for it."""
    t0 = time.monotonic()
    async with aiohttp.ClientSession(base_url=base) as direct:
        while True:
            async with direct.get("/stats") as r:
                stats = await r.json()
            if pred(stats):
                return stats
            assert time.monotonic() - t0 < timeout, stats
            await asyncio.sleep(0.05)


@async_test
async def test_jax_gateway_streams_from_the_port_node():
    """(a) unary and (b) streamed executions over one channel: tokens equal,
    one terminal; (c) a seeded ``channel.drop`` after 3 frames reattaches,
    nothing lost or repeated; (d) async + ``GET .../stream`` replays from
    frame 0; (e) a duplicate submit runs once."""
    async with CPHarness() as h:
        proc, base, lines = await _start_child(h.base_url, "torch-ch")
        try:
            gen = {"prompt": "stream me please", "max_new_tokens": 10}
            async with h.http.post("/api/v1/execute/torch-ch.generate",
                                   json={"input": gen}) as r:
                ref = await r.json()
            assert ref["status"] == "completed", ref
            ref_tokens = ref["result"]["tokens"]
            assert len(ref_tokens) == 10
            async with aiohttp.ClientSession(base_url=base) as direct:
                async with direct.post("/reasoners/generate", json={"input": gen}) as r:
                    assert (await r.json())["result"]["tokens"] == ref_tokens
            frames = await _collect_stream(h.http, "torch-ch.generate",
                                           {"input": gen, "stream": True})
            terminals = [f for f in frames if f.get("kind") == "terminal"]
            assert len(terminals) == 1 and frames[-1] is terminals[0]
            assert terminals[0]["status"] == "completed"
            assert _toks(frames) == ref_tokens == terminals[0]["result"]["tokens"]
            assert terminals[0]["frames_delivered"] == len(
                [f for f in frames if f.get("kind") == "token"])
            opens = h.cp.metrics.counter_value("channel_opens_total")
            assert opens == 1  # one socket for both executions
            # the unary execution paid nothing per token
            assert h.cp.gateway.streams.tokens_published(ref["execution_id"]) == 0

            jax_faults.install(jax_faults.FaultInjector(
                seed=11, spec={"channel.drop": {"times": 1, "after": 3}}))
            try:
                frames = await _collect_stream(h.http, "torch-ch.generate",
                                               {"input": gen, "stream": True})
            finally:
                jax_faults.install(None)
            terminals = [f for f in frames if f.get("kind") == "terminal"]
            assert len(terminals) == 1 and terminals[0]["status"] == "completed"
            assert _toks(frames) == ref_tokens, "the reattach lost or repeated a token"
            seqs = [f["seq"] for f in frames if f.get("kind") == "token"]
            assert seqs == sorted(set(seqs))
            assert h.cp.metrics.counter_value("channel_reconnects_total") >= 1
            assert h.cp.metrics.counter_value("channel_reattaches_total") >= 1
            assert h.cp.metrics.counter_value("channel_opens_total") == opens + 1

            async with h.http.post("/api/v1/execute/async/torch-ch.generate",
                                   json={"input": gen, "stream": True}) as r:
                assert r.status == 202
                eid = (await r.json())["execution_id"]
            for _ in range(600):
                await asyncio.sleep(0.05)
                async with h.http.get(f"/api/v1/executions/{eid}") as r:
                    if (await r.json())["status"] == "completed":
                        break
            replay = []
            async with h.http.get(f"/api/v1/executions/{eid}/stream") as r:
                assert r.status == 200
                async for line in r.content:
                    if line.startswith(b"data: "):
                        replay.append(json.loads(line[6:]))
                        if replay[-1].get("kind") == "terminal":
                            break
            assert replay[-1]["status"] == "completed" and _toks(replay) == ref_tokens

            nodeobj = await h.cp.gateway._node_get("torch-ch")
            before = await _node_stats(base, lambda s: s["active_slots"] == 0)
            for _ in range(2):
                out = await h.cp.gateway.channels.submit(
                    nodeobj, "exec_dup", "generate", gen, {}, stream=True)
                assert out[0] == "deferred"
            for _ in range(600):
                if h.cp.gateway.streams.tokens_published("exec_dup") >= 10:
                    break
                await asyncio.sleep(0.05)
            await asyncio.sleep(0.3)
            assert h.cp.gateway.streams.tokens_published("exec_dup") == 10
            stats = await _node_stats(base, lambda s: s["active_slots"] == 0)
            # the duplicate replayed: one more request served, not two
            assert stats["requests_finished"] == before["requests_finished"] + 1
        finally:
            rc = await _stop_child(proc, lines)
        assert rc == 0, "".join(lines)


@async_test
async def test_timeout_cancels_and_sigterm_drains_the_port_node():
    """A gateway timeout sends cancel down the channel: the node's request
    ends and its slot frees. Then SIGTERM with a stream open: the stream
    gets its terminal (deadline_exceeded at the 1 s grace), a request sent
    during the drain gets 503, the node deregisters and exits 0."""
    async with CPHarness() as h:
        proc, base, lines = await _start_child(h.base_url, "torch-dr",
                                               {"AGENTFIELD_DRAIN_GRACE": "1"})
        try:
            frames = await _collect_stream(h.http, "torch-dr.generate", {
                "input": {"prompt": "a long one", "max_new_tokens": 480}, "stream": True,
                "timeout": 1.0})
            terminals = [f for f in frames if f.get("kind") == "terminal"]
            assert len(terminals) == 1 and terminals[0]["status"] == "timeout"
            # the cancel reached the engine long before 480 tokens
            stats = await _node_stats(base, lambda s: s["requests_cancelled"] >= 1
                                      and s["active_slots"] == 0, timeout=5.0)
            assert stats["decode_tokens"] < 480 and stats["pending"] == 0

            async with aiohttp.ClientSession(base_url=base) as direct:
                async with direct.post("/generate/stream", json={
                        "prompt": "drain me", "max_new_tokens": 480}) as r:
                    assert r.status == 200
                    first = await r.content.readline()
                    assert first.startswith(b"data: ")
                    t0 = time.monotonic()
                    proc.send_signal(signal.SIGTERM)
                    proc.send_signal(signal.SIGTERM)  # a second signal is ignored
                    await asyncio.sleep(0.2)
                    async with direct.post("/reasoners/generate",
                                           json={"input": {"prompt": "late"}}) as late:
                        assert late.status == 503, await late.text()
                        assert "NodeDrainingError" in (await late.json())["error"]
                    last = None
                    async for line in r.content:
                        if line.startswith(b"data: "):
                            last = json.loads(line[6:])
                            if last["finished"]:
                                break
                    assert last is not None and last["finished"]
                    assert last["finish_reason"] in ("deadline_exceeded", "length")
                    assert time.monotonic() - t0 < 15
        finally:
            rc = await _stop_child(proc, lines)
        assert rc == 0, "".join(lines)
        assert any("drained" in ln for ln in lines), lines
        async with h.http.get("/api/v1/nodes/torch-dr") as r:
            gone = r.status == 404 or (await r.json())["node"]["status"] == "stopping"
        assert gone


def test_smoke_channel_phase_rehearses_on_cpu():
    """``chip_smoke.phase_channel`` end to end on the CPU at llama-tiny size:
    the three transports' tokens equal, a dropped socket's reattach, a
    cancel, a traced waterfall, tracing on and off, ``/debug/flight``, a
    profiler capture and the drain with a stream and a channel execution
    open."""
    import chip_smoke
    from agentfield_tpu_torch.models.configs import get_config
    from agentfield_tpu_torch.models.llama import init_params

    cfg = get_config("llama-tiny")
    results: dict = {}
    chip_smoke.phase_channel(
        results, {"params": init_params(cfg, seed=0, device="cpu"), "cfg": cfg}, 0,
        device="cpu", model_name="llama-tiny", prompts=(10, 20, 33, 40, 50, 60, 70, 80), new=8,
        long_new=48, drain_new=300, num_pages=256, max_pages_per_seq=40)
    ch = results["channel"]
    assert ch["b"]["tokens"] == 48 and ch["b"]["replayed"] >= 1
    assert ch["f"]["late_status"] == 503 and ch["f"]["stop_s"] < 11
    assert ch["f"]["sse_finish"] == ch["f"]["channel_finish"] == "deadline_exceeded"
    assert ch["channel_stats"]["channel_server_reattaches_total"] == 1
    assert ch["channel_stats"]["channel_server_cancels_total"] == 1
    assert ch["d"]["on"]["tick_ms_decode"] > 0 and ch["d"]["off"]["tick_ms_decode"] > 0
    assert len(ch["a"]["first_frame_ms"]) == 8
