"""gRPC over HTTP/2 on the standard library: the port's stand-in for
grpcio, which the card's machine lacks (with ``hpack_codec.py`` for the
headers and ``proto/wire.py`` for the messages). The port's two gRPC
services ride it: the control plane's admin service (``admin_grpc.py``)
and the model node's ``Generate`` (``serving/model_node.py``). Both are
unary and insecure, so this is unary calls over h2c with prior knowledge
(no TLS, no HTTP/1.1 upgrade), interoperable with grpcio both ways.

HTTP/2 (RFC 9113): the connection preface; SETTINGS and their ACK; HEADERS
with CONTINUATION (padding and priority fields read and dropped); DATA;
WINDOW_UPDATE; PING answered; RST_STREAM; GOAWAY; streams multiplexed on
one connection, opened in increasing order. Flow control both ways: what
this side sends is bounded by the peer's connection window and the
stream's (from the peer's SETTINGS_INITIAL_WINDOW_SIZE, adjusted when the
setting changes, grown by its WINDOW_UPDATEs) and cut into frames no larger
than the peer's SETTINGS_MAX_FRAME_SIZE; what it receives it hands back at
once with WINDOW_UPDATEs, connection and stream, so it keeps the protocol's
default 64 KiB windows and 16 KiB frames and a larger message still gets
through.

gRPC over HTTP/2 (the gRPC project's PROTOCOL-HTTP2): ``content-type:
application/grpc``, the 5-byte message prefix (a compressed-flag 1 is
answered UNIMPLEMENTED: only ``identity`` is offered), ``grpc-timeout``
into the handler's ``time_remaining()``, trailers ``grpc-status`` and a
percent-encoded ``grpc-message``, a trailers-only answer for an error. A
client whose deadline passes sends RST_STREAM CANCEL, as grpcio does; the
server then calls the RPC's ``add_callback`` hooks, which is how the model
node releases the request's engine slot.

The API keeps grpcio's shapes so the services read as the JAX package's:
``server(max_workers)`` with ``add_generic_rpc_handlers``,
``add_insecure_port`` (0 when the bind fails), ``start`` and
``stop(grace)``; a handler's ``service(handler_call_details)`` returns
``unary_unary_rpc_method_handler(fn, request_deserializer,
response_serializer)``; ``insecure_channel(target).unary_unary(method,
request_serializer, response_deserializer)(request, timeout=)``; a failed
call raises ``RpcError`` with ``code()`` (a ``StatusCode``) and
``details()``. The server is thread-based, as ``grpc.server(
ThreadPoolExecutor(max_workers=n))``: one thread accepts, one reads each
connection, handlers run on a pool of ``max_workers``; ``stop`` joins them
all.
"""

from __future__ import annotations

import collections
import concurrent.futures
import enum
import re
import socket
import struct
import threading
import time
from typing import Any, Callable

from agentfield_tpu_torch.control_plane.hpack_codec import Decoder, HPACKError, encode_headers

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

# frame types (RFC 9113 6)
DATA, HEADERS, PRIORITY, RST_STREAM, SETTINGS, PUSH_PROMISE, PING, GOAWAY, WINDOW_UPDATE, \
    CONTINUATION = range(10)
# flags
END_STREAM = ACK = 0x1
END_HEADERS, PADDED, PRIORITY_FLAG = 0x4, 0x8, 0x20
# settings (6.5.2)
HEADER_TABLE_SIZE, ENABLE_PUSH, MAX_CONCURRENT_STREAMS, INITIAL_WINDOW_SIZE, \
    MAX_FRAME_SIZE, MAX_HEADER_LIST_SIZE = range(1, 7)
# error codes (7)
NO_ERROR, PROTOCOL_ERROR, INTERNAL_ERROR, FLOW_CONTROL_ERROR = 0, 1, 2, 3
STREAM_CLOSED, FRAME_SIZE_ERROR, REFUSED_STREAM, CANCEL, COMPRESSION_ERROR = 5, 6, 7, 8, 9

DEFAULT_WINDOW = 65535
DEFAULT_MAX_FRAME = 16384
MAX_WINDOW = (1 << 31) - 1
MAX_MESSAGE = 4 << 20  # grpcio's default receive limit, both ways
CONNECT_TIMEOUT_S = 10.0
USER_AGENT = "agentfield-tpu-torch-grpc-h2/1"


class StatusCode(enum.Enum):
    """grpc.StatusCode's names and values."""

    OK = (0, "ok")
    CANCELLED = (1, "cancelled")
    UNKNOWN = (2, "unknown")
    INVALID_ARGUMENT = (3, "invalid argument")
    DEADLINE_EXCEEDED = (4, "deadline exceeded")
    NOT_FOUND = (5, "not found")
    ALREADY_EXISTS = (6, "already exists")
    PERMISSION_DENIED = (7, "permission denied")
    RESOURCE_EXHAUSTED = (8, "resource exhausted")
    FAILED_PRECONDITION = (9, "failed precondition")
    ABORTED = (10, "aborted")
    OUT_OF_RANGE = (11, "out of range")
    UNIMPLEMENTED = (12, "unimplemented")
    INTERNAL = (13, "internal")
    UNAVAILABLE = (14, "unavailable")
    DATA_LOSS = (15, "data loss")
    UNAUTHENTICATED = (16, "unauthenticated")


_BY_NUMBER = {c.value[0]: c for c in StatusCode}


class RpcError(Exception):
    """A call that ended in a status other than OK, shaped as grpcio's
    ``_InactiveRpcError``: ``code()`` and ``details()``."""

    def __init__(self, code: StatusCode, details: str):
        self._code, self._details = code, details
        super().__init__(f"<RpcError of RPC that terminated with:\n\tstatus = {code}\n"
                         f"\tdetails = \"{details}\"\n>")

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details


# -- header helpers ---------------------------------------------------------

_TIMEOUT_UNITS = {"H": 3600.0, "M": 60.0, "S": 1.0, "m": 1e-3, "u": 1e-6, "n": 1e-9}
_TIMEOUT_RE = re.compile(r"^(\d{1,8})([HMSmun])$")


def parse_timeout(value: str) -> float:
    """``grpc-timeout`` (up to 8 digits and a unit) → seconds."""
    m = _TIMEOUT_RE.match(value)
    if m is None:
        raise ValueError(f"bad grpc-timeout {value!r}")
    return int(m.group(1)) * _TIMEOUT_UNITS[m.group(2)]


def format_timeout(seconds: float) -> str:
    """Seconds → ``grpc-timeout``, in the finest unit that fits 8 digits
    (rounded up: a deadline never arrives early)."""
    seconds = max(seconds, 0.0)
    for unit, scale in (("u", 1e-6), ("m", 1e-3), ("S", 1.0), ("M", 60.0), ("H", 3600.0)):
        n = -int(-seconds // scale)
        if n < 10**8:
            return f"{max(n, 1)}{unit}"
    return "99999999H"


def percent_encode(text: str) -> str:
    """``grpc-message``: UTF-8, every byte outside 0x20-0x7E and '%' as %XX."""
    out = []
    for b in text.encode("utf-8"):
        out.append(chr(b) if 0x20 <= b <= 0x7E and b != 0x25 else f"%{b:02X}")
    return "".join(out)


def percent_decode(text: str) -> str:
    raw = text.encode("latin-1")
    out = bytearray()
    i = 0
    while i < len(raw):
        if raw[i] == 0x25 and re.fullmatch(rb"[0-9A-Fa-f]{2}", raw[i + 1:i + 3]):
            out.append(int(raw[i + 1:i + 3], 16))
            i += 3
        else:
            out.append(raw[i])
            i += 1
    return out.decode("utf-8", errors="replace")


def _frame(type_: int, flags: int, sid: int, payload: bytes = b"") -> bytes:
    return len(payload).to_bytes(3, "big") + bytes((type_, flags)) + \
        struct.pack(">I", sid & 0x7FFFFFFF) + payload


def _message(payload: bytes) -> bytes:
    return b"\0" + struct.pack(">I", len(payload)) + payload


class _ConnectionError(Exception):
    """A connection error (RFC 9113 5.4.1): GOAWAY with ``code``, close."""

    def __init__(self, code: int, reason: str):
        super().__init__(reason)
        self.code = code


class _Stream:
    def __init__(self, sid: int, send_window: int):
        self.id = sid
        self.send_window = send_window
        self.headers: list[tuple[str, str]] | None = None
        self.trailers: list[tuple[str, str]] | None = None
        self.data = bytearray()
        self.remote_closed = False
        self.reset_code: int | None = None
        self.failure: str | None = None  # the connection went away
        self.done = threading.Event()
        self.callbacks: list[Callable[[], None]] = []
        self.terminated = False


class _Connection:
    """One HTTP/2 connection, either side: a reader thread dispatches the
    peer's frames; writers share one lock, so a header block and its
    continuations go out whole."""

    def __init__(self, sock: socket.socket, client: bool,
                 on_request: Callable[["_Connection", _Stream], None] | None = None):
        self.sock = sock
        self.client = client
        self._on_request = on_request
        self._wlock = threading.Lock()
        self._flow = threading.Condition()  # windows, streams, settings
        self._rfile = sock.makefile("rb")
        self.decoder = Decoder()
        self.peer_initial_window = DEFAULT_WINDOW
        self.peer_max_frame = DEFAULT_MAX_FRAME
        self.peer_max_streams: int | None = None
        self.conn_window = DEFAULT_WINDOW
        self.streams: dict[int, _Stream] = {}
        self.next_id = 1
        self.last_peer_id = 0
        self.goaway: int | None = None  # the peer's last stream id, once it sent GOAWAY
        self.closed: str | None = None
        self._cont: tuple[int, int, bytearray] | None = None
        self.thread = threading.Thread(target=self._read_loop, daemon=True,
                                       name="grpc-h2-client" if client else "grpc-h2-conn")

    def start(self) -> None:
        first = PREFACE if self.client else b""
        settings = struct.pack(">HI", ENABLE_PUSH, 0) if self.client else b""
        self._send(first + _frame(SETTINGS, 0, 0, settings))
        self.thread.start()

    # -- writing ---------------------------------------------------------

    def _send(self, data: bytes) -> None:
        with self._wlock:
            if self.closed:
                raise ConnectionError(f"HTTP/2 connection closed: {self.closed}")
            self.sock.sendall(data)

    def _header_frames(self, sid: int, headers: list[tuple[str, str]], end_stream: bool) -> bytes:
        block = encode_headers(headers)
        size = self.peer_max_frame
        chunks = [block[i:i + size] for i in range(0, len(block), size)] or [b""]
        out = bytearray()
        for i, chunk in enumerate(chunks):
            flags = END_HEADERS if i == len(chunks) - 1 else 0
            if i == 0:
                out += _frame(HEADERS, flags | (END_STREAM if end_stream else 0), sid, chunk)
            else:
                out += _frame(CONTINUATION, flags, sid, chunk)
        return bytes(out)

    def send_headers(self, sid: int, headers: list[tuple[str, str]], end_stream: bool) -> None:
        self._send(self._header_frames(sid, headers, end_stream))

    def open_stream(self, headers: list[tuple[str, str]], deadline: float | None) -> _Stream:
        """Client: a new stream, its HEADERS sent (ids go out in order)."""
        with self._flow:
            while (self.peer_max_streams is not None
                   and len(self.streams) >= self.peer_max_streams and not self.closed):
                if not self._flow.wait(_remaining(deadline)):
                    raise TimeoutError("no stream free before the deadline")
        with self._wlock:
            with self._flow:
                if self.closed or self.goaway is not None:
                    raise ConnectionError(f"HTTP/2 connection unusable: {self.closed or 'GOAWAY'}")
                st = _Stream(self.next_id, self.peer_initial_window)
                self.next_id += 2
                self.streams[st.id] = st
            self.sock.sendall(self._header_frames(st.id, headers, False))
        return st

    def send_data(self, st: _Stream, payload: bytes, end_stream: bool,
                  deadline: float | None = None) -> None:
        """``payload`` in DATA frames within the windows and the peer's
        frame size, waiting for WINDOW_UPDATEs as it must."""
        view = memoryview(payload)
        off = 0
        while True:
            with self._flow:
                while True:
                    if self.closed:
                        raise ConnectionError(f"HTTP/2 connection closed: {self.closed}")
                    if st.reset_code is not None:
                        raise ConnectionError(f"stream reset ({st.reset_code})")
                    if self.client and st.done.is_set():
                        raise ConnectionError("the server answered before the request ended")
                    n = min(len(view) - off, self.conn_window, st.send_window,
                            self.peer_max_frame)
                    if n > 0 or off == len(view):
                        break
                    if not self._flow.wait(_remaining(deadline)):
                        raise TimeoutError("flow-control window stayed closed")
                self.conn_window -= n
                st.send_window -= n
            last = off + n == len(view)
            self._send(_frame(DATA, END_STREAM if last and end_stream else 0, st.id,
                              bytes(view[off:off + n])))
            off += n
            if last:
                return

    def reset(self, st: _Stream, code: int) -> None:
        with self._flow:
            self.streams.pop(st.id, None)
        try:
            self._send(_frame(RST_STREAM, 0, st.id, struct.pack(">I", code)))
        except OSError:
            pass

    def forget(self, st: _Stream) -> None:
        with self._flow:
            self.streams.pop(st.id, None)
            self._flow.notify_all()

    def send_goaway(self, code: int = NO_ERROR) -> None:
        try:
            self._send(_frame(GOAWAY, 0, 0, struct.pack(">II", self.last_peer_id, code)))
        except OSError:
            pass

    # -- reading ---------------------------------------------------------

    def _read_exact(self, n: int) -> bytes:
        data = self._rfile.read(n)
        if data is None or len(data) < n:
            raise EOFError("peer closed the connection")
        return data

    def _read_loop(self) -> None:
        reason = "peer closed the connection"
        try:
            if not self.client and self._read_exact(len(PREFACE)) != PREFACE:
                raise _ConnectionError(PROTOCOL_ERROR, "bad connection preface")
            while True:
                head = self._read_exact(9)
                length = int.from_bytes(head[:3], "big")
                type_, flags = head[3], head[4]
                sid = struct.unpack(">I", head[5:9])[0] & 0x7FFFFFFF
                if length > DEFAULT_MAX_FRAME:
                    raise _ConnectionError(FRAME_SIZE_ERROR, f"frame of {length} bytes")
                payload = self._read_exact(length)
                if self._cont is not None and (type_ != CONTINUATION or sid != self._cont[0]):
                    raise _ConnectionError(PROTOCOL_ERROR, "header block interrupted")
                self._dispatch(type_, flags, sid, payload)
        except _ConnectionError as e:
            reason = str(e)
            self.send_goaway(e.code)
        except HPACKError as e:
            reason = f"HPACK: {e}"
            self.send_goaway(COMPRESSION_ERROR)
        except (EOFError, OSError, ValueError) as e:
            reason = repr(e) if not isinstance(e, EOFError) else str(e)
        finally:
            self.close(reason)
            self._release()

    def _release(self) -> None:
        try:
            self._rfile.close()
            self.sock.close()
        except OSError:
            pass

    def _dispatch(self, type_: int, flags: int, sid: int, payload: bytes) -> None:
        if type_ == DATA:
            self._on_data(flags, sid, payload)
        elif type_ == HEADERS:
            if sid == 0:
                raise _ConnectionError(PROTOCOL_ERROR, "HEADERS on stream 0")
            payload = self._strip(flags, payload, priority=True)
            if flags & END_HEADERS:
                self._on_header_block(sid, flags, payload)
            else:
                self._cont = (sid, flags, bytearray(payload))
        elif type_ == CONTINUATION:
            if self._cont is None:
                raise _ConnectionError(PROTOCOL_ERROR, "CONTINUATION without HEADERS")
            self._cont[2].extend(payload)
            if flags & END_HEADERS:
                csid, cflags, block = self._cont
                self._cont = None
                self._on_header_block(csid, cflags, bytes(block))
        elif type_ == SETTINGS:
            if sid != 0 or len(payload) % 6:
                raise _ConnectionError(PROTOCOL_ERROR, "bad SETTINGS frame")
            if not flags & ACK:
                self._on_settings(payload)
                self._send(_frame(SETTINGS, ACK, 0))
        elif type_ == WINDOW_UPDATE:
            inc = struct.unpack(">I", payload)[0] & 0x7FFFFFFF
            with self._flow:
                if sid == 0:
                    if inc == 0:
                        raise _ConnectionError(PROTOCOL_ERROR, "WINDOW_UPDATE of 0")
                    self.conn_window += inc
                    if self.conn_window > MAX_WINDOW:
                        raise _ConnectionError(FLOW_CONTROL_ERROR, "connection window overflow")
                elif sid in self.streams:
                    self.streams[sid].send_window += inc
                self._flow.notify_all()
        elif type_ == PING:
            if len(payload) != 8 or sid != 0:
                raise _ConnectionError(FRAME_SIZE_ERROR, "bad PING")
            if not flags & ACK:
                self._send(_frame(PING, ACK, 0, payload))
        elif type_ == RST_STREAM:
            code = struct.unpack(">I", payload)[0]
            with self._flow:
                st = self.streams.pop(sid, None)
                self._flow.notify_all()
            # a reset after a whole answer (grpc servers send NO_ERROR to stop
            # a request body they no longer read) changes nothing
            if st is not None and not (self.client and st.remote_closed):
                st.reset_code = code
                self._terminate(st)
        elif type_ == GOAWAY:
            last = struct.unpack(">I", payload[:4])[0] & 0x7FFFFFFF
            with self._flow:
                self.goaway = last
                doomed = [s for i, s in self.streams.items() if i > last]
                for s in doomed:
                    self.streams.pop(s.id, None)
                self._flow.notify_all()
            for s in doomed:
                s.failure = "the server went away (GOAWAY)"
                self._terminate(s)
        elif type_ == PUSH_PROMISE:
            raise _ConnectionError(PROTOCOL_ERROR, "PUSH_PROMISE is disabled")
        # PRIORITY and unknown frame types are ignored (RFC 9113 5.5)

    @staticmethod
    def _strip(flags: int, payload: bytes, priority: bool = False) -> bytes:
        start, end = 0, len(payload)
        if flags & PADDED:
            if not payload:
                raise _ConnectionError(PROTOCOL_ERROR, "padded frame without a pad length")
            start, end = 1, len(payload) - payload[0]
        if priority and flags & PRIORITY_FLAG:
            start += 5
        if end < start:
            raise _ConnectionError(PROTOCOL_ERROR, "padding longer than the frame")
        return payload[start:end]

    def _on_settings(self, payload: bytes) -> None:
        with self._flow:
            for i in range(0, len(payload), 6):
                key, value = struct.unpack(">HI", payload[i:i + 6])
                if key == INITIAL_WINDOW_SIZE:
                    if value > MAX_WINDOW:
                        raise _ConnectionError(FLOW_CONTROL_ERROR, "initial window too large")
                    delta = value - self.peer_initial_window
                    self.peer_initial_window = value
                    for st in self.streams.values():
                        st.send_window += delta
                elif key == MAX_FRAME_SIZE:
                    if not DEFAULT_MAX_FRAME <= value <= (1 << 24) - 1:
                        raise _ConnectionError(PROTOCOL_ERROR, f"MAX_FRAME_SIZE {value}")
                    self.peer_max_frame = value
                elif key == MAX_CONCURRENT_STREAMS:
                    self.peer_max_streams = value
                elif key == ENABLE_PUSH and value > 1:
                    raise _ConnectionError(PROTOCOL_ERROR, "ENABLE_PUSH not 0 or 1")
                # HEADER_TABLE_SIZE: this encoder keeps no table; others unused
            self._flow.notify_all()

    def _on_data(self, flags: int, sid: int, payload: bytes) -> None:
        if sid == 0:
            raise _ConnectionError(PROTOCOL_ERROR, "DATA on stream 0")
        data = self._strip(flags, payload)
        with self._flow:
            st = self.streams.get(sid)
        if payload:  # hand the window back: flow-controlled length, padding included
            update = _frame(WINDOW_UPDATE, 0, 0, struct.pack(">I", len(payload)))
            if st is not None and not flags & END_STREAM:
                update += _frame(WINDOW_UPDATE, 0, sid, struct.pack(">I", len(payload)))
            self._send(update)
        if st is None or st.remote_closed:
            return  # a stream already reset or answered: its data is dropped
        st.data += data
        if flags & END_STREAM:
            self._end_remote(st)

    def _on_header_block(self, sid: int, flags: int, block: bytes) -> None:
        headers = self.decoder.decode(block)  # always: the table must stay in step
        with self._flow:
            st = self.streams.get(sid)
            if st is None and not self.client:
                if sid % 2 == 0 or sid <= self.last_peer_id:
                    raise _ConnectionError(PROTOCOL_ERROR, f"stream id {sid} out of order")
                self.last_peer_id = sid
                st = _Stream(sid, self.peer_initial_window)
                self.streams[sid] = st
        if st is None or st.remote_closed:
            return
        if st.headers is None:
            st.headers = headers
        else:
            st.trailers = headers
        if flags & END_STREAM:
            self._end_remote(st)

    def _end_remote(self, st: _Stream) -> None:
        st.remote_closed = True
        if self.client:
            st.done.set()
        elif self._on_request is not None:
            self._on_request(self, st)

    def _terminate(self, st: _Stream) -> None:
        """The stream ended without an answer (reset, GOAWAY, the connection
        lost): wake its waiter, run its cancel hooks."""
        st.done.set()
        fire_callbacks(st)

    def close(self, reason: str = "closed") -> None:
        with self._flow:
            if self.closed:
                return
            self.closed = reason
            streams = list(self.streams.values())
            self.streams.clear()
            self._flow.notify_all()
        for st in streams:
            st.failure = reason
            self._terminate(st)
        try:
            self.sock.shutdown(socket.SHUT_RDWR)  # wakes the reader, which closes the socket
        except OSError:
            pass
        if self.thread.ident is None:  # never started: nobody else will close it
            self._release()

    def join(self, timeout: float | None = None) -> None:
        if self.thread.is_alive() and threading.current_thread() is not self.thread:
            self.thread.join(timeout)


def fire_callbacks(st: _Stream) -> None:
    with _CB_LOCK:
        if st.terminated:
            return
        st.terminated = True
        cbs, st.callbacks = st.callbacks, []
    for cb in cbs:
        try:
            cb()
        except Exception:  # noqa: BLE001 — one hook's failure must not skip the rest
            pass


_CB_LOCK = threading.Lock()


def _remaining(deadline: float | None) -> float | None:
    return None if deadline is None else max(0.0, deadline - time.monotonic())


# -- server -----------------------------------------------------------------

HandlerCallDetails = collections.namedtuple("HandlerCallDetails", ("method", "invocation_metadata"))
RpcMethodHandler = collections.namedtuple(
    "RpcMethodHandler", ("unary_unary", "request_deserializer", "response_serializer"))


def unary_unary_rpc_method_handler(behavior, request_deserializer=None, response_serializer=None):
    return RpcMethodHandler(behavior, request_deserializer, response_serializer)


class _Aborted(Exception):
    """Raised by ``ServicerContext.abort`` to end the handler."""


class ServicerContext:
    """What a handler gets beside its request: grpcio's
    ``time_remaining``, ``abort`` and ``add_callback`` (run when the RPC
    ends: answered, reset by the client or cut by the server's stop)."""

    def __init__(self, st: _Stream, deadline: float | None):
        self._st, self._deadline = st, deadline
        self.code: StatusCode | None = None
        self.details_text = ""

    def time_remaining(self) -> float | None:
        return None if self._deadline is None else max(0.0, self._deadline - time.monotonic())

    def add_callback(self, callback: Callable[[], None]) -> bool:
        with _CB_LOCK:
            if not self._st.terminated:
                self._st.callbacks.append(callback)
                return True
        return False

    def abort(self, code: StatusCode, details: str) -> None:
        if code is StatusCode.OK:
            raise ValueError("abort() with StatusCode.OK")
        self.code, self.details_text = code, details
        raise _Aborted(details)


class Server:
    """A gRPC server: ``add_generic_rpc_handlers``, ``add_insecure_port``,
    ``start``, ``stop``."""

    def __init__(self, max_workers: int = 4):
        self._handlers: list[Any] = []
        self._max_workers = max_workers
        self._pool: concurrent.futures.ThreadPoolExecutor | None = None
        self._listeners: list[socket.socket] = []
        self._accept_threads: list[threading.Thread] = []
        self._conns: set[_Connection] = set()
        self._lock = threading.Condition()
        self._active: dict[_Stream, _Connection] = {}  # RPCs in flight; under _lock
        self._stopping = False

    def add_generic_rpc_handlers(self, handlers) -> None:
        self._handlers.extend(handlers)

    def add_insecure_port(self, address: str) -> int:
        """Bind ``host:port`` (port 0: any free one); the bound port, or 0
        when the bind fails, as grpcio answers."""
        host, _, port = address.rpartition(":")
        host = host.strip("[]") or "0.0.0.0"
        family = socket.AF_INET6 if ":" in host else socket.AF_INET
        sock = socket.socket(family, socket.SOCK_STREAM)
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind((host, int(port)))
            sock.listen(128)
        except OSError:
            sock.close()
            return 0
        sock.settimeout(0.1)  # the accept loop looks at the stop flag this often
        self._listeners.append(sock)
        return sock.getsockname()[1]

    def start(self) -> None:
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self._max_workers, thread_name_prefix="grpc-h2-handler")
        for lsock in self._listeners:
            th = threading.Thread(target=self._accept_loop, args=(lsock,), daemon=True,
                                  name="grpc-h2-accept")
            th.start()
            self._accept_threads.append(th)

    def _accept_loop(self, lsock: socket.socket) -> None:
        while not self._stopping:
            try:
                sock, _ = lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _Connection(sock, client=False, on_request=self._on_request)
            with self._lock:
                if self._stopping:
                    sock.close()
                    return
                ended = {c for c in self._conns if c.closed}  # clients that went away
                self._conns -= ended
                self._conns.add(conn)
            for c in ended:
                c.join()
            try:
                conn.start()
            except OSError:
                conn.close("could not send the server preface")

    def _lookup(self, method: str, metadata: tuple):
        details = HandlerCallDetails(method, metadata)
        for h in self._handlers:
            handler = h.service(details)
            if handler is not None:
                return handler
        return None

    def _on_request(self, conn: _Connection, st: _Stream) -> None:
        """A whole request arrived (reader thread): check it, then run its
        handler on the pool."""
        hdrs = dict(st.headers or ())
        if hdrs.get(":method") != "POST":
            self._http_error(conn, st, "405")
            return
        if not hdrs.get("content-type", "").startswith("application/grpc"):
            self._http_error(conn, st, "415")
            return
        metadata = tuple((k, v) for k, v in (st.headers or ()) if not k.startswith(":"))
        deadline = None
        if "grpc-timeout" in hdrs:
            try:
                deadline = time.monotonic() + parse_timeout(hdrs["grpc-timeout"])
            except ValueError as e:
                self._finish(conn, st, StatusCode.INTERNAL, str(e))
                return
        body = bytes(st.data)
        if len(body) < 5 or len(body) != 5 + struct.unpack(">I", body[1:5])[0]:
            self._finish(conn, st, StatusCode.INTERNAL,
                         "a unary request must carry exactly one message")
            return
        if body[0] == 1:
            self._finish(conn, st, StatusCode.UNIMPLEMENTED,
                         f"compressed message (grpc-encoding "
                         f"{hdrs.get('grpc-encoding', 'identity')!r}): only identity is "
                         "offered")
            return
        if body[0] != 0:
            self._finish(conn, st, StatusCode.INTERNAL, f"bad message flag {body[0]}")
            return
        if len(body) - 5 > MAX_MESSAGE:
            self._finish(conn, st, StatusCode.RESOURCE_EXHAUSTED,
                         f"Received message larger than max ({len(body) - 5} vs. "
                         f"{MAX_MESSAGE})")
            return
        handler = self._lookup(hdrs.get(":path", ""), metadata)
        if handler is None:
            self._finish(conn, st, StatusCode.UNIMPLEMENTED, "Method not found!")
            return
        with self._lock:
            if self._stopping or self._pool is None:
                conn.reset(st, REFUSED_STREAM)
                return
            self._active[st] = conn
        ctx = ServicerContext(st, deadline)
        self._pool.submit(self._run, conn, st, handler, body[5:], ctx)

    def _run(self, conn: _Connection, st: _Stream, handler, payload: bytes,
             ctx: ServicerContext) -> None:
        code, details, out = StatusCode.OK, "", b""
        try:
            try:
                req = handler.request_deserializer(payload) if handler.request_deserializer \
                    else payload
            except Exception:  # noqa: BLE001 — answered as grpcio answers it
                code, details = StatusCode.INTERNAL, "Exception deserializing request!"
            else:
                try:
                    resp = handler.unary_unary(req, ctx)
                    out = handler.response_serializer(resp) if handler.response_serializer \
                        else resp
                except _Aborted:
                    code, details = ctx.code, ctx.details_text
                except Exception as e:  # noqa: BLE001 — answered as grpcio answers it
                    code, details = StatusCode.UNKNOWN, f"Exception calling application: {e}"
            self._finish(conn, st, code, details, out)
        finally:
            fire_callbacks(st)  # the RPC is over: its termination hooks run once
            with self._lock:
                self._active.pop(st, None)
                self._lock.notify_all()

    def _http_error(self, conn: _Connection, st: _Stream, status: str) -> None:
        try:
            conn.send_headers(st.id, [(":status", status)], end_stream=True)
        except OSError:
            pass
        conn.forget(st)

    def _finish(self, conn: _Connection, st: _Stream, code: StatusCode, details: str,
                out: bytes = b"") -> None:
        """The answer: headers, the message and trailers, or trailers only
        for an error. Nothing goes to a stream the client reset."""
        try:
            if st.reset_code is not None or st.failure is not None:
                return
            base = [(":status", "200"), ("content-type", "application/grpc")]
            if code is StatusCode.OK:
                conn.send_headers(st.id, base + [("grpc-accept-encoding", "identity")], False)
                conn.send_data(st, _message(out), end_stream=False, deadline=None)
                conn.send_headers(st.id, [("grpc-status", "0")], end_stream=True)
            else:
                trailers = base + [("grpc-status", str(code.value[0]))]
                if details:
                    trailers.append(("grpc-message", percent_encode(details)))
                conn.send_headers(st.id, trailers, end_stream=True)
        except (OSError, ConnectionError):
            pass  # the client went away meanwhile
        finally:
            conn.forget(st)

    def stop(self, grace: float | None = None) -> threading.Event:
        """Stop accepting; let RPCs in flight finish for ``grace`` seconds
        (None or 0: none); cancel the rest (their ``add_callback`` hooks
        run, the client sees RST_STREAM CANCEL); close every connection and
        join every thread this server started. Returns a set Event, as
        grpcio's ``stop`` returns one to wait on."""
        with self._lock:
            self._stopping = True
            conns = list(self._conns)
        for lsock in self._listeners:
            lsock.close()
        for th in self._accept_threads:
            th.join()
        for conn in conns:
            conn.send_goaway(NO_ERROR)
        end = time.monotonic() + (grace or 0.0)
        with self._lock:
            while self._active and time.monotonic() < end:
                self._lock.wait(max(0.0, end - time.monotonic()))
            left = list(self._active.items())
        for st, conn in left:
            conn.reset(st, CANCEL)
            st.reset_code = CANCEL
            fire_callbacks(st)
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        for conn in conns:
            conn.close("server stopped")
            conn.join()
        with self._lock:
            self._conns.clear()
        done = threading.Event()
        done.set()
        return done


def server(max_workers: int = 4) -> Server:
    """``grpc.server(ThreadPoolExecutor(max_workers=n))``'s counterpart."""
    return Server(max_workers)


# -- client -----------------------------------------------------------------


_HTTP_TO_GRPC = {"400": StatusCode.INTERNAL, "401": StatusCode.UNAUTHENTICATED,
                 "403": StatusCode.PERMISSION_DENIED, "404": StatusCode.UNIMPLEMENTED,
                 "429": StatusCode.UNAVAILABLE, "502": StatusCode.UNAVAILABLE,
                 "503": StatusCode.UNAVAILABLE, "504": StatusCode.UNAVAILABLE}


class Channel:
    """One connection to ``host:port``, opened at the first call and again
    after the server closed it; calls on it run concurrently as streams."""

    def __init__(self, target: str):
        host, _, port = target.rpartition(":")
        self.target = target
        self._addr = (host.strip("[]") or "127.0.0.1", int(port))
        self._conn: _Connection | None = None
        self._old: list[_Connection] = []
        self._lock = threading.Lock()

    def _connection(self) -> _Connection:
        with self._lock:
            c = self._conn
            if c is None or c.closed or c.goaway is not None:
                if c is not None:
                    self._old.append(c)
                sock = socket.create_connection(self._addr, timeout=CONNECT_TIMEOUT_S)
                sock.settimeout(None)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                c = self._conn = _Connection(sock, client=True)
                c.start()
            return c

    def unary_unary(self, method: str, request_serializer=None, response_deserializer=None):
        return _UnaryUnary(self, method, request_serializer, response_deserializer)

    def call(self, method: str, payload: bytes, timeout: float | None = None) -> bytes:
        """One unary call: the response message's bytes, or RpcError."""
        deadline = None if timeout is None else time.monotonic() + timeout
        headers = [(":method", "POST"), (":scheme", "http"), (":path", method),
                   (":authority", self.target), ("te", "trailers"),
                   ("content-type", "application/grpc"), ("user-agent", USER_AGENT),
                   ("grpc-accept-encoding", "identity")]
        if timeout is not None:
            headers.append(("grpc-timeout", format_timeout(timeout)))
        try:
            conn = self._connection()
            st = conn.open_stream(headers, deadline)
        except TimeoutError:
            raise RpcError(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded") from None
        except OSError as e:
            raise RpcError(StatusCode.UNAVAILABLE,
                           f"failed to connect to all addresses; last error: {e!r}") from None
        try:
            try:
                conn.send_data(st, _message(payload), end_stream=True, deadline=deadline)
            except TimeoutError:
                conn.reset(st, CANCEL)
                raise RpcError(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded") from None
            except (OSError, ConnectionError):
                if not st.done.is_set():  # else the answer (or the reset) says why
                    raise RpcError(StatusCode.UNAVAILABLE, "the connection was lost") from None
            if not st.done.wait(_remaining(deadline)):
                conn.reset(st, CANCEL)  # grpcio's cancel when its deadline passes
                raise RpcError(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded")
        finally:
            conn.forget(st)
        return self._response(st)

    def _response(self, st: _Stream) -> bytes:
        if st.reset_code is not None:
            if st.reset_code == REFUSED_STREAM:
                raise RpcError(StatusCode.UNAVAILABLE, "the server refused the stream")
            if st.reset_code == CANCEL:
                raise RpcError(StatusCode.CANCELLED, "the server cancelled the call")
            raise RpcError(StatusCode.INTERNAL,
                           f"Received RST_STREAM with error code {st.reset_code}")
        if st.headers is None:
            raise RpcError(StatusCode.UNAVAILABLE, st.failure or "no response")
        hdrs = dict(st.headers)
        status = hdrs.get(":status")
        if status != "200":
            raise RpcError(_HTTP_TO_GRPC.get(status, StatusCode.UNKNOWN),
                           f"Received http2 header with status: {status}")
        trailers = dict(st.trailers) if st.trailers is not None else hdrs
        if "grpc-status" not in trailers:
            raise RpcError(StatusCode.UNAVAILABLE if st.failure else StatusCode.UNKNOWN,
                           st.failure or "the response carried no grpc-status")
        code = _BY_NUMBER.get(int(trailers["grpc-status"]), StatusCode.UNKNOWN)
        details = percent_decode(trailers.get("grpc-message", ""))
        if code is not StatusCode.OK:
            raise RpcError(code, details)
        body = bytes(st.data)
        if len(body) < 5 or len(body) != 5 + struct.unpack(">I", body[1:5])[0]:
            raise RpcError(StatusCode.INTERNAL, "a unary response must carry one message")
        if body[0] != 0:
            raise RpcError(StatusCode.INTERNAL, "compressed response: only identity was offered")
        if len(body) - 5 > MAX_MESSAGE:
            raise RpcError(StatusCode.RESOURCE_EXHAUSTED,
                           f"Received message larger than max ({len(body) - 5} vs. "
                           f"{MAX_MESSAGE})")
        return body[5:]

    def close(self) -> None:
        with self._lock:
            conns = self._old + ([self._conn] if self._conn is not None else [])
            self._conn, self._old = None, []
        for c in conns:
            c.send_goaway(NO_ERROR)
            c.close("channel closed")
            c.join()

    def __enter__(self) -> "Channel":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _UnaryUnary:
    def __init__(self, channel: Channel, method: str, serializer, deserializer):
        self._channel, self._method = channel, method
        self._ser, self._de = serializer, deserializer

    def __call__(self, request, timeout: float | None = None):
        payload = self._ser(request) if self._ser else request
        out = self._channel.call(self._method, payload, timeout)
        return self._de(out) if self._de else out


def insecure_channel(target: str) -> Channel:
    return Channel(target)
