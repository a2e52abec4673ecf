"""RFC 6455 WebSocket over the standard library (numpy masks the frames): the
framing under the node's gateway channel (``serving.channel``), which the
card's machine must serve without aiohttp or the websockets package. Each
socket has ``TCP_NODELAY`` set: a frame is one write, never held for the
peer's ACK of the one before.

The server half upgrades a request that ``http.server`` has already parsed:
``handshake_headers`` checks the client's headers and gives the 101
response's (``Sec-WebSocket-Accept`` from the key; no extension is echoed,
so an offered permessage-deflate is declined and frames stay uncompressed).
``WebSocket`` then reads messages from the connection's buffered reader
(bytes after the request's headers may already sit in its buffer):
fragments reassembled, a ping answered with a pong at once, a close echoed.
It writes each frame with one ``sendall`` under a send lock, so frames of
several writer threads never interleave. A send is bounded: a peer that
stops reading (frozen, or its host gone without a reset) makes it fail
after ``SEND_TIMEOUT_S`` without progress, and the connection is aborted,
so no writer, and no reader waiting for the send lock to answer a ping,
blocks for ever. Server frames go unmasked, client
frames masked; a frame masked the wrong way, with a reserved bit set, or a
control frame that is fragmented or longer than 125 bytes is a protocol
error (close 1002).

The client half (``connect``) plays the gateway's side, as aiohttp's
``ws_connect`` does for the control plane: ``chip_smoke.py`` and the tests
drive the node with it.
"""

from __future__ import annotations

import base64
import hashlib
import os
import socket
import struct
import threading

import numpy as np

GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0x0, 0x1, 0x2, 0x8, 0x9, 0xA
DATA_OPS = (OP_TEXT, OP_BINARY)
CONTROL_OPS = (OP_CLOSE, OP_PING, OP_PONG)
MAX_MESSAGE = 64 << 20  # a message larger than this closes the connection (1009)
# a send the peer takes no byte of for this long aborts the connection: under
# half the gateway's 15 s heartbeat, so a pong queued behind it still lands
SEND_TIMEOUT_S = 5.0
CLOSE_LOCK_S = 1.0  # close() aborts instead when a send holds the lock longer


class ProtocolError(ValueError):
    """The peer broke RFC 6455; ``code`` is the close code to answer with."""

    def __init__(self, msg: str, code: int = 1002):
        super().__init__(msg)
        self.code = code


class HandshakeError(ValueError):
    """An upgrade request (or a 101 response) that is not a WebSocket one."""


def accept_key(key: str) -> str:
    """``Sec-WebSocket-Accept`` for a client's ``Sec-WebSocket-Key``."""
    return base64.b64encode(hashlib.sha1((key + GUID).encode()).digest()).decode()


def handshake_headers(headers) -> list[tuple[str, str]]:
    """The 101 response's headers for an upgrade request's ``headers`` (a
    case-insensitive mapping, as ``http.server`` gives); raises
    HandshakeError for a request that is not a version-13 upgrade."""
    if "websocket" not in (headers.get("Upgrade") or "").lower():
        raise HandshakeError("missing 'Upgrade: websocket'")
    if "upgrade" not in [t.strip() for t in (headers.get("Connection") or "").lower().split(",")]:
        raise HandshakeError("missing 'Connection: Upgrade'")
    if (headers.get("Sec-WebSocket-Version") or "").strip() != "13":
        raise HandshakeError("Sec-WebSocket-Version must be 13")
    key = (headers.get("Sec-WebSocket-Key") or "").strip()
    try:
        raw = base64.b64decode(key, validate=True)
    except ValueError:
        raw = b""
    if len(raw) != 16:
        raise HandshakeError("Sec-WebSocket-Key must be 16 bytes in base64")
    return [("Upgrade", "websocket"), ("Connection", "Upgrade"),
            ("Sec-WebSocket-Accept", accept_key(key))]


def set_send_timeout(sock: socket.socket, seconds: float) -> None:
    """Bound every blocking send on ``sock`` (``SO_SNDTIMEO``): one that
    moves no byte for ``seconds`` raises instead of waiting for ever on a
    peer that stopped reading. Reads keep blocking."""
    sec = int(seconds)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                    struct.pack("ll", sec, int((seconds - sec) * 1e6)))


def _xor_key(buf: np.ndarray, key: bytes) -> None:
    """XOR ``buf`` (uint8, in place) with the 4-byte key repeated from its
    first byte, 8 bytes at a time: a KV page blob is megabytes."""
    n = buf.size
    w = n // 8 * 8
    if w and buf.ctypes.data % 8 == 0:
        buf[:w].view(np.uint64)[...] ^= np.frombuffer(key * 2, np.uint64)[0]
    else:
        w = 0
    buf[w:] ^= np.resize(np.frombuffer(key, np.uint8), n - w)


def _mask_parts(parts, key: bytes) -> np.ndarray:
    """The concatenation of ``parts`` masked with ``key``: one copy."""
    out = np.empty(sum(len(p) for p in parts), np.uint8)
    off = 0
    for p in parts:
        out[off : off + len(p)] = np.frombuffer(p, np.uint8)
        off += len(p)
    _xor_key(out, key)
    return out


def _mask(payload: bytes, key: bytes) -> bytes:
    """XOR with the 4-byte key repeated (masking and unmasking alike)."""
    return _mask_parts([payload], key).tobytes() if payload else b""


def frame_header(opcode: int, n: int, fin: bool = True, mask: bytes | None = None) -> bytes:
    """A frame's header for an ``n``-byte payload: the 7-, 16- or 64-bit
    length form as ``n`` needs, the mask key after it when masked."""
    head = bytes([(0x80 if fin else 0) | opcode])
    mbit = 0x80 if mask is not None else 0
    if n < 126:
        head += bytes([mbit | n])
    elif n < 1 << 16:
        head += bytes([mbit | 126]) + struct.pack("!H", n)
    else:
        head += bytes([mbit | 127]) + struct.pack("!Q", n)
    return head + (mask or b"")


def encode_frame(opcode: int, payload: bytes = b"", fin: bool = True,
                 mask: bytes | None = None) -> bytes:
    """One frame, masked with the 4-byte ``mask`` (a client's frame) or not
    (a server's)."""
    head = frame_header(opcode, len(payload), fin, mask)
    return head + (payload if mask is None else _mask(payload, mask))


def _read_exact(rfile, n: int) -> bytes:
    data = rfile.read(n) if n else b""
    if len(data) != n:
        raise ConnectionError("connection closed mid-frame" if data else "connection closed")
    return data


def _read_into(rfile, n: int) -> bytearray:
    """``n`` bytes read straight into a new buffer (no intermediate copy:
    a payload may be megabytes)."""
    buf = bytearray(n)
    view, got = memoryview(buf), 0
    while got < n:
        k = rfile.readinto(view[got:])
        if not k:
            raise ConnectionError("connection closed mid-frame")
        got += k
    return buf


def read_frame(rfile, expect_masked: bool) -> tuple[bool, int, bytes]:
    """(fin, opcode, unmasked payload) of the next frame on ``rfile``.
    ``expect_masked``: a server reads masked client frames, a client
    unmasked server frames; the other kind is a protocol error."""
    b0, b1 = _read_exact(rfile, 2)
    fin, opcode = bool(b0 & 0x80), b0 & 0x0F
    if b0 & 0x70:
        raise ProtocolError("reserved bits set without a negotiated extension")
    if opcode not in DATA_OPS + CONTROL_OPS + (OP_CONT,):
        raise ProtocolError(f"unknown opcode {opcode:#x}")
    masked, n = bool(b1 & 0x80), b1 & 0x7F
    if masked != expect_masked:
        raise ProtocolError("client frames must be masked, server frames must not")
    if n == 126:
        n = struct.unpack("!H", _read_exact(rfile, 2))[0]
    elif n == 127:
        n = struct.unpack("!Q", _read_exact(rfile, 8))[0]
        if n >> 63:
            raise ProtocolError("64-bit length with its top bit set")
    if opcode in CONTROL_OPS and (not fin or n > 125):
        raise ProtocolError("control frames are unfragmented and at most 125 bytes")
    if n > MAX_MESSAGE:
        raise ProtocolError(f"frame of {n} bytes", code=1009)
    key = _read_exact(rfile, 4) if masked else None
    payload = _read_into(rfile, n)
    if key is not None and n:
        _xor_key(np.frombuffer(payload, np.uint8), key)  # unmasked in place
    return fin, opcode, payload


class WebSocket:
    """One open WebSocket over ``sock``, reading from ``rfile`` (the
    socket's buffered reader). ``recv`` returns the next whole message as
    ``(opcode, payload)`` (text payloads decoded to str, binary ones a
    bytes-like buffer read straight from the socket), answering pings
    and echoing a close on the way, and None once the connection has
    closed. The send methods raise ConnectionError on a closed or broken
    connection, and on a send that timed out, which aborts it."""

    def __init__(self, sock: socket.socket, rfile, client: bool = False):
        set_send_timeout(sock, SEND_TIMEOUT_S)
        # each frame is one write: Nagle would hold a small frame (a token)
        # behind the peer's delayed ACK of the one before (about 40 ms)
        if sock.family in (socket.AF_INET, socket.AF_INET6):
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock = sock
        self.rfile = rfile
        self.client = client
        self.closed = False  # a close frame sent, or the socket gone
        self.close_code: int | None = None  # the peer's, once received
        self._send_lock = threading.Lock()

    # -- writing ----------------------------------------------------------

    def _send(self, opcode: int, *parts) -> None:
        """One frame whose payload is the concatenation of ``parts``: a
        server's parts go out as they are, a client's are masked into one
        buffer."""
        n = sum(len(p) for p in parts)
        if self.client:
            key = os.urandom(4)
            bufs = [frame_header(opcode, n, True, key), _mask_parts(parts, key)]
        else:
            bufs = [frame_header(opcode, n), *parts]
        with self._send_lock:
            if self.closed:
                raise ConnectionError("websocket is closed")
            try:
                for b in bufs:
                    if len(b):
                        self.sock.sendall(b)
            except OSError as e:
                self.abort()  # part of the frame may be out: the stream is lost
                raise ConnectionError(f"websocket send failed: {e!r}") from e

    def send_text(self, text: str) -> None:
        self._send(OP_TEXT, text.encode())

    def send_binary(self, *parts) -> None:
        """One binary message: the concatenation of ``parts`` (bytes-like),
        never joined on a server's side."""
        self._send(OP_BINARY, *parts)

    def close(self, code: int = 1000, reason: str = "") -> None:
        """Send a close frame (once); the peer's echo ends ``recv``. When
        another thread's send holds the lock past ``CLOSE_LOCK_S`` (a peer
        that stopped reading), abort instead."""
        if not self._send_lock.acquire(timeout=CLOSE_LOCK_S):
            self.abort()
            return
        try:
            if self.closed:
                return
            self.closed = True
            payload = struct.pack("!H", code) + reason.encode()[:123]
            try:
                self.sock.sendall(encode_frame(OP_CLOSE, payload, True,
                                               os.urandom(4) if self.client else None))
            except OSError:
                pass
        finally:
            self._send_lock.release()

    def abort(self) -> None:
        """Shut the socket down both ways: a reader blocked in ``recv``
        returns None, a blocked writer raises. Safe from any thread."""
        self.closed = True
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    def release(self) -> None:
        """Abort, then close the reader and the socket: the owner's last
        call, once no thread reads any more."""
        self.abort()
        self.rfile.close()
        self.sock.close()

    # -- reading ----------------------------------------------------------

    def recv(self) -> tuple[int, str | bytes] | None:
        opcode, parts, size = None, [], 0
        while True:
            try:
                fin, op, payload = read_frame(self.rfile, expect_masked=not self.client)
            except ProtocolError as e:
                self.close(e.code, str(e)[:100])
                self.abort()
                raise
            except (ConnectionError, OSError, ValueError):
                self.closed = True
                return None
            if op == OP_PING:
                try:
                    self._send(OP_PONG, payload)
                except ConnectionError:
                    return None
                continue
            if op == OP_PONG:
                continue
            if op == OP_CLOSE:
                self.close_code = struct.unpack("!H", payload[:2])[0] if len(payload) >= 2 else 1005
                # echo the peer's code (none, if it sent none), then stop reading
                self.close(self.close_code if self.close_code != 1005 else 1000)
                return None
            if op == OP_CONT:
                if opcode is None:
                    raise self._fail("continuation frame without a message to continue")
            elif opcode is not None:
                raise self._fail("a new message began inside a fragmented one")
            else:
                opcode = op
            parts.append(payload)
            size += len(payload)
            if size > MAX_MESSAGE:
                raise self._fail(f"message past {MAX_MESSAGE} bytes", 1009)
            if fin:
                data = parts[0] if len(parts) == 1 else b"".join(parts)
                if opcode == OP_TEXT:
                    try:
                        return opcode, data.decode()
                    except UnicodeDecodeError:
                        raise self._fail("text message is not UTF-8", 1007) from None
                return opcode, data

    def _fail(self, msg: str, code: int = 1002) -> ProtocolError:
        self.close(code, msg[:100])
        self.abort()
        return ProtocolError(msg, code)


def connect(host: str, port: int, path: str = "/", timeout: float = 10.0) -> WebSocket:
    """Open a client WebSocket to ``ws://host:port/path`` (no extensions);
    raises HandshakeError if the server does not switch protocols. The
    socket blocks without a timeout once connected."""
    sock = socket.create_connection((host, port), timeout=timeout)
    try:
        key = base64.b64encode(os.urandom(16)).decode()
        sock.sendall((f"GET {path} HTTP/1.1\r\nHost: {host}:{port}\r\nUpgrade: websocket\r\n"
                      f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                      "Sec-WebSocket-Version: 13\r\n\r\n").encode())
        rfile = sock.makefile("rb")
        status = rfile.readline().decode("latin-1")
        headers: dict[str, str] = {}
        while True:
            line = rfile.readline().decode("latin-1")
            if line in ("\r\n", "\n", ""):
                break
            name, _, value = line.partition(":")
            headers[name.strip().lower()] = value.strip()
        if status.split(" ")[1:2] != ["101"]:
            raise HandshakeError(f"server answered {status.strip()!r}")
        if headers.get("sec-websocket-accept") != accept_key(key):
            raise HandshakeError("wrong Sec-WebSocket-Accept")
        if headers.get("sec-websocket-extensions"):
            raise HandshakeError("server negotiated an extension that was not offered")
        sock.settimeout(None)
        return WebSocket(sock, rfile, client=True)
    except BaseException:
        sock.close()
        raise
