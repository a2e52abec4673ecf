"""HTTP/1.1 and a WebSocket client over asyncio streams: the control plane's
stand-in for aiohttp, which the card's machine does not have.

The control plane's modules keep the JAX package's asyncio structure, line
for line; only what they took from aiohttp comes from here, under the same
names, so ``web.json_response`` reads ``http.json_response`` and
``aiohttp.ClientSession`` reads ``http.ClientSession``.

Server (``Application``, ``RouteTableDef``, ``AppRunner``, ``TCPSite``):
``asyncio.start_server`` with keep-alive, one request at a time on a
connection. Routes match in the order they were added; a path segment
``{name}`` matches one segment, ``{name:regex}`` the regex (``{action:a|b}``).
A path that no route matches is a 404, one that matches under another
method a 405 with ``Allow``; a body past ``client_max_size`` a 413 when the
handler reads it; a handler's uncaught exception a 500 (the connection then
closes). The plain-text bodies of these answers are aiohttp's, so a client
sees the same status and text from either control plane. ``StreamResponse``
streams a chunked body (the SSE routes); its ``write`` raises
``ConnectionResetError`` once the client has gone.

Client (``ClientSession``): a pool of keep-alive connections per host,
bounded as ``TCPConnector`` says, and a per-request ``ClientTimeout``.
Failures raise distinct exceptions: ``ClientConnectorError`` (the connect
was refused or failed), ``ServerDisconnectedError`` (the peer closed or
reset the connection before the answer was whole), ``ServerTimeoutError``
(the request's time ran out; also an ``asyncio.TimeoutError``) and
``ClientResponseError`` (``raise_for_status`` on a status >= 400, or
``ContentTypeError`` from ``json()`` on a body that is not JSON). All are
``ClientError``. A request that finds its pooled connection closed by the
server before any byte of the answer is sent once more on a new connection.

WebSocket client (``ClientSession.ws_connect``): RFC 6455 over the same
streams, with the frame codec of ``serving/websocket.py`` (header layout,
masking). Text and binary messages; a binary message can be given in parts
(a KV blob's header and its page bytes), masked into one buffer; fragmented
server messages are reassembled; pings are answered. ``heartbeat=s`` pings
every ``s`` seconds and closes the socket when no pong came within ``s/2``,
as aiohttp's does.

WebSocket server (``WebSocketResponse``, aiohttp's ``web`` name): a
handler's ``await ws.prepare(request)`` checks the upgrade request
(``serving.websocket.handshake_headers``: a request that is no version-13
upgrade answers 400), answers 101 with ``Sec-WebSocket-Accept`` and takes
the connection over; ``async for msg in ws`` then gives the client's
messages (masked frames required, unmasked ones a protocol error, close
1002) as the client end does, and the sends write unmasked frames. The
connection closes when the handler returns. ``ClientTimeout(sock_read=s)``
bounds each read of a response body (an SSE stream's gap between frames).
"""

from __future__ import annotations

import asyncio
import base64
import enum
import json
import os
import re
import struct
import time
from email.utils import formatdate
from http import HTTPStatus
from typing import Any, Awaitable, Callable, Generic, TypeVar
from urllib.parse import parse_qsl, unquote, urlsplit

from agentfield_tpu_torch.logging import get_logger
from agentfield_tpu_torch.serving import websocket as _ws

log = get_logger("http")

MAX_LINE = 8190  # one request or header line, as aiohttp's parser allows
MAX_HEADERS = 32768  # the whole header block
KEEPALIVE_S = 75.0  # an idle server connection closes after this long
SHUTDOWN_S = 60.0  # AppRunner.cleanup waits this long for running handlers


def aio_timeout(delay: float | None):
    """``async with aio_timeout(t):`` raises the builtin TimeoutError at
    the deadline (``asyncio.timeout``; Python >= 3.11)."""
    return asyncio.timeout(delay)


class Headers:
    """Case-insensitive header mapping that keeps the names as received
    (``items()`` gives them so); ``get`` and ``[]`` give the first value."""

    def __init__(self, items=()):
        self._items: list[tuple[str, str]] = []
        self._index: dict[str, str] = {}
        for k, v in (items.items() if isinstance(items, dict) else items):
            self.add(k, v)

    def add(self, name: str, value: str) -> None:
        self._items.append((name, value))
        self._index.setdefault(name.lower(), value)

    def get(self, name: str, default=None):
        return self._index.get(name.lower(), default)

    def __getitem__(self, name: str) -> str:
        return self._index[name.lower()]

    def __contains__(self, name) -> bool:
        return isinstance(name, str) and name.lower() in self._index

    def items(self):
        return list(self._items)


def _reason(status: int) -> str:
    try:
        return HTTPStatus(status).phrase
    except ValueError:
        return "Unknown"


async def _read_line(reader: asyncio.StreamReader) -> bytes:
    """One CRLF-terminated line, without its terminator; b"" at EOF."""
    try:
        line = await reader.readuntil(b"\n")
    except asyncio.IncompleteReadError as e:
        if e.partial:
            raise ConnectionResetError("connection closed mid-line") from None
        return b""
    except asyncio.LimitOverrunError:
        raise ValueError("line too long") from None
    if len(line) > MAX_LINE + 2:
        raise ValueError("line too long")
    return line.rstrip(b"\r\n")


async def _read_headers(reader: asyncio.StreamReader) -> Headers:
    headers, total = Headers(), 0
    while True:
        line = await _read_line(reader)
        if not line:
            return headers
        total += len(line)
        if total > MAX_HEADERS:
            raise ValueError("header block too large")
        name, sep, value = line.decode("latin-1").partition(":")
        if not sep or not name or name != name.strip():
            raise ValueError(f"invalid header line {line[:40]!r}")
        headers.add(name, value.strip())


async def _read_chunked(reader: asyncio.StreamReader, limit: int | None = None):
    """Yield the decoded chunks of a chunked body, then read its trailer."""
    got = 0
    while True:
        size_line = await _read_line(reader)
        try:
            n = int(size_line.split(b";", 1)[0].strip(), 16)
        except ValueError:
            raise ValueError(f"invalid chunk size {size_line[:20]!r}") from None
        if n == 0:
            while await _read_line(reader):
                pass  # trailer fields
            return
        got += n
        if limit is not None and got >= limit:
            raise _TooLarge(got)
        try:
            data = await reader.readexactly(n)
            await reader.readexactly(2)
        except asyncio.IncompleteReadError:
            raise ConnectionResetError("connection closed mid-chunk") from None
        yield data


class _TooLarge(Exception):
    def __init__(self, size: int):
        super().__init__(size)
        self.size = size


# ===========================================================================
# Server


class HTTPException(Exception):
    """An answer raised instead of returned: the connection renders it as a
    plain-text response (aiohttp's ``web.HTTPException`` texts)."""

    def __init__(self, status: int, text: str | None = None, headers=None):
        self.status = status
        self.text = f"{status}: {_reason(status)}" if text is None else text
        self.headers = dict(headers or {})
        super().__init__(self.text)

    def response(self) -> "Response":
        return Response(status=self.status, text=self.text, headers=self.headers)


class AppKey(Generic[TypeVar("T")]):
    """A typed key of an ``Application``'s state (aiohttp's ``AppKey``)."""

    def __init__(self, name: str):
        self.name = name

    def __repr__(self) -> str:
        return f"<AppKey({self.name})>"


class Request:
    """One parsed request. The body is read on demand (``read``, ``text``,
    ``json``); one past the application's ``client_max_size`` raises a 413."""

    def __init__(self, app: "Application", method: str, target: str, version: str,
                 headers: Headers, reader: asyncio.StreamReader, remote: str | None):
        self.app = app
        self.method = method
        self.headers = headers
        self.raw_path = target
        parts = urlsplit(target)
        self.path = unquote(parts.path)
        self._raw_path_only = parts.path
        q: dict[str, str] = {}
        for k, v in parse_qsl(parts.query, keep_blank_values=True):
            q.setdefault(k, v)  # the first value, as a MultiDict's get() gives
        self.query = q
        self.match_info: dict[str, str] = {}
        self.remote = remote
        self._reader = reader
        self._body: bytes | None = None
        self._consumed = False  # the body's bytes are off the connection
        self._stream: StreamResponse | None = None  # the response prepare()d on it
        te = (headers.get("Transfer-Encoding") or "").lower()
        self._chunked = "chunked" in te
        try:
            self.content_length = int(headers.get("Content-Length") or 0) if not self._chunked else None
        except ValueError:
            raise HTTPException(400, "Invalid Content-Length") from None
        if self.content_length is not None and self.content_length < 0:
            raise HTTPException(400, "Invalid Content-Length")

    @property
    def body_exists(self) -> bool:
        return self._chunked or bool(self.content_length)

    can_read_body = body_exists

    async def read(self) -> bytes:
        if self._body is not None:
            return self._body
        limit = self.app._client_max_size
        if self._chunked:
            buf = bytearray()
            try:
                async for chunk in _read_chunked(self._reader, limit):
                    buf += chunk
            except _TooLarge as e:
                raise HTTPException(413, f"Maximum request body size {limit} exceeded, "
                                         f"actual body size {e.size}") from None
            self._body = bytes(buf)
        else:
            n = self.content_length or 0
            if limit and n >= limit:
                raise HTTPException(413, f"Maximum request body size {limit} exceeded, "
                                         f"actual body size {n}")
            try:
                self._body = await self._reader.readexactly(n) if n else b""
            except asyncio.IncompleteReadError:
                raise ConnectionResetError("client closed mid-body") from None
        self._consumed = True
        return self._body

    async def text(self) -> str:
        return (await self.read()).decode("utf-8")

    async def json(self, loads=json.loads) -> Any:
        return loads(await self.text())

    async def _discard_body(self) -> bool:
        """Read off an unread body so the connection can carry the next
        request; False when it cannot (too large: the connection closes)."""
        if self._consumed:
            return True
        if self._chunked or (self.content_length or 0) > (1 << 20):
            return False
        try:
            await self.read()
        except (HTTPException, ConnectionError, ValueError):
            return False
        return True


class StreamResponse:
    """A response whose body the handler writes after ``prepare``: chunked,
    ended by ``write_eof`` (or by the server once the handler returns)."""

    def __init__(self, status: int = 200, reason: str | None = None, headers=None):
        self.status = status
        self.reason = reason
        self.headers = Headers(headers or {})
        self._writer: asyncio.StreamWriter | None = None
        self._eof = False
        self.prepared = False

    async def prepare(self, request: Request) -> "StreamResponse":
        if self.prepared:
            return self
        self._writer = request._conn_writer  # type: ignore[attr-defined]
        request._stream = self
        hdrs = [(k, v) for k, v in self.headers.items()
                if k.lower() not in ("content-length", "transfer-encoding")]
        hdrs.append(("Transfer-Encoding", "chunked"))
        self._writer.write(_head(self.status, self.reason, hdrs))
        self.prepared = True
        await self._drain()
        return self

    async def _drain(self) -> None:
        w = self._writer
        if w is None or w.is_closing():
            raise ConnectionResetError("Cannot write to closing transport")
        await w.drain()

    async def write(self, data: bytes) -> None:
        if not self.prepared:
            raise RuntimeError("StreamResponse.write before prepare()")
        if self._eof:
            raise RuntimeError("write after write_eof()")
        if not data:
            return
        w = self._writer
        if w is None or w.is_closing():
            raise ConnectionResetError("Cannot write to closing transport")
        w.write(b"%x\r\n" % len(data) + bytes(data) + b"\r\n")
        await self._drain()

    async def write_eof(self) -> None:
        if self._eof or not self.prepared:
            return
        self._eof = True
        w = self._writer
        if w is not None and not w.is_closing():
            w.write(b"0\r\n\r\n")
            try:
                await w.drain()
            except ConnectionError:
                pass


class Response:
    """A whole response: ``text`` (utf-8, ``text/plain`` unless
    ``content_type`` says otherwise) or raw ``body`` bytes."""

    def __init__(self, status: int = 200, text: str | None = None, body: bytes | None = None,
                 content_type: str | None = None, headers=None, reason: str | None = None):
        self.status = status
        self.reason = reason
        self.headers = Headers(headers or {})
        if text is not None:
            self.body = text.encode("utf-8")
            ctype = content_type or "text/plain"
            if "charset" not in ctype:
                ctype += "; charset=utf-8"
            if "Content-Type" not in self.headers:
                self.headers.add("Content-Type", ctype)
        else:
            self.body = bytes(body or b"")
            if content_type and "Content-Type" not in self.headers:
                self.headers.add("Content-Type", content_type)
            elif self.body and "Content-Type" not in self.headers:
                self.headers.add("Content-Type", "application/octet-stream")

    @property
    def text(self) -> str:
        return self.body.decode("utf-8")


def json_response(data: Any, status: int = 200, headers=None,
                  dumps: Callable[[Any], str] = json.dumps) -> Response:
    return Response(status=status, text=dumps(data), content_type="application/json",
                    headers=headers)


def _head(status: int, reason: str | None, headers) -> bytes:
    lines = [f"HTTP/1.1 {status} {reason or _reason(status)}"]
    lines += [f"{k}: {v}" for k, v in headers]
    lines.append(f"Date: {formatdate(usegmt=True)}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


Handler = Callable[[Request], Awaitable[Any]]
_PARAM = re.compile(r"\{([A-Za-z_][A-Za-z0-9_]*)(?::([^{}]*(?:\{[^{}]*\}[^{}]*)*))?\}")


def _compile(path: str) -> re.Pattern:
    """A route path to a regex over the raw (still percent-encoded) path."""
    out, pos = [], 0
    for m in _PARAM.finditer(path):
        out.append(re.escape(path[pos:m.start()]))
        out.append(f"(?P<{m.group(1)}>{m.group(2) or '[^{}/]+'})")
        pos = m.end()
    out.append(re.escape(path[pos:]))
    return re.compile("^" + "".join(out) + "$")


class RouteTableDef:
    """Decorators that collect routes (``@routes.get(path)``)."""

    def __init__(self):
        self._items: list[tuple[str, str, Handler]] = []

    def route(self, method: str, path: str):
        def deco(handler: Handler) -> Handler:
            self._items.append((method.upper(), path, handler))
            return handler
        return deco

    def get(self, path: str):
        return self.route("GET", path)

    def post(self, path: str):
        return self.route("POST", path)

    def delete(self, path: str):
        return self.route("DELETE", path)

    def __iter__(self):
        return iter(self._items)


class Router:
    def __init__(self):
        self._routes: list[tuple[str, re.Pattern, Handler]] = []

    def add_route(self, method: str, path: str, handler: Handler) -> None:
        self._routes.append((method.upper(), _compile(path), handler))

    def resolve(self, method: str, raw_path: str) -> tuple[Handler, dict[str, str]]:
        allowed: list[str] = []
        for m, rx, handler in self._routes:
            hit = rx.match(raw_path)
            if hit is None:
                continue
            if m != method:
                if m not in allowed:
                    allowed.append(m)
                continue
            return handler, {k: unquote(v) for k, v in hit.groupdict().items()}
        if allowed:
            raise HTTPException(405, headers={"Allow": ",".join(allowed)})
        raise HTTPException(404)


class Application(dict):
    """Routes, shared state (``app[key]``) and the startup/cleanup hooks."""

    def __init__(self, client_max_size: int = 1024 ** 2):
        super().__init__()
        self._client_max_size = client_max_size
        self.router = Router()
        self.on_startup: list[Callable[["Application"], Awaitable[None]]] = []
        self.on_cleanup: list[Callable[["Application"], Awaitable[None]]] = []

    def add_routes(self, routes) -> None:
        for method, path, handler in routes:
            self.router.add_route(method, path, handler)


class _ServerConn:
    __slots__ = ("task", "writer", "busy")

    def __init__(self, task, writer):
        self.task, self.writer, self.busy = task, writer, False


class AppRunner:
    """Runs an application's hooks and owns its sites' connections."""

    def __init__(self, app: Application, shutdown_timeout: float = SHUTDOWN_S,
                 keepalive_timeout: float = KEEPALIVE_S):
        self.app = app
        self.shutdown_timeout = shutdown_timeout
        self.keepalive_timeout = keepalive_timeout
        self._sites: list["TCPSite"] = []
        self._conns: set[_ServerConn] = set()
        self._closing = False

    @property
    def addresses(self) -> list[tuple[str, int]]:
        return [s.address for s in self._sites if s.address is not None]

    async def setup(self) -> None:
        for hook in self.app.on_startup:
            await hook(self.app)

    async def cleanup(self) -> None:
        """Stop listening, close idle connections, wait up to
        ``shutdown_timeout`` for running handlers, cancel the rest, then run
        the cleanup hooks."""
        self._closing = True
        for site in list(self._sites):
            await site.stop()
        for c in list(self._conns):
            if not c.busy:
                c.writer.close()
        tasks = [c.task for c in self._conns]
        if tasks:
            _, pending = await asyncio.wait(tasks, timeout=self.shutdown_timeout)
            for t in pending:
                t.cancel()
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)
        for hook in self.app.on_cleanup:
            await hook(self.app)

    async def _serve(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        conn = _ServerConn(asyncio.current_task(), writer)
        self._conns.add(conn)
        peer = writer.get_extra_info("peername")
        remote = peer[0] if isinstance(peer, tuple) else None
        try:
            while not self._closing:
                try:
                    async with asyncio.timeout(self.keepalive_timeout):
                        line = await _read_line(reader)
                except (TimeoutError, ConnectionError, ValueError):
                    return
                if not line:
                    return  # the client closed between requests
                conn.busy = True
                keep = await self._one(line, reader, writer, remote)
                conn.busy = False
                if not keep or self._closing:
                    return
        except asyncio.CancelledError:
            pass
        finally:
            self._conns.discard(conn)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _one(self, line: bytes, reader, writer, remote) -> bool:
        """Answer one request; True to keep the connection for the next."""
        try:
            method, target, version = line.decode("latin-1").split(" ")
            if not version.startswith("HTTP/1."):
                raise ValueError(version)
            headers = await _read_headers(reader)
        except (ValueError, UnicodeDecodeError):
            writer.write(_plain(400, "Bad Request", close=True))
            await _drain_quietly(writer)
            return False
        except ConnectionError:
            return False
        conn_hdr = (headers.get("Connection") or "").lower()
        keep = "close" not in conn_hdr and (version == "HTTP/1.1" or "keep-alive" in conn_hdr)
        try:
            req = Request(self.app, method, target, version, headers, reader, remote)
        except HTTPException as e:
            writer.write(_plain(e.status, e.text, close=True))
            await _drain_quietly(writer)
            return False
        req._conn_writer = writer  # type: ignore[attr-defined]
        try:
            handler, req.match_info = self.app.router.resolve(method, req._raw_path_only)
            resp = await handler(req)
        except HTTPException as e:
            if req._stream is not None:  # a head is out: no second response
                log.error("HTTP error after a stream was prepared", method=method,
                          path=req.path, status=e.status)
                return False
            resp = e.response()
        except ConnectionError:
            return False
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("error handling request", method=method, path=req.path)
            if req._stream is not None:  # mid-stream: drop the connection, as aiohttp does
                return False
            resp = Response(status=500, text="500 Internal Server Error\n\nServer got itself in trouble")
            keep = False
        if isinstance(resp, WebSocketResponse):
            if resp._hb_task is not None:
                resp._hb_task.cancel()
            if not resp.closed:
                await resp.close()
            return False
        if isinstance(resp, StreamResponse):
            if not resp.prepared:
                await resp.prepare(req)
            await resp.write_eof()
        elif isinstance(resp, Response):
            hdrs = [(k, v) for k, v in resp.headers.items()
                    if k.lower() not in ("content-length", "transfer-encoding", "connection")]
            hdrs.append(("Content-Length", str(len(resp.body))))
            if not keep:
                hdrs.append(("Connection", "close"))
            if writer.is_closing():
                return False
            writer.write(_head(resp.status, resp.reason, hdrs) + resp.body)
        else:
            raise TypeError(f"handler returned {type(resp).__name__}, not a response")
        if not await _drain_quietly(writer):
            return False
        return keep and await req._discard_body()


def _plain(status: int, text: str, close: bool = False) -> bytes:
    body = text.encode()
    hdrs = [("Content-Type", "text/plain; charset=utf-8"), ("Content-Length", str(len(body)))]
    if close:
        hdrs.append(("Connection", "close"))
    return _head(status, None, hdrs) + body


async def _drain_quietly(writer: asyncio.StreamWriter) -> bool:
    try:
        await writer.drain()
        return not writer.is_closing()
    except (ConnectionError, OSError):
        return False


class TCPSite:
    def __init__(self, runner: AppRunner, host: str = "0.0.0.0", port: int = 8080):
        self.runner = runner
        self.host, self.port = host, port
        self.address: tuple[str, int] | None = None
        self._server: asyncio.base_events.Server | None = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(self.runner._serve, self.host, self.port,
                                                  limit=MAX_HEADERS * 2)
        self.address = self._server.sockets[0].getsockname()[:2]
        self.runner._sites.append(self)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            self._server = None
        if self in self.runner._sites:
            self.runner._sites.remove(self)


# ===========================================================================
# Client


class ClientError(Exception):
    """Every client failure."""


class ClientConnectionError(ClientError):
    pass


class ClientOSError(ClientConnectionError, OSError):
    pass


class ClientConnectorError(ClientOSError):
    """The connection could not be opened (refused, unreachable)."""


class ServerDisconnectedError(ClientConnectionError):
    """The server closed or reset the connection before the answer was whole."""


class ServerTimeoutError(ClientConnectionError, asyncio.TimeoutError):
    """The request's ``ClientTimeout`` ran out."""


class ClientResponseError(ClientError):
    def __init__(self, status: int, message: str = ""):
        super().__init__(f"{status}, message={message!r}")
        self.status = status
        self.message = message


class ContentTypeError(ClientResponseError):
    pass


class WSServerHandshakeError(ClientResponseError):
    pass


class ClientTimeout:
    """``total``: the whole request, body included; ``connect`` and
    ``sock_connect``: opening the connection; ``sock_read``: each read of
    the response body. None is unbounded."""

    __slots__ = ("total", "connect", "sock_connect", "sock_read")

    def __init__(self, total: float | None = None, connect: float | None = None,
                 sock_connect: float | None = None, sock_read: float | None = None):
        self.total, self.connect, self.sock_connect = total, connect, sock_connect
        self.sock_read = sock_read


DEFAULT_TIMEOUT = ClientTimeout(total=300.0, sock_connect=30.0)


class TCPConnector:
    """The pool's bounds: ``limit`` connections in all, ``limit_per_host``
    to one host (0: unbounded), idle ones kept ``keepalive_timeout`` s."""

    def __init__(self, limit: int = 100, limit_per_host: int = 0, keepalive_timeout: float = 15.0):
        self.limit = limit
        self.limit_per_host = limit_per_host
        self.keepalive_timeout = keepalive_timeout
        self._idle: dict[tuple[str, int], list[tuple[float, Any, Any]]] = {}
        self._total: asyncio.Semaphore | None = None
        self._per_host: dict[tuple[str, int], asyncio.Semaphore] = {}

    def _sems(self, key):
        if self._total is None:
            self._total = asyncio.Semaphore(self.limit or 1 << 30)
        sem = self._per_host.get(key)
        if sem is None:
            sem = self._per_host[key] = asyncio.Semaphore(self.limit_per_host or 1 << 30)
        return self._total, sem

    def _take_idle(self, key):
        idle = self._idle.get(key) or []
        t = time.monotonic()
        while idle:
            since, reader, writer = idle.pop()
            if t - since < self.keepalive_timeout and not writer.is_closing() and not reader.at_eof():
                return reader, writer
            writer.close()
        return None

    def _put_idle(self, key, reader, writer) -> None:
        self._idle.setdefault(key, []).append((time.monotonic(), reader, writer))

    def close(self) -> None:
        for idle in self._idle.values():
            for _, _, w in idle:
                w.close()
        self._idle.clear()


class _ClientConn:
    """One client connection held by one request."""

    __slots__ = ("key", "reader", "writer", "reused", "release_cb")

    def __init__(self, key, reader, writer, reused, release_cb):
        self.key, self.reader, self.writer = key, reader, writer
        self.reused, self.release_cb = reused, release_cb


class StreamReader:
    """A response body read in pieces (``resp.content``): ``read``,
    ``readline``, ``readany`` and ``async for line``."""

    def __init__(self, resp: "ClientResponse"):
        self._resp = resp
        self._buf = bytearray()
        self._eof = False

    async def _more(self) -> bool:
        if self._eof:
            return False
        data = await self._resp._next_piece()
        if not data:
            self._eof = True
            return False
        self._buf += data
        return True

    async def readany(self) -> bytes:
        if not self._buf:
            await self._more()
        out = bytes(self._buf)
        self._buf.clear()
        return out

    async def read(self, n: int = -1) -> bytes:
        if n < 0:
            while await self._more():
                pass
            out = bytes(self._buf)
            self._buf.clear()
            return out
        while len(self._buf) < n and await self._more():
            pass
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    async def readline(self) -> bytes:
        while True:
            i = self._buf.find(b"\n")
            if i >= 0:
                out = bytes(self._buf[: i + 1])
                del self._buf[: i + 1]
                return out
            if not await self._more():
                out = bytes(self._buf)
                self._buf.clear()
                return out

    def __aiter__(self):
        return self

    async def __anext__(self) -> bytes:
        line = await self.readline()
        if not line:
            raise StopAsyncIteration
        return line


class ClientResponse:
    def __init__(self, method: str, url: str, status: int, reason: str, headers: Headers,
                 conn: _ClientConn, deadline: float | None, keep: bool):
        self.method, self.url = method, url
        self.status, self.reason, self.headers = status, reason, headers
        self._conn: _ClientConn | None = conn
        self._deadline = deadline
        self._sock_read: float | None = None  # the request's ClientTimeout.sock_read
        self._keep = keep
        self._body: bytes | None = None
        self._done = False  # the body's bytes are all off the connection
        te = (headers.get("Transfer-Encoding") or "").lower()
        self._chunks = _read_chunked(conn.reader) if "chunked" in te else None
        cl = headers.get("Content-Length")
        self._left: int | None = int(cl) if cl is not None and self._chunks is None else None
        if method == "HEAD" or status in (204, 304) or 100 <= status < 200:
            self._left = 0
        if self._chunks is None and self._left is None:
            self._keep = False  # read to EOF
        self._done = self._left == 0  # an empty body: the connection is free now
        self.content = StreamReader(self)

    @property
    def content_type(self) -> str:
        return (self.headers.get("Content-Type") or "application/octet-stream").split(";")[0].strip()

    async def _timed(self, aw):
        left = None if self._deadline is None else self._deadline - time.monotonic()
        if self._sock_read is not None:
            left = self._sock_read if left is None else min(left, self._sock_read)
        if left is None:
            return await aw
        try:
            return await asyncio.wait_for(aw, max(left, 0.0))
        except TimeoutError:
            self.close()
            raise ServerTimeoutError(f"request to {self.url} timed out") from None

    async def _next_piece(self) -> bytes:
        """The next decoded piece of the body; b"" at its end."""
        conn = self._conn
        if self._done or conn is None:
            return b""
        try:
            if self._chunks is not None:
                try:
                    data = await self._timed(self._chunks.__anext__())
                except StopAsyncIteration:
                    data = b""
            elif self._left is not None:
                if self._left == 0:
                    data = b""
                else:
                    data = await self._timed(conn.reader.read(min(self._left, 1 << 20)))
                    if not data:
                        raise ConnectionResetError("connection closed mid-body")
                    self._left -= len(data)
            else:
                data = await self._timed(conn.reader.read(1 << 20))
        except (ConnectionError, asyncio.IncompleteReadError, ValueError) as e:
            self.close()
            raise ServerDisconnectedError(f"{self.url}: {e!r}") from None
        if not data:
            self._done = True
            self.release()
        return data

    async def read(self) -> bytes:
        if self._body is None:
            self._body = await self.content.read()
        return self._body

    async def text(self, encoding: str = "utf-8") -> str:
        return (await self.read()).decode(encoding, "replace")

    async def json(self, content_type: str | None = "application/json", loads=json.loads) -> Any:
        body = await self.read()
        if content_type and content_type not in self.content_type:
            raise ContentTypeError(
                self.status, f"Attempt to decode JSON with unexpected mimetype: {self.content_type}")
        text = body.decode("utf-8").strip()
        return loads(text) if text else None

    def raise_for_status(self) -> None:
        if self.status >= 400:
            self.release()
            raise ClientResponseError(self.status, self.reason)

    def release(self) -> None:
        """Give the connection back to the pool when the body was read
        whole on a keep-alive connection; close it otherwise."""
        conn, self._conn = self._conn, None
        if conn is not None:
            conn.release_cb(conn, self._done and self._keep)

    def close(self) -> None:
        conn, self._conn = self._conn, None
        if conn is not None:
            conn.release_cb(conn, False)

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        self.release()


class _RequestContextManager:
    """``async with session.post(...) as resp`` or ``await session.post(...)``."""

    def __init__(self, coro):
        self._coro = coro
        self._resp = None

    def __await__(self):
        return self._coro.__await__()

    async def __aenter__(self):
        self._resp = await self._coro
        return self._resp

    async def __aexit__(self, *exc):
        if self._resp is not None:
            self._resp.release()


class ClientSession:
    def __init__(self, base_url: str | None = None, timeout: ClientTimeout | None = None,
                 connector: TCPConnector | None = None, headers: dict | None = None):
        self._base = base_url.rstrip("/") if base_url else None
        self.timeout = timeout or DEFAULT_TIMEOUT
        self.connector = connector or TCPConnector()
        self._default_headers = dict(headers or {})
        self._closed = False
        self._ws: set["ClientWebSocketResponse"] = set()

    @property
    def closed(self) -> bool:
        return self._closed

    async def close(self) -> None:
        self._closed = True
        for ws in list(self._ws):
            await ws.close()
        self.connector.close()

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        await self.close()

    def _url(self, url: str):
        if self._base is not None and url.startswith("/"):
            url = self._base + url
        parts = urlsplit(url)
        if parts.scheme not in ("http", "ws"):
            raise ClientError(f"unsupported URL scheme in {url!r}")
        host = parts.hostname or "127.0.0.1"
        port = parts.port or 80
        path = parts.path or "/"
        if parts.query:
            path += "?" + parts.query
        return url, host, port, path

    async def _open(self, host: str, port: int, timeout: ClientTimeout, deadline):
        limit = timeout.sock_connect or timeout.connect
        if deadline is not None:
            left = max(deadline - time.monotonic(), 0.0)
            limit = left if limit is None else min(limit, left)
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(host, port, limit=1 << 20), limit)
        except TimeoutError:
            raise ServerTimeoutError(f"connection to {host}:{port} timed out") from None
        except OSError as e:
            raise ClientConnectorError(e.errno, f"cannot connect to {host}:{port}: {e}") from None
        sock = writer.get_extra_info("socket")
        if sock is not None:
            import socket as _socket
            sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        return reader, writer

    def request(self, method: str, url: str, *, json: Any = None, data: Any = None,
                headers: dict | None = None,
                timeout: ClientTimeout | None = None) -> _RequestContextManager:
        return _RequestContextManager(self._request(method, url, json, data, headers, timeout))

    def get(self, url: str, **kw) -> _RequestContextManager:
        return self.request("GET", url, **kw)

    def post(self, url: str, **kw) -> _RequestContextManager:
        return self.request("POST", url, **kw)

    def delete(self, url: str, **kw) -> _RequestContextManager:
        return self.request("DELETE", url, **kw)

    async def _request(self, method, url, json_body, data, headers, timeout):
        if self._closed:
            raise RuntimeError("Session is closed")
        timeout = timeout or self.timeout
        deadline = time.monotonic() + timeout.total if timeout.total is not None else None
        url, host, port, path = self._url(url)
        hdrs = Headers({**self._default_headers, **(headers or {})})
        if json_body is not None:
            body = json.dumps(json_body).encode()
            if "Content-Type" not in hdrs:
                hdrs.add("Content-Type", "application/json")
        elif data is not None:
            body = data.encode() if isinstance(data, str) else bytes(data)
        else:
            body = b""
        lines = [f"{method} {path} HTTP/1.1", f"Host: {host}:{port}"]
        lines += [f"{k}: {v}" for k, v in hdrs.items()
                  if k.lower() not in ("host", "content-length", "connection")]
        if body or method in ("POST", "PUT", "PATCH"):
            lines.append(f"Content-Length: {len(body)}")
        raw = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body
        key = (host, port)
        total, per_host = self.connector._sems(key)
        for attempt in (0, 1):
            try:
                async with asyncio.timeout(None if deadline is None
                                           else max(deadline - time.monotonic(), 0.0)):
                    await total.acquire()
                    try:
                        await per_host.acquire()
                    except BaseException:
                        total.release()
                        raise
            except TimeoutError:
                raise ServerTimeoutError(f"no free connection to {host}:{port} in time") from None
            conn = None
            try:
                pooled = self.connector._take_idle(key) if attempt == 0 else None
                if pooled is not None:
                    reader, writer = pooled
                else:
                    reader, writer = await self._open(host, port, timeout, deadline)
                conn = _ClientConn(key, reader, writer, pooled is not None, self._release_fn(total, per_host))
                resp = await self._exchange(method, url, raw, conn, deadline)
                resp._sock_read = timeout.sock_read
                return resp
            except _StaleConnection:
                conn.release_cb(conn, False)
                continue
            except BaseException:
                if conn is not None:
                    conn.release_cb(conn, False)
                else:
                    total.release()
                    per_host.release()
                raise
        raise ServerDisconnectedError(f"{url}: server closed the connection")

    def _release_fn(self, total, per_host):
        def release(conn: _ClientConn, reuse: bool) -> None:
            if conn.release_cb is None:
                return
            conn.release_cb = None
            if reuse and not self._closed and not conn.writer.is_closing():
                self.connector._put_idle(conn.key, conn.reader, conn.writer)
            else:
                conn.writer.close()
            total.release()
            per_host.release()
        return release

    async def _exchange(self, method, url, raw, conn: _ClientConn, deadline) -> ClientResponse:
        async def go():
            try:
                conn.writer.write(raw)
                await conn.writer.drain()
            except (ConnectionError, OSError):
                if conn.reused:  # the request never reached a live server
                    raise _StaleConnection() from None
                raise
            # once the request is written, the server may have read and run
            # it: only an idempotent method is sent again (as aiohttp does);
            # a POST surfaces the drop to the caller's own retry logic
            retry = conn.reused and method in _IDEMPOTENT
            try:
                status_line = await _read_line(conn.reader)
            except (ConnectionError, OSError):
                if retry:
                    raise _StaleConnection() from None
                raise
            if not status_line:
                if retry:
                    raise _StaleConnection()
                raise ConnectionResetError("server closed the connection")
            while True:
                parts = status_line.decode("latin-1").split(" ", 2)
                if len(parts) < 2 or not parts[0].startswith("HTTP/1."):
                    raise ValueError(f"bad status line {status_line[:60]!r}")
                status = int(parts[1])
                headers = await _read_headers(conn.reader)
                if status != 100:
                    break
                status_line = await _read_line(conn.reader)
            keep = (parts[0] == "HTTP/1.1"
                    and "close" not in (headers.get("Connection") or "").lower())
            return ClientResponse(method, url, status, parts[2] if len(parts) > 2 else "",
                                  headers, conn, deadline, keep)
        try:
            if deadline is None:
                return await go()
            return await asyncio.wait_for(go(), max(deadline - time.monotonic(), 0.0))
        except _StaleConnection:
            raise
        except TimeoutError:
            raise ServerTimeoutError(f"request to {url} timed out") from None
        except (ConnectionError, OSError, asyncio.IncompleteReadError, ValueError) as e:
            raise ServerDisconnectedError(f"{url}: {e!r}") from None

    async def ws_connect(self, url: str, heartbeat: float | None = None,
                         timeout: float = 10.0) -> "ClientWebSocketResponse":
        url, host, port, path = self._url(url)
        t = self.timeout
        reader, writer = await self._open(host, port, t, time.monotonic() + timeout)
        try:
            key = base64.b64encode(os.urandom(16)).decode()
            writer.write((f"GET {path} HTTP/1.1\r\nHost: {host}:{port}\r\nUpgrade: websocket\r\n"
                          f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                          "Sec-WebSocket-Version: 13\r\n\r\n").encode())
            async with asyncio.timeout(timeout):
                await writer.drain()
                status_line = await _read_line(reader)
                headers = await _read_headers(reader)
            parts = status_line.decode("latin-1").split(" ", 2)
            if len(parts) < 2 or parts[1] != "101":
                raise WSServerHandshakeError(int(parts[1]) if len(parts) > 1 and parts[1].isdigit()
                                             else 0, f"Invalid response status: {status_line!r}")
            if headers.get("Sec-WebSocket-Accept") != _ws.accept_key(key):
                raise WSServerHandshakeError(101, "Invalid challenge response")
            if headers.get("Sec-WebSocket-Extensions"):
                raise WSServerHandshakeError(101, "an extension was negotiated that was not offered")
        except TimeoutError:
            writer.close()
            raise ServerTimeoutError(f"websocket handshake with {url} timed out") from None
        except (ConnectionError, OSError, ValueError) as e:
            writer.close()
            raise ServerDisconnectedError(f"{url}: {e!r}") from None
        except BaseException:
            writer.close()
            raise
        ws = ClientWebSocketResponse(reader, writer, heartbeat, self._ws)
        self._ws.add(ws)
        return ws


class _StaleConnection(Exception):
    """A pooled connection the server had closed: send again on a new one."""


_IDEMPOTENT = frozenset({"GET", "HEAD", "OPTIONS", "PUT", "DELETE", "TRACE"})


# ===========================================================================
# WebSocket client


class WSMsgType(enum.IntEnum):
    CONTINUATION = 0x0
    TEXT = 0x1
    BINARY = 0x2
    PING = 0x9
    PONG = 0xA
    CLOSE = 0x8
    CLOSING = 0x100
    CLOSED = 0x101
    ERROR = 0x102


class WSMessage:
    __slots__ = ("type", "data", "extra")

    def __init__(self, type: WSMsgType, data: Any = None, extra: Any = None):
        self.type, self.data, self.extra = type, data, extra

    def json(self, loads: Callable[[str], Any] = json.loads) -> Any:
        """A TEXT message's JSON document (aiohttp's ``WSMessage.json``)."""
        return loads(self.data)

    def __repr__(self) -> str:
        return f"WSMessage({self.type.name}, {len(self.data) if self.data else 0} bytes)"


async def _ws_read_frame(reader: asyncio.StreamReader,
                         masked: bool = False) -> tuple[bool, int, bytes]:
    """(fin, opcode, unmasked payload) of the peer's next frame: a client
    reads unmasked server frames, a server (``masked``) masked client
    frames; the checks of ``serving.websocket.read_frame`` on an asyncio
    stream."""
    b0, b1 = await reader.readexactly(2)
    fin, opcode = bool(b0 & 0x80), b0 & 0x0F
    if b0 & 0x70:
        raise _ws.ProtocolError("reserved bits set without a negotiated extension")
    if opcode not in _ws.DATA_OPS + _ws.CONTROL_OPS + (_ws.OP_CONT,):
        raise _ws.ProtocolError(f"unknown opcode {opcode:#x}")
    if bool(b1 & 0x80) != masked:
        raise _ws.ProtocolError("client frames must be masked, server frames must not")
    n = b1 & 0x7F
    if n == 126:
        n = struct.unpack("!H", await reader.readexactly(2))[0]
    elif n == 127:
        n = struct.unpack("!Q", await reader.readexactly(8))[0]
        if n >> 63:
            raise _ws.ProtocolError("64-bit length with its top bit set")
    if opcode in _ws.CONTROL_OPS and (not fin or n > 125):
        raise _ws.ProtocolError("control frames are unfragmented and at most 125 bytes")
    if n > _ws.MAX_MESSAGE:
        raise _ws.ProtocolError(f"frame of {n} bytes", code=1009)
    key = await reader.readexactly(4) if masked else None
    payload = await reader.readexactly(n) if n else b""
    if key is not None and n:
        payload = _ws._mask(payload, key)
    return fin, opcode, payload


class ClientWebSocketResponse:
    """The client end of one WebSocket. ``async for msg in ws`` gives TEXT
    and BINARY messages and ends when the connection closes; sends raise
    ``ConnectionResetError`` on a closed connection."""

    _client = True  # masks its frames, reads unmasked ones

    def __init__(self, reader, writer, heartbeat: float | None, registry: set):
        self._reader, self._writer = reader, writer
        self._registry = registry
        self._closed = False
        self.close_code: int | None = None
        self._send_lock = asyncio.Lock()
        self._pong = asyncio.Event()
        self._hb_task = (asyncio.create_task(self._heartbeat(heartbeat))
                         if heartbeat else None)
        self._exception: BaseException | None = None

    @property
    def closed(self) -> bool:
        return self._closed

    async def _send(self, opcode: int, *parts) -> None:
        if self._closed or self._writer is None or self._writer.is_closing():
            raise ConnectionResetError("Cannot write to closing transport")
        n = sum(len(p) for p in parts)
        if self._client:
            key = os.urandom(4)
            bufs = [_ws.frame_header(opcode, n, True, key)]
            if n:
                bufs.append(memoryview(_ws._mask_parts(parts, key)))
        else:
            bufs = [_ws.frame_header(opcode, n), *(p for p in parts if len(p))]
        async with self._send_lock:
            for b in bufs:
                self._writer.write(b)
            await self._writer.drain()

    async def send_str(self, data: str) -> None:
        await self._send(_ws.OP_TEXT, data.encode())

    async def send_json(self, data: Any, dumps: Callable[[Any], str] = json.dumps) -> None:
        await self.send_str(dumps(data))

    async def send_bytes(self, *parts) -> None:
        """One binary message, the concatenation of ``parts``."""
        await self._send(_ws.OP_BINARY, *parts)

    async def ping(self, data: bytes = b"") -> None:
        await self._send(_ws.OP_PING, data)

    async def _heartbeat(self, every: float) -> None:
        try:
            while not self._closed:
                await asyncio.sleep(every)
                self._pong.clear()
                try:
                    await self.ping()
                except ConnectionError:
                    return
                try:
                    await asyncio.wait_for(self._pong.wait(), every / 2)
                except TimeoutError:
                    self._exception = ServerTimeoutError("no pong within the heartbeat")
                    self._abort(1006)
                    return
        except asyncio.CancelledError:
            pass

    def _abort(self, code: int) -> None:
        self._closed = True
        if self.close_code is None:
            self.close_code = code
        if self._writer is not None:
            self._writer.close()
        self._registry.discard(self)

    async def close(self, code: int = 1000, message: bytes = b"") -> bool:
        """Send a close frame, wait a little for the echo, close the socket."""
        if self._hb_task is not None and self._hb_task is not asyncio.current_task():
            self._hb_task.cancel()
        if self._closed:
            self._abort(code)
            return False
        try:
            await asyncio.wait_for(self._send(_ws.OP_CLOSE, struct.pack("!H", code) + message[:123]), 2.0)
        except (ConnectionError, OSError, TimeoutError):
            pass
        self._closed = True
        self._abort(code)
        return True

    async def receive(self) -> WSMessage:
        opcode, parts, size = None, [], 0
        while True:
            if self._closed and self._writer.is_closing():
                return WSMessage(WSMsgType.CLOSED)
            try:
                fin, op, payload = await _ws_read_frame(self._reader, not self._client)
            except _ws.ProtocolError as e:
                self._exception = e
                await self.close(e.code)
                return WSMessage(WSMsgType.ERROR, e)
            except (asyncio.IncompleteReadError, ConnectionError, OSError) as e:
                if not self._closed:
                    self._exception = e
                self._abort(1006)
                return WSMessage(WSMsgType.CLOSED)
            if op == _ws.OP_PING:
                try:
                    await self._send(_ws.OP_PONG, payload)
                except ConnectionError:
                    pass
                continue
            if op == _ws.OP_PONG:
                self._pong.set()
                continue
            if op == _ws.OP_CLOSE:
                self.close_code = struct.unpack("!H", payload[:2])[0] if len(payload) >= 2 else 1005
                if not self._closed:
                    await self.close(self.close_code if self.close_code != 1005 else 1000)
                return WSMessage(WSMsgType.CLOSE, self.close_code)
            if op == _ws.OP_CONT:
                if opcode is None:
                    self._exception = _ws.ProtocolError("continuation without a message")
                    await self.close(1002)
                    return WSMessage(WSMsgType.ERROR, self._exception)
            elif opcode is not None:
                self._exception = _ws.ProtocolError("a new message began inside a fragmented one")
                await self.close(1002)
                return WSMessage(WSMsgType.ERROR, self._exception)
            else:
                opcode = op
            parts.append(payload)
            size += len(payload)
            if size > _ws.MAX_MESSAGE:
                self._exception = _ws.ProtocolError("message too big", 1009)
                await self.close(1009)
                return WSMessage(WSMsgType.ERROR, self._exception)
            if fin:
                data = parts[0] if len(parts) == 1 else b"".join(parts)
                if opcode == _ws.OP_TEXT:
                    try:
                        return WSMessage(WSMsgType.TEXT, data.decode())
                    except UnicodeDecodeError as e:
                        self._exception = e
                        await self.close(1007)
                        return WSMessage(WSMsgType.ERROR, e)
                return WSMessage(WSMsgType.BINARY, data)

    def __aiter__(self):
        return self

    async def __anext__(self) -> WSMessage:
        msg = await self.receive()
        if msg.type in (WSMsgType.CLOSE, WSMsgType.CLOSING, WSMsgType.CLOSED):
            raise StopAsyncIteration
        return msg


class WebSocketResponse(ClientWebSocketResponse):
    """The server end of one WebSocket (aiohttp's ``web.WebSocketResponse``):
    ``prepare`` upgrades the handler's request and takes its connection;
    then the client end's reading and sending, with unmasked frames out and
    masked frames required in. ``heartbeat=s`` pings the client as the
    client end pings the server."""

    _client = False

    def __init__(self, heartbeat: float | None = None):
        self._heartbeat_s = heartbeat
        self._reader = self._writer = None
        self._registry: set = set()
        self._closed = False
        self.close_code = None
        self._send_lock = asyncio.Lock()
        self._pong = asyncio.Event()
        self._hb_task = None
        self._exception = None
        self.prepared = False

    async def prepare(self, request: Request) -> "WebSocketResponse":
        if self.prepared:
            return self
        try:
            hdrs = _ws.handshake_headers(request.headers)
        except _ws.HandshakeError as e:
            raise HTTPException(400, str(e)) from None
        self._reader, self._writer = request._reader, request._conn_writer  # type: ignore[attr-defined]
        request._stream = self  # type: ignore[assignment]  # the head is out: no second answer
        request._consumed = True
        sock = self._writer.get_extra_info("socket")
        if sock is not None:
            import socket as _socket
            sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        self._writer.write(_head(101, "Switching Protocols", hdrs))
        await self._writer.drain()
        self.prepared = True
        if self._heartbeat_s:
            self._hb_task = asyncio.create_task(self._heartbeat(self._heartbeat_s))
        return self
