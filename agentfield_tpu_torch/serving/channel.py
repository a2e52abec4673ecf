"""The node side of the gateway's persistent channel: the port's counterpart
of ``ChannelServer`` in ``agentfield_tpu/control_plane/channel.py``, on
threads instead of asyncio, over ``serving.websocket``.

The gateway keeps one WebSocket to the node (``GET /channel``) and
multiplexes every execution it sends the node over it. JSON text frames,
the JAX protocol:

==================  ======  ==================================================
kind                dir     meaning
==================  ======  ==================================================
``submit``          gw→nd   start an execution: ``exec_id``, ``target``
                            component, ``input``, ``headers``, ``stream``,
                            optional ``trace`` (TraceContext)
``accepted``        nd→gw   the node owns the execution now
``token``           nd→gw   one streamed token event (``seq``, ``data``)
``terminal``        nd→gw   exactly one final frame: ``status`` completed |
                            failed, ``result`` or ``error``, ``seq``; the
                            node's spans under ``trace`` for a traced one
``cancel``          gw→nd   stop the execution: the engine's cancel path,
                            then terminal failed "cancelled by gateway"
``reattach``        gw→nd   after a dropped connection: re-bind ``exec_id``
                            on this one; the node replays frames past
                            ``last_seq`` (``reattach_ok`` first), or answers
                            ``reattach_fail`` for an execution it does not
                            know
``fin``             gw→nd   the terminal is processed: drop the replay buffer
``ping``/``pong``   both    application-level liveness probe
``kv_fetch``        gw→nd   a peer's KV page request; answered with the JAX
                            server's error frame (the cluster KV tier is not
                            ported)
==================  ======  ==================================================

``seq`` is per execution and rises strictly over its token and terminal
frames. An execution outlives its connection: frames buffer while it is
unbound, and a reattach replays them, so the gateway loses and repeats
nothing (it drops frames at or below the seq it has). A duplicate
``submit`` is idempotent: accepted again and replayed from 0, the work not
run twice. Finished executions' buffers retire after ``replay_ttl_s`` or at
``fin``.

Threads: the connection's reader is the HTTP handler thread that upgraded
it (``serve``); it answers WebSocket pings at once, whatever an execution
is sending. Each execution runs on a daemon thread of its own. Its seq, its
buffer and its sends go under one per-execution lock, so a replay and a new
frame cannot cross; each frame is one ``sendall`` under the socket's send
lock, bounded by ``websocket.SEND_TIMEOUT_S``. ``close`` cancels every
running execution, waits for them, and closes every socket:
``ThreadingHTTPServer.shutdown`` would not close a connection its handler
took over.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Any, Callable

from agentfield_tpu_torch.serving.websocket import OP_TEXT, ProtocolError, WebSocket

log = logging.getLogger(__name__)

CHANNEL_PATH = "/channel"
CANCELLED = "cancelled by gateway"


class ExecutionCancelled(Exception):
    """The gateway cancelled the execution (or the node is closing)."""


class ChannelExec:
    """One execution the node owns: its replay buffer, the connection its
    frames go to (None while unbound) and its cancel signal."""

    def __init__(self, exec_id: str):
        self.exec_id = exec_id
        self.seq = 0
        self.frames: list[dict] = []  # replay buffer (token + terminal); under lock
        self.done = False
        self.done_at = 0.0
        self.thread: threading.Thread | None = None
        self.ended = threading.Event()  # set as its run's last act
        self.conn: WebSocket | None = None  # under lock
        self.lock = threading.Lock()
        self.trace: dict | None = None  # the submit's TraceContext
        self.cancelled = threading.Event()
        self._on_cancel: list[Callable[[], None]] = []
        self._cancel_lock = threading.Lock()

    def on_cancel(self, fn: Callable[[], None]) -> None:
        """Call ``fn`` when the execution is cancelled (now, if it is)."""
        with self._cancel_lock:
            if not self.cancelled.is_set():
                self._on_cancel.append(fn)
                return
        fn()

    def cancel(self) -> None:
        with self._cancel_lock:
            if self.cancelled.is_set():
                return
            self.cancelled.set()
            hooks, self._on_cancel = self._on_cancel, []
        for fn in hooks:
            fn()


# invoke(component_id, payload, headers, execution) -> result: a terminal
# frame only. A stream handler(payload, headers, emit, execution) -> result
# calls emit(data) once a token frame.
InvokeFn = Callable[[str, Any, dict, ChannelExec], Any]
StreamFn = Callable[[Any, dict, Callable[[dict], None], ChannelExec], Any]

STAT_KEYS = (
    "channel_server_connections_total", "channel_server_submits_total",
    "channel_server_frames_total", "channel_server_reattaches_total",
    "channel_server_cancels_total", "channel_server_kv_fetches_total",
    "channel_server_kv_fetch_timeouts_total", "channel_server_kv_fetch_errors_total",
)


class ChannelServer:
    """Node-side endpoint of the gateway's channel. ``serve(ws)`` runs one
    connection's receive loop on the calling thread; ``stats`` holds the
    JAX server's ``channel_server_*`` counters (the node's heartbeat carries
    them)."""

    def __init__(self, invoke: InvokeFn, stream_handlers: dict[str, StreamFn] | None = None,
                 replay_ttl_s: float = 120.0):
        self.invoke = invoke
        self.stream_handlers = dict(stream_handlers or {})
        self.replay_ttl_s = replay_ttl_s
        self._trace_collect: Callable[[dict], list] | None = None
        self._lock = threading.Lock()
        self._execs: dict[str, ChannelExec] = {}  # under _lock
        self._conns: dict[WebSocket, threading.Thread] = {}  # under _lock: reader threads
        self._closing = False
        self.stats = dict.fromkeys(STAT_KEYS, 0)  # under _lock

    def set_trace_collect(self, fn: Callable[[dict], list]) -> None:
        """``fn(trace_ctx) -> spans``, called as a traced execution's
        terminal is built (completed, failed and cancelled alike)."""
        self._trace_collect = fn

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.stats[key] += n

    def stats_snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self.stats)

    # -- one connection -----------------------------------------------------

    def serve(self, ws: WebSocket) -> None:
        """The receive loop of one upgraded connection, until it closes.
        Executions bound to it stay running, their frames buffered for a
        reattach."""
        with self._lock:
            if self._closing:
                ws.close(1001, "node stopping")
                return
            self._conns[ws] = threading.current_thread()
            self.stats["channel_server_connections_total"] += 1
        try:
            while True:
                msg = ws.recv()
                if msg is None:
                    break
                op, data = msg
                if op != OP_TEXT:
                    continue  # binary frames carry KV page blobs (cluster tier)
                try:
                    frame = json.loads(data)
                    if not isinstance(frame, dict):
                        raise ValueError("frame must be an object")
                except ValueError as e:
                    log.warning("malformed channel frame: %r", e)
                    continue
                self._handle(ws, frame)
        except ProtocolError as e:
            log.warning("channel connection broke the protocol: %r", e)
        finally:
            with self._lock:
                self._conns.pop(ws, None)
                execs = list(self._execs.values())
            for st in execs:
                with st.lock:
                    if st.conn is ws:
                        st.conn = None

    @staticmethod
    def _send(ws: WebSocket, frame: dict) -> bool:
        try:
            ws.send_text(json.dumps(frame))
            return True
        except ConnectionError:
            return False

    def _handle(self, ws: WebSocket, frame: dict) -> None:
        kind = frame.get("kind")
        eid = frame.get("exec_id", "")
        if kind == "submit":
            self._submit(ws, eid, frame)
        elif kind == "cancel":
            self._count("channel_server_cancels_total")
            with self._lock:
                st = self._execs.get(eid)
            if st is not None and not st.done:
                st.cancel()
        elif kind == "reattach":
            try:
                last_seq = int(frame.get("last_seq", 0))
            except (TypeError, ValueError):
                last_seq = 0
            self._reattach(ws, eid, last_seq)
        elif kind == "fin":
            with self._lock:
                st = self._execs.get(eid)
                if st is not None and st.done:
                    self._execs.pop(eid, None)
        elif kind == "kv_fetch":
            # the JAX server without an exporter: an error frame, and the
            # requesting peer re-prefills locally
            with self._lock:
                self.stats["channel_server_kv_fetches_total"] += 1
                self.stats["channel_server_kv_fetch_errors_total"] += 1
            self._send(ws, {"kind": "kv_pages", "fetch_id": frame.get("fetch_id", ""),
                            "error": "node serves no KV export", "done": True})
        elif kind == "ping":
            self._send(ws, {"kind": "pong"})

    def _purge(self) -> None:  # under _lock
        cutoff = time.monotonic() - self.replay_ttl_s
        for eid in [e for e, st in self._execs.items() if st.done and st.done_at < cutoff]:
            del self._execs[eid]

    def _submit(self, ws: WebSocket, eid: str, frame: dict) -> None:
        with self._lock:
            self.stats["channel_server_submits_total"] += 1
            self._purge()
            st = self._execs.get(eid)
            if st is None:
                st = self._execs[eid] = ChannelExec(eid)
                st.conn = ws
                tr = frame.get("trace")
                if isinstance(tr, dict) and isinstance(tr.get("trace_id"), str):
                    st.trace = tr
                if self._closing:
                    st.cancel()  # runs to its cancelled terminal at once
                fresh = True
            else:
                fresh = False
        self._send(ws, {"kind": "accepted", "exec_id": eid})
        if not fresh:
            # a retried submit of an execution this node owns: re-bind and
            # replay from 0, never run the work twice
            self._replay(ws, st, 0)
            return
        st.thread = threading.Thread(target=self._run, args=(st, frame), daemon=True,
                                     name=f"channel-{eid}")
        st.thread.start()

    def _reattach(self, ws: WebSocket, eid: str, last_seq: int) -> None:
        with self._lock:
            st = self._execs.get(eid)
        if st is None:
            self._send(ws, {"kind": "reattach_fail", "exec_id": eid,
                            "error": "unknown execution (restart or replay TTL expired)"})
            return
        self._count("channel_server_reattaches_total")
        self._send(ws, {"kind": "reattach_ok", "exec_id": eid, "from_seq": last_seq})
        self._replay(ws, st, last_seq)

    def _replay(self, ws: WebSocket, st: ChannelExec, last_seq: int) -> None:
        # under the execution's lock: a frame emitted meanwhile waits, then
        # goes to the re-bound connection after the older ones
        with st.lock:
            for f in st.frames:
                if f["seq"] > last_seq:
                    self._send(ws, f)
            st.conn = ws

    def _emit(self, st: ChannelExec, frame: dict) -> None:
        with st.lock:
            st.seq += 1
            frame["seq"] = st.seq
            st.frames.append(frame)
            self._count("channel_server_frames_total")
            if st.conn is not None and not self._send(st.conn, frame):
                st.conn = None  # buffer until a reattach

    def _run(self, st: ChannelExec, frame: dict) -> None:
        target = frame.get("target", "")
        payload = frame.get("input")
        headers = frame.get("headers") or {}
        try:
            if st.cancelled.is_set():
                raise ExecutionCancelled
            sh = self.stream_handlers.get(target)
            if sh is not None and frame.get("stream", True):
                def emit(data: dict) -> None:
                    self._emit(st, {"kind": "token", "exec_id": st.exec_id, "data": data})

                result = sh(payload, headers, emit, st)
            else:
                result = self.invoke(target, payload, headers, st)
            if st.cancelled.is_set():
                raise ExecutionCancelled  # an invoke cannot be interrupted
            json.dumps(result)  # an unserializable result fails the execution here
            term = {"kind": "terminal", "exec_id": st.exec_id, "status": "completed",
                    "result": result}
        except ExecutionCancelled:
            term = {"kind": "terminal", "exec_id": st.exec_id, "status": "failed",
                    "error": CANCELLED}
        except Exception as e:  # noqa: BLE001 — the execution's failed terminal
            term = {"kind": "terminal", "exec_id": st.exec_id, "status": "failed",
                    "error": repr(e)}
        if st.trace is not None and self._trace_collect is not None:
            try:
                spans = self._trace_collect(st.trace)
            except Exception as e:  # noqa: BLE001 — evidence is best effort
                log.debug("trace collection failed: %r", e)
                spans = None
            if spans:
                term["trace"] = {"trace_id": st.trace.get("trace_id"), "spans": spans}
        st.done_at = time.monotonic()
        st.done = True
        try:
            self._emit(st, term)
        finally:
            st.ended.set()

    # -- shutdown -------------------------------------------------------------

    def open(self) -> None:
        """Take connections again after a ``close`` (a node started again)."""
        with self._lock:
            self._closing = False

    def close(self, timeout: float = 30.0) -> None:
        """Node shutdown: cancel every running execution (each ends with its
        failed terminal, "cancelled by gateway") and wait for them until
        ``timeout``; then close every socket (a close frame, 1001, or an
        abort where a send is stuck behind a peer that stopped reading) and
        join the readers and the executions an abort woke."""
        deadline = time.monotonic() + timeout
        with self._lock:
            self._closing = True  # a later submit is cancelled as it lands
        seen: dict[int, ChannelExec] = {}
        while True:
            with self._lock:
                execs = [st for st in self._execs.values() if id(st) not in seen]
            if not execs:
                break
            for st in execs:
                seen[id(st)] = st
                st.cancel()
            for st in execs:
                st.ended.wait(max(0.0, deadline - time.monotonic()))
        with self._lock:
            conns = dict(self._conns)
        for ws in conns:
            ws.close(1001, "node stopping")
        for ws, th in conns.items():
            th.join(min(2.0, max(0.0, deadline - time.monotonic())))  # the peer's echo
            ws.abort()  # wakes a reader, and a send stuck on this socket
        for st in seen.values():
            if st.thread is not None and st.thread.ident is not None:
                st.thread.join(2.0)
            if not st.ended.is_set():
                log.warning("channel execution %s did not end at close", st.exec_id)
        for th in conns.values():
            th.join(2.0)
