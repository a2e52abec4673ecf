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
``kv_fetch``        both    a cross-node KV page request: nd→gw names the
                            ``peer`` that advertised the pages and their
                            ``chains`` (hex chain hashes), optionally a
                            ``handoff`` id (two-phase dispatch: the peer's
                            stashed tail page too); the gateway relays it
                            gw→nd to the peer under its own ``fetch_id``
``kv_pages``        both    the answer's metadata: page descriptors (chain or
                            handoff, depth, leaf dtypes and shapes, segment
                            lengths) framed by ``seq`` under the
                            ``fetch_id``, ``blob_len``, the last one
                            ``done``; or an ``error``
(binary)            both    the page bytes of one ``kv_pages`` frame: an
                            ``AFKV1`` header (fetch_id, seq), then the leaf
                            bytes, sent just before their metadata frame
==================  ======  ==================================================

``seq`` is per execution and rises strictly over its token and terminal
frames. An execution outlives its connection: frames buffer while it is
unbound, and a reattach replays them, so the gateway loses and repeats
nothing (it drops frames at or below the seq it has). A duplicate
``submit`` is idempotent: accepted again and replayed from 0, the work not
run twice. Finished executions' buffers retire after ``replay_ttl_s`` or at
``fin``.

The KV half is the JAX server's: ``set_kv_export`` registers the node's
exporter and each ``kv_fetch`` is served on a thread of its own (the
``kv.fetch_stall``, ``kv.handoff_stall`` and ``kv.fetch_fail`` fault points
act there, on the serving side), its answer chunked at
``KV_PAGES_FRAME_BYTES`` and capped at ``KV_FETCH_MAX_BYTES``;
``fetch_kv`` sends the node's own fetch up a live connection and pairs the
relayed metadata frames with their blobs (in either order) until ``done``,
or gives None at its timeout (the caller re-prefills; late frames drop).

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
import os
import threading
import time
from typing import Any, Callable

from agentfield_tpu_torch.serving import faults
from agentfield_tpu_torch.serving.websocket import OP_BINARY, OP_TEXT, ProtocolError, WebSocket

log = logging.getLogger(__name__)

CHANNEL_PATH = "/channel"
CANCELLED = "cancelled by gateway"

# the JAX channel's transfer caps: the payload bytes one fetch is answered
# with at most ($AGENTFIELD_KV_FETCH_MAX_BYTES), the chains one fetch names
# at most, and the payload bytes one kv_pages frame (and its blob) carries
KV_FETCH_MAX_BYTES = int(os.environ.get("AGENTFIELD_KV_FETCH_MAX_BYTES", str(8 << 20)))
KV_FETCH_MAX_CHAINS = 64
KV_PAGES_FRAME_BYTES = 1 << 20
KV_BLOB_MAGIC = b"AFKV1"  # blob header: magic | u8 fid length | fid | u32 seq


def kv_blob_header(fetch_id: str, seq: int) -> bytes:
    """The header that goes before a blob's payload bytes."""
    fid = fetch_id.encode()
    if len(fid) > 255:
        raise ValueError(f"fetch_id too long for a blob header: {fetch_id!r}")
    return KV_BLOB_MAGIC + bytes([len(fid)]) + fid + int(seq).to_bytes(4, "big")


def unpack_kv_blob(data) -> tuple[str, int, memoryview] | None:
    """``(fetch_id, seq, payload)`` of a blob (the payload a view of
    ``data``, not a copy), or None for a frame that is no blob."""
    n = len(KV_BLOB_MAGIC)
    if len(data) < n + 5 or bytes(data[:n]) != KV_BLOB_MAGIC:
        return None
    fl = data[n]
    if len(data) < n + 1 + fl + 4:
        return None
    try:
        fid = bytes(data[n + 1 : n + 1 + fl]).decode()
    except UnicodeDecodeError:
        return None
    seq = int.from_bytes(bytes(data[n + 1 + fl : n + 5 + fl]), "big")
    return fid, seq, memoryview(data)[n + 5 + fl :]


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


class _KvWaiter:
    """One fetch in flight: each seq's metadata frame paired with its blob
    (the relay may deliver either first), resolved once every seq up to
    ``done`` is assembled; a torn pair or an error frame resolves None."""

    def __init__(self):
        self.lock = threading.Lock()
        self.event = threading.Event()
        self.result: list[dict] | None = None
        self.pages: dict[int, list[dict]] = {}  # assembled, per seq
        self.blobs: dict[int, memoryview] = {}
        self.metas: dict[int, dict] = {}
        self.done_seq: int | None = None

    def resolve(self, result: list[dict] | None) -> None:  # under lock
        if not self.event.is_set():
            self.result = result
            self.event.set()

    def assemble(self) -> None:  # under lock
        for seq in list(self.metas):
            frame = self.metas[seq]
            blob_len = int(frame.get("blob_len") or 0)
            if blob_len and seq not in self.blobs:
                continue  # the metadata came first: wait for its blob
            blob = self.blobs.pop(seq, memoryview(b""))
            if len(blob) != blob_len:
                self.resolve(None)
                return
            pages, off = [], 0
            for meta in frame.get("pages") or []:
                if not isinstance(meta, dict):
                    continue
                n = sum(int(x) for x in (meta.get("segs") or []))
                pages.append({**meta, "data": blob[off : off + n]})  # a view
                off += n
            self.pages[seq] = pages
            del self.metas[seq]
        if self.done_seq is not None and all(s in self.pages
                                             for s in range(1, self.done_seq + 1)):
            self.resolve([pg for s in sorted(self.pages) for pg in self.pages[s]])


# exporter(chains_hex, max_bytes, handoff) -> [(page meta, payload bytes)]
KvExportFn = Callable[[list, int, Any], list]


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
        self._kv_export: KvExportFn | None = None
        self._kv_waiters: dict[str, _KvWaiter] = {}  # under _lock
        self._kv_next = 0  # under _lock
        self._kv_threads: set[threading.Thread] = set()  # under _lock: fetches being served

    def set_trace_collect(self, fn: Callable[[dict], list]) -> None:
        """``fn(trace_ctx) -> spans``, called as a traced execution's
        terminal is built (completed, failed and cancelled alike)."""
        self._trace_collect = fn

    def set_kv_export(self, fn: KvExportFn) -> None:
        """Register the exporter that answers peers' ``kv_fetch`` frames:
        ``fn(chains_hex, max_bytes, handoff) -> [(meta, payload bytes)]``,
        each meta the page's chain (or handoff id), depth, leaf dtypes and
        shapes and segment lengths. Without one a fetch is answered with an
        error frame."""
        self._kv_export = fn

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
                if op == OP_BINARY:
                    self._on_kv_blob(data)
                    continue
                if op != OP_TEXT:
                    continue
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

    @staticmethod
    def _send_bytes(ws: WebSocket, *parts) -> bool:
        try:
            ws.send_binary(*parts)
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
            # served off the reader: a stall or an export must not hold up
            # this connection's other frames
            th = threading.Thread(target=self._serve_kv_fetch, args=(ws, frame), daemon=True,
                                  name="channel-kv-fetch")
            with self._lock:
                self._kv_threads.add(th)
            th.start()
        elif kind == "kv_pages":
            self._on_kv_pages(frame)
        elif kind == "ping":
            self._send(ws, {"kind": "pong"})

    # -- cross-node KV transfer -----------------------------------------------

    def fetch_kv(self, peer_node_id: str, chains_hex: list[str], timeout_s: float = 5.0,
                 max_bytes: int | None = None, handoff: str | None = None) -> list[dict] | None:
        """Ask ``peer_node_id`` for pages through the gateway's relay, over a
        live connection of this node: the page dicts (``chain`` or
        ``handoff``, ``depth``, ``parts``, ``segs``, ``data`` bytes; perhaps
        fewer than asked), or None when no connection is open, the peer
        answered with an error, or ``timeout_s`` passed (the caller
        re-prefills; frames arriving later are dropped)."""
        with self._lock:
            conns = list(self._conns)
            if not conns or not (chains_hex or handoff):
                return None
            self._kv_next += 1
            fid = f"kvf_{id(self)}_{self._kv_next}"
            w = self._kv_waiters[fid] = _KvWaiter()
        try:
            frame = {"kind": "kv_fetch", "fetch_id": fid, "peer": peer_node_id,
                     "chains": list(chains_hex)[:KV_FETCH_MAX_CHAINS],
                     "max_bytes": int(max_bytes or KV_FETCH_MAX_BYTES)}
            if handoff is not None:
                frame["handoff"] = handoff
            if not self._send(conns[0], frame):
                return None
            if not w.event.wait(timeout_s):
                self._count("channel_server_kv_fetch_timeouts_total")
                return None
            return w.result
        finally:
            with self._lock:
                self._kv_waiters.pop(fid, None)

    def _waiter(self, fid) -> _KvWaiter | None:
        with self._lock:
            return self._kv_waiters.get(fid) if isinstance(fid, str) else None

    def _on_kv_pages(self, frame: dict) -> None:
        """A relayed metadata frame of one of this node's fetches (one for
        an unknown or finished fetch is dropped)."""
        w = self._waiter(frame.get("fetch_id"))
        if w is None:
            return
        with w.lock:
            if w.event.is_set():
                return
            if frame.get("error"):
                w.resolve(None)
                return
            try:
                seq = int(frame.get("seq", 0))
            except (TypeError, ValueError):
                w.resolve(None)
                return
            w.metas[seq] = frame
            if frame.get("done"):
                w.done_seq = seq
            w.assemble()

    def _on_kv_blob(self, data: bytes) -> None:
        """A relayed page blob of one of this node's fetches."""
        parsed = unpack_kv_blob(data)
        if parsed is None:
            return
        fid, seq, payload = parsed
        w = self._waiter(fid)
        if w is None:
            return
        with w.lock:
            if not w.event.is_set():
                w.blobs[seq] = payload
                w.assemble()

    def _serve_kv_fetch(self, ws: WebSocket, frame: dict) -> None:
        """Answer a peer's relayed fetch from this node's prefix index:
        chunks of at most ``KV_PAGES_FRAME_BYTES``, each a blob then its
        ``kv_pages`` frame, the last ``done``; the answer stops at the byte
        cap (the requester re-prefills the rest)."""
        try:
            fid = frame.get("fetch_id", "")
            chains = frame.get("chains") or []
            handoff = frame.get("handoff") if isinstance(frame.get("handoff"), str) else None
            try:
                max_bytes = min(int(frame.get("max_bytes") or KV_FETCH_MAX_BYTES),
                                KV_FETCH_MAX_BYTES)
            except (TypeError, ValueError):
                max_bytes = KV_FETCH_MAX_BYTES
            self._count("channel_server_kv_fetches_total")

            def fail(err: str) -> None:
                self._count("channel_server_kv_fetch_errors_total")
                self._send(ws, {"kind": "kv_pages", "fetch_id": fid, "error": err,
                                "done": True})

            f = faults.fire("kv.fetch_stall")
            if f is not None and f.delay_s > 0:
                time.sleep(f.delay_s)
            if handoff is not None:
                # a stalled handoff degrades as a stalled prefix fetch does
                f = faults.fire("kv.handoff_stall")
                if f is not None and f.delay_s > 0:
                    time.sleep(f.delay_s)
            f = faults.fire("kv.fetch_fail")
            if f is not None:
                fail(f.error)
                return
            if self._kv_export is None or not isinstance(chains, list):
                fail("node serves no KV export")
                return
            try:
                pages = self._kv_export(
                    [c for c in chains[:KV_FETCH_MAX_CHAINS] if isinstance(c, str)],
                    max_bytes, handoff)
            except Exception as e:  # noqa: BLE001 — an error frame; the peer re-prefills
                fail(f"kv export failed: {e!r}")
                return
            seq = total = size = 0
            batch: list[dict] = []
            blob: list = []  # the frame's page payloads, sent as they are

            def flush(done: bool) -> None:
                nonlocal seq, batch, blob, size
                seq += 1
                if blob:
                    self._send_bytes(ws, kv_blob_header(fid, seq), *blob)
                self._send(ws, {"kind": "kv_pages", "fetch_id": fid, "seq": seq,
                                "pages": batch, "blob_len": size, "done": done})
                batch, blob, size = [], [], 0

            for meta, payload in pages:
                if total + len(payload) > max_bytes:
                    break  # the byte cap (the exporter already kept to it)
                if batch and size + len(payload) > KV_PAGES_FRAME_BYTES:
                    flush(done=False)
                batch.append(meta)
                blob.append(payload)
                size += len(payload)
                total += len(payload)
            flush(done=True)
        finally:
            with self._lock:
                self._kv_threads.discard(threading.current_thread())

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
        with self._lock:
            kv_threads = list(self._kv_threads)
            waiters = list(self._kv_waiters.values())
        for w in waiters:  # a fetch of this node's own ends now
            with w.lock:
                w.resolve(None)
        for th in kv_threads:  # a stalled serve ends at its delay
            th.join(max(0.0, deadline - time.monotonic()) + 2.0)
