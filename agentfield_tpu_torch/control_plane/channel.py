"""Streaming data plane: the port's copy of
``agentfield_tpu/control_plane/channel.py``, both halves on asyncio. The
gateway's half (``NodeChannel``, ``ChannelManager``) speaks through
``http.ClientSession.ws_connect``; the node half (``ChannelServer``) is
what the SDK's ``Agent`` serves at ``GET /channel``, on
``http.WebSocketResponse``. The model node keeps its own threaded node half,
``agentfield_tpu_torch/serving/channel.py``. The frame kinds and the
``AFKV1`` blob header are the JAX module's, byte for byte.

Streaming data plane: persistent multiplexed gateway↔node channels.

The dispatch fast path left the per-request agent hop as the dominant
cost (docs/PERFORMANCE.md: the ``with_agent_hop`` variant was "a wash — the
hop dominates"). This module replaces the per-execution HTTP POST with ONE
long-lived WebSocket per (gateway, node) pair carrying framed messages, and
streams tokens end-to-end — engine ``TokenEvent`` → model node → channel
frame → gateway stream registry → client SSE — so a sync caller's first
byte arrives at time-to-first-token instead of full-completion latency
(ROADMAP item 5; "Software-Defined Agentic Serving" treats the transport as
a first-class serving concern, PAPERS.md).

Frame protocol (JSON text frames; ``seq`` is per-execution, assigned by the
node, monotonically increasing over token+terminal frames so a reattach can
resume exactly where the last connection died):

==================  ======  =====================================================
kind                dir     meaning
==================  ======  =====================================================
``submit``          gw→nd   start an execution: target component, input, headers,
                            stream flag, optional ``trace`` (TraceContext —
                            request-scoped tracing, docs/OBSERVABILITY.md;
                            the terminal frame then carries the node's
                            collected spans under ``trace``)
``accepted``        nd→gw   submit received; the node owns the execution now
                            (the channel's 202-equivalent)
``token``           nd→gw   one streamed token event (``seq``, ``data``)
``terminal``        nd→gw   exactly-one final frame: status completed|failed,
                            result/error (``seq``)
``cancel``          gw→nd   stop the execution (deadline/timeout/abandoned
                            caller); propagates to the engine's cancel path
``reattach``        gw→nd   after a channel drop: re-bind ``exec_id`` on a new
                            connection; the node replays frames > ``last_seq``
``reattach_ok``     nd→gw   exec known; replay (if any) precedes this binding
``reattach_fail``   nd→gw   exec unknown (node restarted / replay TTL expired)
``fin``             gw→nd   terminal processed durably; the node may drop the
                            execution's replay buffer
``ping``/``pong``   both    app-level liveness probe (the WS heartbeat
                            owns transport liveness; this is for diagnostics)
``kv_fetch``        both    cross-node KV page request (docs/PREFIX_CACHING.md
                            "Cluster tier"): node→gw carries ``peer`` (the
                            node whose sketch advertised the pages) +
                            ``chains`` (hex chain hashes); the gateway relays
                            it gw→node to the peer (``peer`` stripped), which
                            serves it from its prefix index. An optional
                            ``handoff`` id (disaggregated pools, phase 2)
                            additionally pulls the peer's stashed live tail
                            page for that handoff — its page descriptor
                            carries ``handoff`` instead of ``chain``
``kv_pages``        both    the peer's response METADATA: ``fetch_id``-
                            correlated, seq-framed page descriptors
                            (chain/depth/leaf dtypes+shapes/segment byte
                            lengths), size-capped per frame
                            (``AGENTFIELD_KV_FETCH_MAX_BYTES``), final frame
                            carries ``done``; relayed gw→requester. The page
                            BYTES travel separately (below).
(binary)            both    raw page payloads as binary WS frames —
                            ``AFKV1`` header (fetch_id, seq) + concatenated
                            leaf bytes, sent immediately BEFORE the seq's
                            ``kv_pages`` metadata frame. No base64: the old
                            text-frame encoding paid ~33% wire overhead plus
                            a to_thread encode/decode hop on both sides. The
                            gateway relays blobs by header rewrite only —
                            payload bytes are never copied into JSON.
==================  ======  =====================================================

Failure semantics (docs/FAULT_TOLERANCE.md mid-stream table): a submit that
was never ``accepted`` is retried/failed-over by the gateway dispatch loop
exactly like a failed POST (zero frames exist, replay is safe). Once frames
have been published to the client-visible stream, a lost channel may only
REATTACH (by exec_id + last acked seq) — if reattach fails the execution
dead-letters with the frame count recorded, never replays (replay would
duplicate tokens a client already consumed). Exactly one terminal frame
reaches the stream per execution.

Fallback: a node that does not advertise ``metadata.channel`` (or a gateway
with ``AGENTFIELD_CHANNEL=0``) uses the per-execution POST path unchanged —
channel off is bit-compatible with the pre-channel gateway, pinned by test.
"""

from __future__ import annotations

import asyncio
import collections
import json
import os
import random
import time
from typing import Any, Awaitable, Callable

from agentfield_tpu_torch.control_plane import faults, http
from agentfield_tpu_torch.control_plane.http import aio_timeout
from agentfield_tpu_torch.logging import get_logger

log = get_logger("channel")

CHANNEL_PATH = "/channel"

# Cross-node KV transfer caps (docs/OPERATIONS.md "Cluster prefix cache"):
# one kv_pages frame never exceeds this many serialized-payload bytes (the
# serving side chunks the response), and one kv_fetch never names more than
# _KV_FETCH_MAX_CHAINS pages — a misbehaving peer cannot turn the relay into
# a bulk copy pipe.
_KV_FETCH_MAX_BYTES = int(
    os.environ.get("AGENTFIELD_KV_FETCH_MAX_BYTES", str(8 << 20))
)
_KV_FETCH_MAX_CHAINS = 64
# One kv_pages frame carries at most this much serialized payload; a
# response larger than one frame is split into seq-numbered chunks the
# requester accumulates until `done` (a multi-MB WS text frame would stall
# every other execution multiplexed on the channel while it serializes).
_KV_PAGES_FRAME_BYTES = 1 << 20
# Gateway-side relay bookkeeping TTL: an unanswered fetch_id is forgotten
# after this long (the requester's own timeout is always shorter in
# practice; this bounds the map against a dead peer).
_KV_RELAY_TTL_S = 30.0
_KV_RELAY_MAX = 256
# Completed relays (done/error seen) linger this long so a binary blob
# frame racing its own metadata frame through the relay's per-frame tasks
# still resolves its fetch_id; capacity purges honor the shortened deadline.
_KV_RELAY_DRAIN_S = 2.0

# Binary kv-page blob framing: MAGIC | u8 fid_len | fid utf-8 | u32 seq |
# payload. The header is the ONLY part the gateway relay parses (it
# rewrites fid between the node-minted and gateway-unique namespaces).
_KV_BLOB_MAGIC = b"AFKV1"


def _pack_kv_blob(fetch_id: str, seq: int, payload: bytes) -> bytes:
    fid = fetch_id.encode()
    if len(fid) > 255:
        raise ValueError(f"fetch_id too long for blob header: {fetch_id!r}")
    return (
        _KV_BLOB_MAGIC + bytes([len(fid)]) + fid
        + int(seq).to_bytes(4, "big") + payload
    )


def _unpack_kv_blob(data: bytes) -> tuple[str, int, memoryview] | None:
    """(fetch_id, seq, payload) or None for frames that are not kv blobs;
    the payload is a view into ``data``, not a copy."""
    n = len(_KV_BLOB_MAGIC)
    if len(data) < n + 5 or data[:n] != _KV_BLOB_MAGIC:
        return None
    fl = data[n]
    if len(data) < n + 1 + fl + 4:
        return None
    try:
        fid = data[n + 1 : n + 1 + fl].decode()
    except UnicodeDecodeError:
        return None
    seq = int.from_bytes(data[n + 1 + fl : n + 5 + fl], "big")
    return fid, seq, memoryview(data)[n + 5 + fl :]


class ChannelUnavailable(Exception):
    """The channel could not carry this submit (connect/handshake/send
    failure). Zero frames exist, so the caller falls back to the POST path
    for this call — behavior identical to a channel-less node."""


# ---------------------------------------------------------------------------
# Gateway-side: per-execution stream registry (frames the CLIENT can see)


class StreamSubscription:
    """One consumer of an execution's frame stream: the replay snapshot it
    attached with, then live frames. ``get()`` pops replay first so a late
    subscriber sees every frame exactly once, in order."""

    def __init__(self, entry: "_StreamEntry", replay: list[dict]):
        self._entry = entry
        self._replay = collections.deque(replay)
        self.q: asyncio.Queue = asyncio.Queue(maxsize=8192)
        self.dropped = False

    async def get(self) -> dict | None:
        """Next frame; None means this subscriber lagged and was dropped
        (the stream itself continues for other consumers)."""
        if self._replay:
            return self._replay.popleft()
        return await self.q.get()

    def close(self) -> None:
        self._entry.subs.discard(self.q)

    def __aiter__(self):
        return self

    async def __anext__(self) -> dict:
        frame = await self.get()
        if frame is None:
            raise StopAsyncIteration
        if frame.get("kind") == "terminal":
            self.close()
            # the terminal frame itself is still yielded; the NEXT pull ends
            self._replay.append(None)  # type: ignore[arg-type]
        return frame


class _StreamEntry:
    __slots__ = ("frames", "tokens", "done", "done_at", "subs")

    def __init__(self):
        self.frames: list[dict] = []  # token frames + (eventually) terminal
        self.tokens = 0  # token frames published — the "client saw N" count
        self.done = False
        self.done_at = 0.0
        self.subs: set[asyncio.Queue] = set()


class ExecutionStreams:
    """Per-execution frame buffer + subscriber fanout on the gateway.

    Every token frame received over a node channel is published here the
    moment it arrives — buffered for late subscribers (``GET
    /api/v1/executions/{id}/stream`` replays from frame 0) and fanned out to
    live SSE consumers. The buffer IS the client-visible record: once
    ``tokens_published`` is non-zero the execution may never be replayed
    (docs/FAULT_TOLERANCE.md mid-stream semantics).

    Entries retire ``retain_s`` after their terminal frame (late subscribers
    within the window still get the full replay + terminal); the lazy purge
    runs on every mutation so no background task is needed.
    """

    def __init__(self, retain_s: float = 60.0, max_entries: int = 4096):
        self.retain_s = retain_s
        self.max_entries = max_entries
        # Registry + retirement order: mutated only from the gateway's event
        # loop (channel recv loop, SSE handlers, gateway.complete) — no lock
        # exists to check, so encapsulation is the enforced half.
        self._entries: dict[str, _StreamEntry] = {}  # guarded by: external(gateway event loop)
        self._done_order: collections.OrderedDict[str, float] = collections.OrderedDict()  # guarded by: external(gateway event loop)

    def _purge(self) -> None:
        cutoff = time.monotonic() - self.retain_s
        while self._done_order:
            eid, t = next(iter(self._done_order.items()))
            if t > cutoff and len(self._entries) <= self.max_entries:
                break
            self._done_order.pop(eid, None)
            self._entries.pop(eid, None)

    def ensure(self, execution_id: str) -> None:
        """Open an execution's stream entry without subscribing (async
        executions submitted with ``stream: true`` — frames buffer for a
        later ``GET /executions/{id}/stream`` attach)."""
        if execution_id not in self._entries:
            self._entries[execution_id] = _StreamEntry()
            self._purge()

    def wants(self, execution_id: str) -> bool:
        """Should the node emit token frames for this execution? True when
        a stream entry is open (a streaming caller or async ``stream:
        true`` asked). Plain sync/async traffic skips per-token framing
        entirely — the channel then carries submit + terminal only."""
        entry = self._entries.get(execution_id)
        return entry is not None and not entry.done

    def attach(self, execution_id: str) -> StreamSubscription:
        """Subscribe to an execution's stream, creating the entry if the
        execution is still live (so frames/terminal land somewhere). The
        replay snapshot + live-queue registration is atomic on the event
        loop: no frame can fall between them."""
        self._purge()
        entry = self._entries.get(execution_id)
        if entry is None:
            entry = self._entries[execution_id] = _StreamEntry()
        sub = StreamSubscription(entry, list(entry.frames))
        if not entry.done:
            entry.subs.add(sub.q)
        return sub

    def publish(self, execution_id: str, frame: dict) -> None:
        """One token frame from the node channel → buffer + live fanout."""
        entry = self._entries.get(execution_id)
        if entry is None:
            entry = self._entries[execution_id] = _StreamEntry()
            self._purge()
        if entry.done:
            return  # late frame after terminal: exactly-one-terminal holds
        entry.frames.append(frame)
        if frame.get("kind") == "token":
            entry.tokens += 1
        self._fanout(entry, frame)

    def _fanout(self, entry: _StreamEntry, frame: dict) -> None:
        for q in list(entry.subs):
            try:
                q.put_nowait(frame)
            except asyncio.QueueFull:
                # This consumer is hopelessly behind — drop IT, not the
                # stream. The sentinel lets its handler close with an
                # explicit "dropped" signal instead of a silent stall.
                entry.subs.discard(q)
                try:
                    q.put_nowait(None)
                except asyncio.QueueFull:
                    pass  # queue is full of frames the dead consumer will never read

    def finish(self, ex) -> None:
        """Publish the exactly-one terminal frame for a terminal execution
        (idempotent; no-op when nothing ever subscribed/streamed and nothing
        is watching)."""
        entry = self._entries.get(ex.execution_id)
        if entry is None:
            return
        if entry.done:
            return
        entry.done = True
        entry.done_at = time.monotonic()
        self._done_order[ex.execution_id] = entry.done_at
        result = ex.result
        frame = {
            "kind": "terminal",
            "execution_id": ex.execution_id,
            "status": ex.status.value,
            "error": ex.error,
            "result": result,
            "frames_delivered": entry.tokens,
        }
        if isinstance(result, dict) and result.get("finish_reason"):
            frame["finish_reason"] = result["finish_reason"]
        entry.frames.append(frame)
        self._fanout(entry, frame)
        entry.subs.clear()
        self._purge()

    def tokens_published(self, execution_id: str) -> int:
        entry = self._entries.get(execution_id)
        return entry.tokens if entry is not None else 0

    def discard(self, execution_id: str) -> None:
        """Drop an execution's stream entry (operator dead-letter requeue:
        the NEW incarnation must stream from frame 0 into a fresh buffer,
        and the old terminal frame must not gag it)."""
        self._entries.pop(execution_id, None)
        self._done_order.pop(execution_id, None)

    @staticmethod
    def terminal_frame(doc: dict) -> dict:
        """Synthesize the terminal frame for an execution that went terminal
        before (or without) any stream entry — GET /stream on old rows."""
        result = doc.get("result")
        frame = {
            "kind": "terminal",
            "execution_id": doc["execution_id"],
            "status": doc["status"],
            "error": doc.get("error"),
            "result": result,
            "frames_delivered": doc.get("frames_delivered", 0),
        }
        if isinstance(result, dict) and result.get("finish_reason"):
            frame["finish_reason"] = result["finish_reason"]
        return frame


# ---------------------------------------------------------------------------
# Node-side: the channel server (one WS route on every channel-enabled node)


class _ServerExec:
    __slots__ = (
        "exec_id", "seq", "frames", "done", "done_at", "task", "conn",
        "lock", "trace",
    )

    def __init__(self, exec_id: str):
        self.exec_id = exec_id
        self.seq = 0
        self.frames: list[dict] = []  # replay buffer (token + terminal)
        self.done = False
        self.done_at = 0.0
        self.task: asyncio.Task | None = None
        self.conn: "_ServerConn | None" = None
        # Serializes emission vs reattach-replay so a frame emitted during a
        # replay cannot reach the new connection before older frames do.
        self.lock = asyncio.Lock()
        # TraceContext from the submit frame (docs/OBSERVABILITY.md): the
        # terminal frame carries the node's collected spans for it.
        self.trace: dict | None = None


class _ServerConn:
    __slots__ = ("ws", "lock")

    def __init__(self, ws: http.WebSocketResponse):
        self.ws = ws
        self.lock = asyncio.Lock()  # one frame at a time on the socket

    async def send(self, frame: dict) -> bool:
        try:
            async with self.lock:
                await self.ws.send_str(json.dumps(frame))
            return True
        except (ConnectionError, RuntimeError, asyncio.CancelledError):
            return False

    async def send_bytes(self, payload: bytes) -> bool:
        try:
            async with self.lock:
                await self.ws.send_bytes(payload)
            return True
        except (ConnectionError, RuntimeError, asyncio.CancelledError):
            return False


class _KvWaiter:
    """One in-flight fetch_kv: pairs each seq's metadata frame with its
    binary blob (whichever arrives first waits for the other — the gateway
    relays them as independent tasks, so ordering is NOT guaranteed end to
    end) and resolves the future once every seq up to ``done`` assembled.
    A lost blob simply never resolves — the caller's timeout degrades to a
    local re-prefill, the standing best-effort contract."""

    __slots__ = ("fut", "frames", "blobs", "metas", "done_seq")

    def __init__(self, fut: asyncio.Future):
        self.fut = fut
        self.frames: dict[int, list[dict]] = {}  # assembled pages per seq
        self.blobs: dict[int, bytes] = {}
        self.metas: dict[int, dict] = {}
        self.done_seq: int | None = None


# invoke(component_id, payload, headers) -> result
InvokeFn = Callable[[str, Any, dict[str, str]], Awaitable[Any]]
# stream handler(payload, headers, emit) -> result; emit(data_dict) is an
# async callable pushing one token frame
StreamFn = Callable[..., Awaitable[Any]]


class ChannelServer:
    """Node-side endpoint of the persistent channel (``GET /channel``).

    Executions survive connection loss: a running task keeps generating and
    BUFFERING frames while unbound; a ``reattach`` from the gateway's next
    connection replays everything past ``last_seq`` and re-binds the sink —
    zero token loss, zero duplication (the gateway dedups by seq). Replay
    buffers for finished executions retire after ``replay_ttl_s`` or on an
    explicit ``fin``.
    """

    def __init__(
        self,
        invoke: InvokeFn,
        stream_handlers: dict[str, StreamFn] | None = None,
        heartbeat_s: float = 15.0,
        replay_ttl_s: float = 120.0,
    ):
        self.invoke = invoke
        self.stream_handlers = dict(stream_handlers or {})
        self.heartbeat_s = heartbeat_s
        self.replay_ttl_s = replay_ttl_s
        self._execs: dict[str, _ServerExec] = {}
        self._conns: set[_ServerConn] = set()
        # Cross-node KV transfer (docs/PREFIX_CACHING.md "Cluster tier"):
        # serving side — a registered exporter answers peers' kv_fetch
        # frames; requesting side — fetch_kv() sends a kv_fetch up the live
        # gateway connection and collects the relayed kv_pages response.
        self._kv_export: Callable[[list[str], int], Awaitable[list]] | None = None
        # Tracing hook (docs/OBSERVABILITY.md): sync fn(trace_ctx) ->
        # list[span dict], called when an execution's terminal frame is
        # built so node-side spans ride it back to the gateway — for
        # SUCCESS, FAILURE, and CANCEL terminals alike (a node that failed
        # an execution still ships its evidence).
        self._trace_collect: Callable[[dict], list] | None = None
        self._kv_waiters: dict[str, _KvWaiter] = {}
        self._kv_next_id = 0
        self._kv_tasks: set[asyncio.Task] = set()
        self.stats = {
            "channel_server_connections_total": 0,
            "channel_server_submits_total": 0,
            "channel_server_frames_total": 0,
            "channel_server_reattaches_total": 0,
            "channel_server_cancels_total": 0,
            "channel_server_kv_fetches_total": 0,
            # Degradation-ladder rungs (docs/FAULT_TOLERANCE.md): a fetch
            # that timed out waiting on the peer (the caller re-prefilled)
            # and a served fetch answered with an error frame — both are
            # correct-but-slower outcomes an operator must be able to see.
            "channel_server_kv_fetch_timeouts_total": 0,
            "channel_server_kv_fetch_errors_total": 0,
        }

    def stream_handler(self, component_id: str, fn: StreamFn) -> None:
        """Register a token-streaming handler for one component (the model
        node registers ``generate``); everything else goes through
        ``invoke`` and produces only a terminal frame."""
        self.stream_handlers[component_id] = fn

    def set_trace_collect(self, fn) -> None:
        """Register the span collector for traced executions (the model
        node wires ``ModelBackend.collect_trace_spans``). Without one,
        terminal frames never carry a ``trace`` key."""
        self._trace_collect = fn

    def set_kv_export(self, fn) -> None:
        """Register the KV page exporter: ``async fn(chains_hex, max_bytes)
        -> list[(meta dict, payload bytes)]`` — meta carries chain/depth/
        per-leaf dtypes+shapes/segment lengths, payload the raw
        concatenated leaf bytes (the model node wires its engine's
        ``export_kv_pages`` through ``kv_export_pages``). Without one,
        kv_fetch frames answer with an error — the requesting peer
        re-prefills locally."""
        self._kv_export = fn

    # -- cross-node KV transfer (docs/PREFIX_CACHING.md "Cluster tier") --

    async def fetch_kv(
        self,
        peer_node_id: str,
        chains_hex: list[str],
        timeout_s: float = 5.0,
        max_bytes: int | None = None,
        handoff: str | None = None,
    ) -> list[dict] | None:
        """Request serialized KV pages from `peer_node_id` through the
        gateway relay, over THIS node's live channel connection. Returns
        page dicts ``{chain, depth, parts, segs, data: bytes}`` (raw
        payload assembled from the binary blob frames; possibly fewer
        pages than asked — best effort), or None when no connection
        exists, the relay/peer failed, or `timeout_s` expired. Strictly
        best-effort by design: every failure mode degrades to a local
        re-prefill on the caller's side.

        ``handoff`` (disaggregated pools, phase 2) also requests the
        peer's stashed live tail page for that handoff id; its descriptor
        comes back with ``handoff`` instead of ``chain``. A handoff fetch
        with zero missing chain pages (short prompt fully cached locally)
        is still sent — the tail is the whole point."""
        if not self._conns or not (chains_hex or handoff):
            return None
        conn = next(iter(self._conns))
        self._kv_next_id += 1
        fid = f"kvf_{id(self)}_{self._kv_next_id}"
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._kv_waiters[fid] = _KvWaiter(fut)
        try:
            frame = {
                "kind": "kv_fetch",
                "fetch_id": fid,
                "peer": peer_node_id,
                "chains": chains_hex[:_KV_FETCH_MAX_CHAINS],
                "max_bytes": int(max_bytes or _KV_FETCH_MAX_BYTES),
            }
            if handoff is not None:
                frame["handoff"] = handoff
            ok = await conn.send(frame)
            if not ok:
                return None
            async with aio_timeout(timeout_s):
                return await fut
        except TimeoutError:
            self.stats["channel_server_kv_fetch_timeouts_total"] += 1
            return None  # the caller re-prefills; late frames are dropped
        except asyncio.CancelledError:
            raise  # an EXTERNAL cancel (client gone, drain) must propagate
        finally:
            self._kv_waiters.pop(fid, None)

    def _on_kv_pages(self, frame: dict) -> None:
        """A relayed kv_pages METADATA frame for one of OUR fetch_kv
        calls. Frames past the waiter's timeout (or for an unknown
        fetch_id) are dropped — a stalled peer's late answer must not
        adopt pages into a request that already started its local
        re-prefill."""
        w = self._kv_waiters.get(frame.get("fetch_id", ""))
        if w is None or w.fut.done():
            return
        if frame.get("error"):
            w.fut.set_result(None)
            return
        seq = int(frame.get("seq", 0))
        w.metas[seq] = frame
        if frame.get("done"):
            w.done_seq = seq
        self._kv_assemble(w)

    def _on_kv_blob(self, data: bytes) -> None:
        """A relayed binary page blob: stash by (fetch_id, seq) and try to
        pair it with its metadata frame (arrival order across the relay's
        per-frame tasks is unspecified)."""
        parsed = _unpack_kv_blob(data)
        if parsed is None:
            return
        fid, seq, payload = parsed
        w = self._kv_waiters.get(fid)
        if w is None or w.fut.done():
            return
        w.blobs[seq] = payload
        self._kv_assemble(w)

    def _kv_assemble(self, w: _KvWaiter) -> None:
        """Pair metadata frames with their blobs, slice per-page segments,
        and resolve the fetch once every seq up to ``done`` assembled."""
        for seq in list(w.metas):
            frame = w.metas[seq]
            blob_len = int(frame.get("blob_len") or 0)
            blob = w.blobs.get(seq, b"")
            if blob_len and seq not in w.blobs:
                continue  # metadata before blob: wait for the pair
            if len(blob) != blob_len:
                w.fut.set_result(None)  # torn relay: poison, caller re-prefills
                return
            pages: list[dict] = []
            off = 0
            for meta in frame.get("pages") or []:
                if not isinstance(meta, dict):
                    continue
                n = sum(int(s) for s in (meta.get("segs") or []))
                pages.append({**meta, "data": blob[off : off + n]})
                off += n
            w.frames[seq] = pages
            del w.metas[seq]
            w.blobs.pop(seq, None)
        if w.done_seq is not None and all(
            s in w.frames for s in range(1, w.done_seq + 1)
        ):
            if not w.fut.done():
                w.fut.set_result(
                    [pg for s in sorted(w.frames) for pg in w.frames[s]]
                )

    async def _serve_kv_fetch(self, conn: _ServerConn, frame: dict) -> None:
        """Answer a peer's (gateway-relayed) kv_fetch from this node's
        prefix index: size-capped, seq-framed kv_pages chunks, final frame
        ``done``. The seeded ``kv.fetch_fail``/``kv.fetch_stall`` fault
        points live HERE (the serving side) so chaos tests can pin the
        requester's degradation: failed or stalled fetch → local re-prefill,
        token-exact, zero leaked pages."""
        fid = frame.get("fetch_id", "")
        chains = frame.get("chains") or []
        handoff = frame.get("handoff")
        if not isinstance(handoff, str):
            handoff = None
        max_bytes = min(
            int(frame.get("max_bytes") or _KV_FETCH_MAX_BYTES), _KV_FETCH_MAX_BYTES
        )

        self.stats["channel_server_kv_fetches_total"] += 1

        async def fail(err: str) -> None:
            self.stats["channel_server_kv_fetch_errors_total"] += 1
            await conn.send(
                {"kind": "kv_pages", "fetch_id": fid, "error": err, "done": True}
            )

        f = faults.fire("kv.fetch_stall")
        if f is not None and f.delay_s > 0:
            await asyncio.sleep(f.delay_s)
        if handoff is not None:
            # Disaggregated pools: a stalled handoff transfer must degrade
            # like a stalled prefix fetch — the decode node's wait times
            # out and admission falls back to prefilling from whatever
            # prefix it adopted (token-exact; the prefill node's published
            # pages stay reusable, its stash expires by TTL).
            f = faults.fire("kv.handoff_stall")
            if f is not None and f.delay_s > 0:
                await asyncio.sleep(f.delay_s)
        f = faults.fire("kv.fetch_fail")
        if f is not None:
            await fail(f.error)
            return
        if self._kv_export is None or not isinstance(chains, list):
            await fail("node serves no KV export")
            return
        try:
            chains_clean = [
                c for c in chains[:_KV_FETCH_MAX_CHAINS] if isinstance(c, str)
            ]
            if handoff is not None:
                # 3rd positional only when present: pre-handoff exporters
                # (2-arg test doubles) keep working for plain fetches
                pages = await self._kv_export(chains_clean, max_bytes, handoff)
            else:
                pages = await self._kv_export(chains_clean, max_bytes)
        except Exception as e:
            await fail(f"kv export failed: {e!r}")
            return
        seq = total = 0
        batch: list[dict] = []
        batch_blob = bytearray()

        async def flush(done: bool) -> None:
            # blob FIRST, then the metadata frame that names it: on one
            # unrelayed connection that is also the arrival order; across
            # the gateway relay the requester pairs them by (fid, seq)
            # regardless of order.
            nonlocal batch, batch_blob, seq
            seq += 1
            if batch_blob:
                await conn.send_bytes(_pack_kv_blob(fid, seq, bytes(batch_blob)))
            await conn.send(
                {
                    "kind": "kv_pages",
                    "fetch_id": fid,
                    "seq": seq,
                    "pages": batch,
                    "blob_len": len(batch_blob),
                    "done": done,
                }
            )
            batch, batch_blob = [], bytearray()

        for meta, payload in pages:
            # same byte accounting as the exporter's own max_bytes cap
            # (kv_export_pages), so this re-check is pure defense — it
            # drops nothing the exporter admitted
            sz = len(payload)
            if total + sz > max_bytes:
                break  # size cap: the requester re-prefills the tail
            if batch and len(batch_blob) + sz > _KV_PAGES_FRAME_BYTES:
                await flush(done=False)  # chunk: bound each WS frame
            batch.append(meta)
            batch_blob += payload
            total += sz
        await flush(done=True)

    def _kv_task(self, coro) -> None:
        t = asyncio.create_task(coro)
        self._kv_tasks.add(t)
        t.add_done_callback(self._kv_tasks.discard)

    def _purge(self) -> None:
        cutoff = time.monotonic() - self.replay_ttl_s
        stale = [
            eid for eid, st in self._execs.items() if st.done and st.done_at < cutoff
        ]
        for eid in stale:
            self._execs.pop(eid, None)

    async def close(self) -> None:
        """Node shutdown: cancel running executions (their terminal frames
        go to the buffer; the gateway's side sees the connection drop) and
        close every live socket — an open channel would otherwise hold the
        ``http.AppRunner``'s graceful shutdown for its full timeout."""
        for st in list(self._execs.values()):
            if st.task is not None and not st.task.done():
                st.task.cancel()
        tasks = [st.task for st in self._execs.values() if st.task is not None]
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
        for t in list(self._kv_tasks):
            t.cancel()
        if self._kv_tasks:
            await asyncio.gather(*list(self._kv_tasks), return_exceptions=True)
        for conn in list(self._conns):
            try:
                await conn.ws.close()
            except (ConnectionError, RuntimeError) as e:
                log.debug("channel close failed during shutdown", error=repr(e))

    async def handler(self, request: http.Request) -> http.WebSocketResponse:
        ws = http.WebSocketResponse(heartbeat=self.heartbeat_s)
        await ws.prepare(request)
        conn = _ServerConn(ws)
        self._conns.add(conn)
        self.stats["channel_server_connections_total"] += 1
        try:
            async for msg in ws:
                if msg.type == http.WSMsgType.BINARY:
                    # relayed kv page blob for one of OUR fetch_kv calls
                    self._on_kv_blob(msg.data)
                    continue
                if msg.type != http.WSMsgType.TEXT:
                    continue
                try:
                    frame = json.loads(msg.data)
                    if not isinstance(frame, dict):
                        raise ValueError("frame must be an object")
                except ValueError as e:
                    log.warning("malformed channel frame", error=repr(e))
                    continue
                await self._handle(conn, frame)
        except (ConnectionResetError, asyncio.CancelledError):
            pass  # peer gone / shutdown: running execs keep buffering for reattach
        finally:
            # Connection gone: unbind sinks, keep executions running — the
            # gateway reconnects and reattaches; frames buffer meanwhile.
            self._conns.discard(conn)
            for st in self._execs.values():
                if st.conn is conn:
                    st.conn = None
        return ws

    async def _handle(self, conn: _ServerConn, frame: dict) -> None:
        kind = frame.get("kind")
        eid = frame.get("exec_id", "")
        if kind == "submit":
            await self._submit(conn, eid, frame)
        elif kind == "cancel":
            st = self._execs.get(eid)
            self.stats["channel_server_cancels_total"] += 1
            if st is not None and not st.done and st.task is not None:
                st.task.cancel()
        elif kind == "reattach":
            await self._reattach(conn, eid, int(frame.get("last_seq", 0)))
        elif kind == "fin":
            st = self._execs.get(eid)
            if st is not None and st.done:
                self._execs.pop(eid, None)
        elif kind == "kv_fetch":
            # A peer's page request, relayed by the gateway: serve it off the
            # receive loop (the export does a device→host copy).
            self._kv_task(self._serve_kv_fetch(conn, frame))
        elif kind == "kv_pages":
            self._on_kv_pages(frame)
        elif kind == "ping":
            await conn.send({"kind": "pong"})

    async def _submit(self, conn: _ServerConn, eid: str, frame: dict) -> None:
        self.stats["channel_server_submits_total"] += 1
        self._purge()
        st = self._execs.get(eid)
        if st is not None:
            # Duplicate submit — the gateway retried/requeued an execution
            # this node already owns (e.g. a drop the recovery path resolved
            # by re-dispatch). Idempotent: re-bind and replay from 0; never
            # run the work twice.
            await conn.send({"kind": "accepted", "exec_id": eid})
            await self._replay(conn, st, last_seq=0)
            return
        st = _ServerExec(eid)
        st.conn = conn
        tr = frame.get("trace")
        if isinstance(tr, dict) and isinstance(tr.get("trace_id"), str):
            st.trace = tr
        self._execs[eid] = st
        await conn.send({"kind": "accepted", "exec_id": eid})
        st.task = asyncio.create_task(self._run(st, frame))

    async def _reattach(self, conn: _ServerConn, eid: str, last_seq: int) -> None:
        st = self._execs.get(eid)
        if st is None:
            await conn.send(
                {
                    "kind": "reattach_fail",
                    "exec_id": eid,
                    "error": "unknown execution (restart or replay TTL expired)",
                }
            )
            return
        self.stats["channel_server_reattaches_total"] += 1
        await conn.send({"kind": "reattach_ok", "exec_id": eid, "from_seq": last_seq})
        await self._replay(conn, st, last_seq)

    async def _replay(self, conn: _ServerConn, st: _ServerExec, last_seq: int) -> None:
        # Under the exec lock: frames emitted DURING the replay wait, then
        # send directly to the re-bound conn — order preserved end to end.
        async with st.lock:
            for f in st.frames:
                if f["seq"] > last_seq:
                    await conn.send(f)
            st.conn = conn

    async def _emit(self, st: _ServerExec, frame: dict) -> None:
        async with st.lock:
            st.seq += 1
            frame["seq"] = st.seq
            st.frames.append(frame)
            self.stats["channel_server_frames_total"] += 1
            if st.conn is not None:
                ok = await st.conn.send(frame)
                if not ok:
                    st.conn = None  # buffer until reattach

    async def _run(self, st: _ServerExec, frame: dict) -> None:
        target = frame.get("target", "")
        payload = frame.get("input")
        headers = frame.get("headers") or {}
        try:
            sh = self.stream_handlers.get(target)
            if sh is not None and frame.get("stream", True):

                async def emit(data: dict) -> None:
                    await self._emit(
                        st, {"kind": "token", "exec_id": st.exec_id, "data": data}
                    )

                result = await sh(payload, headers, emit)
            else:
                result = await self.invoke(target, payload, headers)
            json.dumps(result)  # fail fast: an unserializable result must be
            # a failed execution, not a dead channel write
            term = {
                "kind": "terminal",
                "exec_id": st.exec_id,
                "status": "completed",
                "result": result,
            }
        except asyncio.CancelledError:
            term = {
                "kind": "terminal",
                "exec_id": st.exec_id,
                "status": "failed",
                "error": "cancelled by gateway",
            }
        except Exception as e:
            term = {
                "kind": "terminal",
                "exec_id": st.exec_id,
                "status": "failed",
                "error": repr(e),
            }
        if st.trace is not None and self._trace_collect is not None:
            # Ship the node's spans on the terminal frame — the gateway's
            # TraceStore is the assembly point. Tracing off → no submit
            # ctx → st.trace is None → the frame is bit-identical to
            # today's (pinned).
            try:
                spans = self._trace_collect(st.trace)
            except Exception as e:
                log.debug("trace collection failed", error=repr(e))
                spans = None
            if spans:
                term["trace"] = {
                    "trace_id": st.trace.get("trace_id"), "spans": spans
                }
        st.done = True
        st.done_at = time.monotonic()
        await self._emit(st, term)


# ---------------------------------------------------------------------------
# Gateway-side: one NodeChannel per node, owned by the ChannelManager


class _Call:
    __slots__ = (
        "exec_id",
        "submit_frame",
        "accept_fut",
        "last_seq",
        "frames",
        "reattach_pending",
    )

    def __init__(self, exec_id: str, submit_frame: dict):
        self.exec_id = exec_id
        self.submit_frame = submit_frame
        self.accept_fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self.last_seq = 0
        self.frames = 0  # token frames received (== published to the stream)
        self.reattach_pending = False


class NodeChannel:
    """One persistent WS to one node, multiplexing every in-flight execution
    dispatched to it. Opened lazily on first submit; a drop with live calls
    triggers reconnect-with-backoff + per-execution reattach."""

    def __init__(self, mgr: "ChannelManager", node_id: str, base_url: str):
        self.mgr = mgr
        self.node_id = node_id
        self.base_url = base_url.rstrip("/")
        self._ws: http.ClientWebSocketResponse | None = None
        self._recv_task: asyncio.Task | None = None
        self._conn_lock = asyncio.Lock()
        self._send_lock = asyncio.Lock()
        self._calls: dict[str, _Call] = {}
        self._recovering = False
        self._bg: set[asyncio.Task] = set()

    # -- connection ----------------------------------------------------

    async def _ensure_connected(self) -> None:
        async with self._conn_lock:
            if self._ws is not None and not self._ws.closed:
                return
            await self._connect_locked()

    async def _connect_locked(self) -> None:  # guarded by: _conn_lock
        ws = await self.mgr.session.ws_connect(
            self.base_url + CHANNEL_PATH, heartbeat=self.mgr.heartbeat_s
        )
        self._ws = ws
        self.mgr.metrics.inc("channel_opens_total")
        self._recv_task = asyncio.create_task(self._recv_loop(ws))

    async def _send(self, frame: dict) -> None:
        await self._ensure_connected()
        ws = self._ws
        assert ws is not None
        async with self._send_lock:
            await ws.send_str(json.dumps(frame))
        self.mgr.metrics.inc("channel_frames_tx_total")

    async def _send_bytes(self, *parts) -> None:
        """One binary message, the concatenation of ``parts`` (a blob's
        header and its page bytes, never joined here)."""
        await self._ensure_connected()
        ws = self._ws
        assert ws is not None
        async with self._send_lock:
            await ws.send_bytes(*parts)
        self.mgr.metrics.inc("channel_frames_tx_total")

    async def close(self) -> None:
        if self._recv_task is not None:
            self._recv_task.cancel()
            await asyncio.gather(self._recv_task, return_exceptions=True)
        if self._ws is not None and not self._ws.closed:
            await self._ws.close()
        for t in list(self._bg):
            t.cancel()
        if self._bg:
            await asyncio.gather(*self._bg, return_exceptions=True)

    def _task(self, coro) -> None:
        t = asyncio.ensure_future(coro)
        self._bg.add(t)
        t.add_done_callback(self._bg.discard)

    # -- submit --------------------------------------------------------

    async def submit(self, execution_id: str, frame: dict) -> tuple[str, Any]:
        """Send one submit frame; wait for the node's ``accepted`` ack.
        Returns ``("deferred", None)`` — from here on the terminal frame
        (routed through the manager to ``gateway.complete``) owns the
        execution's completion, exactly like a 202 status callback.
        Raises ChannelUnavailable when the channel cannot carry the submit
        at all (caller falls back to the POST path)."""
        call = _Call(execution_id, frame)
        old = self._calls.get(execution_id)
        if old is not None:
            # Defensive: a resubmit racing a still-live call inherits its
            # seq watermark so a node-side replay (duplicate submits replay
            # from 0) can never republish frames the client already saw.
            call.last_seq = old.last_seq
            call.frames = old.frames
        self._calls[execution_id] = call
        self.mgr.index(execution_id, self)
        try:
            await self._send(frame)
        except (http.ClientError, ConnectionError, OSError, RuntimeError) as e:
            self._drop_call(execution_id)
            raise ChannelUnavailable(f"channel to {self.node_id}: {e!r}") from e
        try:
            async with aio_timeout(self.mgr.accept_timeout_s):
                await call.accept_fut
            self.mgr.metrics.inc("channel_submits_total")
            return ("deferred", None)
        except TimeoutError:
            self._drop_call(execution_id)
            return (
                "node_error",
                f"agent call failed: channel submit to {self.node_id} not "
                f"acknowledged within {self.mgr.accept_timeout_s}s",
            )
        except ChannelUnavailable as e:  # recovery failed mid-accept-wait
            self._drop_call(execution_id)
            return ("node_error", f"agent call failed: {e}")

    def _drop_call(self, execution_id: str) -> _Call | None:
        self.mgr.unindex(execution_id)
        return self._calls.pop(execution_id, None)

    async def cancel(self, execution_id: str) -> None:
        """Best-effort cancel: drop the call (its terminal, if any, is
        ignored — the gateway already drove its own) and tell the node to
        stop burning compute on it."""
        call = self._drop_call(execution_id)
        if call is not None and not call.accept_fut.done():
            call.accept_fut.set_exception(
                ChannelUnavailable("cancelled while awaiting accept")
            )
            call.accept_fut.exception()  # consumed: never an unretrieved warning
        try:
            await self._send({"kind": "cancel", "exec_id": execution_id})
        except (ChannelUnavailable, http.ClientError, ConnectionError, OSError, RuntimeError) as e:
            log.debug(
                "channel cancel not delivered",
                node_id=self.node_id, execution_id=execution_id, error=repr(e),
            )

    # -- receive / recovery --------------------------------------------

    async def _recv_loop(self, ws: http.ClientWebSocketResponse) -> None:
        try:
            async for msg in ws:
                if msg.type == http.WSMsgType.BINARY:
                    # a serving node's kv page blob: same chaos hook + rx
                    # accounting as text frames (a dropped blob is the new
                    # failure mode — the requester's (fid, seq) pairing must
                    # time out into a local re-prefill, and chaos tests need
                    # to be able to inject exactly that), then relay by
                    # header rewrite (payload bytes never enter JSON).
                    f = faults.fire("channel.drop")
                    if f is not None:
                        self.mgr.metrics.inc("channel_drops_injected_total")
                        log.warning("injected channel drop (blob)", node_id=self.node_id)
                        break
                    self.mgr.metrics.inc("channel_frames_rx_total")
                    self._task(self.mgr.relay_kv_blob(self.node_id, msg.data))
                    continue
                if msg.type != http.WSMsgType.TEXT:
                    continue
                f = faults.fire("channel.drop")
                if f is not None:
                    # Injected mid-stream channel kill (chaos tests): close
                    # the socket abruptly and let recovery reattach.
                    self.mgr.metrics.inc("channel_drops_injected_total")
                    log.warning("injected channel drop", node_id=self.node_id)
                    break
                try:
                    frame = json.loads(msg.data)
                    if not isinstance(frame, dict):
                        raise ValueError("frame must be an object")
                except ValueError as e:
                    self.mgr.metrics.inc("channel_malformed_frames_total")
                    log.warning("malformed channel frame", node_id=self.node_id, error=repr(e))
                    continue
                self.mgr.metrics.inc("channel_frames_rx_total")
                await self._handle_frame(frame)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            # Transport died under us: the finally below reconnects and
            # reattaches live calls — count the loop death itself so a
            # flapping socket is visible as a rate, not just log noise.
            self.mgr.metrics.inc("channel_recv_failures_total")
            log.warning("channel receive loop failed", node_id=self.node_id, error=repr(e))
        finally:
            if self._ws is ws:
                self._ws = None
            self._task(ws.close())
            if self._calls and not self._recovering:
                self._task(self._recover())

    async def _handle_frame(self, frame: dict) -> None:
        kind = frame.get("kind")
        eid = frame.get("exec_id", "")
        call = self._calls.get(eid)
        if kind == "accepted":
            if call is not None and not call.accept_fut.done():
                call.accept_fut.set_result(True)
        elif kind == "token":
            if call is None:
                return  # cancelled/unknown: discard
            if not call.accept_fut.done():
                # A token from the node IS the ack (the `accepted` frame was
                # lost to a drop): without this, the accept-wait would time
                # out and retry an execution whose frames are already
                # client-visible — exactly the duplication the seq protocol
                # forbids.
                call.accept_fut.set_result(True)
            seq = int(frame.get("seq", 0))
            if seq <= call.last_seq:
                return  # reattach-replay overlap: dedup by seq
            call.last_seq = seq
            call.frames += 1
            data = frame.get("data") or {}
            self.mgr.publish_cb(
                eid, {"kind": "token", "execution_id": eid, "seq": seq, **data}
            )
        elif kind == "terminal":
            if call is None:
                return
            if not call.accept_fut.done():
                call.accept_fut.set_result(True)  # node owns it: that's the ack
            seq = int(frame.get("seq", 0))
            if seq <= call.last_seq:
                return
            self._drop_call(eid)
            self._task(self._send({"kind": "fin", "exec_id": eid}))
            await self.mgr.terminal_cb(eid, frame)
        elif kind == "reattach_ok":
            if call is not None:
                call.reattach_pending = False
                if not call.accept_fut.done():
                    # The node owning the exec on the new connection doubles
                    # as the submit ack (the original `accepted` died with
                    # the old socket).
                    call.accept_fut.set_result(True)
                self.mgr.metrics.inc("channel_reattaches_total")
        elif kind == "reattach_fail":
            if call is not None:
                await self._lose_call(
                    call, f"reattach refused: {frame.get('error')}"
                )
        elif kind == "kv_fetch":
            # Node-originated cross-node page request: relay to the peer it
            # names (docs/PREFIX_CACHING.md "Cluster tier").
            self._task(self.mgr.relay_kv_fetch(self.node_id, frame))
        elif kind == "kv_pages":
            # A serving node's response: route back to the requester.
            self._task(self.mgr.relay_kv_pages(self.node_id, frame))
        elif kind == "pong":
            pass

    async def _lose_call(self, call: _Call, error: str) -> None:
        self._drop_call(call.exec_id)
        if not call.accept_fut.done():
            # submit() is still waiting: surface through its own path
            call.accept_fut.set_exception(ChannelUnavailable(error))
            return
        await self.mgr.lost_cb(call.exec_id, self.node_id, call.frames, error)

    async def _recover(self) -> None:
        """The channel dropped with live executions on it: reconnect with
        jittered backoff and reattach every call by (exec_id, last_seq).
        Exhaustion loses the calls — the manager's lost callback then applies
        the frames-delivered rule (requeue at zero, dead-letter otherwise)."""
        self._recovering = True
        try:
            for attempt in range(self.mgr.reattach_attempts):
                if not self._calls:
                    return
                await asyncio.sleep(
                    self.mgr.reattach_backoff_s
                    * (2**attempt)
                    * (0.5 + 0.5 * random.random())
                )
                try:
                    async with self._conn_lock:
                        if self._ws is None or self._ws.closed:
                            await self._connect_locked()
                except (http.ClientError, ConnectionError, OSError) as e:
                    log.warning(
                        "channel reconnect failed",
                        node_id=self.node_id, attempt=attempt + 1, error=repr(e),
                    )
                    continue
                self.mgr.metrics.inc("channel_reconnects_total")
                pend = list(self._calls.values())
                try:
                    for c in pend:
                        c.reattach_pending = True
                        await self._send(
                            {
                                "kind": "reattach",
                                "exec_id": c.exec_id,
                                "last_seq": c.last_seq,
                            }
                        )
                except (http.ClientError, ConnectionError, OSError, RuntimeError):
                    continue  # connection died again: next attempt
                deadline = time.monotonic() + self.mgr.reattach_ack_timeout_s
                while time.monotonic() < deadline and any(
                    c.reattach_pending for c in pend if c.exec_id in self._calls
                ):
                    await asyncio.sleep(0.02)
                for c in pend:
                    if c.exec_id in self._calls and c.reattach_pending:
                        await self._lose_call(c, "reattach unacknowledged")
                return
            for c in list(self._calls.values()):
                await self._lose_call(
                    c,
                    f"channel to {self.node_id} lost and reconnect exhausted "
                    f"after {self.mgr.reattach_attempts} attempt(s)",
                )
        finally:
            self._recovering = False


class ChannelManager:
    """Owns every NodeChannel on a gateway; the dispatch path asks
    ``supports(node)`` then ``submit(...)``. Callbacks into the gateway are
    late-bound (``bind``) to avoid an import/ownership cycle:

    - ``publish(execution_id, frame)`` — token frame → ExecutionStreams
    - ``terminal(execution_id, frame)`` — drive ``gateway.complete``
    - ``lost(execution_id, node_id, frames_delivered, error)`` — channel
      gone for good: requeue (zero frames) or dead-letter (frames exist)

    ``AGENTFIELD_CHANNEL=0`` disables the data plane entirely — every
    dispatch takes the per-execution POST path, bit-compatible with the
    pre-channel gateway (pinned by test).
    """

    def __init__(
        self,
        metrics,
        enabled: bool | None = None,
        heartbeat_s: float = 15.0,
        connect_timeout_s: float = 5.0,
        accept_timeout_s: float = 15.0,
        reattach_attempts: int = 3,
        reattach_backoff_s: float = 0.2,
        reattach_ack_timeout_s: float = 10.0,
        fallback_cooldown_s: float = 30.0,
    ):
        if enabled is None:
            enabled = os.environ.get("AGENTFIELD_CHANNEL", "1") not in ("0", "false")
        self.enabled = enabled
        self.metrics = metrics
        self.heartbeat_s = heartbeat_s
        self.connect_timeout_s = connect_timeout_s
        self.accept_timeout_s = accept_timeout_s
        self.reattach_attempts = reattach_attempts
        self.reattach_backoff_s = reattach_backoff_s
        self.reattach_ack_timeout_s = reattach_ack_timeout_s
        self.fallback_cooldown_s = fallback_cooldown_s
        self._session: http.ClientSession | None = None
        self._chans: dict[str, NodeChannel] = {}
        self._call_index: dict[str, NodeChannel] = {}
        self._broken_until: dict[str, float] = {}
        # Cross-node KV relay bookkeeping: the gateway REWRITES each relayed
        # fetch_id to a gateway-unique one (node-minted ids are only unique
        # within their process — two identical node binaries can mint the
        # same id) and maps it back on the response: gateway_fid →
        # (requesting node_id, the requester's original fetch_id, deadline).
        self._kv_relays: dict[str, tuple[str, str, float]] = {}  # guarded by: external(gateway event loop — relay frames arrive on one recv loop)
        self._kv_relay_seq = 0  # guarded by: external(gateway event loop)
        self.publish_cb: Callable[[str, dict], None] = lambda eid, f: None
        self.terminal_cb: Callable[[str, dict], Awaitable[Any]] | None = None
        self.lost_cb: Callable[[str, str, int, str], Awaitable[Any]] | None = None
        # async fn(node_id) -> AgentNode | None — the gateway's node getter,
        # needed to resolve a kv_fetch's peer to a base_url.
        self.resolve_node_cb: Callable[[str], Awaitable[Any]] | None = None

    def bind(self, publish, terminal, lost, resolve_node=None) -> None:
        self.publish_cb = publish
        self.terminal_cb = terminal
        self.lost_cb = lost
        self.resolve_node_cb = resolve_node

    @property
    def session(self) -> http.ClientSession:
        if self._session is None or self._session.closed:
            # Reads are deliberately unbounded (streams are long-lived; the
            # WS heartbeat owns liveness) but connect/handshake never hang.
            self._session = http.ClientSession(
                timeout=http.ClientTimeout(
                    total=None,
                    connect=self.connect_timeout_s,
                    sock_connect=self.connect_timeout_s,
                )
            )
        return self._session

    async def stop(self) -> None:
        for chan in list(self._chans.values()):
            await chan.close()
        self._chans.clear()
        self._call_index.clear()
        if self._session is not None and not self._session.closed:
            await self._session.close()
        self._session = None

    # -- routing -------------------------------------------------------

    def supports(self, node) -> bool:
        """Should this dispatch ride the channel? Node must advertise
        ``metadata.channel``; a node whose channel recently failed to carry
        a submit is in a fallback cooldown (POST) so callers never pay a
        connect timeout per request against a broken endpoint."""
        if not self.enabled:
            return False
        if not (node.metadata or {}).get("channel"):
            return False
        until = self._broken_until.get(node.node_id, 0.0)
        return time.monotonic() >= until

    def mark_broken(self, node_id: str) -> None:
        self._broken_until[node_id] = time.monotonic() + self.fallback_cooldown_s

    def index(self, execution_id: str, chan: NodeChannel) -> None:
        self._call_index[execution_id] = chan

    def unindex(self, execution_id: str) -> None:
        self._call_index.pop(execution_id, None)

    def inflight(self, execution_id: str) -> bool:
        return execution_id in self._call_index

    async def _chan_for(self, node) -> NodeChannel:
        chan = self._chans.get(node.node_id)
        if chan is None or chan.base_url != node.base_url.rstrip("/"):
            if chan is not None:
                # Node re-registered at a new base_url: retire the stale
                # channel (socket + recv task) instead of leaking it.
                await chan.close()
            chan = NodeChannel(self, node.node_id, node.base_url)
            self._chans[node.node_id] = chan
        return chan

    async def submit(
        self, node, execution_id: str, target_component: str,
        agent_input: Any, headers: dict[str, str], stream: bool = False,
        trace: dict | None = None,
    ) -> tuple[str, Any]:
        chan = await self._chan_for(node)
        frame = {
            "kind": "submit",
            "exec_id": execution_id,
            "target": target_component,
            "input": agent_input,
            "headers": headers,
            # Per-token framing only when a client-visible stream is open —
            # plain traffic rides the channel as submit + terminal, paying
            # nothing per token.
            "stream": stream,
        }
        if trace is not None:
            # Request-scoped tracing (docs/OBSERVABILITY.md): the node's
            # channel server collects this trace's spans onto the terminal
            # frame. Key absent entirely when tracing is off — the submit
            # frame stays bit-identical (pinned).
            frame["trace"] = trace
        try:
            return await chan.submit(execution_id, frame)
        except ChannelUnavailable:
            self.mark_broken(node.node_id)
            raise

    async def cancel(self, execution_id: str) -> None:
        chan = self._call_index.get(execution_id)
        if chan is not None:
            await chan.cancel(execution_id)

    # -- cross-node KV relay (docs/PREFIX_CACHING.md "Cluster tier") ----

    def _purge_kv_relays(self) -> None:
        t = time.monotonic()
        stale = [fid for fid, (_, _, dl) in self._kv_relays.items() if dl < t]
        for fid in stale:
            self._kv_relays.pop(fid, None)

    async def _kv_error_to(self, requester_id: str, fid: str, err: str) -> None:
        """Tell the requesting node its fetch is dead NOW — without this it
        would burn its full fetch timeout on a peer that was never going to
        answer."""
        self.metrics.inc("kv_relay_errors_total")
        chan = self._chans.get(requester_id)
        if chan is None:
            return
        try:
            await chan._send(
                {"kind": "kv_pages", "fetch_id": fid, "error": err, "done": True}
            )
        except (ChannelUnavailable, http.ClientError, ConnectionError, OSError, RuntimeError) as e:
            log.debug(
                "kv relay error frame not delivered",
                node_id=requester_id, error=repr(e),
            )

    async def relay_kv_fetch(self, requester_id: str, frame: dict) -> None:
        """Relay a node's kv_fetch to the peer it names. The gateway is a
        pure store-and-forward hop: it validates shape and caps, remembers
        fetch_id → requester, and never touches page bytes."""
        fid = frame.get("fetch_id")
        peer = frame.get("peer")
        chains = frame.get("chains")
        if not isinstance(fid, str) or not isinstance(peer, str) or not isinstance(chains, list):
            return
        self._purge_kv_relays()
        if len(self._kv_relays) >= _KV_RELAY_MAX:
            await self._kv_error_to(requester_id, fid, "kv relay at capacity")
            return
        if self.resolve_node_cb is None:
            await self._kv_error_to(requester_id, fid, "kv relay not wired")
            return
        node = await self.resolve_node_cb(peer)
        if node is None or not self.supports(node):
            await self._kv_error_to(
                requester_id, fid, f"peer {peer!r} unknown or channel-less"
            )
            return
        self._kv_relay_seq += 1
        gw_fid = f"kvr_{self._kv_relay_seq}"
        self._kv_relays[gw_fid] = (
            requester_id, fid, time.monotonic() + _KV_RELAY_TTL_S
        )
        self.metrics.inc("kv_relay_fetches_total")
        relayed = {
            "kind": "kv_fetch",
            "fetch_id": gw_fid,
            "chains": chains[:_KV_FETCH_MAX_CHAINS],
            "max_bytes": min(
                int(frame.get("max_bytes") or _KV_FETCH_MAX_BYTES),
                _KV_FETCH_MAX_BYTES,
            ),
        }
        if isinstance(frame.get("handoff"), str):
            # disaggregated pools: the handoff id rides the relay so the
            # serving peer can attach its stashed live tail page
            relayed["handoff"] = frame["handoff"]
        try:
            await (await self._chan_for(node))._send(relayed)
        except (ChannelUnavailable, http.ClientError, ConnectionError, OSError, RuntimeError) as e:
            self._kv_relays.pop(gw_fid, None)
            await self._kv_error_to(requester_id, fid, f"peer unreachable: {e!r}")

    async def relay_kv_pages(self, server_id: str, frame: dict) -> None:
        """Route a serving node's kv_pages metadata response back to the
        requester. ``server_id`` is informational (the frame correlates by
        fetch_id); unknown/expired fetch_ids are dropped — late answers
        must not leak into a request that already re-prefilled. A
        done/error frame does not delete the relay entry outright: the
        seq's binary blob may still be in flight on a sibling relay task,
        so the entry drains for ``_KV_RELAY_DRAIN_S`` instead."""
        gw_fid = frame.get("fetch_id")
        entry = self._kv_relays.get(gw_fid) if isinstance(gw_fid, str) else None
        if entry is None:
            return
        requester_id, orig_fid, _dl = entry
        if frame.get("done") or frame.get("error"):
            self._kv_relays[gw_fid] = (
                requester_id, orig_fid, time.monotonic() + _KV_RELAY_DRAIN_S
            )
        self.metrics.inc("kv_relay_frames_total")
        chan = self._chans.get(requester_id)
        if chan is None:
            return
        try:
            # translate back to the id the requester is waiting on
            await chan._send({**frame, "fetch_id": orig_fid})
        except (ChannelUnavailable, http.ClientError, ConnectionError, OSError, RuntimeError) as e:
            self.metrics.inc("kv_relay_errors_total")
            log.debug(
                "kv relay response not delivered",
                node_id=requester_id, server=server_id, error=repr(e),
            )

    async def relay_kv_blob(self, server_id: str, data: bytes) -> None:
        """Route a serving node's binary page blob back to the requester:
        parse the AFKV1 header, rewrite the gateway-unique fetch_id back to
        the requester's own, and forward the payload bytes untouched."""
        parsed = _unpack_kv_blob(data)
        if parsed is None:
            return
        gw_fid, seq, payload = parsed
        entry = self._kv_relays.get(gw_fid)
        if entry is None:
            return
        requester_id, orig_fid, _dl = entry
        self.metrics.inc("kv_relay_frames_total")
        chan = self._chans.get(requester_id)
        if chan is None:
            return
        try:
            await chan._send_bytes(_pack_kv_blob(orig_fid, seq, b""), payload)
        except (ChannelUnavailable, http.ClientError, ConnectionError, OSError, RuntimeError) as e:
            self.metrics.inc("kv_relay_errors_total")
            log.debug(
                "kv relay blob not delivered",
                node_id=requester_id, server=server_id, error=repr(e),
            )

    def cancel_soon(self, execution_id: str) -> None:
        """Fire-and-forget cancel (terminal transitions must not block on a
        dead socket)."""
        chan = self._call_index.get(execution_id)
        if chan is not None:
            chan._task(chan.cancel(execution_id))
