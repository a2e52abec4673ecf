"""Model node: the serving engine behind a stdlib HTTP server — counterpart
of ``agentfield_tpu/serving/model_node.py``.

``ModelBackend`` drives the engine on one worker thread (continuous
batching: every ``generate`` call submits a request and waits for its
terminal event) and returns the JAX node's text result dict: ``tokens``,
``logprobs``, ``finish_reason``, ``model`` and ``text``. ``deadline_s`` and
``priority`` ride into the engine's request (the JAX node validates them the
same way); a request past its deadline answers with the tokens generated so
far and ``finish_reason`` "deadline_exceeded". A waiter that gives up
(``timeout``) cancels its request in the engine. ``drain()`` closes
admission (``NodeDrainingError``, HTTP 503), lets in-flight work finish for a
grace period, then deadline-outs the rest through ``deadline_all_now``.

``generate(response_schema=...)`` decodes under the schema's grammar
(``serving.grammar``, compiled once per canonical schema into an LRU of 8):
the node's engine runs with ``grammar_slots=256`` by default, as the JAX
node's does, and the stop id falls back to the tokenizer's
``eos_token_id``.

``generate(n_branches=N, branch_policy=...)`` is the JAX node's branch
decoding: the engine forks the request into N branches after one prefill,
the node's ``branching.BranchGroup`` scores them, prunes and re-forks them
(``beam``) through the engine's ``request_cancel``/``request_fork``, and the
caller gets the winner only, with a ``branches`` summary. A policy's
``verifier`` (a ``node.reasoner`` target) reranks the settled candidates
through the control plane when the node has one (``ModelNodeServer`` sets
``ModelBackend._verifier_call``, the JAX ``build_model_node``'s
``_branch_verifier``): the candidate texts go to the reasoner on a thread of
their own, off the drive thread, so decoding goes on meanwhile (and a judge
that calls this node's ``generate`` is served); its ``{"best": i}`` or
``{"scores": [...]}`` verdict (``_parse_verdict``, the JAX node's) picks
the winner, any failure leaves the logprob winner, and
``branch_verifier_calls_total`` counts the calls. Without a control plane
the best cumulative logprob wins, as on a JAX node without the hook.
``submit_stream`` streams a request's events into a queue; a branched
stream carries the winner's events only, replayed at resolution. A caller
that gives up cancels every branch.

``generate`` takes the JAX node's request surface, so the payload
``Agent.ai()`` sends is served as the JAX node serves it: ``messages``
(``apply_chat_template``), ``context_overflow`` ("truncate_left" reports
``truncated_prompt_tokens``), ``output="text"`` and null media, and the
gateway's routing hints, as the JAX node serves them: ``kv_peer`` pulls the
prompt's missing prefix pages from the named peer node over the channel
before admission (``maybe_prefetch_kv``; every failure degrades to a local
prefill, token-exact), ``handoff_export`` makes the request phase one of a
two-phase dispatch (the result carries the ``handoff`` descriptor),
``handoff`` makes it phase two (the live tail rides the same prefetch), and
``expect_followup``/``followup_candidates`` pin the session warm and
prefill the candidates speculatively. A ``trace``
context (``agentfield_tpu_torch.tracing``) rides into the engine: the
request's lifecycle spans and the node's ``node.generate`` come back under
the result's ``trace`` key (or on the channel's terminal frame).

Multimodal serving is the JAX node's, with its tower contract
(``ModelBackend(vision=, audio=, tts=, imagegen=)``: a config name or
config draws random weights, a checkpoint directory loads CLIP/SigLIP or
Whisper weights in bf16, a ``(cfg, params)`` pair serves given weights).
``images``/``audios`` fill a prompt's ``<image>``/``<audio>`` markers: each
part is decoded (``models.media_codec``: PNG, baseline JPEG, Pillow's
bicubic resize; ``models.audio.wav_to_float``), encoded by its tower and
spliced in as placeholder ids plus an embedding span
(``Request.mm_embeds``). ``output="audio"`` speaks the prompt through the
TTS head, ``"speech"`` speaks the generated text, ``"image"`` renders the
prompt through the image-generation head; the parts come back as base64
WAV or PNG. Every tower and head forward runs on the engine's drive thread
between two ticks (``_on_engine_thread``), so none overlaps a decode
step's graph; ``media_ms`` keeps their device times. A node built without
the tower or head a request needs refuses it with BadRequestError (400),
in the JAX node's words.

``embed`` pools the final-norm hidden states of one forward through
``dense_causal_attention``, run on the engine's drive thread between ticks.

``ModelNodeServer`` serves the JAX SDK agent's HTTP contract
(``sdk/agent.py``): ``POST /reasoners/{generate,embed}`` with ``{"input":
{...}}`` answers ``{"result": {...}}``, or, with an ``X-Execution-ID``
header from the gateway, 202 now and the outcome posted to the control
plane; ``POST /generate/stream`` (SSE); ``GET /channel``, the gateway's
persistent WebSocket (``serving.channel``: token frames with a
per-execution seq, reattach, cancel; the node advertises it as
``metadata["channel"]``); ``GET /health``, ``/reasoners``, ``/stats``,
``/debug/flight`` (the engine's flight recorder); ``POST /profile/start``
and ``/profile/stop`` (a ``torch.profiler`` capture of whole engine ticks,
written as a Chrome trace). With a control plane it registers (kind
"model"), heartbeats the engine's and the channel's stats and deregisters
at stop (``sdk/node_client.py``, stdlib). ``ModelNodeServer.stop(grace_s)`` is
the JAX ``drain_and_stop``: admission closes (503), in-flight work finishes
or ends ``deadline_exceeded`` at the grace, so every stream and channel
execution gets its terminal frame, then the node deregisters and shuts
down. Answered inline, a request the node cannot serve as sent (unported
a tower or head the node was built without, an invalid schema) answers
400, an input that does not
fit the parameters or a bad argument 422, a full queue, a grammar bank or a
draining node 503. It is built on ``http.server.ThreadingHTTPServer``
because the card's machine has no aiohttp. ``start_grpc(port)`` serves
the JAX node's gRPC ``Generate`` (``ModelGrpcService``, on the port's own
HTTP/2 transport ``control_plane/grpc_h2.py``; ``aftpu model`` puts it on
the HTTP port + 100), stopped inside ``stop``'s drain.

Run a node::

    python -m agentfield_tpu_torch.serving.model_node --model llama-3-8b --port 8080 --seed 0

``--control-plane URL --node-id ID`` makes it a node of that control plane.
SIGTERM or Ctrl-C drains (``AGENTFIELD_DRAIN_GRACE`` seconds, default 30;
a second signal during the drain is ignored), deregisters and exits 0.
``--checkpoint DIR`` serves a Hugging Face checkpoint directory
(``models.hf_loader``: config and weights from the directory, bf16) with its
own tokenizer and chat template (``serving.tokenizer.HFTokenizer``, when the
directory has a ``tokenizer.json``; else the byte tokenizer, as the JAX node
falls back).

``--quant int8`` serves weight-only int8 layer projections (``models.quant``;
the int8-weight kernel on the card). ``--kv-quant-dtype int8`` (or ``fp8``)
stores the KV pages quantized, with per-slot scales
(``EngineConfig.kv_quant_dtype``). ``--spec-draft
llama-3.2-draft --spec-k 3`` decodes speculatively with a draft preset
(``load_draft_model``: random weights from the seed) or, given a directory,
a draft checkpoint (its trained weights in the target's dtype).
``--vision``, ``--audio``, ``--tts`` and ``--imagegen`` add the towers and
heads (a config name or a checkpoint directory). ``--lora DIR`` merges a
LoRA adapter (``training.lora.save_adapter``'s directory) into the fp weights
at load, before ``--quant`` quantizes them.
"""

from __future__ import annotations

import argparse
import base64
import collections
import concurrent.futures
import dataclasses
import functools
import inspect
import json
import logging
import os
import queue
import re
import signal
import tempfile
import threading
import time
import types
import typing
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable

import numpy as np
import torch

from agentfield_tpu_torch import tracing
from agentfield_tpu_torch.branching import BranchGroup, validate_branch_spec
from agentfield_tpu_torch.models import audio as audio_mod
from agentfield_tpu_torch.models import image_gen, llama, media_codec, vision as vision_mod
from agentfield_tpu_torch.models.configs import LlamaConfig, get_config
from agentfield_tpu_torch.models.llama import init_params
from agentfield_tpu_torch.models.quant import quantize_params
from agentfield_tpu_torch.ops.kv_quant import KV_QUANT_DTYPES
from agentfield_tpu_torch.sdk.node_client import ControlPlaneError, NodeControlPlaneClient
from agentfield_tpu_torch.prefix_hash import page_chain_hashes
from agentfield_tpu_torch.serving.channel import (
    CHANNEL_PATH,
    KV_FETCH_MAX_CHAINS,
    ChannelExec,
    ChannelServer,
    ExecutionCancelled,
)
from agentfield_tpu_torch.serving.engine import (
    EngineConfig,
    GrammarCapacityError,
    InferenceEngine,
    QueueFullError,
    Request,
    RequestTooLongError,
    TokenEvent,
)
from agentfield_tpu_torch.serving.grammar import Grammar, SchemaError, compile_json_schema
from agentfield_tpu_torch.serving.sampler import SamplingParams
from agentfield_tpu_torch.serving.tokenizer import ByteTokenizer, HFTokenizer
from agentfield_tpu_torch.serving.websocket import (
    SEND_TIMEOUT_S,
    HandshakeError,
    WebSocket,
    handshake_headers,
    set_send_timeout,
)

log = logging.getLogger(__name__)

GRAMMAR_SLOTS = 256  # the node's grammar bank rows, as the JAX node builds it
CONTEXT_OVERFLOW = ("error", "truncate_left")
OUTPUTS = ("text", "audio", "speech", "image")  # the JAX node's output modalities
# a node built without the tower or head a request needs (the JAX node's words)
NO_VISION = ("this model node has no vision tower (images unsupported); "
             "start it with vision=<config> to serve image inputs")
NO_AUDIO = ("this model node has no audio tower (audio inputs "
            "unsupported); start it with audio=<config> to serve them")
NO_TTS = ("this model node has no TTS head (audio output unsupported); "
          "start it with tts=<config> to serve output='audio'/'speech'")
NO_IMAGEGEN = ("this model node has no image-generation head; start it "
               "with imagegen=<config> to serve output='image'")
ROLES = ("prefill", "decode", "mixed")  # a node's pool in two-phase dispatch
SSE_PING_S = 10.0  # a token stream idle this long gets a ": ping" comment frame
EMBED_CHUNK_TOKENS = 2048  # padded tokens of one embed forward between two ticks
DRAIN_GRACE_S = 30.0  # stop()'s default grace, and main's without AGENTFIELD_DRAIN_GRACE


class BadRequestError(ValueError):
    """A request this node cannot serve as sent (HTTP 400)."""


class NodeDrainingError(QueueFullError):
    """The node is draining: admission is closed. A QueueFullError, so the
    HTTP front answers it as retryable backpressure (503)."""


class ProfileActiveError(RuntimeError):
    """A profiler capture is already active (``/profile/start``: 409)."""


def _check_branch_compat(response_schema, images, audios) -> None:
    if response_schema is not None:
        raise ValueError(
            "branch decoding is incompatible with response_schema "
            "(constrained decoding owns the sampler mask)"
        )
    if images or audios:
        raise ValueError("branch decoding does not take media inputs")


def _prompt_byte_ids(text: str, max_chars: int) -> tuple[np.ndarray, int, int]:
    """UTF-8 text → ([1, max_chars] int32 padded byte ids, bytes used, bytes
    cut): the byte-level heads' truncation (TTS, image generation). A cut
    inside a multibyte character drops that character's leading bytes too."""
    full = text.encode("utf-8")
    data = full
    if len(full) > max_chars:
        data = full[:max_chars]
        i = len(data) - 1
        while i >= 0 and (data[i] & 0xC0) == 0x80:
            i -= 1
        if i >= 0 and data[i] >= 0xC0:
            lead = data[i]
            need = 2 if lead < 0xE0 else 3 if lead < 0xF0 else 4
            if len(data) - i < need:
                data = data[:i]
    ids = np.zeros((1, max_chars), np.int32)
    if data:
        ids[0, : len(data)] = np.frombuffer(data, np.uint8)
    return ids, len(data), len(full) - len(data)


def _media_model(spec, configs: dict, get_cfg, cfg_type, init, seed: int, device,
                 load_ckpt=None, lm_hidden: int | None = None, kind: str = ""):
    """(cfg, params) of a tower or head, or (None, None) for None: a
    registered config name first, then (towers: ``load_ckpt`` given) a
    checkpoint directory loaded in bf16 on ``device``, else ``get_cfg``'s
    known-names error; a config draws random weights from ``seed``; a
    ``(cfg, params)`` pair passes through. A tower's ``out_dim`` must be
    ``lm_hidden``."""
    if spec is None:
        return None, None
    if isinstance(spec, str):
        if spec not in configs and load_ckpt is not None and os.path.isdir(spec):
            spec = load_ckpt(spec, out_dim=lm_hidden, dtype="bfloat16", device=device)
        else:
            spec = get_cfg(spec)
    if isinstance(spec, cfg_type):
        spec = (spec, init(spec, seed, device))
    cfg, params = spec
    if lm_hidden is not None and cfg.out_dim != lm_hidden:
        raise ValueError(f"{kind} out_dim={cfg.out_dim} must match the "
                         f"LM hidden_size={lm_hidden}")
    return cfg, params


def embed_chunks(lens: list[int], budget: int) -> list[list[int]]:
    """The row indices of each forward of an embed: rows in order of
    length, cut where the next row would pad the chunk past ``budget``
    tokens (a longer row goes alone)."""
    chunks: list[list[int]] = []
    for i in sorted(range(len(lens)), key=lambda i: lens[i]):
        if chunks and (len(chunks[-1]) + 1) * lens[i] <= budget:
            chunks[-1].append(i)
        else:
            chunks.append([i])
    return chunks


def embed_rows(params: dict[str, Any], cfg: LlamaConfig, rows: list[list[int]],
               pooling: str = "mean", attn_impl: str = "kernel", mesh=None) -> torch.Tensor:
    """L2-normalized ``[B, D]`` float32 embeddings of token ``rows``: one
    dense forward over the rows padded to the longest, final-norm hidden
    states (``forward(return_hidden=True)``), mean- or last-pooled over each
    row's real tokens. ``attn_impl="kernel"`` takes
    ``dense_causal_attention`` (its plain version on CPU tensors). Under a
    tensor-parallel ``mesh`` each rank runs its share of the forward
    (``InferenceEngine.embed_rows`` sends it to the workers)."""
    dev = params["embed"].device
    B, S = len(rows), max(len(r) for r in rows)
    padded = torch.zeros((B, S), dtype=torch.long)
    for i, r in enumerate(rows):
        padded[i, : len(r)] = torch.tensor(r, dtype=torch.long)
    toks = padded.to(dev)
    nv = torch.tensor([len(r) for r in rows], device=dev)
    pos = torch.arange(S, device=dev).expand(B, S)
    with torch.inference_mode():
        h, _ = llama.forward(params, cfg, toks, pos, attn_impl=attn_impl, collect_kv=False,
                             return_hidden=True, mesh=mesh)
        h = h.float()
        if pooling == "mean":
            real = (torch.arange(S, device=dev)[None, :] < nv[:, None])[..., None]
            v = torch.where(real, h, 0.0).sum(dim=1) / nv[:, None]
        else:
            v = h[torch.arange(B, device=dev), nv - 1]
        return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(1e-9)


class ModelBackend:
    def __init__(
        self,
        params: dict[str, Any],
        cfg: LlamaConfig,
        ecfg: EngineConfig | None = None,
        tokenizer=None,
        seed: int = 0,
        model_name: str = "custom",
        device: str | torch.device | None = None,
        idle_sleep: float = 0.002,
        draft: tuple[dict[str, Any], LlamaConfig] | None = None,
        vision=None,
        audio=None,
        tts=None,
        imagegen=None,
        restore_budget_bytes: int | None = None,
        mesh=None,
    ):
        """``mesh`` makes this node's engine rank 0 of a tensor-parallel
        engine (``InferenceEngine(mesh=)``; ``build_model_node(tp=)`` starts
        its workers); the towers and heads then live on rank 0 only, and a
        prompt's embeddings reach the workers inside its prefill operation.
        ``vision``/``audio`` (input towers) and ``tts``/``imagegen``
        (output heads) follow the JAX node's contract: a config name or
        config object draws random weights from ``seed`` + 1, + 2, + 3 and
        + 5, a checkpoint directory (towers only) loads pretrained weights
        in bf16, a ``(cfg, params)`` pair is served as given; the input
        towers' ``out_dim`` must be the LM's hidden size. All on the
        engine's device. ``restore_budget_bytes`` is the engine's (the host
        store pages fetched from a peer wait in)."""
        self.cfg = cfg
        self.model_name = model_name
        self.tokenizer = tokenizer
        if ecfg is None:
            ecfg = EngineConfig(grammar_slots=GRAMMAR_SLOTS)
        self.engine = InferenceEngine(params, cfg, ecfg, seed=seed, device=device, draft=draft,
                                      restore_budget_bytes=restore_budget_bytes, mesh=mesh)
        dev = self.engine.device
        D = cfg.hidden_size
        self.vision_cfg, self.vision_params = _media_model(
            vision, vision_mod.CONFIGS, vision_mod.get_vision_config, vision_mod.VisionConfig,
            vision_mod.init_vision_params, seed + 1, dev, vision_mod.load_clip_vision, D, "vision")
        self.audio_cfg, self.audio_params = _media_model(
            audio, audio_mod.CONFIGS, audio_mod.get_audio_config, audio_mod.AudioConfig,
            audio_mod.init_audio_params, seed + 2, dev, audio_mod.load_whisper_encoder, D, "audio")
        self.tts_cfg, self.tts_params = _media_model(
            tts, audio_mod.TTS_CONFIGS, audio_mod.get_tts_config, audio_mod.TTSConfig,
            audio_mod.init_tts_params, seed + 3, dev)
        self.imagegen_cfg, self.imagegen_params = _media_model(
            imagegen, image_gen.CONFIGS, image_gen.get_imagegen_config, image_gen.ImageGenConfig,
            image_gen.init_imagegen_params, seed + 5, dev)
        # (kind, device ms) of each tower or head forward: CUDA events
        self.media_ms: collections.deque[tuple[str, float]] = collections.deque(maxlen=1024)
        self.idle_sleep = idle_sleep
        # canonical schema JSON -> compiled grammar, least recently used out
        self._grammars: collections.OrderedDict[str, Grammar] = collections.OrderedDict()
        self._grammars_max = 8
        self._grammar_lock = threading.Lock()
        # rid -> its event queue (``generate`` reads one too); under _lock
        self._streams: dict[str, queue.Queue] = {}
        # branch decoding: every branch rid -> its group; a group's parent
        # rid -> its caller's event queue; the resolved summary of a group.
        # Under _lock; the groups
        # themselves are driven on the engine thread only
        self._groups: dict[str, BranchGroup] = {}
        self._group_sinks: dict[str, queue.Queue] = {}
        self._group_meta: dict[str, dict] = {}
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._next = 0
        self._thread: threading.Thread | None = None
        self.error: BaseException | None = None
        self._draining = False
        # work that must not overlap a tick (embed forwards): run by the
        # drive thread between ticks; under _lock
        self._jobs: list[tuple[Any, concurrent.futures.Future]] = []
        self.embed_ms: collections.deque[float] = collections.deque(maxlen=1024)  # CUDA events
        self._profile: dict[str, Any] = {"prof": None, "dir": None}  # under _profile_lock
        self._profile_lock = threading.Lock()
        # the cluster tier: the transport of this node's own fetches
        # (``ChannelServer.fetch_kv``, wired by the server), off with
        # $AGENTFIELD_KV_FETCH=0 (the node then honors no kv_peer hint; it
        # still serves peers), and the fetches in flight by (peer, first
        # missing chain or handoff id): a same-prefix burst makes one
        # transfer, the others wait for its adoption
        self._kv_fetch_fn: Callable[..., list[dict] | None] | None = None
        self.kv_fetch_enabled = os.environ.get("AGENTFIELD_KV_FETCH", "1").lower() not in (
            "0", "false", "no")
        self.kv_fetch_timeout_s = 5.0
        self._kv_prefetch_inflight: dict[tuple, threading.Event] = {}  # under _lock
        # branch groups' verifier: blocking (target, payload) -> the
        # reasoner's result, raising on any failure; set by the server when
        # the node has a control plane (``ModelNodeServer._verify``)
        self._verifier_call: Callable[[str, dict], Any] | None = None
        # (pages, bytes, seconds) of each prefetch that adopted pages
        self.kv_fetch_log: collections.deque[tuple[int, int, float]] = collections.deque(
            maxlen=1024)

    def start(self) -> None:
        """Start the drive loop; a backend started again after ``stop``
        admits again (its drain ended with the stop)."""
        if self._thread is None:
            self._draining = False
            self._stop.clear()
            self._thread = threading.Thread(target=self._drive_loop, name="engine", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        """Stop the drive loop, then leave no caller waiting (the JAX
        backend's ``stop``): every open request's queue gets a terminal
        error event (a waiting ``generate`` raises it), queued jobs fail;
        then the engine's offload worker closes. ``drain`` first to let
        work finish. Idempotent."""
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        stopped = RuntimeError("model node stopped")
        with self._lock:
            streams, self._streams = self._streams, {}
            groups = list({id(g): g for g in self._groups.values()}.values())
        for rid, q in streams.items():
            q.put(TokenEvent(request_id=rid, token=-1, index=-1, finished=True,
                             finish_reason=f"error: {stopped}"))
        for g in groups:
            self._fail_group(g, stopped)
        self._fail_jobs(stopped)
        with self._profile_lock:
            prof, self._profile["prof"] = self._profile["prof"], None
        if prof is not None:
            prof.stop()
        self.engine.close()

    def _drive_loop(self) -> None:
        """Continuous-batching driver: engine.step() until stopped. A step
        failure fails every waiting request with the real error (the
        engine's state may be corrupt) and stops the loop."""
        if self.engine.device.type == "cuda":
            # kernels launch on this thread's current device and stream
            torch.cuda.set_device(self.engine.device)
        last_gc = time.monotonic()
        while not self._stop.is_set():
            if self._jobs:
                self._run_job()  # one between two ticks
            if not self.engine.has_work():
                if self._jobs:
                    continue
                if time.monotonic() - last_gc > 30.0:
                    last_gc = time.monotonic()
                    self.engine.gc_sessions()
                self._wake.wait(timeout=self.idle_sleep * 50)
                self._wake.clear()
                continue
            try:
                events = self.engine.step()
            except Exception as e:  # noqa: BLE001 — surfaced to every waiter
                with self._lock:  # _submit checks error under this lock
                    self.error = e
                    streams, self._streams = self._streams, {}
                    groups = {id(g): g for g in self._groups.values()}.values()
                # the flight recorder is the crash dump: the ticks before the failure
                log.exception("engine step failed; failing %d waiting requests; flight recorder: %s",
                              len(streams), json.dumps(self.engine.flight.snapshot(last=64)))
                for rid, q in streams.items():
                    q.put(_error_event(rid, e))
                for g in list(groups):
                    self._fail_group(g, e)
                self._fail_jobs(RuntimeError(f"engine step failed: {e!r}"))
                return
            for ev in events:
                with self._lock:
                    group = self._groups.get(ev.request_id)
                    stream = self._streams.get(ev.request_id)
                    if stream is not None and ev.finished:
                        del self._streams[ev.request_id]
                if group is not None:
                    # a branch's events feed its group, never the caller
                    self._on_group_event(group, ev)
                    continue
                if stream is not None:
                    stream.put(ev)

    def _grammar_for(self, schema: dict[str, Any]) -> Grammar:
        """Compile (once) the token-level grammar of a JSON schema; the cache
        key is the canonical schema text, so identical schemas share one
        grammar and one registration in the engine's bank."""
        if self.tokenizer is None:
            raise BadRequestError("constrained decoding needs a tokenizer on this node")
        key = json.dumps(schema, sort_keys=True)
        with self._grammar_lock:
            g = self._grammars.get(key)
            if g is None:
                vocab = self.tokenizer.token_bytes(self.cfg.vocab_size)
                g = self._grammars[key] = compile_json_schema(schema, vocab)
            self._grammars.move_to_end(key)
            while len(self._grammars) > self._grammars_max:
                # the engine's bank keeps its own reference until its rows
                # evict, so requests in flight are unaffected
                self._grammars.popitem(last=False)
            return g

    def generate(
        self,
        prompt: str | None = None,
        tokens: list[int] | None = None,
        messages: list[dict] | None = None,
        max_new_tokens: int = 128,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        stop_token_ids: list[int] | None = None,
        session_id: str | None = None,
        response_schema: dict[str, Any] | None = None,
        context_overflow: str = "error",
        images: list | None = None,
        audios: list | None = None,
        output: str = "text",
        deadline_s: float | None = None,
        priority: int = 0,
        n_branches: int = 1,
        branch_policy: Any = None,
        kv_peer: dict | None = None,
        handoff_export: bool = False,
        handoff: dict | None = None,
        trace: dict | None = None,
        expect_followup: bool = False,
        followup_candidates: list | None = None,
        timeout: float | None = None,
        on_cancel: Callable[[Callable[[], None]], None] | None = None,
    ) -> dict[str, Any]:
        """Generate from a text ``prompt``, from ``tokens`` or from chat
        ``messages`` (``apply_chat_template``); blocks until the request
        finishes. The parameters are the JAX node's: ``context_overflow``
        "truncate_left" keeps the prompt's last ``max_context -
        max_new_tokens`` tokens and reports ``truncated_prompt_tokens``
        ("error" lets the engine refuse it); ``response_schema`` (a JSON
        schema) constrains the output to it; ``deadline_s`` bounds the
        request's wall time in the engine (``finish_reason``
        "deadline_exceeded", partial tokens kept); ``priority`` is its
        admission tier; ``n_branches`` > 1 forks it into branches under
        ``branch_policy`` and answers the winner with a ``branches`` summary.
        ``images``/``audios`` fill the prompt's ``<image>``/``<audio>``
        markers through the node's towers; ``output`` "audio" speaks the
        prompt, "speech" the generated text (a WAV part), "image" renders
        the prompt (a PNG part), as the JAX node does. ``kv_peer`` (a token
        prompt only) pulls the prompt's missing prefix pages from that node
        before admission; ``handoff_export`` makes this phase one of a
        two-phase dispatch (``finish_reason`` "handoff" and the ``handoff``
        descriptor in the result), ``handoff`` phase two; with
        ``expect_followup`` the session stays pinned warm and each of
        ``followup_candidates`` (strings or token lists) is prefilled
        speculatively. With a ``trace`` context
        the engine records the request's spans, the node its
        ``node.generate`` span, and the result carries them all under
        ``trace`` (``{"trace_id", "spans"}``). Raises QueueFullError
        (NodeDrainingError while draining) / RequestTooLongError / GrammarCapacityError from
        admission, BadRequestError (or the grammar's SchemaError) for a
        request the node cannot serve (a tower or head it was built
        without among them), ValueError for a bad argument,
        RuntimeError if the engine failed, and TimeoutError after cancelling
        the request (every branch of it) when ``timeout`` runs out.
        ``on_cancel(fn)``, given, registers the hook that cancels the
        request (a gateway's cancel of a unary channel execution), after
        which this raises ExecutionCancelled."""
        if output not in OUTPUTS:
            raise ValueError(
                f"unknown output modality {output!r}: 'text' | 'audio' "
                "(synthesize the prompt) | 'speech' (generate, then "
                "synthesize the generated text) | 'image' (render the prompt)"
            )
        n_branches, branch_policy = validate_branch_spec(n_branches, branch_policy)
        if n_branches > 1:
            if output != "text":
                raise ValueError("branch decoding (n_branches > 1) is text-only")
            _check_branch_compat(response_schema, images, audios)
        if messages is not None:
            if prompt is not None or tokens is not None:
                raise ValueError("messages is exclusive with prompt/tokens")
            prompt = self.apply_chat_template(messages)
        if output in ("audio", "speech") and self.tts_cfg is None:
            raise BadRequestError(NO_TTS)  # before any decode
        if output == "image":
            if self.imagegen_cfg is None:
                raise BadRequestError(NO_IMAGEGEN)
            if images or audios:
                raise ValueError("output='image' renders the prompt — media inputs would "
                                 "be silently dropped")
            if not prompt:
                raise ValueError("output='image' requires a text prompt")
            png_b64, cut = self._render_png_b64(prompt)
            out = {"text": prompt,
                   "parts": [{"type": "image", "mime": "image/png", "data_b64": png_b64}],
                   "model": self.model_name, "finish_reason": "imagegen", "tokens": []}
            if cut:
                out["imagegen_truncated_chars"] = cut
            return out
        if output == "speech" and self.tokenizer is None:
            raise ValueError("output='speech' needs a tokenizer on this node (the "
                             "generated text is what gets synthesized)")
        if output == "audio":
            if images or audios:
                raise ValueError("output='audio' speaks the prompt verbatim — media "
                                 "inputs would be silently dropped; use output='speech' "
                                 "to understand media and speak the response")
            if not prompt:
                raise ValueError("output='audio' requires a text prompt")
            wav_b64, cut = self._synthesize_wav_b64(prompt)
            out = {"text": prompt,
                   "parts": [{"type": "audio", "mime": "audio/wav", "data_b64": wav_b64}],
                   "model": self.model_name, "finish_reason": "tts", "tokens": []}
            if cut:
                out["tts_truncated_chars"] = cut
            return out
        trace = tracing.valid_context(trace)
        t0 = time.time(), time.perf_counter()
        if kv_peer is not None and tokens is not None and not (images or audios):
            self.maybe_prefetch_kv(tokens, kv_peer)
        q: queue.Queue = queue.Queue()
        rid, truncated = self._submit(
            q, prompt, tokens, max_new_tokens, temperature, top_k, top_p,
            stop_token_ids, session_id, response_schema, context_overflow, images, audios,
            deadline_s, priority, n_branches, branch_policy, expect_followup,
            followup_candidates, trace, handoff_export=handoff_export, handoff=handoff)
        if on_cancel is not None:
            on_cancel(lambda: q.put(None))
        result = self.collect_result(rid, q, truncated, trace, t0, timeout=timeout)
        if handoff_export and result.get("finish_reason") == "handoff":
            # phase one's terminal: the descriptor goes back to the gateway,
            # which dispatches phase two to a decode node
            desc = self.engine.pop_handoff_desc(rid)
            if desc is not None:
                result["handoff"] = desc
        if output == "speech":  # speak the generated text
            wav_b64, cut = self._synthesize_wav_b64(result.get("text", ""))
            result["parts"] = [{"type": "audio", "mime": "audio/wav", "data_b64": wav_b64}]
            if cut:
                result["tts_truncated_chars"] = cut
        if trace is not None:
            result["trace"] = {"trace_id": trace["trace_id"],
                               "spans": self.collect_trace_spans(trace)}
        return result

    def submit_stream(
        self,
        prompt: str | None = None,
        tokens: list[int] | None = None,
        max_new_tokens: int = 128,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        stop_token_ids: list[int] | None = None,
        session_id: str | None = None,
        response_schema: dict[str, Any] | None = None,
        context_overflow: str = "error",
        images: list | None = None,
        audios: list | None = None,
        deadline_s: float | None = None,
        priority: int = 0,
        n_branches: int = 1,
        branch_policy: Any = None,
        trace: dict | None = None,
        handoff: dict | None = None,
        expect_followup: bool = False,
        followup_candidates: list | None = None,
    ) -> tuple[str, queue.Queue, int]:
        """Streaming variant of ``generate``: returns ``(request_id, queue,
        truncated_prompt_tokens)``, the queue holding the request's
        TokenEvents, the last one finished. A branched stream emits nothing
        while its branches decode; at resolution the winner's events replay
        under ``request_id``, then one terminal, and
        ``pop_group_meta(request_id)`` gives the ``branches`` summary.
        ``release_stream`` when the consumer goes away. A ``trace`` context
        gets the request's engine spans (``collect_trace_spans``)."""
        n_branches, branch_policy = validate_branch_spec(n_branches, branch_policy)
        if n_branches > 1:
            _check_branch_compat(response_schema, images, audios)
        q: queue.Queue = queue.Queue()
        rid, truncated = self._submit(
            q, prompt, tokens, max_new_tokens, temperature, top_k, top_p,
            stop_token_ids, session_id, response_schema, context_overflow, images, audios,
            deadline_s, priority, n_branches, branch_policy, expect_followup,
            followup_candidates, tracing.valid_context(trace), handoff=handoff)
        return rid, q, truncated

    def collect_trace_spans(self, ctx) -> list[dict]:
        """Pop a trace's spans from the process's buffer, each stamped with
        the dispatch labels of the gateway's context (``node``,
        ``attempt``): the waterfall must say which node served which
        attempt, which the engine's spans cannot know."""
        ctx = tracing.valid_context(ctx)
        if ctx is None:
            return []
        spans = tracing.tracer().pop(ctx["trace_id"])
        for key in ("node", "attempt"):
            if ctx.get(key) is not None:
                for s in spans:
                    s.setdefault(key, ctx[key])
        return spans

    def release_stream(self, rid: str) -> None:
        """The consumer of ``rid``'s stream is gone: cancel its request (a
        branched one whole) if it still runs."""
        self._abandon(rid)
        with self._lock:
            self._group_meta.pop(rid, None)

    def pop_group_meta(self, rid: str) -> dict | None:
        """The ``branches`` summary of a resolved streamed group (once)."""
        with self._lock:
            return self._group_meta.pop(rid, None)

    def _submit(self, q, prompt, tokens, max_new_tokens, temperature, top_k, top_p,
                stop_token_ids, session_id, response_schema, context_overflow, images,
                audios, deadline_s, priority, n_branches, branch_policy, expect_followup,
                followup_candidates, trace, handoff_export: bool = False,
                handoff: dict | None = None) -> tuple[str, int]:
        """Validate, register the event queue ``q`` for the new request id
        and submit the request to the engine; returns ``(id, prompt tokens
        truncated)``."""
        if self._draining:
            raise NodeDrainingError("node is draining (rolling restart): not admitting new work")
        mm_embeds = None
        if images or audios:
            if tokens is not None:
                raise ValueError("media inputs require a text 'prompt', not 'tokens'")
            if prompt is None:
                raise ValueError("media inputs require a text 'prompt'")
            tokens, mm_embeds = self._fuse_media(prompt, images, audios)
        elif tokens is None:
            if prompt is None:
                raise ValueError("one of 'prompt' or 'tokens' is required")
            if self.tokenizer is None:
                raise ValueError("no tokenizer loaded on this model node; pass 'tokens'")
            tokens = self.tokenizer.encode(prompt)
        if context_overflow not in CONTEXT_OVERFLOW:
            raise ValueError(f"unknown context_overflow policy {context_overflow!r}")
        truncated = 0
        if mm_embeds and context_overflow == "truncate_left":
            # a cut would sever a media span: an over-long multimodal prompt fails
            budget = self.engine.ecfg.max_context - max_new_tokens
            if len(tokens) > budget:
                raise RequestTooLongError(
                    f"multimodal prompt ({len(tokens)} tokens incl. media "
                    f"embeddings) exceeds the {budget}-token budget and "
                    "cannot be truncated")
        elif context_overflow == "truncate_left":
            budget = self.engine.ecfg.max_context - max_new_tokens
            if budget < 1:
                raise ValueError(
                    f"max_new_tokens={max_new_tokens} leaves no room for a "
                    f"prompt in a {self.engine.ecfg.max_context}-token context"
                )
            if len(tokens) > budget:
                # keep the tail: the most recent turns matter most
                truncated = len(tokens) - budget
                tokens = tokens[-budget:]
        grammar = None
        if response_schema is not None:
            if not isinstance(response_schema, dict):
                raise BadRequestError("response_schema must be a JSON object")
            grammar = self._grammar_for(response_schema)
            if not stop_token_ids:
                eos = getattr(self.tokenizer, "eos_token_id", None)
                if eos is None:
                    raise BadRequestError(
                        "constrained decoding needs stop_token_ids (tokenizer has no eos_token_id)"
                    )
                stop_token_ids = [eos]
        cand_tokens = self._followup_cand_tokens(
            followup_candidates if expect_followup else None)
        with self._lock:
            if self.error is not None:
                raise RuntimeError(f"engine stopped after a failed step: {self.error!r}")
            self._next += 1
            rid = f"gen_{self._next}"
            if n_branches > 1:
                g = BranchGroup(rid, n_branches, branch_policy)
                for r in g.branch_rids():
                    self._groups[r] = g
                self._group_sinks[rid] = q
            else:
                self._streams[rid] = q
        try:
            self.engine.submit(
                Request(
                    id=rid,
                    prompt=[int(t) for t in tokens],
                    sampling=SamplingParams(
                        temperature=temperature, top_k=top_k, top_p=top_p,
                        max_new_tokens=max_new_tokens,
                        stop_token_ids=tuple(stop_token_ids or ()),
                    ),
                    session_id=session_id,
                    grammar=grammar,
                    deadline_s=deadline_s,
                    priority=priority,
                    n_branches=n_branches,
                    trace=trace,
                    mm_embeds=mm_embeds,
                    handoff_export=bool(handoff_export),
                    handoff=handoff,
                    expect_followup=bool(expect_followup),
                    followup_candidates=cand_tokens,
                )
            )
        except Exception:
            with self._lock:
                self._forget(rid)
            raise
        self._wake.set()
        return rid, truncated

    def _followup_cand_tokens(self, cands) -> list[list[int]] | None:
        """Declared follow-up candidates as token lists (the JAX node's
        contract): no tokenizer for a string, an empty candidate, or more
        than the engine's ``spec_max_candidates`` drop; a container that is
        not a list or an element of the wrong type raises ValueError."""
        if not cands:
            return None
        if not isinstance(cands, (list, tuple)):
            raise ValueError(
                f"followup_candidates must be a list, got {type(cands).__name__}"
            )
        cap = max(0, self.engine.ecfg.spec_max_candidates)
        out: list[list[int]] = []
        for cand in cands:
            if len(out) >= cap:
                break
            if isinstance(cand, str):
                if self.tokenizer is None:
                    continue
                toks = self.tokenizer.encode(cand)
            elif isinstance(cand, (list, tuple)):
                toks = list(cand)
                if not all(isinstance(t, int) and not isinstance(t, bool) for t in toks):
                    raise ValueError(
                        "followup_candidates token lists must contain only ints"
                    )
            else:
                raise ValueError(
                    "each followup candidate must be a string or a token list, "
                    f"got {type(cand).__name__}"
                )
            if toks:
                out.append(toks)
        return out or None

    # -- the cluster tier: serving a peer's fetch, pulling from a peer -------

    def kv_export_pages(self, chains_hex: list[str], max_bytes: int,
                        handoff: str | None = None) -> list[tuple[dict, bytes]]:
        """Serve a peer's ``kv_fetch`` (the JAX node's ``kv_export_pages``):
        each requested chain indexed here as ``(meta, payload)``, meta its
        chain, depth, leaves (``{"dtype", "shape"}``, a quantized pool's
        scales among them) and segment lengths, payload the leaves' raw
        bytes, until ``max_bytes``. With ``handoff`` the stashed tail page of
        that handoff comes first (its meta names ``handoff``, not a chain)
        and leaves the stash."""
        chains = []
        for c in chains_hex:
            try:
                b = bytes.fromhex(c)
            except (TypeError, ValueError):
                continue
            if len(b) == 16:
                chains.append(b)
        eng = self.engine
        parts = [{"dtype": d, "shape": list(sh)} for d, sh in eng.page_payload_spec()]
        raw = eng.export_kv_pages(chains)
        tail = eng.export_handoff_tail(handoff) if handoff else None
        pages: list[tuple[dict, bytes]] = []
        total = wire_saved = handoff_bytes = 0
        segs = eng.page_payload_segs()  # every head, under a mesh too
        size = sum(segs)  # every page's payload: the leaves' bytes in order
        if tail is not None and size <= max_bytes:
            # ahead of the chain pages: the byte cap must never starve the
            # one page phase two cannot re-derive from the index
            pages.append(({"handoff": handoff, "parts": parts, "segs": segs},
                          eng.page_payload_bytes(tail[1])))
            total = handoff_bytes = size
        for chain, depth, payload in raw:
            if total + size > max_bytes:
                break
            pages.append(({"chain": chain.hex(), "depth": int(depth), "parts": parts,
                           "segs": segs}, eng.page_payload_bytes(payload)))
            total += size
            if eng.ecfg.kv_quant_dtype != "none":
                # against what the dense page would put on the wire
                wire_saved += max(0, eng.kv_page_bytes_dense - size)
        with self._lock:
            eng.stats["kv_fetch_served_total"] += len(pages)
            eng.stats["kv_fetch_bytes_total"] += total
            eng.stats["kv_quant_wire_bytes_saved_total"] += wire_saved
            eng.stats["kv_handoff_bytes_total"] += handoff_bytes
        return pages

    def _count_kv(self, key: str) -> None:
        with self._lock:
            self.engine.stats[key] += 1

    def maybe_prefetch_kv(self, tokens: list[int] | None, hint: Any) -> int:
        """Pull the prompt's missing prefix pages from the peer the gateway
        named (the ``kv_peer`` hint) into the host store, before the
        request is submitted: its admission restores them as it restores
        demoted pages. Only the missing range is asked for, in fetches of at
        most ``KV_FETCH_MAX_CHAINS`` pages; each page is checked leaf by
        leaf against ``page_payload_spec`` and a gap ends the adoptable
        prefix. With the hint's ``handoff`` id the first fetch also brings
        the phase-1 tail page, stashed for the live install. A same-prefix
        burst makes one transfer (the others wait for it, then let the
        lookup find its pages). Every failure (no channel, a dead peer, a
        timeout, a malformed page, ``kv.fetch_fail``, ``kv.fetch_stall``)
        degrades to a local prefill, token-exact. Returns the pages
        adopted."""
        if (not self.kv_fetch_enabled or self._kv_fetch_fn is None
                or not isinstance(hint, dict) or not tokens or len(tokens) < 2):
            return 0
        peer = hint.get("node_id")
        ps = self.engine.ecfg.page_size
        if not isinstance(peer, str) or hint.get("page_size") != ps:
            return 0  # another page geometry: the chains can never align
        hid = hint.get("handoff") if isinstance(hint.get("handoff"), str) else None
        matchable = [int(t) for t in tokens[: len(tokens) - 1]]
        hashes = page_chain_hashes(matchable, ps)
        local = self.engine.peek_prefix(matchable) // ps
        try:
            want = int(hint.get("pages") or len(hashes))
        except (TypeError, ValueError):
            want = len(hashes)
        missing = hashes[local : min(want, len(hashes))]
        if not missing and hid is None:
            return 0
        # a handoff pull is unique to its id: it never leads a plain burst
        key = (peer, ("handoff", hid) if hid is not None else missing[0])
        with self._lock:
            leader = self._kv_prefetch_inflight.get(key)
            if leader is None:
                done = self._kv_prefetch_inflight[key] = threading.Event()
        if leader is not None:
            leader.wait()
            return 0
        try:
            return self._prefetch(peer, matchable, missing, local, hid)
        finally:
            with self._lock:
                self._kv_prefetch_inflight.pop(key, None)
            done.set()

    def _page_leaves(self, pg: dict, spec) -> list[torch.Tensor]:
        """One page's wire leaves as host tensors (a byte view each, cast to
        the leaf's dtype), checked against this pool's ``spec``."""
        parts, segs = pg["parts"], [int(x) for x in pg["segs"]]
        data = memoryview(pg["data"])
        if data.readonly:  # torch views writable buffers only
            data = memoryview(bytearray(data))
        if len(parts) != len(spec) or len(segs) != len(spec):
            raise ValueError("payload leaf count mismatch")
        if sum(segs) != len(data):
            raise ValueError(f"payload of {len(data)} bytes, segments of {sum(segs)}")
        leaves, off = [], 0
        for part, seg, (name, shape) in zip(parts, segs, spec):
            if (part["dtype"], tuple(part["shape"])) != (name, shape):
                raise ValueError(f"leaf {part} != expected {(name, shape)}")
            raw = torch.frombuffer(data[off : off + seg], dtype=torch.uint8)
            leaves.append(raw.view(getattr(torch, name)).view(shape))
            off += seg
        return leaves

    def _prefetch(self, peer: str, matchable: list[int], missing: list[bytes], local: int,
                  hid: str | None) -> int:
        eng, ps = self.engine, self.engine.ecfg.page_size
        spec = eng.page_payload_spec()
        t0 = time.perf_counter()
        adopted = nbytes = 0
        depth = local
        first = True
        while missing or (first and hid is not None):
            chunk = missing[:KV_FETCH_MAX_CHAINS]
            self._count_kv("kv_fetch_requested_total")
            kw = {"handoff": hid} if first and hid is not None else {}
            got = self._kv_fetch_fn(peer, [h.hex() for h in chunk], self.kv_fetch_timeout_s, **kw)
            if not got:
                self._count_kv("kv_fetch_failed_total")
                break
            pages = [pg for pg in got if isinstance(pg, dict)]
            if kw:
                tpg = next((pg for pg in pages if pg.get("handoff") == hid), None)
                if tpg is not None:
                    try:
                        eng.adopt_handoff_tail(hid, eng.build_page_payload(
                            self._page_leaves(tpg, spec)))
                    except Exception:  # noqa: BLE001 — the stash stays empty: admission counts it
                        pass
            by_chain = {pg.get("chain"): pg for pg in pages}
            entries = []
            for i, h in enumerate(chunk):
                pg = by_chain.get(h.hex())
                if pg is None:
                    break  # a gap ends the adoptable prefix
                try:
                    payload = eng.build_page_payload(self._page_leaves(pg, spec))
                except Exception:  # noqa: BLE001 — a malformed page ends the prefix
                    self._count_kv("kv_fetch_failed_total")
                    break
                d = depth + i
                entries.append((h, d, tuple(matchable[d * ps : (d + 1) * ps]), payload))
                nbytes += len(pg["data"])
            if entries:
                adopted += eng.adopt_kv_pages(entries)
            if len(entries) < len(chunk):
                break
            missing, depth, first = missing[len(chunk):], depth + len(chunk), False
        if adopted:
            self.kv_fetch_log.append((adopted, nbytes, time.perf_counter() - t0))
        return adopted

    def _device_job(self, fn, on_ms: Callable[[float], None]):
        """Run ``fn`` on the drive thread between two ticks
        (``_on_engine_thread``) and return its result; on the card its
        device time (CUDA events, synchronized) goes to ``on_ms``."""
        def run():
            if self.engine.device.type != "cuda":
                return fn()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            b.synchronize()
            on_ms(a.elapsed_time(b))
            return out

        return self._on_engine_thread(run)

    def _tower_call(self, kind: str, fn):
        """A tower or head forward as a ``_device_job``, its device ms kept
        in ``media_ms`` under ``kind``."""
        return self._device_job(fn, lambda ms: self.media_ms.append((kind, ms)))

    def _decode_image(self, item) -> np.ndarray:
        """One wire image → [S, S, 3] float32 in [0, 1]: encoded bytes, a
        ``{"b64": ...}`` PNG or JPEG, or a nested list / array of pixels in
        [0, 1] (clipped); resized to the tower's size as Pillow resizes."""
        S = self.vision_cfg.image_size
        raw = None
        if isinstance(item, (bytes, bytearray)):
            raw = bytes(item)
        elif isinstance(item, dict) and "b64" in item:
            raw = base64.b64decode(item["b64"])
        if raw is not None:
            img = media_codec.resize_bicubic(media_codec.decode_image(raw), (S, S))
            return img.astype(np.float32) / 255.0
        arr = np.asarray(item, np.float32)
        if arr.ndim != 3 or arr.shape[-1] != 3:
            raise ValueError(f"image array must be [H, W, 3], got {arr.shape}")
        arr = np.clip(arr, 0.0, 1.0)
        if arr.shape[0] != S or arr.shape[1] != S:
            img = media_codec.resize_bicubic((arr * 255).astype(np.uint8), (S, S))
            arr = img.astype(np.float32) / 255.0
        return arr

    def _decode_audio(self, item) -> np.ndarray:
        """One wire audio part → [max_samples] float32 in [-1, 1]: WAV
        bytes, ``{"b64": <WAV>}``, or an array of samples."""
        cfg = self.audio_cfg
        raw = None
        if isinstance(item, (bytes, bytearray)):
            raw = bytes(item)
        elif isinstance(item, dict) and "b64" in item:
            raw = base64.b64decode(item["b64"])
        if raw is not None:
            return audio_mod.wav_to_float(raw, cfg.sample_rate, cfg.max_samples)
        x = np.asarray(item, np.float32).reshape(-1)
        out = np.zeros((cfg.max_samples,), np.float32)
        n = min(len(x), cfg.max_samples)
        out[:n] = np.clip(x[:n], -1.0, 1.0)
        return out

    def _fuse_media(self, prompt: str, images: list | None,
                    audios: list | None) -> tuple[list[int], list]:
        """Tokenize a prompt with ``<image>``/``<audio>`` markers: each
        part is decoded on the calling thread, encoded by its tower (one
        batch a modality, on the drive thread) and spliced in as
        placeholder ids (0) plus its embedding span. Returns (tokens,
        ``Request.mm_embeds``)."""
        images, audios = images or [], audios or []
        if images and self.vision_cfg is None:
            raise BadRequestError(NO_VISION)
        if audios and self.audio_cfg is None:
            raise BadRequestError(NO_AUDIO)
        if self.tokenizer is None:
            raise ValueError("multimodal inputs need a tokenizer (text prompt)")
        pieces = re.split(r"(<image>|<audio>)", prompt)
        n_img, n_aud = pieces.count("<image>"), pieces.count("<audio>")
        if n_img != len(images) or n_aud != len(audios):
            raise ValueError(
                f"prompt has {n_img} <image> + {n_aud} <audio> markers for "
                f"{len(images)} images + {len(audios)} audio parts")
        dev = self.engine.device
        embs: dict[str, list] = {"<image>": [], "<audio>": []}
        if images:
            batch = torch.from_numpy(np.stack([self._decode_image(im) for im in images]))
            embs["<image>"] = list(self._tower_call("vision", lambda: vision_mod.vision_encode(
                self.vision_params, self.vision_cfg, batch.to(dev))))
        if audios:
            batch = torch.from_numpy(np.stack([self._decode_audio(a) for a in audios]))
            embs["<audio>"] = list(self._tower_call("audio", lambda: audio_mod.audio_encode(
                self.audio_params, self.audio_cfg, batch.to(dev))))
        tokens: list[int] = []
        mm: list[tuple[int, torch.Tensor]] = []
        for piece in pieces:
            if piece in embs:
                emb = embs[piece].pop(0)
                mm.append((len(tokens), emb))
                tokens.extend([0] * emb.shape[0])
            elif piece:
                tokens.extend(self.tokenizer.encode(piece))
        return tokens, mm

    def _synthesize_wav_b64(self, text: str) -> tuple[str, int]:
        """Text → (base64 WAV, bytes cut) through the TTS head, trimmed to
        the speakable span of the text kept."""
        if self.tts_cfg is None:
            raise BadRequestError(NO_TTS)
        cfg = self.tts_cfg
        ids, n_bytes, cut = _prompt_byte_ids(text, cfg.max_chars)
        wav = self._tower_call("tts", lambda: audio_mod.tts_synthesize(
            self.tts_params, cfg, torch.from_numpy(ids).to(self.engine.device))[0].cpu())
        n = max(1, n_bytes) * cfg.frames_per_char * cfg.samples_per_frame
        wav_bytes = audio_mod.float_to_wav(wav.numpy()[:n], cfg.sample_rate)
        return base64.b64encode(wav_bytes).decode(), cut

    def _render_png_b64(self, text: str) -> tuple[str, int]:
        """Prompt → (base64 PNG, bytes cut) through the image-generation head."""
        cfg = self.imagegen_cfg
        ids, _, cut = _prompt_byte_ids(text, cfg.max_chars)
        img = self._tower_call("imagegen", lambda: image_gen.imagegen_synthesize(
            self.imagegen_params, cfg, torch.from_numpy(ids).to(self.engine.device))[0].cpu())
        return base64.b64encode(image_gen.image_to_png(img.numpy())).decode(), cut

    def apply_chat_template(self, messages: list[dict]) -> str:
        """[{role, content}] → one prompt string: the checkpoint's own chat
        template where the tokenizer has one (``HFTokenizer``, rendered as
        transformers' ``apply_chat_template(tokenize=False,
        add_generation_prompt=True)`` renders it, as the JAX node does),
        else the JAX node's role-tagged transcript."""
        if not isinstance(messages, list):
            raise ValueError("messages must be a list of {role, content} objects")
        for i, m in enumerate(messages):
            bad = (
                not isinstance(m, dict)
                or not isinstance(m.get("content"), str)
                or m.get("role") not in ("system", "user", "assistant")
            )
            if bad:
                raise ValueError(
                    f"messages[{i}] must be {{role: system|user|assistant, "
                    "content: str}"
                )
        if getattr(self.tokenizer, "chat_template", None):
            return self.tokenizer.apply_chat_template(messages, add_generation_prompt=True)
        lines = [f"{m['role']}: {m['content']}" for m in messages]
        return "\n".join(lines) + "\nassistant:"

    def embed(
        self,
        prompt: str | None = None,
        tokens: list[int] | None = None,
        pooling: str = "mean",
        context_overflow: str = "error",
        prompts: list[str] | None = None,
    ) -> dict[str, Any]:
        """Text → L2-normalized embedding from the LM's final-norm hidden
        states, mean- or last-token-pooled over the real tokens (the JAX
        node's ``embed``). ``prompts`` is the batch form,
        ``{"embeddings": [...]}``. Over-long inputs follow
        ``context_overflow``: "error" rejects, "truncate_left" keeps the
        last ``max_context`` tokens and reports ``truncated_tokens``. The
        rows go through forwards of at most ``EMBED_CHUNK_TOKENS`` padded
        tokens (``embed_chunks``; ``embed_rows``, attention through
        ``dense_causal_attention``), each a job of the engine's drive
        thread: it never overlaps a decode step's graph capture or replay,
        and a live decode waits for one chunk at most. Rows pad to the
        longest of their chunk (not to a prefill bucket): padding follows
        every real token, so causal attention and the pooling mask keep it
        out."""
        if pooling not in ("mean", "last"):
            raise ValueError(f"pooling={pooling!r} must be 'mean' or 'last'")
        if context_overflow not in CONTEXT_OVERFLOW:
            raise ValueError(
                f"context_overflow={context_overflow!r} must be 'error' or "
                "'truncate_left'"
            )
        batch_mode = prompts is not None
        if batch_mode:
            if prompt is not None or tokens is not None:
                raise ValueError("prompts is exclusive with prompt/tokens")
            if not prompts:
                raise ValueError("prompts must be non-empty")
            if self.tokenizer is None:
                raise ValueError("no tokenizer loaded on this model node")
            token_rows = [self.tokenizer.encode(p) for p in prompts]
        else:
            if tokens is None:
                if prompt is None:
                    raise ValueError("one of 'prompt', 'tokens', 'prompts' is required")
                if self.tokenizer is None:
                    raise ValueError("no tokenizer loaded on this model node; pass 'tokens'")
                tokens = self.tokenizer.encode(prompt)
            token_rows = [list(tokens)]
        max_ctx = self.engine.ecfg.max_context
        truncated_rows: list[int] = []
        for i, row in enumerate(token_rows):
            if not row:
                raise ValueError(f"cannot embed an empty sequence (row {i})")
            if len(row) > max_ctx:
                if context_overflow == "error":
                    raise ValueError(
                        f"sequence of {len(row)} tokens (row {i}) exceeds "
                        f"max_context={max_ctx}; pass context_overflow="
                        "'truncate_left' to embed the most recent context"
                    )
                truncated_rows.append(len(row) - max_ctx)
                token_rows[i] = row[-max_ctx:]
            else:
                truncated_rows.append(0)
        lens = [len(r) for r in token_rows]

        vecs = torch.empty((len(token_rows), self.cfg.hidden_size))
        for chunk in embed_chunks(lens, EMBED_CHUNK_TOKENS):
            vecs[chunk] = self._device_job(functools.partial(
                self.engine.embed_rows, [token_rows[i] for i in chunk], pooling),
                self.embed_ms.append).cpu()
        base = {"dim": int(vecs.shape[1]), "model": self.model_name, "pooling": pooling}
        if batch_mode:
            out = {**base, "embeddings": vecs.tolist(), "tokens_used": lens}
            if any(truncated_rows):
                out["truncated_tokens"] = truncated_rows
            return out
        out = {**base, "embedding": vecs[0].tolist(), "tokens_used": lens[0]}
        if truncated_rows[0]:
            out["truncated_tokens"] = truncated_rows[0]
        return out

    def _on_engine_thread(self, fn):
        """Run ``fn`` on the drive thread between two ticks and return its
        result (inline when the drive loop was never started or has been
        joined: nothing can overlap it then)."""
        if threading.current_thread() is self._thread:
            return fn()
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._lock:
            if self.error is not None:
                raise RuntimeError(f"engine stopped after a failed step: {self.error!r}")
            inline = self._thread is None
            if not inline:
                if self._stop.is_set():  # the loop may still be in its last step
                    raise RuntimeError("model node stopped")
                self._jobs.append((fn, fut))
        if inline:
            return fn()
        self._wake.set()
        return fut.result()

    def _run_job(self) -> None:
        with self._lock:
            fn, fut = self._jobs.pop(0)
        try:
            fut.set_result(fn())
        except Exception as e:  # noqa: BLE001 — the job's caller gets it
            fut.set_exception(e)

    def _fail_jobs(self, error: BaseException) -> None:
        with self._lock:
            jobs, self._jobs = self._jobs, []
        for _, fut in jobs:
            fut.set_exception(error)

    def prep_stream_kwargs(self, body: dict) -> dict:
        """The ``submit_stream`` arguments of a ``/generate/stream`` body
        (the JAX node's ``_prep_stream_kwargs``): known keys that are not
        null, ``messages`` through the chat template, text output only
        (``images``/``audios`` are fused in ``_submit``, as the JAX node
        pre-fuses them); ``kv_peer`` is a transport hint: the prompt's pages
        are pulled from that peer here, before the submit."""
        kw = {k: body[k] for k in STREAM_PARAMS if body.get(k) is not None}
        if body.get("messages") is not None:
            if kw.get("prompt") is not None or kw.get("tokens") is not None:
                raise ValueError("messages is exclusive with prompt/tokens")
            kw["prompt"] = self.apply_chat_template(body["messages"])
        if body.get("output") not in (None, "text"):
            raise ValueError(
                "the token stream is text-only; use the unary generate "
                "path for output='audio'/'speech'/'image'"
            )
        if (body.get("kv_peer") is not None and kw.get("tokens") is not None
                and not (kw.get("images") or kw.get("audios"))):
            self.maybe_prefetch_kv(kw["tokens"], body["kv_peer"])
        return kw

    def event_frame(self, ev: TokenEvent) -> dict:
        """One SSE data frame of the token stream."""
        frame = {"token": ev.token, "index": ev.index, "finished": ev.finished,
                 "finish_reason": ev.finish_reason, "logprob": ev.logprob}
        if self.tokenizer is not None and ev.token >= 0:
            frame["text"] = self.tokenizer.decode([ev.token])
        return frame

    def collect_result(self, rid: str, q: queue.Queue, truncated: int, trace: dict | None,
                       t0: tuple[float, float], emit=None, timeout: float | None = None) -> dict:
        """Read ``rid``'s TokenEvents from ``q`` into the result of unary
        ``generate`` (every transport's result has its shape), each event
        also to ``emit`` (a channel's token frames) when given. A None on
        the queue is a cancel (ExecutionCancelled); ``timeout`` raises
        TimeoutError. The request is cancelled if it still runs when this
        returns or raises. A traced request's ``node.generate`` span
        (started at ``t0``, wall and perf clocks) is recorded in any
        case."""
        deadline = None if timeout is None else time.monotonic() + timeout
        records: list[tuple[int, float | None]] = []
        finish_reason = branches_meta = None
        try:
            while True:
                try:
                    ev = q.get(timeout=None if deadline is None
                               else max(0.0, deadline - time.monotonic()))
                except queue.Empty:
                    raise TimeoutError(f"request {rid} timed out after {timeout} s") from None
                if ev is None:
                    raise ExecutionCancelled
                if emit is not None:
                    emit(self.event_frame(ev))
                if ev.token >= 0 and not (ev.finished and ev.finish_reason == "stop"):
                    # stop tokens terminate, they are not content; a
                    # deadline or error terminal carries no token
                    records.append((ev.token, ev.logprob))
                if ev.finished:
                    finish_reason = ev.finish_reason
                    branches_meta = self.pop_group_meta(rid)
                    break
        finally:
            self.release_stream(rid)  # cancels the request if it still runs
            if trace is not None:
                attrs = {"rid": rid, "finish": finish_reason}
                if emit is not None:
                    attrs["stream"] = 1
                tracing.tracer().record_span("node.generate", trace["trace_id"], t0[0],
                                             (time.perf_counter() - t0[1]) * 1e3, attrs)
        if finish_reason and finish_reason.startswith("error: "):
            raise RuntimeError(finish_reason[len("error: "):])
        result = {"tokens": [t for t, _ in records], "logprobs": [lp for _, lp in records],
                  "finish_reason": finish_reason, "model": self.model_name}
        if branches_meta is not None:
            result["branches"] = branches_meta
        if self.tokenizer is not None:
            result["text"] = self.tokenizer.decode(result["tokens"])
        if truncated:
            result["truncated_prompt_tokens"] = truncated
        return result

    def channel_generate(self, payload: Any, headers: dict, emit, ex: ChannelExec) -> dict:
        """``generate`` streamed over the gateway's channel (the JAX node's
        ``channel_generate``): each TokenEvent becomes a token frame
        (``emit``), and the result is unary ``generate``'s. A gateway
        cancel (``ex``) ends the request through the engine's cancel path
        and the execution with ExecutionCancelled. Non-text outputs go
        unary."""
        if not isinstance(payload, dict):
            raise ValueError("generate input must be a JSON object")
        if payload.get("output") not in (None, "text"):
            return self.generate(**{k: v for k, v in payload.items() if v is not None},
                                 on_cancel=ex.on_cancel)
        trace = tracing.valid_context(payload.get("trace"))
        t0 = time.time(), time.perf_counter()
        rid, q, truncated = self.submit_stream(**self.prep_stream_kwargs(payload))
        ex.on_cancel(lambda: q.put(None))  # wakes the reader
        return self.collect_result(rid, q, truncated, trace, t0, emit=emit)

    def profile_start(self, trace_dir: str) -> None:
        """Start a ``torch.profiler`` capture (CPU ops, and the card's
        kernels on a CUDA engine) on the drive thread between two ticks, so
        it holds whole ticks. Raises ProfileActiveError when one is
        active."""
        with self._profile_lock:
            if self._profile["prof"] is not None:
                raise ProfileActiveError("trace already active")
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.engine.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            self._on_engine_thread(prof.start)
            self._profile.update(prof=prof, dir=trace_dir)

    def profile_stop(self) -> str:
        """Stop the active capture on the drive thread and write its Chrome
        trace into its directory; returns the file's path. Raises
        LookupError when none is active."""
        with self._profile_lock:
            prof, trace_dir = self._profile["prof"], self._profile["dir"]
            if prof is None:
                raise LookupError("no active trace")
            self._profile["prof"] = None  # never wedged, even if the stop fails
            self._on_engine_thread(prof.stop)
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"{self.model_name.replace(os.sep, '_')}."
                                       f"{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        return path

    def heartbeat_stats(self) -> dict[str, Any]:
        """The engine's part of every heartbeat (the JAX node's
        ``_heartbeat_stats``; the node adds the channel's counters), with the
        prefix index's sketch under ``prefix_sketch`` (the gateway's
        affinity routing reads it) unless the engine publishes none."""
        eng = self.engine
        stats = {
            **dict(eng.stats),
            **eng.grammar_bank_stats(),
            **eng.prefix_cache_stats(),
            **eng.scheduler_stats(),
            "active_slots": eng.num_active,
            "pending_requests": len(eng.pending),
            "free_pages": eng.allocator.free_pages,
            "draining": int(self._draining),
            "latency_hist": eng.latency_histograms(),
        }
        sketch = eng.prefix_sketch()
        if sketch is not None:
            stats["prefix_sketch"] = sketch
        return stats

    def stats_doc(self) -> dict[str, Any]:
        """``GET /stats``: the heartbeat's stats under the JAX route's key
        names (``model``, ``pending``) besides."""
        return {"model": self.model_name, **self.heartbeat_stats(),
                "pending": len(self.engine.pending)}

    def _forget(self, rid: str) -> BranchGroup | None:
        """Drop ``rid``'s queue (under _lock); returns its group, if any."""
        self._streams.pop(rid, None)
        g = self._groups.get(rid)
        if g is not None:
            self._teardown_group(g)
        return g

    def _abandon(self, rid: str) -> None:
        """No reader is left for ``rid``: drop its queue and cancel it in the
        engine, every live branch of a group."""
        with self._lock:
            live = rid in self._streams
            g = self._forget(rid)
        if g is None:
            if live:
                self.cancel(rid)
            return
        for b in map(g.branch, g.branch_rids()):
            if b is not None and b.live:
                self.engine.request_cancel(b.rid)
        self._wake.set()

    # -- branch decoding: the group lifecycle, on the engine thread -------

    def _teardown_group(self, g: BranchGroup) -> None:  # under _lock
        for r in [r for r, gg in self._groups.items() if gg is g]:
            del self._groups[r]
        self._group_sinks.pop(g.parent, None)

    def _fail_group(self, g: BranchGroup, error: BaseException) -> None:
        with self._lock:
            q = self._group_sinks.get(g.parent)
            self._teardown_group(g)
        if q is not None:
            q.put(_error_event(g.parent, error))

    def _on_group_event(self, g: BranchGroup, ev: TokenEvent) -> None:
        """Feed one branch event to its group and apply the actions: a
        pruned branch is cancelled (its pages free now), a beam survivor
        re-forks into a new branch id, a settled group resolves."""
        for act in g.on_event(ev.request_id, ev):
            if act[0] == "cancel":
                self.engine.stats["branch_pruned_total"] += 1
                self.engine.request_cancel(act[1])
            elif act[0] == "fork":
                _, src, new_rid = act
                with self._lock:
                    if g.parent not in self._group_sinks:
                        continue  # the caller left: no new branches
                    self._groups[new_rid] = g
                self.engine.request_fork(src, new_rid)
            elif act[0] == "resolve":
                self._resolve_group(g)

    @staticmethod
    def _branch_content(b) -> list[tuple[int, float | None]]:
        """A branch's content: a terminal stop token is not content."""
        if b.finish_reason == "stop" and b.records:
            return b.records[:-1]
        return list(b.records)

    def _resolve_group(self, g: BranchGroup) -> None:
        """Every branch settled (on the drive thread): with a verifier
        target and a hook, send the candidates' texts to the verifier on a
        thread of its own; else deliver the best cumulative logprob."""
        cands = g.candidates()
        target = g.policy.get("verifier")
        if (len(cands) > 1 and target and self._verifier_call is not None
                and self.tokenizer is not None):
            # the JAX node's rerank payload; every branch has finished, so
            # its pages are released already: only its records remain
            self.engine.stats["branch_verifier_calls_total"] += 1
            texts = [self.tokenizer.decode([t for t, _ in self._branch_content(b)])
                     for b in cands]
            payload = {"task": "rerank", "candidates": texts,
                       "scores": [round(b.cum_logprob, 4) for b in cands]}
            threading.Thread(target=self._verify_group, args=(g, cands, target, payload),
                             name="branch-verifier", daemon=True).start()
            return
        self._deliver_group(g, cands[0] if cands else None, False)

    def _verify_group(self, g: BranchGroup, cands: list, target: str, payload: dict) -> None:
        """The verifier's call, off the drive thread: its verdict picks the
        winner; any failure degrades to the logprob winner, as on the JAX
        node."""
        winner, used = cands[0], False
        try:
            idx = self._parse_verdict(self._verifier_call(target, payload), len(cands))
            if idx is not None:
                winner, used = cands[idx], True
        except Exception as e:  # noqa: BLE001 — a broken verifier must not fail the generation
            log.warning("branch verifier failed; using logprob winner (target=%s, error=%r)",
                        target, e)
        self._deliver_group(g, winner, used)

    @staticmethod
    def _parse_verdict(res, n: int) -> int | None:
        """Accept {"best": i} or {"scores": [...]} shaped verdicts (nested
        under "result" tolerated); anything else → None (logprob wins)."""
        if isinstance(res, dict) and isinstance(res.get("result"), dict):
            res = res["result"]
        if not isinstance(res, dict):
            return None
        best = res.get("best")
        if isinstance(best, bool):
            return None
        if isinstance(best, int) and 0 <= best < n:
            return best
        scores = res.get("scores")
        if (
            isinstance(scores, list)
            and len(scores) == n
            and all(isinstance(s, (int, float)) and not isinstance(s, bool) for s in scores)
        ):
            return max(range(n), key=lambda i: scores[i])
        return None

    def _deliver_group(self, g: BranchGroup, winner, verifier_used: bool) -> None:
        """Deliver the winner to the group's caller. The sink is fetched
        now, after any verifier call: a caller that left meanwhile tore the
        group down and gets nothing."""
        if winner is None:
            winner = g.fallback_branch()
        meta = g.summary(winner, verifier_used)
        with self._lock:
            q = self._group_sinks.get(g.parent)
            self._teardown_group(g)
            if q is not None:
                self._group_meta[g.parent] = meta
        if q is None or winner is None:
            return
        # the winner's tokens replay under the parent id, then one terminal
        # (a deadline or failure terminal carries no token, as the engine's)
        recs, reason = winner.records, winner.finish_reason
        tokened = reason in ("stop", "length") and bool(recs)
        for i, (tok, lp) in enumerate(recs):
            last = tokened and i == len(recs) - 1
            q.put(TokenEvent(request_id=g.parent, token=tok, index=i, finished=last,
                               finish_reason=reason if last else None, logprob=lp))
        if not tokened:
            q.put(TokenEvent(request_id=g.parent, token=-1, index=-1, finished=True,
                               finish_reason=reason or "error: branch group unresolved"))

    def cancel(self, rid: str) -> None:
        """Cancel an in-flight request and wake the drive loop so its slot
        frees now."""
        self.engine.request_cancel(rid)
        self._wake.set()

    def drain(self, grace_s: float = 30.0) -> dict[str, Any]:
        """Graceful drain: stop admitting, let in-flight requests finish for
        ``grace_s``, then deadline-out whatever still runs (each caller gets
        a "deadline_exceeded" answer, never a hang). Idempotent; returns a
        summary. Without a running drive loop nothing can finish: no
        wait."""
        t0 = time.monotonic()
        if not self._draining:
            self._draining = True
            self.engine.stats["drains_total"] += 1
        if self._thread is None or self.error is not None:
            return {"drained": not self.engine.has_work(), "deadline_outed": 0,
                    "elapsed_s": round(time.monotonic() - t0, 3)}
        while self.engine.has_work() and time.monotonic() - t0 < grace_s:
            self._wake.set()
            time.sleep(0.02)
        cancelled = 0
        if self.engine.has_work():
            cancelled = self.engine.deadline_all_now()
            self.engine.stats["drain_cancelled"] += cancelled
            t1 = time.monotonic()
            while self.engine.has_work() and time.monotonic() - t1 < 10.0:
                self._wake.set()
                time.sleep(0.02)
        return {
            "drained": not self.engine.has_work(),
            "deadline_outed": cancelled,
            "elapsed_s": round(time.monotonic() - t0, 3),
        }


def _error_event(rid: str, error: BaseException) -> TokenEvent:
    """The terminal a stream gets when the engine failed."""
    return TokenEvent(request_id=rid, token=-1, index=-1, finished=True,
                      finish_reason=f"error: engine step failed: {error!r}")


class InputError(TypeError):
    """A reasoner input that does not fit its parameters: not an object, an
    unknown key, or null where the parameter takes none (HTTP 422, as the
    JAX SDK's validation error)."""


def _params_of(fn) -> dict[str, tuple[Any, Any]]:
    """A reasoner's input parameters: name -> (annotation, default), in
    signature order (``self``, ``timeout`` and ``on_cancel`` excluded)."""
    hints = typing.get_type_hints(fn)
    return {n: (hints.get(n, Any), p.default) for n, p in inspect.signature(fn).parameters.items()
            if n not in ("self", "timeout", "on_cancel")}


def _allows_none(ann) -> bool:
    return ann is Any or ann is type(None) or (
        typing.get_origin(ann) in (typing.Union, types.UnionType)
        and type(None) in typing.get_args(ann))


def check_input(params: dict[str, tuple[Any, Any]], payload: Any) -> dict[str, Any]:
    """The keyword arguments of a reasoner call from its JSON ``input``:
    null means no arguments; an unknown key, or null for a parameter that
    does not take it, raises InputError. Values go on as sent: the backend
    validates them (a wrong type raises there)."""
    if payload is None:
        return {}
    if not isinstance(payload, dict):
        raise InputError(f"input must be a JSON object, got {type(payload).__name__}")
    unknown = sorted(set(payload) - set(params))
    if unknown:
        raise InputError(f"unknown input keys {unknown}; known: {list(params)}")
    nulls = sorted(k for k, v in payload.items() if v is None and not _allows_none(params[k][0]))
    if nulls:
        raise InputError(f"input keys {nulls} must not be null")
    return dict(payload)


def input_schema(name: str, params: dict[str, tuple[Any, Any]]) -> dict:
    """The reasoner's input schema as registration carries it: one property
    per parameter (the JAX node's property names), with its default."""
    props, required = {}, []
    for n, (_, default) in params.items():
        prop = {"title": n.replace("_", " ").title()}
        if default is inspect.Parameter.empty:
            required.append(n)
        else:
            prop["default"] = default
        props[n] = prop
    doc = {"type": "object", "title": f"{name}_Input", "properties": props}
    if required:
        doc["required"] = required
    return doc


GENERATE_PARAMS = _params_of(ModelBackend.generate)
EMBED_PARAMS = _params_of(ModelBackend.embed)
STREAM_PARAMS = _params_of(ModelBackend.submit_stream)  # the token stream's body keys


class ModelNodeServer:
    """Stdlib HTTP front of one ModelBackend (one handler thread per
    connection; the engine batches whatever is in flight), and with a
    ``control_plane`` URL a node of that control plane: it registers at
    ``start`` (kind "model"), heartbeats every ``heartbeat_interval``
    seconds with the engine's stats on a daemon thread (three failures in a
    row: ``connection_state`` "degraded"; a 404: it registers again), acks a
    gateway-tracked request (``X-Execution-ID``) with 202 and posts its
    outcome to ``/api/v1/executions/{id}/status``, and at ``stop`` drains,
    sends a "stopping" heartbeat and deregisters. It serves the gateway's
    channel at ``GET /channel`` (``self.channel``), advertised in its
    registration as ``metadata["channel"]``, as the JAX SDK agent does; its
    peers' KV fetches are served over it and its own go up it. ``role``
    ("prefill" | "decode" | "mixed") is its pool in two-phase dispatch,
    advertised as ``metadata["role"]``."""

    def __init__(self, backend: ModelBackend, node_id: str = "model",
                 control_plane: str | None = None, heartbeat_interval: float = 2.0,
                 role: str = "mixed"):
        if "." in node_id:
            raise ValueError("node_id must not contain '.'")
        if role not in ROLES:
            raise ValueError(
                f"unknown node role {role!r}: 'prefill' | 'decode' | 'mixed' "
                "(AGENTFIELD_NODE_ROLE / build_model_node(role=...))"
            )
        self.backend = backend
        self.node_id = node_id
        self.client = NodeControlPlaneClient(control_plane) if control_plane else None
        self.heartbeat_interval = heartbeat_interval
        # the served modalities, as the JAX node advertises them (the SDK
        # routes a capability-needing call to a node that has it)
        modalities = ["text"] + [m for m, have in (
            ("image-in", backend.vision_cfg), ("audio-in", backend.audio_cfg),
            ("audio-out", backend.tts_cfg), ("image-out", backend.imagegen_cfg)) if have]
        self.metadata = {"model": backend.model_name, "modalities": modalities, "role": role,
                         "channel": True}
        self.connection_state = "connected"  # "degraded" after failed heartbeats
        self.components = {"generate": (backend.generate, GENERATE_PARAMS),
                           "embed": (backend.embed, EMBED_PARAMS)}
        self.channel = ChannelServer(self._channel_invoke,
                                     {"generate": backend.channel_generate})
        self.channel.set_trace_collect(backend.collect_trace_spans)
        # the cluster tier: peers' fetches are served from this engine's
        # index, and this node's own fetches ride the same channel
        self.channel.set_kv_export(backend.kv_export_pages)
        backend._kv_fetch_fn = self.channel.fetch_kv
        if self.client is not None:
            backend._verifier_call = self._verify
        self.host = "127.0.0.1"
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._hb_thread: threading.Thread | None = None
        self._hb_stop = threading.Event()
        self._registered = False
        # threads whose answer a drain must let out: tracked requests, SSE
        # streams; under _tracked_lock
        self._tracked: set[threading.Thread] = set()
        self._tracked_lock = threading.Lock()
        self._grpc = None  # the gRPC Generate server, from start_grpc
        self.grpc_port: int | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Start the engine loop and serve on ``host:port`` (0 = any free
        port) from a background thread, then register and start
        heartbeating if a control plane is set; returns the bound port. A
        failed registration stops the node and raises."""
        self.backend.start()
        self.channel.open()
        self.host = host
        self._httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever, name="http", daemon=True)
        self._thread.start()
        if self.client is not None:
            try:
                self.client.register_node(self.node_spec())
            except BaseException:
                self.stop()
                raise
            self._registered = True
            self._hb_stop.clear()
            self._hb_thread = threading.Thread(target=self._heartbeat_loop, name="heartbeat",
                                               daemon=True)
            self._hb_thread.start()
        return self.port

    def start_grpc(self, port: int) -> int:
        """Serve ``Generate`` over gRPC on ``127.0.0.1:port``
        (``start_model_grpc``) until ``stop``; returns the port. OSError if
        it cannot be bound."""
        self._grpc = start_model_grpc(self.backend, port)
        self.grpc_port = port
        return port

    def stop(self, grace_s: float = DRAIN_GRACE_S) -> dict[str, Any]:
        """The JAX ``drain_and_stop``: stop heartbeating; drain the backend
        (admission answers 503, in-flight work finishes within ``grace_s``
        or ends "deadline_exceeded", so every stream and channel execution
        gets its terminal frame); let tracked requests call back and streams
        write their last frame; stop the gRPC server (its calls got their
        answers in the drain); send a "stopping" heartbeat and deregister;
        close the channel; stop serving; stop the engine. Returns the
        drain's summary. After the drain, the joins and the channel's close
        take at most ``min(grace_s + 5, 30)`` s together: a reader that
        stopped reading is cut, its sends bounded."""
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=30.0)
            self._hb_thread = None
        summary = self.backend.drain(grace_s)
        deadline = time.monotonic() + min(grace_s + 5.0, 30.0)
        with self._tracked_lock:
            tracked = list(self._tracked)
        for th in tracked:
            th.join(timeout=max(0.0, deadline - time.monotonic()))
        if self._grpc is not None:  # its calls were drained with the rest
            self._grpc.stop(max(0.0, deadline - time.monotonic()))
            self._grpc = None
        if self._registered:
            self._registered = False
            for call in (lambda: self.client.heartbeat(self.node_id, status="stopping"),
                         lambda: self.client.deregister_node(self.node_id)):
                try:
                    call()
                except Exception as e:  # noqa: BLE001 — the lease sweep covers a lost goodbye
                    log.debug("control-plane goodbye failed: %r", e)
        self.channel.close(timeout=max(0.0, deadline - time.monotonic()))
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self.backend.stop()
        return summary

    def heartbeat_stats(self) -> dict[str, Any]:
        """A heartbeat's stats: the engine's and the channel's counters."""
        return {**self.backend.heartbeat_stats(), **self.channel.stats_snapshot()}

    def track(self, th: threading.Thread) -> None:
        """Register a request thread whose answer a stop waits for."""
        with self._tracked_lock:
            self._tracked.add(th)

    def untrack(self, th: threading.Thread) -> None:
        with self._tracked_lock:
            self._tracked.discard(th)

    def _channel_invoke(self, cid: str, payload: Any, headers: dict, ex: ChannelExec) -> Any:
        """A unary channel execution: the component's HTTP call; a gateway
        cancel of a ``generate`` ends its request through the engine's
        cancel path."""
        if cid not in self.components:
            raise LookupError(f"unknown component {cid!r}")
        fn, params = self.components[cid]
        kw = check_input(params, payload)
        if cid == "generate":
            kw["on_cancel"] = ex.on_cancel
        return fn(**kw)

    def _verify(self, target: str, payload: dict) -> Any:
        """The branch verifier's dispatch (the JAX ``_branch_verifier``):
        the candidates go to ``target`` through the gateway; an execution
        that did not complete raises, and the group falls back to the
        logprob winner."""
        doc = self.client.execute(target, payload)
        if doc.get("status") != "completed":
            raise RuntimeError(f"verifier {target!r} {doc.get('status')}: {doc.get('error')}")
        return doc.get("result")

    def node_spec(self) -> dict[str, Any]:
        """The registration body (the JAX SDK's ``Agent._node_spec``); the
        control plane probes the callback candidates' ``/health`` and keeps
        the first that answers with this node's id."""
        base = f"http://{self.host}:{self.port}"
        return {
            "node_id": self.node_id,
            "base_url": base,
            "callback_candidates": list(dict.fromkeys([base, f"http://127.0.0.1:{self.port}"])),
            "kind": "model",
            "metadata": dict(self.metadata),
            "reasoners": self.reasoners(),
            "skills": [],
        }

    def reasoners(self) -> list[dict]:
        what = {"generate": "generation", "embed": "embeddings"}
        return [{"id": cid, "description": f"GPU-served {self.backend.model_name} {what[cid]}",
                 "input_schema": input_schema(cid, params)}
                for cid, (_, params) in self.components.items()]

    def invoke(self, cid: str, payload: Any) -> Any:
        fn, params = self.components[cid]
        return fn(**check_input(params, payload))

    def _heartbeat_loop(self) -> None:
        failures = 0
        while not self._hb_stop.wait(self.heartbeat_interval):
            # a broken stats provider gives a stats-less heartbeat, never none
            stats = None
            try:
                stats = self.heartbeat_stats()
            except Exception as e:  # noqa: BLE001
                log.debug("heartbeat stats failed: %r", e)
            try:
                self.client.heartbeat(self.node_id, stats=stats)
            except ControlPlaneError as e:
                failures += 1
                if e.status == 404:  # the control plane lost us (restart): register again
                    try:
                        self.client.register_node(self.node_spec())
                    except Exception as re_err:  # noqa: BLE001 — the next beat retries
                        log.debug("re-registration failed: %r", re_err)
                    else:
                        failures = 0
                        self.connection_state = "connected"
            except Exception:  # noqa: BLE001 — transient: keep beating
                failures += 1
            else:
                failures = 0
                self.connection_state = "connected"
            if failures >= 3:
                self.connection_state = "degraded"

    def run_tracked(self, cid: str, payload: Any, execution_id: str) -> None:
        """Serve a 202-acked request on its own thread and post its outcome:
        "completed" with the result, or "failed" with ``repr`` of the error
        (the SDK's backpressure retry reads ``QueueFullError`` there)."""
        def run():
            try:
                result = self.invoke(cid, payload)
                json.dumps(result)  # an unserializable result fails here, not stranded
            except Exception as e:  # noqa: BLE001 — reported to the control plane
                self._post_status(execution_id, "failed", error=repr(e))
            else:
                self._post_status(execution_id, "completed", result=result)
            finally:
                self.untrack(threading.current_thread())

        th = threading.Thread(target=run, name=f"tracked-{execution_id}", daemon=True)
        self.track(th)
        th.start()

    def _post_status(self, execution_id: str, status: str, **kw) -> None:
        try:
            self.client.post_status(execution_id, status, **kw)
        except Exception as e:  # noqa: BLE001 — the control plane marks it stale
            log.warning("status callback %s for %s failed: %r", status, execution_id, e)


def _make_handler(node: ModelNodeServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # keep request logs off stderr
            pass

        def _json(self, status: int, doc: dict) -> None:
            body = json.dumps(doc).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _empty(self, status: int) -> None:
            self.send_response(status)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def do_GET(self):
            url = urllib.parse.urlsplit(self.path)
            if url.path == "/health":
                self._json(200, {"status": "ok", "node_id": node.node_id,
                                 "control_plane": node.connection_state})
            elif url.path == "/reasoners":
                self._json(200, {"reasoners": node.reasoners()})
            elif url.path == "/stats":
                self._json(200, node.backend.stats_doc())
            elif url.path == CHANNEL_PATH:
                self._channel()
            elif url.path == "/debug/flight":
                self._flight(urllib.parse.parse_qs(url.query))
            else:
                self._json(404, {"error": "not found"})

        def _channel(self):
            """Upgrade to the gateway's WebSocket and run its receive loop
            on this thread until it closes; never back into HTTP."""
            try:
                headers = handshake_headers(self.headers)
            except HandshakeError as e:
                self._json(400, {"error": str(e)})
                return
            self.close_connection = True
            self.send_response(101)
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            node.channel.serve(WebSocket(self.connection, self.rfile))

        def _flight(self, query: dict):
            """The engine's flight recorder (the JAX node's
            ``/debug/flight``): the last ``?last=N`` rows, all without."""
            try:
                last = int(query.get("last", ["0"])[0]) or None
            except ValueError:
                last = None
            eng = node.backend.engine
            self._json(200, {"node_id": node.node_id, "max_ticks": eng.flight.max_ticks,
                             "ticks_recorded": eng.flight.ticks_recorded,
                             "trace_buffer_spans": eng._tracer.span_count(),
                             "trace_spans_dropped": eng._tracer.dropped_spans,
                             "ticks": eng.flight.snapshot(last=last)})

        def _profile(self, action: str, raw: bytes):
            """``/profile/start {"dir"}`` and ``/profile/stop``: a
            ``torch.profiler`` capture, written at stop as a Chrome trace
            into ``dir`` (the JAX node's bodies and statuses)."""
            backend = node.backend
            if action == "start":
                try:
                    body = json.loads(raw) if raw else {}
                except ValueError:
                    body = {}
                if not isinstance(body, dict):
                    body = {}
                trace_dir = body.get("dir") or os.path.join(tempfile.gettempdir(),
                                                            "agentfield_tpu_torch_trace")
                try:
                    backend.profile_start(trace_dir)
                except ProfileActiveError:
                    self._json(409, {"error": "trace already active"})
                    return
                except Exception as e:  # noqa: BLE001 — reported to the caller
                    self._json(500, {"error": f"start_trace failed: {e!r}"})
                    return
                self._json(200, {"tracing": True, "dir": trace_dir})
            elif action == "stop":
                try:
                    path = backend.profile_stop()
                except LookupError:
                    self._json(409, {"error": "no active trace"})
                    return
                except Exception as e:  # noqa: BLE001 — reported to the caller
                    self._json(500, {"error": f"stop_trace failed: {e!r}"})
                    return
                self._json(200, {"tracing": False, "dir": os.path.dirname(path),
                                 "file": path})
            else:
                self._json(404, {"error": "action must be start|stop"})

        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(n) if n else b""
            if self.path == "/generate/stream":
                self._stream(raw)
                return
            if self.path.startswith("/profile/"):
                self._profile(self.path[len("/profile/"):], raw)
                return
            cid = self.path[len("/reasoners/"):] if self.path.startswith("/reasoners/") else None
            if cid not in node.components:
                self._json(404, {"error": "unknown component"})
                return
            try:
                body = json.loads(raw) if raw else {}
            except ValueError:
                self._json(400, {"error": "invalid JSON"})
                return
            if not isinstance(body, dict):
                self._json(400, {"error": "JSON object body required"})
                return
            payload = body.get("input")
            eid = self.headers.get("X-Execution-ID")
            if eid and node.client is not None:
                # gateway-tracked: ack now, call back with the outcome
                node.run_tracked(cid, payload, eid)
                self._empty(202)
                return
            try:
                result = node.invoke(cid, payload)
            except (QueueFullError, GrammarCapacityError) as e:
                self._json(503, {"error": repr(e)})
                return
            except (BadRequestError, SchemaError) as e:
                self._json(400, {"error": repr(e)})
                return
            except (RequestTooLongError, ValueError, TypeError) as e:
                self._json(422, {"error": repr(e)})
                return
            except Exception as e:  # noqa: BLE001 — reported to the caller
                self._json(500, {"error": repr(e)})
                return
            self._json(200, {"result": result})

        def _stream(self, raw: bytes) -> None:
            """SSE token stream (the JAX node's ``stream_handler``):
            ``data: {frame}`` per event, ``: ping`` after 10 s without one,
            a terminal frame before close on a failure, the request
            cancelled when the reader goes away."""
            backend = node.backend
            try:
                body = json.loads(raw) if raw else {}
                if not isinstance(body, dict):
                    raise ValueError("JSON object body required")
                rid, q, _ = backend.submit_stream(**backend.prep_stream_kwargs(body))
            except QueueFullError as e:
                self._json(503, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 — a request the stream cannot take
                self._json(400, {"error": repr(e)})
                return
            self.close_connection = True  # the stream ends with the connection
            set_send_timeout(self.connection, SEND_TIMEOUT_S)  # a stalled reader is cut
            node.track(threading.current_thread())  # a drain waits for its last frame
            try:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.end_headers()
                while True:
                    try:
                        ev = q.get(timeout=SSE_PING_S)
                    except queue.Empty:
                        self.wfile.write(b": ping\n\n")  # idle: keep proxies open
                        self.wfile.flush()
                        continue
                    frame = backend.event_frame(ev)
                    if ev.finished:
                        meta = backend.pop_group_meta(rid)
                        if meta is not None:
                            frame["branches"] = meta
                    self.wfile.write(f"data: {json.dumps(frame)}\n\n".encode())
                    self.wfile.flush()
                    if ev.finished:
                        break
            except OSError:
                backend.cancel(rid)  # the reader is gone
            except Exception as e:  # noqa: BLE001 — terminal frame, then close
                try:
                    self.wfile.write(("data: " + json.dumps(
                        {"token": -1, "index": -1, "finished": True,
                         "finish_reason": f"error: {e!r}"}) + "\n\n").encode())
                    self.wfile.flush()
                except OSError:
                    pass
                backend.cancel(rid)
            finally:
                backend.release_stream(rid)
                node.untrack(threading.current_thread())

    return Handler


def load_draft_model(source: str, target_vocab: int, seed: int = 0,
                     device: str | torch.device = "cuda",
                     dtype: str | torch.dtype | None = None):
    """A speculative-decoding draft, the ``(params, cfg)`` pair
    ``InferenceEngine(draft=...)`` takes: an HF checkpoint directory loads
    its trained weights (``models.hf_loader``, in ``dtype``, default
    bfloat16); a preset name draws random weights from ``seed`` (in
    ``dtype``, default the preset's). Both land on ``device``. A vocabulary
    other than the target's is refused (speculation compares token ids)."""
    import os

    if os.path.isdir(source):
        from agentfield_tpu_torch.models.hf_loader import config_from_hf, load_hf_checkpoint

        dcfg = config_from_hf(source)  # the vocab check before any weight is read
    else:
        dcfg = get_config(source)
    if dcfg.vocab_size != target_vocab:
        raise ValueError(
            f"spec draft {source!r} vocab {dcfg.vocab_size} != target vocab {target_vocab}")
    if os.path.isdir(source):
        _, params = load_hf_checkpoint(source, dcfg, dtype=dtype or "bfloat16", device=device)
        return params, dcfg
    return init_params(dcfg, seed=seed, dtype=dtype, device=device), dcfg


def merge_adapter(params: dict[str, Any], path: str, device) -> dict[str, Any]:
    """``params`` with the LoRA adapter at ``path`` merged in (fp leaves).
    Every target's shape is checked against the base first: a clear error
    beats a broadcast failure inside ``merge_lora``."""
    from agentfield_tpu_torch.training.lora import load_adapter, merge_lora

    lcfg, adapter = load_adapter(path, device=device)
    for t in lcfg.targets:
        base_shape = tuple(params["layers"][t].shape)
        a_shape = tuple(adapter["layers"][f"{t}_a"].shape)
        b_shape = tuple(adapter["layers"][f"{t}_b"].shape)
        if base_shape[:2] != a_shape[:2] or base_shape[2] != b_shape[2]:
            raise ValueError(
                f"LoRA adapter {path!r} was trained for a different "
                f"model shape: target {t} is {base_shape}, adapter "
                f"a={a_shape} b={b_shape}"
            )
    with torch.no_grad():
        return merge_lora(params, adapter, lcfg)


# the JAX node's operator overrides of engine fields: (variable, field, parser)
ENV_OVERRIDES = (
    ("AGENTFIELD_PREFIX_SKETCH_BYTES", "prefix_sketch_bytes", int),
    ("AGENTFIELD_SPEC_PREFILL", "spec_prefill",
     lambda v: v.strip().lower() not in ("0", "false", "no", "off")),
    ("AGENTFIELD_SPEC_PIN_TTL_S", "spec_pin_ttl", float),
    ("AGENTFIELD_SPEC_PIN_BUDGET", "spec_pin_budget", int),
    ("AGENTFIELD_SPEC_MAX_CANDIDATES", "spec_max_candidates", int),
)


def card_available() -> bool:
    """Whether this machine has a CUDA device to serve on (the CLI's
    ``model`` refuses to fall back to the CPU unasked)."""
    return torch.cuda.is_available()


def build_model_node(
    model: str = "llama-3-8b",
    seed: int = 0,
    ecfg: EngineConfig | None = None,
    device: str | torch.device = "cuda",
    params: dict[str, Any] | None = None,
    tokenizer=None,
    node_id: str = "model",
    spec_draft: str | None = None,
    spec_k: int | None = None,
    control_plane: str | None = None,
    quant: str | None = None,
    checkpoint: str | None = None,
    vision=None,
    audio=None,
    tts=None,
    imagegen=None,
    role: str | None = None,
    lora: str | None = None,
    tp: int = 1,
    tp_backend: str | None = None,
) -> tuple[ModelNodeServer, ModelBackend]:
    """Construct ``(server, backend)`` for a preset: random weights drawn
    from ``seed`` on ``device`` unless ``params`` are given, the byte
    tokenizer unless one is given. With ``checkpoint`` (an HF checkpoint
    directory, the JAX node's ``checkpoint``) the config and the bf16
    weights come from the directory (``models.hf_loader``), the model name
    is the path, and the tokenizer is the directory's ``HFTokenizer`` when it
    has a ``tokenizer.json`` (one the port cannot read raises), else the byte
    tokenizer. ``quant="int8"`` serves weight-only int8
    (the layer projections and expert stacks go through the int8-weight
    kernel on the card; embed, ``lm_head``, norms, a MoE router and the
    speculative draft stay fp, as on the JAX node): given ``params`` are
    quantized by ``models.quant.quantize_params``; random weights are drawn
    by ``init_params(quantize=True)``, one matrix at a time quantized and
    packed, so no fp stack is ever held whole (Mixtral-8x7B's bf16 expert
    stacks alone would not fit the card). ``spec_k`` sets ``ecfg.spec_k``; with
    ``spec_k > 0`` the ``spec_draft`` preset is the draft model
    (``load_draft_model``, seed ``seed + 4`` as the JAX node draws it, in
    the target's dtype). With ``control_plane`` (its base URL) the server
    registers as ``node_id`` and heartbeats. Call ``server.start(port=...)``.
    A checkpoint under ``quant="int8"`` is quantized as it loads, one
    matrix at a time, so its fp stacks are never held whole either.
    ``vision``, ``audio``, ``tts`` and ``imagegen`` are ``ModelBackend``'s
    tower and head contract (the JAX node's). ``role`` (else
    $AGENTFIELD_NODE_ROLE, else "mixed") is the node's pool in two-phase
    dispatch. As on the JAX node, $AGENTFIELD_PREFIX_SKETCH_BYTES,
    $AGENTFIELD_SPEC_PREFILL, $AGENTFIELD_SPEC_PIN_TTL_S,
    $AGENTFIELD_SPEC_PIN_BUDGET and $AGENTFIELD_SPEC_MAX_CANDIDATES override
    the engine's fields of those names (a malformed value keeps the
    configured one). ``lora`` (an adapter directory,
    ``training.lora.save_adapter``'s) is merged into the fp weights at load
    (``merge_lora``), before ``quant`` quantizes them, as on the JAX node; an
    adapter whose target shapes are not this model's raises ``ValueError``.
    Given ``params`` are served detached from autograd (a train state's
    leaves among them).

    ``tp`` > 1 serves the model tensor-parallel over ``tp`` ranks (the JAX
    node's ``tp``): this process is rank 0 and starts the other ranks
    (``parallel.worker.start_workers``; ``stop()`` joins them) over
    ``tp_backend``, which the caller names (no default): "nccl" with a
    card a rank (rank r on ``cuda:r``; unverified: no run has yet seen an
    NCCL all-reduce complete, nor its collectives captured in the decode
    graphs, ROADMAP A5), "gloo" on the CPU or for several ranks sharing
    ``device``. Each rank
    makes only its own slice: random weights are drawn whole, one matrix at
    a time in ``init_params``'s order, and cut (bit-equal to slices of the
    TP=1 node's tree); a checkpoint loads each rank's rows or columns
    (``load_hf_checkpoint(shard=)``). Given ``params`` and ``lora`` are
    refused under ``tp``. Everything else of the node runs under ``tp``: the
    media towers and heads (on rank 0, whose engine sends a prompt's
    embeddings to the workers inside its prefill), the host KV tier
    (``ecfg.host_cache_bytes``: each rank demotes and restores its own heads
    of a page), the cluster tier and two-phase handoff (the wire carries
    whole pages, every KV head, as a TP=1 node's: ``kv_export_pages``'
    ``parts`` and ``segs`` are equal on both), and the heartbeat's prefix
    sketch."""
    role = role or os.environ.get("AGENTFIELD_NODE_ROLE") or "mixed"
    if role not in ROLES:
        raise ValueError(
            f"unknown node role {role!r}: 'prefill' | 'decode' | 'mixed' "
            "(AGENTFIELD_NODE_ROLE / build_model_node(role=...))"
        )
    if quant is not None and quant != "int8":
        raise ValueError(f"unknown quant mode {quant!r} (have: 'int8')")
    if checkpoint:
        from agentfield_tpu_torch.models.hf_loader import config_from_hf, load_hf_checkpoint

        if tp > 1:  # each rank loads its own slice (_build_tp_node)
            cfg = config_from_hf(checkpoint)
        else:
            # with an adapter the fp weights load first: the merge comes before quantizing
            cfg, params = load_hf_checkpoint(checkpoint, device=device,
                                             quant=None if lora else quant)
        model = checkpoint
        if tokenizer is None and os.path.exists(os.path.join(checkpoint, "tokenizer.json")):
            tokenizer = HFTokenizer(checkpoint)
    else:
        cfg = get_config(model)
    if ecfg is None:
        ecfg = EngineConfig(grammar_slots=GRAMMAR_SLOTS)
    for env, field, parse in ENV_OVERRIDES:
        v = os.environ.get(env)
        if v is not None:
            try:
                ecfg = dataclasses.replace(ecfg, **{field: parse(v)})
            except ValueError:
                pass
    if spec_k is not None:
        ecfg = dataclasses.replace(ecfg, spec_k=spec_k)
    if ecfg.spec_k > 0 and spec_draft is None:
        raise ValueError("spec_k > 0 needs spec_draft=<model preset>")
    if tp > 1:
        if tp_backend is None:
            raise ValueError(f"tp={tp} needs tp_backend='gloo' or 'nccl' (no default)")
        return _build_tp_node(cfg, ecfg, tp, tp_backend, seed=seed, device=device,
                              params=params, tokenizer=tokenizer, node_id=node_id,
                              spec_draft=spec_draft if ecfg.spec_k > 0 else None,
                              control_plane=control_plane, quant=quant,
                              checkpoint=checkpoint, model=model, lora=lora, role=role,
                              media=(vision, audio, tts, imagegen))
    if params is None:
        params = init_params(cfg, seed=seed, device=device,
                             quantize=quant is not None and lora is None)
    else:
        params = llama.detached(params)
    if lora is not None:
        params = merge_adapter(params, lora, device)
    if quant is not None:
        params = quantize_params(params)  # idempotent
    draft = None
    if ecfg.spec_k > 0:
        draft = load_draft_model(spec_draft, cfg.vocab_size, seed=seed + 4, device=device,
                                 dtype=params["embed"].dtype)
    if tokenizer is None:
        tokenizer = ByteTokenizer(cfg.vocab_size)
    backend = ModelBackend(
        params, cfg, ecfg, tokenizer=tokenizer, seed=seed, model_name=model, device=device,
        draft=draft, vision=vision, audio=audio, tts=tts, imagegen=imagegen,
    )
    return ModelNodeServer(backend, node_id=node_id, control_plane=control_plane,
                           role=role), backend


def _build_tp_node(cfg, ecfg, tp, backend, *, seed, device, params, tokenizer, node_id,
                   spec_draft, control_plane, quant, checkpoint, model, lora, role, media):
    """``build_model_node``'s tensor-parallel path (its docstring)."""
    from agentfield_tpu_torch.parallel.worker import (
        CheckpointWeights, RandomWeights, WorkerSpec, start_workers)

    if params is not None:
        raise ValueError("build_model_node(tp>1) makes each rank's weights itself: pass a "
                         "seed or a checkpoint, not params")
    if lora is not None:
        raise NotImplementedError(
            "lora= under a tensor-parallel mesh is not ported (ROADMAP A5: the trainer's "
            "mesh pieces)")
    if checkpoint:
        weights = CheckpointWeights(checkpoint, quant, spec_draft, seed)
    else:
        weights = RandomWeights(cfg, seed, quant is not None, spec_draft, cfg.dtype)
    spec = WorkerSpec(cfg, ecfg, seed, weights, backend, str(device),
                      threads=torch.get_num_threads() if torch.device(device).type == "cpu"
                      else None)
    mesh = start_workers(tp, spec)
    try:
        own, draft = weights(mesh)
        if tokenizer is None:
            tokenizer = ByteTokenizer(cfg.vocab_size)
        vision, audio, tts, imagegen = media
        backend_ = ModelBackend(own, cfg, ecfg, tokenizer=tokenizer, seed=seed,
                                model_name=model, device=mesh.device, draft=draft, mesh=mesh,
                                vision=vision, audio=audio, tts=tts, imagegen=imagegen)
        mesh.workers.wait_ready()
    except BaseException:
        mesh.close()
        raise
    return ModelNodeServer(backend_, node_id=node_id, control_plane=control_plane,
                           role=role), backend_


# -- the gRPC data plane (the JAX node's ModelGrpcService) --------------------

# Optional scalar fields of GenerateRequest, shared by the server-side
# decode and the client-side encode so the two cannot drift.
_GRPC_SCALAR_FIELDS = ("prompt", "max_new_tokens", "temperature", "top_k",
                       "top_p", "session_id", "context_overflow")
GRPC_TIMEOUT_CAP_S = 600.0  # a call without a deadline (or a longer one) waits this long


def _grpc_request_to_kwargs(request) -> dict[str, Any]:
    """GenerateRequest proto → backend.generate kwargs. `optional` fields
    pass through only when present, so server-side defaults (top_p=1 etc.)
    stay authoritative."""
    kwargs: dict[str, Any] = {}
    for f in _GRPC_SCALAR_FIELDS:
        if request.HasField(f):
            kwargs[f] = getattr(request, f)
    if request.tokens:
        kwargs["tokens"] = list(request.tokens)
    if request.stop_token_ids:
        kwargs["stop_token_ids"] = list(request.stop_token_ids)
    if request.HasField("response_schema_json"):
        kwargs["response_schema"] = json.loads(request.response_schema_json)
    if request.images:
        # raw encoded bytes straight through — _decode_image takes them
        # as-is (no base64 round trip on the data-plane hot path)
        kwargs["images"] = list(request.images)
    return kwargs


def _result_to_grpc_response(result: dict[str, Any]):
    from agentfield_tpu_torch.control_plane.proto import modelnode_pb2

    return modelnode_pb2.GenerateResponse(
        tokens=result.get("tokens", []),
        text=result.get("text", ""),
        finish_reason=result.get("finish_reason") or "",
        model=result.get("model", ""),
        logprobs=[lp for lp in (result.get("logprobs") or []) if lp is not None],
        truncated_prompt_tokens=int(result.get("truncated_prompt_tokens", 0)),
    )


class ModelGrpcService:
    """The model node's gRPC surface (``agentfield.model.v1.ModelNode/
    Generate``, modelnode.proto), on the port's own transport
    (``control_plane/grpc_h2.py``): the unary Generate blocks a pool thread
    until ``ModelBackend.generate`` returns. The status codes are the JAX
    service's: INVALID_ARGUMENT for a bad ``response_schema_json`` and for
    RequestTooLongError, RESOURCE_EXHAUSTED for QueueFullError (a draining
    node's NodeDrainingError among them), DEADLINE_EXCEEDED when the
    caller's deadline (capped at ``GRPC_TIMEOUT_CAP_S``) runs out, INTERNAL
    for anything else. A deadline that runs out, or a client that cancels
    (RST_STREAM, the transport's ``add_callback`` hooks), ends the request
    through the node's cancel path, so its engine slot and pages are
    released (the JAX service cancels the coroutine); no ``deadline_s``
    rides into the engine, whose counters stay the HTTP path's."""

    SERVICE = "agentfield.model.v1.ModelNode"

    def __init__(self, backend: ModelBackend):
        self.backend = backend

    def service(self, handler_call_details):
        from agentfield_tpu_torch.control_plane import grpc_h2 as grpc
        from agentfield_tpu_torch.control_plane.proto import modelnode_pb2

        if handler_call_details.method != f"/{self.SERVICE}/Generate":
            return None

        def generate(request, context):
            try:
                kwargs = _grpc_request_to_kwargs(request)
            except ValueError as e:  # malformed response_schema_json etc.
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))

            def on_cancel(fn) -> None:  # the client reset the stream, or the server stops
                if not context.add_callback(fn):
                    fn()  # it ended before the hook was in: cancel at once

            remaining = context.time_remaining()
            timeout = (min(remaining, GRPC_TIMEOUT_CAP_S) if remaining is not None
                       else GRPC_TIMEOUT_CAP_S)
            try:
                return _result_to_grpc_response(
                    self.backend.generate(**kwargs, timeout=timeout, on_cancel=on_cancel))
            except TimeoutError:
                context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, "generation timed out")
            except ExecutionCancelled:
                context.abort(grpc.StatusCode.CANCELLED, "the client cancelled the call")
            except QueueFullError as e:
                # Admission backpressure is retryable — mirror the SSE path's
                # 503 (reference queue-full semantics, execute.go:1373-1410).
                context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
            except RequestTooLongError as e:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
            except Exception as e:  # noqa: BLE001 — the JAX service's INTERNAL
                context.abort(grpc.StatusCode.INTERNAL, repr(e))

        return grpc.unary_unary_rpc_method_handler(
            generate,
            request_deserializer=modelnode_pb2.GenerateRequest.FromString,
            response_serializer=modelnode_pb2.GenerateResponse.SerializeToString,
        )


def start_model_grpc(backend: ModelBackend, port: int):
    """Serve Generate on ``127.0.0.1:port`` (the node's HTTP port + 100, by
    the CLI's convention); returns the server (``stop(grace)``). A port
    that cannot be bound raises OSError."""
    from agentfield_tpu_torch.control_plane import grpc_h2 as grpc

    server = grpc.server(max_workers=8)
    server.add_generic_rpc_handlers((ModelGrpcService(backend),))
    bound = server.add_insecure_port(f"127.0.0.1:{port}")
    if bound == 0:
        raise OSError(f"model gRPC could not bind 127.0.0.1:{port}")
    server.start()
    return server


def model_grpc_request(request: dict):
    """The HTTP body's dict shape (response_schema as a dict, images as
    ``{"b64": ...}`` entries) → a GenerateRequest."""
    from agentfield_tpu_torch.control_plane.proto import modelnode_pb2

    msg = modelnode_pb2.GenerateRequest()
    for f in _GRPC_SCALAR_FIELDS:
        if request.get(f) is not None:
            setattr(msg, f, request[f])
    if request.get("tokens"):
        msg.tokens.extend(request["tokens"])
    if request.get("stop_token_ids"):
        msg.stop_token_ids.extend(request["stop_token_ids"])
    if request.get("response_schema") is not None:
        msg.response_schema_json = json.dumps(request["response_schema"])
    for im in request.get("images") or []:
        if not (isinstance(im, dict) and "b64" in im):
            raise ValueError("gRPC images must be {'b64': <base64 bytes>} entries")
        msg.images.append(base64.b64decode(im["b64"]))
    return msg


def model_grpc_response(resp) -> dict[str, Any]:
    out: dict[str, Any] = {
        "tokens": list(resp.tokens),
        "text": resp.text,
        "finish_reason": resp.finish_reason or None,
        "model": resp.model,
    }
    if resp.logprobs:
        out["logprobs"] = list(resp.logprobs)
    if resp.truncated_prompt_tokens:
        out["truncated_prompt_tokens"] = resp.truncated_prompt_tokens
    return out


def model_grpc_generate(port: int, request: dict, timeout: float = 600.0,
                        channel=None) -> dict:
    """Client helper for the gRPC Generate surface, as the JAX node's:
    the HTTP body's dict in, the result dict out (RpcError on a failed
    call). ``channel`` (a ``grpc_h2.Channel``) reuses a connection; else
    one is opened for the call."""
    from agentfield_tpu_torch.control_plane import grpc_h2 as grpc
    from agentfield_tpu_torch.control_plane.proto import modelnode_pb2

    msg = model_grpc_request(request)
    own = channel is None
    ch = grpc.insecure_channel(f"127.0.0.1:{port}") if own else channel
    try:
        fn = ch.unary_unary(
            f"/{ModelGrpcService.SERVICE}/Generate",
            request_serializer=modelnode_pb2.GenerateRequest.SerializeToString,
            response_deserializer=modelnode_pb2.GenerateResponse.FromString,
        )
        resp = fn(msg, timeout=timeout)
    finally:
        if own:
            ch.close()
    return model_grpc_response(resp)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="Serve a model over HTTP on the GPU.")
    ap.add_argument("--model", default="llama-3-8b")
    ap.add_argument("--checkpoint", default=None, metavar="DIR",
                    help="serve this Hugging Face checkpoint directory (config, weights, "
                         "tokenizer and chat template) instead of a random preset")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kv-quant-dtype", default="none", choices=KV_QUANT_DTYPES,
                    help="store KV pages quantized with per-slot scales")
    ap.add_argument("--quant", default=None, choices=("int8",),
                    help="weight-only int8 layer projections (the int8-weight kernel)")
    ap.add_argument("--spec-draft", default=None,
                    help="draft model for speculative decoding (with --spec-k): a preset "
                         "name or a checkpoint directory")
    ap.add_argument("--spec-k", type=int, default=None,
                    help="draft proposals per speculative step (needs --spec-draft)")
    ap.add_argument("--control-plane", default=None, metavar="URL",
                    help="register with this control plane and heartbeat to it")
    ap.add_argument("--node-id", default="model", help="the node's id in the control plane")
    for flag, what in (("--vision", "vision tower for <image> inputs"),
                       ("--audio", "audio tower for <audio> inputs"),
                       ("--tts", "TTS head for output='audio'/'speech'"),
                       ("--imagegen", "image-generation head for output='image'")):
        ap.add_argument(flag, default=None,
                        help=f"{what}: a config name (random weights) or a checkpoint directory")
    ap.add_argument("--lora", default=None, metavar="DIR",
                    help="LoRA adapter dir (save_adapter) merged at load")
    args = ap.parse_args(argv)
    grace_s = float(os.environ.get("AGENTFIELD_DRAIN_GRACE", DRAIN_GRACE_S))
    server, _ = build_model_node(
        args.model, seed=args.seed, device=args.device,
        ecfg=EngineConfig(grammar_slots=GRAMMAR_SLOTS, kv_quant_dtype=args.kv_quant_dtype),
        spec_draft=args.spec_draft, spec_k=args.spec_k, node_id=args.node_id,
        control_plane=args.control_plane, quant=args.quant, checkpoint=args.checkpoint,
        vision=args.vision, audio=args.audio, tts=args.tts, imagegen=args.imagegen,
        lora=args.lora,
    )

    # SIGTERM and Ctrl-C drain (the JAX install_sigterm_drain); a second
    # signal during the drain is ignored: the drain is bounded
    stopping = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda signum, frame: stopping.set())
    port = server.start(args.host, args.port)
    print(f"model node {args.checkpoint or args.model} serving on http://{args.host}:{port}", flush=True)
    try:
        stopping.wait()
    finally:
        summary = server.stop(grace_s)
        print(f"model node {args.node_id} drained: {summary}", flush=True)


if __name__ == "__main__":
    main()
