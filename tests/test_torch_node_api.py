"""The port's node as the SDK and the control plane call it, against the JAX
node on the CPU (llama-tiny, float32, the same carried weights):

- ``Agent.ai()``'s payload (``chip_smoke.sdk_payload``: null media, text
  output, "truncate_left"), with a prompt, with ``messages``, with the
  routing hints, and over-long: the same greedy tokens and the same
  ``truncated_prompt_tokens`` from both backends (and from the port over
  HTTP); ``submit_stream`` reports the same truncation;
- bad requests raise the same exception class with the same message in
  both backends (media and non-text outputs on a node built without the
  tower or head: ``BadRequestError``, a ``ValueError``, on the port, where
  the JAX node raises ``ValueError``);
- ``HistogramSet``: the same snapshot for the same observations, and the
  same per-histogram counts from both engines over one script;
- a table of HTTP payloads: each status from the JAX node's own aiohttp app
  (its SDK agent's routes), asserted on the port's node; the differences
  are listed in ``ALLOWED_STATUS``, each with its reason;
- ``generate``'s and ``embed``'s parameters and input-schema property names
  compared with the JAX node's by name, the differences listed;
- the token stream (pings when idle, cancel on disconnect), tracked dispatch
  and heartbeats against ``chip_smoke.StandInControlPlane``, and
  ``chip_smoke.phase_api`` rehearsed at llama-tiny size.
"""

from __future__ import annotations

import asyncio
import dataclasses
import http.client
import inspect
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from agentfield_tpu import tracing as jax_tracing
from agentfield_tpu.models import configs as jax_configs
from agentfield_tpu.models import llama as jax_llama
from agentfield_tpu.serving import engine as jax_engine
from agentfield_tpu.serving import model_node as jax_node
from agentfield_tpu.serving.sampler import SamplingParams as JaxSampling
from agentfield_tpu_torch import tracing
from agentfield_tpu_torch.models.configs import get_config
from agentfield_tpu_torch.models.convert import params_from_numpy
from agentfield_tpu_torch.serving import engine
from agentfield_tpu_torch.serving import model_node
from agentfield_tpu_torch.serving.engine import EngineConfig, QueueFullError
from agentfield_tpu_torch.serving.model_node import ModelNodeServer, build_model_node
from agentfield_tpu_torch.serving.sampler import SamplingParams

ECFG = dict(max_batch=4, page_size=8, num_pages=64, max_pages_per_seq=8)  # max_context 64
V = 512
sdk_payload = chip_smoke.sdk_payload
MSGS = [{"role": "system", "content": "be brief"}, {"role": "user", "content": "hi there"}]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """llama-tiny gains nothing from intra-op threads; one keeps this file
    off the cores that concurrent test workers time their locks on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jax_configs.get_config("llama-tiny"), dtype="float32")
    tree = jax.tree.map(np.asarray, jax_llama.init_params(jcfg, jax.random.PRNGKey(5)))
    return jcfg, tree, params_from_numpy(tree, get_config("llama-tiny"), device="cpu")


@pytest.fixture(scope="module")
def node(weights):
    server, backend = build_model_node("llama-tiny", ecfg=EngineConfig(**ECFG), device="cpu",
                                       params=weights[2])
    port = server.start(port=0)
    yield port, backend
    server.stop()


def _call(port: int, path: str, body=None, headers=None, raw: bytes | None = None):
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method="GET" if data is None else "POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            text = resp.read()
            return resp.status, json.loads(text) if text else None
    except urllib.error.HTTPError as e:
        text = e.read()
        return e.code, json.loads(text) if text else None


def _jax_generate(weights, calls: list[dict]) -> list:
    """Each call's result (or the exception it raised) from the JAX node's
    ``generate``, one engine for the list."""
    jcfg, tree, _ = weights

    async def main():
        b = jax_node.ModelBackend(tree, jcfg, jax_node.EngineConfig(**ECFG),
                                  tokenizer=jax_node.ByteTokenizer(V), idle_sleep=0.001)
        await b.start()
        out = []
        try:
            for kw in calls:
                try:
                    out.append(await b.generate(**kw))
                except Exception as e:  # noqa: BLE001 — compared below
                    out.append(e)
        finally:
            await b.stop()
        return out

    return asyncio.run(main())


LONG_TOKENS = np.random.default_rng(7).integers(1, V, 90).tolist()  # > max_context 64
PAYLOADS = {
    "sdk_prompt": sdk_payload(prompt="the SDK payload probe", max_new_tokens=6),
    "sdk_messages": sdk_payload(messages=MSGS, max_new_tokens=6),
    "sdk_over_long_tokens": sdk_payload(tokens=LONG_TOKENS, max_new_tokens=6),
    "sdk_over_long_text": sdk_payload(prompt="an over-long text prompt " * 4, max_new_tokens=5),
    "sdk_hints": sdk_payload(prompt="hinted probe", max_new_tokens=6, expect_followup=True,
                             followup_candidates=["next step", [1, 2, 3]], handoff_export=False,
                             trace={"trace_id": "t-1"}),
}


def _span_shapes(spans: list[dict]) -> list[tuple]:
    return [(s["name"], {k: v for k, v in s.get("attrs", {}).items() if k != "rid"},
             s.get("node"), s.get("attempt")) for s in spans]


def test_sdk_payloads_match_jax(weights, node):
    port, backend = node
    want = _jax_generate(weights, list(PAYLOADS.values()))
    for (name, payload), w in zip(PAYLOADS.items(), want):
        assert isinstance(w, dict), (name, w)
        got = backend.generate(**payload)
        status, doc = _call(port, "/reasoners/generate", {"input": payload})
        assert status == 200, (name, doc)
        for res in (got, doc["result"]):
            assert res["tokens"] == w["tokens"], name
            assert res["finish_reason"] == w["finish_reason"] and res["text"] == w["text"]
            assert res.get("truncated_prompt_tokens") == w.get("truncated_prompt_tokens"), name
            # a valid trace context gives both nodes a "trace" key: the same
            # spans, in the same order, with the same attrs (clocks and the
            # request ids aside; the repeat over HTTP hits the prefix cache
            # the first call filled, so its prefill's "cached" differs)
            assert set(res) == set(w), name
            if "trace" in w:
                assert res["trace"]["trace_id"] == w["trace"]["trace_id"]
                want_spans = _span_shapes(w["trace"]["spans"])
                if res is got:
                    assert _span_shapes(res["trace"]["spans"]) == want_spans
                else:
                    assert [s[0] for s in _span_shapes(res["trace"]["spans"])] == [
                        s[0] for s in want_spans]
    assert want[2]["truncated_prompt_tokens"] == len(LONG_TOKENS) - (64 - 6)


def test_submit_stream_reports_the_truncation(weights, node):
    _, backend = node
    kw = dict(tokens=LONG_TOKENS, max_new_tokens=6, context_overflow="truncate_left")
    [want] = _jax_generate(weights, [kw])
    rid, q, truncated = backend.submit_stream(**kw)
    evs = [q.get(timeout=60)]
    while not evs[-1].finished:
        evs.append(q.get(timeout=60))
    backend.release_stream(rid)
    assert truncated == want["truncated_prompt_tokens"]
    assert [e.token for e in evs if e.token >= 0] == want["tokens"]


ERRORS = {
    "too_long": dict(tokens=LONG_TOKENS, max_new_tokens=6),
    "messages_and_prompt": dict(prompt="x", messages=MSGS),
    "bad_message": dict(messages=[{"role": "robot", "content": "x"}]),
    "overflow_policy": dict(prompt="x", context_overflow="drop"),
    "no_room": dict(prompt="x", max_new_tokens=64, context_overflow="truncate_left"),
    "nothing": dict(),
    "output_bogus": dict(prompt="x", output="smell"),
    "output_audio": dict(prompt="x", output="audio"),
    "output_image": dict(prompt="x", output="image"),
    "images": dict(prompt="x <image>", images=["aGVsbG8="]),
    "audios": dict(prompt="x", audios=["aGVsbG8="]),
    "bad_candidate": dict(prompt="x", expect_followup=True, followup_candidates=[1.5]),
    "candidates_not_list": dict(prompt="x", expect_followup=True, followup_candidates="abc"),
    "branches_zero": dict(prompt="x", n_branches=0),
    "branches_audio": dict(prompt="x", n_branches=2, output="audio"),
}
# a node built without the tower or head a request needs: the port refuses
# it with BadRequestError (a ValueError: HTTP 400 inline), the JAX node with
# ValueError, both in the JAX node's words
NO_TOWER_OR_HEAD = {"output_audio", "output_image", "images", "audios"}


def test_errors_raise_the_jax_class(weights, node):
    _, backend = node
    want = _jax_generate(weights, list(ERRORS.values()))
    for (name, kw), w in zip(ERRORS.items(), want):
        assert isinstance(w, Exception), (name, w)
        with pytest.raises(Exception) as e:
            backend.generate(**kw)
        if name in NO_TOWER_OR_HEAD:
            assert type(w) is ValueError and type(e.value) is model_node.BadRequestError, name
        else:
            assert type(e.value).__name__ == type(w).__name__, (name, e.value, w)
        if name != "too_long":  # rids differ in that message
            assert str(e.value) == str(w), name
    assert not backend.engine.pending and not backend._streams


OBSERVATIONS = [("ttft_ms", 0.4), ("ttft_ms", 12.0), ("itl_ms", 1.0), ("itl_ms", 2.5),
                ("itl_ms", 31000.0), ("tick_ms", 0.0), ("queue_wait_ms", 99.99)]


@pytest.mark.parametrize("buckets", [None, (1.0, 10.0)])
def test_histogram_set_matches_jax(buckets):
    names = ("ttft_ms", "itl_ms", "queue_wait_ms", "tick_ms")
    kw = {} if buckets is None else {"buckets": buckets}
    a, b = jax_tracing.HistogramSet(names, **kw), tracing.HistogramSet(names, **kw)
    for name, v in OBSERVATIONS:
        a.observe(name, v)
        b.observe(name, v)
    assert a.snapshot() == b.snapshot()
    with pytest.raises(KeyError):
        b.observe("nope", 1.0)
    assert tracing.MS_BUCKETS == jax_tracing.MS_BUCKETS


@pytest.mark.parametrize("mixed", [False, True], ids=["classic", "mixed"])
def test_engine_histogram_counts_match_jax(weights, mixed):
    """One script through both engines: each histogram counts the same
    number of observations (its values are host times)."""
    jcfg, tree, params = weights
    over = dict(mixed_step=True, mixed_step_budget=24, prefill_chunk=16) if mixed else {}
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, V, n).tolist() for n in (5, 30, 12, 3, 40)]
    counts = []
    for mod in (jax_engine, engine):
        if mod is jax_engine:
            eng = jax_engine.InferenceEngine(tree, jcfg, jax_engine.EngineConfig(**ECFG, **over))
            samp = JaxSampling
        else:
            eng = engine.InferenceEngine(params, get_config("llama-tiny"),
                                         engine.EngineConfig(**ECFG, **over))
            samp = SamplingParams
        for i, p in enumerate(prompts):
            eng.submit(mod.Request(id=f"r{i}", prompt=p, sampling=samp(max_new_tokens=7)))
        steps = 0
        while eng.has_work():
            eng.step()
            steps += 1
            if steps == 3:  # a late arrival, queued behind the rest
                eng.submit(mod.Request(id="late", prompt=prompts[0],
                                       sampling=samp(max_new_tokens=4)))
        counts.append({k: v["count"] for k, v in eng.latency_histograms().items()})
    assert counts[0] == counts[1]
    assert counts[1]["ttft_ms"] == counts[1]["queue_wait_ms"] == len(prompts) + 1
    assert counts[1]["itl_ms"] == len(prompts) * 6 + 3


# -- the HTTP surface against the JAX node's ---------------------------------

TABLE = {
    # name: (path, body, raw body)
    "sdk_prompt": ("/reasoners/generate", {"input": PAYLOADS["sdk_prompt"]}, None),
    "sdk_messages": ("/reasoners/generate", {"input": PAYLOADS["sdk_messages"]}, None),
    "sdk_over_long": ("/reasoners/generate", {"input": PAYLOADS["sdk_over_long_tokens"]}, None),
    "plain_tokens": ("/reasoners/generate", {"input": {"tokens": [1, 2, 3],
                                                       "max_new_tokens": 2}}, None),
    "null_bool": ("/reasoners/generate", {"input": {"prompt": "x", "expect_followup": None}},
                  None),
    "null_output": ("/reasoners/generate", {"input": {"prompt": "x", "output": None}}, None),
    "unknown_key": ("/reasoners/generate", {"input": {"prompt": "x", "max_new_tokens": 2,
                                                      "bogus": 1}}, None),
    "no_prompt": ("/reasoners/generate", {"input": {}}, None),
    "null_input": ("/reasoners/generate", {"input": None}, None),
    "over_long_error": ("/reasoners/generate", {"input": dict(
        PAYLOADS["sdk_over_long_tokens"], context_overflow="error")}, None),
    "bad_message": ("/reasoners/generate", {"input": {"messages": [{"role": "robot",
                                                                    "content": "x"}]}}, None),
    "image_input": ("/reasoners/generate", {"input": {"prompt": "x", "images": ["aGk="]}},
                    None),
    "audio_output": ("/reasoners/generate", {"input": {"prompt": "x", "output": "audio"}},
                     None),
    "invalid_json": ("/reasoners/generate", None, b"{not json"),
    "array_body": ("/reasoners/generate", [1, 2], None),
    "unknown_reasoner": ("/reasoners/nope", {"input": {}}, None),
    "embed": ("/reasoners/embed", {"input": {"prompt": "embed me"}}, None),
    "embed_batch": ("/reasoners/embed", {"input": {"prompts": ["a", "bb"],
                                                   "pooling": "last"}}, None),
    "embed_bad_pooling": ("/reasoners/embed", {"input": {"prompt": "x", "pooling": "max"}},
                          None),
    "stream": ("/generate/stream", {"prompt": "stream me", "max_new_tokens": 2}, None),
    "stream_sdk_shape": ("/generate/stream", dict(PAYLOADS["sdk_messages"], max_new_tokens=2,
                                                  images=None), None),
    "stream_no_prompt": ("/generate/stream", {"max_new_tokens": 2}, None),
    "stream_audio": ("/generate/stream", {"prompt": "x", "output": "audio"}, None),
    "stream_invalid_json": ("/generate/stream", None, b"]["),
}
# Inline answers only: the gateway always sends X-Execution-ID, so it gets
# 202 and a status callback from both nodes, and the SDK's own direct route
# is /generate/stream, where both give the same codes.
ALLOWED_STATUS = {
    "unknown_key": (200, 422, "the JAX SDK's input model ignores unknown keys; the port "
                              "refuses them so a typo cannot pass silently"),
    "no_prompt": (500, 422, "the port answers a bad argument (ValueError) with 422"),
    "null_input": (500, 422, "the port answers a bad argument (ValueError) with 422"),
    "over_long_error": (500, 422, "RequestTooLongError: 422 on the port"),
    "bad_message": (500, 422, "the port answers a bad argument (ValueError) with 422"),
    "image_input": (500, 400, "a node built without the tower: 400 (BadRequestError) on "
                              "the port"),
    "audio_output": (500, 400, "a node built without the head: 400 (BadRequestError) on "
                               "the port"),
    "embed_bad_pooling": (500, 422, "the port answers a bad argument (ValueError) with 422"),
}


def _jax_statuses(weights) -> dict[str, int]:
    """Every table row's status from the JAX node's own HTTP app (the JAX
    SDK agent's routes and the node's stream route), no execution id."""
    from aiohttp.test_utils import TestClient, TestServer

    jcfg, tree, _ = weights

    async def main():
        agent, backend = jax_node.build_model_node(
            model="llama-tiny", params=tree, ecfg=jax_node.EngineConfig(**ECFG))
        backend.cfg = jcfg  # float32 weights: the float32 config
        await backend.start()
        client = TestClient(TestServer(agent._build_app()))
        await client.start_server()
        out = {}
        try:
            for name, (path, body, raw) in TABLE.items():
                data = raw if raw is not None else json.dumps(body).encode()
                async with client.post(path, data=data,
                                       headers={"Content-Type": "application/json"}) as r:
                    out[name] = r.status
                    await r.read()
        finally:
            await client.close()
            await backend.stop()
        return out

    return asyncio.run(main())


def test_http_status_table_matches_jax(weights, node):
    port, backend = node
    jax_status = _jax_statuses(weights)
    for name, (path, body, raw) in TABLE.items():
        if path == "/generate/stream":
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request("POST", path, raw if raw is not None else json.dumps(body),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            status = resp.status
            resp.read()
            conn.close()
        else:
            status = _call(port, path, body, raw=raw)[0]
        if name in ALLOWED_STATUS:
            j, p, _ = ALLOWED_STATUS[name]
            assert (jax_status[name], status) == (j, p), name
        else:
            assert status == jax_status[name], (name, status, jax_status[name])
    assert _idle(backend)


def test_parameters_and_schemas_match_jax_by_name(weights):
    """``generate``/``embed`` take the JAX node's parameters, in order; the
    registered input schemas carry the JAX node's property names."""
    port_gen = list(inspect.signature(model_node.ModelBackend.generate).parameters)
    jax_gen = list(inspect.signature(jax_node.ModelBackend.generate).parameters)
    # the port's generate is synchronous: `timeout` bounds the caller's wait
    # and `on_cancel` takes a channel cancel (the JAX node's caller cancels
    # its task instead); neither is an input key
    assert [p for p in port_gen if p not in ("timeout", "on_cancel")] == jax_gen
    assert not {"timeout", "on_cancel"} & set(model_node.GENERATE_PARAMS)
    assert (list(inspect.signature(model_node.ModelBackend.embed).parameters)
            == list(inspect.signature(jax_node.ModelBackend.embed).parameters))
    # submit_stream: the JAX node's pre-warmed grammar and pre-fused media
    # arguments are its async internals; the port compiles and fuses inline
    port_ss = list(inspect.signature(model_node.ModelBackend.submit_stream).parameters)
    jax_ss = list(inspect.signature(jax_node.ModelBackend.submit_stream).parameters)
    assert port_ss == [p for p in jax_ss if p not in ("grammar_obj", "prefused")]
    agent, _ = jax_node.build_model_node(model="llama-tiny", params=weights[1],
                                         ecfg=jax_node.EngineConfig(**ECFG))
    server = ModelNodeServer(model_node.ModelBackend(
        weights[2], get_config("llama-tiny"), EngineConfig(**ECFG)))
    ours = {r["id"]: list(r["input_schema"]["properties"]) for r in server.reasoners()}
    theirs = {cid: list(c.input_schema["properties"]) for cid, c in agent.components.items()}
    assert ours == theirs
    assert tuple(theirs["generate"]) == chip_smoke.JAX_GENERATE_PROPS
    assert tuple(theirs["embed"]) == chip_smoke.JAX_EMBED_PROPS
    # the heartbeat's own keys and latency histograms are the JAX node's
    jax_hb = agent.heartbeat_stats()
    port_hb = server.backend.heartbeat_stats()
    assert set(chip_smoke.HEARTBEAT_KEYS) <= set(jax_hb) & set(port_hb)
    assert set(jax_hb["latency_hist"]) == set(port_hb["latency_hist"])


def test_stats_and_health_routes(node):
    port, backend = node
    status, doc = _call(port, "/stats")
    assert status == 200 and doc["model"] == "llama-tiny"
    assert {"active_slots", "pending", "free_pages", "decode_tokens", "itl_ms_p50",
            "prefix_cached_pages"} <= set(doc)
    assert doc["free_pages"] == backend.engine.allocator.free_pages
    status, doc = _call(port, "/reasoners")
    assert [r["id"] for r in doc["reasoners"]] == ["generate", "embed"]


def _idle(b) -> bool:
    for _ in range(1000):
        if not b.engine.has_work() and b.engine.allocator.free_pages == ECFG["num_pages"] - 1:
            return True
        time.sleep(0.01)
    return False


def test_stream_pings_when_idle_and_cancels_on_disconnect(node, monkeypatch):
    port, backend = node
    monkeypatch.setattr(model_node, "SSE_PING_S", 0.02)
    step = backend.engine.step

    def slow_step():
        time.sleep(0.05)
        return step()

    monkeypatch.setattr(backend.engine, "step", slow_step)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/generate/stream",
                 json.dumps({"prompt": "ping me", "max_new_tokens": 40}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200 and resp.getheader("Content-Type") == "text/event-stream"
    lines = []
    while not any(ln.startswith(b"data: ") for ln in lines):
        lines.append(resp.readline())
    assert b": ping\n" in lines
    frame = json.loads(next(ln for ln in lines if ln.startswith(b"data: "))[6:])
    assert frame["index"] == 0 and not frame["finished"]
    conn.close()  # the reader goes away mid-stream
    monkeypatch.setattr(backend.engine, "step", step)
    assert _idle(backend), "the abandoned stream's request still holds pages"
    assert not backend._streams


# -- the control plane, with the stand-in -------------------------------------


def _stand_in_node(weights, heartbeat_interval=2.0):
    cp = chip_smoke.StandInControlPlane()
    url = cp.start()
    server, backend = build_model_node("llama-tiny", ecfg=EngineConfig(**ECFG), device="cpu",
                                       params=weights[2], node_id="m1", control_plane=url)
    server.heartbeat_interval = heartbeat_interval
    return cp, server, backend


def test_tracked_dispatch_posts_the_outcome(weights):
    cp, server, backend = _stand_in_node(weights)
    port = server.start()
    try:
        hdr = {"X-Execution-ID": "e-ok"}
        body = {"input": sdk_payload(prompt="tracked probe", max_new_tokens=4),
                "execution_id": "e-ok"}
        assert _call(port, "/reasoners/generate", body, hdr) == (202, None)
        assert _call(port, "/reasoners/embed", {"input": {"prompt": "v"}},
                     {"X-Execution-ID": "e-vec"}) == (202, None)
        assert _call(port, "/reasoners/generate", {"input": {"bogus": 1}},
                     {"X-Execution-ID": "e-bad"})[0] == 202

        def full(prompt):
            raise QueueFullError("pending queue at capacity 0")

        submit = backend.engine.submit
        backend.engine.submit = full
        try:
            assert _call(port, "/reasoners/generate", {"input": {"prompt": "x"}},
                         {"X-Execution-ID": "e-full"})[0] == 202
            assert cp.wait(lambda: "e-full" in cp.statuses, 30)
        finally:
            backend.engine.submit = submit
        assert cp.wait(lambda: {"e-ok", "e-vec", "e-bad"} <= set(cp.statuses), 30)
        direct = _call(port, "/reasoners/generate", {"input": body["input"]})[1]["result"]
    finally:
        server.stop()
        cp.stop()
    ok = cp.statuses["e-ok"]
    assert ok["status"] == "completed" and ok["error"] is None
    # the same answer as the direct call (logprobs: another batch, last digits)
    assert ok["result"]["tokens"] == direct["tokens"]
    assert set(ok["result"]) == set(direct)
    assert cp.statuses["e-vec"]["status"] == "completed"
    assert len(cp.statuses["e-vec"]["result"]["embedding"]) == get_config("llama-tiny").hidden_size
    bad = cp.statuses["e-bad"]
    assert bad["status"] == "failed" and "InputError" in bad["error"] and "bogus" in bad["error"]
    # the SDK's backpressure retry keys on the class name in the error
    assert cp.statuses["e-full"]["status"] == "failed"
    assert "QueueFullError" in cp.statuses["e-full"]["error"]


def test_heartbeats_reregister_degrade_and_stop(weights):
    cp, server, backend = _stand_in_node(weights, heartbeat_interval=0.05)
    port = server.start()
    try:
        spec = cp.specs[0]
        assert spec["node_id"] == "m1" and spec["kind"] == "model"
        assert spec["metadata"] == {"model": "llama-tiny", "modalities": ["text"],
                                    "role": "mixed", "channel": True}
        assert spec["base_url"] == f"http://127.0.0.1:{port}"
        assert cp.wait(lambda: len(cp.heartbeats) >= 2, 30)
        stats = cp.heartbeats[-1][2]["stats"]
        assert set(chip_smoke.HEARTBEAT_KEYS) <= set(stats)
        assert set(backend.engine.stats) <= set(stats)
        with cp.cv:
            cp.nodes.clear()  # the control plane restarted: the next beat gets 404
        assert cp.wait(lambda: len(cp.specs) == 2, 30), "no re-registration after a 404"
        assert server.connection_state == "connected"
        cp.stop()  # the link goes down: three failed beats make the node degraded
        for _ in range(600):
            if server.connection_state == "degraded":
                break
            time.sleep(0.01)
        assert server.connection_state == "degraded"
        assert _call(port, "/health")[1]["control_plane"] == "degraded"
    finally:
        server.stop()
    assert not any(t.name == "heartbeat" and t.is_alive() for t in threading.enumerate())


def test_stop_says_goodbye(weights):
    cp, server, _ = _stand_in_node(weights, heartbeat_interval=0.05)
    server.start()
    try:
        assert cp.wait(lambda: len(cp.heartbeats) >= 1, 30)
    finally:
        server.stop()
        cp.stop()
    assert cp.heartbeats[-1][2] == {"status": "stopping"}
    assert cp.deleted == ["m1"] and not cp.nodes
    assert not any(t.name == "heartbeat" and t.is_alive() for t in threading.enumerate())


def test_failed_registration_stops_the_node(weights):
    server, backend = build_model_node("llama-tiny", ecfg=EngineConfig(**ECFG), device="cpu",
                                       params=weights[2], control_plane="http://127.0.0.1:9")
    with pytest.raises(OSError):
        server.start()
    assert backend._thread is None and server._httpd is None


def test_smoke_api_phase_rehearses_on_cpu(weights, monkeypatch):
    """``chip_smoke.phase_api`` end to end on the CPU at llama-tiny size:
    the SDK payload and messages, truncation, the SSE stream, embed (also
    during a live decode, its batch in several chunks as on the card), and
    registration, heartbeats, a tracked request and the goodbye against the
    stand-in control plane."""
    monkeypatch.setattr(model_node, "EMBED_CHUNK_TOKENS", 200)
    results = {}
    chip_smoke.phase_api(results, {"params": weights[2], "cfg": get_config("llama-tiny")}, 0,
                         device="cpu", model_name="llama-tiny", new=6, live_new=48,
                         embed_lens=(10, 20, 33, 50, 64, 80, 100, 120),
                         prompts=(30, 20, 40, 50, 60), num_pages=96, max_pages_per_seq=8,
                         heartbeat_interval=0.1)
    api = results["api"]
    assert api["b"]["truncated_prompt_tokens"] == 200 + 6
    assert api["heartbeats"] >= 2 and api["embed_cosine_min"] > 0.999999
    assert api["d"]["forwards"] == [(1, 60), (4, 50), (2, 80), (1, 100), (1, 120)]
    assert api["embed_cosine_chunked_min"] > 0.999999


# -- C2: stop() drains --------------------------------------------------------


def _jax_draining_message(weights) -> str:
    """What the JAX node's admission raises while it drains."""
    jcfg, tree, _ = weights

    async def main():
        b = jax_node.ModelBackend(tree, jcfg, jax_node.EngineConfig(**ECFG),
                                  tokenizer=jax_node.ByteTokenizer(V))
        b._draining = True
        with pytest.raises(jax_node.NodeDrainingError) as e:
            b.submit_stream(prompt="late")
        return str(e.value)

    return asyncio.run(main())


def _frames_until_terminal(resp) -> list[dict]:
    frames = []
    for line in resp:
        if line.startswith(b"data: "):
            frames.append(json.loads(line[6:]))
            if frames[-1]["finished"]:
                break
    return frames


def test_stop_drains_open_streams_and_refuses_new_work(weights, monkeypatch):
    """C2: an SSE stream and a channel execution are open when ``stop()``
    is called. Requests during the drain get the JAX node's 503; both open
    ones end with a terminal frame (``deadline_exceeded`` at the grace);
    ``stop`` returns within the grace plus 10 s with the engine empty and
    its offload worker, the channel's threads and the heartbeat gone."""
    from agentfield_tpu_torch.serving import websocket as wsm

    want_msg = _jax_draining_message(weights)
    server, backend = build_model_node(
        "llama-tiny", ecfg=EngineConfig(**ECFG, host_cache_bytes=1 << 20), device="cpu",
        params=weights[2])
    port = server.start()
    step = backend.engine.step

    def slow_step():  # 50 tokens take longer than the grace
        time.sleep(0.05)
        return step()

    monkeypatch.setattr(backend.engine, "step", slow_step)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    ws = wsm.connect("127.0.0.1", port, "/channel")
    try:
        conn.request("POST", "/generate/stream",
                     json.dumps({"prompt": "drain me", "max_new_tokens": 50}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        ws.send_text(json.dumps({"kind": "submit", "exec_id": "c1", "target": "generate",
                                 "headers": {}, "stream": True,
                                 "input": {"prompt": "drain me too", "max_new_tokens": 50}}))
        chan = []
        while not any(f.get("kind") == "token" for f in chan):
            chan.append(json.loads(ws.recv()[1]))
        out: dict = {}
        t0 = time.monotonic()
        stopper = threading.Thread(target=lambda: out.update(summary=server.stop(grace_s=1.0)))
        stopper.start()
        for _ in range(500):
            if backend._draining:
                break
            time.sleep(0.002)
        status, doc = _call(port, "/reasoners/generate", {"input": {"prompt": "late"}})
        assert status == 503 and doc["error"] == repr(model_node.NodeDrainingError(want_msg))
        late = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        late.request("POST", "/generate/stream", json.dumps({"prompt": "late"}),
                     {"Content-Type": "application/json"})
        r = late.getresponse()
        assert r.status == 503 and json.loads(r.read()) == {"error": want_msg}
        late.close()
        frames = _frames_until_terminal(resp)
        assert frames[-1]["finish_reason"] == "deadline_exceeded"
        assert sum(f["finished"] for f in frames) == 1
        while (msg := ws.recv()) is not None:
            chan.append(json.loads(msg[1]))
        stopper.join(30)
        assert not stopper.is_alive() and time.monotonic() - t0 < 1.0 + 10
    finally:
        conn.close()
        ws.release()
    terms = [f for f in chan if f.get("kind") == "terminal"]
    assert len(terms) == 1 and terms[0]["status"] == "completed"
    assert terms[0]["result"]["finish_reason"] == "deadline_exceeded"
    assert out["summary"]["deadline_outed"] >= 2 and out["summary"]["drained"]
    assert not backend.engine.has_work()
    # this node's threads are gone: drive loop, HTTP, offload worker, channel
    assert backend._thread is None and server._thread is None and server._httpd is None
    offload = backend.engine.allocator._offload_thread
    assert offload is None or not offload.is_alive()
    assert not any(t.name.startswith("channel-") and t.is_alive()
                   for t in threading.enumerate())


def _small_send_buffer(sock: socket.socket) -> None:
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)


def _stalled_reader(server, port: int, transport: str) -> socket.socket:
    """A client that opens 240-token streams over ``transport`` (four
    channel executions, or one SSE stream) and never reads: its receive
    buffer, and the node's send buffer, hold a few KiB."""
    from agentfield_tpu_torch.serving import websocket as wsm

    sock = socket.socket()
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
    sock.connect(("127.0.0.1", port))
    body = {"max_new_tokens": 240}
    if transport == "sse":
        raw = json.dumps({"prompt": "never read", **body}).encode()
        sock.sendall(b"POST /generate/stream HTTP/1.1\r\nHost: x\r\nContent-Type: "
                     b"application/json\r\nContent-Length: %d\r\n\r\n" % len(raw) + raw)
        return sock
    sock.sendall(b"GET /channel HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
                 b"Connection: Upgrade\r\nSec-WebSocket-Key: dGhlIHNhbXBsZSBub25jZQ==\r\n"
                 b"Sec-WebSocket-Version: 13\r\n\r\n")
    t0 = time.monotonic()
    while not server.channel._conns:
        assert time.monotonic() - t0 < 30, "the channel never opened"
        time.sleep(0.005)
    for ws in list(server.channel._conns):
        _small_send_buffer(ws.sock)
    for i in range(4):
        frame = {"kind": "submit", "exec_id": f"s{i}", "target": "generate", "headers": {},
                 "stream": True, "input": {"prompt": f"never read {i}", **body}}
        sock.sendall(wsm.encode_frame(wsm.OP_TEXT, json.dumps(frame).encode(), True, b"abcd"))
    return sock


@pytest.mark.parametrize("transport", ["channel", "sse"])
def test_stop_is_bounded_when_a_reader_stops_reading(weights, monkeypatch, transport):
    """A gateway (or SSE client) that stops reading mid-stream, frozen with
    its buffers full: the node's sends block. ``stop(grace_s=1)`` still
    returns within the grace plus 10 s, the engine empty and the channel's
    threads gone."""
    set_timeout = model_node.set_send_timeout

    def small_buffer(sock, seconds):  # the SSE connection's send buffer
        _small_send_buffer(sock)
        set_timeout(sock, seconds)

    monkeypatch.setattr(model_node, "set_send_timeout", small_buffer)
    ecfg = dict(ECFG, num_pages=160, max_pages_per_seq=32)
    server, backend = build_model_node("llama-tiny", ecfg=EngineConfig(**ecfg), device="cpu",
                                       params=weights[2])
    port = server.start()
    sock = _stalled_reader(server, port, transport)
    try:
        # the writer is stuck: its request's events pile up unread
        t0 = time.monotonic()
        while not any(q.qsize() >= 20 for q in list(backend._streams.values())):
            assert time.monotonic() - t0 < 60, "the stream's writer never stalled"
            time.sleep(0.01)
        t0 = time.monotonic()
        out: dict = {}
        stopper = threading.Thread(target=lambda: out.update(summary=server.stop(grace_s=1.0)))
        stopper.start()
        stopper.join(1.0 + 10 + 20)
        assert not stopper.is_alive() and time.monotonic() - t0 < 1.0 + 10
    finally:
        sock.close()
    assert out["summary"]["drained"] and not backend.engine.has_work()
    assert backend._thread is None and server._httpd is None and not backend._streams
    assert not server._tracked  # the SSE writer was cut, not left blocked
    assert not any(t.name.startswith("channel-") and t.is_alive()
                   for t in threading.enumerate())


def test_backend_stop_leaves_no_caller_waiting(weights, monkeypatch):
    """``ModelBackend.stop`` without a drain, as the JAX backend's: a
    waiting ``generate`` fails, an open stream gets a terminal event."""
    backend = model_node.ModelBackend(weights[2], get_config("llama-tiny"), EngineConfig(**ECFG),
                                      device="cpu")
    backend.start()
    step = backend.engine.step

    def slow_step():
        time.sleep(0.05)
        return step()

    monkeypatch.setattr(backend.engine, "step", slow_step)
    errors: list = []

    def waiter():
        try:
            backend.generate(tokens=[1, 2, 3], max_new_tokens=50)
        except RuntimeError as e:
            errors.append(e)

    th = threading.Thread(target=waiter)
    th.start()
    rid, q, _ = backend.submit_stream(tokens=[4, 5, 6], max_new_tokens=50)
    for _ in range(500):
        if backend.engine.num_active == 2:
            break
        time.sleep(0.01)
    backend.stop()
    th.join(10)
    assert not th.is_alive() and [str(e) for e in errors] == ["model node stopped"]
    evs = [q.get(timeout=10)]
    while not evs[-1].finished:
        evs.append(q.get(timeout=10))
    assert evs[-1].finish_reason == "error: model node stopped" and evs[-1].token == -1
    backend.stop()  # idempotent


def _jax_debug_routes(weights) -> dict:
    """The JAX node's ``/debug/flight`` body and its ``/profile`` refusals,
    after one request."""
    from aiohttp.test_utils import TestClient, TestServer

    jcfg, tree, _ = weights

    async def main():
        agent, backend = jax_node.build_model_node(
            model="llama-tiny", params=tree, ecfg=jax_node.EngineConfig(**ECFG))
        backend.cfg = jcfg
        await backend.start()
        client = TestClient(TestServer(agent._build_app()))
        await client.start_server()
        out = {}
        try:
            async with client.post("/reasoners/generate", json={
                    "input": {"prompt": "flight", "max_new_tokens": 4}}) as r:
                assert r.status == 200
            async with client.get("/debug/flight?last=2") as r:
                out["flight"] = (r.status, await r.json())
            for action in ("stop", "nope"):
                async with client.post(f"/profile/{action}") as r:
                    out[action] = (r.status, await r.json())
        finally:
            await client.close()
            await backend.stop()
        return out

    return asyncio.run(main())


def test_debug_flight_and_profile_match_jax(weights, node, tmp_path):
    """``GET /debug/flight`` has the JAX node's keys and rows; ``/profile``
    answers the JAX node's statuses and bodies, and a capture around a
    request writes a Chrome trace holding the engine thread's ops."""
    port, backend = node
    want = _jax_debug_routes(weights)
    assert _call(port, "/reasoners/generate",
                 {"input": {"prompt": "flight", "max_new_tokens": 4}})[0] == 200
    status, doc = _call(port, "/debug/flight?last=2")
    j_status, j_doc = want["flight"]
    assert status == j_status == 200 and set(doc) == set(j_doc)
    assert len(doc["ticks"]) == len(j_doc["ticks"]) == 2
    assert [set(r) for r in doc["ticks"]] == [set(r) for r in j_doc["ticks"]]
    assert doc["max_ticks"] == j_doc["max_ticks"] and doc["ticks_recorded"] > 2
    assert len(_call(port, "/debug/flight")[1]["ticks"]) == doc["ticks_recorded"]
    for action in ("stop", "nope"):
        assert _call(port, f"/profile/{action}", {}) == want[action], action
    assert _call(port, "/profile/start", {"dir": str(tmp_path)}) == (
        200, {"tracing": True, "dir": str(tmp_path)})
    assert _call(port, "/profile/start", {"dir": str(tmp_path)}) == (
        409, {"error": "trace already active"})
    assert _call(port, "/reasoners/generate",
                 {"input": {"prompt": "profiled", "max_new_tokens": 4}})[0] == 200
    status, doc = _call(port, "/profile/stop", {})
    assert status == 200 and doc["tracing"] is False and doc["dir"] == str(tmp_path)
    with open(doc["file"]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names), sorted(names)[:20]
    assert _call(port, "/profile/stop", {}) == want["stop"]
