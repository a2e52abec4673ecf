"""The port's model node over HTTP, on the CPU: the tokens it answers equal
the JAX package's ``ModelBackend.generate`` on the same carried weights."""

from __future__ import annotations

import asyncio
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from agentfield_tpu.models import configs as jax_configs
from agentfield_tpu.models import llama as jax_llama
from agentfield_tpu.serving import model_node as jax_node
from agentfield_tpu_torch.models.configs import get_config
from agentfield_tpu_torch.models.convert import params_from_numpy
from agentfield_tpu_torch.serving.engine import EngineConfig
from agentfield_tpu_torch.serving.model_node import build_model_node
from agentfield_tpu_torch.serving.tokenizer import ByteTokenizer

ECFG = dict(max_batch=4, page_size=8, num_pages=64, max_pages_per_seq=8, prefill_chunk=16)
PROMPTS = [[5, 17, 300, 2, 9], list(range(40, 60)), [77]]


def _call(port: int, path: str, body: dict | None = None) -> tuple[int, dict]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
        method="GET" if body is None else "POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jax_configs.get_config("llama-tiny"), dtype="float32")
    tree = jax.tree.map(np.asarray, jax_llama.init_params(jcfg, jax.random.PRNGKey(1)))
    return jcfg, tree


@pytest.fixture(scope="module")
def node(weights):
    _, tree = weights
    params = params_from_numpy(tree, get_config("llama-tiny"), device="cpu")
    server, backend = build_model_node(
        "llama-tiny", ecfg=EngineConfig(**ECFG), device="cpu", params=params
    )
    port = server.start(port=0)
    yield port, backend
    server.stop()


def _jax_tokens(weights) -> list[list[int]]:
    jcfg, tree = weights

    async def main():
        backend = jax_node.ModelBackend(
            tree, jcfg, jax_node.EngineConfig(**ECFG),
            tokenizer=jax_node.ByteTokenizer(jcfg.vocab_size),
        )
        await backend.start()
        try:
            return [
                (await backend.generate(tokens=p, max_new_tokens=8))["tokens"] for p in PROMPTS
            ]
        finally:
            await backend.stop()

    return asyncio.run(main())


def test_http_generate_matches_jax_backend(weights, node):
    port, _ = node
    want = _jax_tokens(weights)
    for prompt, w in zip(PROMPTS, want):
        status, doc = _call(port, "/reasoners/generate", {"input": {"tokens": prompt, "max_new_tokens": 8}})
        assert status == 200, doc
        res = doc["result"]
        assert res["tokens"] == w
        assert res["finish_reason"] == "length" and res["model"] == "llama-tiny"
        assert len(res["logprobs"]) == 8 and all(np.isfinite(res["logprobs"]))
        assert isinstance(res["text"], str)


def test_http_concurrent_requests_all_answered(node):
    port, backend = node
    out: dict[int, tuple[int, dict]] = {}

    def go(i):
        out[i] = _call(port, "/reasoners/generate",
                       {"input": {"prompt": f"request number {i}", "max_new_tokens": 3}})

    ths = [threading.Thread(target=go, args=(i,)) for i in range(6)]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    assert sorted(out) == list(range(6))
    assert all(s == 200 and len(d["result"]["tokens"]) == 3 for s, d in out.values())
    assert backend.engine.stats["requests_finished"] >= 6


def test_health_reasoners_and_errors(node):
    port, _ = node
    # the JAX SDK agent's /health: the control-plane link state beside the id
    assert _call(port, "/health") == (200, {"status": "ok", "node_id": "model",
                                            "control_plane": "connected"})
    status, doc = _call(port, "/reasoners")
    assert status == 200 and doc["reasoners"][0]["id"] == "generate"
    assert "tokens" in doc["reasoners"][0]["input_schema"]["properties"]
    assert _call(port, "/nope")[0] == 404
    assert _call(port, "/reasoners/generate", {"input": {"bogus": 1}})[0] == 422
    assert _call(port, "/reasoners/generate", {"input": {}})[0] == 422  # no prompt/tokens
    status, doc = _call(port, "/reasoners/generate",
                        {"input": {"tokens": [1] * 60, "max_new_tokens": 10}})
    assert status == 422 and "RequestTooLong" in doc["error"]


def test_session_turn_reuses_cached_pages(node):
    port, backend = node
    hits = backend.engine.stats["prefix_cache_hits"]
    p1 = list(range(100, 112))
    _, d1 = _call(port, "/reasoners/generate",
                  {"input": {"tokens": p1, "max_new_tokens": 4, "session_id": "t"}})
    p2 = p1 + d1["result"]["tokens"] + [9, 9]
    status, d2 = _call(port, "/reasoners/generate",
                       {"input": {"tokens": p2, "max_new_tokens": 4, "session_id": "t"}})
    assert status == 200 and len(d2["result"]["tokens"]) == 4
    assert backend.engine.stats["prefix_cache_hits"] == hits + 1


def test_failed_step_fails_waiters_and_later_requests(weights):
    """An engine step that raises fails the request in flight with the real
    error and every later request at once (none may hang)."""
    _, tree = weights
    params = params_from_numpy(tree, get_config("llama-tiny"), device="cpu")
    _, backend = build_model_node("llama-tiny", ecfg=EngineConfig(**ECFG), device="cpu", params=params)

    def boom():
        raise ValueError("injected step fault")

    backend.engine.step = boom
    backend.start()
    try:
        with pytest.raises(RuntimeError, match="injected step fault"):
            backend.generate(tokens=[1, 2, 3], max_new_tokens=2, timeout=30)
        with pytest.raises(RuntimeError, match="failed step"):
            backend.generate(tokens=[4, 5], max_new_tokens=2, timeout=30)
    finally:
        backend.stop()


SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"},
                                           "mode": {"enum": ["fast", "slow"]}},
          "required": ["ok", "mode"]}


@pytest.fixture(scope="module")
def schema_node(weights):
    _, tree = weights
    params = params_from_numpy(tree, get_config("llama-tiny"), device="cpu")
    server, backend = build_model_node(
        "llama-tiny", ecfg=EngineConfig(**ECFG, grammar_slots=64, decode_buckets=(2,)),
        device="cpu", params=params,
    )
    port = server.start(port=0)
    yield port, backend
    server.stop()


def test_http_response_schema_matches_jax_backend(weights, schema_node):
    """``response_schema`` over HTTP: the answer is a value of the schema
    (the copied ``match_bytes`` accepts its bytes), ends on the tokenizer's
    eos id, and has the JAX node's tokens on the same weights."""
    from agentfield_tpu_torch.serving.grammar import match_bytes

    port, backend = schema_node
    jcfg, tree = weights
    prompt = [5, 17, 300, 2, 9]

    async def jax_answer():
        jb = jax_node.ModelBackend(
            tree, jcfg, jax_node.EngineConfig(**ECFG, grammar_slots=64, decode_buckets=(2,)),
            tokenizer=jax_node.ByteTokenizer(jcfg.vocab_size),
        )
        await jb.start()
        try:
            return await jb.generate(tokens=prompt, max_new_tokens=40, response_schema=SCHEMA)
        finally:
            await jb.stop()

    want = asyncio.run(jax_answer())
    status, doc = _call(port, "/reasoners/generate",
                        {"input": {"tokens": prompt, "max_new_tokens": 40, "response_schema": SCHEMA}})
    assert status == 200, doc
    res = doc["result"]
    assert res["tokens"] == want["tokens"] and res["finish_reason"] == want["finish_reason"] == "stop"
    g = backend._grammar_for(SCHEMA)
    assert match_bytes(g.trans, g.accept, bytes(res["tokens"]))  # byte ids: token b is byte b
    assert json.loads(res["text"])["mode"] in ("fast", "slow")
    # the same schema (keys in another order) shares one compiled grammar
    assert backend._grammar_for(dict(reversed(list(SCHEMA.items())))) is g
    assert backend.engine.grammar_bank_stats()["grammar_bank_grammars"] == 1


def test_http_response_schema_errors(weights, schema_node):
    port, _ = schema_node
    bad = {"type": "frobnicate"}
    assert _call(port, "/reasoners/generate",
                 {"input": {"tokens": [1, 2], "response_schema": bad}})[0] == 400
    assert _call(port, "/reasoners/generate",
                 {"input": {"tokens": [1, 2], "response_schema": [1]}})[0] == 400
    # no stop id and a tokenizer without an eos id: 400, nothing submitted
    _, tree = weights
    tok = ByteTokenizer(get_config("llama-tiny").vocab_size)
    tok.eos_token_id = None
    server, backend = build_model_node(
        "llama-tiny", ecfg=EngineConfig(**ECFG, grammar_slots=64), device="cpu",
        params=params_from_numpy(tree, get_config("llama-tiny"), device="cpu"), tokenizer=tok,
    )
    port2 = server.start(port=0)
    try:
        status, doc = _call(port2, "/reasoners/generate",
                            {"input": {"tokens": [1, 2], "response_schema": SCHEMA}})
        assert status == 400 and "eos_token_id" in doc["error"]
        assert backend.engine.stats["requests_finished"] == 0 and not backend.engine.pending
    finally:
        server.stop()


def test_node_engine_defaults_match_the_jax_node():
    """The node builds its engine as the JAX node does: a grammar bank of
    256 rows and the pipelined decode tick."""
    _, backend = build_model_node("llama-tiny", device="cpu")
    ecfg = backend.engine.ecfg
    assert ecfg.grammar_slots == 256 and ecfg.async_decode and ecfg.decode_buckets is None


def test_http_deadline_and_priority_reach_the_engine(weights, node):
    """``deadline_s`` and ``priority`` in the body of ``POST
    /reasoners/generate`` ride into the engine's request; a non-integer
    priority answers 422, as the JAX node rejects it with a ValueError."""
    port, backend = node
    seen = []
    submit = backend.engine.submit

    def spy(req):
        seen.append(req)
        return submit(req)

    backend.engine.submit = spy
    try:
        status, doc = _call(port, "/reasoners/generate", {"input": {
            "tokens": [3, 4, 5], "max_new_tokens": 2, "deadline_s": 30.0, "priority": 2}})
        assert status == 200 and doc["result"]["finish_reason"] == "length"
        assert (seen[-1].deadline_s, seen[-1].priority) == (30.0, 2)
        for bad in ("high", True, 1.5):
            status, doc = _call(port, "/reasoners/generate",
                                {"input": {"tokens": [3], "priority": bad}})
            assert status == 422 and "priority" in doc["error"]
        status, doc = _call(port, "/reasoners/generate",
                            {"input": {"tokens": [3], "deadline_s": -1}})
        assert status == 422 and "deadline_s" in doc["error"]
        assert not backend.engine.pending and not backend._streams
    finally:
        backend.engine.submit = submit
    _, tree = weights
    jcfg = weights[0]

    async def jax_rejects():
        jb = jax_node.ModelBackend(tree, jcfg, jax_node.EngineConfig(**ECFG),
                                   tokenizer=jax_node.ByteTokenizer(jcfg.vocab_size))
        for bad in ("high", True, 1.5):
            with pytest.raises(ValueError, match="priority"):
                await jb.generate(tokens=[3], max_new_tokens=1, priority=bad)

    asyncio.run(jax_rejects())


@pytest.fixture
def slow_node(weights):
    """A node whose engine takes at least 5 ms a step, so a 50-token answer
    outlasts the short deadlines and grace periods below; a step also waits
    for ``backend.gate`` (open unless a test closes it)."""
    import time

    _, tree = weights
    params = params_from_numpy(tree, get_config("llama-tiny"), device="cpu")
    server, backend = build_model_node("llama-tiny", ecfg=EngineConfig(**ECFG), device="cpu",
                                       params=params)
    step = backend.engine.step
    backend.gate = threading.Event()
    backend.gate.set()

    def slow():
        assert backend.gate.wait(timeout=30)
        time.sleep(0.005)
        return step()

    backend.engine.step = slow
    port = server.start(port=0)
    yield port, backend
    backend.gate.set()
    server.stop()


def test_http_deadline_exceeded_is_the_finish_reason(slow_node):
    port, backend = slow_node
    status, doc = _call(port, "/reasoners/generate", {"input": {
        "tokens": [7, 8, 9], "max_new_tokens": 50, "deadline_s": 0.05}})
    assert status == 200 and doc["result"]["finish_reason"] == "deadline_exceeded"
    assert len(doc["result"]["tokens"]) < 50 and -1 not in doc["result"]["tokens"]
    assert backend.engine.stats["deadline_exceeded"] == 1
    assert backend.engine.allocator.free_pages == ECFG["num_pages"] - 1


def test_waiter_timeout_cancels_its_request(slow_node):
    import time

    _, backend = slow_node
    backend.gate.clear()  # the engine takes no step until the waiter gave up
    with pytest.raises(TimeoutError):
        backend.generate(tokens=[1, 2, 3], max_new_tokens=50, timeout=0.05)
    backend.gate.set()
    t0 = time.monotonic()
    while backend.engine.has_work() and time.monotonic() - t0 < 10:
        time.sleep(0.01)
    assert backend.engine.stats["requests_cancelled"] == 1
    assert backend.engine.stats["requests_finished"] == 0
    assert backend.engine.allocator.free_pages == ECFG["num_pages"] - 1


def test_drain_ends_in_flight_work(slow_node):
    """``drain()``: in-flight work is deadline-outed at the grace cutoff (its
    caller gets an answer with the partial tokens), new work answers 503,
    and a second drain finds nothing to do."""
    import time

    port, backend = slow_node
    out = {}
    th = threading.Thread(target=lambda: out.update(
        r=_call(port, "/reasoners/generate", {"input": {"tokens": [1, 2, 3], "max_new_tokens": 50}})))
    th.start()
    t0 = time.monotonic()
    while not backend.engine.has_work() and time.monotonic() - t0 < 10:
        time.sleep(0.005)
    summary = backend.drain(grace_s=0.0)
    assert summary["drained"] and summary["deadline_outed"] == 1, summary
    th.join(timeout=30)
    status, doc = out["r"]
    assert status == 200 and doc["result"]["finish_reason"] == "deadline_exceeded"
    status, doc = _call(port, "/reasoners/generate", {"input": {"tokens": [1], "max_new_tokens": 1}})
    assert status == 503 and "draining" in doc["error"]
    again = backend.drain(grace_s=0.01)
    assert again["drained"] and again["deadline_outed"] == 0
    assert backend.engine.stats["drains_total"] == 1 and backend.engine.stats["drain_cancelled"] == 1
