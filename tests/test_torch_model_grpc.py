"""The model node's gRPC ``Generate`` on the port (``serving/model_node.py``'s
``ModelGrpcService`` on ``control_plane/grpc_h2.py``) against the JAX
node's (grpcio, protoc's messages), on the CPU, llama-tiny in float32 on the
same carried weights:

- ``tests/test_model_grpc.py``'s script through both nodes, each over its
  own gRPC: the same tokens call by call, the session's second call a
  prefix hit on both, a request with no prompt and no tokens INTERNAL on
  both and the server still serving;
- the interop matrix: grpcio's client (the JAX ``model_grpc_generate``) on
  the port's server, the port's client on the JAX server: the same tokens;
- the same request bytes decode to the same ``generate`` kwargs on both
  (``temperature=0.7`` as the float32 0.699999988079071, an unset
  ``top_p`` absent so the server's 1.0 holds);
- the status table: a malformed ``response_schema_json`` and an over-long
  prompt INVALID_ARGUMENT, a full queue RESOURCE_EXHAUSTED, on both nodes;
- a PNG from the port's own codec through ``images`` (a vision node): the
  tokens of the same image over HTTP;
- grpcio's client with a short deadline: DEADLINE_EXCEEDED, after which
  the engine holds no request and has all its free pages back;
- ``ModelNodeServer.stop`` stops the gRPC server with its drain, leaving
  no thread of the transport.
"""

from __future__ import annotations

import asyncio
import base64
import dataclasses
import threading

import grpc
import jax
import numpy as np
import pytest
import torch

import chip_smoke
from agentfield_tpu.control_plane.proto import modelnode_pb2 as j_pb
from agentfield_tpu.models import configs as jax_configs
from agentfield_tpu.models import llama as jax_llama
from agentfield_tpu.serving import model_node as jax_node
from agentfield_tpu_torch.control_plane import grpc_h2 as h2
from agentfield_tpu_torch.control_plane.proto import modelnode_pb2 as t_pb
from agentfield_tpu_torch.models import media_codec
from agentfield_tpu_torch.models.configs import get_config
from agentfield_tpu_torch.models.convert import params_from_numpy
from agentfield_tpu_torch.serving import model_node
from agentfield_tpu_torch.serving.engine import EngineConfig, QueueFullError
from tests.helpers_cp import free_port

ECFG = dict(max_batch=2, page_size=8, num_pages=64, max_pages_per_seq=8)  # tests/test_model_grpc.py's
V = 512


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jax_configs.get_config("llama-tiny"), dtype="float32")
    tree = jax.tree.map(np.asarray, jax_llama.init_params(jcfg, jax.random.PRNGKey(5)))
    return jcfg, tree, params_from_numpy(tree, get_config("llama-tiny"), device="cpu")


class JaxGrpcNode:
    """The JAX node's backend on an event loop of its own, its gRPC server
    started from that loop (``start_model_grpc`` takes the running loop)."""

    def __init__(self, weights):
        jcfg, tree, _ = weights
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.port = free_port()

        async def boot():
            b = jax_node.ModelBackend(tree, jcfg, jax_node.EngineConfig(**ECFG),
                                      tokenizer=jax_node.ByteTokenizer(V), idle_sleep=0.001,
                                      model_name="llama-tiny")
            await b.start()
            return b, jax_node.start_model_grpc(b, self.port)

        self.backend, self.server = self.run(boot())

    def run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(120)

    def close(self):
        self.server.stop(0).wait()
        self.run(self.backend.stop())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        self.loop.close()


@pytest.fixture(scope="module")
def nodes(weights):
    jn = JaxGrpcNode(weights)
    server, backend = model_node.build_model_node(
        "llama-tiny", ecfg=EngineConfig(**ECFG), device="cpu", params=weights[2])
    port = server.start()
    gport = server.start_grpc(free_port())
    yield {"jax": jn, "port": (server, backend, port, gport)}
    server.stop(1)
    jn.close()
    assert [t for t in threading.enumerate() if t.name.startswith("grpc-h2")] == []


def _port_call(gport: int, body: dict, timeout: float = 60.0) -> dict:
    return model_node.model_grpc_generate(gport, body, timeout=timeout)


def _jax_call(gport: int, body: dict, timeout: float = 60.0) -> dict:
    return jax_node.model_grpc_generate(gport, body, timeout=timeout)


def _code(fn, *a) -> str:
    try:
        fn(*a)
    except (grpc.RpcError, h2.RpcError) as e:
        return e.code().name
    return "OK"


def test_round_trip_script_matches_jax(nodes):
    """tests/test_model_grpc.py::test_grpc_generate_round_trip on both
    nodes, each through its own package's client."""
    jn, (_, backend, _, gport) = nodes["jax"], nodes["port"]
    out = {}
    for side, call, port, eng in (("jax", _jax_call, jn.port, jn.backend.engine),
                                  ("port", _port_call, gport, backend.engine)):
        hits0 = eng.stats["prefix_cache_hits"]
        a = call(port, {"tokens": [3, 4, 5], "max_new_tokens": 4, "session_id": "g1"})
        assert len(a["tokens"]) == 4 and a["finish_reason"] == "length"
        b = call(port, {"tokens": [3, 4, 5] + a["tokens"] + [6], "max_new_tokens": 2,
                        "session_id": "g1"})
        assert len(b["tokens"]) == 2
        assert eng.stats["prefix_cache_hits"] == hits0 + 1, side
        bad = _code(call, port, {"max_new_tokens": 2})
        c = call(port, {"tokens": [9], "max_new_tokens": 1})
        assert len(c["tokens"]) == 1
        out[side] = (a, b, bad, c)
    ja, jb, jbad, jc = out["jax"]
    ta, tb, tbad, tc = out["port"]
    assert jbad == tbad == "INTERNAL"
    for j, t in ((ja, ta), (jb, tb), (jc, tc)):
        assert t["tokens"] == j["tokens"] and t["finish_reason"] == j["finish_reason"]
        assert t["model"] == j["model"] == "llama-tiny" and t["text"] == j["text"]
        np.testing.assert_allclose(t["logprobs"], j["logprobs"], rtol=0, atol=1e-4)


def test_interop_matrix(nodes):
    jn, (_, _, _, gport) = nodes["jax"], nodes["port"]
    body = {"tokens": [11, 12, 13, 14], "max_new_tokens": 5}
    want = _jax_call(jn.port, body)["tokens"]
    assert _jax_call(gport, body)["tokens"] == want  # grpcio client → port server
    assert _port_call(jn.port, body)["tokens"] == want  # port client → grpcio server
    assert _port_call(gport, body)["tokens"] == want


def test_same_request_bytes_same_kwargs():
    body = {"prompt": "hi", "tokens": [1, 2], "temperature": 0.7, "top_k": 5,
            "stop_token_ids": [7], "session_id": "s", "response_schema": {"type": "object"},
            "images": [{"b64": base64.b64encode(b"\x89PNG-ish").decode()}]}
    t_msg = model_node.model_grpc_request(body)
    j_msg = j_pb.GenerateRequest.FromString(t_msg.SerializeToString())
    jk = jax_node._grpc_request_to_kwargs(j_msg)
    tk = model_node._grpc_request_to_kwargs(t_pb.GenerateRequest.FromString(
        j_msg.SerializeToString()))
    assert tk == jk
    assert tk["temperature"] == 0.699999988079071 and "top_p" not in tk
    assert tk["images"] == [b"\x89PNG-ish"]


@pytest.mark.parametrize("case", ["bad_schema_json", "too_long", "queue_full"])
def test_status_table_as_jax(nodes, case, monkeypatch):
    jn, (_, backend, _, gport) = nodes["jax"], nodes["port"]
    if case == "bad_schema_json":
        msg = {"tokens": [1], "response_schema_json": "{not json"}
        raw = t_pb.GenerateRequest(**msg).SerializeToString()
    elif case == "too_long":
        raw = t_pb.GenerateRequest(tokens=list(range(1, 91)), max_new_tokens=4).SerializeToString()
    else:
        raw = t_pb.GenerateRequest(tokens=[1]).SerializeToString()

        def full(**kw):
            raise QueueFullError("queue full (test)")

        async def jfull(**kw):
            raise jax_node.QueueFullError("queue full (test)")

        monkeypatch.setattr(backend, "generate", full)
        monkeypatch.setattr(jn.backend, "generate", jfull)
    method = f"/{model_node.ModelGrpcService.SERVICE}/Generate"
    codes = []
    with grpc.insecure_channel(f"127.0.0.1:{jn.port}") as ch:
        codes.append(_code(ch.unary_unary(method), raw, 30))
    with h2.insecure_channel(f"127.0.0.1:{gport}") as ch:
        codes.append(_code(lambda r, t: ch.unary_unary(method)(r, timeout=t), raw, 30))
    want = {"bad_schema_json": "INVALID_ARGUMENT", "too_long": "INVALID_ARGUMENT",
            "queue_full": "RESOURCE_EXHAUSTED"}[case]
    assert codes == [want, want]


def test_image_bytes_through_grpc(weights):
    """tests/test_model_grpc.py::test_grpc_generate_with_image_bytes on the
    port: a PNG the port's codec wrote, raw over gRPC, as over HTTP."""
    server, backend = model_node.build_model_node(
        "llama-tiny", ecfg=EngineConfig(**ECFG), device="cpu", params=weights[2],
        vision="vit-tiny")
    server.start()
    gport = server.start_grpc(free_port())
    try:
        img = np.zeros((8, 8, 3), np.uint8)
        img[...] = (10, 200, 30)
        png = base64.b64encode(media_codec.encode_png(img)).decode()
        body = {"prompt": "see <image> now", "images": [{"b64": png}], "max_new_tokens": 3}
        res = _port_call(gport, body)
        assert len(res["tokens"]) == 3 and res["model"] == "llama-tiny"
        assert res["tokens"] == backend.generate(**body)["tokens"]
        assert _jax_call(gport, body)["tokens"] == res["tokens"]  # grpcio's client too
    finally:
        server.stop(1)


def test_deadline_releases_the_engine_slot(nodes):
    _, backend, _, gport = nodes["port"]
    eng = backend.engine
    chip_smoke._wait_idle(backend)
    free0 = backend._on_engine_thread(lambda: eng.allocator.free_pages)
    req = t_pb.GenerateRequest(tokens=[5, 6, 7], max_new_tokens=58)
    with grpc.insecure_channel(f"127.0.0.1:{gport}") as ch:
        fn = ch.unary_unary(f"/{model_node.ModelGrpcService.SERVICE}/Generate",
                            request_serializer=t_pb.GenerateRequest.SerializeToString,
                            response_deserializer=j_pb.GenerateResponse.FromString)
        with pytest.raises(grpc.RpcError) as e:
            fn(req, timeout=0.03)
        assert e.value.code() == grpc.StatusCode.DEADLINE_EXCEEDED
        chip_smoke._wait_idle(backend, timeout=30)
        assert not backend._on_engine_thread(eng.has_work)
        assert backend._on_engine_thread(lambda: eng.allocator.free_pages) == free0
        ok = fn(t_pb.GenerateRequest(tokens=[5], max_new_tokens=2), timeout=30)
        assert len(ok.tokens) == 2


def test_stop_stops_grpc_with_the_drain(weights):
    before = set(threading.enumerate())
    server, _ = model_node.build_model_node(
        "llama-tiny", ecfg=EngineConfig(**ECFG), device="cpu", params=weights[2])
    server.start()
    gport = server.start_grpc(free_port())
    assert len(_port_call(gport, {"tokens": [1, 2], "max_new_tokens": 2})["tokens"]) == 2
    summary = server.stop(1)
    assert summary["drained"] is True
    with pytest.raises(h2.RpcError) as e:
        _port_call(gport, {"tokens": [1], "max_new_tokens": 1}, timeout=5)
    assert e.value.code() is h2.StatusCode.UNAVAILABLE
    assert [t for t in threading.enumerate()
            if t.name.startswith("grpc-h2") and t not in before] == []
