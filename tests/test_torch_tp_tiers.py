"""The host KV tier, the cluster tier, two-phase handoff and media prompts
on the port's tensor-parallel engine and node, on the CPU: rank 0 in the
test's process, rank 1 spawned (``parallel.worker``), gloo between them,
float32 llama-tiny weights carried from the JAX package
(``tests/helpers_torch_tp.NpzWeights``: each rank cuts its own slice). The
JAX side is the JAX engine or node under ``make_mesh({"model": 2})``.

- the host tier, for a plain (float32), an int8 and an fp8 pool: the tier
  script of ``tests/test_torch_kv_offload.py`` (expiry demotes, the resume
  restores; a second expiry whose restore an injected ``kv.restore_fail``
  refuses, degrading to a re-prefill; a third that restores again):
  greedy tokens, the ``kv_offload_*`` counters and ``free_pages`` equal to
  the JAX TP engine's, every rank's restored slice bit-equal to what that
  rank captured, ``page_payload_spec`` equal to the JAX TP engine's and the
  port's TP=1 engine's, ``prefix_sketch()`` equal to the JAX TP engine's;
- the cluster tier through the nodes' ``kv_fetch`` (the fetch function
  stubbed with the other node's ``kv_export_pages``): a TP=2 node's pages
  adopted by a TP=1 node and the reverse, greedy tokens equal to the JAX TP
  engine's, the wire's ``parts`` and ``segs`` equal on both nodes, the
  TP=2 export of a prompt within 1e-5 of the JAX mesh engine's as float32,
  and export -> adopt -> export bit-exact both ways;
- two-phase handoff from a TP=2 prefill node to a TP=1 decode node and the
  reverse: the live install (no prefill), tokens equal to the JAX nodes' on
  the same handoff (a JAX node under the mesh, a JAX node without) and to
  the JAX TP engine's;
- ``Request.mm_embeds`` on the TP=2 engine: tokens equal to the JAX TP
  engine's, the injected prefill's logits within ``LOGIT_TOL`` of the JAX
  forward on the mesh;
- ``build_model_node(tp=2, vision=, tts=, imagegen=)`` over HTTP against
  the JAX TP node (``ModelBackend(mesh=)``, the weights of the port's seed,
  the towers and heads carried from the JAX draw): a PNG prompt, a spoken
  answer and a rendered image, answers equal.

``LOGIT_TOL`` = 1e-4 (``tests/test_torch_tp_serving.py``). Every worker
must exit with code 0."""

from __future__ import annotations

import asyncio
import base64
import contextlib
import dataclasses
import io
import json
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentfield_tpu.control_plane import faults as jax_faults
from agentfield_tpu.models import configs as jax_configs
from agentfield_tpu.models import llama as jax_llama
from agentfield_tpu.parallel import mesh as jax_mesh
from agentfield_tpu.parallel import sharding as jax_sharding
from agentfield_tpu.serving import engine as jax_engine
from agentfield_tpu.serving import model_node as jax_node
from agentfield_tpu.serving.sampler import SamplingParams as JaxSampling
from agentfield_tpu_torch.models import llama
from agentfield_tpu_torch.models.configs import get_config
from agentfield_tpu_torch.models.convert import params_from_numpy
from agentfield_tpu_torch.parallel import worker as worker_mod
from agentfield_tpu_torch.parallel.worker import WorkerSpec, start_workers
from agentfield_tpu_torch.prefix_hash import page_chain_hashes
from agentfield_tpu_torch.serving import engine as port_engine
from agentfield_tpu_torch.serving import faults
from agentfield_tpu_torch.serving.engine import EngineConfig, InferenceEngine, Request
from agentfield_tpu_torch.serving.model_node import ModelBackend, build_model_node
from agentfield_tpu_torch.serving.sampler import SamplingParams
from tests import helpers_torch_mm as mm
from tests import helpers_torch_tp as ht

LOGIT_TOL = 1e-4
PS = 8
# one engine shape for every script, so the JAX engines share their
# compiled functions: the host tier on, room for a few 40-token prompts
ECFG = dict(max_batch=2, page_size=PS, num_pages=64, max_pages_per_seq=16,
            host_cache_bytes=64 << 20, session_ttl=60.0)
OFFLOAD_KEYS = ("kv_offload_demoted", "kv_offload_restored", "kv_offload_restore_fail",
                "kv_offload_demote_fail", "kv_offload_host_evicted", "prefix_index_hits",
                "sessions_evicted")
CFG = get_config("llama-tiny")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _ranks_yield_the_cpu():
    """The spawned ranks run at nice 10 (``tests/test_torch_tp_serving.py``)."""
    popen = worker_mod.subprocess.Popen
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(worker_mod.subprocess, "Popen",
                   lambda args, **kw: popen(["nice", "-n", "10", *args], **kw))
        yield


@pytest.fixture(autouse=True)
def _clear_injectors():
    yield
    jax_faults.install(None)
    faults.install(None)


@dataclasses.dataclass
class Weights:
    jcfg: object
    tree: dict
    path: str  # the tree as an .npz (each rank cuts its slice)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    jcfg = dataclasses.replace(jax_configs.get_config("llama-tiny"), dtype="float32")
    tree = jax.tree.map(np.asarray, jax_llama.init_params(jcfg, jax.random.PRNGKey(0)))
    path = str(tmp_path_factory.mktemp("tp_tiers") / "w.npz")
    ht.save_tree(tree, path)
    return Weights(jcfg, tree, path)


@contextlib.contextmanager
def tp2_engine(w: Weights, **over):
    """Rank 0's engine of a 2-rank gloo engine on ``ECFG | over``; the
    worker starts at once (the caller's JAX work overlaps its build) and
    must have exited with code 0 once the engine closes."""
    ecfg = EngineConfig(**(ECFG | over))
    weights = ht.NpzWeights(w.path, CFG)
    mesh = start_workers(2, WorkerSpec(CFG, ecfg, 0, weights, "gloo", "cpu", timeout_s=120,
                                       threads=1))
    workers = mesh.workers
    try:
        eng = InferenceEngine(weights(mesh)[0], CFG, ecfg, mesh=mesh)
    except BaseException:
        mesh.close()
        raise
    try:
        yield eng
    finally:
        eng.close()
    assert workers.exitcodes == [0]


def _jax_tp_engine(w: Weights, **over):
    return jax_engine.InferenceEngine(w.tree, w.jcfg, jax_engine.EngineConfig(**(ECFG | over)),
                                      mesh=jax_mesh.make_mesh({"model": 2}))


def _prompt(seed: int, n: int) -> list[int]:
    return np.random.default_rng(seed).integers(0, 512, n).tolist()


def _run(eng, rid, prompt, max_new=4, **kw):
    jax_side = isinstance(eng, jax_engine.InferenceEngine)
    mod, samp = (jax_engine, JaxSampling) if jax_side else (port_engine, SamplingParams)
    return eng.run_to_completion([mod.Request(id=rid, prompt=prompt,
                                              sampling=samp(max_new_tokens=max_new),
                                              **kw)])[rid]


def _observe(eng) -> dict:
    with eng._session_lock:
        return {"counters": {k: eng.stats[k] for k in OFFLOAD_KEYS},
                "free_pages": eng.allocator.free_pages,
                "host_pages": eng.allocator.host_pages}


def _rank_slices(eng, chains) -> dict[bytes, list[list[np.ndarray]]]:
    """Every rank's bytes of each indexed chain's device page: rank 0's
    own, then each worker's (``Workers.query``)."""
    with eng._session_lock:
        pages = [eng.allocator._by_hash[c].page for c in chains]
    mine = eng.page_kv_bytes(pages)
    theirs = eng.mesh.workers.query("page_kv_bytes", pages)
    return {c: [mine[i]] + [t[i] for t in theirs] for i, c in enumerate(chains)}


def _tier_script(eng, install, slices=None) -> dict:
    """``tests/test_torch_kv_offload.py``'s tier script on one engine:
    expiry demotes, the resume restores; a restore refused by
    ``kv.restore_fail`` re-prefills; the next expiry restores again.
    ``slices(chains)`` (the port's TP engine) reads every rank's bytes of
    the first turn's pages on the device before the expiry and after the
    resume restored them (under ``"slices"``, beside the result)."""
    t1 = _prompt(1, 16)
    out1 = _run(eng, "a", t1, session_id="conv")
    chains = page_chain_hashes(t1, PS)
    captured = slices(chains) if slices else None
    expired = eng.gc_sessions(at=time.time() + 120)
    assert eng.allocator.offload_drain(10.0)
    mid = _observe(eng)
    with eng._session_lock:
        demoted = [eng.allocator._by_hash[c].tier for c in chains]
    t2 = t1 + out1 + _prompt(2, 3)
    out2 = _run(eng, "b", t2, session_id="conv")
    restored = slices(chains) if slices else None
    eng.gc_sessions(at=time.time() + 240)
    assert eng.allocator.offload_drain(10.0)
    install({"kv.restore_fail": {"prob": 1.0, "times": 1}})
    t3 = t2 + out2 + _prompt(3, 3)
    out3 = _run(eng, "c", t3, session_id="conv")
    failed = _observe(eng)
    eng.gc_sessions(at=time.time() + 360)
    assert eng.allocator.offload_drain(10.0)
    t4 = t3 + out3 + _prompt(4, 3)
    out4 = _run(eng, "d", t4, session_id="conv")
    return {"out": (out1, out2, out3, out4), "expired": expired, "mid": mid, "failed": failed,
            "end": _observe(eng), "sketch": eng.prefix_sketch(), "demoted": demoted,
            "spec": eng.page_payload_spec()}, (captured, restored)


@pytest.mark.parametrize("mode", ["none", "int8", "fp8"])
def test_host_tier_under_tp_matches_jax(weights, mode):
    with tp2_engine(weights, kv_quant_dtype=mode) as eng:
        jeng = _jax_tp_engine(weights, kv_quant_dtype=mode)
        try:
            want, _ = _tier_script(jeng, lambda spec: jax_faults.install(
                jax_faults.FaultInjector(seed=5, spec=spec)))
        finally:
            jeng.close()
        got, (captured, restored) = _tier_script(
            eng, lambda spec: faults.install(faults.FaultInjector(seed=5, spec=spec)),
            slices=lambda chains: _rank_slices(eng, chains))
        # the worker holds a slice of exactly the captures rank 0 still
        # holds (its demoted pages) once an operation carried the releases
        eng.gc_sessions(at=time.time() + 480)
        assert eng.allocator.offload_drain(10.0)
        _run(eng, "flush", [1, 2, 3], max_new=1)
        held = eng.mesh.workers.query("rank_report")[0]["host_slices"]
        assert held == eng.allocator.host_pages > 0
    assert got["demoted"] == ["host", "host"]
    for c, ranks in restored.items():  # every rank's restore is its capture, bit for bit
        assert len(ranks) == 2
        for rank, (now, then) in enumerate(zip(ranks, captured[c])):
            for a, b in zip(now, then, strict=True):
                assert np.array_equal(a, b), (mode, rank)
    one = InferenceEngine(params_from_numpy(weights.tree, CFG, device="cpu"), CFG,
                          EngineConfig(**(ECFG | {"kv_quant_dtype": mode})))
    try:
        assert got["spec"] == one.page_payload_spec()
    finally:
        one.close()
    assert got == want
    assert got["mid"]["counters"]["kv_offload_demoted"] >= 2
    assert got["failed"]["counters"]["kv_offload_restore_fail"] == 1
    assert got["end"]["counters"]["kv_offload_restored"] > got["failed"]["counters"][
        "kv_offload_restored"] > 0


# ---------------------------------------------------------------------------
# the cluster tier and handoff: a TP=2 node and a TP=1 node


def _pages_for(pages: list) -> list[dict]:
    """An exporter's ``(meta, payload)`` list as a fetch returns it."""
    return [{**m, "data": data} for m, data in pages]


def _fetch_from(src: ModelBackend, log: list):
    def fetch(peer, chains_hex, timeout_s, **kw):
        pages = src.kv_export_pages(chains_hex, 8 << 20, **kw)
        log.append(pages)
        return _pages_for(pages)

    return fetch


@pytest.fixture(scope="module")
def fleet(weights):
    """A started TP=2 node backend and a TP=1 one on the same weights, and
    the JAX TP engine (``ECFG``) as their reference."""
    weights_fn = ht.NpzWeights(weights.path, CFG)
    ecfg = EngineConfig(**ECFG)
    mesh = start_workers(2, WorkerSpec(CFG, ecfg, 0, weights_fn, "gloo", "cpu", timeout_s=120,
                                       threads=1))
    workers = mesh.workers
    jeng = _jax_tp_engine(weights)
    try:
        tp2 = ModelBackend(weights_fn(mesh)[0], CFG, ecfg, device="cpu", idle_sleep=0.001,
                           mesh=mesh)
    except BaseException:
        mesh.close()
        raise
    tp1 = ModelBackend(params_from_numpy(weights.tree, CFG, device="cpu"), CFG, ecfg,
                       device="cpu", idle_sleep=0.001)
    tp2.start()
    tp1.start()
    try:
        yield {"tp2": tp2, "tp1": tp1, "jax": jeng}
    finally:
        for b in (tp2, tp1):
            b.stop()
            b.engine.close()
        jeng.close()
    assert workers.exitcodes == [0]


def _jax_f32(payload) -> np.ndarray:
    """A JAX export's page payload ((k, v) numpy) as one float32 vector in
    the wire's leaf order."""
    return np.concatenate([np.asarray(a, np.float32).ravel()
                           for a in jax.tree.leaves(payload)])


@pytest.mark.parametrize("first", ["tp2", "tp1"], ids=["tp2_to_tp1", "tp1_to_tp2"])
def test_cluster_pages_pass_between_tp_and_tp1_nodes(weights, fleet, first):
    """``first``'s pages of a 32-token prefix adopted by the other node
    through its ``kv_fetch``, then the adopter's own export of the same
    chains adopted back by ``first``: every hop restores (no prefill of the
    prefix), tokens equal the JAX TP engine's, and the bytes come back bit
    for bit."""
    src, dst = fleet[first], fleet["tp1" if first == "tp2" else "tp2"]
    seed = 20 if first == "tp2" else 30
    shared = _prompt(seed, 32)
    chains = [h.hex() for h in page_chain_hashes(shared, PS)]
    src.generate(tokens=shared + [1, 2], max_new_tokens=2)
    jeng = fleet["jax"]
    if first == "tp2":  # the sketch of the same index, after the same request
        _run(jeng, "warm", shared + [1, 2], max_new=2)
        assert src.engine.prefix_sketch() == jeng.prefix_sketch()
    hops = []
    for rnd, (a, b) in enumerate(((src, dst), (dst, src))):
        tail = _prompt(seed + 1 + rnd, 3)
        b._kv_fetch_fn = _fetch_from(a, hops)
        before = dict(b.engine.stats)
        if rnd == 1:  # b's own pages go first: the fetch must bring them back
            with b.engine._session_lock:
                for h in page_chain_hashes(shared, PS):
                    b.engine.allocator.forget(b.engine.allocator._by_hash[h].page)
        out = b.generate(tokens=shared + tail, max_new_tokens=6,
                         kv_peer={"node_id": "peer", "pages": 4, "page_size": PS})
        d = {k: b.engine.stats[k] - before.get(k, 0) for k in
             ("kv_fetch_pages_adopted_total", "kv_offload_restored", "prefill_tokens")}
        assert d == {"kv_fetch_pages_adopted_total": 4, "kv_offload_restored": 4,
                     "prefill_tokens": len(tail)}, (rnd, d)
        assert out["tokens"] == _run(jeng, f"ref{first}{rnd}", shared + tail, max_new=6)
    p0, p1 = hops
    assert [m for m, _ in p1] == [m for m, _ in p0]  # parts and segs: every head on both
    assert [c["chain"] for c, _ in p0] == chains
    assert [x for _, x in p1] == [x for _, x in p0]  # the round trip, bit for bit
    segs = p0[0][0]["segs"]
    assert sum(segs) == fleet["tp2"].engine.kv_page_bytes == len(p0[0][1])
    if first == "tp2":  # the TP export of the prompt against the JAX mesh engine's
        jpages = jeng.export_kv_pages([bytes.fromhex(c) for c in chains])
        for (_, data), (_, _, jp) in zip(p0, jpages, strict=True):
            got = np.frombuffer(data, np.float32)
            np.testing.assert_allclose(got, _jax_f32(jp), atol=1e-5, rtol=0)


def _jax_handoff(weights, prompt, prefill: str) -> list[int]:
    """The same two-phase handoff between JAX nodes (the ``tp2`` one under
    ``make_mesh({"model": 2})``), through the JAX decode node's
    ``kv_fetch`` stubbed with the prefill node's export: its tokens."""
    def node(tp):
        return jax_node.ModelBackend(weights.tree, weights.jcfg, jax_engine.EngineConfig(**ECFG),
                                     mesh=jax_mesh.make_mesh({"model": 2}) if tp == 2 else None)

    async def main():
        a, b = node(2 if prefill == "tp2" else 1), node(1 if prefill == "tp2" else 2)
        for n in (a, b):
            await n.start()
        try:
            first = await a.generate(tokens=prompt, max_new_tokens=6, handoff_export=True)
            desc = first["handoff"]

            async def fetch(peer, chains_hex, timeout_s, **kw):
                return _pages_for(await a.kv_export_pages(chains_hex, 8 << 20, **kw))

            b._kv_fetch_fn = fetch
            out = await b.generate(tokens=prompt, max_new_tokens=6, handoff=desc,
                                   kv_peer={"node_id": "peer", "pages": desc["pages"],
                                            "page_size": PS, "handoff": desc["id"]})
            assert b.engine.stats["kv_handoff_completed_total"] == 1
            return out["tokens"]
        finally:
            for n in (a, b):
                await n.stop()
                n.engine.close()

    return asyncio.run(main())


@pytest.mark.parametrize("prefill", ["tp2", "tp1"], ids=["tp2_prefills", "tp1_prefills"])
def test_two_phase_handoff_between_tp_and_tp1_nodes(weights, fleet, prefill):
    """Phase one on ``prefill``, phase two on the other node through its
    ``kv_fetch`` (the tail first): the slot installs live with the phase-1
    token, no prefill, and the tokens are the JAX nodes' on the same
    handoff, and the JAX TP engine's."""
    a, b = fleet[prefill], fleet["tp1" if prefill == "tp2" else "tp2"]
    prompt = _prompt(40 if prefill == "tp2" else 50, 27)
    first = a.generate(tokens=prompt, max_new_tokens=6, handoff_export=True)
    desc = first["handoff"]
    assert first["finish_reason"] == "handoff" and desc["pages"] == 3
    log: list = []
    b._kv_fetch_fn = _fetch_from(a, log)
    before = dict(b.engine.stats)
    out = b.generate(tokens=prompt, max_new_tokens=6, handoff=desc,
                     kv_peer={"node_id": "peer", "pages": 3, "page_size": PS,
                              "handoff": desc["id"]})
    assert b.engine.stats["kv_handoff_completed_total"] == before[
        "kv_handoff_completed_total"] + 1
    assert b.engine.stats["prefill_tokens"] == before["prefill_tokens"]
    assert "handoff" in log[0][0][0]
    assert out["tokens"][0] == desc["t0"] == first["tokens"][0]
    assert out["tokens"] == _jax_handoff(weights, prompt, prefill)
    assert out["tokens"] == _run(fleet["jax"], f"h{prefill}", prompt, max_new=6)


def test_mm_embeds_under_tp_match_jax(weights, fleet):
    """A prompt whose placeholder span takes embeddings: the TP engine's
    greedy tokens equal the JAX TP engine's, its injected prefill's logits
    within ``LOGIT_TOL`` of the JAX forward on the mesh."""
    rng = np.random.default_rng(3)
    emb = (rng.standard_normal((6, CFG.hidden_size)) * 0.05).astype(np.float32)
    prompt = [5] * 6 + [9, 11, 13, 17]
    spans = [(0, emb)]
    eng = fleet["tp2"].engine
    got = fleet["tp2"]._on_engine_thread(lambda: eng.run_to_completion([Request(
        id="mm", prompt=prompt, mm_embeds=[(0, torch.from_numpy(emb))],
        sampling=SamplingParams(max_new_tokens=6))]))
    want = fleet["jax"].run_to_completion([jax_engine.Request(
        id="mm", prompt=prompt, mm_embeds=spans, sampling=JaxSampling(max_new_tokens=6))])
    assert got == want
    assert got["mm"] != _run(fleet["jax"], "plain", prompt, max_new=6)
    row = np.zeros((eng.ecfg.max_pages_per_seq,), np.int32)  # KV to the garbage page
    logits = fleet["tp2"]._on_engine_thread(
        lambda: eng._dense_prefill([prompt], [row], spans).numpy())
    jm = jax_mesh.make_mesh({"model": 2})
    placed = jax_sharding.shard_params(weights.tree, weights.jcfg, jm)
    inject = np.zeros((1, len(prompt), CFG.hidden_size), np.float32)
    inject[0, :6] = emb
    mask = np.asarray([[True] * 6 + [False] * 4])
    with jax_mesh.use_mesh(jm):
        jl, _ = jax_llama.forward_impl(
            placed, weights.jcfg, jnp.asarray([prompt], jnp.int32),
            jnp.arange(len(prompt), dtype=jnp.int32)[None],
            embeds_override=(jnp.asarray(inject), jnp.asarray(mask)))
    np.testing.assert_allclose(logits[0], np.asarray(jl[0, -1], np.float32), atol=LOGIT_TOL,
                               rtol=0)


def _png_b64(color=(255, 0, 0), size=(8, 8)) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", size, color).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _post(port: int, body: dict) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/reasoners/generate",
                                 data=json.dumps({"input": body}).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())["result"]


def test_media_node_under_tp_matches_jax():
    """``build_model_node(tp=2)`` with a vision tower, a TTS head and an
    image head, over HTTP, against the JAX node's backend under
    ``make_mesh({"model": 2})`` on the port's weights of the same seed (the
    towers and heads the JAX draw, carried): a PNG prompt, a spoken answer
    and a rendered image answer alike."""
    vit, tts, img = (mm.tower("vision", "vit-tiny"), mm.tower("tts", "tts-tiny"),
                     mm.tower("imagegen", "imagegen-tiny"))
    ecfg = dict(ECFG, host_cache_bytes=0)
    calls = {"png": dict(prompt="look: <image> describe", images=[{"b64": _png_b64()}],
                         max_new_tokens=4),
             "speak": dict(prompt="hello", output="audio"),
             "image": dict(prompt="a boat", output="image")}
    server, backend = build_model_node("llama-tiny", seed=7, ecfg=EngineConfig(**ecfg),
                                       device="cpu", tp=2, tp_backend="gloo", vision=vit[1],
                                       tts=tts[1], imagegen=img[1])
    workers = backend.engine.mesh.workers
    port = server.start(port=0)
    try:
        got = [_post(port, body) for body in calls.values()]
    finally:
        server.stop()
    assert workers.exitcodes == [0]
    tree = jax.tree.map(lambda t: t.numpy(), llama.init_params(CFG, seed=7, device="cpu"))
    jcfg = dataclasses.replace(jax_configs.get_config("llama-tiny"), dtype="float32")
    want = mm.jax_calls((jcfg, tree, None), ecfg, list(calls.values()),
                        mesh=jax_mesh.make_mesh({"model": 2}), model_name="llama-tiny",
                        vision=vit[0], tts=tts[0], imagegen=img[0])
    mm.assert_same(want, got, list(calls))
    assert len(got[0]["tokens"]) == 4
    assert [p["type"] for p in got[1]["parts"]] == ["audio"]
    assert [p["type"] for p in got[2]["parts"]] == ["image"]
