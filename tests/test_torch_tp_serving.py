"""The port's tensor-parallel engine and node, on the CPU: rank 0 in the
test's process, ranks 1..tp-1 spawned (``parallel.worker``), gloo
between them, float32 llama-tiny weights carried from the JAX package
(``tests/helpers_torch_tp.NpzWeights``: each rank cuts its own slice).

- ``test_tensor_parallel_engine_matches_oracle``'s script
  (``tests/test_serving_engine.py``) through the port's ``tp=2`` engine:
  greedy tokens equal to the JAX engine under ``make_mesh({"model": 2})``
  and to the JAX single-device oracle (``generate_greedy``); the prefill
  logits within ``LOGIT_TOL`` of the JAX forward;
- int8 weights under TP (``test_tp_shards_quantized_params``'s tree):
  tokens equal to the JAX TP engine's on the quantized tree, logits
  within ``LOGIT_TOL`` of the JAX forward on it;
- one prefill at 8 ranks on llama-tiny-tp8 (one KV head a rank);
- speculative decoding, branch forks and the chunked mixed tick under TP
  against the JAX engine under the same mesh, config and draft, and the
  port's own single-rank engine (greedy tokens equal);
- a ``tp=2`` node over HTTP against a ``tp=1`` node of the same seed
  (its weights are slices of the TP=1 tree), its embeddings, and its
  workers joined at ``stop()``;
- the collectives on two gloo ranks, what a mesh refuses, a worker that
  exits when rank 0 dies mid-step, and ``chip_smoke.phase_tp`` rehearsed
  with ``device="cpu"``.

``LOGIT_TOL`` = 1e-4: float32 math in another order (the all-reduces add
the ranks' partial products, as GSPMD's psum does, in another grouping than
one product over the whole contraction); the engine tests in
``test_torch_engine.py`` hold plain float32 to the same bound."""

from __future__ import annotations

import contextlib
import dataclasses
import json
import multiprocessing
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from agentfield_tpu.models import configs as jax_configs
from agentfield_tpu.models import llama as jax_llama
from agentfield_tpu.models import quant as jax_quant
from agentfield_tpu.parallel import mesh as jax_mesh
from agentfield_tpu.parallel import sharding as jax_sharding
from agentfield_tpu.serving import engine as jax_engine
from agentfield_tpu.serving.sampler import SamplingParams as JaxSampling
from agentfield_tpu_torch.models import llama
from agentfield_tpu_torch.models.configs import get_config
from agentfield_tpu_torch.models.convert import params_from_numpy
from agentfield_tpu_torch.parallel import mesh as tmesh
from agentfield_tpu_torch.parallel import worker as worker_mod
from agentfield_tpu_torch.parallel.sharding import shard_params
from agentfield_tpu_torch.parallel.worker import WorkerSpec, start_workers
from agentfield_tpu_torch.serving.engine import EngineConfig, InferenceEngine, Request
from agentfield_tpu_torch.serving.model_node import build_model_node
from agentfield_tpu_torch.serving.sampler import SamplingParams
from tests import helpers_torch_tp as ht

LOGIT_TOL = 1e-4
ECFG = dict(max_batch=4, page_size=8, num_pages=64, max_pages_per_seq=8)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _ranks_yield_the_cpu(monkeypatch):
    """The spawned ranks run at nice 10: their start (an interpreter and
    torch each, up to seven at once) must not starve the other test files'
    timed sections on a shared box."""
    popen = worker_mod.subprocess.Popen
    monkeypatch.setattr(worker_mod.subprocess, "Popen",
                        lambda args, **kw: popen(["nice", "-n", "10", *args], **kw))


def _jax_tree(name: str, quant: bool = False):
    jcfg = dataclasses.replace(jax_configs.get_config(name), dtype="float32")
    tree = jax_llama.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, (jax_quant.quantize_params(tree) if quant else tree)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@contextlib.contextmanager
def tp_engine(path: str, name: str, tp: int, ecfg: EngineConfig, self_draft: bool = False):
    """Rank 0's engine of a ``tp``-rank gloo engine on the CPU; every
    worker must have exited with code 0 once it closes."""
    cfg = get_config(name)
    weights = ht.NpzWeights(path, cfg, self_draft)
    mesh = start_workers(tp, WorkerSpec(cfg, ecfg, 0, weights, "gloo", "cpu", timeout_s=120,
                                        threads=1))
    workers = mesh.workers
    try:
        params, draft = weights(mesh)
        eng = InferenceEngine(params, cfg, ecfg, mesh=mesh, draft=draft)
    except BaseException:
        mesh.close()
        raise
    try:
        yield eng
    finally:
        eng.close()
    assert workers.exitcodes == [0] * (tp - 1)


def _prompts():
    # test_tensor_parallel_engine_matches_oracle's prompts
    return [jax.random.randint(jax.random.PRNGKey(i), (n,), 0, 512, jnp.int32).tolist()
            for i, n in enumerate([5, 9])]


def _jax_tp_tokens(jcfg, tree, prompts, max_new=5, over=None, self_draft=False, **req_kw):
    """Greedy tokens of the JAX engine under ``make_mesh({"model": 2})``
    (``over``: EngineConfig fields beside ``ECFG``; ``self_draft``: the tree
    is its own speculative draft, sharded by the engine)."""
    eng = jax_engine.InferenceEngine(tree, jcfg, jax_engine.EngineConfig(**{**ECFG, **(over or {})}),
                                     mesh=jax_mesh.make_mesh({"model": 2}),
                                     draft=(tree, jcfg) if self_draft else None)
    return eng.run_to_completion([
        jax_engine.Request(id=f"r{i}", prompt=p, sampling=JaxSampling(max_new_tokens=max_new),
                           **req_kw)
        for i, p in enumerate(prompts)])


def _port_requests(prompts, max_new=5, **kw):
    return [Request(id=f"r{i}", prompt=p, sampling=SamplingParams(max_new_tokens=max_new), **kw)
            for i, p in enumerate(prompts)]


def _prefill_logits(eng, prompts) -> np.ndarray:
    """Last-token logits of a dense prefill (rank 0 and the workers), its
    KV written to the garbage page 0."""
    row = np.zeros((eng.ecfg.max_pages_per_seq,), np.int32)
    return eng._dense_prefill(prompts, [row] * len(prompts)).numpy()


def _jax_last_logits(jcfg, tree, prompts, tp: int) -> np.ndarray:
    """The JAX forward on the tree placed on a ``tp`` mesh, each prompt
    alone, at its last position."""
    jm = jax_mesh.make_mesh({"model": tp})
    placed = jax_sharding.shard_params(tree, jcfg, jm)
    out = []
    with jax_mesh.use_mesh(jm):
        for p in prompts:
            toks = jnp.asarray([p], jnp.int32)
            pos = jnp.arange(len(p), dtype=jnp.int32)[None]
            logits, _ = jax_llama.forward(placed, jcfg, toks, pos, collect_kv=False)
            out.append(np.asarray(logits[0, -1], np.float32))
    return np.stack(out)


def test_tp_engine_matches_jax_tp_engine_and_oracle(tmp_path):
    jcfg, tree = _jax_tree("llama-tiny")
    path = str(tmp_path / "w.npz")
    ht.save_tree(_np(tree), path)
    prompts = _prompts()
    want = _jax_tp_tokens(jcfg, tree, prompts)
    for i, p in enumerate(prompts):
        oracle = jax_llama.generate_greedy(tree, jcfg, jnp.asarray([p], jnp.int32),
                                           num_steps=5, max_len=64)[0].tolist()
        assert want[f"r{i}"] == oracle
    with tp_engine(path, "llama-tiny", 2, EngineConfig(**ECFG)) as eng:
        got = eng.run_to_completion(_port_requests(prompts))
        assert got == want
        assert eng.cache.k_pages.shape[2] == get_config("llama-tiny").num_kv_heads // 2
        assert eng.cache.page_bytes() == eng.kv_page_bytes_dense  # global: every rank's heads
        assert "gloo" in eng.graph_stats()["eager"]
        assert eng.allocator.free_pages == ECFG["num_pages"] - 1
        logits = _prefill_logits(eng, prompts)
    np.testing.assert_allclose(logits, _jax_last_logits(jcfg, tree, prompts, 2),
                               atol=LOGIT_TOL, rtol=0)


def test_tp_int8_engine_matches_jax(tmp_path):
    """``test_tp_shards_quantized_params``'s tree: the JAX TP engine's
    greedy tokens, and the JAX forward's logits (finite, within
    ``LOGIT_TOL``)."""
    jcfg, qtree = _jax_tree("llama-tiny", quant=True)
    path = str(tmp_path / "q.npz")
    ht.save_tree(_np(qtree), path)
    prompts = _prompts() + [list(range(3, 30))]
    want = _jax_tp_tokens(jcfg, qtree, prompts, max_new=6)
    with tp_engine(path, "llama-tiny", 2, EngineConfig(**ECFG)) as eng:
        assert eng.params["layers"]["wo"].q.shape[1] == jcfg.q_dim // 2
        got = eng.run_to_completion(_port_requests(prompts, max_new=6))
        logits = _prefill_logits(eng, prompts)
    assert got == want
    assert np.isfinite(logits).all()
    np.testing.assert_allclose(logits, _jax_last_logits(jcfg, qtree, prompts, 2),
                               atol=LOGIT_TOL, rtol=0)


def test_tp8_prefill_matches_jax(tmp_path):
    """Eight ranks on llama-tiny-tp8: one KV head and 8 query heads a rank
    (the Llama-3-70B TP=8 carve in miniature)."""
    jcfg, tree = _jax_tree("llama-tiny-tp8")
    path = str(tmp_path / "w8.npz")
    ht.save_tree(_np(tree), path)
    prompts = [list(range(7, 40)), [3, 99, 4]]
    with tp_engine(path, "llama-tiny-tp8", 8, EngineConfig(**ECFG)) as eng:
        assert eng.cache.k_pages.shape[2] == 1
        logits = _prefill_logits(eng, prompts)
    np.testing.assert_allclose(logits, _jax_last_logits(jcfg, tree, prompts, 8),
                               atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("feature", ["spec", "branches", "mixed_chunked"])
def test_tp_engine_features_match_single_rank(tmp_path, feature):
    """Speculative decoding (a self draft, k = 2: rank 0's proposals and
    acceptances broadcast), branch forks (8 slots, so most forks install at
    once: the partial last page copied on every rank) and the mixed tick
    with chunked prompts, greedy: the TP engine's tokens are the JAX
    engine's under ``make_mesh({"model": 2})`` with the same config and
    draft, and the single-rank port engine's."""
    jcfg, tree = _jax_tree("llama-tiny")
    path = str(tmp_path / "w.npz")
    ht.save_tree(_np(tree), path)
    cfg = get_config("llama-tiny")
    over = {"spec": dict(spec_k=2, mixed_step=False), "branches": dict(max_batch=8),
            "mixed_chunked": dict(prefill_chunk=16, mixed_step=True)}[feature]
    ecfg = EngineConfig(**{**ECFG, **over})
    prompts = _prompts() + [list(range(40, 75))]
    kw = dict(n_branches=3) if feature == "branches" else {}

    def reqs():
        return _port_requests(prompts, max_new=7, **kw)

    params = params_from_numpy(_np(tree), cfg, device="cpu")
    draft = (params_from_numpy(_np(tree), cfg, device="cpu"), cfg) if feature == "spec" else None
    want = InferenceEngine(params, cfg, ecfg, draft=draft).run_to_completion(reqs())
    assert want == _jax_tp_tokens(jcfg, tree, prompts, max_new=7, over=over,
                                  self_draft=feature == "spec", **kw)
    with tp_engine(path, "llama-tiny", 2, ecfg, self_draft=feature == "spec") as eng:
        copies = []
        copy_page = eng._copy_page
        eng._copy_page = lambda src, dst: (copies.append(src), copy_page(src, dst))[1]
        got = eng.run_to_completion(reqs())
        if feature == "spec":
            assert eng.stats["spec_steps"] > 0
        if feature == "branches":
            assert eng.stats["branch_forks_total"] > eng.stats["branch_forks_degraded_total"]
            assert copies
        if feature == "mixed_chunked":
            assert eng.stats["mixed_ticks"] > 0
        assert eng.allocator.free_pages == ECFG["num_pages"] - 1
    assert got == want


def _call(port: int, path: str, body: dict) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())["result"]


def test_tp_node_over_http_matches_tp1_node():
    """Random weights from one seed: the TP=2 node's ranks hold slices of
    the TP=1 node's tree, so greedy tokens are equal and the embeddings
    within LOGIT_TOL; ``stop()`` joins the worker."""
    ecfg = EngineConfig(**ECFG)
    prompts = [[5, 17, 300, 2, 9], list(range(40, 60))]
    out = {}
    for tp in (1, 2):
        kw = dict(tp=2, tp_backend="gloo") if tp == 2 else {}
        server, backend = build_model_node("llama-tiny", seed=7, ecfg=ecfg, device="cpu", **kw)
        port = server.start(port=0)
        try:
            out[tp] = ([_call(port, "/reasoners/generate",
                              {"input": {"tokens": p, "max_new_tokens": 6}})["tokens"]
                        for p in prompts],
                       _call(port, "/reasoners/embed", {"input": {"tokens": prompts[1]}})[
                           "embedding"])
            workers = backend.engine.mesh.workers if tp == 2 else None
        finally:
            server.stop()
        if workers is not None:
            assert workers.exitcodes == [0]
            assert backend.engine.mesh.workers is None
    assert out[2][0] == out[1][0]
    np.testing.assert_allclose(out[2][1], out[1][1], atol=LOGIT_TOL, rtol=0)
    whole = llama.init_params(get_config("llama-tiny"), seed=7, device="cpu")
    r1 = llama.init_params(get_config("llama-tiny"), seed=7, device="cpu",
                           shard=tmesh.make_mesh({"model": 2}, 1))
    assert torch.equal(r1["layers"]["w_down"], whole["layers"]["w_down"][:, 128:])
    with pytest.raises(ValueError, match="pass a seed or a checkpoint"):
        build_model_node("llama-tiny", device="cpu", tp=2, tp_backend="gloo",
                         params=whole)
    with pytest.raises(ValueError, match="needs tp_backend="):
        build_model_node("llama-tiny", device="cpu", tp=2)  # the caller names the backend


def test_collectives_on_two_gloo_ranks(tmp_path):
    store = torch.distributed.TCPStore("127.0.0.1", 0, 2, True, wait_for_workers=False)
    ctx = multiprocessing.get_context("spawn")
    parent, child = ctx.Pipe()
    err = tmp_path / "rank1.stderr"
    p = ctx.Process(target=ht.collective_rank, args=(1, store.port, child, str(err)),
                    daemon=True)
    p.start()
    child.close()
    mesh = tmesh.make_mesh({"model": 2}, 0, "gloo", store=store, timeout_s=120)
    try:
        mine = ht.collective_script(mesh)
        theirs = parent.recv()
        t0 = time.monotonic()
        p.join(timeout=30)
        waited = time.monotonic() - t0
    finally:
        mesh.close()
    assert p.exitcode == 0, (
        f"rank 1: exit code {p.exitcode} after {waited:.1f} s of join; its stderr:\n"
        + (err.read_text() if err.exists() else "(none)"))
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    for got in (mine, theirs):
        assert torch.equal(got["sum"], x * 3)
        assert got["sum_bf16"].dtype == torch.bfloat16 and torch.equal(
            got["sum_bf16"], torch.full((4,), 1.5, dtype=torch.bfloat16))
        assert torch.equal(got["gathered"], torch.tensor([[1.0] * 3 + [2.0] * 3] * 2))
        assert torch.equal(got["bcast"], torch.arange(5))
    assert mesh.reduce_dtype(torch.bfloat16) == torch.float32


def _coord_engine(name="llama-tiny", cut=True, **over):
    """Rank 0's engine of a mesh with no workers and no group (host-side
    checks only), over rank 0's slice (``cut``) or the whole tree."""
    cfg = get_config(name)
    mesh = tmesh.make_mesh({"model": 2}, 0)
    params = llama.init_params(cfg, seed=0, device="cpu",
                               dtype="float32" if cfg.dtype != "float32" else None)
    if cut:
        params = shard_params(params, cfg, mesh)
    return InferenceEngine(params, cfg, EngineConfig(**ECFG, **over), mesh=mesh)


def test_what_a_mesh_refuses():
    """Every engine feature this slice does not port raises
    NotImplementedError naming its ROADMAP item, before any weight is cut
    or any request runs single-rank. (The host tier, the cluster tier,
    handoff, the sketch and media prompts run under a mesh:
    ``tests/test_torch_tp_tiers.py``.)"""
    with pytest.raises(NotImplementedError, match="A5: EP and Mixtral"):
        _coord_engine("mixtral-tiny", cut=False)
    with pytest.raises(ValueError, match=r"param embed: shape \(512, 128\) is not one rank's"):
        _coord_engine(cut=False)  # the engine takes a rank's slice, never a whole tree
    with pytest.raises(ValueError, match="does not divide num_kv_heads"):
        InferenceEngine(llama.init_params(get_config("llama-tiny"), device="cpu"),
                        get_config("llama-tiny"), EngineConfig(**ECFG),
                        mesh=tmesh.make_mesh({"model": 4}, 0))
    eng = _coord_engine()
    assert eng.cache.k_pages.shape[2] == 1 and eng.params["embed"].shape[0] == 256
    with pytest.raises(NotImplementedError, match="A5: ring attention"):
        llama.forward(eng.params, eng.cfg, torch.zeros((1, 4), dtype=torch.long),
                      torch.arange(4)[None], attn_impl="ring", mesh=eng.mesh)
    with pytest.raises(NotImplementedError, match="A5: the trainer's mesh pieces"):
        build_model_node("llama-tiny", device="cpu", tp=2, tp_backend="gloo", lora="/x")


def test_worker_exits_when_root_dies():
    """A rank 0 that dies with its worker inside a decode step's first
    collective: the worker exits (gloo reports the closed peer) instead of
    waiting forever."""
    cfg = get_config("llama-tiny")
    spec = WorkerSpec(cfg, EngineConfig(**ECFG), 0, _RandomTiny(cfg), "gloo", "cpu",
                      timeout_s=120, threads=1)
    ctx = multiprocessing.get_context("spawn")
    parent, child = ctx.Pipe()
    root = ctx.Process(target=ht.root_that_dies, args=(spec, child))
    root.start()
    child.close()
    assert parent.poll(120), "rank 0 never reported its worker"
    pid = parent.recv()
    root.join(timeout=30)
    assert root.exitcode == 1
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and _alive(pid):
        time.sleep(0.2)
    assert not _alive(pid), f"worker {pid} still waits after rank 0 died"


def test_a_worker_that_fails_to_start_is_reported():
    """A rank whose weights raise: rank 0's wait for the workers raises
    with that rank's traceback at once, and the rank exits with code 2."""
    cfg = get_config("llama-tiny")
    mesh = start_workers(2, WorkerSpec(cfg, EngineConfig(**ECFG), 0, ht.FailOnRank(1), "gloo",
                                       "cpu", timeout_s=120, threads=1))
    workers = mesh.workers
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 failed to start(.|\n)*refuses to load"):
        workers.wait_ready()
    assert time.monotonic() - t0 < 60
    mesh.close()
    assert workers.exitcodes == [2]


def _RandomTiny(cfg):
    from agentfield_tpu_torch.parallel.worker import RandomWeights

    return RandomWeights(cfg, 0)


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/status") as f:
            state = next(line for line in f if line.startswith("State:"))
    except (FileNotFoundError, ProcessLookupError, StopIteration):
        return False
    return "Z" not in state.split()[1]


def test_phase_tp_rehearsed_on_the_cpu():
    """``chip_smoke.phase_tp`` end to end at llama-tiny size on the CPU
    (``TP_REHEARSAL``): the TP=2 node in f32 and int8 against the TP=1
    node, prefill and teacher-forced decode logits and served logprobs
    within their bounds, every worker joined; on the f32 pair (d) the host
    tier, (e) pages and handoffs both ways, (f) a PNG prompt."""
    results: dict = {}
    chip_smoke.phase_tp(results, 0, device="cpu", **chip_smoke.TP_REHEARSAL)
    t = results["tp"]["bf16"]["tiers"]
    d, e, f = t["d"], t["e"], t["f"]
    assert d["tokens_equal"] and d["slices_equal"] == [True, True]
    assert d["pages_demoted"] == d["pages_restored"] == d["all_host"] > 0
    assert e["spec_equal"] and e["segs_equal"] and e["sketch_holds_prompt"]
    for m in e["moves"].values():
        assert m["adopted"] == m["restored"] > 0
        assert m["max_abs_logit_diff"] <= m["logit_bound"]
    for h in e["handoffs"].values():
        assert h["live"] == 1 and h["prefilled"] == 0 and h["first_token_kept"]
    assert f["max_abs_logit_diff"] <= f["logit_bound"] and f["near_max"]
    for mode in ("bf16", "int8"):
        r = results["tp"][mode]
        assert r["answered"] == r["prompts"] and r["tokens_equal"]
        assert r["max_abs_logit_diff"] <= r["logit_bound"]
        assert r["decode_steps_forced"] == chip_smoke.TP_REHEARSAL["max_new"] - 1
        assert r["decode_max_abs_logit_diff"] <= r["logit_bound"]
        assert max(r["served_logprob_diff"].values()) <= r["served_logprob_bound"]
        assert r["first_tokens_checked"] and r["first_tokens_equal"]
        assert r["tp_first_token_near_max"] == r["prompts"]
        assert r["first_token_is_argmax"] == {1: r["prompts"], 2: r["prompts"]}
        assert r["exitcodes"] == [0]
