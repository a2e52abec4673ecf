"""The port's branch decoding against the JAX package's, on the CPU
(llama-tiny, float32, the same carried weights). The scripts are those of
``tests/test_branching.py``:

- ``validate_branch_spec``, ``max_branches`` and ``branch_rid``: the same
  answers and the same messages as the JAX module's;
- ``BranchGroup`` best-of-N and beam: the same actions, records and
  summaries for the same event feed;
- the engine: greedy branch 0 token-exact against the JAX engine (every
  branch, classic and mixed ticks), sampled branches leaking nothing, a
  degraded fork under slot pressure, a live fork and the ``fork_failed``
  terminal, ``engine.preempt_storm`` in the middle of a branch group (each
  package's own injector), bad requests rejected with the JAX messages.
  Tokens where they are greedy, the fork counters and ``free_pages`` must
  be equal;
- the node: best-of-N (greedy answer equal to the JAX node's), beam with
  pruning and re-forks, the winner-only stream, and a caller giving up
  freeing every branch.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from agentfield_tpu import branching as jax_branching
from agentfield_tpu.control_plane import faults as jax_faults
from agentfield_tpu.models import configs as jax_configs
from agentfield_tpu.models import llama as jax_llama
from agentfield_tpu.serving import engine as jax_engine
from agentfield_tpu.serving import model_node as jax_node
from agentfield_tpu.serving.grammar import compile_json_schema as jax_compile
from agentfield_tpu.serving.sampler import SamplingParams as JaxSampling
from agentfield_tpu_torch import branching
from agentfield_tpu_torch.models.configs import get_config
from agentfield_tpu_torch.models.convert import params_from_numpy
from agentfield_tpu_torch.serving import engine
from agentfield_tpu_torch.serving import faults
from agentfield_tpu_torch.serving.grammar import compile_json_schema
from agentfield_tpu_torch.serving.model_node import ModelBackend
from agentfield_tpu_torch.serving.sampler import SamplingParams
from agentfield_tpu_torch.serving.tokenizer import ByteTokenizer

ECFG = dict(max_batch=8, page_size=8, num_pages=128, max_pages_per_seq=8)
FORK_KEYS = ("branch_forks_total", "branch_forks_degraded_total", "branch_fork_failed_total",
             "preempt_storm_injected", "preemptions_total", "requests_finished")
V = 512


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
    tree = jax.tree.map(np.asarray, jax_llama.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tree, params_from_numpy(tree, get_config("llama-tiny"), device="cpu")


@pytest.fixture(autouse=True)
def _clear_injectors():
    yield
    jax_faults.install(None)
    faults.install(None)


def _prompt(seed: int, n: int) -> list[int]:
    return np.random.default_rng(seed).integers(0, V, n).tolist()


def _make(weights, mod, seed=0, **over):
    jcfg, tree, params = weights
    ecfg = ECFG | over
    if mod is jax_engine:
        return jax_engine.InferenceEngine(tree, jcfg, jax_engine.EngineConfig(**ecfg), seed=seed)
    return engine.InferenceEngine(params, get_config("llama-tiny"), engine.EngineConfig(**ecfg),
                                  seed=seed)


def _req(mod, rid, prompt, max_new, temperature=0.0, **kw):
    samp = JaxSampling if mod is jax_engine else SamplingParams
    return mod.Request(id=rid, prompt=prompt,
                       sampling=samp(max_new_tokens=max_new, temperature=temperature), **kw)


def _drain(eng) -> list:
    evs = []
    t0 = time.monotonic()
    while eng.has_work():
        assert time.monotonic() - t0 < 120, "engine wedged"
        evs += eng.step()
    return evs


def _indexes(evs) -> dict[str, list[int]]:
    by: dict[str, list[int]] = {}
    for e in evs:
        if e.token >= 0:
            by.setdefault(e.request_id, []).append(e.index)
    return by


def _observe(eng) -> dict:
    return {"counters": {k: eng.stats[k] for k in FORK_KEYS},
            "free_pages": eng.allocator.free_pages}


# ---------------------------------------------------------------------------
# spec validation, ids, the group (jax-free layer)


SPECS = [
    (None, None), (1, None), (4, None), (4, "beam"),
    (3, {"type": "best_of_n", "verifier": "judge.score"}),
    (6, {"type": "beam", "beam_width": 2, "beam_interval": 5}),
    (0, None), (-1, None), (True, None), (1.5, None), ("2", None), (33, None),
    (1, "best_of_n"), (2, {"type": "bogus"}), (2, {"type": "best_of_n", "verifier": "nodot"}),
    (2, {"type": "beam", "beam_width": 2}), (2, {"type": "best_of_n", "wat": 1}),
    (2, 7), (3, {"type": "beam", "beam_interval": 0}),
]


def _outcome(mod, n, pol):
    try:
        return ("ok", mod.validate_branch_spec(n, pol))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("n,pol", SPECS, ids=[repr(s) for s in SPECS])
def test_validate_branch_spec_matches_jax(n, pol):
    assert _outcome(branching, n, pol) == _outcome(jax_branching, n, pol)


def test_branch_cap_env_and_rid(monkeypatch):
    for raw in ("4", "junk", "0", None):
        if raw is None:
            monkeypatch.delenv("AGENTFIELD_BRANCH_MAX", raising=False)
        else:
            monkeypatch.setenv("AGENTFIELD_BRANCH_MAX", raw)
        assert branching.max_branches() == jax_branching.max_branches()
        assert _outcome(branching, 5, None) == _outcome(jax_branching, 5, None)
    for parent, j in (("gen_7", 0), ("gen_7", 3), ("p", 12)):
        assert branching.branch_rid(parent, j) == jax_branching.branch_rid(parent, j)
    assert branching.branch_rid("gen_7", 3) == "gen_7#b3"


def _ev(mod, tok, idx, lp, finished=False, reason=None):
    return mod.TokenEvent(request_id="x", token=tok, index=idx, finished=finished,
                          finish_reason=reason, logprob=lp)


def _feed_best_of_n(bmod, emod):
    g = bmod.BranchGroup("p", 2, {"type": "best_of_n"})
    acts = [g.on_event("p", _ev(emod, 5, 0, -1.0)), g.on_event("p#b1", _ev(emod, 6, 0, -0.1)),
            g.on_event("p", _ev(emod, 7, 1, -1.0, True, "length")),
            g.on_event("p#b1", _ev(emod, 8, 1, -0.1, True, "length"))]
    cands = g.candidates()
    return acts, [c.rid for c in cands], g.summary(cands[0], False)


def _feed_beam(bmod, emod):
    g = bmod.BranchGroup("p", 3, {"type": "beam", "beam_width": 1, "beam_interval": 2})
    acts = []
    for idx in (0, 1):
        for rid, lp in (("p", -0.1), ("p#b1", -5.0), ("p#b2", -9.0)):
            acts.append(g.on_event(rid, _ev(emod, 1, idx, lp)))
    acts.append(g.on_event("p#b3", _ev(emod, 9, 2, -0.2)))
    b3 = g.branch("p#b3")
    seeded = ([t for t, _ in b3.records], round(b3.cum_logprob, 6))
    acts.append(g.on_event("p#b4", _ev(emod, -1, -1, None, True, "fork_failed")))
    acts.append(g.on_event("p", _ev(emod, 1, 2, -0.1, True, "stop")))
    acts.append(g.on_event("p#b3", _ev(emod, 1, 3, -0.2, True, "stop")))
    cands = g.candidates()
    return acts, seeded, g.pruned_count(), g.summary(cands[0], False)


def test_group_best_of_n_matches_jax():
    t = _feed_best_of_n(branching, engine)
    assert t == _feed_best_of_n(jax_branching, jax_engine)
    assert t[0][-1] == [("resolve",)] and t[1][0] == "p#b1" and t[2]["winner"] == 1


def test_group_beam_prune_and_refork_matches_jax():
    t = _feed_beam(branching, engine)
    assert t == _feed_beam(jax_branching, jax_engine)
    acts = [a for step in t[0] for a in step]
    assert {a[1] for a in acts if a[0] == "cancel"} == {"p#b1", "p#b2"}
    assert [a[2] for a in acts if a[0] == "fork"] == ["p#b3", "p#b4"]
    assert t[1] == ([1, 1, 9], -0.4) and t[2] == 2 and ("resolve",) in acts


# ---------------------------------------------------------------------------
# engine forks, through both engines


@pytest.mark.parametrize("mixed", [False, True], ids=["classic", "mixed"])
def test_fork_greedy_token_exact_against_jax(weights, mixed):
    prompt = _prompt(1, 19)
    over = {"mixed_step": True} if mixed else {}
    obs = {}
    for mod in (jax_engine, engine):
        base = _make(weights, mod, seed=7, **over).run_to_completion(
            [_req(mod, "u", prompt, 6)])["u"]
        eng = _make(weights, mod, seed=7, **over)
        out = eng.run_to_completion([_req(mod, "g", prompt, 6, n_branches=4)])
        assert out["g"] == base, f"branch 0 diverged ({mod.__name__})"
        assert set(out) == {"g", "g#b1", "g#b2", "g#b3"}
        assert eng.allocator.free_pages == ECFG["num_pages"] - 1
        obs[mod] = (out, _observe(eng))
    assert obs[engine] == obs[jax_engine]
    assert obs[engine][1]["counters"]["branch_forks_total"] == 3


def test_fork_sampled_branches_diverge_and_leak_nothing(weights):
    obs = {}
    for mod in (jax_engine, engine):
        eng = _make(weights, mod, seed=3)
        out = eng.run_to_completion([_req(mod, "s", _prompt(2, 21), 8, temperature=0.9,
                                          n_branches=4)])
        assert len(out) == 4 and all(len(v) == 8 for v in out.values())
        assert len({tuple(v) for v in out.values()}) > 1, "branches must diverge"
        obs[mod] = _observe(eng)
    assert obs[engine] == obs[jax_engine]
    assert obs[engine]["free_pages"] == ECFG["num_pages"] - 1


def test_fork_degrades_to_queue_under_slot_pressure(weights):
    obs = {}
    for mod in (jax_engine, engine):
        eng = _make(weights, mod, seed=5, max_batch=2)
        out = eng.run_to_completion([_req(mod, "d", _prompt(4, 17), 4, temperature=0.7,
                                          n_branches=4)])
        assert set(out) == {"d", "d#b1", "d#b2", "d#b3"}
        assert all(len(v) == 4 for v in out.values())
        obs[mod] = _observe(eng)
    assert obs[engine] == obs[jax_engine]
    assert obs[engine]["counters"]["branch_forks_degraded_total"] >= 1


def test_live_fork_and_fork_failed_terminal(weights):
    obs = {}
    for mod in (jax_engine, engine):
        eng = _make(weights, mod, seed=9)
        eng.submit(_req(mod, "p", _prompt(6, 15), 10, temperature=0.8))
        evs = []
        for _ in range(4):
            evs += eng.step()
        eng.request_fork("p", "p#b1")
        evs += _drain(eng)
        idxs = _indexes(evs)["p#b1"]
        # the child continues the source's index sequence from the fork point
        assert idxs == list(range(idxs[0], 10)) and idxs[0] > 0
        assert eng.allocator.free_pages == ECFG["num_pages"] - 1
        eng.request_fork("p", "p#b9")  # the source finished
        evs2 = _drain(eng)
        fails = [(e.request_id, e.finish_reason, e.token) for e in evs2 if e.finished]
        assert fails == [("p#b9", "fork_failed", -1)]
        obs[mod] = (idxs, _observe(eng))
    assert obs[engine] == obs[jax_engine]
    assert obs[engine][1]["counters"]["branch_fork_failed_total"] == 1


def test_preempt_storm_mid_branch_keeps_group_accounting(weights):
    """A seeded ``engine.preempt_storm`` while a 3-branch group decodes
    beside six others and one waiting request: every branch still gives its
    8 tokens with continuous indexes, and no page leaks."""
    obs = {}
    for mod, f in ((jax_engine, jax_faults), (engine, faults)):
        eng = _make(weights, mod, seed=11)
        f.install(f.FaultInjector(seed=1, spec={"engine.preempt_storm": {"times": 2,
                                                                         "after": 4}}))
        try:
            eng.submit(_req(mod, "g", _prompt(8, 19), 8, temperature=0.8, n_branches=3))
            for i in range(6):
                eng.submit(_req(mod, f"f{i}", _prompt(50 + i, 9), 10))
            by = _indexes(_drain(eng))
        finally:
            f.install(None)
        for rid in ("g", "g#b1", "g#b2"):
            assert by[rid] == list(range(8)), f"{rid} indexes broke: {by[rid]}"
        obs[mod] = (by, _observe(eng))
    assert obs[engine] == obs[jax_engine]
    assert obs[engine][1]["counters"]["preempt_storm_injected"] >= 1
    assert obs[engine][1]["free_pages"] == ECFG["num_pages"] - 1


def test_engine_rejects_bad_branch_requests(weights):
    vocab = [bytes([i]) if i < 256 else b"\x00" for i in range(V)]
    msgs = {}
    for mod, compile_ in ((jax_engine, jax_compile), (engine, compile_json_schema)):
        eng = _make(weights, mod, grammar_slots=8)
        p = _prompt(9, 9)
        got = []
        for kw in ({"n_branches": 0}, {"n_branches": True}, {"n_branches": 2.0}):
            with pytest.raises(ValueError, match="n_branches") as ei:
                eng.submit(_req(mod, "a", p, 4, **kw))
            got.append(str(ei.value))
        g = compile_({"type": "boolean"}, vocab)
        samp = JaxSampling if mod is jax_engine else SamplingParams
        with pytest.raises(ValueError, match="grammar") as ei:
            eng.submit(mod.Request(id="c", prompt=p, grammar=g, n_branches=2,
                                   sampling=samp(stop_token_ids=(0,))))
        got.append(str(ei.value))
        assert not eng.pending
        msgs[mod] = got
    assert msgs[engine] == msgs[jax_engine]


# ---------------------------------------------------------------------------
# the node: the group coordinator


@pytest.fixture(scope="module")
def backend(weights):
    _, _, params = weights
    b = ModelBackend(params, get_config("llama-tiny"), engine.EngineConfig(**ECFG),
                     tokenizer=ByteTokenizer(V), idle_sleep=0.001)
    b.start()
    yield b
    b.stop()


def _jax_node_branched(weights, prompt, **kw):
    jcfg, tree, _ = weights

    async def main():
        b = jax_node.ModelBackend(tree, jcfg, jax_node.EngineConfig(**ECFG),
                                  tokenizer=jax_node.ByteTokenizer(V), idle_sleep=0.001)
        await b.start()
        try:
            return await b.generate(prompt=prompt, **kw)
        finally:
            await b.stop()

    return asyncio.run(main())


def _idle(b) -> bool:
    """Wait for the engine to settle; True when every page is back."""
    for _ in range(1000):
        if not b.engine.has_work() and b.engine.allocator.free_pages == ECFG["num_pages"] - 1:
            return True
        time.sleep(0.01)
    return False


def test_node_best_of_n_greedy_matches_jax_node(weights, backend):
    kw = dict(max_new_tokens=6, n_branches=3)
    r = backend.generate(prompt="parity probe xy", **kw)
    j = _jax_node_branched(weights, "parity probe xy", **kw)
    assert r["tokens"] == j["tokens"] and r["branches"] == j["branches"]
    assert r["branches"]["winner"] == 0  # a tied greedy group: branch 0
    assert r["tokens"] == backend.generate(prompt="parity probe xy", max_new_tokens=6)["tokens"]
    assert _idle(backend) and not backend._groups


def test_node_best_of_n_and_beam(backend):
    r = backend.generate(prompt="best of n probe", max_new_tokens=8, temperature=0.9,
                         n_branches=3)
    assert r["branches"]["n"] == 3 and r["branches"]["winner"] is not None
    assert len(r["tokens"]) == len(r["logprobs"]) <= 8
    assert all(lp is not None for lp in r["logprobs"])
    pruned0 = backend.engine.stats["branch_pruned_total"]
    r2 = backend.generate(prompt="beam probe prompt", max_new_tokens=18, temperature=0.9,
                          n_branches=4,
                          branch_policy={"type": "beam", "beam_width": 2, "beam_interval": 5})
    assert r2["branches"]["policy"] == "beam" and r2["branches"]["pruned"] >= 1
    assert r2["branches"]["forked"] > 4  # survivors re-forked
    assert backend.engine.stats["branch_pruned_total"] > pruned0
    # a verifier target is accepted; without a verifier hook, logprob wins
    r3 = backend.generate(prompt="verifier probe", max_new_tokens=6, temperature=0.9,
                          n_branches=3,
                          branch_policy={"type": "best_of_n", "verifier": "judge.score"})
    assert r3["branches"]["verifier_used"] is False
    assert r3["finish_reason"] in ("stop", "length")
    with pytest.raises(ValueError, match="response_schema"):
        backend.generate(prompt="x", n_branches=2, response_schema={"type": "boolean"})
    with pytest.raises(ValueError, match="n_branches"):
        backend.generate(prompt="x", n_branches=0)
    assert _idle(backend) and not backend._groups and not backend._group_sinks


def test_node_group_stream_winner_only(backend):
    rid, q, _ = backend.submit_stream(prompt="stream winner probe", max_new_tokens=6,
                                   temperature=0.9, n_branches=3)
    evs = []
    while True:
        ev = q.get(timeout=60)
        evs.append(ev)
        if ev.finished:
            break
    # one stream under the parent id: contiguous indexes from 0, one terminal
    assert all(e.request_id == rid for e in evs)
    content = [e for e in evs if e.token >= 0]
    assert [e.index for e in content] == list(range(len(content)))
    assert sum(e.finished for e in evs) == 1
    meta = backend.pop_group_meta(rid)
    assert meta and meta["n"] == 3 and backend.pop_group_meta(rid) is None
    assert _idle(backend)


def test_node_stream_release_cancels_the_request(backend):
    """A plain stream carries the request's own events; a consumer that
    goes away (``release_stream``) cancels it and its pages return."""
    rid, q, _ = backend.submit_stream(prompt="plain stream probe", max_new_tokens=40)
    first = q.get(timeout=60)
    assert first.request_id == rid and first.index == 0 and first.token >= 0
    backend.release_stream(rid)
    assert _idle(backend) and rid not in backend._streams


def test_node_caller_giving_up_frees_every_branch(backend):
    with pytest.raises(TimeoutError):
        backend.generate(prompt="cancel me whole group", max_new_tokens=40, temperature=0.9,
                         n_branches=3, timeout=0.05)
    assert _idle(backend), "pages of the abandoned branches did not return"
    assert not backend._groups and not backend._group_sinks


def test_smoke_fork_phase_rehearses_on_cpu(weights):
    """``chip_smoke.phase_fork`` end to end on the CPU at a small size
    (llama-tiny, a 40-token prompt, 4 branches): best-of-N against separate
    requests, branch 0's first token and logprob equal to the unforked
    request's, a beam over HTTP with live re-forks, forked tails bit-equal to
    their parent's, one terminal per branch, no page leaked."""
    import chip_smoke

    results = {}
    chip_smoke.phase_fork(results, {"params": weights[2], "cfg": get_config("llama-tiny")}, 0,
                          device="cpu", prompt_len=40, max_new=12, n=4, num_pages=64)
    fork = results["fork"]
    assert fork["a_branched"]["forks"] == 3 and fork["a_branched"]["tail_copies"] == 3
    assert fork["c_greedy"]["tokens_equal_unforked"]  # float32: no near-tie flips
    assert fork["d_beam"]["pruned"] >= 1 and fork["d_beam"]["forks"] > 3
