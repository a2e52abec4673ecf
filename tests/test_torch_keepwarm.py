"""The port's agent-aware serving (keep-warm session pins and speculative
next-step prefill) against the JAX package's, on the CPU (llama-tiny,
float32, the same weights).

The engine scripts of ``tests/test_agent_serving.py`` run through both
engines, each under its own package's fault injector: a speculation hit,
a miss, a winner among two candidates, the knob off, the pin budget's
spill, page pressure shedding speculation and pins before it fails,
``spec.fail`` and ``spec.stall``, a client cancel, ``free_session``, pin
expiry and the pin's exemption from the session ttl. Tokens, the
``spec_*`` counters, the pins and ``free_pages`` must be equal, and the
JAX file's own assertions hold on the port's side. Then the node: the
hints reach the engine through ``ModelBackend.generate``, and the JAX
node's environment overrides of the engine's fields.
"""

from __future__ import annotations

import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from agentfield_tpu.control_plane import faults as jax_faults
from agentfield_tpu.models import configs as jax_configs
from agentfield_tpu.models import llama as jax_llama
from agentfield_tpu.serving import engine as jax_engine
from agentfield_tpu.serving import model_node as jax_node
from agentfield_tpu.serving.sampler import SamplingParams as JaxSampling
from agentfield_tpu_torch.models.configs import get_config
from agentfield_tpu_torch.models.convert import params_from_numpy
from agentfield_tpu_torch.serving import engine
from agentfield_tpu_torch.serving import faults
from agentfield_tpu_torch.serving import model_node
from agentfield_tpu_torch.serving.sampler import SamplingParams

ECFG = dict(max_batch=2, page_size=8, num_pages=64, max_pages_per_seq=8)
SPEC_COUNTERS = ("spec_started_total", "spec_hit_total", "spec_wasted_tokens_total",
                 "spec_cancelled_total", "session_pins_active", "spec_fail_injected",
                 "spec_stall_injected")
FAULTS = {"jax": jax_faults, "torch": faults}


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
    jcfg = jax_configs.get_config("llama-tiny")
    tree = jax.tree.map(np.asarray, jax_llama.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tree, params_from_numpy(tree, get_config("llama-tiny"), device="cpu")


@pytest.fixture(autouse=True)
def _clear_injectors():
    yield
    jax_faults.install(None)
    faults.install(None)


class Side:
    """One package's engine factory and request helpers."""

    def __init__(self, kind: str, weights):
        self.kind = kind
        self.jcfg, self.tree, self.params = weights
        self.mod = jax_engine if kind == "jax" else engine
        self.faults = FAULTS[kind]
        self.made: list = []

    def engine(self, **over):
        ecfg = self.mod.EngineConfig(**{**ECFG, **over})
        if self.kind == "jax":
            e = jax_engine.InferenceEngine(self.tree, self.jcfg, ecfg)
        else:
            e = engine.InferenceEngine(self.params, get_config("llama-tiny"), ecfg)
        self.made.append(e)
        return e

    def request(self, rid, prompt, max_new=4, **kw):
        samp = JaxSampling if self.kind == "jax" else SamplingParams
        return self.mod.Request(id=rid, prompt=prompt, sampling=samp(max_new_tokens=max_new),
                                **kw)

    def run(self, eng, rid, prompt, max_new=4, session=None, ef=False, cands=None):
        return eng.run_to_completion([self.request(rid, prompt, max_new, session_id=session,
                                                   expect_followup=ef,
                                                   followup_candidates=cands)])[rid]

    def install(self, spec):
        self.faults.install(self.faults.FaultInjector(seed=7, spec=spec))


def _prompt(seed: int, n: int) -> list[int]:
    return np.random.default_rng(seed).integers(0, 512, n).tolist()


def _state(eng) -> dict:
    with eng._session_lock:
        return {"counters": {k: eng.stats[k] for k in SPEC_COUNTERS + ("prefill_tokens",)},
                "pins": sorted(eng._pins), "spec": sorted(eng._spec_by_session),
                "stalled": len(eng._spec_stalled), "sessions": sorted(eng._sessions),
                "free_pages": eng.allocator.free_pages}


def _quiescent(eng) -> dict:
    """The terminal state every script ends in: the session freed, then
    what must be released."""
    eng.free_session("sess")
    return _state(eng)


# the scripts of tests/test_agent_serving.py (:107-352), one package each


def script_hit(s: Side) -> dict:
    t1, cand = _prompt(1, 10), _prompt(2, 9)
    eng = s.engine()
    out1 = s.run(eng, "s1", t1, session="sess", ef=True, cands=[cand])
    mid = _state(eng)
    follow = t1 + out1 + cand + _prompt(3, 2)
    out2 = s.run(eng, "s2", follow, session="sess")
    after = _state(eng)
    fresh = s.run(s.engine(), "f", follow)
    return {"out": (out1, out2, fresh), "mid": mid, "after": after, "end": _quiescent(eng)}


def script_miss(s: Side) -> dict:
    t1, cand = _prompt(1, 10), _prompt(2, 9)
    eng = s.engine()
    out1 = s.run(eng, "m1", t1, session="sess", ef=True, cands=[cand])
    wrong = t1 + out1 + _prompt(7, 6) + _prompt(3, 2)
    out2 = s.run(eng, "m2", wrong, session="sess")
    after = _state(eng)
    return {"out": (out1, out2, s.run(s.engine(), "f", wrong)), "after": after,
            "end": _quiescent(eng)}


def script_multi(s: Side) -> dict:
    t1, loser, winner = _prompt(1, 10), _prompt(11, 8), _prompt(2, 9)
    eng = s.engine()
    out1 = s.run(eng, "c1", t1, session="sess", ef=True, cands=[loser, winner])
    follow = t1 + out1 + winner + _prompt(3, 2)
    out2 = s.run(eng, "c2", follow, session="sess")
    after = _state(eng)
    return {"out": (out1, out2, s.run(s.engine(), "f", follow)), "after": after,
            "end": _quiescent(eng)}


def script_knob_off(s: Side) -> dict:
    t1, cand = _prompt(1, 10), _prompt(2, 9)
    off = s.engine(spec_prefill=False)
    out1 = s.run(off, "k1", t1, session="sess", ef=True, cands=[cand])
    out2 = s.run(off, "k2", t1 + out1 + cand + _prompt(3, 2), session="sess")
    base = s.engine()
    b1 = s.run(base, "k1", t1, session="sess")
    b2 = s.run(base, "k2", t1 + b1 + cand + _prompt(3, 2), session="sess")
    return {"out": (out1, out2, b1, b2), "off": _state(off), "base": _state(base),
            "end": _quiescent(off)}


def script_pin_budget(s: Side) -> dict:
    eng = s.engine(spec_pin_budget=1)
    s.run(eng, "a1", _prompt(1, 10), session="a", ef=True, cands=[_prompt(2, 9)])
    first = _state(eng)
    s.run(eng, "b1", _prompt(4, 10), session="b", ef=True, cands=[_prompt(5, 9)])
    second = _state(eng)
    eng.free_session("a")
    eng.free_session("b")
    return {"first": first, "second": second, "end": _state(eng)}


def script_page_pressure(s: Side) -> dict:
    eng = s.engine(num_pages=9, max_pages_per_seq=8)  # 8 allocatable pages
    s.run(eng, "a", _prompt(6, 8), session="hog", ef=True, cands=[_prompt(2, 6)])
    mid = _state(eng)
    out = s.run(eng, "b", _prompt(7, 50), max_new=8)
    return {"out": out, "mid": mid, "end": _state(eng)}


def script_spec_fail(s: Side) -> dict:
    t1, cand = _prompt(1, 10), _prompt(2, 9)
    s.install({"spec.fail": {}})
    eng = s.engine()
    out1 = s.run(eng, "s1", t1, session="sess", ef=True, cands=[cand])
    mid = _state(eng)
    follow = t1 + out1 + cand + _prompt(3, 2)
    out2 = s.run(eng, "s2", follow, session="sess")
    after = _state(eng)
    s.faults.install(None)
    return {"out": (out1, out2, s.run(s.engine(), "f", follow)), "mid": mid, "after": after,
            "end": _quiescent(eng)}


def script_spec_stall(s: Side) -> dict:
    t1, cand = _prompt(1, 10), _prompt(2, 9)
    s.install({"spec.stall": {"delay_s": 30.0}})
    eng = s.engine()
    eng.submit(s.request("s1", t1, session_id="sess", expect_followup=True,
                         followup_candidates=[cand]))
    out1: list[int] = []
    while len(out1) < 4:  # only until s1 finishes: the jobs stay deferred
        out1 += [ev.token for ev in eng.step() if ev.request_id == "s1" and ev.token >= 0]
    mid = _state(eng)
    follow = t1 + out1 + cand + _prompt(3, 2)
    out2 = s.run(eng, "s2", follow, session="sess")
    after = _state(eng)
    s.faults.install(None)
    return {"out": (out1, out2, s.run(s.engine(), "f", follow)), "mid": mid, "after": after,
            "end": _quiescent(eng)}


def script_client_cancel(s: Side) -> dict:
    t1, cand = _prompt(1, 10), _prompt(2, 9)
    eng = s.engine()
    out1 = s.run(eng, "s1", t1, session="sess", ef=True, cands=[cand])
    mid = _state(eng)
    eng.submit(s.request("s2", t1 + out1 + cand + _prompt(3, 2), session_id="sess"))
    eng.request_cancel("s2")  # the client is gone before admission
    while eng.has_work():
        eng.step()
    return {"out": out1, "mid": mid, "after": _state(eng), "end": _quiescent(eng)}


def script_free_session(s: Side) -> dict:
    eng = s.engine()
    s.run(eng, "s1", _prompt(1, 10), session="sess", ef=True, cands=[_prompt(2, 9)])
    mid = _state(eng)
    eng.free_session("sess")
    return {"mid": mid, "end": _state(eng)}


def script_pin_ttl(s: Side) -> dict:
    eng = s.engine(spec_pin_ttl=0.001, session_ttl=0.001)
    s.run(eng, "g1", _prompt(1, 10), session="sess", ef=True, cands=[_prompt(2, 9)])
    mid = _state(eng)
    time.sleep(0.05)
    eng.gc_sessions()
    return {"mid": mid, "end": _state(eng)}


def script_pin_exempts_gc(s: Side) -> dict:
    eng = s.engine(session_ttl=0.001, spec_pin_ttl=120.0)
    s.run(eng, "g1", _prompt(1, 10), session="sess", ef=True)
    time.sleep(0.05)
    eng.gc_sessions()
    return {"pinned": _state(eng), "end": _quiescent(eng)}


SCRIPTS = [script_hit, script_miss, script_multi, script_knob_off, script_pin_budget,
           script_page_pressure, script_spec_fail, script_spec_stall, script_client_cancel,
           script_free_session, script_pin_ttl, script_pin_exempts_gc]


@pytest.fixture
def sides(weights):
    made = [Side("jax", weights), Side("torch", weights)]
    yield made
    for s in made:
        for e in s.made:
            e.close()


@pytest.mark.parametrize("script", SCRIPTS, ids=[f.__name__[7:] for f in SCRIPTS])
def test_agent_serving_script_matches_jax(sides, script):
    j, t = (script(s) for s in sides)
    assert t == j
    # the JAX file's own assertions, on the port's side
    base_free = ECFG["num_pages"] - 1
    if "end" in t and script is not script_page_pressure:
        end = t["end"]
        assert end["pins"] == [] and end["spec"] == [] and end["stalled"] == 0
        if script is not script_pin_budget:
            assert end["free_pages"] == base_free
    c = {k: v for k, v in t.get("after", {}).get("counters", {}).items()}
    if script is script_hit:
        assert t["mid"]["counters"]["spec_started_total"] == 1 and t["mid"]["pins"] == ["sess"]
        assert c["spec_hit_total"] == 1 and c["spec_wasted_tokens_total"] == 0
        assert c["session_pins_active"] == 0
        assert c["prefill_tokens"] - t["mid"]["counters"]["prefill_tokens"] < 9 + 2 + 1
        assert t["out"][1] == t["out"][2], "the hit path diverged from a fresh engine"
    elif script is script_miss:
        assert (c["spec_hit_total"], c["spec_wasted_tokens_total"],
                c["spec_cancelled_total"]) == (0, 9, 1)
        assert t["out"][1] == t["out"][2]
    elif script is script_multi:
        assert (c["spec_started_total"], c["spec_hit_total"],
                c["spec_wasted_tokens_total"]) == (2, 1, 8)
        assert t["out"][1] == t["out"][2]
    elif script is script_knob_off:
        assert t["out"][:2] == t["out"][2:]
        assert t["off"]["counters"]["prefill_tokens"] == t["base"]["counters"]["prefill_tokens"]
        assert t["off"]["counters"]["spec_started_total"] == 0 and t["off"]["pins"] == []
    elif script is script_pin_budget:
        assert t["first"]["pins"] == ["a"] and t["second"]["pins"] == ["b"]
        assert "a" not in t["second"]["spec"] and t["end"]["free_pages"] == base_free
    elif script is script_page_pressure:
        assert t["mid"]["pins"] == ["hog"] and len(t["out"]) == 8
        assert t["end"]["pins"] == [] and t["end"]["spec"] == [] and t["end"]["sessions"] == []
    elif script is script_spec_fail:
        assert t["mid"]["counters"]["spec_started_total"] == 0
        assert t["mid"]["counters"]["spec_fail_injected"] == 1 and t["mid"]["pins"] == ["sess"]
        assert c["spec_hit_total"] == 0 and c["session_pins_active"] == 0
        assert t["out"][1] == t["out"][2]
    elif script is script_spec_stall:
        assert t["mid"]["stalled"] == 1 and t["mid"]["counters"]["spec_started_total"] == 1
        assert c["spec_hit_total"] == 0 and c["spec_cancelled_total"] == 1 and \
            t["after"]["stalled"] == 0
        assert t["out"][1] == t["out"][2]
    elif script is script_client_cancel:
        assert t["mid"]["pins"] == ["sess"] and t["mid"]["spec"] == ["sess"]
        assert t["after"]["pins"] == [] and t["after"]["spec"] == []
    elif script is script_free_session:
        assert t["mid"]["counters"]["session_pins_active"] == 1
        assert t["end"]["counters"]["spec_cancelled_total"] == 1
    elif script is script_pin_ttl:
        assert t["mid"]["counters"]["session_pins_active"] == 1
        assert t["end"]["counters"]["session_pins_active"] == 0 and t["end"]["sessions"] == []
        assert t["end"]["free_pages"] == base_free
    elif script is script_pin_exempts_gc:
        assert t["pinned"]["sessions"] == ["sess"]


def test_spec_counters_always_present(weights):
    s = Side("torch", weights)
    eng = s.engine()
    for name in SPEC_COUNTERS:
        assert eng.stats[name] == 0, name
    eng.close()


def test_spec_priority_is_the_jax_engines():
    assert engine._SPEC_PRIORITY == jax_engine._SPEC_PRIORITY
    assert (engine._HANDOFF_TTL_S, engine._HANDOFF_STASH_MAX) == (
        jax_engine._HANDOFF_TTL_S, jax_engine._HANDOFF_STASH_MAX)


# ---------------------------------------------------------------------------
# the node


def test_node_hints_reach_the_engine(weights):
    """``generate(expect_followup=, followup_candidates=)`` pins the session
    and prefills the candidates (strings through the tokenizer, token
    lists as they are, past ``spec_max_candidates`` dropped); the follow-up
    absorbs the first."""
    _, _, params = weights
    back = model_node.ModelBackend(params, get_config("llama-tiny"),
                                   engine.EngineConfig(**ECFG, spec_max_candidates=2),
                                   tokenizer=model_node.ByteTokenizer(512), device="cpu")
    back.start()
    try:
        first = back.generate(prompt="plan the next step", max_new_tokens=4, session_id="agent",
                              expect_followup=True,
                              followup_candidates=["tool says yes", [5, 6, 7], "never used"])
        eng = back.engine
        assert eng.stats["spec_started_total"] == 2 and sorted(eng._pins) == ["agent"]
        for _ in range(500):
            if not eng.has_work():
                break
            time.sleep(0.01)
        toks = back.tokenizer.encode("plan the next step") + first["tokens"]
        back.generate(tokens=toks + back.tokenizer.encode("tool says yes") + [9], max_new_tokens=4,
                      session_id="agent")
        assert eng.stats["spec_hit_total"] == 1 and eng._pins == {}
        assert eng.stats["spec_wasted_tokens_total"] == 3
        eng.free_session("agent")
        assert eng.allocator.free_pages == ECFG["num_pages"] - 1
    finally:
        back.stop()


@pytest.mark.parametrize("env,field,want", [
    ({"AGENTFIELD_SPEC_PREFILL": "0"}, "spec_prefill", False),
    ({"AGENTFIELD_SPEC_PIN_TTL_S": "7.5"}, "spec_pin_ttl", 7.5),
    ({"AGENTFIELD_SPEC_PIN_BUDGET": "3"}, "spec_pin_budget", 3),
    ({"AGENTFIELD_SPEC_MAX_CANDIDATES": "1"}, "spec_max_candidates", 1),
    ({"AGENTFIELD_PREFIX_SKETCH_BYTES": "0"}, "prefix_sketch_bytes", 0),
    ({"AGENTFIELD_SPEC_PIN_BUDGET": "lots"}, "spec_pin_budget", 32),  # malformed: kept
])
def test_node_env_overrides_match_jax(weights, monkeypatch, env, field, want):
    jcfg, tree, params = weights
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _, jback = jax_node.build_model_node("envy", "http://127.0.0.1:9", model="llama-tiny",
                                         params=tree, ecfg=jax_engine.EngineConfig(**ECFG))
    server, back = model_node.build_model_node("llama-tiny", params=params, device="cpu",
                                               ecfg=engine.EngineConfig(**ECFG))
    try:
        assert getattr(back.engine.ecfg, field) == getattr(jback.engine.ecfg, field) == want
    finally:
        jback.engine.close()
        back.engine.close()
