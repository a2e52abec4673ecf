"""The port's request tracing and flight recorder against the JAX package's,
on the CPU (llama-tiny, float32, the same carried weights):

- ``Tracer``, ``FlightRecorder``, ``valid_context`` and ``new_trace_id``
  driven through the call sequences of ``tests/test_tracing.py``: the same
  results from both modules;
- the same traced request script through the JAX engine and the port's
  engine: the same span names, in the same order, with the same attrs
  (durations and wall-clock starts aside) for a plain request beside an
  untraced one, a seeded ``engine.preempt_storm`` (an ``engine.park`` span
  and two prefills), a branch group with a pruned branch (``engine.fork``
  spans), a cancelled and a deadline-shed request;
- the flight recorder's rows: the JAX key set, and the same rows (times
  aside) through classic and mixed ticks.
"""

from __future__ import annotations

import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from agentfield_tpu import tracing as jax_tracing
from agentfield_tpu.branching import branch_rid
from agentfield_tpu.control_plane import faults as jax_faults
from agentfield_tpu.models import configs as jax_configs
from agentfield_tpu.models import llama as jax_llama
from agentfield_tpu.serving import engine as jax_engine
from agentfield_tpu.serving.sampler import SamplingParams as JaxSampling
from agentfield_tpu_torch import tracing
from agentfield_tpu_torch.models.configs import get_config
from agentfield_tpu_torch.models.convert import params_from_numpy
from agentfield_tpu_torch.serving import engine
from agentfield_tpu_torch.serving import faults
from agentfield_tpu_torch.serving.sampler import SamplingParams

V = 512
ECFG = dict(max_batch=4, page_size=8, num_pages=64, max_pages_per_seq=8)
# the keys of a JAX flight row (agentfield_tpu/serving/engine.py step())
FLIGHT_KEYS = {"t", "mode", "dur_ms", "active", "pending", "jobs", "events", "finished",
               "tokens", "free_pages", "host_pages", "preemptions_total",
               "shed_pending_deadline_total", "deadline_exceeded"}
ERROR_KEYS = {"t", "mode", "error", "dur_ms", "active", "pending", "jobs", "free_pages"}
PAIRS = ((jax_engine, jax_tracing, jax_faults), (engine, tracing, faults))


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


def _make(weights, mod, **over):
    jcfg, tree, params = weights
    ecfg = ECFG | over
    if mod is jax_engine:
        return jax_engine.InferenceEngine(tree, jcfg, jax_engine.EngineConfig(**ecfg))
    return engine.InferenceEngine(params, get_config("llama-tiny"), engine.EngineConfig(**ecfg))


def _req(mod, rid, prompt, max_new, temperature=0.0, **kw):
    samp = JaxSampling if mod is jax_engine else SamplingParams
    return mod.Request(id=rid, prompt=prompt,
                       sampling=samp(max_new_tokens=max_new, temperature=temperature), **kw)


def _prompt(seed: int, n: int) -> list[int]:
    return np.random.default_rng(seed).integers(0, V, n).tolist()


def _ctx(tid: str) -> dict:
    return {"trace_id": tid, "attempt": 1, "node": "n1"}


def _shape(spans: list[dict]) -> list[tuple]:
    """A trace without its clocks: (name, attrs) in record order."""
    for s in spans:
        assert set(s) <= {"name", "t0", "dur_ms", "attrs"}, s
        assert s["dur_ms"] >= 0.0 and s["t0"] > 1e9
    return [(s["name"], s.get("attrs")) for s in spans]


def _step_until(eng, done, limit=400) -> list:
    evs = []
    for _ in range(limit):
        evs += eng.step()
        if done(evs):
            return evs
    raise AssertionError("the script did not finish")


def _drain(eng) -> list:
    evs = []
    t0 = time.monotonic()
    while eng.has_work():
        assert time.monotonic() - t0 < 120, "engine wedged"
        evs += eng.step()
    return evs


# -- the module's primitives, call for call -----------------------------------


def _tracer_script(tr) -> dict:
    t = tr.Tracer(max_spans=6)
    for tid in ("tr_a", "tr_b", "tr_c"):
        for i in range(2):
            t.record_span("engine.decode", tid, float(i), 1.0)
    out = {"count": t.span_count()}
    t.record_span("engine.decode", "tr_d", 0.0, 1.0, {"finish": "stop"})
    out.update(a=t.pop("tr_a"), b=t.pop("tr_b"), dropped=t.dropped_spans,
               d=t.pop("tr_d"), count_after=t.span_count())
    t2 = tr.Tracer(max_spans=10_000)
    for i in range(tr._MAX_SPANS_PER_TRACE + 5):
        t2.record_span("engine.decode", "tr_big", float(i), 1.0)
    out["big"] = len(t2.pop("tr_big"))
    out["big_dropped"] = t2.dropped_spans
    t2.record_span("engine.decode", None, 0.0, 1.0)
    out["none_count"] = t2.span_count()
    out["span"] = tr.make_span("engine.prefill", 1722772800.1234567, 14.23456, {"tokens": 3})
    out["bare_span"] = tr.make_span("engine.fork", 5.0, 0.0)
    return out


def test_tracer_matches_jax():
    ours, theirs = _tracer_script(tracing), _tracer_script(jax_tracing)
    assert ours == theirs
    assert ours["a"] == [] and len(ours["b"]) == 2 and ours["dropped"] == 2
    assert ours["big"] == tracing._MAX_SPANS_PER_TRACE == 512


def _flight_script(tr) -> dict:
    fr = tr.FlightRecorder(max_ticks=4)
    for i in range(9):
        fr.record({"i": i})
    return {"all": fr.snapshot(), "last2": fr.snapshot(last=2), "n": fr.ticks_recorded,
            "max": fr.max_ticks}


def test_flight_recorder_matches_jax():
    assert _flight_script(tracing) == _flight_script(jax_tracing)
    assert [r["i"] for r in _flight_script(tracing)["all"]] == [5, 6, 7, 8]


def test_env_knobs_match_jax(monkeypatch):
    monkeypatch.setenv("AGENTFIELD_TRACE_BUFFER_SPANS", "77")
    monkeypatch.setenv("AGENTFIELD_FLIGHT_TICKS", "9")
    assert tracing.Tracer().max_spans == jax_tracing.Tracer().max_spans == 77
    assert tracing.FlightRecorder().max_ticks == jax_tracing.FlightRecorder().max_ticks == 9
    monkeypatch.setenv("AGENTFIELD_FLIGHT_TICKS", "nonsense")
    assert tracing.FlightRecorder().max_ticks == jax_tracing.FlightRecorder().max_ticks == 512


CONTEXTS = [{"trace_id": "tr_1", "attempt": 2}, {"trace_id": 7}, "tr_1", None,
            {"trace_id": "tr_x", "node": "n"}, {}, ["trace_id"]]


@pytest.mark.parametrize("ctx", CONTEXTS, ids=repr)
def test_valid_context_matches_jax(ctx):
    assert tracing.valid_context(ctx) == jax_tracing.valid_context(ctx)


def test_new_trace_id_has_the_jax_form():
    ours, theirs = tracing.new_trace_id(), jax_tracing.new_trace_id()
    assert ours != tracing.new_trace_id()
    assert ours[:3] == theirs[:3] == "tr_" and len(ours) == len(theirs) == 23
    int(ours[3:], 16)


# -- engine spans: the same script through both engines -----------------------


def _both(weights, script, tids, **over) -> list:
    """``script(mod, eng)`` on a JAX and a port engine; each trace's spans
    (popped from the module's tracer) must have the same shape."""
    out = []
    for mod, tr, _ in PAIRS:
        eng = _make(weights, mod, **over)
        try:
            script(mod, eng)
            out.append({tid: _shape(tr.tracer().pop(tid)) for tid in tids})
            assert not eng._traces, "an open trace entry outlived its request"
        finally:
            eng.close()
    assert out[1] == out[0]
    return out[1]


def test_plain_requests_spans_match_jax(weights):
    """Two traced requests (one cut short by its stop token, one by its
    length) queue behind an untraced one in a one-slot engine."""
    def script(mod, eng):
        eng.submit(_req(mod, "untraced", _prompt(1, 11), 4))
        eng.submit(_req(mod, "a", _prompt(2, 13), 6, trace=_ctx("tr_a")))
        eng.submit(_req(mod, "b", _prompt(3, 9), 5, trace=_ctx("tr_b")))
        _drain(eng)

    got = _both(weights, script, ("tr_a", "tr_b"), max_batch=1)
    for tid, n_prompt, n_new in (("tr_a", 13, 6), ("tr_b", 9, 5)):
        assert got[tid] == [("engine.queue_wait", None),
                            ("engine.prefill", {"tokens": n_prompt, "cached": 0}),
                            ("engine.decode", {"finish": "length", "tokens": n_new})]


def test_preempt_storm_spans_match_jax(weights):
    """``tests/test_tracing.py``'s preempt script: the victim's trace holds
    two decode segments (the first ``preempted``) bridged by ``engine.park``,
    and two prefills."""
    def script(mod, eng):
        f = dict(zip((jax_engine, engine), (jax_faults, faults)))[mod]
        f.install(f.FaultInjector(seed=3, spec={"engine.preempt_storm": {"times": 1}}))
        try:
            eng.submit(_req(mod, "victim", list(range(12)), 10, trace=_ctx("tr_preempt")))
            evs = _step_until(eng, lambda e: any(x.request_id == "victim" for x in e))
            eng.submit(_req(mod, "rival", list(range(20, 30)), 3, trace=_ctx("tr_rival")))
            evs += _step_until(eng, lambda e: {"victim", "rival"} <= {
                x.request_id for x in e if x.finished})
        finally:
            f.install(None)
        assert eng.stats["preemptions_total"] == 1
        idx = [e.index for e in evs if e.request_id == "victim"]
        assert idx == list(range(10))

    got = _both(weights, script, ("tr_preempt", "tr_rival"), max_batch=1,
                preempt_fence_ticks=4)
    names = [n for n, _ in got["tr_preempt"]]
    assert names.count("engine.prefill") == 2 and "engine.park" in names
    decodes = [a for n, a in got["tr_preempt"] if n == "engine.decode"]
    assert decodes[0]["finish"] == "preempted" and decodes[1]["finish"] == "length"
    assert sum(d["tokens"] for d in decodes) == 10


def test_branch_group_spans_match_jax(weights):
    """``tests/test_tracing.py``'s branch script: three branches under one
    trace, two ``engine.fork`` spans, the pruned branch closed
    ``cancelled``."""
    pruned = branch_rid("grp", 2)

    def script(mod, eng):
        eng.submit(_req(mod, "grp", list(range(12)), 8, temperature=0.8, n_branches=3,
                        trace=_ctx("tr_branch")))
        cancelled = False
        evs: list = []
        for _ in range(400):
            evs += eng.step()
            if not cancelled and any(e.request_id == pruned and e.index >= 1 for e in evs):
                eng.request_cancel(pruned)
                cancelled = True
            if cancelled and not eng.has_work():
                break
        assert cancelled and not eng.has_work()

    got = _both(weights, script, ("tr_branch",), num_pages=128)["tr_branch"]
    forks = [a for n, a in got if n == "engine.fork"]
    assert forks == [{"branch": branch_rid("grp", 1)}, {"branch": pruned}]
    finishes = sorted(a["finish"] for n, a in got if n == "engine.decode")
    assert finishes == ["cancelled", "length", "length"]


def test_cancel_and_deadline_spans_match_jax(weights):
    """A request cancelled mid-decode closes its decode span ``cancelled``;
    one shed by its deadline while still queued closes its queue-wait span
    ``deadline_exceeded``; ``deadline_all_now`` ends an active one."""
    def script(mod, eng):
        eng.submit(_req(mod, "long", _prompt(4, 10), 30, trace=_ctx("tr_cancel")))
        eng.submit(_req(mod, "shed", _prompt(5, 10), 4, trace=_ctx("tr_shed"),
                        deadline_s=0.001))
        _step_until(eng, lambda e: any(x.request_id == "long" and x.index >= 2 for x in e))
        time.sleep(0.01)
        eng.request_cancel("long")
        _drain(eng)
        eng.submit(_req(mod, "swept", _prompt(6, 10), 30, trace=_ctx("tr_sweep")))
        _step_until(eng, lambda e: any(x.request_id == "swept" for x in e))
        eng.deadline_all_now()
        _drain(eng)

    got = _both(weights, script, ("tr_cancel", "tr_shed", "tr_sweep"), max_batch=1)
    assert got["tr_cancel"][-1] == ("engine.decode", {"finish": "cancelled"})
    assert got["tr_shed"] == [("engine.queue_wait", {"finish": "deadline_exceeded"})]
    assert got["tr_sweep"][-1] == ("engine.decode", {"finish": "deadline_exceeded"})


def test_untraced_requests_record_nothing(weights):
    eng = _make(weights, engine)
    try:
        before = tracing.tracer().span_count()
        eng.submit(_req(engine, "x", _prompt(7, 9), 4, trace={"trace_id": 5}))
        _drain(eng)
        assert tracing.tracer().span_count() == before and not eng._traces
    finally:
        eng.close()


# -- the flight recorder ------------------------------------------------------


def _flight_rows(weights, mod, over, script) -> list[dict]:
    eng = _make(weights, mod, **over)
    try:
        script(mod, eng)
        return eng.flight.snapshot()
    finally:
        eng.close()


def _classic(mod, eng):
    for i in range(3):
        eng.submit(_req(mod, f"r{i}", _prompt(10 + i, 7 + 3 * i), 5))
    _drain(eng)


def _mixed(mod, eng):
    for i in range(2):
        eng.submit(_req(mod, f"d{i}", _prompt(20 + i, 6), 12))
    _step_until(eng, lambda e: len({x.request_id for x in e}) == 2)
    eng.submit(_req(mod, "late", _prompt(30, 40), 4))
    _drain(eng)


@pytest.mark.parametrize("name,over,script", [
    ("classic", {}, _classic),
    ("mixed", {"mixed_step": True, "mixed_step_budget": 20}, _mixed),
], ids=lambda v: v if isinstance(v, str) else "")
def test_flight_rows_match_jax(weights, name, over, script):
    rows = [_flight_rows(weights, mod, over, script) for mod in (jax_engine, engine)]
    for r in rows[1]:
        want = FLIGHT_KEYS | ({"budget_util"} if r["mode"] == "mixed" else set())
        assert set(r) == want, r
        assert r["dur_ms"] >= 0.0

    def clockless(rs):
        return [{k: v for k, v in r.items() if k not in ("t", "dur_ms")} for r in rs]

    assert clockless(rows[1]) == clockless(rows[0])
    modes = {r["mode"] for r in rows[1]}
    assert ({"prefill", "decode"} <= modes) if name == "classic" else ("mixed" in modes)


def test_failed_step_records_an_error_row(weights, monkeypatch):
    eng = _make(weights, engine)
    try:
        eng.submit(_req(engine, "x", _prompt(8, 9), 4))

        def boom():
            raise RuntimeError("injected step failure")

        monkeypatch.setattr(eng, "_step_inner", boom)
        with pytest.raises(RuntimeError, match="injected"):
            eng.step()
        row = eng.flight.snapshot(last=1)[0]
        assert set(row) == ERROR_KEYS and row["mode"] == "error"
        assert "injected step failure" in row["error"] and row["pending"] == 1
    finally:
        eng.close()
