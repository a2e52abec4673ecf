"""The port's overload control against the JAX engine's, on the CPU, with the
same carried weights (llama-tiny, float32): priority admission, preempt-and-
resume on the shared-prefix cache (classic and mixed ticks), pending-deadline
shedding, deadlines of active requests, ``deadline_all_now`` and cancel
accounting. The submission scripts are those of ``tests/test_overload.py``
and ``tests/test_engine_deadlines.py``; each runs through both engines,
which must give the same greedy tokens, the same finish reasons, the same
``OVERLOAD_KEYS`` counters and the same ``free_pages`` at the end."""

from __future__ import annotations

import dataclasses
import time

import jax
import numpy as np
import pytest

from agentfield_tpu.models import configs as jax_configs
from agentfield_tpu.models import llama as jax_llama
from agentfield_tpu.serving import engine as jax_engine
from agentfield_tpu.serving.sampler import SamplingParams as JaxSampling
from agentfield_tpu_torch.models.configs import get_config
from agentfield_tpu_torch.models.convert import params_from_numpy
from agentfield_tpu_torch.serving import engine
from agentfield_tpu_torch.serving.sampler import SamplingParams

ECFG = dict(max_batch=4, page_size=8, num_pages=64, max_pages_per_seq=8)
# 6 usable pages: a 12-prompt/24-new victim holds 5, so a 12-prompt/8-new
# rival (3 pages) is page-starved while the victim runs
TIGHT = dict(max_batch=4, page_size=8, num_pages=7, max_pages_per_seq=6, preempt_fence_ticks=2)
MIXED = dict(mixed_step=True, mixed_step_budget=20)
OVERLOAD_KEYS = (
    "preemptions_total", "resume_prefix_hits_total", "requests_cancelled", "cancels_unknown",
    "deadline_exceeded", "shed_pending_deadline_total", "mixed_ticks", "mixed_tokens",
    "admission_reorders", "requests_finished", "decode_steps", "prefill_tokens",
)
V = 512


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jax_configs.get_config("llama-tiny"), dtype="float32")
    tree = jax.tree.map(np.asarray, jax_llama.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tree, params_from_numpy(tree, get_config("llama-tiny"), device="cpu")


def _prompt(seed: int, n: int) -> list[int]:
    return np.random.default_rng(seed).integers(0, V, n).tolist()


def _make(weights, mod, ecfg):
    jcfg, tree, params = weights
    if mod is jax_engine:
        return jax_engine.InferenceEngine(tree, jcfg, jax_engine.EngineConfig(**ecfg))
    return engine.InferenceEngine(params, get_config("llama-tiny"), engine.EngineConfig(**ecfg))


def _req(mod, rid, prompt, max_new=8, **kw):
    samp = JaxSampling if mod is jax_engine else SamplingParams
    return mod.Request(id=rid, prompt=prompt, sampling=samp(max_new_tokens=max_new), **kw)


class Run:
    """One engine plus what its events said: tokens and terminal events per
    request id."""

    def __init__(self, weights, mod, ecfg):
        self.mod, self.eng = mod, _make(weights, mod, ecfg)
        self.tokens: dict[str, list[int]] = {}
        self.finals: dict[str, list[tuple[str, int, int]]] = {}

    def submit(self, rid, prompt, max_new=8, **kw):
        self.eng.submit(_req(self.mod, rid, prompt, max_new, **kw))

    def step(self):
        evs = self.eng.step()
        for ev in evs:
            if ev.token >= 0:
                self.tokens.setdefault(ev.request_id, []).append(ev.token)
            if ev.finished:
                self.finals.setdefault(ev.request_id, []).append(
                    (ev.finish_reason, ev.token, ev.index))
        return evs

    def drain(self):
        t0 = time.monotonic()
        while self.eng.has_work():
            assert time.monotonic() - t0 < 120, "engine wedged"
            self.step()
        return self


def _both(weights, ecfg, script):
    """``script(run)`` on a JAX run and a port run; both must agree."""
    runs = [Run(weights, mod, ecfg) for mod in (jax_engine, engine)]
    for r in runs:
        script(r)
    j, t = runs
    assert t.tokens == j.tokens
    assert t.finals == j.finals
    for k in OVERLOAD_KEYS:
        assert t.eng.stats[k] == j.eng.stats[k], k
    assert t.eng.allocator.free_pages == j.eng.allocator.free_pages
    return t


def test_priority_admits_first(weights):
    """Four priority-1 requests submitted behind four defaults move to the
    queue head and take the whole first admission batch."""
    def script(r):
        for i in range(4):
            r.submit(f"lo{i}", _prompt(i, 5), 4)
        for i in range(4):
            r.submit(f"hi{i}", _prompt(10 + i, 5), 4, priority=1)
        assert [q.id for q in r.eng.pending] == [f"hi{i}" for i in range(4)] + [
            f"lo{i}" for i in range(4)]
        assert {ev.request_id for ev in r.step()} == {f"hi{i}" for i in range(4)}
        r.drain()

    t = _both(weights, ECFG, script)
    assert all(len(v) == 4 for v in t.tokens.values()) and len(t.tokens) == 8


def test_flat_priority_is_fifo(weights):
    def script(r):
        for i in range(6):
            r.submit(f"r{i}", _prompt(i, 5), 4)
        r.drain()

    t = _both(weights, ECFG, script)
    assert t.eng.stats["admission_reorders"] == 0 and t.eng.stats["preemptions_total"] == 0


def test_submit_rejects_bad_priority_and_deadline(weights):
    eng = _make(weights, engine, ECFG)
    for bad in (True, "high", 1.5):
        with pytest.raises(ValueError, match="priority"):
            eng.submit(_req(engine, "bad", _prompt(0, 5), priority=bad))
    for bad in (0.0, -1.0, float("nan"), float("inf")):
        with pytest.raises(ValueError, match="deadline_s"):
            eng.submit(_req(engine, "bad", _prompt(0, 5), deadline_s=bad))
    assert not eng.pending


def _preempt_script(r):
    r.submit("victim", _prompt(0, 12), 24)
    r.step()  # the victim admits
    r.submit("rival", _prompt(1, 12), 8, priority=1)
    r.drain()


@pytest.mark.parametrize("mixed", [False, True], ids=["classic", "mixed"])
def test_preempt_resume_token_exact(weights, mixed):
    """A page-starved priority-1 rival preempts the victim past the fence;
    the victim resumes through a prefix hit and its tokens equal an
    unpreempted run's; one terminal event each, the victim's index
    continuous across incarnations."""
    ecfg = dict(TIGHT, **MIXED) if mixed else TIGHT
    t = _both(weights, ecfg, _preempt_script)
    assert t.eng.stats["preemptions_total"] >= 1
    assert t.eng.stats["resume_prefix_hits_total"] >= 1
    alone = _make(weights, engine, ecfg)
    assert t.tokens["victim"] == alone.run_to_completion(
        [_req(engine, "victim", _prompt(0, 12), 24)])["victim"]
    assert t.finals["victim"] == [("length", t.tokens["victim"][-1], 23)]
    assert [f[0] for f in t.finals["rival"]] == ["length"]
    assert t.eng.allocator.free_pages == TIGHT["num_pages"] - 1
    assert not t.eng._deadline_at and not t.eng.pending


def test_zero_fence_disables_preemption(weights):
    t = _both(weights, dict(TIGHT, preempt_fence_ticks=0), _preempt_script)
    assert t.eng.stats["preemptions_total"] == 0
    assert len(t.tokens["victim"]) == 24 and len(t.tokens["rival"]) == 8


def test_preempt_fires_when_candidate_prefix_is_cached(weights):
    """A rival whose prefix sits refcount-0 on the LRU still ages the fence
    (the probe subtracts that overlap from the free pages)."""
    warm = _prompt(5, 16)

    def script(r):
        r.submit("warm", warm, 8)
        r.drain()
        r.submit("victim", _prompt(0, 12), 24)
        r.step()
        r.submit("rival", warm + _prompt(6, 1), 16, priority=1)
        r.drain()

    t = _both(weights, dict(TIGHT, num_pages=9), script)
    assert t.eng.stats["preemptions_total"] >= 1 and t.eng.stats["resume_prefix_hits_total"] >= 1
    assert len(t.tokens["rival"]) == 16 and len(t.tokens["victim"]) == 24


def test_preempt_fence_is_per_head(weights):
    """A new head does not inherit the starved ticks of a cancelled one."""
    def script(r):
        r.submit("victim", _prompt(0, 12), 24)
        r.step()
        r.submit("rivalA", _prompt(1, 12), 8, priority=1)
        r.step()
        r.step()
        r.eng.request_cancel("rivalA")
        r.step()
        r.submit("rivalB", _prompt(2, 12), 8, priority=1)
        r.step()
        assert r.eng.stats["preemptions_total"] == 0
        r.drain()

    t = _both(weights, dict(TIGHT, preempt_fence_ticks=3), script)
    assert t.eng.stats["preemptions_total"] >= 1 and len(t.tokens["rivalB"]) == 8


def test_pending_deadline_shed_exactly_once(weights):
    """A request expiring while every slot is busy sheds from the queue with
    one deadline_exceeded terminal (token -1) and never produces a token."""
    def script(r):
        for i in range(4):
            r.submit(f"busy{i}", _prompt(i, 5), 48)
        r.step()
        r.submit("shed", _prompt(9, 5), 4, deadline_s=0.01)
        time.sleep(0.03)
        r.drain()

    t = _both(weights, ECFG, script)
    assert "shed" not in t.tokens and t.finals["shed"] == [("deadline_exceeded", -1, -1)]
    assert t.eng.stats["shed_pending_deadline_total"] == 1 and t.eng.stats["deadline_exceeded"] == 1
    assert "shed" not in t.eng._deadline_at and "shed" not in t.eng._req_hashes


def test_pending_cancel_drops_bookkeeping(weights):
    def script(r):
        r.submit("big", _prompt(0, 12), 24)
        r.step()
        r.submit("starved", _prompt(1, 12), 8, deadline_s=30.0)
        for _ in range(3):
            r.step()
        assert "starved" in r.eng._req_hashes and "starved" in r.eng._deadline_at
        r.eng.request_cancel("starved")
        r.step()
        assert "starved" not in r.eng._req_hashes and "starved" not in r.eng._deadline_at
        r.drain()

    t = _both(weights, TIGHT, script)
    assert "starved" not in t.finals and len(t.tokens["big"]) == 24


@pytest.mark.parametrize("mixed", [False, True], ids=["classic", "mixed"])
def test_deadline_expires_active_request(weights, mixed):
    """A decoding request past its deadline ends with deadline_exceeded; its
    pages free; an undeadlined peer completes."""
    def script(r):
        r.submit("dl", _prompt(0, 5), 48, deadline_s=0.001)
        r.submit("ok", _prompt(1, 5), 4)
        time.sleep(0.01)
        r.drain()

    t = _both(weights, dict(ECFG, **MIXED) if mixed else ECFG, script)
    assert t.finals["dl"] == [("deadline_exceeded", -1, -1)]
    assert [f[0] for f in t.finals["ok"]] == ["length"]
    assert t.eng.allocator.free_pages == ECFG["num_pages"] - 1 and not t.eng._deadline_at


@pytest.mark.parametrize("mixed", [False, True], ids=["classic", "mixed"])
def test_deadline_all_now_ends_everything(weights, mixed):
    """The drain sweep ends pending, mid-prefill and active requests, each
    with one deadline_exceeded terminal; every page returns."""
    def script(r):
        for i in range(3):
            r.submit(f"r{i}", _prompt(i, 5), 48)
        r.step()
        if mixed:
            r.step()
            r.submit("long", _prompt(7, 50), 4)  # 50 > budget: mid-prefill
            r.step()
        assert r.eng.deadline_all_now() == (4 if mixed else 3)
        r.drain()

    t = _both(weights, dict(ECFG, **MIXED) if mixed else ECFG, script)
    ids = [f"r{i}" for i in range(3)] + (["long"] if mixed else [])
    assert {k: [f[0] for f in v] for k, v in t.finals.items()} == {
        i: ["deadline_exceeded"] for i in ids}
    assert t.eng.allocator.free_pages == ECFG["num_pages"] - 1


def test_cancels_unknown_counted(weights):
    def script(r):
        r.eng.request_cancel("ghost")  # never submitted
        r.step()
        assert r.eng.stats["cancels_unknown"] == 1
        r.submit("done", _prompt(2, 5), 2)
        r.drain()
        r.eng.request_cancel("done")  # already finished
        r.step()
        r.submit("pend", _prompt(3, 5), 4)
        r.eng.request_cancel("pend")  # a real cancel of a pending request
        r.step()
        r.drain()

    t = _both(weights, ECFG, script)
    assert t.eng.stats["cancels_unknown"] == 2 and t.eng.stats["requests_cancelled"] == 1
