"""The branch verifier on the port's model node, on the CPU.

``ai(n_branches=N, branch_policy={"verifier": "judge.x"})``: the node forks
the request into N branches, and once they settle sends the candidates'
texts to the verifier reasoner through the control plane; its verdict picks
the winner, and any failure leaves the best cumulative logprob.

- ``ModelBackend._parse_verdict`` equals the JAX node's on every verdict
  shape (hypothesis);
- the port's node (in-process) behind the port's control plane, with port
  ``Agent``s for the caller and the judges: the winner is the judge's pick
  among the texts it got, the payload is the JAX node's (``task``,
  ``candidates``, ``scores`` best first), ``branch_verifier_calls_total``
  counts each call, a failing, a missing and a malformed judge leave the
  logprob winner, a judge that calls ``ai()`` on the same node completes,
  and no page leaks;
- the same script through the JAX node (the JAX CLI's ``model --cpu``, one
  child process) and the JAX control plane (``CPHarness``) with JAX agents
  gives the same ``verifier_used``, the same verdict indexes and the same
  counter.
"""

from __future__ import annotations

import asyncio
import json
import os
import pathlib
import re
import signal
import subprocess
import sys
import threading
import time

import aiohttp
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from agentfield_tpu.sdk import agent as jax_agent_mod
from agentfield_tpu.serving.model_node import ModelBackend as JaxBackend
from agentfield_tpu_torch.control_plane.server import ControlPlane, ControlPlaneThread
from agentfield_tpu_torch.sdk import agent as port_agent_mod
from agentfield_tpu_torch.serving.model_node import ModelBackend, ModelNodeServer
from tests.helpers_cp import CPHarness

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 4  # branches
NEW = 6
PROMPT = "judge these branches"
# (judge reasoner, the verdict index it gives, or None where the logprob wins)
CASES = (("last", N - 1), ("scored", N - 1), ("nested", 1), ("malformed", None),
         ("fail", None), ("nobody.score", None), ("reentrant", N - 1))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VERDICTS = st.recursive(
    st.none() | st.booleans() | st.integers(-3, 6) | st.floats(allow_nan=False, width=16)
    | st.text(max_size=3),
    lambda kids: st.lists(kids, max_size=5) | st.fixed_dictionaries(
        {}, optional={"best": kids, "scores": kids, "result": kids, "other": kids}),
    max_leaves=8)


@settings(max_examples=300, deadline=None, derandomize=True)
@given(VERDICTS, st.integers(1, 5))
def test_parse_verdict_equals_jax(res, n):
    assert ModelBackend._parse_verdict(res, n) == JaxBackend._parse_verdict(res, n)


@pytest.mark.parametrize("res,n,want", [
    ({"best": 2}, 4, 2), ({"best": True}, 4, None), ({"best": 4}, 4, None),
    ({"scores": [0.1, 0.9, 0.2]}, 3, 1), ({"scores": [1, 2]}, 3, None),
    ({"result": {"best": 0}}, 2, 0), ({"scores": [True, 1.0]}, 2, None), ("best", 2, None),
])
def test_parse_verdict_shapes(res, n, want):
    assert ModelBackend._parse_verdict(res, n) == want == JaxBackend._parse_verdict(res, n)


def _agents(sdk_agent, cp_url: str, seen: dict):
    """The caller (``app.branched``) and the judges, under ``sdk_agent``."""
    app, judge = sdk_agent("app", cp_url), sdk_agent("judge", cp_url)

    @app.reasoner()
    async def branched(verifier: str) -> dict:
        out = await app.ai(PROMPT, max_new_tokens=NEW, temperature=0.9, n_branches=N,
                           branch_policy={"type": "best_of_n", "verifier": verifier})
        return {"tokens": out["tokens"], "text": out["text"], "branches": out["branches"]}

    def record(name, candidates, scores, verdict):
        seen.setdefault(name, []).append({"candidates": candidates, "scores": scores})
        return verdict

    @judge.reasoner()
    def last(task: str, candidates: list[str], scores: list[float]) -> dict:
        assert task == "rerank"
        return record("last", candidates, scores, {"best": len(candidates) - 1})

    @judge.reasoner()
    def scored(task: str, candidates: list[str], scores: list[float]) -> dict:
        return record("scored", candidates, scores, {"scores": list(range(len(candidates)))})

    @judge.reasoner()
    def nested(task: str, candidates: list[str], scores: list[float]) -> dict:
        return record("nested", candidates, scores, {"result": {"best": 1}})

    @judge.reasoner()
    def malformed(task: str, candidates: list[str], scores: list[float]) -> dict:
        return record("malformed", candidates, scores, {"best": True})

    @judge.reasoner()
    def fail(task: str, candidates: list[str], scores: list[float]) -> dict:
        raise RuntimeError("this judge always fails")

    @judge.reasoner()
    async def reentrant(task: str, candidates: list[str], scores: list[float]) -> dict:
        out = await judge.ai("the judge asks the same node", max_new_tokens=3)
        assert len(out["tokens"]) == 3
        return record("reentrant", candidates, scores, {"best": len(candidates) - 1})

    return app, judge


async def _script(sdk_agent, cp_url: str, stats) -> list[dict]:
    """Each case through ``app.branched``; per case: verifier_used, the
    verdict index that won (None: the logprob winner), the candidates'
    count; checked against what each judge got."""
    seen: dict = {}
    app, judge = _agents(sdk_agent, cp_url, seen)
    await app.start()
    await judge.start()
    out = []
    try:
        calls0 = (await stats())["branch_verifier_calls_total"]
        async with aiohttp.ClientSession() as http:
            for name, verdict in CASES:
                target = name if "." in name else f"judge.{name}"
                async with http.post(f"{cp_url}/api/v1/execute/app.branched",
                                     json={"input": {"verifier": target}}) as r:
                    doc = await r.json()
                assert doc["status"] == "completed", (name, doc)
                res = doc["result"]
                br = res["branches"]
                scores = {int(k): v for k, v in br["scores"].items()}
                assert br["n"] == N and len(scores) == N, br
                ranked = sorted(scores, key=lambda i: (-scores[i], i))
                if verdict is None:
                    assert br["verifier_used"] is False and br["winner"] == ranked[0], (name, br)
                else:
                    got = seen[name][-1]
                    # the JAX node's payload: every candidate, best logprob first
                    assert got["scores"] == [round(scores[i], 4) for i in ranked], (got, br)
                    assert len(got["candidates"]) == N
                    assert br["verifier_used"] is True, (name, br)
                    assert br["winner"] == ranked[verdict], (name, br, ranked)
                    assert res["text"] == got["candidates"][verdict], (name, res["text"], got)
                out.append({"case": name, "verifier_used": br["verifier_used"],
                            "won": verdict if br["verifier_used"] else None,
                            "candidates": len(scores)})
        calls = (await stats())["branch_verifier_calls_total"] - calls0
        assert calls == len(CASES), calls  # one call each (the failing ones too)
        return out + [{"verifier_calls": calls}]
    finally:
        await app.stop()
        await judge.stop()


def _port_run() -> list[dict]:
    from agentfield_tpu_torch.models.configs import get_config
    from agentfield_tpu_torch.models.llama import init_params
    from agentfield_tpu_torch.serving.engine import EngineConfig
    from agentfield_tpu_torch.serving.tokenizer import ByteTokenizer

    cfg = get_config("llama-tiny")
    cpt = ControlPlaneThread(ControlPlane(channel=True))
    url = cpt.start()
    backend = ModelBackend(init_params(cfg, seed=0, device="cpu"), cfg,
                           EngineConfig(max_batch=8, num_pages=128, max_pages_per_seq=16),
                           tokenizer=ByteTokenizer(cfg.vocab_size), model_name="llama-tiny",
                           device="cpu")
    server = ModelNodeServer(backend, node_id="tiny", control_plane=url,
                             heartbeat_interval=0.5)
    threads0 = set(threading.enumerate())
    try:
        server.start()
        free0 = backend.engine.allocator.free_pages

        async def stats():
            return dict(backend.engine.stats)

        out = asyncio.run(asyncio.wait_for(_script(port_agent_mod.Agent, url, stats), 120))
        t0 = time.monotonic()
        while backend._on_engine_thread(backend.engine.has_work):
            assert time.monotonic() - t0 < 30
            time.sleep(0.01)
        assert backend.engine.allocator.free_pages == free0, "branch pages leaked"
        return out
    finally:
        server.stop(1.0)
        cpt.stop()
        t0 = time.monotonic()
        while [t for t in threading.enumerate() if t not in threads0 and t.is_alive()
               and t.name == "branch-verifier"] and time.monotonic() - t0 < 10:
            time.sleep(0.05)
        assert not [t for t in threading.enumerate() if t.name == "branch-verifier"
                    and t.is_alive()], "a verifier thread outlived its call"


def test_verifier_through_the_port_gateway_and_as_the_jax_node(tmp_path):
    port = _port_run()

    async def jax_run():
        async with CPHarness(channel=True) as h:
            env = dict(os.environ, PYTHONPATH=str(ROOT), HOME=str(tmp_path),
                       OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
            proc = await asyncio.create_subprocess_exec(
                sys.executable, "-m", "agentfield_tpu.cli", "model", "--cpu", "--model",
                "llama-tiny", "--name", "tiny", "--url", h.base_url, cwd=str(ROOT), env=env,
                stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.STDOUT)
            lines: list[str] = []
            try:
                while True:
                    line = (await asyncio.wait_for(proc.stdout.readline(), 120)).decode()
                    assert line, f"the JAX node exited: {lines}"
                    lines.append(line)
                    m = re.search(r"on :(\d+)", line)
                    if m:
                        base = f"http://127.0.0.1:{m.group(1)}"
                        break

                async def stats():
                    async with aiohttp.ClientSession() as s:
                        async with s.get(f"{base}/stats") as r:
                            return await r.json()

                return await _script(jax_agent_mod.Agent, h.base_url, stats)
            finally:
                if proc.returncode is None:
                    proc.send_signal(signal.SIGTERM)
                try:
                    await asyncio.wait_for(proc.wait(), 30)
                except TimeoutError:
                    proc.kill()
                    await proc.wait()

    jax = asyncio.run(asyncio.wait_for(jax_run(), 240))
    assert port == jax, (port, jax)
