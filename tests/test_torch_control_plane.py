"""The port's model node as a node of the JAX control plane, on the CPU.

The control plane runs in-process (``tests/helpers_cp.CPHarness``); the
port's node runs as a child process (``python -m
agentfield_tpu_torch.serving.model_node --device cpu --model llama-tiny
--control-plane URL``), so torch's CPU work stays off the harness loop's
thread, whose lock witness fails any lock held there for more than 50 ms.
A JAX SDK ``Agent`` then calls it the way agent programs do:

- ``ai()`` with a prompt and with ``messages``; ``ai(stream=True)``
  (token frames through the gateway); ``ai_stream()`` (SSE straight from the
  node); ``ai_embed()`` (the ``embed`` reasoner through the gateway). Each
  completes, and its tokens (or vector) equal a direct POST of the same
  payload to the node. The node advertises the channel, so the gateway
  sends these over ``GET /channel``; one run with the gateway's channel off
  (``AGENTFIELD_CHANNEL=0``) keeps the tracked dispatch covered (202, then
  the node's status callback);
- the streamed execution's trace (``GET /api/v1/executions/{id}/trace``)
  is one ordered waterfall from the gateway's dispatch down to the engine's
  spans, the node's stamped with its id and the attempt, as
  ``tests/test_tracing.py`` requires of the JAX node;
- the registry lists the node with ``kind`` "model" and its metadata,
  ``/api/v1/nodes/{id}`` shows the heartbeat's engine and channel stats,
  and ``/metrics`` the latency histograms it carried;
- after SIGTERM the child exits 0, deregistered (or marked stopping).
"""

from __future__ import annotations

import asyncio
import os
import pathlib
import re
import signal
import sys

import aiohttp
import pytest

import chip_smoke
from agentfield_tpu.sdk.agent import Agent
from tests.helpers_cp import CPHarness, async_test

ROOT = pathlib.Path(__file__).resolve().parents[1]
NODE = "torch-node"
MSGS = [{"role": "system", "content": "be brief"}, {"role": "user", "content": "say hi"}]


async def _start_child(cp_url: str):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "agentfield_tpu_torch.serving.model_node", "--device", "cpu",
        "--model", "llama-tiny", "--port", "0", "--control-plane", cp_url, "--node-id", NODE,
        cwd=str(ROOT), env=env, stdout=asyncio.subprocess.PIPE,
        stderr=asyncio.subprocess.STDOUT)
    lines: list[str] = []
    while True:
        line = (await asyncio.wait_for(proc.stdout.readline(), 40)).decode()
        assert line, f"the node exited: {lines}"
        lines.append(line)
        m = re.search(r"serving on (http://\S+)", line)
        if m:
            return proc, m.group(1), lines


async def _drain(proc, lines: list[str]) -> None:
    async for line in proc.stdout:
        lines.append(line.decode())


# the waterfall tests/test_tracing.py requires of a streamed execution
WATERFALL = ("gateway.execute", "gateway.dispatch", "channel.submit", "node.generate",
             "engine.queue_wait", "engine.prefill", "engine.decode")


@pytest.mark.parametrize("channel", [True, False], ids=["channel", "post"])
@async_test
async def test_sdk_agent_drives_the_port_node_through_the_control_plane(channel):
    async with CPHarness(channel=channel) as h:
        proc, base, lines = await _start_child(h.base_url)
        drain = asyncio.create_task(_drain(proc, lines))
        caller = Agent("caller", h.base_url, channel=False)
        direct = aiohttp.ClientSession(base_url=base)
        try:
            async with h.http.get(f"/api/v1/nodes/{NODE}") as r:
                assert r.status == 200, await r.text()
                node = (await r.json())["node"]
            assert node["kind"] == "model" and node["status"] == "active"
            assert node["metadata"] == {"model": "llama-tiny", "modalities": ["text"],
                                        "role": "mixed", "channel": True}
            assert sorted(c["id"] for c in node["reasoners"]) == ["embed", "generate"]

            async def post(path, payload):
                async with direct.post(path, json={"input": payload}) as r:
                    assert r.status == 200, await r.text()
                    return (await r.json())["result"]

            # ai(): over the channel, or gateway -> 202 -> the node's status callback
            res = await caller.ai("hello from the SDK", max_new_tokens=6, timeout=60)
            want = await post("/reasoners/generate",
                              chip_smoke.sdk_payload(prompt="hello from the SDK",
                                                     max_new_tokens=6))
            assert res["tokens"] == want["tokens"] and len(res["tokens"]) == 6
            res_m = await caller.ai(messages=MSGS, max_new_tokens=5, timeout=60)
            want_m = await post("/reasoners/generate",
                                chip_smoke.sdk_payload(messages=MSGS, max_new_tokens=5))
            assert res_m["tokens"] == want_m["tokens"]
            # ai(stream=True): token frames through the gateway, then the result
            gen = await caller.ai("hello from the SDK", max_new_tokens=6, timeout=60,
                                  stream=True)
            sframes = [f async for f in gen]
            assert sframes[-1]["terminal"] and sframes[-1]["status"] == "completed"
            assert sframes[-1]["result"]["tokens"] == res["tokens"]
            streamed = [f["token"] for f in sframes[:-1] if f["token"] >= 0]
            # with the channel off the gateway sends the one terminal only
            assert streamed == (res["tokens"] if channel else [])
            # the streamed execution's waterfall
            eid = sframes[-1]["execution_id"]
            async with h.http.get(f"/api/v1/executions/{eid}/trace") as r:
                assert r.status == 200, await r.text()
                doc = await r.json()
            names = [s["name"] for s in doc["spans"]]
            for required in WATERFALL if channel else set(WATERFALL) - {"channel.submit"}:
                assert required in names, (required, names)
            assert names.count("gateway.execute") == 1
            t0s = [s["t0"] for s in doc["spans"]]
            assert t0s == sorted(t0s)
            by_name = {s["name"]: s for s in doc["spans"]}
            assert by_name["engine.queue_wait"]["t0"] <= by_name["engine.prefill"]["t0"]
            assert by_name["engine.prefill"]["t0"] <= by_name["engine.decode"]["t0"]
            for n in ("engine.prefill", "engine.decode", "node.generate"):
                assert by_name[n]["node"] == NODE and by_name[n]["attempt"] == 1
            # ai_stream(): SSE straight from the node
            frames = [f async for f in caller.ai_stream("stream me", max_new_tokens=6,
                                                          timeout=60)]
            assert frames[-1]["finished"] and frames[-1]["finish_reason"] == "length"
            want_s = await post("/reasoners/generate", {"prompt": "stream me",
                                                        "max_new_tokens": 6})
            assert [f["token"] for f in frames if f["token"] >= 0] == want_s["tokens"]
            # ai_embed(): the embed reasoner through the gateway
            emb = await caller.ai_embed("embed through the gateway", timeout=60)
            want_e = await post("/reasoners/embed", {"prompt": "embed through the gateway"})
            assert emb == want_e and emb["dim"] == len(emb["embedding"])
            # the heartbeat's engine stats on the registry
            for _ in range(100):
                async with h.http.get(f"/api/v1/nodes/{NODE}") as r:
                    stats = (await r.json())["node"]["metadata"].get("stats") or {}
                if stats.get("requests_finished", 0) >= 4:
                    break
                await asyncio.sleep(0.1)
            assert {"active_slots", "pending_requests", "free_pages", "draining",
                    "decode_tokens", "itl_ms_p50", "grammar_bank_grammars",
                    "channel_server_submits_total"} <= set(stats), stats
            assert (stats["channel_server_submits_total"] > 0) == channel
            # the registry pops latency_hist into per-node Prometheus histograms
            assert "latency_hist" not in stats
            async with h.http.get("/metrics") as r:
                metrics = await r.text()
            for name in ("ttft_ms", "itl_ms", "queue_wait_ms", "tick_ms"):
                assert re.search(rf'engine_{name}_count{{[^}}]*node="{NODE}"', metrics), name
        finally:
            await direct.close()
            await caller.client.close()
            if proc.returncode is None:
                proc.send_signal(signal.SIGTERM)
            rc = await asyncio.wait_for(proc.wait(), 30)
            await drain
        assert rc == 0, "".join(lines)
        async with h.http.get(f"/api/v1/nodes/{NODE}") as r:
            gone = r.status == 404 or (await r.json())["node"]["status"] == "stopping"
        assert gone, "the node neither deregistered nor said it was stopping"
