"""The port's model node as a child process of a test that runs the JAX
control plane in-process (``tests/helpers_cp.CPHarness``), serving the JAX
package's llama-tiny weights: the cluster tests put port nodes, and JAX
nodes on the same weights, in one fleet behind the JAX gateway.

A child process keeps the node's threads off the control plane's event loop
(the harness times its storage locks on that loop). The parent writes the
weights once (``write_weights``) and starts each node with ``start_node``;
the child (``python -m tests.helpers_torch_cluster`` with the node's spec as
JSON in ``AFT_NODE``) installs the spec's fault schedule (the port's
``serving.faults``) before it serves, so a fault fires in the node that
consults it, prints ``serving on URL`` and drains on SIGTERM.
"""

from __future__ import annotations

import asyncio
import json
import os
import pathlib
import re
import signal
import sys
import threading
import time

import aiohttp
import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


def write_weights(path: str, tree: dict) -> None:
    """The JAX param tree (numpy leaves) as one ``.npz``, nested keys joined
    by ``/``."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update({f"{k}/{kk}": np.asarray(vv) for kk, vv in v.items()})
        else:
            flat[k] = np.asarray(v)
    np.savez(path, **flat)


def read_weights(path: str) -> dict:
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            head, _, leaf = key.partition("/")
            if leaf:
                tree.setdefault(head, {})[leaf] = z[key]
            else:
                tree[head] = z[key]
    return tree


async def start_node(cp_url: str, node_id: str, weights: str, role: str = "mixed",
                     ecfg: dict | None = None, faults: dict | None = None,
                     kv_fetch_timeout_s: float | None = None,
                     heartbeat_interval: float = 0.2):
    """Start one port node; returns ``(process, base url, output lines)``."""
    spec = {"cp_url": cp_url, "node_id": node_id, "weights": weights, "role": role,
            "ecfg": ecfg or {}, "faults": faults, "kv_fetch_timeout_s": kv_fetch_timeout_s,
            "heartbeat_interval": heartbeat_interval}
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               AFT_NODE=json.dumps(spec))
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "tests.helpers_torch_cluster", cwd=str(ROOT), env=env,
        stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.STDOUT)
    lines: list[str] = []
    while True:
        line = (await asyncio.wait_for(proc.stdout.readline(), 60)).decode()
        assert line, f"the node exited: {lines}"
        lines.append(line)
        m = re.search(r"serving on (http://\S+)", line)
        if m:
            return proc, m.group(1), lines


async def stop_node(proc, lines: list[str]) -> int:
    if proc.returncode is None:
        proc.send_signal(signal.SIGTERM)
    async for line in proc.stdout:
        lines.append(line.decode())
    return await asyncio.wait_for(proc.wait(), 60)


async def node_stats(base: str, pred=lambda s: True, timeout: float = 30.0) -> dict:
    """The node's ``GET /stats``, once ``pred`` holds for it."""
    t0 = time.monotonic()
    async with aiohttp.ClientSession(base_url=base) as direct:
        while True:
            async with direct.get("/stats") as r:
                stats = await r.json()
            if pred(stats):
                return stats
            assert time.monotonic() - t0 < timeout, stats
            await asyncio.sleep(0.05)


async def idle_stats(base: str, timeout: float = 30.0) -> dict:
    """The node's stats once nothing runs there."""
    return await node_stats(base, lambda s: s["active_slots"] == 0 and s["pending_requests"] == 0,
                            timeout)


def main() -> None:
    import torch

    from agentfield_tpu_torch.models.configs import get_config
    from agentfield_tpu_torch.models.convert import params_from_numpy
    from agentfield_tpu_torch.serving import faults
    from agentfield_tpu_torch.serving.engine import EngineConfig
    from agentfield_tpu_torch.serving.model_node import ModelBackend, ModelNodeServer
    from agentfield_tpu_torch.serving.tokenizer import ByteTokenizer

    torch.set_num_threads(1)
    spec = json.loads(os.environ["AFT_NODE"])
    cfg = get_config("llama-tiny")
    params = params_from_numpy(read_weights(spec["weights"]), cfg, device="cpu")
    if spec.get("faults"):
        faults.install(faults.FaultInjector(seed=0, spec=spec["faults"]))
    backend = ModelBackend(params, cfg, EngineConfig(**spec["ecfg"]),
                           tokenizer=ByteTokenizer(cfg.vocab_size), model_name="llama-tiny",
                           device="cpu")
    if spec.get("kv_fetch_timeout_s") is not None:
        backend.kv_fetch_timeout_s = spec["kv_fetch_timeout_s"]
    server = ModelNodeServer(backend, node_id=spec["node_id"], control_plane=spec["cp_url"],
                             heartbeat_interval=spec["heartbeat_interval"], role=spec["role"])
    stopping = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda signum, frame: stopping.set())
    port = server.start()
    print(f"serving on http://127.0.0.1:{port}", flush=True)
    try:
        stopping.wait()
    finally:
        server.stop(1.0)
        print("stopped", flush=True)


if __name__ == "__main__":
    main()
