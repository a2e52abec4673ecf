"""Helpers of the tensor-parallel tests that run in spawned rank processes
(``tests/test_torch_tp_serving.py``): importing this module imports torch
and the port, never JAX, so a rank's fresh interpreter stays light.

- :class:`NpzWeights` — a worker's weight source: a JAX tree written to an
  ``.npz`` by the test (``save_tree``), each rank cutting its slice
  (``params_from_numpy(shard=mesh)``).
- ``collective_rank`` — rank 1 of the collectives test.
- ``root_that_dies`` — a rank 0 that starts its workers, sends them one
  operation, and exits without running it.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import sys
from typing import Any

import numpy as np
import torch

from agentfield_tpu_torch.models.convert import params_from_numpy


def save_tree(tree: dict[str, Any], path: str) -> None:
    """A numpy param tree (QuantW-like leaves as their ``q``/``scale``) as
    an ``.npz`` of ``/``-joined keys."""
    flat: dict[str, np.ndarray] = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{k}/", v)
        elif hasattr(node, "q"):
            flat[prefix + "q"] = np.asarray(node.q)
            flat[prefix + "scale"] = np.asarray(node.scale)
        else:
            flat[prefix[:-1]] = np.asarray(node, np.float32)

    walk("", tree)
    np.savez(path, **flat)


def load_tree(path: str) -> dict[str, Any]:
    tree: dict[str, Any] = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    layers = tree["layers"]
    for name, v in list(layers.items()):
        if isinstance(v, dict):  # a quantized leaf
            layers[name] = (v["q"], v["scale"])
    return tree


@dataclasses.dataclass
class NpzWeights:
    """``weights(mesh)`` for ``parallel.worker``: the rank's slice of the
    tree in ``path``, on the mesh's device in ``cfg.dtype``; with
    ``self_draft`` a second copy is the speculative draft."""

    path: str
    cfg: Any
    self_draft: bool = False

    def __call__(self, mesh):
        def load():
            return params_from_numpy(load_tree(self.path), self.cfg, device=mesh.device,
                                     shard=mesh)

        return load(), ((load(), self.cfg) if self.self_draft else None)


def be_nice() -> None:
    """Lower this process's CPU priority (a spawned rank's, before it runs
    anything): ranks of a test yield to the other tests on a shared box."""
    os.nice(10)


def collective_rank(rank: int, port: int, conn, stderr_path: str | None = None) -> None:
    """Rank ``rank`` of a 2-rank gloo mesh on the CPU: runs the same
    collectives as the test's rank 0, sends back what it got and closes its
    mesh. With ``stderr_path`` its stderr goes to that file (the test puts
    it in its assertion message)."""
    if stderr_path is not None:
        fd = os.open(stderr_path, os.O_WRONLY | os.O_CREAT | os.O_APPEND)
        os.dup2(fd, 2)
        os.close(fd)
        sys.stderr = os.fdopen(2, "w", buffering=1, closefd=False)
    from agentfield_tpu_torch.parallel.mesh import make_mesh

    be_nice()
    torch.set_num_threads(1)
    mesh = make_mesh({"model": 2}, rank, "gloo", init_method=f"tcp://127.0.0.1:{port}",
                     timeout_s=120)
    # pickled by value: ``conn.send`` would share the tensors' storage by
    # file descriptor through this process's resource sharer, which is gone
    # once this process exits, so a parent that reads late gets
    # FileNotFoundError
    conn.send_bytes(pickle.dumps(collective_script(mesh)))
    conn.close()
    mesh.close()


def collective_script(mesh) -> dict[str, torch.Tensor]:
    """Each rank's inputs are made from its rank: the sum, the gather and
    the broadcast have known answers."""
    r = mesh.rank
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) * (r + 1)
    xb = (torch.full((4,), 0.5) * (r + 1)).to(torch.bfloat16)
    part = torch.full((2, 3), float(r + 1))
    b = torch.arange(5) if r == 0 else torch.zeros(5, dtype=torch.int64)
    return {"sum": mesh.all_reduce(x), "sum_bf16": mesh.all_reduce(xb),
            "gathered": mesh.gather_vocab(part), "bcast": mesh.broadcast(b).clone()}


def root_that_dies(spec, conn) -> None:
    """Rank 0 of a 2-rank engine: start the worker, wait until it is ready,
    send it a decode-state load and a step, report the worker's pid, and
    exit without running the step: the worker waits in the step's first
    collective until it sees this process gone."""
    from agentfield_tpu_torch.parallel.worker import start_workers

    be_nice()  # its worker inherits it
    torch.set_num_threads(1)
    mesh = start_workers(2, spec)
    mesh.workers.wait_ready()
    pid = mesh.workers.procs[0].pid
    width = spec.ecfg.max_batch
    rows = {"seq_lens": np.full((width,), 3, np.int32)}
    mesh.workers.send(("_load_state", (width, rows), {}))
    mesh.workers.send(("_run_graph", (width, "greedy", "free"), {}))
    conn.send(pid)
    conn.close()
    os._exit(1)


@dataclasses.dataclass
class FailOnRank:
    """``weights(mesh)`` that raises on one rank: a worker failing to start."""

    rank: int

    def __call__(self, mesh):
        if mesh.rank == self.rank:
            raise ValueError(f"rank {mesh.rank} refuses to load its weights")
        raise AssertionError("only the failing rank calls this")
