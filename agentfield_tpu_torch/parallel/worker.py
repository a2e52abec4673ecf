"""The rank loop of a tensor-parallel serving engine (the port's own
module: the JAX engine is one controller and has none).

Rank 0 is the caller's process: it owns the engine's host side (scheduler,
prefix index, sampler, clock, threads, the node). ``start_workers`` starts
ranks 1..tp-1, each a fresh interpreter (``python -m``, a socket pair its
pipe) that joins the ``model`` group over a TCP rendezvous on the
loopback address, makes only its own slice of the weights (``weights``:
:class:`RandomWeights`, :class:`CheckpointWeights` or any picklable
callable ``weights(mesh) -> (params, draft or None)``), builds its
``InferenceEngine(mesh=)`` and reports ready. Then it runs the device
operations rank 0 sends over its pipe (``InferenceEngine._tp_op``: method
name and host arguments, an argument that differs by rank a
:class:`PerRank`), in order, and answers rank 0's queries
(``Workers.query``: a report of its launches and timings, its slices of a
captured KV page), until:

- a shutdown message (rank 0's ``Mesh.close``, from ``engine.close()``);
- its pipe closes (rank 0 exited or died);
- an operation raises, e.g. a collective whose peer died (gloo raises when
  a peer's socket closes, or after the group's ``timeout_s``).

A worker never waits forever: it exits, and rank 0's next collective
raises in turn. A worker takes no decision from a clock, a thread or a
random generator: rank 0 samples and broadcasts what it drew.

Rank 0 sends from more than one thread (the tick's operations; a KV page's
capture from the thread that demotes or serves a peer's fetch; queries), so
every message goes out whole under one lock, in the order rank 0 took it,
and a query holds a second lock until its answers are read: the tick's
operations go on meanwhile, and each worker answers after the operations
sent before the query.
"""

from __future__ import annotations

import dataclasses
import datetime
import faulthandler
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import traceback
from multiprocessing.connection import Connection
from typing import Any, Callable

import torch

from agentfield_tpu_torch.parallel.mesh import AXIS_MODEL, DEFAULT_TIMEOUT_S, Mesh, make_mesh

READY_TIMEOUT_S = 900.0  # a worker's import, weights and engine build


@dataclasses.dataclass
class RandomWeights:
    """Random weights from ``seed`` (``llama.init_params(shard=mesh)``):
    every matrix drawn whole in the unsharded order, the rank's slice kept,
    so each rank's tree is the slice of the TP=1 tree; ``quantize`` draws
    int8 (quantized whole, cut, packed). ``draft`` is a speculative draft
    preset, drawn whole from ``seed + 4`` in ``draft_dtype`` (the engine
    cuts it)."""

    cfg: Any
    seed: int = 0
    quantize: bool = False
    draft: str | None = None
    draft_dtype: str | None = None

    def __call__(self, mesh: Mesh):
        from agentfield_tpu_torch.models.llama import init_params

        params = init_params(self.cfg, seed=self.seed, device=mesh.device,
                             quantize=self.quantize, shard=mesh)
        return params, _draft(self.draft, self.cfg, self.seed, mesh, self.draft_dtype)


@dataclasses.dataclass
class CheckpointWeights:
    """One rank's slice of an HF checkpoint directory
    (``hf_loader.load_hf_checkpoint(shard=mesh)``), int8 on load with
    ``quant``."""

    path: str
    quant: str | None = None
    draft: str | None = None
    seed: int = 0

    def __call__(self, mesh: Mesh):
        from agentfield_tpu_torch.models.hf_loader import load_hf_checkpoint

        cfg, params = load_hf_checkpoint(self.path, device=mesh.device, quant=self.quant,
                                         shard=mesh)
        return params, _draft(self.draft, cfg, self.seed, mesh, str(params["embed"].dtype)[6:])


def _draft(preset, cfg, seed, mesh, dtype):
    if preset is None:
        return None
    from agentfield_tpu_torch.serving.model_node import load_draft_model

    return load_draft_model(preset, cfg.vocab_size, seed=seed + 4, device=mesh.device,
                            dtype=dtype)


@dataclasses.dataclass
class WorkerSpec:
    """What a worker needs to build its rank of the engine."""

    cfg: Any
    ecfg: Any
    seed: int
    weights: Callable
    backend: str
    device: str
    timeout_s: float = DEFAULT_TIMEOUT_S
    threads: int | None = None  # torch intra-op threads (CPU ranks)


class PerRank:
    """An operation's argument that differs by rank: ``values[r]`` is rank
    r's (rank 0's is never pickled; a worker's must be host data)."""

    __slots__ = ("values",)

    def __init__(self, values: list):
        self.values = values


def for_rank(args: tuple, kwargs: dict, rank: int) -> tuple[tuple, dict]:
    """``args`` and ``kwargs`` with each :class:`PerRank` replaced by rank
    ``rank``'s value."""
    def pick(v):
        return v.values[rank] if isinstance(v, PerRank) else v

    return tuple(pick(a) for a in args), {k: pick(v) for k, v in kwargs.items()}


class Workers:
    """Rank 0's handle on the worker processes: their pipes, in rank
    order."""

    def __init__(self, procs: list, conns: list):
        self.procs, self.conns = procs, conns
        self._ready = False
        self._send_lock = threading.Lock()  # one whole message at a time
        self._query_lock = threading.Lock()  # one query's answers at a time

    def wait_ready(self, timeout_s: float = READY_TIMEOUT_S) -> None:
        """Block until every worker built its engine; raise with a worker's
        traceback if one failed, at once if one exited, and after
        ``timeout_s`` naming the ranks still building."""
        if self._ready:
            return
        deadline = time.monotonic() + timeout_s
        pending = dict(enumerate(zip(self.procs, self.conns), start=1))
        while pending:
            for rank, (p, c) in list(pending.items()):
                if c.poll(0):
                    try:
                        kind, detail = c.recv()
                    except EOFError:
                        kind, detail = "error", f"exit code {p.wait()}"
                    if kind != "ready":
                        raise RuntimeError(
                            f"tensor-parallel worker rank {rank} failed to start:\n{detail}")
                    del pending[rank]
                elif p.poll() is not None:
                    raise RuntimeError(f"tensor-parallel worker rank {rank} exited with code "
                                       f"{p.returncode} before it was ready")
            if pending and time.monotonic() > deadline:
                raise TimeoutError(f"tensor-parallel worker ranks {sorted(pending)} not ready "
                                   f"after {timeout_s} s")
            if pending:
                time.sleep(0.05)
        self._ready = True

    def query(self, name: str, *args, timeout_s: float = 120.0) -> list:
        """Every worker's ``engine.<name>(*args)`` (host data, not a device
        operation of the boundary), in rank order, each answered after the
        operations sent before it. Any thread may ask; the caller must hold
        no lock that the engine's thread takes inside an operation (the
        answer waits for those operations)."""
        self.wait_ready()
        with self._query_lock:
            self._send_all(lambda rank: ("?", name, args))
            out = []
            for rank, c in enumerate(self.conns, start=1):
                if not c.poll(timeout_s):
                    raise TimeoutError(f"tensor-parallel worker rank {rank} did not answer {name}")
                try:
                    out.append(c.recv())
                except (EOFError, ConnectionResetError) as e:
                    raise RuntimeError(f"tensor-parallel worker rank {rank} is gone") from e
            return out

    def send(self, msg) -> None:
        """One operation ``(name, args, kwargs)`` to every worker, a
        :class:`PerRank` argument as that worker's value."""
        self.wait_ready()
        name, args, kwargs = msg
        self._send_all(lambda rank: (name, *for_rank(args, kwargs, rank)))

    def _send_all(self, msg_of) -> None:
        with self._send_lock:
            for rank, c in enumerate(self.conns, start=1):
                try:
                    c.send(msg_of(rank))
                except (BrokenPipeError, ConnectionResetError, EOFError) as e:
                    raise RuntimeError(f"tensor-parallel worker rank {rank} is gone") from e

    def close(self, join_s: float = 30.0) -> None:
        """Send the shutdown message, join every worker (killing one that
        does not exit within ``join_s``), close the pipes."""
        for c in self.conns:
            try:
                c.send(None)
            except (BrokenPipeError, ConnectionResetError, EOFError, OSError):
                pass
        for p in self.procs:
            try:
                p.wait(timeout=join_s)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=join_s)
        for c in self.conns:
            c.close()

    @property
    def exitcodes(self) -> list[int | None]:
        return [p.poll() for p in self.procs]


def start_workers(tp: int, spec: WorkerSpec) -> Mesh:
    """Start ranks 1..tp-1 and join the ``model`` group as rank 0; returns
    rank 0's :class:`Mesh` (its ``workers`` set: ``close`` stops and joins
    them). Each worker is ``python -m agentfield_tpu_torch.parallel.worker``
    with this process's ``sys.path``, its pipe one end of a socket pair
    (nothing of the caller's ``__main__`` runs again in it, as it would
    under ``multiprocessing``'s spawn). The workers build their engines
    meanwhile; the first operation sent waits until all are ready
    (``Workers.wait_ready``)."""
    if tp < 2:
        raise ValueError(f"tp={tp}: a tensor-parallel engine has at least 2 ranks")
    timeout = datetime.timedelta(seconds=spec.timeout_s)
    store = torch.distributed.TCPStore("127.0.0.1", 0, tp, True, timeout=timeout,
                                       wait_for_workers=False)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
    procs, conns = [], []
    try:
        for rank in range(1, tp):
            mine, theirs = socket.socketpair()
            with theirs:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "agentfield_tpu_torch.parallel.worker", str(rank),
                     str(tp), str(store.port), str(theirs.fileno())],
                    env=env, pass_fds=(theirs.fileno(),)))
            conns.append(Connection(mine.detach()))
            conns[-1].send(spec)
        mesh = make_mesh({AXIS_MODEL: tp}, 0, spec.backend, device=spec.device,
                         timeout_s=spec.timeout_s, store=store)
    except BaseException:
        Workers(procs, conns).close(join_s=5.0)
        raise
    mesh.workers = Workers(procs, conns)
    return mesh


def worker_main(rank: int, tp: int, port: int, conn) -> None:
    """The entry point of rank ``rank``'s process (module docstring): its
    ``WorkerSpec`` is the pipe's first message."""
    faulthandler.register(signal.SIGUSR1, all_threads=True)  # kill -USR1: every stack
    spec = conn.recv()
    if spec.threads:
        torch.set_num_threads(spec.threads)
    try:
        dev = torch.device(spec.device)
        if spec.backend == "nccl":
            dev = torch.device("cuda", rank)
        elif dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        mesh = make_mesh({AXIS_MODEL: tp}, rank, spec.backend,
                         init_method=f"tcp://127.0.0.1:{port}", device=dev,
                         timeout_s=spec.timeout_s)
        from agentfield_tpu_torch.serving.engine import InferenceEngine

        params, draft = spec.weights(mesh)
        engine = InferenceEngine(params, spec.cfg, spec.ecfg, seed=spec.seed,
                                 device=mesh.device, draft=draft, mesh=mesh)
        conn.send(("ready", None))
    except BaseException:  # noqa: BLE001 — reported to rank 0, then this rank exits
        tb = traceback.format_exc()
        print(f"tensor-parallel rank {rank} failed to start\n{tb}", file=sys.stderr, flush=True)
        conn.send(("error", tb))
        conn.close()
        os._exit(2)  # no interpreter teardown: dropping a group waits on its peers
    code = 0
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            code = 3  # rank 0 is gone
            break
        if msg is None:
            break
        if msg[0] == "?":  # a query: its answer goes back over the pipe
            conn.send(getattr(engine, msg[1])(*msg[2]))
            continue
        name, args, kwargs = msg
        try:
            getattr(engine, name)(*args, **kwargs)
        except Exception:  # noqa: BLE001 — this rank stops; rank 0's collectives then fail
            print(f"tensor-parallel rank {rank}: {name} failed\n{traceback.format_exc()}",
                  file=sys.stderr, flush=True)
            code = 4
            break
    conn.close()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    sys.stdout.flush()
    os._exit(code)  # no interpreter teardown: the group's threads may still wait on peers


if __name__ == "__main__":
    _rank, _tp, _port, _fd = map(int, sys.argv[1:5])
    worker_main(_rank, _tp, _port, Connection(_fd))
