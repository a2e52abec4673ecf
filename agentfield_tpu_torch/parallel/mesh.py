"""Tensor-parallel meshes on ``torch.distributed`` — counterpart of
``agentfield_tpu/parallel/mesh.py``.

Canonical axis names (every partition spec of the port uses them):

- ``data``    — batch/data parallelism (DP)
- ``model``   — tensor parallelism over heads / ffn dims (TP)
- ``seq``     — sequence/context parallelism (SP/CP, ring attention)
- ``expert``  — expert parallelism for MoE layers (EP)
- ``stage``   — pipeline stages (PP)

JAX is single-controller: one process holds a sharded array and GSPMD
inserts the collectives. PyTorch runs one process per rank, so a
:class:`Mesh` is one rank's view: its coordinate on the ``model`` axis, the
process group of that axis (gloo or NCCL, over a TCP rendezvous on the
loopback address) and the explicit Megatron-style collectives the model
calls (``all_reduce`` after the row-parallel ``wo`` and ``w_down`` and
after the vocab-sharded embedding lookup, ``gather_vocab`` for the
column-parallel unembed, ``broadcast`` of what rank 0 decided). Only the
``model`` axis may exceed 1 here: expert, sequence, pipeline and data
parallelism are later work (ROADMAP A5) and raise ``NotImplementedError``.

Backends: NCCL where every rank has its own card (rank r on ``cuda:r``);
gloo on the CPU and for several ranks sharing one card. The NCCL leg is
unverified: no run has yet seen its all-reduce complete (on a four-card
machine the first one never returned), nor its collectives captured in the
decode graphs (ROADMAP A5). Gloo takes CUDA
tensors only in ``broadcast`` and ``all_reduce`` — the vocab gather is an
all-reduce of a zero-filled buffer, which is exact — and the port reduces
16-bit tensors in float32 under gloo (``reduce_dtype``), a cast that is
explicit and not a fallback: gloo's 16-bit support differs between builds.
A mesh without a backend is a coordinate only (``shard_params`` slices for
it; its collectives raise).

``to_varying``, ``shard_map`` and ``use_mesh`` of the JAX module are JAX
idioms (the vma type system, the SPMD map, the ambient mesh) with no
counterpart: each rank's process already holds only its slice and calls
its collectives itself. ``make_hybrid_mesh`` (multi-slice DCN placement)
waits for ROADMAP A5.
"""

from __future__ import annotations

import dataclasses
import datetime
import time
from typing import Any

import torch

AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_SEQ = "seq"
AXIS_EXPERT = "expert"
AXIS_STAGE = "stage"

# Mesh axis order: slower-varying axes first (the JAX package's order).
CANONICAL_ORDER = (AXIS_STAGE, AXIS_DATA, AXIS_EXPERT, AXIS_SEQ, AXIS_MODEL)
BACKENDS = ("gloo", "nccl")
DEFAULT_TIMEOUT_S = 120.0  # a collective waiting longer for a peer raises
_HALF = (torch.bfloat16, torch.float16)
# the later slices of ROADMAP A5, by axis
_LATER = {
    AXIS_EXPERT: "expert parallelism (ROADMAP A5: EP and Mixtral under a mesh)",
    AXIS_SEQ: "sequence parallelism / ring attention (ROADMAP A5: ring attention)",
    AXIS_STAGE: "pipeline parallelism (ROADMAP A5: pipeline)",
    AXIS_DATA: "data parallelism across ranks (ROADMAP A5: the trainer's mesh pieces)",
}


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's view of a tensor-parallel mesh (see the module
    docstring). ``workers`` is rank 0's handle on the worker processes of a
    serving mesh (``parallel.worker``); ``close`` stops them."""

    shape: dict[str, int]
    rank: int = 0
    backend: str | None = None
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cpu"))
    group: Any = None
    timeout_s: float = DEFAULT_TIMEOUT_S
    workers: Any = None
    store: Any = None  # the rendezvous store (rank 0 serves it)
    # collectives this rank ran: count, payload bytes, host seconds (under
    # gloo a CUDA tensor is staged through the host inside the call)
    stats: dict = dataclasses.field(
        default_factory=lambda: {"calls": 0, "bytes": 0, "host_s": 0.0})

    @property
    def tp(self) -> int:
        return self.shape.get(AXIS_MODEL, 1)

    @property
    def is_root(self) -> bool:
        return self.rank == 0

    def reduce_dtype(self, dtype: torch.dtype) -> torch.dtype:
        """The dtype a sum over ranks is taken in: float32 for a 16-bit
        tensor under gloo, the tensor's own dtype otherwise."""
        return torch.float32 if self.backend == "gloo" and dtype in _HALF else dtype

    def _pg(self):
        if self.group is None:
            raise RuntimeError("this mesh is a coordinate only (no process group)")
        return self.group

    def _run(self, work, t: torch.Tensor) -> None:
        t0 = time.perf_counter()
        work.wait()
        self.stats["calls"] += 1
        self.stats["bytes"] += t.numel() * t.element_size()
        self.stats["host_s"] += time.perf_counter() - t0

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ``model`` ranks (a new tensor of t's dtype;
        the identity at tp 1)."""
        if self.tp == 1:
            return t
        buf = t.to(self.reduce_dtype(t.dtype)).contiguous()
        if buf is t:
            buf = t.clone()
        opts = torch.distributed.AllreduceOptions()
        opts.reduceOp = torch.distributed.ReduceOp.SUM
        self._run(self._pg().allreduce([buf], opts), buf)
        return buf.to(t.dtype)

    def gather_vocab(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's ``[..., V/tp]`` slice of a vocab-sharded output as the
        whole ``[..., V]`` on every rank: the slice in a zero-filled buffer,
        summed over ranks (each element has one non-zero addend, so the sum
        is exact)."""
        if self.tp == 1:
            return t
        n = t.shape[-1]
        full = t.new_zeros((*t.shape[:-1], n * self.tp))
        full[..., self.rank * n:(self.rank + 1) * n] = t
        opts = torch.distributed.AllreduceOptions()
        opts.reduceOp = torch.distributed.ReduceOp.SUM
        self._run(self._pg().allreduce([full], opts), full)
        return full

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` on every rank, written into ``t`` in place."""
        if self.tp == 1:
            return t
        opts = torch.distributed.BroadcastOptions()
        opts.rootRank = 0
        opts.rootTensor = 0
        self._run(self._pg().broadcast([t], opts), t)
        return t

    def close(self) -> None:
        """Rank 0 stops its workers (each joined); every rank shuts its
        group down (its sockets and threads released now, not left to the
        process's exit) and drops it. Idempotent."""
        workers, self.workers = self.workers, None
        if workers is not None:
            workers.close()
        group, self.group = self.group, None
        if group is not None:
            group.shutdown()
        self.store = None


def _check_axes(shape: dict[str, int]) -> None:
    unknown = set(shape) - set(CANONICAL_ORDER)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; canonical axes are "
                         f"{CANONICAL_ORDER}")
    for ax, n in shape.items():
        if n < 1:
            raise ValueError(f"mesh axis {ax}={n} must be >= 1")
        if ax != AXIS_MODEL and n > 1:
            raise NotImplementedError(f"mesh axis {ax}={n}: {_LATER[ax]} is not ported")


def make_mesh(
    shape: dict[str, int] | None = None,
    rank: int = 0,
    backend: str | None = None,
    init_method: str | None = None,
    device: str | torch.device | None = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
    store: Any = None,
) -> Mesh:
    """This rank's :class:`Mesh` of ``{axis: size}`` (missing canonical axes
    get size 1, as in the JAX ``make_mesh``). With ``backend`` ("gloo" |
    "nccl") the ``model`` group is made now: every rank calls this with the
    same ``init_method`` (``tcp://127.0.0.1:<port>``; rank 0 serves the
    store there) or the same ``store``, and the call returns once all have
    joined (or raises after ``timeout_s``). NCCL puts rank r on ``cuda:r``
    and raises when there are fewer cards than ranks (NCCL refuses two
    ranks on one card); gloo puts every rank on ``device`` (default: the
    CPU). Without ``backend`` the mesh is a coordinate only."""
    full = {ax: 1 for ax in CANONICAL_ORDER}
    full.update(shape or {})
    _check_axes(full)
    tp = full[AXIS_MODEL]
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside the model axis of size {tp}")
    if backend is None:
        dev = torch.device(device) if device is not None else torch.device("cpu")
        return Mesh(full, rank, None, dev, None, timeout_s)
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} must be one of {BACKENDS}")
    if backend == "nccl":
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if tp > n_cards:
            raise ValueError(
                f"nccl needs one card a rank: tp={tp} ranks, {n_cards} card(s) (NCCL refuses "
                "two ranks on one card; use backend='gloo' to share a card)")
        dev = torch.device("cuda", rank)
    else:
        dev = torch.device(device) if device is not None else torch.device("cpu")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    timeout = datetime.timedelta(seconds=timeout_s)
    if store is None:
        if init_method is None or not init_method.startswith("tcp://"):
            raise ValueError(f"init_method={init_method!r} must be tcp://<host>:<port>")
        host, port = init_method[len("tcp://"):].rsplit(":", 1)
        store = torch.distributed.TCPStore(host, int(port), tp, rank == 0, timeout=timeout)
    prefixed = torch.distributed.PrefixStore(f"model/{tp}", store)
    if backend == "gloo":
        group = torch.distributed.ProcessGroupGloo(prefixed, rank, tp, timeout)
    else:
        opts = torch.distributed.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        group = torch.distributed.ProcessGroupNCCL(prefixed, rank, tp, opts)
    return Mesh(full, rank, backend, dev, group, timeout_s, store=store)


def auto_mesh_shape(n_devices: int, tp: int | None = None) -> dict[str, int]:
    """Factor n_devices into {data, model}. If tp is not given, pick the
    largest power-of-two TP degree <= 8 that divides n_devices; the rest goes
    to DP (the JAX package's rule)."""
    if tp is None:
        tp = 1
        while tp < 8 and (n_devices % (tp * 2) == 0):
            tp *= 2
    if n_devices % tp:
        raise ValueError(f"tp={tp} does not divide n_devices={n_devices}")
    return {AXIS_DATA: n_devices // tp, AXIS_MODEL: tp}

