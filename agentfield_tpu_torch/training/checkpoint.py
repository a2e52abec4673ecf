"""Train-state checkpoints — counterpart of
``agentfield_tpu/training/checkpoint.py``.

The JAX package saves its ``TrainState`` with orbax, which the port does not
use; the port's format is its own, written and read with its safetensors
writer and reader (``models.hf_loader``). ``save_checkpoint(path, state)``
writes ``path/step_{n}/``:

- ``params.safetensors``: every leaf of ``state.params`` under its dotted
  name (``embed``, ``layers.wq``, ...), in its own dtype;
- ``optimizer.safetensors``: every tensor of the optimizer's per-param state
  but the step count, as ``<key>/<param name>`` (``exp_avg/layers.wq``,
  ``exp_avg_sq/layers.wq`` for Adam and AdamW; none for SGD);
- ``state.json``: the step, each param's optimizer step count
  (``param_steps``, absent before a param's first update) and the
  optimizer's hyperparameters (``training.optim.spec_of``, for the record:
  a restore keeps the target state's own).

``restore_checkpoint(path, state, step=None)`` copies a checkpoint into a
state of the same tree built by ``init_train_state`` (or
``init_lora_state``) on the target device, bit for bit, and returns it.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch

from agentfield_tpu_torch.training.optim import spec_of
from agentfield_tpu_torch.training.trainer import TrainState, named_leaves

PARAMS_FILE = "params.safetensors"
OPTIMIZER_FILE = "optimizer.safetensors"
STATE_FILE = "state.json"


def save_checkpoint(path: str | Path, state: TrainState) -> None:
    from agentfield_tpu_torch.models.hf_loader import write_safetensors

    d = Path(path).absolute() / f"step_{int(state.step)}"
    d.mkdir(parents=True, exist_ok=True)
    leaves = named_leaves(state.params)

    def entries(items):
        return [(name, tuple(t.shape), t.dtype, lambda t=t: t.detach()) for name, t in items]

    write_safetensors(d / PARAMS_FILE, entries(leaves))
    moments, steps = [], {}
    for name, p in leaves:
        for key, v in state.optimizer.state.get(p, {}).items():
            if key == "step":
                steps[name] = int(v)
            else:
                moments.append((f"{key}/{name}", v))
    write_safetensors(d / OPTIMIZER_FILE, entries(moments))
    (d / STATE_FILE).write_text(json.dumps({
        "step": int(state.step), "param_steps": steps,
        "optimizer": dataclasses.asdict(spec_of(state.optimizer))}, indent=1))


def latest_step(path: str | Path) -> int | None:
    path = Path(path)
    steps = [int(p.name.split("_", 1)[1]) for p in path.glob("step_*") if p.is_dir()]
    return max(steps) if steps else None


def restore_checkpoint(path: str | Path, state: TrainState, step: int | None = None) -> TrainState:
    """Load ``path/step_{step}`` (default: ``latest_step``) into ``state``:
    params copied in place, the optimizer's per-param state replaced
    (``load_state_dict``, which puts it on each param's device), the step
    set. Raises ``ValueError`` where a leaf's name, shape or dtype differs
    from the state's."""
    from agentfield_tpu_torch.models.hf_loader import SafetensorsFile

    path = Path(path).absolute()
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    d = path / f"step_{step}"
    meta = json.loads((d / STATE_FILE).read_text())
    leaves = named_leaves(state.params)
    params_st, opt_st = SafetensorsFile(d / PARAMS_FILE), SafetensorsFile(d / OPTIMIZER_FILE)
    try:
        if sorted(params_st.keys()) != sorted(n for n, _ in leaves):
            raise ValueError(f"{d}: params {sorted(params_st.keys())} differ from the state's "
                             f"{sorted(n for n, _ in leaves)}")
        with torch.no_grad():
            for name, p in leaves:
                t = params_st.get(name)
                if (t.shape, t.dtype) != (p.shape, p.dtype):
                    raise ValueError(f"{d}: param {name} is {t.dtype} {tuple(t.shape)}, the "
                                     f"state's {p.dtype} {tuple(p.shape)}")
                p.copy_(t)
        by_param: dict[str, dict] = {}
        for key in opt_st.keys():
            kind, name = key.split("/", 1)
            by_param.setdefault(name, {})[kind] = opt_st.get(key).clone()
        sd = state.optimizer.state_dict()
        sd["state"] = {}
        for i, (name, p) in enumerate(leaves):
            entry = by_param.pop(name, {})
            for kind, t in entry.items():
                if t.shape != p.shape:
                    raise ValueError(f"{d}: {kind} of {name} is {tuple(t.shape)}, the param "
                                     f"{tuple(p.shape)}")
            if name in meta["param_steps"]:
                entry["step"] = torch.tensor(float(meta["param_steps"][name]))
            if entry:
                sd["state"][i] = entry
        if by_param:
            raise ValueError(f"{d}: optimizer state for params the state lacks: {sorted(by_param)}")
        state.optimizer.load_state_dict(sd)
    finally:
        params_st.close()
        opt_st.close()
    state.step = int(meta["step"])
    return state
