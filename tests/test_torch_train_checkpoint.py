"""Train-state checkpoints on the port (``agentfield_tpu_torch/training/
checkpoint.py``): the port's own format (``params.safetensors``,
``optimizer.safetensors``, ``state.json`` under ``step_{n}``) restored bit for
bit into a fresh state, a resumed run equal to an uninterrupted one (the CPU
sums in one order: losses equal exactly), and a JAX ``TrainState`` saved by
orbax after AdamW steps, restored by the JAX package and carried across with
``train_state_from_numpy``, whose next steps give JAX's losses (float32,
within 1e-5 relative)."""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from agentfield_tpu.models import configs as jax_configs
from agentfield_tpu.training import checkpoint as jax_ckpt
from agentfield_tpu.training import trainer as jax_trainer
from agentfield_tpu_torch.models.configs import get_config
from agentfield_tpu_torch.models.convert import train_state_from_numpy
from agentfield_tpu_torch.training import (
    adamw,
    init_train_state,
    make_lm_batch,
    make_train_step,
    sgd,
)
from agentfield_tpu_torch.training.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from agentfield_tpu_torch.training.trainer import named_leaves

CFG = dataclasses.replace(get_config("llama-tiny"), dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed=1, B=2, S=16):
    g = torch.Generator().manual_seed(seed)
    return make_lm_batch(torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                       dtype=torch.int32))


def _same_state(a, b) -> None:
    assert a.step == b.step
    for (na, ta), (nb, tb) in zip(named_leaves(a.params), named_leaves(b.params)):
        assert na == nb and ta.dtype == tb.dtype and torch.equal(ta, tb), na
    for pa, pb in zip(a.optimizer.param_groups[0]["params"], b.optimizer.param_groups[0]["params"]):
        sa, sb = a.optimizer.state[pa], b.optimizer.state[pb]
        assert sa.keys() == sb.keys()
        for k in sa:
            assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("dtype,opt", [("float32", adamw(5e-3)), ("bfloat16", adamw(5e-3)),
                                       ("float32", sgd(0.1))], ids=["f32-adamw", "bf16-adamw",
                                                                     "f32-sgd"])
def test_save_restore_bit_equal_and_latest_step(tmp_path, dtype, opt):
    cfg = dataclasses.replace(CFG, dtype=dtype)
    state = init_train_state(cfg, 0, opt, device="cpu")
    step = make_train_step(cfg, opt)
    assert latest_step(tmp_path) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path, init_train_state(cfg, 1, opt, device="cpu"))
    save_checkpoint(tmp_path, state)  # step 0: no moments yet
    for _ in range(2):
        state, _ = step(state, _batch(cfg))
    save_checkpoint(tmp_path, state)
    assert latest_step(tmp_path) == 2
    assert sorted(p.name for p in (tmp_path / "step_2").iterdir()) == [
        "optimizer.safetensors", "params.safetensors", "state.json"]
    meta = json.loads((tmp_path / "step_2" / "state.json").read_text())
    assert meta["step"] == 2 and meta["optimizer"] == dataclasses.asdict(opt)
    back = restore_checkpoint(tmp_path, init_train_state(cfg, 1, opt, device="cpu"))
    _same_state(state, back)
    zero = restore_checkpoint(tmp_path, init_train_state(cfg, 1, opt, device="cpu"), step=0)
    assert zero.step == 0 and not zero.optimizer.state
    assert torch.equal(zero.params["embed"],
                       init_train_state(cfg, 0, opt, device="cpu").params["embed"])


def test_restore_refuses_another_tree(tmp_path):
    state = init_train_state(CFG, 0, sgd(0.1), device="cpu")
    save_checkpoint(tmp_path, state)
    nano = dataclasses.replace(get_config("llama-nano"), dtype="float32")
    with pytest.raises(ValueError, match="param"):
        restore_checkpoint(tmp_path, init_train_state(nano, 0, sgd(0.1), device="cpu"))


def test_resume_equals_an_uninterrupted_run(tmp_path):
    opt = adamw(5e-3)
    step = make_train_step(CFG, opt)
    batch = _batch(CFG, seed=3)
    run = init_train_state(CFG, 0, opt, device="cpu")
    losses = []
    for i in range(4):
        run, m = step(run, batch)
        losses.append(float(m["loss"]))
        if i == 1:
            save_checkpoint(tmp_path, run)
    resumed = restore_checkpoint(tmp_path, init_train_state(CFG, 7, opt, device="cpu"))
    again = []
    for _ in range(2):
        resumed, m = step(resumed, batch)
        again.append(float(m["loss"]))
    assert again == losses[2:]
    _same_state(run, resumed)


def test_jax_orbax_train_state_resumes_on_the_port(tmp_path):
    """JAX: two AdamW steps, ``save_checkpoint`` (orbax), ``restore_checkpoint``
    into its abstract state. Port: the restored tree as numpy through
    ``train_state_from_numpy``; the next two steps' losses are JAX's."""
    jcfg = dataclasses.replace(jax_configs.get_config("llama-tiny"), dtype="float32")
    tx = optax.adamw(5e-3)
    jstate = jax_trainer.init_train_state(jcfg, jax.random.PRNGKey(0), tx)
    jstep = jax_trainer.make_train_step(jcfg, tx)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    jb = jax_trainer.make_lm_batch(jnp.asarray(toks))
    for _ in range(2):
        jstate, _ = jstep(jstate, jb)
    jax_ckpt.save_checkpoint(tmp_path / "jax", jstate)
    abstract = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jstate)
    restored = jax.tree.map(np.asarray, jax_ckpt.restore_checkpoint(tmp_path / "jax", abstract))
    state = train_state_from_numpy(restored.params, restored.opt_state, restored.step,
                                   adamw(5e-3), device="cpu")
    assert state.step == 2
    mu = dict(named_leaves(restored.opt_state[0].mu))
    p0 = state.optimizer.param_groups[0]["params"][0]
    name0 = named_leaves(state.params)[0][0]
    np.testing.assert_array_equal(state.optimizer.state[p0]["exp_avg"].numpy(), mu[name0])
    step = make_train_step(get_config("llama-tiny"), adamw(5e-3))
    pb = make_lm_batch(torch.from_numpy(toks))
    for _ in range(2):
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, pb)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
