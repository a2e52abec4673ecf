"""LoRA on the port (``agentfield_tpu_torch/training/lora.py``) — the cases
of ``tests/test_lora.py`` one by one, and the port against the JAX package:
the LoRA loss and the adapters' gradients against ``jax.value_and_grad`` of
the JAX step's loss (float32, llama-tiny; the loss within 1e-5 relative, each
gradient within 1e-4 of its largest JAX magnitude), a JAX adapter (orbax,
read by the JAX ``load_adapter``) carried across by ``lora_from_numpy``
merging to the JAX ``merge_lora``'s params (within 1e-6: one float32 sum of
``r`` products and a scale), the artifact round trip, ``build_model_node(
lora=)`` serving the tuned behaviour in bf16 and int8, the "different model"
refusal, and ``--lora`` on a port node in a child process.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from agentfield_tpu.models import configs as jax_configs
from agentfield_tpu.models import llama as jax_llama
from agentfield_tpu.training import lora as jax_lora
from agentfield_tpu.training import trainer as jax_trainer
from agentfield_tpu_torch.models import llama
from agentfield_tpu_torch.models.configs import get_config
from agentfield_tpu_torch.models.convert import lora_from_numpy, params_from_numpy
from agentfield_tpu_torch.models.quant import quantize_params
from agentfield_tpu_torch.serving.engine import EngineConfig, InferenceEngine, Request
from agentfield_tpu_torch.serving.model_node import GRAMMAR_SLOTS, build_model_node
from agentfield_tpu_torch.serving.sampler import SamplingParams
from agentfield_tpu_torch.training import (
    LoRAConfig,
    adam,
    causal_lm_loss,
    init_lora_params,
    init_lora_state,
    load_adapter,
    make_lm_batch,
    make_lora_train_step,
    merge_lora,
    save_adapter,
)
from agentfield_tpu_torch.training.checkpoint import restore_checkpoint, save_checkpoint
from agentfield_tpu_torch.training.trainer import named_leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = dataclasses.replace(get_config("llama-tiny"), dtype="float32")
JCFG = dataclasses.replace(jax_configs.get_config("llama-tiny"), dtype="float32")
LCFG = LoRAConfig(rank=4, alpha=8.0)
ECFG = dict(max_batch=2, page_size=8, num_pages=64, max_pages_per_seq=8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, jax_llama.init_params(JCFG, jax.random.PRNGKey(0)))


@pytest.fixture
def params(tree):
    return params_from_numpy(tree, CFG, device="cpu", dtype=torch.float32)


def _batch(seed=1, B=2, S=16):
    toks = torch.from_numpy(
        np.random.default_rng(seed).integers(0, CFG.vocab_size, (B, S)).astype(np.int32))
    return make_lm_batch(toks)


def _train(params, lcfg, lr, steps, seed, batch):
    opt = adam(lr)
    state = init_lora_state(CFG, lcfg, seed, opt, device="cpu")
    step = make_lora_train_step(CFG, lcfg, opt)
    losses = []
    for _ in range(steps):
        state, m = step(state, params, batch)
        losses.append(float(m["loss"]))
    return state, losses


def _constant_batch(seed: int, target: int):
    batch = _batch(seed)
    batch["targets"] = torch.full_like(batch["targets"], target)
    batch["targets"][:, -1] = -1
    return batch


def test_identity_at_init(params):
    """b is zero-init: the merged model IS the base model at step 0."""
    lora = init_lora_params(CFG, LCFG, seed=1, device="cpu")
    merged = merge_lora(params, lora, LCFG)
    toks = torch.tensor([[5, 6, 7, 8]])
    pos = torch.arange(4)[None]
    base_out, _ = llama.forward(params, CFG, toks, pos, collect_kv=False)
    lora_out, _ = llama.forward(merged, CFG, toks, pos, collect_kv=False)
    assert torch.equal(lora_out, base_out)
    assert all(torch.equal(merged["layers"][t], params["layers"][t]) for t in LCFG.targets)


def test_lora_training_moves_only_adapters(params):
    """The loss falls; the base tree is bit-identical after training; only
    adapters and their optimizer moments exist and change."""
    before = {k: v.clone() for k, v in named_leaves(params)}
    state, losses = _train(params, LCFG, 5e-3, 15, 2, _batch())
    assert losses[-1] < losses[0] - 0.1, losses[:3] + losses[-3:]
    assert all(torch.equal(v, before[k]) and not v.requires_grad
               for k, v in named_leaves(params))
    assert float(state.params["layers"]["wq_b"].detach().abs().max()) > 0
    lora_shapes = {t.shape for _, t in named_leaves(state.params)}
    moments = [v for s in state.optimizer.state.values() for k, v in s.items() if k != "step"]
    assert moments and all(m.shape in lora_shapes for m in moments)
    assert state.step == 15


def test_merge_matches_training_forward(params):
    """Serving uses merge_lora once, training per step: the loss of the
    merged tree is the loss the next step reports, and it differs from the
    base's."""
    state, _ = _train(params, LCFG, 5e-3, 5, 3, _batch(2))
    merged = merge_lora(params, state.params, LCFG)
    with torch.no_grad():
        served, _ = causal_lm_loss(merged, CFG, _batch(2))
        base, _ = causal_lm_loss(params, CFG, _batch(2))
    step = make_lora_train_step(CFG, LCFG, adam(5e-3))
    _, m = step(state, params, _batch(2))
    assert float(m["loss"]) == float(served)
    assert float(served) != float(base)


def test_merged_model_serves(params):
    """fine-tune → merge → serve: the engine runs the merged params."""
    state, _ = _train(params, LCFG, 5e-3, 5, 4, _batch(3))
    with torch.no_grad():
        merged = merge_lora(params, state.params, LCFG)
    eng = InferenceEngine(merged, CFG, EngineConfig(max_batch=2, page_size=16, num_pages=32,
                                                     max_pages_per_seq=4), device="cpu")
    out = eng.run_to_completion(
        [Request(id="l", prompt=[5, 6, 7], sampling=SamplingParams(max_new_tokens=5))])
    eng.close()
    assert len(out["l"]) == 5


def test_lora_under_a_mesh_is_not_ported():
    """The JAX test shards ``b`` over a TP mesh; the port has no mesh yet."""
    with pytest.raises(NotImplementedError, match="A5"):
        init_lora_state(CFG, LCFG, 5, adam(5e-3), mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="A5"):
        make_lora_train_step(CFG, LCFG, adam(5e-3), mesh=object())


def test_lora_rejects_moe_mlp_targets():
    mix = get_config("mixtral-tiny")
    bad = LoRAConfig(targets=("wq", "w_up"))
    with pytest.raises(ValueError, match="MoE") as pe:
        init_lora_params(mix, bad, device="cpu")
    with pytest.raises(ValueError) as je:
        jax_lora.init_lora_params(jax_configs.get_config("mixtral-tiny"),
                                  jax_lora.LoRAConfig(targets=("wq", "w_up")),
                                  jax.random.PRNGKey(0))
    assert str(pe.value) == str(je.value)
    with pytest.raises(ValueError, match="unknown LoRA targets"):
        init_lora_params(CFG, LoRAConfig(targets=("wz",)), device="cpu")
    init_lora_params(mix, LoRAConfig(targets=("wq", "wv")), device="cpu")


def test_lora_loss_and_adapter_grads_match_jax(tree, params):
    """The JAX step's loss (``merge_lora`` + ``causal_lm_loss``) and its
    gradients in the adapters, from a JAX adapter moved across after two
    JAX steps (``b`` nonzero)."""
    lcfg = LoRAConfig(rank=4, alpha=8.0, targets=("wq", "wv", "w_down"))
    jl = jax_lora.LoRAConfig(rank=4, alpha=8.0, targets=("wq", "wv", "w_down"))
    toks = np.random.default_rng(7).integers(0, CFG.vocab_size, (2, 16)).astype(np.int32)
    jb = jax_trainer.make_lm_batch(jnp.asarray(toks))
    tx = optax.adam(5e-3)
    jstate = jax_lora.init_lora_state(JCFG, jl, jax.random.PRNGKey(8), tx)
    jstep = jax_lora.make_lora_train_step(JCFG, jl, tx)
    jbase = jax.tree.map(jnp.asarray, tree)
    for _ in range(2):
        jstate, _ = jstep(jstate, jbase, jb)

    def loss_fn(lora):
        return jax_trainer.causal_lm_loss(jax_lora.merge_lora(jbase, lora, jl), JCFG, jb)

    (jloss, _), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(jstate.params)
    lora = lora_from_numpy(jax.tree.map(np.asarray, jstate.params), lcfg, device="cpu")
    for _, t in named_leaves(lora):
        t.requires_grad_(True)
    loss, _ = causal_lm_loss(merge_lora(params, lora, lcfg), CFG,
                             make_lm_batch(torch.from_numpy(toks)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for name, jg in named_leaves(jax.tree.map(np.asarray, jgrads)):
        g = dict(named_leaves(lora))[name].grad.numpy()
        assert np.abs(g - jg).max() <= 1e-4 * np.abs(jg).max() + 1e-9, name


def test_lora_checkpoint_round_trip(tmp_path, params):
    """An adapter state rides the train-state checkpoint: tiny artifacts,
    restored bit for bit into a fresh state (moments and step too)."""
    state, _ = _train(params, LCFG, 5e-3, 2, 6, _batch(6))
    save_checkpoint(tmp_path / "adapter", state)
    back = restore_checkpoint(tmp_path / "adapter",
                              init_lora_state(CFG, LCFG, 99, adam(5e-3), device="cpu"))
    assert back.step == 2
    for (_, a), (_, b) in zip(named_leaves(state.params), named_leaves(back.params)):
        assert torch.equal(a, b)
    for pa, pb in zip(state.optimizer.param_groups[0]["params"],
                      back.optimizer.param_groups[0]["params"]):
        sa, sb = state.optimizer.state[pa], back.optimizer.state[pb]
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.fixture(scope="module")
def tuned_42(tree, tmp_path_factory):
    """The JAX test's constant-token mode ("always emit 42"), which needs
    ``w_down`` among the targets at rank 4, trained on the port and saved."""
    params = params_from_numpy(tree, CFG, device="cpu", dtype=torch.float32)
    lcfg = LoRAConfig(rank=4, alpha=8.0, targets=("wq", "wv", "w_down"))
    state, _ = _train(params, lcfg, 1e-2, 40, 9, _constant_batch(9, 42))
    d = tmp_path_factory.mktemp("ad")
    save_adapter(d, state.params, lcfg)
    return d, lcfg, state.params


def test_adapter_artifact_round_trip(tuned_42):
    d, lcfg, lora = tuned_42
    lcfg2, back = load_adapter(d, device="cpu")
    assert lcfg2 == lcfg
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(named_leaves(lora),
                                                          named_leaves(back)))
    meta = json.loads((d / "lora_config.json").read_text())
    assert set(meta) == {"rank", "alpha", "targets", "dtype", "shapes", "dtypes"}
    assert meta["dtypes"]["wq_a"] == "float32" and meta["shapes"]["w_down_b"] == [2, 4, 128]


@pytest.mark.parametrize("quant", [None, "int8"])
def test_adapter_node_serves_the_tuned_behaviour(tuned_42, params, quant):
    """``build_model_node(lora=dir)`` on bf16 base weights merges the adapter
    at load (before int8 quantization) and serves the tuned behaviour; its
    weights are ``merge_lora``'s (then ``quantize_params``')."""
    d, lcfg, lora = tuned_42
    base = {k: v.to(torch.bfloat16) if isinstance(v, torch.Tensor) else
            {n: t.to(torch.bfloat16) for n, t in v.items()} for k, v in params.items()}
    _, backend = build_model_node("llama-tiny", params=base, ecfg=EngineConfig(**ECFG),
                                  device="cpu", lora=str(d), quant=quant)
    want = merge_lora(base, lora, lcfg)
    if quant:
        want = quantize_params(want)
        got = backend.engine.params["layers"]["w_down"]
        assert torch.equal(got.q, want["layers"]["w_down"].q)
    else:
        assert torch.equal(backend.engine.params["layers"]["w_down"], want["layers"]["w_down"])
    backend.start()
    try:
        r = backend.generate(prompt="anything", max_new_tokens=6, timeout=60)
    finally:
        backend.stop()
    assert r["tokens"].count(42) >= 4, r["tokens"]


def test_lora_composes_with_int8_serving(tmp_path, params):
    """The JAX test's attention-only adapter (rank 4) tuned to emit 55: an
    int8 node serves it (quantizing first would freeze the base)."""
    state, _ = _train(params, LCFG, 1e-2, 40, 11, _constant_batch(11, 55))
    save_adapter(tmp_path / "ad8", state.params, LCFG)
    _, backend = build_model_node("llama-tiny", params=params, ecfg=EngineConfig(**ECFG),
                                  device="cpu", lora=str(tmp_path / "ad8"), quant="int8")
    backend.start()
    try:
        r = backend.generate(prompt="anything", max_new_tokens=6, timeout=60)
    finally:
        backend.stop()
    assert r["tokens"].count(55) >= 4, r["tokens"]


def test_mismatched_adapter_is_a_different_model(tuned_42):
    d, _, _ = tuned_42
    with pytest.raises(ValueError, match="different model"):
        build_model_node("llama-nano", lora=str(d), device="cpu",
                         ecfg=EngineConfig(max_batch=2, page_size=8, num_pages=32,
                                           max_pages_per_seq=4))


def test_jax_adapter_carried_across(tmp_path, tree, params):
    """A JAX adapter artifact (orbax): the port's ``load_adapter`` refuses
    it; the JAX ``load_adapter``'s tree through ``lora_from_numpy`` merges
    to the JAX ``merge_lora``'s params, and re-saved it serves."""
    jl = jax_lora.LoRAConfig(rank=4, alpha=8.0, targets=("wq", "wk", "w_up"))
    tx = optax.adam(1e-2)
    jstate = jax_lora.init_lora_state(JCFG, jl, jax.random.PRNGKey(12), tx)
    jstep = jax_lora.make_lora_train_step(JCFG, jl, tx)
    toks = jnp.asarray(np.random.default_rng(12).integers(0, CFG.vocab_size, (2, 16)), jnp.int32)
    jbase = jax.tree.map(jnp.asarray, tree)
    for _ in range(3):
        jstate, _ = jstep(jstate, jbase, jax_trainer.make_lm_batch(toks))
    jax_lora.save_adapter(tmp_path / "jax_ad", jstate.params, jl)
    with pytest.raises(ValueError, match="lora_from_numpy"):
        load_adapter(tmp_path / "jax_ad", device="cpu")
    jl2, jadapter = jax_lora.load_adapter(tmp_path / "jax_ad")
    lcfg = LoRAConfig(rank=jl2.rank, alpha=jl2.alpha, targets=jl2.targets, dtype=jl2.dtype)
    lora = lora_from_numpy(jax.tree.map(np.asarray, jadapter), lcfg, device="cpu")
    jmerged = jax.tree.map(np.asarray, jax_lora.merge_lora(jbase, jadapter, jl2))
    merged = merge_lora(params, lora, lcfg)
    for t in lcfg.targets:
        np.testing.assert_allclose(merged["layers"][t].numpy(), jmerged["layers"][t], atol=1e-6)
    with pytest.raises(ValueError, match="not the targets"):
        lora_from_numpy(jax.tree.map(np.asarray, jadapter), LCFG, device="cpu")
    save_adapter(tmp_path / "port_ad", lora, lcfg)
    _, backend = build_model_node("llama-tiny", params=params, ecfg=EngineConfig(**ECFG),
                                  device="cpu", lora=str(tmp_path / "port_ad"))
    assert torch.equal(backend.engine.params["layers"]["w_up"], merged["layers"]["w_up"])


def test_lora_flag_on_a_child_process_node(tuned_42):
    """``python -m agentfield_tpu_torch.serving.model_node --lora DIR``: the
    child's greedy tokens are those of an in-process node built with
    ``lora=`` on the same seed and the CLI's engine config."""
    d, _, _ = tuned_42
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "agentfield_tpu_torch.serving.model_node", "--device", "cpu",
         "--model", "llama-tiny", "--port", "0", "--seed", "0", "--lora", str(d)],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            m = re.search(r"serving on (http://\S+)", line)
            if m:
                break
        assert m, lines
        req = urllib.request.Request(
            f"{m.group(1)}/reasoners/generate",
            data=json.dumps({"input": {"tokens": [5, 6, 7, 8], "max_new_tokens": 6}}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            got = json.loads(resp.read())["result"]["tokens"]
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        proc.stdout.close()
    assert proc.returncode == 0
    _, backend = build_model_node("llama-tiny", seed=0, device="cpu", lora=str(d),
                                  ecfg=EngineConfig(grammar_slots=GRAMMAR_SLOTS))
    backend.start()
    try:
        want = backend.generate(tokens=[5, 6, 7, 8], max_new_tokens=6, timeout=60)["tokens"]
    finally:
        backend.stop()
    assert got == want
