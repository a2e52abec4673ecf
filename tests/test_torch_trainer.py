"""The port's trainer (``agentfield_tpu_torch/training/trainer.py``,
``training/optim.py``) and greedy oracle (``models/llama.py``
``generate_greedy``/``forward_with_cache``) against the JAX package's on the
CPU, float32, small presets. Weights are drawn by the JAX package and carried
across with ``params_from_numpy``; token ids come from numpy.

Tolerances (float32; the two frameworks sum in another order):

- the loss within 1e-5 of its value (relative), and every gradient leaf
  within 1e-4 of that leaf's largest JAX gradient magnitude;
- SGD losses per step within 1e-5 relative;
- Adam/AdamW: both fed the same gradients, every param within 1e-6 of its
  magnitude plus 1e-5 * lr an update so far, after each of three updates
  (the bias corrections, the square root and ``eps`` round in another
  order; a component with a gradient near 1e-6 feels ``eps``). Adam's first step is
  about ``lr * sign(g)``, so independent gradients would differ by a whole
  ``lr`` wherever a component of ``g`` is near 0);
- greedy tokens equal, ``forward_with_cache`` logits within 1e-4.

It also holds the C3 repair (no kernel wrapper differentiates: each raises
``NotImplementedError`` under a gradient), the JAX train → export → serve
loop (``tests/test_train_serve_loop.py``) on the port, a JAX-exported
checkpoint of JAX-trained weights served by a port node, and
``chip_smoke.phase_train`` rehearsed at small size with ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from agentfield_tpu.models import configs as jax_configs
from agentfield_tpu.models import hf_loader as jax_hf
from agentfield_tpu.models import llama as jax_llama
from agentfield_tpu.training import trainer as jax_trainer
from agentfield_tpu_torch.models import llama
from agentfield_tpu_torch.models.configs import LlamaConfig, RopeScaling, get_config
from agentfield_tpu_torch.models.convert import params_from_numpy, train_state_from_numpy
from agentfield_tpu_torch.models.hf_loader import save_hf_checkpoint
from agentfield_tpu_torch.models.quant import quantize_params
from agentfield_tpu_torch.serving.engine import EngineConfig
from agentfield_tpu_torch.serving.model_node import build_model_node
from agentfield_tpu_torch.training import (
    adam,
    adamw,
    causal_lm_loss,
    init_train_state,
    make_lm_batch,
    make_train_step,
    sgd,
)
from agentfield_tpu_torch.training.trainer import named_leaves

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
ADAM_UPDATE_REL = 1e-5
ECFG = dict(max_batch=2, page_size=8, num_pages=64, max_pages_per_seq=8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny models gain nothing from intra-op threads; one keeps this file
    off the cores that concurrent test workers time their locks on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(name: str):
    return dataclasses.replace(jax_configs.get_config(name), dtype="float32")


def _pt_cfg(jcfg) -> LlamaConfig:
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    if jcfg.rope_scaling is not None:
        fields["rope_scaling"] = RopeScaling(**dataclasses.asdict(jcfg.rope_scaling))
    return LlamaConfig(**fields)


def _jax_tree(jcfg, seed=0):
    return jax.tree.map(np.asarray, jax_llama.init_params(jcfg, jax.random.PRNGKey(seed)))


def _tokens(vocab: int, B=2, S=16, seed=1) -> np.ndarray:
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)
    toks[0, 3] = 7  # a repeated id: its embedding row sums two gradients
    toks[1, 5] = 7
    return toks


def _batches(toks: np.ndarray):
    """JAX's batch and the port's from the same ids; one target masked
    beside the final column, so the mask's average shows."""
    jb = jax_trainer.make_lm_batch(jnp.asarray(toks))
    jb["targets"] = jb["targets"].at[0, 2].set(-1)
    pb = make_lm_batch(torch.from_numpy(toks))
    pb["targets"][0, 2] = -1
    return jb, pb


def _grads_close(pt_named: dict, jax_tree) -> None:
    for name, jg in named_leaves(jax.tree.map(np.asarray, jax_tree)):
        g = pt_named[name].detach().numpy()
        scale = float(np.abs(jg).max())
        err = float(np.abs(g - jg).max())
        assert err <= GRAD_REL * scale + 1e-9, (name, err, scale)


@pytest.mark.parametrize("preset", ["llama-tiny", "gemma-tiny", "mixtral-tiny"])
def test_causal_lm_loss_and_grads_match_jax(preset):
    """gemma-tiny: tied embeddings, gelu, scaled embeddings; mixtral-tiny:
    the soft-routed MoE FFN (the router among the gradients)."""
    jcfg = _f32(preset)
    tree = _jax_tree(jcfg)
    jb, pb = _batches(_tokens(jcfg.vocab_size))
    (jloss, jm), jgrads = jax.value_and_grad(jax_trainer.causal_lm_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, tree), jcfg, jb)
    params = params_from_numpy(tree, _pt_cfg(jcfg), device="cpu", dtype=torch.float32)
    leaves = dict(named_leaves(params))
    for t in leaves.values():
        t.requires_grad_(True)
    loss, m = causal_lm_loss(params, _pt_cfg(jcfg), pb)
    loss.backward()
    loss = loss.detach()
    assert float(m["tokens"]) == float(jm["tokens"]) == 2 * 16 - 3
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    assert float(m["loss"].detach()) == float(loss)
    _grads_close({k: v.grad for k, v in leaves.items()}, jgrads)


def test_remat_equals_no_remat():
    """The checkpointed layer bodies recompute the same ops: equal loss and
    gradients; without grad mode ``remat`` changes nothing."""
    jcfg = _f32("llama-tiny")
    cfg = _pt_cfg(jcfg)
    tree = _jax_tree(jcfg)
    _, pb = _batches(_tokens(cfg.vocab_size))
    out = []
    for remat in (False, True):
        params = params_from_numpy(tree, cfg, device="cpu", dtype=torch.float32)
        leaves = dict(named_leaves(params))
        for t in leaves.values():
            t.requires_grad_(True)
        logits, _ = llama.forward(params, cfg, pb["tokens"], pb["positions"], collect_kv=False,
                                  remat=remat)
        logits.square().mean().backward()
        out.append((logits.detach(), {k: v.grad for k, v in leaves.items()}))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=1e-7)
    with torch.no_grad():
        a, _ = llama.forward(params, cfg, pb["tokens"], pb["positions"], remat=True)
    assert torch.equal(a, l0)


def test_make_lm_batch_matches_jax():
    toks = _tokens(512, B=3, S=9)
    jb = jax_trainer.make_lm_batch(jnp.asarray(toks))
    pb = make_lm_batch(torch.from_numpy(toks))
    for k in ("tokens", "positions", "targets"):
        np.testing.assert_array_equal(pb[k].numpy(), np.asarray(jb[k]))
        assert pb[k].dtype == torch.int32


def test_sgd_steps_losses_match_jax():
    """Five SGD steps on one batch from the same weights: the loss of every
    step within ``LOSS_RTOL``, and it falls."""
    jcfg = _f32("llama-tiny")
    cfg = _pt_cfg(jcfg)
    jb, pb = _batches(_tokens(cfg.vocab_size, B=2, S=24))
    jstate = jax_trainer.init_train_state(jcfg, jax.random.PRNGKey(0), optax.sgd(0.2))
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate.params), (), 0, sgd(0.2),
                                   device="cpu")
    jstep = jax_trainer.make_train_step(jcfg, optax.sgd(0.2))
    step = make_train_step(cfg, sgd(0.2))
    jl, pl = [], []
    for _ in range(5):
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, pb)
        jl.append(float(jm["loss"]))
        pl.append(float(m["loss"]))
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    assert pl[-1] < pl[0] - 0.05, pl
    assert state.step == int(jstate.step) == 5


@pytest.mark.parametrize("kind", ["adam", "adamw"])
def test_adam_updates_match_optax_on_the_same_gradients(kind):
    """optax and the port's optimizer fed identical gradients (different each
    step, some near 0): params equal after each update; AdamW's decay is
    optax's 1e-4 default."""
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 5), "b": (7,)}
    p0 = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(0, 1, s) * rng.choice([1e-6, 1.0], s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    lr = 3e-2
    tx = optax.adam(lr) if kind == "adam" else optax.adamw(lr)
    spec = adam(lr) if kind == "adam" else adamw(lr)
    assert spec.weight_decay == (0.0 if kind == "adam" else 1e-4)
    jp = jax.tree.map(jnp.asarray, p0)
    js = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in p0.items()}
    opt = spec(list(tp.values()))
    for g in grads:
        upd, js = tx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k in shapes:
            want = np.asarray(jp[k])
            np.testing.assert_allclose(tp[k].detach().numpy(), want, rtol=1e-6,
                                       atol=ADAM_UPDATE_REL * lr * len(grads))


def test_jax_adamw_state_carried_across_continues_like_jax():
    """A JAX ``TrainState`` after two AdamW steps, moved with
    ``train_state_from_numpy``: the port's next two losses are JAX's."""
    jcfg = _f32("llama-tiny")
    cfg = _pt_cfg(jcfg)
    jb, pb = _batches(_tokens(cfg.vocab_size, B=2, S=16, seed=4))
    tx = optax.adamw(5e-3)
    jstate = jax_trainer.init_train_state(jcfg, jax.random.PRNGKey(2), tx)
    jstep = jax_trainer.make_train_step(jcfg, tx)
    for _ in range(2):
        jstate, _ = jstep(jstate, jb)
    host = jax.tree.map(np.asarray, jstate)
    state = train_state_from_numpy(host.params, host.opt_state, host.step, adamw(5e-3),
                                   device="cpu")
    assert state.step == 2
    step = make_train_step(cfg, adamw(5e-3))
    for _ in range(2):
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, pb)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)


def test_generate_greedy_and_forward_with_cache_match_jax():
    jcfg = _f32("llama-tiny")
    cfg = _pt_cfg(jcfg)
    tree = _jax_tree(jcfg, seed=5)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_numpy(tree, cfg, device="cpu", dtype=torch.float32)
    prompt = np.random.default_rng(6).integers(1, cfg.vocab_size, (2, 7)).astype(np.int32)
    want = np.asarray(jax_llama.generate_greedy(jparams, jcfg, jnp.asarray(prompt), 6, 16))
    got = llama.generate_greedy(params, cfg, torch.from_numpy(prompt), 6, 16)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the cache's logits: a prompt at offset 0, then one token at offset 7
    jc = jax_llama.make_contiguous_cache(jcfg, 2, 16)
    pc = llama.make_contiguous_cache(cfg, 2, 16, device="cpu")
    jl, jc = jax_llama.forward_with_cache(jparams, jcfg, jnp.asarray(prompt), jc, jnp.int32(0))
    pl, pc = llama.forward_with_cache(params, cfg, torch.from_numpy(prompt), pc, 0)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4)
    nxt = np.array(want[:, :1])
    jl, jc = jax_llama.forward_with_cache(jparams, jcfg, jnp.asarray(nxt), jc, jnp.int32(7))
    pl, pc = llama.forward_with_cache(params, cfg, torch.from_numpy(nxt), pc, 7)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(pc["k"].numpy(), np.asarray(jc["k"]), atol=1e-5)
    for steps, max_len in ((0, 16), (11, 16)):
        with pytest.raises(ValueError) as je:
            jax_llama.generate_greedy(jparams, jcfg, jnp.asarray(prompt), steps, max_len)
        with pytest.raises(ValueError) as pe:
            llama.generate_greedy(params, cfg, torch.from_numpy(prompt), steps, max_len)
        assert str(pe.value).split(";")[0] == str(je.value).split(";")[0]


def test_kernel_wrappers_refuse_gradients():
    """C3: under a gradient the kernel paths raise (on the CPU too, where
    their plain versions would differentiate), as ``jax.grad`` through the
    Pallas call raises; without one they run; ``attn_impl="ref"`` trains."""
    from agentfield_tpu_torch.ops.cuda.ragged_paged_attention import dense_causal_attention

    cfg = get_config("llama-nano")
    params = llama.init_params(cfg, seed=0, dtype="float32", device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 8))
    pos = torch.arange(8)[None]
    params["embed"].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        llama.forward(params, cfg, toks, pos, attn_impl="kernel")
    with pytest.raises(NotImplementedError, match="no backward"):
        causal_lm_loss(params, cfg, make_lm_batch(toks), attn_impl="kernel")
    with torch.no_grad():
        k, _ = llama.forward(params, cfg, toks, pos, attn_impl="kernel")
        r, _ = llama.forward(params, cfg, toks, pos, attn_impl="ref")
    torch.testing.assert_close(k, r)
    logits, _ = llama.forward(params, cfg, toks, pos, attn_impl="ref")
    logits.sum().backward()
    assert params["embed"].grad is not None
    q = torch.randn(1, 8, 4, 16, requires_grad=True)
    kv = torch.randn(1, 8, 2, 16)
    with pytest.raises(NotImplementedError):
        dense_causal_attention(q, kv, kv)
    # the int8-weight product: QuantW on the right of @, and the expert stacks
    qp = quantize_params(params)
    x = torch.randn(3, cfg.hidden_size, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        x @ qp["layers"]["wq"][0]
    with torch.no_grad():
        assert (x @ qp["layers"]["wq"][0]).shape == (3, cfg.q_dim)
    mix = get_config("mixtral-tiny")
    mq = quantize_params(llama.init_params(mix, seed=0, dtype="float32", device="cpu"))
    xe = torch.randn(1, 2, mix.hidden_size, requires_grad=True)
    with pytest.raises(NotImplementedError):
        mq["layers"]["w_gate"][0].expert_einsum("bsd,edf->besf", xe)


def test_mesh_training_is_not_ported():
    cfg = get_config("llama-nano")
    with pytest.raises(NotImplementedError, match="A5"):
        make_train_step(cfg, sgd(0.1), attn_impl="ring")
    with pytest.raises(NotImplementedError, match="A5"):
        init_train_state(cfg, 0, sgd(0.1), mesh=object(), device="cpu")


def _node_tokens(backend, prompt: list[int], n: int) -> list[int]:
    backend.start()
    try:
        return backend.generate(tokens=prompt, max_new_tokens=n, timeout=60)["tokens"]
    finally:
        backend.stop()


def test_train_export_serve_on_the_port(tmp_path):
    """``tests/test_train_serve_loop.py`` on the port: fine-tune a few AdamW
    steps (the loss falls), export the tuned weights as an HF checkpoint,
    serve it from a port node: the greedy tokens are the port's
    ``generate_greedy`` on the node's (bf16-loaded) params."""
    cfg = dataclasses.replace(get_config("llama-tiny"), dtype="float32")
    opt = adamw(5e-3)
    state = init_train_state(cfg, 0, opt, device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = make_lm_batch(torch.randint(0, cfg.vocab_size, (4, 32), generator=g,
                                        dtype=torch.int32))
    step = make_train_step(cfg, opt)
    losses = []
    for _ in range(3):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
    ckpt = tmp_path / "tuned"
    save_hf_checkpoint(ckpt, cfg, state.params)
    _, backend = build_model_node(checkpoint=str(ckpt), device="cpu", ecfg=EngineConfig(**ECFG))
    out = _node_tokens(backend, [5, 6, 7, 8], 4)
    expected = llama.generate_greedy(backend.engine.params, backend.cfg,
                                     torch.tensor([[5, 6, 7, 8]]), 4, 32)[0].tolist()
    assert out == expected
    # the served weights are the tuned ones, rounded to bf16 by the load
    torch.testing.assert_close(backend.engine.params["layers"]["wq"],
                               state.params["layers"]["wq"].detach().to(torch.bfloat16))


def test_jax_trained_checkpoint_served_by_a_port_node(tmp_path):
    """JAX fine-tunes and exports; a port node serves the checkpoint: its
    greedy tokens are JAX's ``generate_greedy`` on the JAX load of the same
    directory (both bf16)."""
    jcfg = jax_configs.get_config("llama-tiny")
    tx = optax.adamw(5e-3)
    jstate = jax_trainer.init_train_state(jcfg, jax.random.PRNGKey(0), tx)
    toks = jax.random.randint(jax.random.PRNGKey(1), (4, 32), 0, jcfg.vocab_size, jnp.int32)
    jstep = jax_trainer.make_train_step(jcfg, tx)
    jb = jax_trainer.make_lm_batch(toks)
    for _ in range(3):
        jstate, _ = jstep(jstate, jb)
    ckpt = tmp_path / "jax_tuned"
    jax_hf.save_hf_checkpoint(ckpt, jcfg, jstate.params)
    lcfg, lparams = jax_hf.load_hf_checkpoint(ckpt)
    prompt = [[5, 6, 7, 8], [9, 10, 11, 12, 13, 14]]
    _, backend = build_model_node(checkpoint=str(ckpt), device="cpu", ecfg=EngineConfig(**ECFG))
    for p in prompt:
        want = jax_llama.generate_greedy(lparams, lcfg, jnp.asarray([p], jnp.int32), 6, 32)
        assert _node_tokens(backend, p, 6) == np.asarray(want)[0].tolist()


def test_phase_train_rehearsed_on_cpu(tmp_path):
    """``chip_smoke.phase_train`` end to end at small size on the CPU: the
    LoRA run, its adapter served bf16 and int8 over HTTP, the full
    fine-tune with its checkpoint resumed, and train → export → serve."""
    results: dict = {}
    chip_smoke.phase_train(results, {}, 0, device="cpu", root=str(tmp_path),
                           **chip_smoke.TRAIN_REHEARSAL)
    out = results["train"]
    assert out["lora"]["losses"][-1] < out["lora"]["losses"][0]
    assert out["lora"]["step0_equals_base"] and out["serve"]["greedy_equal"]
    assert out["full"]["restored_bit_equal"] and out["export"]["greedy_equal"]
    assert list(tmp_path.iterdir()) == []  # every directory it made is gone
