"""The port's MoE FFN (``agentfield_tpu_torch.models.moe``, ``llama._moe_mlp``
/ ``_moe_mlp_sparse``, ``QuantW.expert_einsum``, the engine's
``moe_prefill_impl``) against the JAX package's, on the CPU: mixtral-tiny in
float32, weights carried JAX -> numpy -> ``params_from_numpy``.

- ``topk_router_weights``, ``expert_capacity`` and ``sparse_plan`` (with and
  without ``valid``) equal to JAX's outputs; ``dispatch_tokens`` and
  ``combine_tokens`` within ``ATOL_DISPATCH``; ``moe_ffn`` and
  ``moe_ffn_sparse`` within ``ATOL``;
- ``mlp_block`` (soft and sparse) and ``forward`` logits within ``ATOL``,
  and sparse dispatch at factor E against soft routing within JAX's own
  2e-4 (``tests/test_moe.py``);
- ``QuantW.expert_einsum`` at all four specs within ``RTOL_EINSUM`` of max
  |y|, q and scale carried exactly, and ``ValueError`` on another spec;
- the JAX MoE engine scripts (``tests/test_moe.py``, ``tests/test_quant.
  py::test_mixtral_quantized_serving``) through both engines: equal greedy
  tokens. The batched sparse prefill runs at factor 1.0 (the JAX script's)
  and at a factor tight enough to drop entries: the port sizes capacity
  from the JAX engine's padded prefill, so the same entries overflow;
- the engines' ``moe_impl`` / ``moe_prefill_impl`` checks raise alike;
- ``init_params`` of mixtral-tiny has ``cfg.num_params`` elements, and
  ``build_model_node(model="mixtral-tiny", quant="int8")`` serves;
- ``chip_smoke.phase_moe`` rehearsed with ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentfield_tpu.models import configs as jax_configs
from agentfield_tpu.models import llama as jax_llama
from agentfield_tpu.models import moe as jax_moe
from agentfield_tpu.models import quant as jax_quant
from agentfield_tpu.serving import engine as jax_engine
from agentfield_tpu.serving.sampler import SamplingParams as JaxSampling
from agentfield_tpu_torch.models import llama, moe, quant
from agentfield_tpu_torch.models.configs import get_config
from agentfield_tpu_torch.models.convert import params_from_numpy
from agentfield_tpu_torch.serving import engine
from agentfield_tpu_torch.serving.engine import EngineConfig
from agentfield_tpu_torch.serving.model_node import build_model_node
from agentfield_tpu_torch.serving.sampler import SamplingParams

ATOL = 1e-5  # float32: the same products summed in another order
ATOL_DISPATCH = 1e-6  # scatter/gather and one weighted sum
RTOL_EINSUM = 1e-6  # expert_einsum, relative to max |y|
SPARSE_VS_SOFT = 2e-4  # tests/test_moe.py::test_mixtral_sparse_prefill_matches_dense
ECFG = dict(max_batch=2, page_size=16, num_pages=32, max_pages_per_seq=4)  # test_moe.py's
NAME = "mixtral-tiny"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """mixtral-tiny gains nothing from intra-op threads; one keeps this file
    off the cores that concurrent test workers time their locks on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**over):
    jcfg = dataclasses.replace(jax_configs.get_config(NAME), dtype="float32", **over)
    cfg = dataclasses.replace(get_config(NAME), dtype="float32", **over)
    return jcfg, cfg


def _carry(seed: int, quantized: bool = False, **over):
    """(jax cfg, JAX tree as numpy leaves, port params, port cfg)."""
    jcfg, cfg = _cfgs(**over)
    tree = jax_llama.init_params(jcfg, jax.random.PRNGKey(seed))
    if quantized:
        tree = jax_quant.quantize_params(tree)
    tree = jax.tree.map(np.asarray, tree)
    return jcfg, tree, params_from_numpy(tree, cfg, device="cpu"), cfg


@pytest.fixture(scope="module")
def weights():
    return _carry(0)


@pytest.fixture(scope="module")
def qweights():
    return _carry(0, quantized=True)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# models/moe.py


def test_topk_router_weights_equal_jax():
    logits = np.random.default_rng(0).standard_normal((2, 7, 8)).astype(np.float32)
    for k in (1, 2, 3):
        want = np.asarray(jax_moe.topk_router_weights(jnp.asarray(logits), k))
        got = moe.topk_router_weights(torch.from_numpy(logits), k).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
        assert ((got > 0).sum(-1) == k).all()
        np.testing.assert_array_equal(got > 0, want > 0)


@pytest.mark.parametrize("args", [(1, 8, 2, 2.0), (7, 4, 2, 1.0), (32, 4, 2, 0.25),
                                  (512, 8, 2, 2.0), (4096, 8, 2, 1.25), (3, 8, 2, 0.1)],
                         ids=str)
def test_expert_capacity_equal_jax(args):
    assert moe.expert_capacity(*args) == jax_moe.expert_capacity(*args)


@pytest.mark.parametrize("with_valid", [False, True], ids=["all_valid", "padding"])
@pytest.mark.parametrize("capacity", [2, 5, 40])
def test_sparse_plan_equal_jax(with_valid, capacity):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((20, 4)).astype(np.float32)
    valid = rng.random(20) < 0.6 if with_valid else None
    want = jax_moe.sparse_plan(jnp.asarray(logits), 2, capacity,
                               None if valid is None else jnp.asarray(valid))
    got = moe.sparse_plan(torch.from_numpy(logits), 2, capacity,
                          None if valid is None else torch.from_numpy(valid))
    for name, w, g in zip(("experts", "slots", "keep"), want[:3], got[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=0, atol=1e-7)
    if capacity == 2:  # tight: some entries overflow
        assert not got[2][got[0] < 4].all()


def test_sparse_plan_valid_mask_excludes_padding():
    """tests/test_moe.py's script: padding takes no capacity."""
    logits = torch.tensor([[9.0, 0.0]] * 4)
    valid = torch.tensor([False, False, True, True])
    experts, slots, keep, _ = moe.sparse_plan(logits, k=1, capacity=2, valid=valid)
    assert slots[2] == 0 and slots[3] == 1 and keep[2] and keep[3]
    assert not keep[0] and not keep[1]
    _, _, keep_nm, _ = moe.sparse_plan(logits, k=1, capacity=2)
    assert not keep_nm[2] and not keep_nm[3]


@pytest.mark.parametrize("capacity", [3, 12])
def test_dispatch_and_combine_match_jax(capacity):
    rng = np.random.default_rng(2)
    N, D, E, k = 12, 16, 4, 2
    xt = rng.standard_normal((N, D)).astype(np.float32)
    logits = rng.standard_normal((N, E)).astype(np.float32)
    valid = rng.random(N) < 0.8
    jplan = jax_moe.sparse_plan(jnp.asarray(logits), k, capacity, jnp.asarray(valid))
    tplan = moe.sparse_plan(torch.from_numpy(logits), k, capacity, torch.from_numpy(valid))
    want_buf = np.asarray(jax_moe.dispatch_tokens(jnp.asarray(xt), jplan[0], jplan[1], E, capacity))
    got_buf = moe.dispatch_tokens(torch.from_numpy(xt), tplan[0], tplan[1], E, capacity)
    assert tuple(got_buf.shape) == (E, capacity, D)
    np.testing.assert_allclose(got_buf.numpy(), want_buf, rtol=0, atol=ATOL_DISPATCH)
    y = rng.standard_normal((E, capacity, D)).astype(np.float32)
    want = np.asarray(jax_moe.combine_tokens(jnp.asarray(y), *jplan, k))
    got = moe.combine_tokens(torch.from_numpy(y), *tplan, k).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_DISPATCH)
    assert (got[~valid] == 0).all()


def test_moe_ffn_and_sparse_match_jax():
    mcfg = jax_moe.MoEConfig(hidden_size=32, expert_intermediate=64, num_experts=4, top_k=2)
    tcfg = moe.MoEConfig(hidden_size=32, expert_intermediate=64, num_experts=4, top_k=2)
    p = jax.tree.map(np.asarray, jax_moe.init_moe_params(mcfg, jax.random.PRNGKey(0)))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    x = np.random.default_rng(3).standard_normal((2, 8, 32)).astype(np.float32)
    want = np.asarray(jax_moe.moe_ffn(_j(p), mcfg, jnp.asarray(x)))
    np.testing.assert_allclose(moe.moe_ffn(tp, tcfg, torch.from_numpy(x)).numpy(), want,
                               rtol=0, atol=ATOL)
    for factor in (0.5, 2.0, 4.0):
        want_s = np.asarray(jax_moe.moe_ffn_sparse(_j(p), mcfg, jnp.asarray(x), factor))
        got_s = moe.moe_ffn_sparse(tp, tcfg, torch.from_numpy(x), factor).numpy()
        np.testing.assert_allclose(got_s, want_s, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_s, want, rtol=0, atol=SPARSE_VS_SOFT)  # nothing drops at 4


# ---------------------------------------------------------------------------
# models/llama.py


def test_init_params_has_num_params():
    cfg = get_config(NAME)
    p = llama.init_params(cfg, seed=0, device="cpu")
    n = sum(t.numel() for v in p.values() for t in (v.values() if isinstance(v, dict) else [v]))
    assert n == cfg.num_params
    L, E, d, f = cfg.num_layers, cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
    assert tuple(p["layers"]["router"].shape) == (L, d, E)
    assert tuple(p["layers"]["w_gate"].shape) == (L, E, d, f)
    assert tuple(p["layers"]["w_down"].shape) == (L, E, f, d)
    # drawn quantized, matrix by matrix: the int8 leaves, the router fp
    qp = llama.init_params(cfg, seed=0, device="cpu", quantize=True)
    assert quant.is_quantized(qp) and not isinstance(qp["layers"]["router"], quant.QuantW)
    assert qp["layers"]["w_up"].shape == (L, E, d, f)
    assert qp["layers"]["w_up"].scale.shape == (L, E, f)
    again = llama.init_params(cfg, seed=0, device="cpu", quantize=True)
    assert torch.equal(again["layers"]["w_down"].q, qp["layers"]["w_down"].q)  # seeded
    assert torch.equal(again["embed"], qp["embed"])
    # the same distribution as quantize_params(init_params(...)): scales of
    # std-0.02 normal columns
    ref = quant.quantize_params(p)["layers"]["w_gate"].scale
    got = qp["layers"]["w_gate"].scale
    assert abs(float(got.mean()) / float(ref.mean()) - 1) < 0.05


@pytest.mark.parametrize("impl", ["dense", "sparse"])
def test_mlp_block_matches_jax(weights, impl):
    jcfg, tree, params, cfg = weights
    jcfg, cfg = (dataclasses.replace(c, moe_impl=impl, moe_capacity_factor=0.5)
                 for c in (jcfg, cfg))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, cfg.hidden_size)).astype(np.float32)
    valid = np.ones((2, 9), bool)
    valid[1, 5:] = False
    jlp = {k: jnp.asarray(v[1]) for k, v in tree["layers"].items()}
    for vm in (None, valid):
        want = jax_llama.mlp_block(jlp, jnp.asarray(x), jcfg,
                                   None if vm is None else jnp.asarray(vm))
        got = llama.mlp_block(llama.layer(params, 1), torch.from_numpy(x), cfg,
                              None if vm is None else torch.from_numpy(vm))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("attn", [("ref", "ref"), ("flash", "kernel")], ids=["ref", "kernel"])
@pytest.mark.parametrize("impl", ["dense", "sparse"])
def test_forward_logits_match_jax(weights, impl, attn):
    jcfg, tree, params, cfg = weights
    jcfg, cfg = (dataclasses.replace(c, moe_impl=impl, moe_capacity_factor=0.75)
                 for c in (jcfg, cfg))
    rng = np.random.default_rng(5)
    B, S = 2, 16
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    valid = np.arange(S)[None] < np.array([[S], [11]])
    want, _ = jax_llama.forward_impl(_j(tree), jcfg, jnp.asarray(tokens), jnp.asarray(pos),
                                     collect_kv=False, attn_impl=attn[0],
                                     valid_mask=jnp.asarray(valid))
    got, _ = llama.forward(params, cfg, torch.from_numpy(tokens).long(), torch.from_numpy(pos),
                           attn_impl=attn[1], collect_kv=False,
                           valid_mask=torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_sparse_at_factor_e_matches_soft(weights):
    """tests/test_moe.py::test_mixtral_sparse_prefill_matches_dense in the
    port: with capacity for every entry, sparse dispatch is soft routing."""
    _, _, params, cfg = weights
    toks = torch.tensor([[5, 6, 7, 8, 9, 10, 11, 12]])
    pos = torch.arange(8)[None]
    dense, _ = llama.forward(params, cfg, toks, pos, collect_kv=False)
    scfg = dataclasses.replace(cfg, moe_impl="sparse",
                               moe_capacity_factor=float(cfg.num_experts))
    sparse, _ = llama.forward(params, scfg, toks, pos, collect_kv=False)
    np.testing.assert_allclose(sparse.numpy(), dense.numpy(), rtol=SPARSE_VS_SOFT,
                               atol=SPARSE_VS_SOFT)


def test_bad_moe_impl_raises(weights):
    _, _, params, cfg = weights
    with pytest.raises(ValueError, match="moe_impl"):
        llama.forward(params, dataclasses.replace(cfg, moe_impl="ring"),
                      torch.tensor([[1, 2]]), torch.arange(2)[None], collect_kv=False)


# ---------------------------------------------------------------------------
# models/quant.py and models/convert.py


@pytest.mark.parametrize("spec", list(quant.QuantW._EXPERT_SPECS))
def test_expert_einsum_matches_jax(qweights, spec):
    _, tree, params, cfg = qweights
    E, d, f = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
    key = "w_down" if spec.endswith("->besd") or spec.endswith("->ecd") else "w_gate"
    jw = tree["layers"][key]
    jlw = jax_quant.QuantW(jnp.asarray(jw.q[1]), jnp.asarray(jw.scale[1]))
    tw = params["layers"][key][1]
    k_in = f if key == "w_down" else d
    shape = {"bsd": (2, 5, k_in), "bes": (2, E, 5, k_in), "ecd": (E, 6, k_in),
             "ecf": (E, 6, k_in)}[spec[:3]]
    x = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    want = np.asarray(jlw.expert_einsum(spec, jnp.asarray(x)))
    got = tw.expert_einsum(spec, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL_EINSUM * np.abs(want).max())
    # the quantized leaves came across bit for bit
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q[1]))
    np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jw.scale[1]))
    # the packed layout reads the same (the CPU reads it through unpack)
    packed = quant.pack_quantw(tw)
    assert torch.equal(packed.expert_einsum(spec, torch.from_numpy(x)).float(),
                       torch.from_numpy(got))


def test_expert_einsum_refuses_other_specs(qweights):
    tw = qweights[2]["layers"]["w_gate"][0]
    with pytest.raises(ValueError, match="expert_einsum supports"):
        tw.expert_einsum("bsd,edf->bsef", torch.zeros(1, 2, 128))


def test_converter_takes_moe_leaves(qweights, weights):
    _, qtree, qparams, cfg = qweights
    for k in ("w_gate", "w_up", "w_down"):
        w = qparams["layers"][k]
        assert isinstance(w, quant.QuantW)
        np.testing.assert_array_equal(w.q.numpy(), np.asarray(qtree["layers"][k].q))
        np.testing.assert_array_equal(w.scale.numpy(), np.asarray(qtree["layers"][k].scale))
    assert not isinstance(qparams["layers"]["router"], quant.QuantW)
    np.testing.assert_array_equal(qparams["layers"]["router"].numpy(),
                                  np.asarray(qtree["layers"]["router"]))
    # a (q, scale) pair is taken too; a missing router and a bad expert shape raise
    pair = {**qtree, "layers": {**qtree["layers"], "w_up": (qtree["layers"]["w_up"].q,
                                                            qtree["layers"]["w_up"].scale)}}
    assert torch.equal(params_from_numpy(pair, cfg, device="cpu")["layers"]["w_up"].q,
                       qparams["layers"]["w_up"].q)
    fp = weights[1]
    with pytest.raises(KeyError, match="router"):
        params_from_numpy({**fp, "layers": {k: v for k, v in fp["layers"].items()
                                            if k != "router"}}, cfg, device="cpu")
    with pytest.raises(ValueError, match="layers.w_gate"):
        params_from_numpy({**fp, "layers": {**fp["layers"],
                                            "w_gate": fp["layers"]["w_gate"][:, :2]}},
                          cfg, device="cpu")
    with pytest.raises(ValueError, match="layers.w_down.scale"):
        params_from_numpy({**qtree, "layers": {**qtree["layers"], "w_down": (
            qtree["layers"]["w_down"].q, qtree["layers"]["w_down"].scale[:, 0])}},
            cfg, device="cpu")


def test_quantized_forward_matches_jax(qweights):
    jcfg, tree, params, cfg = qweights
    toks = np.asarray([[9, 8, 7, 6, 5, 4]], np.int32)
    pos = np.arange(6, dtype=np.int32)[None]
    for impl in ("dense", "sparse"):
        jc, c = (dataclasses.replace(x, moe_impl=impl) for x in (jcfg, cfg))
        want, _ = jax_llama.forward(_j(tree), jc, jnp.asarray(toks), jnp.asarray(pos),
                                    collect_kv=False)
        got, _ = llama.forward(params, c, torch.from_numpy(toks).long(), torch.from_numpy(pos),
                               collect_kv=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# the engine


def _req(mod, rid, prompt, new):
    samp = (JaxSampling if mod is jax_engine else SamplingParams)(max_new_tokens=new)
    return mod.Request(id=rid, prompt=prompt, sampling=samp)


def _both(carried, ecfg: dict, script, draft: bool = False):
    """``script(engine, module)`` through the JAX engine and the port's on
    the same weights; returns (JAX result, port result, port engine)."""
    jcfg, tree, params, cfg = carried
    jeng = jax_engine.InferenceEngine(_j(tree), jcfg, jax_engine.EngineConfig(**ecfg),
                                      draft=(_j(tree), jcfg) if draft else None)
    want = script(jeng, jax_engine)
    teng = engine.InferenceEngine(params, cfg, EngineConfig(**ecfg),
                                  draft=(params, cfg) if draft else None)
    try:
        got = script(teng, engine)
    finally:
        teng.close()
    return want, got, teng


def test_round_trip_engine_and_spec_like_jax(weights):
    """tests/test_moe.py::test_mixtral_round_trip_and_engine_serving, the
    engine and speculation part: a MoE target with itself as the draft
    (spec_k=2), then the plain engine."""
    def script(eng, mod):
        return eng.run_to_completion([_req(mod, "m", [5, 6, 7], 6)])

    want, got, teng = _both(weights, dict(ECFG, spec_k=2), script, draft=True)
    assert got == want and len(got["m"]) == 6 and teng.stats["spec_steps"] > 0
    assert teng.draft_prefill_cfg.moe_impl == "dense"
    plain_want, plain, _ = _both(weights, ECFG, script)
    assert plain == plain_want == got


def test_engine_sparse_prefill_serves_like_jax():
    """test_mixtral_engine_sparse_prefill_serves: with capacity for every
    entry the sparse-prefill stream equals the soft one, in both engines."""
    carried = _carry(0, moe_capacity_factor=4.0)

    def script(eng, mod):
        return eng.run_to_completion([_req(mod, "m", [5, 6, 7], 6)])

    dense_want, dense, _ = _both(carried, ECFG, script)
    want, got, teng = _both(carried, dict(ECFG, moe_prefill_impl="sparse"), script)
    assert teng.prefill_cfg.moe_impl == "sparse" and teng.cfg.moe_impl == "dense"
    assert got == want == dense == dense_want


@pytest.mark.parametrize("factor", [1.0, 0.25])
def test_batched_sparse_prefill_padding_immune_like_jax(factor, monkeypatch):
    """test_mixtral_batched_sparse_prefill_padding_immune (factor 1.0: the
    sparse stream equals the soft one) and the same script at a factor that
    drops entries: the port's stream equals the JAX engine's, which needs
    the same capacity (the JAX engine pads the batch to its bucket and
    prefill_batch rows, the port to the longest prompt only)."""
    carried = _carry(0, moe_capacity_factor=factor)
    base = dict(ECFG, prefill_batch=2)
    drops = []
    plan = moe.sparse_plan

    def watched(logits, k, capacity, valid=None):
        out = plan(logits, k, capacity, valid)
        drops.append(int(((out[0] < logits.shape[1]) & ~out[2]).sum()))
        return out

    monkeypatch.setattr(moe, "sparse_plan", watched)

    def script(eng, mod):
        return eng.run_to_completion([_req(mod, "a", [5, 6, 7], 4),
                                      _req(mod, "b", [100, 200, 300, 400], 4)])

    dense_want, dense, _ = _both(carried, base, script)
    want, got, _ = _both(carried, dict(base, moe_prefill_impl="sparse"), script)
    assert got == want
    assert drops  # the port's prefill dispatched sparsely
    if factor == 1.0:
        assert got == dense == dense_want and sum(drops) == 0
    else:
        assert sum(drops) > 0  # the tight factor really dropped entries


def test_engine_sparse_prefill_int8_like_jax():
    """test_mixtral_engine_sparse_prefill_int8: sparse dispatch over int8
    expert stacks."""
    carried = _carry(0, quantized=True, moe_capacity_factor=4.0)

    def script(eng, mod):
        return eng.run_to_completion([_req(mod, "q", [5, 6, 7], 4)])

    want, got, _ = _both(carried, dict(ECFG, moe_prefill_impl="sparse"), script)
    assert got == want and len(got["q"]) == 4


def test_mixtral_quantized_serving_like_jax():
    """tests/test_quant.py::test_mixtral_quantized_serving, the single-device
    part: quantized logits close to fp, and the engine serves."""
    fp = _carry(5)
    carried = _carry(5, quantized=True)
    qp, cfg = carried[2], carried[3]
    assert qp["layers"]["w_gate"].scale.shape == (cfg.num_layers, cfg.num_experts,
                                                  cfg.intermediate_size)
    assert "router" not in quant.QUANT_KEYS
    toks, pos = torch.tensor([[9, 8, 7, 6]]), torch.arange(4)[None]
    lf, _ = llama.forward(fp[2], cfg, toks, pos, collect_kv=False)
    lq, _ = llama.forward(qp, cfg, toks, pos, collect_kv=False)
    assert float((lf - lq).abs().max() / (lf.abs().max() + 1e-6)) < 0.1

    def script(eng, mod):
        return eng.run_to_completion([_req(mod, "q", [1, 2, 3], 6)])

    want, got, _ = _both(carried, ECFG, script)
    assert got == want and len(got["q"]) == 6


def test_engine_moe_checks_raise_like_jax(weights):
    jcfg, tree, params, cfg = weights
    cases = [
        (dict(cfg_over=dict(moe_impl="sparse")), "engine model cfg has moe_impl"),
        (dict(ecfg_over=dict(moe_prefill_impl="ring")), "moe_prefill_impl='ring' must be"),
        (dict(draft_over=dict(moe_impl="sparse"), ecfg_over=dict(spec_k=2)),
         "draft cfg has moe_impl"),
    ]
    for over, msg in cases:
        def run(mod, ecfg_cls, p, c):
            c2 = dataclasses.replace(c, **over.get("cfg_over", {}))
            dc = dataclasses.replace(c, **over.get("draft_over", {}))
            e = ecfg_cls(**dict(ECFG, **over.get("ecfg_over", {})))
            draft = (p, dc) if e.spec_k else None
            return mod.InferenceEngine(p, c2, e, draft=draft)

        with pytest.raises(ValueError, match=msg) as jerr:
            run(jax_engine, jax_engine.EngineConfig, _j(tree), jcfg)
        with pytest.raises(ValueError, match=msg) as terr:
            run(engine, EngineConfig, params, cfg)
        assert str(terr.value) == str(jerr.value)


def test_build_model_node_mixtral_int8_serves():
    server, backend = build_model_node(NAME, ecfg=EngineConfig(**ECFG), device="cpu",
                                       quant="int8")
    p = backend.engine.params
    assert quant.is_quantized(p) and p["layers"]["w_gate"].shape[1] == get_config(NAME).num_experts
    backend.start()
    try:
        r = backend.generate(prompt="hi", max_new_tokens=4)
        assert len(r["tokens"]) == 4
    finally:
        backend.stop()
        backend.engine.close()


def test_smoke_moe_phase_rehearses_on_cpu():
    """``chip_smoke.phase_moe`` end to end on the CPU at mixtral-tiny size:
    the node built quantized, the serve under both prefill modes, kernel and
    plain logits (both the plain version here), the expert-slice products,
    a self-draft spec pass and a mixed burst."""
    import chip_smoke

    results: dict = {}
    chip_smoke.phase_moe(results, 0, device="cpu", model=NAME, lengths=(8, 20, 33),
                         max_new=6, S=24, spec_prompts=(12, 30), burst=((10, 20), (40,)),
                         ecfg=EngineConfig(max_batch=8, page_size=16, num_pages=256,
                                           max_pages_per_seq=32, decode_buckets=(4,),
                                           grammar_slots=64))
    out = results["moe"]
    for mode in ("dense", "sparse"):
        assert results[f"serve_moe_{mode}"]["requests"] == 6
    for mode in ("soft", "sparse"):
        lg = out["logits"][mode]
        assert lg["max_abs_err_f32"] == 0.0 and lg["max_abs_err_bf16"] == 0.0
    assert out["spec"]["spec_steps"] > 0 and out["mixed"]["mixed_ticks"] > 0
    assert out["build"]["weight_bytes"] > 0


def test_smoke_routing_replay_holds_the_choices(weights):
    """``chip_smoke.RoutingReplay``: a replayed forward takes the recorded
    experts (on the same weights: the same logits, no flips); on weights
    whose routers disagree it still takes them, counts the flips, and
    differs from the free forward; the patch is undone on exit."""
    import chip_smoke

    _, _, params, cfg = weights
    toks, pos = torch.tensor([[5, 6, 7, 8, 9, 10]]), torch.arange(6)[None]
    other = {**params, "layers": {**params["layers"], "router": -params["layers"]["router"]}}
    for c in (cfg, dataclasses.replace(cfg, moe_impl="sparse")):
        rr = chip_smoke.RoutingReplay()
        with rr:
            rr.start("record")
            base, _ = llama.forward(params, c, toks, pos, collect_kv=False)
            rr.start("replay")
            again, _ = llama.forward(params, c, toks, pos, collect_kv=False)
            assert torch.equal(again, base) and rr.flips == 0
            assert rr.choices == cfg.num_layers * 6
            rr.start("replay")
            forced, _ = llama.forward(other, c, toks, pos, collect_kv=False)
            assert rr.flips > 0
        assert moe.topk_router_weights is rr.orig[0] and moe.sparse_plan is rr.orig[1]
        free, _ = llama.forward(other, c, toks, pos, collect_kv=False)
        assert not torch.allclose(forced, free)
