"""The port's Llama forward against the JAX package's on the same weights.

Weights are drawn once by the JAX package and carried across with
``params_from_numpy``; token ids come from numpy. Everything runs in float32
on the CPU, where both frameworks compute the same math in a different
order: logits agree to 1e-4."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentfield_tpu.models import configs as jax_configs
from agentfield_tpu.models import llama as jax_llama
from agentfield_tpu_torch.models import llama
from agentfield_tpu_torch.models.configs import LlamaConfig, RopeScaling, get_config
from agentfield_tpu_torch.models.convert import params_from_numpy

ATOL = 1e-4


def _f32(name: str, **over):
    return dataclasses.replace(jax_configs.get_config(name), dtype="float32", **over)


def _pt_cfg(jcfg):
    """The port's config with every field of the JAX config ``jcfg``."""
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    if jcfg.rope_scaling is not None:
        fields["rope_scaling"] = RopeScaling(**dataclasses.asdict(jcfg.rope_scaling))
    return LlamaConfig(**fields)


def _carry(jcfg, seed=0):
    tree = jax.tree.map(np.asarray, jax_llama.init_params(jcfg, jax.random.PRNGKey(seed)))
    return tree, params_from_numpy(tree, _pt_cfg(jcfg), device="cpu", dtype=torch.float32)


CASES = {
    "llama-tiny": _f32("llama-tiny"),
    "gemma-tiny": _f32("gemma-tiny"),
    "llama-tiny-window": _f32("llama-tiny", sliding_window=7),
    "llama-tiny-llama3-rope": _f32(
        "llama-tiny",
        rope_scaling=jax_configs.get_config("llama-3.2-1b").rope_scaling,
        rope_theta=jax_configs.get_config("llama-3.2-1b").rope_theta,
    ),
}


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("case", list(CASES))
def test_forward_logits_match_jax(case, impl):
    jcfg = CASES[case]
    tree, params = _carry(jcfg)
    rng = np.random.default_rng(1)
    B, S = 2, 24
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    # llama3 scaling bends the long wavelengths at every position; a start
    # of 400 keeps float32 angles small enough for 1e-4 (see the rope test)
    off = 400 if jcfg.rope_scaling is not None else 0
    positions = np.broadcast_to(np.arange(off, off + S, dtype=np.int32), (B, S)).copy()
    if impl == "kernel":
        positions = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    want, (wk, wv) = jax_llama.forward(tree, jcfg, jnp.asarray(tokens), jnp.asarray(positions))
    got, (gk, gv) = llama.forward(
        params, _pt_cfg(jcfg), torch.from_numpy(tokens).long(),
        torch.from_numpy(positions), attn_impl=impl,
    )
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=ATOL, rtol=0)


def test_forward_last_idx_selects_rows():
    jcfg = CASES["llama-tiny"]
    tree, params = _carry(jcfg)
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (3, 10))
    pos = torch.arange(10)[None].repeat(3, 1)
    full, _ = llama.forward(params, _pt_cfg(jcfg), torch.from_numpy(tokens), pos)
    last = torch.tensor([9, 4, 0])
    sel, kv = llama.forward(
        params, _pt_cfg(jcfg), torch.from_numpy(tokens), pos, last_idx=last, collect_kv=False
    )
    assert kv is None
    torch.testing.assert_close(sel, full[torch.arange(3), last], rtol=0, atol=1e-5)


@pytest.mark.parametrize("pos_hi", [16, 8192, 131072])
def test_rope_llama3_scaling_matches_jax(pos_hi):
    cfg = jax_configs.get_config("llama-3.2-1b")
    positions = np.random.default_rng(pos_hi).integers(0, pos_hi, (3, 11)).astype(np.int32)
    jc, js = jax_llama.rope_sincos(jnp.asarray(positions), cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    tc, ts = llama.rope_sincos(
        torch.from_numpy(positions), cfg.head_dim, cfg.rope_theta,
        get_config("llama-3.2-1b").rope_scaling,
    )
    # float32 angles up to 1.3e5 rad: one ulp of the angle is ~1e-2 rad, and
    # the two libraries' sin/cos round it differently
    tol = 1e-5 if pos_hi <= 16 else 2e-2
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=tol, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=tol, rtol=0)


def test_building_blocks_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal((64,)).astype(np.float32)
    np.testing.assert_allclose(
        llama.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(jax_llama.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        atol=1e-6, rtol=0,
    )
    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    c = rng.standard_normal((2, 5, 8)).astype(np.float32)
    s = rng.standard_normal((2, 5, 8)).astype(np.float32)
    np.testing.assert_allclose(
        llama.apply_rope(*(torch.from_numpy(a) for a in (q, c, s))).numpy(),
        np.asarray(jax_llama.apply_rope(*(jnp.asarray(a) for a in (q, c, s)))),
        atol=1e-6, rtol=0,
    )


def test_bf16_rms_norm_rounds_like_jax():
    """bf16: normalise in float32, cast, then scale — both packages round at
    the same two places, so the results are bit-equal."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal((64,))).astype(np.float32)
    want = np.asarray(
        jax_llama.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), 1e-5)
        .astype(jnp.float32)
    )
    got = llama.rms_norm(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(), 1e-5
    ).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_params_from_numpy_checks_shapes():
    jcfg = CASES["llama-tiny"]
    tree, _ = _carry(jcfg)
    tree["layers"] = dict(tree["layers"], wq=tree["layers"]["wq"][:, :, :-1])
    with pytest.raises(ValueError, match="wq"):
        params_from_numpy(tree, _pt_cfg(jcfg), device="cpu")


def test_init_params_seeded_and_shaped():
    cfg = get_config("llama-tiny")
    a = llama.init_params(cfg, seed=5, device="cpu")
    b = llama.init_params(cfg, seed=5, device="cpu")
    c = llama.init_params(cfg, seed=6, device="cpu")
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])
    assert not torch.equal(a["layers"]["wq"], c["layers"]["wq"])
    assert tuple(a["layers"]["wq"].shape) == (cfg.num_layers, cfg.hidden_size, cfg.q_dim)
    assert a["embed"].dtype == torch.float32 and a["embed"].device.type == "cpu"
    assert "lm_head" in a and tuple(a["lm_head"].shape) == (cfg.hidden_size, cfg.vocab_size)
