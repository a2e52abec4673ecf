"""The port's vision tower (``agentfield_tpu_torch.models.vision``) against
the JAX package's, on the CPU in float32 with the same carried weights:

- ``vision_hidden`` and ``vision_encode`` for every activation
  (``gelu_tanh``, ``quick_gelu``, ``gelu_exact``) in both flavours (SigLIP's
  final LN without CLS; CLIP's CLS and pre-LN without final LN), with and
  without pixel normalization, and a tree saved before the encoder had
  biases: within ``RTOL`` (1e-5) of the largest output, seen about 3e-7;
- ``patchify`` equal; ``init_vision_params`` the JAX tree's keys, shapes
  and dtype;
- ``load_clip_vision`` on CLIP and SigLIP checkpoints that ``transformers``
  writes in the test (as ``tests/test_multimodal_serving.py`` does),
  through the port's own safetensors reader: the config equal to the JAX
  loader's, every encoder leaf bit-equal, and the tower's patch features
  within 2e-3 of ``transformers``' ``last_hidden_state`` (the JAX test's
  bound) and 1e-5 of the JAX tower's;
- the node serving a CLIP checkpoint (the JAX script): ``vision=<dir>``
  resolves to the same configuration in bf16, and with the float32 tower of
  both loaders the two nodes' greedy tokens are equal.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentfield_tpu.models import vision as jax_vision
from agentfield_tpu_torch.models import vision
from agentfield_tpu_torch.models.convert import tower_params_from_numpy
from tests import helpers_torch_mm as mm

RTOL = 1e-5  # of the largest |output|
ECFG = dict(max_batch=4, page_size=8, num_pages=64, max_pages_per_seq=8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(cfg_over: dict, drop_biases: bool = False):
    (jcfg, jp), (pcfg, pp) = mm.tower("vision", "vit-tiny", **cfg_over)
    if drop_biases:
        jp = {**jp, "layers": {k: v for k, v in jp["layers"].items() if not k.startswith("b")}}
        pp = {**pp, "layers": {k: v for k, v in pp["layers"].items() if not k.startswith("b")}}
    return jcfg, jp, pcfg, pp


def _close(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= RTOL * float(np.abs(want).max()), (err, float(np.abs(want).max()))
    return err


FLAVOURS = {"siglip": dict(class_token=False, pre_ln=False, final_ln=True),
            "clip": dict(class_token=True, pre_ln=True, final_ln=False)}


@pytest.mark.parametrize("flavour", list(FLAVOURS))
@pytest.mark.parametrize("act", ["gelu_tanh", "quick_gelu", "gelu_exact"])
def test_tower_matches_jax(act, flavour):
    over = dict(act=act, **FLAVOURS[flavour])
    if flavour == "clip":
        over.update(pixel_mean=(0.48145466, 0.4578275, 0.40821073),
                    pixel_std=(0.26862954, 0.26130258, 0.27577711))
    jcfg, jp, pcfg, pp = _both(over)
    imgs = np.random.default_rng(0).random((2, 32, 32, 3), dtype=np.float32)
    _close(vision.vision_hidden(pp, pcfg, torch.from_numpy(imgs)),
           jax_vision.vision_hidden(jp, jcfg, jnp.asarray(imgs)))
    _close(vision.vision_encode(pp, pcfg, torch.from_numpy(imgs)),
           jax_vision.vision_encode(jp, jcfg, jnp.asarray(imgs)))


def test_pre_bias_tree_upgrades_as_jax():
    jcfg, jp, pcfg, pp = _both({}, drop_biases=True)
    imgs = np.random.default_rng(1).random((1, 32, 32, 3), dtype=np.float32)
    _close(vision.vision_encode(pp, pcfg, torch.from_numpy(imgs)),
           jax_vision.vision_encode(jp, jcfg, jnp.asarray(imgs)))


def test_patchify_and_init_match_jax():
    jcfg = dataclasses.replace(jax_vision.get_vision_config("vit-tiny"), class_token=True,
                               pre_ln=True)
    pcfg = mm.port_cfg(jcfg)
    imgs = np.random.default_rng(2).random((2, 32, 32, 3), dtype=np.float32)
    np.testing.assert_array_equal(vision.patchify(torch.from_numpy(imgs), pcfg).numpy(),
                                  np.asarray(jax_vision.patchify(jnp.asarray(imgs), jcfg)))
    jtree = jax_vision.init_vision_params(jcfg, jax.random.PRNGKey(0))
    ptree = vision.init_vision_params(pcfg, seed=0, device="cpu")
    jl = {"/".join(str(getattr(k, "key", k)) for k in path): v for path, v in
          jax.tree_util.tree_leaves_with_path(jtree)}
    pl = {"/".join(str(getattr(k, "key", k)) for k in path): v for path, v in
          jax.tree_util.tree_leaves_with_path(ptree)}
    assert sorted(jl) == sorted(pl)
    for k in jl:
        assert tuple(pl[k].shape) == tuple(jl[k].shape) and pl[k].dtype == torch.bfloat16, k
    assert vision.CONFIGS.keys() == jax_vision.CONFIGS.keys()
    assert all(mm.port_cfg(c) == vision.CONFIGS[n] for n, c in jax_vision.CONFIGS.items())


def _ckpt(tmp_path, flavour: str):
    transformers = pytest.importorskip("transformers")
    if flavour == "clip":
        hcfg = transformers.CLIPVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
            image_size=32, patch_size=8, layer_norm_eps=1e-5, hidden_act="quick_gelu")
        cls = transformers.CLIPVisionModel
    else:
        hcfg = transformers.SiglipVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
            image_size=32, patch_size=8)
        cls = transformers.SiglipVisionModel
    torch.manual_seed(0 if flavour == "clip" else 1)
    model = cls(hcfg).eval().to(torch.float32)
    d = tmp_path / f"{flavour}-ckpt"
    model.save_pretrained(d, safe_serialization=True)
    return model, d


@pytest.mark.parametrize("flavour", ["clip", "siglip"])
def test_loader_matches_jax_and_transformers(tmp_path, flavour):
    model, d = _ckpt(tmp_path, flavour)
    jcfg, jp = jax_vision.load_clip_vision(str(d), out_dim=128)
    pcfg, pp = vision.load_clip_vision(str(d), out_dim=128, device="cpu")
    assert pcfg == mm.port_cfg(jcfg)
    jl = jax.tree_util.tree_leaves_with_path(jp)
    pl = dict(jax.tree_util.tree_leaves_with_path(pp))
    assert len(jl) == len(pl)
    for path, v in jl:
        if path[0].key.startswith("proj_"):  # the projector stays random
            continue
        np.testing.assert_array_equal(pl[path].numpy(), np.asarray(v), err_msg=str(path))
    rng = np.random.default_rng(0)
    pixels = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    with torch.no_grad():
        want = model(torch.tensor(pixels)).last_hidden_state.numpy()
    if flavour == "clip":
        want = want[:, 1:]
    imgs = np.transpose(pixels, (0, 2, 3, 1))
    nonorm = dataclasses.replace(pcfg, pixel_mean=None, pixel_std=None)
    got = vision.vision_hidden(pp, nonorm, torch.from_numpy(imgs))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    jax_got = jax_vision.vision_hidden(jp, dataclasses.replace(jcfg, pixel_mean=None,
                                                               pixel_std=None), jnp.asarray(imgs))
    _close(got, jax_got)


def test_loader_refusals_match_jax(tmp_path):
    d = tmp_path / "empty"
    d.mkdir()
    (d / "config.json").write_text('{"hidden_size": 8}')
    for load in (jax_vision.load_clip_vision, vision.load_clip_vision):
        with pytest.raises(FileNotFoundError, match="no \\*.safetensors"):
            load(str(d))


def test_node_serves_a_clip_checkpoint_as_jax(tmp_path):
    _, d = _ckpt(tmp_path, "clip")
    weights = mm.llama_tiny(0)
    # a directory resolves to the checkpoint's tower in bf16, as on the JAX node
    b = mm.port_backend(weights, ECFG, vision=str(d))
    assert b.vision_cfg == dataclasses.replace(
        mm.port_cfg(jax_vision.load_clip_vision(str(d), out_dim=128)[0]), dtype="bfloat16")
    assert b.vision_params["pos_embed"].dtype == torch.bfloat16
    b.stop()
    jcfg, jp = jax_vision.load_clip_vision(str(d), out_dim=128)
    pcfg = mm.port_cfg(jcfg)
    pp = tower_params_from_numpy(jax.tree.map(np.asarray, jp), pcfg, device="cpu")
    calls = [dict(prompt="look <image>", images=[np.full((32, 32, 3), 0.5, np.float32)],
                  max_new_tokens=3),
             dict(prompt="and <image>?", images=[np.random.default_rng(3).random((20, 40, 3))],
                  max_new_tokens=3)]
    want = mm.jax_calls(weights, ECFG, calls, vision=(jcfg, jp))
    b = mm.port_backend(weights, ECFG, vision=(pcfg, pp))
    b.start()
    try:
        got = mm.port_calls(b, calls)
    finally:
        b.stop()
    mm.assert_same(want, got)
    assert all(len(r["tokens"]) == 3 for r in got)
