"""The port's image-generation head (``agentfield_tpu_torch.models.image_gen``)
against the JAX package's, on the CPU in float32 with the same carried
weights:

- ``imagegen_synthesize`` within ``RTOL`` (1e-5) of the largest output
  (seen about 1e-7), an all-padding prompt included; the init the JAX tree's keys and shapes,
  the presets equal;
- ``image_to_png`` through the port's own PNG encoder: Pillow decodes it to
  the pixels the JAX head's Pillow-written PNG holds (bit-equal);
- the JAX node scripts of ``tests/test_image_gen.py`` through both nodes:
  ``output="image"`` (PNG pixels equal), truncation reported (and not for a
  short prompt), media with ``output="image"`` refused, a node without the
  head refused before any decode (the JAX message; BadRequestError);
- the served modalities each node advertises, for several towers and heads.
"""

from __future__ import annotations

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from agentfield_tpu.models import image_gen as jax_image_gen
from agentfield_tpu.serving import model_node as jax_node
from agentfield_tpu_torch.models import image_gen
from agentfield_tpu_torch.serving import model_node
from agentfield_tpu_torch.serving.engine import EngineConfig
from tests import helpers_torch_mm as mm

RTOL = 1e-5
ECFG = dict(max_batch=2, page_size=16, num_pages=32, max_pages_per_seq=4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def head():
    return mm.tower("imagegen", "imagegen-tiny")


def test_synthesize_matches_jax(head):
    (jcfg, jp), (pcfg, pp) = head
    ids = np.zeros((3, jcfg.max_chars), np.int32)
    for b, text in enumerate([b"a red cat", b"blueprints", b""]):
        ids[b, : len(text)] = np.frombuffer(text, np.uint8)
    want = np.asarray(jax_image_gen.imagegen_synthesize(jp, jcfg, jnp.asarray(ids)))
    got = image_gen.imagegen_synthesize(pp, pcfg, torch.from_numpy(ids)).numpy()
    assert got.shape == want.shape == (3, jcfg.image_size, jcfg.image_size, 3)
    assert float(np.abs(got - want).max()) <= RTOL * float(np.abs(want).max())
    assert np.isfinite(got).all()


def test_init_and_presets_match_jax():
    jcfg = jax_image_gen.get_imagegen_config("imagegen-tiny")
    jtree = jax_image_gen.init_imagegen_params(jcfg, jax.random.PRNGKey(0))
    ptree = image_gen.init_imagegen_params(mm.port_cfg(jcfg), seed=0, device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jtree)
    pl = dict(jax.tree_util.tree_leaves_with_path(ptree))
    assert len(jl) == len(pl)
    for path, v in jl:
        assert tuple(pl[path].shape) == tuple(v.shape) and pl[path].dtype == torch.bfloat16
    assert image_gen.CONFIGS.keys() == jax_image_gen.CONFIGS.keys()
    assert all(mm.port_cfg(c) == image_gen.CONFIGS[n]
               for n, c in jax_image_gen.CONFIGS.items())


@pytest.mark.parametrize("size", [1, 32, 64])
def test_png_pixels_equal_jax(size):
    img = np.linspace(0, 1, size * size * 3, dtype=np.float32).reshape(size, size, 3)
    img[0, 0] = (-0.5, 1.5, 0.999)  # clipped, as the JAX head clips
    want = np.asarray(Image.open(io.BytesIO(jax_image_gen.image_to_png(img))))
    data = image_gen.image_to_png(img)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), want)


SCRIPT = {
    "image": dict(prompt="a tiny landscape", output="image"),
    "long": dict(prompt="x" * 100, output="image"),
    "short": dict(prompt="short", output="image"),
    "utf8": dict(prompt="ü" * 40, output="image"),
    "media": dict(prompt="<image>", images=[np.zeros((8, 8, 3), np.float32)], output="image"),
    "empty": dict(prompt="", output="image"),
    "messages": dict(messages=[{"role": "user", "content": "draw a boat"}], output="image"),
    "branches": dict(prompt="draw", output="image", n_branches=2),
}


def test_node_script_matches_jax(head):
    (jcfg, jp), (pcfg, pp) = head
    weights = mm.llama_tiny(0)
    calls = list(SCRIPT.values())
    want = mm.jax_calls(weights, ECFG, calls, imagegen=(jcfg, jp))
    b = mm.port_backend(weights, ECFG, imagegen=(pcfg, pp))
    b.start()
    try:
        before = b.engine.stats["decode_steps"]
        got = mm.port_calls(b, calls)
        assert b.engine.stats["decode_steps"] == before  # rendering runs no LM
    finally:
        b.stop()
    mm.assert_same(want, got, list(SCRIPT))
    names = list(SCRIPT)
    assert got[names.index("image")]["finish_reason"] == "imagegen"
    assert got[names.index("long")]["imagegen_truncated_chars"] == 100 - pcfg.max_chars
    assert "imagegen_truncated_chars" not in got[names.index("short")]
    px = mm.png_pixels(got[names.index("image")]["parts"][0]["data_b64"])
    assert px.shape == (pcfg.image_size, pcfg.image_size, 3)


def test_node_without_head_refuses_as_jax():
    weights = mm.llama_tiny(0)
    calls = [dict(prompt="draw", output="image")]
    want = mm.jax_calls(weights, ECFG, calls)
    b = mm.port_backend(weights, ECFG)
    got = mm.port_calls(b, calls)
    b.stop()
    mm.assert_same(want, got)
    assert type(got[0]) is model_node.BadRequestError


@pytest.mark.parametrize("towers", [{}, {"imagegen": "imagegen-tiny"},
                                    {"vision": "vit-tiny", "tts": "tts-tiny"},
                                    {"vision": "vit-tiny", "audio": "audio-tiny",
                                     "tts": "tts-tiny", "imagegen": "imagegen-tiny"}],
                         ids=lambda t: "+".join(t) or "text")
def test_advertised_modalities_match_jax(towers):
    jcfg = jax_node.get_config("llama-tiny")
    agent, _ = jax_node.build_model_node("m", None, model="llama-tiny",
                                         params=jax_node.init_params(jcfg, jax.random.PRNGKey(0)),
                                         ecfg=jax_node.EngineConfig(**ECFG), **towers)
    server, backend = model_node.build_model_node("llama-tiny", ecfg=EngineConfig(**ECFG),
                                                  device="cpu", **towers)
    assert server.metadata["modalities"] == agent.metadata["modalities"]
    backend.stop()
