"""Shared helpers of the multimodal parity tests (``tests/test_torch_vision.py``,
``test_torch_audio.py``, ``test_torch_image_gen.py``,
``test_torch_multimodal_serving.py``): llama-tiny and the tiny towers and
heads in float32, the same weights carried from the JAX package into the
port, and one request script run through the JAX node and the port's node.

A result pair is equal when its tokens, text, finish reason and truncation
keys are equal, its WAV parts agree within one 16-bit level (``WAV_LSB``)
and its PNG parts decode to the same pixels. An error pair is equal when
the messages are; the classes are equal too, except that the port raises
``BadRequestError`` (a ValueError, HTTP 400) where the JAX node, built
without a tower or head, raises ValueError.
"""

from __future__ import annotations

import asyncio
import base64
import dataclasses
import io

import jax
import numpy as np

from agentfield_tpu.models import audio as jax_audio
from agentfield_tpu.models import configs as jax_configs
from agentfield_tpu.models import image_gen as jax_image_gen
from agentfield_tpu.models import llama as jax_llama
from agentfield_tpu.models import vision as jax_vision
from agentfield_tpu.serving import model_node as jax_node
from agentfield_tpu_torch.models import audio, image_gen, vision
from agentfield_tpu_torch.models.configs import get_config
from agentfield_tpu_torch.models.convert import params_from_numpy, tower_params_from_numpy
from agentfield_tpu_torch.serving import model_node
from agentfield_tpu_torch.serving.engine import EngineConfig
from agentfield_tpu_torch.serving.tokenizer import ByteTokenizer

V = 512  # llama-tiny's vocabulary
WAV_LSB = 1  # 16-bit PCM levels two synthesized waveforms may differ by

# kind -> (JAX module, port module, config getter name, init name, JAX seed)
KINDS = {
    "vision": (jax_vision, vision, "get_vision_config", "init_vision_params", 1),
    "audio": (jax_audio, audio, "get_audio_config", "init_audio_params", 2),
    "tts": (jax_audio, audio, "get_tts_config", "init_tts_params", 3),
    "imagegen": (jax_image_gen, image_gen, "get_imagegen_config", "init_imagegen_params", 5),
}


def llama_tiny(seed: int = 0):
    """(JAX float32 config, numpy tree, the port's params on the CPU)."""
    jcfg = dataclasses.replace(jax_configs.get_config("llama-tiny"), dtype="float32")
    tree = jax.tree.map(np.asarray, jax_llama.init_params(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, tree, params_from_numpy(tree, get_config("llama-tiny"), device="cpu")


def port_cfg(cfg):
    """The port's config of a JAX tower or head config (same fields)."""
    cls = {jax_vision.VisionConfig: vision.VisionConfig,
           jax_audio.AudioConfig: audio.AudioConfig,
           jax_audio.TTSConfig: audio.TTSConfig,
           jax_image_gen.ImageGenConfig: image_gen.ImageGenConfig}[type(cfg)]
    return cls(**dataclasses.asdict(cfg))


def tower(kind: str, name: str, **over):
    """A tower or head preset in float32: ((JAX cfg, JAX params), (port cfg,
    port params on the CPU)), the port's carried from the JAX draw."""
    jmod, _, get, init, seed = KINDS[kind]
    jcfg = dataclasses.replace(getattr(jmod, get)(name), dtype="float32", **over)
    jp = getattr(jmod, init)(jcfg, jax.random.PRNGKey(seed))
    pcfg = port_cfg(jcfg)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    return (jcfg, jp), (pcfg, tower_params_from_numpy(tree, pcfg, device="cpu"))


def jax_calls(weights, ecfg: dict, calls: list[dict], mesh=None, **towers) -> list:
    """Each call's result (or the exception it raised) from the JAX node's
    ``generate``, one backend for the list (on ``mesh``, a JAX mesh, when
    given: the JAX node's ``tp``); ``towers`` are (cfg, params)."""
    jcfg, tree, _ = weights

    async def main():
        b = jax_node.ModelBackend(tree, jcfg, jax_node.EngineConfig(**ecfg),
                                  tokenizer=jax_node.ByteTokenizer(V), idle_sleep=0.001,
                                  mesh=mesh, **towers)
        await b.start()
        out = []
        try:
            for kw in calls:
                try:
                    out.append(await b.generate(**kw))
                except Exception as e:  # noqa: BLE001 — compared by the caller
                    out.append(e)
        finally:
            await b.stop()
        return out

    return asyncio.run(main())


def port_backend(weights, ecfg: dict, **towers) -> model_node.ModelBackend:
    return model_node.ModelBackend(weights[2], get_config("llama-tiny"), EngineConfig(**ecfg),
                                   tokenizer=ByteTokenizer(V), device="cpu", idle_sleep=0.001,
                                   **towers)


def port_calls(backend, calls: list[dict]) -> list:
    out = []
    for kw in calls:
        try:
            out.append(backend.generate(**kw, timeout=120))
        except Exception as e:  # noqa: BLE001 — compared by the caller
            out.append(e)
    return out


def wav_samples(b64: str) -> np.ndarray:
    import wave

    with wave.open(io.BytesIO(base64.b64decode(b64)), "rb") as w:
        assert (w.getnchannels(), w.getsampwidth()) == (1, 2)
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.int64)


def png_pixels(b64: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB"))


def assert_same(jax_out: list, port_out: list, names=None) -> dict:
    """Hold each port result against the JAX one (the module docstring);
    returns the largest WAV difference seen, in 16-bit levels."""
    worst = {"wav_levels": 0}
    for i, (j, p) in enumerate(zip(jax_out, port_out, strict=True)):
        name = names[i] if names else i
        if isinstance(j, Exception):
            assert isinstance(p, Exception), (name, j, p)
            assert str(p) == str(j), (name, str(p), str(j))
            if isinstance(p, model_node.BadRequestError):
                assert type(j) is ValueError, (name, type(j))
            else:
                assert type(p).__name__ == type(j).__name__, (name, type(p), type(j))
            continue
        assert not isinstance(p, Exception), (name, p)
        for key in ("tokens", "text", "finish_reason", "model", "truncated_prompt_tokens",
                    "tts_truncated_chars", "imagegen_truncated_chars"):
            assert p.get(key) == j.get(key), (name, key, p.get(key), j.get(key))
        assert len(p.get("parts", [])) == len(j.get("parts", [])), name
        for pp, jp in zip(p.get("parts", []), j.get("parts", [])):
            assert {k: v for k, v in pp.items() if k != "data_b64"} == \
                {k: v for k, v in jp.items() if k != "data_b64"}, name
            if pp["type"] == "audio":
                a, b = wav_samples(pp["data_b64"]), wav_samples(jp["data_b64"])
                assert a.shape == b.shape, name
                d = int(np.abs(a - b).max()) if a.size else 0
                worst["wav_levels"] = max(worst["wav_levels"], d)
                assert d <= WAV_LSB, (name, d)
            else:
                np.testing.assert_array_equal(png_pixels(pp["data_b64"]),
                                              png_pixels(jp["data_b64"]))
    return worst
