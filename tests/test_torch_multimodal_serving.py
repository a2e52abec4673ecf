"""Multimodal serving of the port against the JAX package, on the CPU
(llama-tiny, ``vit-tiny`` and ``audio-tiny`` in float32, the same carried
weights):

- ``llama.forward(embeds_override=...)`` against the JAX ``forward_impl``:
  logits within ``ATOL`` (1e-5), both attention implementations;
- the JAX engine scripts of ``tests/test_multimodal_serving.py`` through
  both engines: the injected prefill's greedy tokens equal, the request
  validation's messages equal, no session kept for a multimodal request,
  every page back;
- the exclusions: a multimodal prompt longer than ``prefill_chunk``
  prefills whole in one dense forward (no suffix piece); two multimodal
  requests with the same placeholder ids under the shared-prefix cache
  publish nothing and hit nothing; a mixed-tick engine admits it through the
  classic path; it is never a preemption victim, never forks live, and
  ``n_branches > 1`` is refused; a speculative engine's draft prefills the
  placeholder ids and the greedy tokens stay the plain engine's;
- the JAX node scripts (``tests/test_multimodal_serving.py``,
  ``tests/test_audio.py``'s mixed prompt) through both nodes: a base64 PNG,
  a base64 JPEG and a pixel array, an image with an audio clip, marker
  mismatches, ``tokens`` with media, a node without the tower, a tower
  whose ``out_dim`` is not the LM's width — results and errors equal
  (``helpers_torch_mm.assert_same``);
- ``chip_smoke.phase_media`` rehearsed on the CPU at llama-tiny size.
"""

from __future__ import annotations

import base64
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from agentfield_tpu.models import llama as jax_llama
from agentfield_tpu.models import vision as jax_vision
from agentfield_tpu.serving import engine as jax_engine
from agentfield_tpu.serving import model_node as jax_node
from agentfield_tpu.serving.sampler import SamplingParams as JaxSampling
from agentfield_tpu_torch.models import llama
from agentfield_tpu_torch.models.configs import get_config
from agentfield_tpu_torch.serving import engine as port_engine
from agentfield_tpu_torch.serving import model_node
from agentfield_tpu_torch.serving.sampler import SamplingParams
from tests import helpers_torch_mm as mm

ATOL = 1e-5
ECFG = dict(max_batch=4, page_size=8, num_pages=64, max_pages_per_seq=8)
NODE_ECFG = dict(max_batch=4, page_size=8, num_pages=128, max_pages_per_seq=16)  # 128 tokens
CFG = get_config("llama-tiny")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    return mm.llama_tiny(0)


@pytest.fixture(scope="module")
def vit():
    return mm.tower("vision", "vit-tiny")


@pytest.fixture(scope="module")
def aud():
    return mm.tower("audio", "audio-tiny")


@pytest.fixture(scope="module")
def embs(vit):
    (jcfg, jp), _ = vit
    imgs = jax.random.uniform(jax.random.PRNGKey(2), (2, 32, 32, 3))
    return np.asarray(jax_vision.vision_encode_jit(jp, jcfg, imgs), np.float32)


def _engines(weights, ecfg=ECFG, **kw):
    jcfg, tree, params = weights
    return (jax_engine.InferenceEngine(tree, jcfg, jax_engine.EngineConfig(**ecfg, **kw)),
            port_engine.InferenceEngine(params, CFG, port_engine.EngineConfig(**ecfg, **kw),
                                        device="cpu"))


def _run_both(weights, reqs, ecfg=ECFG, **kw):
    """Run each request spec ``(id, prompt, mm, max_new, extra)`` through both
    engines; returns (jax tokens, port tokens, jax engine, port engine)."""
    je, pe = _engines(weights, ecfg, **kw)
    jr = je.run_to_completion([jax_engine.Request(
        id=i, prompt=p, mm_embeds=m, sampling=JaxSampling(max_new_tokens=n), **x)
        for i, p, m, n, x in reqs])
    pr = pe.run_to_completion([port_engine.Request(
        id=i, prompt=p, mm_embeds=m, sampling=SamplingParams(max_new_tokens=n), **x)
        for i, p, m, n, x in reqs])
    return jr, pr, je, pe


@pytest.mark.parametrize("attn_impl", ["ref", "kernel"])
def test_forward_embeds_override_matches_jax(weights, embs, attn_impl):
    jcfg, tree, params = weights
    P = embs.shape[1]
    prompt = [5] * P + [9, 11, 13]
    toks = np.asarray([prompt], np.int32)
    pos = np.arange(len(prompt), dtype=np.int32)[None]
    mask = np.asarray([[True] * P + [False] * 3])
    inject = np.concatenate([embs[:1], np.zeros((1, 3, CFG.hidden_size), np.float32)], axis=1)
    want, _ = jax_llama.forward_impl(tree, jcfg, jnp.asarray(toks), jnp.asarray(pos),
                                     embeds_override=(jnp.asarray(inject), jnp.asarray(mask)))
    got, _ = llama.forward(params, CFG, torch.from_numpy(toks).long(),
                           torch.from_numpy(pos).long(), attn_impl=attn_impl,
                           embeds_override=(torch.from_numpy(inject), torch.from_numpy(mask)))
    plain, _ = llama.forward(params, CFG, torch.from_numpy(toks).long(),
                             torch.from_numpy(pos).long(), attn_impl=attn_impl)
    err = float(np.abs(got.numpy() - np.asarray(want)).max())
    assert err <= ATOL, err  # seen: about 2e-7
    assert float((got - plain).abs().max()) > 1e-4  # the embeddings reach the logits


def test_mm_prefill_matches_jax_and_is_deterministic(weights, embs):
    prompt = [5] * embs.shape[1] + [9, 11, 13]
    reqs = [("plain", prompt, None, 6, {}), ("img", prompt, [(0, embs[0])], 6, {}),
            ("img2", prompt, [(0, embs[0])], 6, {}), ("other", prompt, [(0, embs[1])], 6, {})]
    jr, pr, _, pe = _run_both(weights, reqs)
    assert pr == jr
    assert pr["img"] == pr["img2"] and pr["img"] != pr["plain"]
    assert pe.allocator.free_pages == ECFG["num_pages"] - 1


def test_mm_request_validation_matches_jax(weights):
    je, pe = _engines(weights)
    bad_dim = np.zeros((4, CFG.hidden_size + 1), np.float32)
    too_far = np.zeros((4, CFG.hidden_size), np.float32)
    for kw in (dict(prompt=[1, 2, 3, 4, 5], mm_embeds=[(0, bad_dim)]),
               dict(prompt=[1, 2, 3], mm_embeds=[(1, too_far)]),
               dict(prompt=[1, 2, 3, 4, 5, 6], mm_embeds=[(0, too_far)], n_branches=2)):
        with pytest.raises(ValueError) as want:
            je.submit(jax_engine.Request(id="a", **kw))
        with pytest.raises(ValueError) as got:
            pe.submit(port_engine.Request(id="a", **kw))
        assert str(got.value) == str(want.value)
    # a tensor span is checked as an array is
    with pytest.raises(ValueError, match="mm_embeds"):
        pe.submit(port_engine.Request(id="t", prompt=[1, 2, 3, 4, 5],
                                      mm_embeds=[(0, torch.zeros(4, 3))]))
    assert not pe.pending


def test_mm_requests_skip_session_cache(weights):
    emb = np.zeros((2, CFG.hidden_size), np.float32)
    reqs = [("a", [7, 7, 3, 4], [(0, emb)], 3, {"session_id": "s"})]
    jr, pr, je, pe = _run_both(weights, reqs)
    assert pr == jr
    assert "s" not in pe._sessions and "s" not in je._sessions
    assert pe.allocator.free_pages == je.allocator.free_pages == ECFG["num_pages"] - 1


def test_long_mm_prompt_prefills_whole(weights, embs, monkeypatch):
    """A multimodal prompt longer than ``prefill_chunk`` takes one dense
    forward (the JAX engine's whole-prompt inject prefill), no suffix piece."""
    ecfg = dict(max_batch=2, page_size=8, num_pages=64, max_pages_per_seq=16)
    P = embs.shape[1]
    prompt = [3] * 5 + [0] * P + [0] * P + list(range(20, 60))  # 2 images, 77 tokens
    spans = [(5, embs[0]), (5 + P, embs[1])]
    calls = {"dense": [], "suffix": 0}
    pe_cls = port_engine.InferenceEngine
    dense, suffix = pe_cls._dense_prefill, pe_cls._suffix_prefill

    def spy_dense(self, prompts, rows, mm_embeds=None):
        calls["dense"].append((len(prompts[0]), bool(mm_embeds)))
        return dense(self, prompts, rows, mm_embeds)

    def spy_suffix(self, *a, **k):
        calls["suffix"] += 1
        return suffix(self, *a, **k)

    monkeypatch.setattr(pe_cls, "_dense_prefill", spy_dense)
    monkeypatch.setattr(pe_cls, "_suffix_prefill", spy_suffix)
    jr, pr, _, pe = _run_both(weights, [("long", prompt, spans, 5, {})], ecfg=ecfg,
                              prefill_chunk=32)
    assert pr == jr
    assert calls == {"dense": [(len(prompt), True)], "suffix": 0}
    assert pe.stats["prefill_tokens"] == len(prompt)


def test_mm_requests_stay_out_of_the_shared_prefix_cache(weights, embs):
    """Same placeholder ids, different images: neither publishes nor hits."""
    ecfg = dict(max_batch=2, page_size=4, num_pages=64, max_pages_per_seq=16)
    prompt = [0] * embs.shape[1] + [9, 11, 13, 15, 17]
    reqs = [("a", prompt, [(0, embs[0])], 4, {}), ("b", prompt, [(0, embs[1])], 4, {}),
            ("t1", prompt, None, 4, {}), ("t2", prompt, None, 4, {})]
    jr, pr, je, pe = _run_both(weights, reqs, ecfg=ecfg, shared_prefix_cache=True)
    assert pr == jr
    assert pe.stats["prefix_index_hits"] == je.stats["prefix_index_hits"]
    assert pe.stats["prefix_tokens_reused"] == je.stats["prefix_tokens_reused"]
    # the text pair may share pages; the image pair shares none
    je2, pe2 = _engines(weights, ecfg, shared_prefix_cache=True)
    pe2.run_to_completion([port_engine.Request(id=r[0], prompt=r[1], mm_embeds=r[2],
                                               sampling=SamplingParams(max_new_tokens=4))
                           for r in reqs[:2]])
    assert pe2.stats["prefix_index_hits"] == 0 and pe2.allocator.peek(prompt[:-1]) == 0


def test_mm_admits_through_the_classic_path_of_a_mixed_engine(weights, embs):
    ecfg = dict(max_batch=4, page_size=8, num_pages=64, max_pages_per_seq=8)
    prompt = [0] * embs.shape[1] + [9, 11]
    je, pe = _engines(weights, ecfg, mixed_step=True, mixed_step_budget=24)
    out = {}
    for name, eng, R, S in (("jax", je, jax_engine.Request, JaxSampling),
                            ("port", pe, port_engine.Request, SamplingParams)):
        eng.submit(R(id="text", prompt=list(range(1, 20)), sampling=S(max_new_tokens=8)))
        toks = {"text": [], "img": []}
        for step in range(200):
            if step == 2:  # while the text request decodes
                eng.submit(R(id="img", prompt=prompt, mm_embeds=[(0, embs[0])],
                             sampling=S(max_new_tokens=5)))
            if not eng.has_work():
                break
            for ev in eng.step():
                if ev.token >= 0:
                    toks[ev.request_id].append(ev.token)
        out[name] = toks
    assert out["port"] == out["jax"]
    assert not pe._prefill_jobs and pe._mixed_eligible(port_engine.Request(
        id="x", prompt=prompt, mm_embeds=[(0, embs[0])])) is False


def test_mm_slot_is_never_a_victim_and_never_forks(weights, embs):
    _, pe = _engines(weights)
    prompt = [0] * embs.shape[1] + [9]
    pe.submit(port_engine.Request(id="img", prompt=prompt, mm_embeds=[(0, embs[0])],
                                  sampling=SamplingParams(max_new_tokens=20)))
    pe.step()
    assert any(s is not None and s.req.id == "img" for s in pe.slots)
    assert pe._victim_slot() is None
    pe.request_fork("img", "img-fork")
    events = []
    while pe.has_work():
        events += pe.step()
    assert [e.finish_reason for e in events if e.request_id == "img-fork"] == ["fork_failed"]
    assert pe.allocator.free_pages == ECFG["num_pages"] - 1


def test_spec_engine_draft_prefills_the_placeholders(weights, embs):
    """A self draft (the target's own weights) with spec_k: the draft cannot
    see the image, so it drafts from the placeholder ids; verification keeps
    the greedy tokens the plain engine's."""
    jcfg, tree, params = weights
    prompt = [0] * embs.shape[1] + [9, 11, 13]
    spans = [(0, embs[0])]
    plain = port_engine.InferenceEngine(params, CFG, port_engine.EngineConfig(**ECFG),
                                        device="cpu")
    spec = port_engine.InferenceEngine(params, CFG, port_engine.EngineConfig(**ECFG, spec_k=2),
                                       device="cpu", draft=(params, CFG))
    want = plain.run_to_completion([port_engine.Request(
        id="r", prompt=prompt, mm_embeds=spans, sampling=SamplingParams(max_new_tokens=8))])
    got = spec.run_to_completion([port_engine.Request(
        id="r", prompt=prompt, mm_embeds=spans, sampling=SamplingParams(max_new_tokens=8))])
    assert got == want


# -- the node ---------------------------------------------------------------


def _png_b64(color=(255, 0, 0), size=(8, 8)):
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", size, color).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _jpeg_b64(seed: int = 0, size=(45, 37)):
    from PIL import Image

    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=85)
    return base64.b64encode(buf.getvalue()).decode()


def _wav_b64(freq=440.0, seconds=0.5):
    from agentfield_tpu.models.audio import float_to_wav

    n = int(seconds * 16000)
    w = np.sin(2 * np.pi * freq * np.arange(n) / 16000).astype(np.float32)
    return base64.b64encode(float_to_wav(w, 16000)).decode()


IMAGE_SCRIPT = {
    "png": dict(prompt="look: <image> describe", images=[{"b64": _png_b64()}], max_new_tokens=4),
    "array": dict(prompt="look: <image> describe",
                  images=[np.full((8, 8, 3), 0.03, np.float32)], max_new_tokens=4),
    "jpeg": dict(prompt="a photo <image> of", images=[{"b64": _jpeg_b64()}], max_new_tokens=4),
    "two_images": dict(prompt="<image> and <image>", images=[{"b64": _png_b64()},
                                                            {"b64": _jpeg_b64(1)}],
                       max_new_tokens=3),
    "mixed": dict(prompt="see <image> hear <audio> go",
                  images=[np.full((8, 8, 3), 0.25, np.float32)], audios=[{"b64": _wav_b64()}],
                  max_new_tokens=3),
    "markers": dict(prompt="no marker", images=[{"b64": _png_b64()}, {"b64": _png_b64()}]),
    "tokens_and_images": dict(tokens=[1, 2, 3], images=[{"b64": _png_b64()}]),
    "bad_array": dict(prompt="<image>", images=[[0.5, 0.5]]),
    "truncate": dict(prompt="x" * 120 + "<image>", images=[{"b64": _png_b64()}],
                     max_new_tokens=6, context_overflow="truncate_left"),
    "branches": dict(prompt="<image>", images=[{"b64": _png_b64()}], n_branches=2),
}


def test_node_image_script_matches_jax(weights, vit, aud):
    (jv, pv), (ja, pa) = vit, aud
    names = list(IMAGE_SCRIPT)
    want = mm.jax_calls(weights, NODE_ECFG, list(IMAGE_SCRIPT.values()), vision=jv, audio=ja)
    b = mm.port_backend(weights, NODE_ECFG, vision=pv, audio=pa)
    b.start()
    try:
        got = mm.port_calls(b, list(IMAGE_SCRIPT.values()))
        assert not b.engine.pending and b.engine.num_active == 0
    finally:
        b.stop()
    mm.assert_same(want, got, names)
    for n in ("png", "array", "jpeg", "two_images", "mixed"):
        assert len(got[names.index(n)]["tokens"]) > 0, n
    assert b.engine.allocator.free_pages == NODE_ECFG["num_pages"] - 1


def test_node_without_towers_refuses_media_as_jax(weights):
    calls = [dict(prompt="<image>", images=[{"b64": _png_b64()}]),
             dict(prompt="<audio>", audios=[{"b64": _wav_b64()}])]
    want = mm.jax_calls(weights, ECFG, calls)
    b = mm.port_backend(weights, ECFG)
    got = mm.port_calls(b, calls)  # never started: refused before any work
    b.stop()
    mm.assert_same(want, got)
    assert all(type(e) is model_node.BadRequestError for e in got)


@pytest.mark.parametrize("kind", ["vision", "audio"])
def test_tower_width_must_match_the_lm(kind):
    name = {"vision": "vit-tiny", "audio": "audio-tiny"}[kind]
    jcfg = jax_node.get_config("llama-smoke")
    with pytest.raises(ValueError) as want:
        jax_node.ModelBackend(jax_llama.init_params(jcfg, jax.random.PRNGKey(0)), jcfg,
                              jax_node.EngineConfig(**ECFG), **{kind: name})
    cfg = get_config("llama-smoke")
    with pytest.raises(ValueError) as got:
        model_node.ModelBackend(llama.init_params(cfg, device="cpu"), cfg,
                                port_engine.EngineConfig(**ECFG), device="cpu", **{kind: name})
    assert str(got.value) == str(want.value)


def test_phase_media_rehearsal(weights):
    """``chip_smoke.phase_media`` on the CPU at llama-tiny size with the
    tiny towers and heads: every request answered, every check it makes."""
    r: dict = {}
    chip_smoke.phase_media(r, {"params": weights[2], "cfg": CFG}, seed=0, device="cpu",
                           **chip_smoke.MEDIA_REHEARSAL)
    out = r["media"]
    assert out["answered"] == ["image", "audio", "mixed", "audio_out", "speech", "image_out"]
    assert out["dense_launches_per_prefill"] is None  # no kernel launches on the CPU


def test_sdk_agent_sends_media_to_the_port_node():
    """The JAX SDK's media calls through the JAX control plane to the port's
    node, a child process started with ``--vision --audio --tts --imagegen``
    (the scripts of ``tests/test_audio.py`` and ``tests/test_image_gen.py``):
    ``ai(audio=...)``, ``ai_with_vision``, ``ai(output="speech")``,
    ``ai_with_audio`` and ``generate_image`` answer, the parts come back as
    the SDK's MultimodalResponse, and the registry lists the node's
    modalities."""
    import asyncio
    import os
    import pathlib
    import re
    import signal
    import sys

    from agentfield_tpu.models.audio import float_to_wav
    from agentfield_tpu.sdk.agent import Agent
    from agentfield_tpu.sdk.multimodal import ImageContent, MultimodalResponse
    from tests.helpers_cp import CPHarness, async_test

    root = pathlib.Path(__file__).resolve().parents[1]

    @async_test
    async def run():
        async with CPHarness() as h:
            env = dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS="1",
                       MKL_NUM_THREADS="1")
            proc = await asyncio.create_subprocess_exec(
                sys.executable, "-m", "agentfield_tpu_torch.serving.model_node", "--device",
                "cpu", "--model", "llama-tiny", "--port", "0", "--control-plane", h.base_url,
                "--node-id", "mm-node", "--vision", "vit-tiny", "--audio", "audio-tiny",
                "--tts", "tts-tiny", "--imagegen", "imagegen-tiny", cwd=str(root), env=env,
                stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.STDOUT)
            lines: list[str] = []
            while not any(re.search(r"serving on http://", x) for x in lines):
                line = (await asyncio.wait_for(proc.stdout.readline(), 60)).decode()
                assert line, f"the node exited: {lines}"
                lines.append(line)

            async def drain():
                async for line in proc.stdout:
                    lines.append(line.decode())

            drainer = asyncio.create_task(drain())
            app = Agent("caller", h.base_url, channel=False)
            try:
                async with h.http.get("/api/v1/nodes/mm-node") as r:
                    node = (await r.json())["node"]
                assert node["metadata"]["modalities"] == [
                    "text", "image-in", "audio-in", "audio-out", "image-out"]
                t = np.arange(int(0.3 * 16000)) / 16000
                wav = float_to_wav(np.sin(2 * np.pi * 440 * t).astype(np.float32), 16000)
                r1 = await app.ai(prompt="what do you hear? <audio>", audio=[wav],
                                  max_new_tokens=4, timeout=60)
                assert len(r1["tokens"]) == 4
                png = base64.b64decode(_png_b64((0, 128, 255), (20, 30)))
                r2 = await app.ai_with_vision("what is this?", png, max_new_tokens=3, timeout=60)
                assert len(r2["tokens"]) == 3
                r3 = await app.ai(prompt="hi", max_new_tokens=4, output="speech", timeout=60)
                assert isinstance(r3, MultimodalResponse) and r3.parts[0].data[:4] == b"RIFF"
                r4 = await app.ai_with_audio("speak just this", max_new_tokens=4, timeout=60)
                assert isinstance(r4, MultimodalResponse)
                r5 = await app.generate_image("a mountain at dusk", timeout=60)
                [part] = [p for p in r5.parts if isinstance(p, ImageContent)]
                assert part.data[:8] == b"\x89PNG\r\n\x1a\n"
            finally:
                await app.client.close()
                if proc.returncode is None:
                    proc.send_signal(signal.SIGTERM)
                rc = await asyncio.wait_for(proc.wait(), 30)
                await drainer
            assert rc == 0, "".join(lines)

    run()
