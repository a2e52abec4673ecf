"""The port's audio tower and TTS head (``agentfield_tpu_torch.models.audio``)
against the JAX package's, on the CPU in float32 with the same carried
weights:

- both mel filterbanks equal (numpy constants); ``log_mel`` "htk" and
  "whisper": the mel energies (``exp`` / ``10**`` of the log) within
  ``ENERGY_RTOL`` (1e-5) of the clip's largest, the logs within ``MEL_ATOL``
  (1e-3). The two FFTs sum in another order; near htk's floor (``log(mel +
  1e-6)`` of a pure tone's empty bins, about -13.8) a roundoff of 1e-12 in
  energy moves the log by up to 6e-4 (seen), so the log bound is wider than
  the energies';
- ``encode_hidden`` and ``audio_encode`` with the "group" and the "conv"
  front end, tanh and erf GELU, and a tree saved before the encoder had
  biases: within ``RTOL`` (1e-5) of the largest output (seen below 1e-6);
- ``tts_synthesize`` within ``RTOL``; every init the JAX tree's keys and
  shapes, every preset equal;
- the WAV codec: ``float_to_wav`` bytes equal; ``wav_to_float`` equal on
  16-bit, 8-bit and 32-bit, stereo and 8 kHz input; its errors equal;
- ``load_whisper_encoder`` on a checkpoint ``transformers`` writes in the
  test: config equal to the JAX loader's, every encoder leaf bit-equal, the
  whisper mel within 2e-3 of ``WhisperFeatureExtractor`` and the encoder
  within 2e-3 of ``transformers``' (the JAX tests' bounds) and ``RTOL`` of
  the JAX tower;
- the JAX node scripts of ``tests/test_audio.py`` through both nodes: a
  base64 WAV and a sample list, marker mismatches, ``output`` "audio" and
  "speech" (WAV samples within one 16-bit level), truncation of the TTS
  text (bytes cut, UTF-8 kept whole), media with ``output="audio"``, a node
  without the tower or head (refused before any decode), an unknown
  modality; and a node serving a Whisper checkpoint directory.
"""

from __future__ import annotations

import base64
import dataclasses
import io
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentfield_tpu.models import audio as jax_audio
from agentfield_tpu_torch.models import audio
from agentfield_tpu_torch.models.convert import tower_params_from_numpy
from tests import helpers_torch_mm as mm

RTOL = 1e-5  # of the largest |output|
MEL_ATOL = 1e-3
ENERGY_RTOL = 1e-5  # float32 FFTs over n_fft samples: seen 1.1e-6
ECFG = dict(max_batch=4, page_size=8, num_pages=128, max_pages_per_seq=16)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    return mm.llama_tiny(0)


def _close(got: torch.Tensor, want, rtol: float = RTOL) -> float:
    want = np.asarray(want)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= rtol * float(np.abs(want).max()), (err, float(np.abs(want).max()))
    return err


def _tone(freq=440.0, seconds=1.0, rate=16000):
    n = int(seconds * rate)
    return np.sin(2 * np.pi * freq * np.arange(n) / rate).astype(np.float32)


# a small Whisper-form tower: conv stem, whisper mel, 1 s
CONV = dict(frontend="conv", mel_impl="whisper", n_mels=16, max_seconds=1.0)
TOWERS = {"group": {}, "group_erf": dict(gelu_exact=True), "conv": CONV,
          "conv_erf": dict(CONV, gelu_exact=True)}


@pytest.mark.parametrize("impl", ["htk", "whisper"])
def test_filterbanks_and_log_mel_match_jax(impl):
    jcfg = dataclasses.replace(jax_audio.get_audio_config("audio-tiny"), mel_impl=impl)
    pcfg = mm.port_cfg(jcfg)
    np.testing.assert_array_equal(audio.mel_filterbank(pcfg), jax_audio._mel_filterbank(jcfg))
    np.testing.assert_array_equal(audio.mel_filterbank_slaney(pcfg),
                                  jax_audio._mel_filterbank_slaney(jcfg))
    rng = np.random.default_rng(0)
    wave_ = np.stack([_tone(440.0)[: jcfg.max_samples],
                      (rng.standard_normal(jcfg.max_samples) * 0.1).astype(np.float32)])
    want = np.asarray(jax_audio.log_mel(jcfg, jnp.asarray(wave_)))
    got = audio.log_mel(pcfg, torch.from_numpy(wave_)).numpy()
    assert got.shape == want.shape == (2, jcfg.n_frames, jcfg.n_mels)
    assert float(np.abs(got - want).max()) <= MEL_ATOL
    energy = (np.exp if impl == "htk" else lambda x: 10.0 ** (4.0 * x - 4.0))
    eg, ew = energy(got.astype(np.float64)), energy(want.astype(np.float64))
    assert float(np.abs(eg - ew).max()) <= ENERGY_RTOL * float(ew.max())


@pytest.mark.parametrize("tower", list(TOWERS))
def test_encoder_matches_jax(tower):
    (jcfg, jp), (pcfg, pp) = mm.tower("audio", "audio-tiny", **TOWERS[tower])
    rng = np.random.default_rng(1)
    wave_ = (rng.standard_normal((2, jcfg.max_samples)) * 0.1).astype(np.float32)
    mel = np.array(jax_audio.log_mel(jcfg, jnp.asarray(wave_)))
    _close(audio.encode_hidden(pp, pcfg, torch.from_numpy(mel)),
           jax_audio.encode_hidden(jp, jcfg, jnp.asarray(mel)))
    got = audio.audio_encode(pp, pcfg, torch.from_numpy(wave_))
    assert got.shape == (2, jcfg.n_tokens, jcfg.out_dim)
    _close(got, jax_audio.audio_encode(jp, jcfg, jnp.asarray(wave_)))


def test_pre_bias_tree_upgrades_as_jax():
    (jcfg, jp), (pcfg, pp) = mm.tower("audio", "audio-tiny")
    jp = {**jp, "layers": {k: v for k, v in jp["layers"].items() if not k.startswith("b")}}
    pp = {**pp, "layers": {k: v for k, v in pp["layers"].items() if not k.startswith("b")}}
    wave_ = (np.random.default_rng(2).standard_normal((1, jcfg.max_samples)) * 0.1).astype(
        np.float32)
    _close(audio.audio_encode(pp, pcfg, torch.from_numpy(wave_)),
           jax_audio.audio_encode(jp, jcfg, jnp.asarray(wave_)))


def test_tts_matches_jax():
    (jcfg, jp), (pcfg, pp) = mm.tower("tts", "tts-tiny")
    ids = np.zeros((3, jcfg.max_chars), np.int32)
    for b, text in enumerate([b"hello", b"world!", b""]):
        ids[b, : len(text)] = np.frombuffer(text, np.uint8)
    got = audio.tts_synthesize(pp, pcfg, torch.from_numpy(ids))
    assert got.shape == (3, jcfg.max_samples) and got.dtype == torch.float32
    _close(got, jax_audio.tts_synthesize(jp, jcfg, jnp.asarray(ids)))


def _paths(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("name", ["audio-tiny", "whisper-tiny", "tts-tiny"])
def test_init_and_presets_match_jax(name):
    tts = name.startswith("tts")
    jmod_cfg = (jax_audio.get_tts_config if tts else jax_audio.get_audio_config)(name)
    if name == "whisper-tiny":  # 30 s: keep the draw small
        jmod_cfg = dataclasses.replace(jmod_cfg, num_layers=1)
    pcfg = mm.port_cfg(jmod_cfg)
    jtree = (jax_audio.init_tts_params if tts else jax_audio.init_audio_params)(
        jmod_cfg, jax.random.PRNGKey(0))
    ptree = (audio.init_tts_params if tts else audio.init_audio_params)(pcfg, 0, "cpu")
    jl, pl = _paths(jtree), _paths(ptree)
    assert sorted(jl) == sorted(pl)
    for k in jl:
        assert tuple(pl[k].shape) == tuple(jl[k].shape), k
        assert str(pl[k].dtype).split(".")[-1] == str(jl[k].dtype), k
    assert audio.CONFIGS.keys() == jax_audio.CONFIGS.keys()
    assert audio.TTS_CONFIGS.keys() == jax_audio.TTS_CONFIGS.keys()
    assert all(mm.port_cfg(c) == audio.CONFIGS[n] for n, c in jax_audio.CONFIGS.items())
    assert all(mm.port_cfg(c) == audio.TTS_CONFIGS[n] for n, c in jax_audio.TTS_CONFIGS.items())


def _wav(x: np.ndarray, rate: int, width: int, channels: int) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        if width == 1:
            raw = (x * 127 + 128).astype(np.uint8)
        elif width == 2:
            raw = (x * 32767).astype("<i2")
        else:
            raw = (x * 2147483000).astype("<i4")
        w.writeframes(np.repeat(raw, channels).tobytes())
    return buf.getvalue()


@pytest.mark.parametrize("rate,width,channels,seconds", [
    (16000, 2, 1, 0.5), (8000, 2, 2, 0.5), (22050, 1, 1, 0.3), (16000, 4, 1, 2.0),
    (44100, 2, 2, 0.2)])
def test_wav_codec_matches_jax(rate, width, channels, seconds):
    x = _tone(330.0, seconds, rate) * 0.8
    data = _wav(x, rate, width, channels)
    np.testing.assert_array_equal(audio.wav_to_float(data, 16000, 16000),
                                  jax_audio.wav_to_float(data, 16000, 16000))
    assert audio.float_to_wav(x, rate) == jax_audio.float_to_wav(x, rate)


def test_wav_errors_match_jax():
    bad24 = io.BytesIO()
    with wave.open(bad24, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(3)
        w.setframerate(16000)
        w.writeframes(b"\0" * 30)
    for data in (b"not audio at all", bad24.getvalue()):
        with pytest.raises(ValueError) as want:
            jax_audio.wav_to_float(data, 16000, 100)
        with pytest.raises(ValueError) as got:
            audio.wav_to_float(data, 16000, 100)
        assert str(got.value) == str(want.value)


# -- pretrained Whisper encoder ---------------------------------------------


def _whisper_ckpt(tmp_path):
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.WhisperConfig(
        vocab_size=64, num_mel_bins=80, d_model=32, encoder_layers=2,
        encoder_attention_heads=2, encoder_ffn_dim=64, decoder_layers=1,
        decoder_attention_heads=2, decoder_ffn_dim=64, max_source_positions=150,
        max_target_positions=64, pad_token_id=0, bos_token_id=1, eos_token_id=2,
        decoder_start_token_id=1, suppress_tokens=None, begin_suppress_tokens=None)
    torch.manual_seed(0)
    model = transformers.WhisperModel(hf_cfg).eval().to(torch.float32)
    d = tmp_path / "whisper-ckpt"
    model.save_pretrained(d, safe_serialization=True)
    return model, d


def test_whisper_loader_matches_jax_and_transformers(tmp_path):
    transformers = pytest.importorskip("transformers")
    model, d = _whisper_ckpt(tmp_path)
    jcfg, jp = jax_audio.load_whisper_encoder(str(d), out_dim=128)
    pcfg, pp = audio.load_whisper_encoder(str(d), out_dim=128, device="cpu")
    assert pcfg == mm.port_cfg(jcfg) and pcfg.n_tokens == 150
    jl, pl = _paths(jp), _paths(pp)
    assert sorted(jl) == sorted(pl)
    for k, v in jl.items():
        if not k.startswith("proj_"):  # the projector stays random
            np.testing.assert_array_equal(pl[k].numpy(), np.asarray(v), err_msg=k)
    rng = np.random.default_rng(0)
    wave_ = (rng.standard_normal(pcfg.max_samples) * 0.1).astype(np.float32)
    fe = transformers.WhisperFeatureExtractor(feature_size=80, chunk_length=3)
    want = fe(wave_, sampling_rate=16000, return_tensors="np").input_features[0]
    got = audio.log_mel(pcfg, torch.from_numpy(wave_)[None])[0].numpy().T
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    feats = rng.standard_normal((1, pcfg.n_mels, pcfg.n_frames)).astype(np.float32)
    with torch.no_grad():
        want = model.encoder(torch.tensor(feats)).last_hidden_state.numpy()
    mel = np.transpose(feats, (0, 2, 1))
    got = audio.encode_hidden(pp, pcfg, torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    _close(got, jax_audio.encode_hidden(jp, jcfg, jnp.asarray(mel)))


def test_whisper_loader_refusals_match_jax(tmp_path):
    d = tmp_path / "not-whisper"
    d.mkdir()
    (d / "config.json").write_text('{"d_model": 8, "num_mel_bins": 8, "encoder_layers": 1, '
                                   '"encoder_attention_heads": 1, "encoder_ffn_dim": 8}')
    for load in (jax_audio.load_whisper_encoder, audio.load_whisper_encoder):
        with pytest.raises(FileNotFoundError, match="no \\*.safetensors"):
            load(str(d))


def test_node_serves_a_whisper_checkpoint_as_jax(weights, tmp_path):
    _, d = _whisper_ckpt(tmp_path)
    ecfg = dict(max_batch=2, page_size=8, num_pages=256, max_pages_per_seq=32)
    b = mm.port_backend(weights, ecfg, audio=str(d))
    want_cfg = dataclasses.replace(
        mm.port_cfg(jax_audio.load_whisper_encoder(str(d), out_dim=128)[0]), dtype="bfloat16")
    assert b.audio_cfg == want_cfg and b.audio_params["conv1_w"].dtype == torch.bfloat16
    b.stop()
    jcfg, jp = jax_audio.load_whisper_encoder(str(d), out_dim=128)
    pcfg = mm.port_cfg(jcfg)
    pp = tower_params_from_numpy(jax.tree.map(np.asarray, jp), pcfg, device="cpu")
    wav = base64.b64encode(jax_audio.float_to_wav(_tone(440.0, 0.5), 16000)).decode()
    calls = [dict(prompt="transcribe: <audio>", audios=[{"b64": wav}], max_new_tokens=4)]
    want = mm.jax_calls(weights, ecfg, calls, audio=(jcfg, jp))
    b = mm.port_backend(weights, ecfg, audio=(pcfg, pp))
    b.start()
    try:
        got = mm.port_calls(b, calls)
    finally:
        b.stop()
    mm.assert_same(want, got)
    assert len(got[0]["tokens"]) == 4


# -- the node ---------------------------------------------------------------


def _wav_b64(freq=440.0, seconds=0.5):
    return base64.b64encode(jax_audio.float_to_wav(_tone(freq, seconds), 16000)).decode()


NODE_SCRIPT = {
    "b64": dict(prompt="transcribe: <audio>", audios=[{"b64": _wav_b64()}], max_new_tokens=4),
    "samples": dict(prompt="transcribe: <audio>", audios=[_tone(880.0, 0.25).tolist()],
                    max_new_tokens=4),
    "markers": dict(prompt="no marker", audios=[{"b64": _wav_b64()}] * 2),
    "tokens": dict(tokens=[1, 2, 3], audios=[{"b64": _wav_b64()}]),
    "speak": dict(prompt="hello tpu", output="audio"),
    "speech": dict(prompt="abc", max_new_tokens=4, output="speech"),
    "speak_long": dict(prompt="x" * 100, output="audio"),
    "speak_utf8": dict(prompt="é" * 32, output="audio"),
    "speak_media": dict(prompt="<audio>", audios=[{"b64": _wav_b64()}], output="audio"),
    "speak_empty": dict(prompt="", output="audio"),
    "speech_tokens": dict(tokens=[5, 6, 7], max_new_tokens=3, output="speech"),
    "video": dict(prompt="x", output="video"),
}


def test_node_script_matches_jax(weights):
    (ja, jap), (pa, pap) = mm.tower("audio", "audio-tiny")
    (jt, jtp), (pt, ptp) = mm.tower("tts", "tts-tiny")
    calls = list(NODE_SCRIPT.values())
    want = mm.jax_calls(weights, ECFG, calls, audio=(ja, jap), tts=(jt, jtp))
    b = mm.port_backend(weights, ECFG, audio=(pa, pap), tts=(pt, ptp))
    b.start()
    try:
        got = mm.port_calls(b, calls)
    finally:
        b.stop()
    worst = mm.assert_same(want, got, list(NODE_SCRIPT))
    assert worst["wav_levels"] <= mm.WAV_LSB  # seen: 0 or 1
    names = list(NODE_SCRIPT)
    speak = got[names.index("speak")]
    assert speak["finish_reason"] == "tts"
    n = len(b"hello tpu") * pt.frames_per_char * pt.samples_per_frame
    assert len(mm.wav_samples(speak["parts"][0]["data_b64"])) == n
    assert got[names.index("speak_long")]["tts_truncated_chars"] == 100 - pt.max_chars
    assert got[names.index("speak_utf8")]["tts_truncated_chars"] % 2 == 0


def test_node_without_tower_or_head_refuses_before_any_decode(weights):
    calls = [dict(prompt="<audio>", audios=[{"b64": _wav_b64()}]),
             dict(prompt="say this", output="audio"),
             dict(prompt="x", max_new_tokens=64, output="speech")]
    want = mm.jax_calls(weights, ECFG, calls)
    b = mm.port_backend(weights, ECFG)
    b.start()
    try:
        before = b.engine.stats["decode_steps"]
        got = mm.port_calls(b, calls)
        assert b.engine.stats["decode_steps"] == before
    finally:
        b.stop()
    mm.assert_same(want, got)
