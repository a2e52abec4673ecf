"""Audio: a log-mel encoder tower (input) and a TTS head (output) —
counterpart of ``agentfield_tpu/models/audio.py``.

- Input, ``audio_encode``: waveform → log-mel spectrogram → encoder →
  LLM-space embeddings, injected at ``<audio>`` markers of the prompt as the
  vision tower's patches are (``models.vision``).
- Output, ``tts_synthesize``: byte-level text → encoder → per-character
  frame upsampling → waveform.

The parameter layout is the JAX package's. ``log_mel`` has both mel
front ends: "htk" (this module's filterbank on raw frames, a symmetric
``np.hanning`` window) and "whisper" (WhisperFeatureExtractor: reflect-padded
centered frames, a periodic Hann window, slaney filters, log10 with a
per-clip max-8 floor); both filterbanks are numpy constants, as in the JAX
package. The encoder is ``models.vision.encoder`` with GELU in the JAX
form (tanh unless ``gelu_exact``). ``load_whisper_encoder`` reads a Hugging
Face Whisper checkpoint through the port's own safetensors reader.
``wav_to_float``/``float_to_wav`` are the stdlib ``wave`` codec.
"""

from __future__ import annotations

import dataclasses
import io
import json
import struct
import wave as _wave
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from agentfield_tpu_torch.models.llama import resolve_dtype
from agentfield_tpu_torch.models.vision import (
    encoder,
    init_encoder_layers,
    layer_norm,
    normal_init,
    project,
)

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    """Input tower: waveform → LLM-space embeddings."""

    sample_rate: int = 16000
    n_fft: int = 400  # 25 ms window
    hop: int = 160  # 10 ms hop
    n_mels: int = 80
    max_seconds: float = 10.0  # static waveform budget (pad/trim)
    frame_group: int = 4  # consecutive mel frames per encoder token
    hidden_size: int = 512
    num_layers: int = 6
    num_heads: int = 8
    mlp_ratio: int = 4
    out_dim: int = 2048  # LLM hidden size the projector maps into
    layer_norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    frontend: str = "group"  # "group": frame_group mel frames → one linear token;
    # "conv": Whisper's two-Conv1d stem (k=3; stride 1, then conv_stride)
    conv_stride: int = 2
    mel_impl: str = "htk"  # "htk" | "whisper" (WhisperFeatureExtractor's features)
    gelu_exact: bool = False  # erf GELU (HF "gelu") instead of the tanh form

    @property
    def max_samples(self) -> int:
        return int(self.sample_rate * self.max_seconds)

    @property
    def n_frames(self) -> int:
        if self.mel_impl == "whisper":
            return self.max_samples // self.hop  # centered frames, the last dropped
        return 1 + (self.max_samples - self.n_fft) // self.hop

    @property
    def n_tokens(self) -> int:
        if self.frontend == "conv":
            return -(-self.n_frames // self.conv_stride)
        return self.n_frames // self.frame_group


@dataclasses.dataclass(frozen=True)
class TTSConfig:
    """Output head: byte-level text → waveform."""

    sample_rate: int = 16000
    vocab_size: int = 256
    max_chars: int = 256  # static text budget
    frames_per_char: int = 8
    samples_per_frame: int = 160  # 10 ms of audio per frame
    hidden_size: int = 384
    num_layers: int = 4
    num_heads: int = 6
    mlp_ratio: int = 4
    layer_norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def max_samples(self) -> int:
        return self.max_chars * self.frames_per_char * self.samples_per_frame


CONFIGS = {
    "audio-base": AudioConfig(),
    # test tower: about 1 s; out_dim is llama-tiny's hidden size
    "audio-tiny": AudioConfig(
        n_fft=128, hop=64, n_mels=16, max_seconds=1.0, frame_group=4,
        hidden_size=32, num_layers=2, num_heads=2, out_dim=128,
    ),
    # openai/whisper-tiny's encoder shape (load_whisper_encoder takes the
    # dims from a checkpoint's config.json)
    "whisper-tiny": AudioConfig(
        max_seconds=30.0, hidden_size=384, num_layers=4, num_heads=6,
        frontend="conv", mel_impl="whisper", gelu_exact=True, dtype="float32",
    ),
}

TTS_CONFIGS = {
    "tts-base": TTSConfig(),
    "tts-tiny": TTSConfig(
        max_chars=32, frames_per_char=4, samples_per_frame=40,
        hidden_size=32, num_layers=2, num_heads=2,
    ),
}


def get_audio_config(name: str) -> AudioConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown audio config {name!r}; have {sorted(CONFIGS)}")
    return CONFIGS[name]


def get_tts_config(name: str) -> TTSConfig:
    if name not in TTS_CONFIGS:
        raise KeyError(f"unknown tts config {name!r}; have {sorted(TTS_CONFIGS)}")
    return TTS_CONFIGS[name]


def _gelu(exact: bool):
    return (lambda x: F.gelu(x)) if exact else (lambda x: F.gelu(x, approximate="tanh"))


# ---------------------------------------------------------------------------
# log-mel front end
# ---------------------------------------------------------------------------


def mel_filterbank(cfg: AudioConfig) -> np.ndarray:
    """[n_fft//2+1, n_mels] triangular filterbank on the HTK mel scale."""
    n_bins = cfg.n_fft // 2 + 1
    f_max = cfg.sample_rate / 2.0
    mel_max = 2595.0 * np.log10(1.0 + f_max / 700.0)
    mel_pts = np.linspace(0.0, mel_max, cfg.n_mels + 2)
    hz_pts = 700.0 * (10.0 ** (mel_pts / 2595.0) - 1.0)
    bins = np.floor((cfg.n_fft + 1) * hz_pts / cfg.sample_rate).astype(int)
    fb = np.zeros((n_bins, cfg.n_mels), np.float32)
    for m in range(1, cfg.n_mels + 1):
        lo, c, hi = bins[m - 1], bins[m], bins[m + 1]
        for k in range(lo, c):
            if c > lo:
                fb[k, m - 1] = (k - lo) / (c - lo)
        for k in range(c, hi):
            if hi > c:
                fb[k, m - 1] = (hi - k) / (hi - c)
    return fb


def mel_filterbank_slaney(cfg: AudioConfig) -> np.ndarray:
    """[n_fft//2+1, n_mels] slaney-scale, slaney-normalized filterbank
    (librosa's default, hence WhisperFeatureExtractor's)."""
    n_bins = cfg.n_fft // 2 + 1
    fftfreqs = np.linspace(0.0, cfg.sample_rate / 2.0, n_bins)

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        mel = f * 3.0 / 200.0
        return np.where(f >= 1000.0,
                        15.0 + np.log(np.maximum(f, 1e-9) / 1000.0) / (np.log(6.4) / 27.0), mel)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)),
                        m * 200.0 / 3.0)

    mel_pts = np.linspace(hz_to_mel(0.0), hz_to_mel(cfg.sample_rate / 2.0), cfg.n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    fb *= (2.0 / (hz_pts[2: cfg.n_mels + 2] - hz_pts[: cfg.n_mels]))[:, None]
    return fb.T.astype(np.float32)


def log_mel(cfg: AudioConfig, wave: torch.Tensor) -> torch.Tensor:
    """[B, max_samples] float in [-1, 1] → [B, n_frames, n_mels] log-mel
    (``torch.fft.rfft`` over strided frames, the filterbank a matmul)."""
    wave = wave.float()
    dev = wave.device
    if cfg.mel_impl == "whisper":
        half = cfg.n_fft // 2
        padded = F.pad(wave[:, None], (half, half), mode="reflect")[:, 0]
        frames = padded.unfold(-1, cfg.n_fft, cfg.hop)[:, : cfg.n_frames + 1]
        n = np.arange(cfg.n_fft, dtype=np.float32)
        window = torch.from_numpy(0.5 * (1.0 - np.cos(2.0 * np.pi * n / cfg.n_fft))).to(dev)
        power = (torch.fft.rfft(frames * window, dim=-1).abs() ** 2)[:, :-1]
        mel = power @ torch.from_numpy(mel_filterbank_slaney(cfg)).to(dev)
        log_spec = torch.log10(torch.clamp(mel, min=1e-10))
        peak = log_spec.amax(dim=(1, 2), keepdim=True)
        log_spec = torch.maximum(log_spec, peak - 8.0)
        return (log_spec + 4.0) / 4.0
    frames = wave.unfold(-1, cfg.n_fft, cfg.hop)[:, : cfg.n_frames]
    window = torch.from_numpy(np.hanning(cfg.n_fft).astype(np.float32)).to(dev)
    power = torch.fft.rfft(frames * window, dim=-1).abs() ** 2
    mel = power @ torch.from_numpy(mel_filterbank(cfg)).to(dev)
    return torch.log(mel + 1e-6)


# ---------------------------------------------------------------------------
# input tower: waveform → LLM-space embeddings
# ---------------------------------------------------------------------------


def init_audio_params(cfg: AudioConfig, seed: int = 0, device="cuda") -> Params:
    """Random weights drawn from a ``torch.Generator`` seeded with ``seed``,
    on ``device`` in ``cfg.dtype``."""
    dt = resolve_dtype(cfg.dtype)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    norm = normal_init(g, dt, device)
    d = cfg.hidden_size
    if cfg.frontend == "conv":  # Whisper's conv stem, [out, in, k]
        stem = {"conv1_w": norm(d, cfg.n_mels, 3),
                "conv1_b": torch.zeros(d, dtype=dt, device=device),
                "conv2_w": norm(d, d, 3),
                "conv2_b": torch.zeros(d, dtype=dt, device=device)}
    else:
        stem = {"frame_embed": norm(cfg.frame_group * cfg.n_mels, d)}
    return {
        **stem,
        "pos_embed": norm(cfg.n_tokens, d),
        "layers": init_encoder_layers(norm, cfg.num_layers, d, d * cfg.mlp_ratio, dt, device),
        "final_ln_w": torch.ones(d, dtype=dt, device=device),
        "final_ln_b": torch.zeros(d, dtype=dt, device=device),
        "proj_w1": norm(d, cfg.out_dim),
        "proj_w2": norm(cfg.out_dim, cfg.out_dim),
    }


def encode_hidden(params: Params, cfg: AudioConfig, mel: torch.Tensor) -> torch.Tensor:
    """[B, n_frames, n_mels] mel → [B, n_tokens, hidden] encoder states
    (pre-projector; a Whisper checkpoint's encoder ``last_hidden_state``)."""
    B = mel.shape[0]
    if cfg.frontend == "conv":
        act = _gelu(cfg.gelu_exact)
        xc = mel.transpose(1, 2).float()  # [B, n_mels, T]
        # torch Conv1d padding=1 on both sides, as the JAX stem pads explicitly
        xc = act(F.conv1d(xc, params["conv1_w"].float(), padding=1)
                 + params["conv1_b"].float()[None, :, None])
        xc = act(F.conv1d(xc, params["conv2_w"].float(), stride=cfg.conv_stride, padding=1)
                 + params["conv2_b"].float()[None, :, None])
        x = xc.transpose(1, 2).to(mel.dtype) + params["pos_embed"]
    else:
        usable = cfg.n_tokens * cfg.frame_group
        x = mel[:, :usable].reshape(B, cfg.n_tokens, cfg.frame_group * cfg.n_mels)
        x = x @ params["frame_embed"] + params["pos_embed"]
    x = encoder(x, params["layers"], cfg.num_heads, cfg.layer_norm_eps, _gelu(cfg.gelu_exact))
    return layer_norm(x, params["final_ln_w"], params["final_ln_b"], cfg.layer_norm_eps)


def audio_encode(params: Params, cfg: AudioConfig, wave: torch.Tensor) -> torch.Tensor:
    """wave [B, max_samples] float32 in [-1, 1] (padded or trimmed on the
    host) → [B, n_tokens, out_dim] LLM-space embeddings in the tower dtype."""
    with torch.inference_mode():
        mel = log_mel(cfg, wave)
        return project(params, encode_hidden(params, cfg, mel.to(resolve_dtype(cfg.dtype))))


def load_whisper_encoder(path: str, out_dim: int = 2048, dtype: str = "float32", seed: int = 0,
                         device="cuda") -> tuple[AudioConfig, Params]:
    """A Hugging Face Whisper checkpoint directory → ``(AudioConfig,
    params)`` on ``device`` in ``dtype``, as the JAX ``load_whisper_encoder``
    maps it: the encoder only (conv stem, sinusoidal positions, layers with
    a zero k bias, final LN), whisper mel, conv front end; the projector
    stays random, drawn from ``seed``."""
    from agentfield_tpu_torch.models.hf_loader import open_checkpoint

    p = Path(path)
    hf = json.loads((p / "config.json").read_text())
    d = int(hf["d_model"])
    cfg = AudioConfig(
        sample_rate=16000, n_fft=400, hop=160, n_mels=int(hf["num_mel_bins"]),
        max_seconds=float(hf.get("max_source_positions", 1500) * 2 * 160) / 16000.0,
        hidden_size=d, num_layers=int(hf["encoder_layers"]),
        num_heads=int(hf["encoder_attention_heads"]),
        mlp_ratio=int(hf["encoder_ffn_dim"]) // d, out_dim=out_dim, frontend="conv",
        mel_impl="whisper", gelu_exact=hf.get("activation_function", "gelu") == "gelu",
        dtype=dtype,
    )
    handles = open_checkpoint(p)
    if not any(n.startswith(("model.encoder.", "encoder.")) for n in handles):
        raise KeyError(f"no encoder tensors in {p} (not a Whisper checkpoint?)")
    dt = resolve_dtype(dtype)

    def get(name: str) -> torch.Tensor:
        for prefix in ("model.encoder.", "encoder."):
            if prefix + name in handles:
                return handles[prefix + name].get(prefix + name).to(device=device, dtype=dt,
                                                                     copy=True)
        raise KeyError(f"missing encoder tensor {name!r}")

    def stack(fmt: str, transpose: bool = True) -> torch.Tensor:
        return torch.stack([get(fmt.format(i)).T if transpose else get(fmt.format(i))
                            for i in range(cfg.num_layers)]).contiguous()

    pre = "layers.{}."
    bq = stack(pre + "self_attn.q_proj.bias", False)
    layers = {
        "ln1_w": stack(pre + "self_attn_layer_norm.weight", False),
        "ln1_b": stack(pre + "self_attn_layer_norm.bias", False),
        "ln2_w": stack(pre + "final_layer_norm.weight", False),
        "ln2_b": stack(pre + "final_layer_norm.bias", False),
        "wqkv": torch.cat([stack(pre + f"self_attn.{n}_proj.weight") for n in "qkv"], dim=2),
        "bqkv": torch.cat([bq, torch.zeros_like(bq), stack(pre + "self_attn.v_proj.bias", False)],
                          dim=1),
        "wo": stack(pre + "self_attn.out_proj.weight"),
        "bo": stack(pre + "self_attn.out_proj.bias", False),
        "w1": stack(pre + "fc1.weight"), "b1": stack(pre + "fc1.bias", False),
        "w2": stack(pre + "fc2.weight"), "b2": stack(pre + "fc2.bias", False),
    }
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    norm = normal_init(g, dt, device)
    params: Params = {
        "conv1_w": get("conv1.weight"), "conv1_b": get("conv1.bias"),
        "conv2_w": get("conv2.weight"), "conv2_b": get("conv2.bias"),
        "pos_embed": get("embed_positions.weight")[: cfg.n_tokens].contiguous(),
        "layers": layers,
        "final_ln_w": get("layer_norm.weight"), "final_ln_b": get("layer_norm.bias"),
        "proj_w1": norm(d, out_dim), "proj_w2": norm(out_dim, out_dim),
    }
    for h in set(handles.values()):
        h.close()
    return cfg, params


# ---------------------------------------------------------------------------
# output head: text bytes → waveform
# ---------------------------------------------------------------------------


def init_tts_params(cfg: TTSConfig, seed: int = 0, device="cuda") -> Params:
    dt = resolve_dtype(cfg.dtype)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    norm = normal_init(g, dt, device)
    d = cfg.hidden_size
    return {
        "char_embed": norm(cfg.vocab_size, d),
        "pos_embed": norm(cfg.max_chars, d),
        "layers": init_encoder_layers(norm, cfg.num_layers, d, d * cfg.mlp_ratio, dt, device),
        "final_ln_w": torch.ones(d, dtype=dt, device=device),
        "final_ln_b": torch.zeros(d, dtype=dt, device=device),
        "up_w": norm(d, cfg.frames_per_char * d),  # one char → frames_per_char frames
        "wav_w": norm(d, cfg.samples_per_frame),  # one frame → its samples
    }


def tts_synthesize(params: Params, cfg: TTSConfig, char_ids: torch.Tensor) -> torch.Tensor:
    """[B, max_chars] byte ids (0-padded) → [B, max_samples] float32
    waveform in (-1, 1); the host trims it to the speakable length."""
    with torch.inference_mode():
        B, d = char_ids.shape[0], cfg.hidden_size
        x = params["char_embed"][char_ids.long()] + params["pos_embed"]
        x = encoder(x, params["layers"], cfg.num_heads, cfg.layer_norm_eps, _gelu(False))
        x = layer_norm(x, params["final_ln_w"], params["final_ln_b"], cfg.layer_norm_eps)
        frames = (x @ params["up_w"]).reshape(B, cfg.max_chars * cfg.frames_per_char, d)
        wav = (frames @ params["wav_w"]).float().reshape(B, cfg.max_samples)
        return torch.tanh(wav)


# ---------------------------------------------------------------------------
# WAV codec (host side, stdlib only)
# ---------------------------------------------------------------------------


def wav_to_float(data: bytes, target_rate: int, max_samples: int) -> np.ndarray:
    """A PCM WAV → [max_samples] float32 in [-1, 1]: mono mix,
    nearest-neighbour resample to ``target_rate``, pad or trim. Raises
    ValueError on non-PCM or malformed input."""
    try:
        with _wave.open(io.BytesIO(data), "rb") as w:
            n_ch, width, rate, n_frames = (
                w.getnchannels(), w.getsampwidth(), w.getframerate(), w.getnframes())
            raw = w.readframes(n_frames)
    except (_wave.Error, EOFError, struct.error) as e:
        raise ValueError(f"not a decodable PCM WAV: {e}") from e
    if width == 2:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 1:  # unsigned 8-bit
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 4:
        x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported PCM sample width {width}")
    if n_ch > 1:
        x = x[: (len(x) // n_ch) * n_ch].reshape(-1, n_ch).mean(axis=1)
    if rate != target_rate and len(x):
        idx = np.clip(np.arange(int(len(x) * target_rate / rate)) * rate / target_rate,
                      0, len(x) - 1).astype(np.int64)
        x = x[idx]
    out = np.zeros((max_samples,), np.float32)
    n = min(len(x), max_samples)
    out[:n] = x[:n]
    return out


def float_to_wav(wave_f32: np.ndarray, rate: int) -> bytes:
    """[-1, 1] float32 → 16-bit mono PCM WAV bytes."""
    pcm = (np.clip(wave_f32, -1.0, 1.0) * 32767.0).astype("<i2")
    buf = io.BytesIO()
    with _wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()
