"""Image-generation head: text → image, served through the response's
``parts`` — counterpart of ``agentfield_tpu/models/image_gen.py``.

A byte-level text encoder, mean-pooled over the real characters, conditions
a grid of learned patch queries; a canvas encoder and a patch head emit the
image, unpatchified by reshape. Both stacks are ``models.vision.encoder``
(tanh GELU, as the JAX ``_encoder``); the parameter layout is the JAX
package's. ``image_to_png`` goes through the port's own PNG encoder
(``models.media_codec``): the card's machine has no Pillow.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from agentfield_tpu_torch.models import media_codec
from agentfield_tpu_torch.models.llama import resolve_dtype
from agentfield_tpu_torch.models.vision import (
    encoder,
    init_encoder_layers,
    layer_norm,
    normal_init,
)

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ImageGenConfig:
    vocab_size: int = 256  # byte-level prompt
    max_chars: int = 256  # static text budget
    image_size: int = 64  # square canvas
    patch_size: int = 8
    hidden_size: int = 384
    num_text_layers: int = 3
    num_canvas_layers: int = 3
    num_heads: int = 6
    mlp_ratio: int = 4
    layer_norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * 3


CONFIGS = {
    "imagegen-base": ImageGenConfig(image_size=256, patch_size=16, hidden_size=768,
                                    num_text_layers=6, num_canvas_layers=6, num_heads=12),
    "imagegen-tiny": ImageGenConfig(
        max_chars=32, image_size=32, patch_size=8, hidden_size=32,
        num_text_layers=1, num_canvas_layers=1, num_heads=2,
    ),
}


def get_imagegen_config(name: str) -> ImageGenConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown imagegen config {name!r}; have {sorted(CONFIGS)}")
    return CONFIGS[name]


def init_imagegen_params(cfg: ImageGenConfig, seed: int = 0, device="cuda") -> Params:
    dt = resolve_dtype(cfg.dtype)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    norm = normal_init(g, dt, device)
    d, f = cfg.hidden_size, cfg.hidden_size * cfg.mlp_ratio
    return {
        "char_embed": norm(cfg.vocab_size, d),
        "char_pos": norm(cfg.max_chars, d),
        "text_layers": init_encoder_layers(norm, cfg.num_text_layers, d, f, dt, device),
        "canvas_queries": norm(cfg.num_patches, d),
        "canvas_layers": init_encoder_layers(norm, cfg.num_canvas_layers, d, f, dt, device),
        "final_ln_w": torch.ones(d, dtype=dt, device=device),
        "final_ln_b": torch.zeros(d, dtype=dt, device=device),
        "patch_head": norm(d, cfg.patch_dim),
    }


def imagegen_synthesize(params: Params, cfg: ImageGenConfig,
                        char_ids: torch.Tensor) -> torch.Tensor:
    """[B, max_chars] byte ids (0-padded) → [B, S, S, 3] float32 in (0, 1)."""
    def act(x):
        return F.gelu(x, approximate="tanh")

    with torch.inference_mode():
        B = char_ids.shape[0]
        x = params["char_embed"][char_ids.long()] + params["char_pos"]
        x = encoder(x, params["text_layers"], cfg.num_heads, cfg.layer_norm_eps, act)
        # masked mean over the real (nonzero) chars; an all-padding prompt
        # takes a plain mean over none, divided by 1
        real = (char_ids > 0).float()[..., None]
        cond = (x.float() * real).sum(dim=1) / real.sum(dim=1).clamp(min=1.0)  # [B, d]
        canvas = params["canvas_queries"][None] + cond[:, None, :].to(x.dtype)
        canvas = encoder(canvas, params["canvas_layers"], cfg.num_heads, cfg.layer_norm_eps, act)
        canvas = layer_norm(canvas, params["final_ln_w"], params["final_ln_b"],
                            cfg.layer_norm_eps)
        patches = (canvas @ params["patch_head"]).float()  # [B, N, patch_dim]
        g, p = cfg.image_size // cfg.patch_size, cfg.patch_size
        img = patches.reshape(B, g, g, p, p, 3).permute(0, 1, 3, 2, 4, 5)
        return torch.sigmoid(img.reshape(B, cfg.image_size, cfg.image_size, 3))


def image_to_png(img: np.ndarray) -> bytes:
    """[S, S, 3] float in [0, 1] → PNG bytes (the JAX head's quantization:
    clip, times 255, truncated to uint8)."""
    arr = (np.clip(np.asarray(img, np.float32), 0.0, 1.0) * 255).astype(np.uint8)
    return media_codec.encode_png(arr)
