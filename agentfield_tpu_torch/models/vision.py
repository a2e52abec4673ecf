"""Vision tower: a ViT patch encoder and projector for multimodal prompts —
counterpart of ``agentfield_tpu/models/vision.py``.

Images in ``[0, 1]`` become LLM-space embeddings that the serving engine
injects at the placeholder positions of a prompt (LLaVA-style early fusion,
``llama.forward(embeds_override=...)``). The parameter layout is the JAX
package's (stacked ``[L, in, out]`` layer leaves), so
``models.convert.tower_params_from_numpy`` carries JAX weights across as
they are. Patchify is a reshape, the encoder a loop over the stacked layers;
its bidirectional attention takes float32 scores and softmax, as the JAX
einsums compute them (``preferred_element_type=float32``). ``jax.nn.gelu``
defaults to the tanh form, so the projector and ``gelu_tanh`` use
``approximate="tanh"``; ``jnp.var`` is the population variance.

``load_clip_vision`` reads a Hugging Face CLIP or SigLIP vision checkpoint
through the port's own safetensors reader (``models.hf_loader``).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any

import torch
import torch.nn.functional as F

from agentfield_tpu_torch.models.llama import resolve_dtype

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 12
    num_heads: int = 16
    mlp_ratio: int = 4
    out_dim: int = 2048  # LLM hidden size the projector maps into
    layer_norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    class_token: bool = False  # CLIP prepends a learned CLS token (it attends,
    # so patch outputs depend on it); the features are the patch positions
    pre_ln: bool = False  # CLIP's pre_layrnorm on the embeddings
    final_ln: bool = True  # CLIP's last_hidden_state has no final LN, SigLIP's has
    act: str = "gelu_tanh"  # "gelu_tanh" (SigLIP) | "quick_gelu" (OpenAI CLIP) | "gelu_exact"
    pixel_mean: tuple[float, float, float] | None = None  # applied inside the
    # tower: callers send [0, 1] pixels
    pixel_std: tuple[float, float, float] | None = None

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + (1 if self.class_token else 0)

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * 3


CONFIGS = {
    "vit-base-224": VisionConfig(),
    # test tower: out_dim is llama-tiny's hidden size
    "vit-tiny": VisionConfig(
        image_size=32, patch_size=8, hidden_size=64, num_layers=2,
        num_heads=4, out_dim=128,
    ),
}


def get_vision_config(name: str) -> VisionConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown vision config {name!r}; have {sorted(CONFIGS)}")
    return CONFIGS[name]


def normal_init(g: torch.Generator, dt: torch.dtype, device):
    """``norm(*shape)``: std-0.02 normal values drawn from ``g`` in ``dt``."""
    def norm(*shape, scale: float = 0.02) -> torch.Tensor:
        return torch.empty(shape, dtype=dt, device=device).normal_(0.0, scale, generator=g)
    return norm


def init_encoder_layers(norm, L: int, d: int, f: int, dt, device) -> Params:
    """The stacked layer leaves of a pre-LN encoder (ones/zeros norms and
    biases, random projections)."""
    def full(v, *shape):
        return torch.full(shape, v, dtype=dt, device=device)

    return {
        "ln1_w": full(1.0, L, d), "ln1_b": full(0.0, L, d),
        "ln2_w": full(1.0, L, d), "ln2_b": full(0.0, L, d),
        "wqkv": norm(L, d, 3 * d), "bqkv": full(0.0, L, 3 * d),
        "wo": norm(L, d, d), "bo": full(0.0, L, d),
        "w1": norm(L, d, f), "b1": full(0.0, L, f),
        "w2": norm(L, f, d), "b2": full(0.0, L, d),
    }


def init_vision_params(cfg: VisionConfig, seed: int = 0, device="cuda") -> Params:
    """Random weights drawn from a ``torch.Generator`` seeded with ``seed``,
    on ``device`` in ``cfg.dtype`` (values differ from the JAX package's)."""
    dt = resolve_dtype(cfg.dtype)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    norm = normal_init(g, dt, device)
    d = cfg.hidden_size
    out: Params = {
        "patch_embed": norm(cfg.patch_dim, d),
        "pos_embed": norm(cfg.seq_len, d),
        "layers": init_encoder_layers(norm, cfg.num_layers, d, d * cfg.mlp_ratio, dt, device),
        "final_ln_w": torch.ones(d, dtype=dt, device=device),
        "final_ln_b": torch.zeros(d, dtype=dt, device=device),
        "proj_w1": norm(d, cfg.out_dim),
        "proj_w2": norm(cfg.out_dim, cfg.out_dim),
    }
    if cfg.class_token:
        out["class_embed"] = norm(d)
    if cfg.pre_ln:
        out["pre_ln_w"] = torch.ones(d, dtype=dt, device=device)
        out["pre_ln_b"] = torch.zeros(d, dtype=dt, device=device)
    return out


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """The JAX towers' layer norm: statistics in float32 (population
    variance), normalized back in x's dtype, then scale and shift."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def patchify(images: torch.Tensor, cfg: VisionConfig) -> torch.Tensor:
    """[B, H, W, 3] → [B, num_patches, patch_dim]: a reshape, each patch
    flattened as [p_row, p_col, channel]."""
    B = images.shape[0]
    g, p = cfg.image_size // cfg.patch_size, cfg.patch_size
    x = images.reshape(B, g, p, g, p, 3)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, g * g, cfg.patch_dim)


def act_fn(name: str):
    if name == "quick_gelu":  # OpenAI CLIP: x * sigmoid(1.702 x)
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu_exact":
        return F.gelu
    if name == "gelu_tanh":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown act {name!r} (gelu_tanh | quick_gelu | gelu_exact)")


def with_biases(layers: Params, d: int) -> Params:
    """Layers saved before the encoders had biases get zero ones."""
    if "bqkv" in layers:
        return layers
    w = layers["wqkv"]
    L, f = w.shape[0], layers["w1"].shape[-1]

    def z(*shape):
        return torch.zeros(shape, dtype=w.dtype, device=w.device)

    return {**layers, "bqkv": z(L, 3 * d), "bo": z(L, d), "b1": z(L, f), "b2": z(L, d)}


def encoder(x: torch.Tensor, layers: Params, num_heads: int, eps: float, act) -> torch.Tensor:
    """Bidirectional pre-LN transformer over [B, N, d], one layer of the
    stacked leaves at a time; attention scores and softmax in float32."""
    B, N, d = x.shape
    hd = d // num_heads
    layers = with_biases(layers, d)
    for i in range(layers["wqkv"].shape[0]):
        lp = {k: v[i] for k, v in layers.items()}
        h = layer_norm(x, lp["ln1_w"], lp["ln1_b"], eps)
        qkv = (h @ lp["wqkv"] + lp["bqkv"]).reshape(B, N, 3, num_heads, hd)
        q, k, v = (qkv[:, :, j].transpose(1, 2).float() for j in range(3))  # [B, H, N, hd]
        probs = torch.softmax((q @ k.transpose(-1, -2)) * (hd ** -0.5), dim=-1)
        attn = (probs @ v).transpose(1, 2).reshape(B, N, d).to(x.dtype)
        x = x + (attn @ lp["wo"] + lp["bo"])
        h = layer_norm(x, lp["ln2_w"], lp["ln2_b"], eps)
        up = act((h @ lp["w1"] + lp["b1"]).float()).to(x.dtype)
        x = x + (up @ lp["w2"] + lp["b2"])
    return x


def project(params: Params, x: torch.Tensor) -> torch.Tensor:
    """The two-layer projector into LLM space (tanh GELU, as ``jax.nn.gelu``)."""
    h = F.gelu((x @ params["proj_w1"]).float(), approximate="tanh").to(x.dtype)
    return h @ params["proj_w2"]


def vision_hidden(params: Params, cfg: VisionConfig, images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] float in [0, 1] → [B, num_patches, hidden] encoder
    states at the patch positions (pre-projector): a CLIP checkpoint's
    ``last_hidden_state[:, 1:]``, a SigLIP one's whole ``last_hidden_state``."""
    dt = resolve_dtype(cfg.dtype)
    if cfg.pixel_mean is not None:
        mean = torch.tensor(cfg.pixel_mean, dtype=torch.float32, device=images.device)
        std = torch.tensor(cfg.pixel_std or (1.0, 1.0, 1.0), dtype=torch.float32,
                           device=images.device)
        images = (images.float() - mean) / std
    x = patchify(images.to(dt), cfg) @ params["patch_embed"]
    if "patch_bias" in params:  # SigLIP's conv stem carries a bias
        x = x + params["patch_bias"]
    B = x.shape[0]
    if cfg.class_token:
        cls = params["class_embed"].to(x.dtype).expand(B, 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"]
    if cfg.pre_ln:
        x = layer_norm(x, params["pre_ln_w"], params["pre_ln_b"], cfg.layer_norm_eps)
    x = encoder(x, params["layers"], cfg.num_heads, cfg.layer_norm_eps, act_fn(cfg.act))
    if cfg.final_ln:
        x = layer_norm(x, params["final_ln_w"], params["final_ln_b"], cfg.layer_norm_eps)
    if cfg.class_token:
        x = x[:, 1:]
    return x


def vision_encode(params: Params, cfg: VisionConfig, images: torch.Tensor) -> torch.Tensor:
    """images [B, image_size, image_size, 3] float32 in [0, 1] →
    [B, num_patches, out_dim] LLM-space embeddings in the tower dtype."""
    with torch.inference_mode():
        return project(params, vision_hidden(params, cfg, images))


def load_clip_vision(path: str, out_dim: int = 2048, dtype: str = "float32", seed: int = 0,
                     device="cuda") -> tuple[VisionConfig, Params]:
    """A Hugging Face CLIP or SigLIP vision checkpoint directory →
    ``(VisionConfig, params)`` on ``device`` in ``dtype``, as the JAX
    ``load_clip_vision`` maps it: the flavour from ``model_type`` (else
    from the tensors), CLIP with CLS, pre-LN, quick_gelu and no final LN,
    SigLIP with a biased conv stem, tanh GELU and its post-LN; the conv
    patch kernel refolded into the patchify matmul; the processor's mean
    and std from ``preprocessor_config.json`` when present. The projector
    stays random, drawn from ``seed``."""
    from agentfield_tpu_torch.models.hf_loader import open_checkpoint

    p = Path(path)
    doc = json.loads((p / "config.json").read_text())
    vc = doc.get("vision_config", doc)  # CLIPConfig nests, CLIPVisionConfig is flat
    d = int(vc["hidden_size"])
    handles = open_checkpoint(p)
    names = {n.split("vision_model.", 1)[1]: n for n in handles if "vision_model." in n}
    if not names:
        raise KeyError(f"no vision_model tensors in {p} (not a CLIP/SigLIP checkpoint?)")
    mt = vc.get("model_type") or doc.get("model_type") or ""
    if "siglip" in mt:
        siglip = True
    elif "clip" in mt:
        siglip = False
    elif "pre_layrnorm.weight" in names:
        siglip = False
    elif "embeddings.patch_embedding.bias" in names:
        siglip = True
    else:
        raise ValueError(
            f"unrecognized vision checkpoint flavor (model_type={mt!r}; expected CLIP or SigLIP)")
    act_name = vc.get("hidden_act", "gelu_pytorch_tanh" if siglip else "quick_gelu")
    act = {"quick_gelu": "quick_gelu", "gelu": "gelu_exact",
           "gelu_pytorch_tanh": "gelu_tanh"}.get(act_name)
    if act is None:
        raise ValueError(f"unsupported vision hidden_act={act_name!r}")
    mean = (0.5, 0.5, 0.5) if siglip else (0.48145466, 0.4578275, 0.40821073)
    std = (0.5, 0.5, 0.5) if siglip else (0.26862954, 0.26130258, 0.27577711)
    prep = p / "preprocessor_config.json"
    if prep.exists():
        pdoc = json.loads(prep.read_text())
        mean = tuple(pdoc.get("image_mean", mean))
        std = tuple(pdoc.get("image_std", std))
    cfg = VisionConfig(
        image_size=int(vc["image_size"]), patch_size=int(vc["patch_size"]), hidden_size=d,
        num_layers=int(vc["num_hidden_layers"]), num_heads=int(vc["num_attention_heads"]),
        mlp_ratio=int(vc["intermediate_size"]) // d, out_dim=out_dim,
        layer_norm_eps=float(vc.get("layer_norm_eps", 1e-6 if siglip else 1e-5)),
        dtype=dtype, class_token=not siglip, pre_ln=not siglip, final_ln=siglip, act=act,
        pixel_mean=mean, pixel_std=std,
    )
    dt = resolve_dtype(dtype)

    def get(name: str) -> torch.Tensor:
        if name not in names:
            raise KeyError(f"missing vision tensor {name!r}")
        return handles[names[name]].get(names[name]).to(device=device, dtype=dt, copy=True)

    def stack(fmt: str, transpose: bool = True) -> torch.Tensor:
        return torch.stack([get(fmt.format(i)).T if transpose else get(fmt.format(i))
                            for i in range(cfg.num_layers)]).contiguous()

    pre = "encoder.layers.{}."
    layers = {
        "ln1_w": stack(pre + "layer_norm1.weight", False),
        "ln1_b": stack(pre + "layer_norm1.bias", False),
        "ln2_w": stack(pre + "layer_norm2.weight", False),
        "ln2_b": stack(pre + "layer_norm2.bias", False),
        "wqkv": torch.cat([stack(pre + f"self_attn.{n}_proj.weight") for n in "qkv"], dim=2),
        "bqkv": torch.cat([stack(pre + f"self_attn.{n}_proj.bias", False) for n in "qkv"],
                          dim=1),
        "wo": stack(pre + "self_attn.out_proj.weight"),
        "bo": stack(pre + "self_attn.out_proj.bias", False),
        "w1": stack(pre + "mlp.fc1.weight"), "b1": stack(pre + "mlp.fc1.bias", False),
        "w2": stack(pre + "mlp.fc2.weight"), "b2": stack(pre + "mlp.fc2.bias", False),
    }
    # conv patch kernel [d, 3, p, p] → [p, p, 3, d] → patchify's [patch_dim, d]
    conv = get("embeddings.patch_embedding.weight")
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    norm = normal_init(g, dt, device)
    params: Params = {
        "patch_embed": conv.permute(2, 3, 1, 0).reshape(cfg.patch_dim, d).contiguous(),
        "pos_embed": get("embeddings.position_embedding.weight"),
        "layers": layers,
        "proj_w1": norm(d, out_dim),
        "proj_w2": norm(out_dim, out_dim),
    }
    if siglip:
        params["patch_bias"] = get("embeddings.patch_embedding.bias")
        params["final_ln_w"] = get("post_layernorm.weight")
        params["final_ln_b"] = get("post_layernorm.bias")
    else:
        params["class_embed"] = get("embeddings.class_embedding")
        params["pre_ln_w"] = get("pre_layrnorm.weight")
        params["pre_ln_b"] = get("pre_layrnorm.bias")
        params["final_ln_w"] = torch.ones(d, dtype=dt, device=device)  # unused (final_ln=False)
        params["final_ln_b"] = torch.zeros(d, dtype=dt, device=device)
    for h in set(handles.values()):
        h.close()
    return cfg, params
