"""Model configuration presets for the Llama family — the port's own copy
of ``agentfield_tpu/models/configs.py`` (field for field; the parity test
holds every preset equal to the JAX package's)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Llama-3.1/3.2-style RoPE frequency rescaling (HF ``rope_scaling`` with
    ``rope_type="llama3"``). Wavelengths past ``original_max_position_embeddings
    / low_freq_factor`` are divided by ``factor``; a smooth ramp interpolates
    between the high- and low-frequency cutoffs."""

    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500_000.0
    rope_scaling: RopeScaling | None = None  # llama3-style frequency rescaling
    rms_norm_eps: float = 1e-5
    max_seq_len: int = 8192
    tie_embeddings: bool = False
    attn_bias: bool = False  # Qwen2-style QKV projection biases
    mlp_act: str = "silu"  # gate activation: "silu" (llama) | "gelu"
    # (gemma's gelu_pytorch_tanh)
    norm_offset: bool = False  # gemma RMSNorm computes x*(1+w). Convention:
    # params store RUNTIME weights (hf_loader adds the 1.0 at load), so the
    # forward stays one code path
    scale_embeddings: bool = False  # gemma multiplies token embeddings by
    # sqrt(hidden_size) after lookup (unembed uses the RAW tied table)
    sliding_window: int | None = None  # Mistral/Qwen2/Phi-3-style windowed
    # attention: each query attends the most recent `sliding_window` keys
    # only. Served EVERYWHERE: ref paths, the pallas kernels (flash / paged
    # decode / paged chunk — window applied in-kernel with block/page
    # skipping, so a bound window reads O(window) K/V), and ring attention
    # (whole-block skips over the traveling positions)
    num_experts: int = 0  # >0 → Mixtral-style MoE FFN: per-layer router
    # [d, E] + expert-stacked gate/up/down [E, ...]; top-k routing with
    # softmax over the selected experts' logits
    num_experts_per_tok: int = 2
    moe_impl: str = "dense"  # MoE FFN formulation: "dense" soft-routes every
    # expert (exact — the oracle); "sparse" runs capacity-based top-k
    # dispatch (FLOPs ∝ top_k; over-capacity tokens lose that expert's
    # contribution). Serving flips this on its PREFILL cfg only
    # (EngineConfig.moe_prefill_impl) — prefill is compute-bound, decode is
    # weight-bound so dense-mix costs the same HBM there.
    moe_capacity_factor: float = 2.0  # sparse dispatch headroom: per-expert
    # capacity = ceil(tokens * top_k / num_experts * factor)
    # dtype name, resolved lazily so configs stay hashable / serializable
    dtype: str = "bfloat16"

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def num_params(self) -> int:
        """Approximate parameter count (for memory planning)."""
        d, f, v = self.hidden_size, self.intermediate_size, self.vocab_size
        if self.num_experts > 0:
            mlp = d * self.num_experts + 3 * d * f * self.num_experts
        else:
            mlp = 3 * d * f
        per_layer = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d + mlp + 2 * d
        if self.attn_bias:
            per_layer += self.q_dim + 2 * self.kv_dim
        embed = v * d * (1 if self.tie_embeddings else 2)
        return self.num_layers * per_layer + embed + d


PRESETS: dict[str, LlamaConfig] = {
    # Tiny config for unit tests — MXU-aligned dims, trivially fast on CPU.
    # hermetic speculative-decoding draft: llama-tiny's vocab, quarter the
    # width — pairs with llama-tiny in engine tests (spec_k / draft-verify)
    "llama-nano": LlamaConfig(
        vocab_size=512,
        hidden_size=64,
        intermediate_size=128,
        num_layers=1,
        num_heads=2,
        num_kv_heads=1,
        head_dim=32,
        max_seq_len=256,
    ),
    # draft-scale model sharing the Llama-3 vocabulary: the speculative
    # decoding companion for the 1B/8B targets (random-init until a trained
    # draft checkpoint is pointed at via spec_draft=<dir>)
    "llama-3.2-draft": LlamaConfig(
        vocab_size=128256,
        hidden_size=512,
        intermediate_size=2048,
        num_layers=4,
        num_heads=8,
        num_kv_heads=2,
        head_dim=64,
        tie_embeddings=True,
        max_seq_len=8192,
    ),
    "llama-tiny": LlamaConfig(
        vocab_size=512,
        hidden_size=128,
        intermediate_size=256,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        max_seq_len=256,
        dtype="float32",
    ),
    # llama-3-70b's GQA shape in miniature (8 KV heads, group size 8): the
    # TP=8 serving-validation config — 1 KV head per device, exactly the
    # north-star config-5 carve (BASELINE.md) where KV-page layout bugs live.
    "llama-tiny-tp8": LlamaConfig(
        vocab_size=512,
        hidden_size=128,
        intermediate_size=256,
        num_layers=2,
        num_heads=64,
        num_kv_heads=8,
        head_dim=16,
        max_seq_len=256,
        dtype="float32",
    ),
    # A mid-size config for single-chip smoke benches (~0.3B).
    "llama-smoke": LlamaConfig(
        vocab_size=32768,
        hidden_size=1024,
        intermediate_size=4096,
        num_layers=8,
        num_heads=16,
        num_kv_heads=8,
        head_dim=64,
        max_seq_len=4096,
    ),
    # Llama 3.2 1B (north-star config 1: greeting-agent smoke model).
    "llama-3.2-1b": LlamaConfig(
        vocab_size=128256,
        hidden_size=2048,
        intermediate_size=8192,
        num_layers=16,
        num_heads=32,
        num_kv_heads=8,
        head_dim=64,
        tie_embeddings=True,
        max_seq_len=8192,
        # HF meta-llama/Llama-3.2-1B config.json rope_scaling (rope_type=llama3)
        rope_scaling=RopeScaling(
            factor=32.0,
            low_freq_factor=1.0,
            high_freq_factor=4.0,
            original_max_position_embeddings=8192,
        ),
    ),
    # Llama 3 8B (primary north-star model).
    "llama-3-8b": LlamaConfig(
        vocab_size=128256,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        max_seq_len=8192,
    ),
    # Mistral-7B: same decoder family (GQA, rotate-half RoPE, SwiGLU) —
    # served by the identical code path.
    "mistral-7b": LlamaConfig(
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=10000.0,
        max_seq_len=32768,
        sliding_window=4096,  # Mistral-7B-v0.1 windowed attention
    ),
    # Gemma (v1): GeGLU MLP, RMSNorm x*(1+w), sqrt(d)-scaled embeddings,
    # MQA (2B) / MHA (7B), 256-wide heads, tied embeddings.
    "gemma-2b": LlamaConfig(
        vocab_size=256000,
        hidden_size=2048,
        intermediate_size=16384,
        num_layers=18,
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        rope_theta=10000.0,
        rms_norm_eps=1e-6,
        max_seq_len=8192,
        tie_embeddings=True,
        mlp_act="gelu",
        norm_offset=True,
        scale_embeddings=True,
    ),
    "gemma-7b": LlamaConfig(
        vocab_size=256000,
        hidden_size=3072,
        intermediate_size=24576,
        num_layers=28,
        num_heads=16,
        num_kv_heads=16,
        head_dim=256,
        rope_theta=10000.0,
        rms_norm_eps=1e-6,
        max_seq_len=8192,
        tie_embeddings=True,
        mlp_act="gelu",
        norm_offset=True,
        scale_embeddings=True,
    ),
    # hermetic gemma-shaped test config (all three gemma behaviors on)
    "gemma-tiny": LlamaConfig(
        vocab_size=512,
        hidden_size=128,
        intermediate_size=256,
        num_layers=2,
        num_heads=4,
        num_kv_heads=1,
        head_dim=32,
        rms_norm_eps=1e-6,
        max_seq_len=256,
        tie_embeddings=True,
        mlp_act="gelu",
        norm_offset=True,
        scale_embeddings=True,
    ),
    # Mixtral: Llama architecture with a top-2-of-8 MoE FFN per layer.
    "mixtral-8x7b": LlamaConfig(
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=1_000_000.0,
        max_seq_len=32768,
        num_experts=8,
        num_experts_per_tok=2,
    ),
    # hermetic MoE test config (4 experts, top-2)
    "mixtral-tiny": LlamaConfig(
        vocab_size=512,
        hidden_size=128,
        intermediate_size=256,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        max_seq_len=256,
        num_experts=4,
        num_experts_per_tok=2,
    ),
    # microsoft/Phi-3-mini-4k-instruct: llama architecture with fused
    # qkv/gate_up projections in the checkpoint (split at load,
    # hf_loader.py), MHA (32 q = 32 kv heads), vocab 32064, and a
    # 2047-token sliding window (its config.json carries it)
    "phi-3-mini": LlamaConfig(
        vocab_size=32064,
        hidden_size=3072,
        intermediate_size=8192,
        num_layers=32,
        num_heads=32,
        num_kv_heads=32,
        head_dim=96,
        rope_theta=10000.0,
        rms_norm_eps=1e-5,
        max_seq_len=4096,
        sliding_window=2047,
    ),
    # Qwen2-7B: adds QKV projection biases (attn_bias).
    "qwen2-7b": LlamaConfig(
        vocab_size=152064,
        hidden_size=3584,
        intermediate_size=18944,
        num_layers=28,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        rope_theta=1_000_000.0,
        rms_norm_eps=1e-6,
        max_seq_len=32768,
        attn_bias=True,
    ),
    # Llama 3 70B (TP=8 over ICI, north-star config 5).
    "llama-3-70b": LlamaConfig(
        vocab_size=128256,
        hidden_size=8192,
        intermediate_size=28672,
        num_layers=80,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        max_seq_len=8192,
    ),
}


def get_config(name: str) -> LlamaConfig:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown model config {name!r}; known: {sorted(PRESETS)}") from None
