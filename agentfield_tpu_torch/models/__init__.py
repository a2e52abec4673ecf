"""Llama-family models in PyTorch (counterpart of ``agentfield_tpu.models``)."""

from agentfield_tpu_torch.models.configs import PRESETS, LlamaConfig, RopeScaling, get_config

__all__ = ["PRESETS", "LlamaConfig", "RopeScaling", "get_config"]
