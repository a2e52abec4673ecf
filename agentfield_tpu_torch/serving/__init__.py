"""Serving stack in PyTorch (counterpart of ``agentfield_tpu.serving``):
paged KV cache, sampler, continuous-batching engine and the model node.
Import the submodules directly; nothing is imported here."""
