"""Serving stack in PyTorch (counterpart of ``agentfield_tpu.serving``):
paged KV cache, sampler, grammar-constrained decoding, continuous-batching
engine with its graph-captured decode step, and the model node.
Import the submodules directly; nothing is imported here."""
