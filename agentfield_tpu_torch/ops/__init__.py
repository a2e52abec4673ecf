"""Attention ops (counterpart of ``agentfield_tpu.ops``): the ragged paged
attention dispatcher and its plain version; the CUDA kernel lives under
``ops/cuda``."""
