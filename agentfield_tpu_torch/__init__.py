"""agentfield_tpu_torch — the PyTorch/CUDA port of agentfield_tpu's
model-serving data plane, for one NVIDIA H100.

The JAX package (``agentfield_tpu``) stays the reference. This package
mirrors its layout (``models/``, ``ops/``, ``serving/``) so each module has an
obvious counterpart, imports nothing of it, and replaces its Pallas TPU
kernel with a hand-written CUDA kernel for ``sm_90a`` (``csrc/``, built at
first use by ``ops/cuda/build.py``). Every kernel keeps a plain PyTorch
version beside it: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel or raises.

Entry points default to ``device="cuda"``; pass ``device="cpu"`` to run the
plain versions (the tests do).
"""

__version__ = "0.1.0"  # the JAX package's, as the CLI's `version` prints it
