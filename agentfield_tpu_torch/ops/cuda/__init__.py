"""Hand-written CUDA kernels for Hopper (sources in ``agentfield_tpu_torch/
csrc/``), their ctypes bindings and their launch counters. Nothing here
builds or loads a kernel at import time."""
