"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/*.cu`` file, or each variant of it (``VARIANTS``: the attention
source once per head dim), is compiled by its own ``nvcc`` process (all
started together) into a shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC [-D...] -o _build/<name>[.<variant>]-<hash>.so csrc/<name>.cu

No PyTorch headers are included, so a build takes seconds, not the minutes
``torch.utils.cpp_extension`` would. Libraries land in
``agentfield_tpu_torch/_build/`` (git-ignored), named by a hash of the
source and flags, so an unchanged source is built once per checkout.
Nothing is prebuilt or downloaded; without ``nvcc`` the build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# Head dims of the port's presets (models/configs.py), each its own build of
# the attention source: six processes in parallel instead of one long one.
ATTENTION_HEAD_DIMS = (16, 32, 64, 96, 128, 256)
# source name -> {variant: extra nvcc flags}; a source not listed builds once
VARIANTS: dict[str, dict[str, tuple[str, ...]]] = {
    "ragged_paged_attention": {
        f"hd{hd}": (f"-DAFP_HEAD_DIM={hd}",) for hd in ATTENTION_HEAD_DIMS
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built from source at first use")


def _targets(src: Path) -> dict[str, tuple[str, ...]]:
    """Library name -> extra flags for every build of ``src``."""
    variants = VARIANTS.get(src.stem)
    if variants is None:
        return {src.stem: ()}
    return {f"{src.stem}.{v}": flags for v, flags in variants.items()}


def _lib_path(src: Path, name: str, flags: tuple[str, ...]) -> Path:
    key = src.read_bytes() + " ".join(NVCC_FLAGS + flags).encode()
    return BUILD_DIR / f"{name}-{hashlib.sha256(key).hexdigest()[:16]}.so"


def build_all(names: list[str] | None = None, verbose: bool = False) -> dict[str, Path]:
    """Compile the named libraries (default: every build of every
    ``csrc/*.cu``; a name is a source stem, or ``<stem>.<variant>`` for one
    of its ``VARIANTS``) that are not built yet, one ``nvcc`` per library,
    all in parallel. Returns library name -> path. Raises with the compiler
    output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}  # library name -> (source, flags, path)
    for src in sorted(CSRC_DIR.glob("*.cu")):
        for name, flags in _targets(src).items():
            if names is None or name in names or src.stem in names:
                jobs[name] = (src, flags, _lib_path(src, name, flags))
    todo = {n: j for n, j in jobs.items() if not j[2].exists()}
    if todo:
        nvcc = _nvcc()
        procs = []
        for name, (src, flags, path) in todo.items():
            tmp = path.with_suffix(f".{os.getpid()}.tmp.so")
            cmd = [nvcc, *NVCC_FLAGS, *flags, "-o", str(tmp), str(src)]
            if verbose:
                cmd[1:1] = ["-Xptxas", "-v"]
            procs.append((name, tmp, path, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        errors = []
        for name, tmp, path, p in procs:
            log, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"nvcc failed on {name} (rc {p.returncode}):\n{log}")
                continue
            if verbose and log:
                print(log)
            os.replace(tmp, path)
        if errors:
            raise RuntimeError("\n".join(errors))
    return {n: j[2] for n, j in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (a source stem, or ``<stem>.<variant>``),
    building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib
