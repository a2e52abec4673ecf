"""The PyTorch port stands alone: no module of ``agentfield_tpu_torch`` and
not ``chip_smoke.py`` imports JAX, the JAX package (its ``sdk``,
``control_plane`` and ``tracing`` included), the repo's tools, or aiohttp,
pydantic, safetensors, transformers, tokenizers, regex, websockets and
grpc, which the card's machine lacks, nor Pillow (``PIL``) or ml_dtypes,
which it lacks too (the checkpoint loader and the tokenizer read their
formats themselves; the channel speaks WebSocket over the standard library;
the node decodes and encodes PNG, JPEG and WAV with ``models.media_codec``
and ``wave``; the cluster tier's KV wire reads bf16 and fp8 leaves through
``torch.frombuffer``), nor optax, orbax or flax (the trainer steps with
``torch.optim`` and checkpoints in its own safetensors format; a JAX train
state or adapter comes across as numpy). jinja2 stays allowed: it comes with torch, and the
tokenizer imports it only when it renders a chat template.

The check is on the AST, by the exact top-level module name: a prefix test
on ``"agentfield_tpu"`` would also match ``agentfield_tpu_torch``."""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "agentfield_tpu", "tools", "aiohttp", "pydantic", "safetensors",
             "transformers", "tokenizers", "regex", "websockets", "grpc", "PIL", "ml_dtypes",
             "optax", "orbax", "flax"}


def _port_files() -> list[pathlib.Path]:
    return sorted((ROOT / "agentfield_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_tops(path: pathlib.Path) -> list[tuple[int, str]]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name.split(".")[0]) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append((node.lineno, node.module.split(".")[0]))
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, (ast.Name, ast.Attribute))
            and getattr(node.func, "id", getattr(node.func, "attr", None))
            in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            out.append((node.lineno, node.args[0].value.split(".")[0]))
    return out


def test_port_has_modules_to_scan():
    files = _port_files()
    assert len(files) > 10 and all(f.exists() for f in files)


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: str(p.relative_to(ROOT))
)
def test_no_jax_or_repo_tool_imports(path):
    bad = [(ln, top) for ln, top in _imported_tops(path) if top in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_matches_exact_top_level_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "import agentfield_tpu_torch.models\n"
        "from agentfield_tpu_torch import prefix_hash\n"
        "import jax.numpy as jnp\n"
        "from agentfield_tpu.models import llama\n"
        "from tools.perf import kernel_gate\n"
        "import importlib; importlib.import_module('jaxlib')\n"
    )
    tops = [t for _, t in _imported_tops(src)]
    assert [t for t in tops if t in FORBIDDEN] == ["jax", "agentfield_tpu", "tools", "jaxlib"]


def test_guard_names_the_jax_sdk_control_plane_tracing_and_their_libraries(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "from agentfield_tpu.sdk.client import ControlPlaneClient\n"
        "import agentfield_tpu.control_plane.gateway\n"
        "from agentfield_tpu import tracing\n"
        "import aiohttp.web\n"
        "from pydantic import BaseModel\n"
        "from agentfield_tpu_torch.sdk import client\n"
        "from agentfield_tpu_torch import tracing as port_tracing\n"
    )
    tops = [t for _, t in _imported_tops(src)]
    assert [t for t in tops if t in FORBIDDEN] == [
        "agentfield_tpu", "agentfield_tpu", "agentfield_tpu", "aiohttp", "pydantic"]


def test_guard_names_the_hf_libraries(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "from safetensors import safe_open\n"
        "from transformers import AutoTokenizer\n"
        "import tokenizers.pre_tokenizers\n"
        "import regex as re\n"
        "import jinja2\n"
        "from agentfield_tpu_torch.serving.tokenizer import HFTokenizer\n"
    )
    tops = [t for _, t in _imported_tops(src)]
    assert [t for t in tops if t in FORBIDDEN] == [
        "safetensors", "transformers", "tokenizers", "regex"]


def test_guard_names_the_channel_libraries(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "import websockets\n"
        "from websockets.sync.client import connect\n"
        "import grpc\n"
        "from grpc import aio\n"
        "from agentfield_tpu_torch.serving import websocket\n"
        "from agentfield_tpu_torch.serving.channel import ChannelServer\n"
    )
    tops = [t for _, t in _imported_tops(src)]
    assert [t for t in tops if t in FORBIDDEN] == ["websockets", "websockets", "grpc", "grpc"]


def test_guard_names_the_image_library(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "from PIL import Image\n"
        "import PIL.PngImagePlugin\n"
        "import importlib; importlib.import_module('PIL.JpegImagePlugin')\n"
        "import wave\n"
        "from agentfield_tpu_torch.models import media_codec\n"
    )
    tops = [t for _, t in _imported_tops(src)]
    assert [t for t in tops if t in FORBIDDEN] == ["PIL", "PIL", "PIL"]


def test_guard_names_the_kv_wire_libraries(tmp_path):
    """The cluster tier's modules (the prefix hash's sketch digests, the
    pool's adoption, the engine's wire payloads, the channel's relay) stay
    clear of JAX, the JAX package, aiohttp and ml_dtypes: checked by name,
    and each of those modules of the port scanned below."""
    src = tmp_path / "m.py"
    src.write_text(
        "import ml_dtypes\n"
        "from ml_dtypes import bfloat16\n"
        "from agentfield_tpu.prefix_hash import sketch_digest\n"
        "from agentfield_tpu.control_plane.channel import _pack_kv_blob\n"
        "from aiohttp import WSMsgType\n"
        "from agentfield_tpu_torch.prefix_hash import sketch_digest as port_digest\n"
        "from agentfield_tpu_torch.serving.channel import kv_blob_header\n"
    )
    tops = [t for _, t in _imported_tops(src)]
    assert [t for t in tops if t in FORBIDDEN] == [
        "ml_dtypes", "ml_dtypes", "agentfield_tpu", "agentfield_tpu", "aiohttp"]
    for rel in ("prefix_hash.py", "serving/kv_cache.py", "serving/engine.py",
                "serving/channel.py", "serving/model_node.py", "serving/websocket.py"):
        path = ROOT / "agentfield_tpu_torch" / rel
        assert path in _port_files()
        assert not [t for _, t in _imported_tops(path) if t in FORBIDDEN], rel


def test_port_modules_load_nothing_forbidden():
    """Import every module of the port and ``chip_smoke`` in a fresh
    interpreter: none of the forbidden packages ends up in ``sys.modules``."""
    mods = sorted(
        ".".join(f.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for f in (ROOT / "agentfield_tpu_torch").rglob("*.py")
    ) + ["chip_smoke"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = sorted({{n.split('.')[0] for n in sys.modules}} & set({sorted(FORBIDDEN)!r}))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env={"PATH": "/usr/bin:/bin",
                                                      "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]", out.stdout


def test_guard_names_the_training_libraries(tmp_path):
    """The training slice (``training/``, ``models/convert.py``'s state
    converters) imports none of optax, orbax or flax: checked by name, and
    those modules of the port scanned."""
    src = tmp_path / "m.py"
    src.write_text(
        "import optax\n"
        "import orbax.checkpoint as ocp\n"
        "from flax import linen\n"
        "from agentfield_tpu.training import lora\n"
        "from agentfield_tpu_torch.training import lora as port_lora\n"
        "import torch.optim\n"
    )
    tops = [t for _, t in _imported_tops(src)]
    assert [t for t in tops if t in FORBIDDEN] == ["optax", "orbax", "flax", "agentfield_tpu"]
    for rel in ("training/__init__.py", "training/trainer.py", "training/lora.py",
                "training/checkpoint.py", "training/optim.py", "models/convert.py"):
        path = ROOT / "agentfield_tpu_torch" / rel
        assert path in _port_files()
        assert not [t for _, t in _imported_tops(path) if t in FORBIDDEN], rel
