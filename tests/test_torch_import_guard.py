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
state or adapter comes across as numpy), nor PyYAML (``yaml``) or jsonschema
(the SDK validates structured output, and the CLI reads its config files,
with its own code), nor cryptography (the identity layer signs, derives and
seals with ``control_plane/crypto.py``), nor protobuf's runtime (``google``),
h2, hpack or a Postgres driver (psycopg, psycopg2, asyncpg): gRPC rides the
port's own HTTP/2, HPACK and protobuf codecs (``control_plane/grpc_h2.py``,
``hpack_codec.py``, ``proto/``), Postgres its own wire client
(``control_plane/pgwire.py``). jinja2 stays allowed: it comes with torch, and the
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
             "optax", "orbax", "flax", "yaml", "jsonschema", "cryptography",
             "google", "h2", "hpack", "psycopg", "psycopg2", "asyncpg"}
# ``google`` is a namespace package that this interpreter's site hooks load
# at start-up: a loaded-module check looks for protobuf's runtime itself
LOADED_FORBIDDEN = sorted(FORBIDDEN - {"google"})


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
        f"bad = sorted({{n.split('.')[0] for n in sys.modules}} & set({LOADED_FORBIDDEN!r}))\n"
        "bad += sorted(n for n in sys.modules if n.startswith('google.protobuf'))\n"
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


def test_scan_covers_the_parallel_package_and_its_test_helper():
    """The tensor-parallel modules are scanned, and the helper module the
    spawned ranks import (``tests/helpers_torch_tp.py``) imports no JAX
    either: a rank's fresh interpreter loads torch and the port only."""
    files = {str(p.relative_to(ROOT)) for p in _port_files()}
    for name in ("__init__", "mesh", "sharding", "worker"):
        assert f"agentfield_tpu_torch/parallel/{name}.py" in files
    helper = ROOT / "tests" / "helpers_torch_tp.py"
    assert not [t for _, t in _imported_tops(helper) if t in FORBIDDEN]


CONTROL_PLANE = ("__init__", "__main__", "admin_grpc", "channel", "crypto", "dag", "dashboard",
                 "events", "faults", "gateway", "grpc_h2", "health", "hpack_codec", "http",
                 "identity", "mcp_service", "metrics", "payloads", "pgwire", "registry",
                 "server", "storage", "storage_pg", "types", "ui_service", "webhooks")
PROTO = ("__init__", "admin_pb2", "modelnode_pb2", "wire")


def _control_plane_offences(cp_dir: pathlib.Path) -> dict[str, list]:
    """Per module of a control-plane directory: imports that are neither the
    standard library, numpy nor the port (a forbidden name among them)."""
    allowed = set(sys.stdlib_module_names) | {"numpy", "agentfield_tpu_torch"}
    out = {}
    for path in sorted(cp_dir.glob("*.py")):
        bad = [(ln, top) for ln, top in _imported_tops(path)
               if top not in allowed or top in FORBIDDEN]
        if bad:
            out[path.stem] = bad
    return out


def test_scan_covers_the_control_plane_and_it_imports_only_stdlib_numpy_and_the_port():
    """The port's control plane (``agentfield_tpu_torch/control_plane/``) is
    scanned module by module: each imports the standard library, numpy and
    the port only (no aiohttp, pydantic or grpc: ``http.py`` is its HTTP)."""
    files = {str(p.relative_to(ROOT)) for p in _port_files()}
    cp_dir = ROOT / "agentfield_tpu_torch" / "control_plane"
    assert {p.stem for p in cp_dir.glob("*.py")} == set(CONTROL_PLANE)
    for name in CONTROL_PLANE:
        assert f"agentfield_tpu_torch/control_plane/{name}.py" in files
    assert _control_plane_offences(cp_dir) == {}
    assert {p.stem for p in (cp_dir / "proto").glob("*.py")} == set(PROTO)
    for name in PROTO:
        assert f"agentfield_tpu_torch/control_plane/proto/{name}.py" in files
    assert _control_plane_offences(cp_dir / "proto") == {}


def test_control_plane_scan_fails_on_a_planted_aiohttp_import(tmp_path):
    """A scratch copy of the control plane with ``import aiohttp`` planted
    in the gateway (and a lazy ``from grpc import aio`` in the server) is
    caught: the scan above would fail on it."""
    import shutil

    cp_copy = tmp_path / "control_plane"
    shutil.copytree(ROOT / "agentfield_tpu_torch" / "control_plane", cp_copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    gw = cp_copy / "gateway.py"
    gw.write_text(gw.read_text() + "\nimport aiohttp\n")
    srv = cp_copy / "server.py"
    srv.write_text(srv.read_text() + "\n\ndef _late():\n    from grpc import aio\n")
    bad = _control_plane_offences(cp_copy)
    assert set(bad) == {"gateway", "server"}, bad
    assert [t for _, t in bad["gateway"]] == ["aiohttp"]
    assert [t for _, t in bad["server"]] == ["grpc"]


SDK_CLI = {"sdk": ("__init__", "agent", "client", "context", "mcp", "memory_events",
                   "multimodal", "node_client", "result_cache", "structured"),
           "cli": ("__init__", "__main__", "main", "packages")}


def test_guard_names_the_sdk_libraries(tmp_path):
    """PyYAML and jsonschema, which the JAX SDK and CLI use and the card's
    machine lacks, are named by the guard."""
    src = tmp_path / "m.py"
    src.write_text(
        "import yaml\n"
        "from jsonschema import validate\n"
        "import jsonschema.exceptions\n"
        "from agentfield_tpu.sdk.agent import Agent\n"
        "from agentfield_tpu_torch.sdk import Agent as PortAgent\n"
        "from agentfield_tpu_torch.config import load_yaml\n"
    )
    tops = [t for _, t in _imported_tops(src)]
    assert [t for t in tops if t in FORBIDDEN] == [
        "yaml", "jsonschema", "jsonschema", "agentfield_tpu"]


def test_scan_covers_the_sdk_cli_and_config_and_they_import_only_stdlib_numpy_and_the_port():
    """``sdk/``, ``cli/`` and ``config.py`` are scanned module by module:
    each imports the standard library, numpy and the port only (torch too
    only through the port: the CLI asks ``serving.model_node`` for the
    card)."""
    files = {str(p.relative_to(ROOT)) for p in _port_files()}
    pkg = ROOT / "agentfield_tpu_torch"
    for sub, names in SDK_CLI.items():
        assert {p.stem for p in (pkg / sub).glob("*.py")} == set(names), sub
        for name in names:
            assert f"agentfield_tpu_torch/{sub}/{name}.py" in files
        assert _control_plane_offences(pkg / sub) == {}, sub
    assert "agentfield_tpu_torch/config.py" in files
    allowed = set(sys.stdlib_module_names) | {"numpy", "agentfield_tpu_torch"}
    assert [t for _, t in _imported_tops(pkg / "config.py") if t not in allowed] == []


def test_the_sdk_imports_without_the_jax_libraries():
    """``from agentfield_tpu_torch.sdk import Agent`` in a fresh interpreter
    where aiohttp, pydantic, PyYAML, jsonschema and cryptography cannot be
    imported; the identity layer derives a DID there."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('aiohttp', 'pydantic', 'yaml', 'jsonschema',\n"
        "                                  'cryptography'):\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "from agentfield_tpu_torch.sdk import Agent, AgentRouter, AIConfig, ControlPlaneClient\n"
        "from agentfield_tpu_torch.cli.main import build_parser\n"
        "from agentfield_tpu_torch.config import load_config\n"
        "from agentfield_tpu_torch.control_plane.identity import DIDService\n"
        "from agentfield_tpu_torch.sdk.mcp import MCPManager\n"
        "assert DIDService(bytes(32)).org_did.startswith('did:key:z')\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env={"PATH": "/usr/bin:/bin",
                                                      "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_guard_names_the_crypto_library_and_the_identity_modules_use_none(tmp_path):
    """cryptography, which the JAX identity layer imports and the card's
    machine lacks, is named by the guard; the port's identity modules
    (``crypto.py``, ``identity.py``), its MCP modules (``mcp_service.py``,
    ``sdk/mcp.py``), ``ui_service.py`` and ``dashboard.py`` import the
    standard library, numpy and the port only."""
    src = tmp_path / "m.py"
    src.write_text(
        "from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey\n"
        "import cryptography.exceptions\n"
        "from agentfield_tpu.control_plane.identity import VCService\n"
        "from agentfield_tpu_torch.control_plane.crypto import AESGCM\n"
        "import hashlib, hmac\n"
    )
    tops = [t for _, t in _imported_tops(src)]
    assert [t for t in tops if t in FORBIDDEN] == ["cryptography", "cryptography", "agentfield_tpu"]
    allowed = set(sys.stdlib_module_names) | {"numpy", "agentfield_tpu_torch"}
    pkg = ROOT / "agentfield_tpu_torch"
    for rel in ("control_plane/crypto.py", "control_plane/identity.py",
                "control_plane/mcp_service.py", "control_plane/ui_service.py",
                "control_plane/dashboard.py", "sdk/mcp.py", "sdk/memory_events.py"):
        assert pkg / rel in _port_files(), rel
        assert [t for _, t in _imported_tops(pkg / rel)
                if t not in allowed or t in FORBIDDEN] == [], rel


def test_guard_names_the_grpc_and_postgres_libraries(tmp_path):
    """protobuf's runtime, h2, hpack and the Postgres drivers, which the
    JAX services import or could, and the card's machine lacks, are named by
    the guard; the port's gRPC and Postgres modules import the standard
    library and the port only."""
    src = tmp_path / "m.py"
    src.write_text(
        "from google.protobuf import descriptor_pool\n"
        "import h2.connection\n"
        "from hpack import Decoder\n"
        "import psycopg\n"
        "import psycopg2.extras\n"
        "import asyncpg\n"
        "import grpc\n"
        "from agentfield_tpu.control_plane.proto import admin_pb2\n"
        "from agentfield_tpu_torch.control_plane import grpc_h2, hpack_codec, pgwire\n"
    )
    tops = [t for _, t in _imported_tops(src)]
    assert [t for t in tops if t in FORBIDDEN] == [
        "google", "h2", "hpack", "psycopg", "psycopg2", "asyncpg", "grpc", "agentfield_tpu"]
    allowed = set(sys.stdlib_module_names) | {"agentfield_tpu_torch"}
    pkg = ROOT / "agentfield_tpu_torch"
    for rel in ("control_plane/grpc_h2.py", "control_plane/hpack_codec.py",
                "control_plane/admin_grpc.py", "control_plane/pgwire.py",
                "control_plane/proto/wire.py", "control_plane/proto/admin_pb2.py",
                "control_plane/proto/modelnode_pb2.py"):
        assert pkg / rel in _port_files(), rel
        assert [t for _, t in _imported_tops(pkg / rel)
                if t not in allowed or t in FORBIDDEN] == [], rel


def test_grpc_and_postgres_run_without_the_libraries():
    """In a fresh interpreter where grpcio, protobuf, h2, hpack and the
    Postgres drivers cannot be imported: the admin service answers the
    port's own client, a GenerateRequest round-trips, and the Postgres
    provider imports."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('grpc', 'h2', 'hpack', 'psycopg', 'psycopg2',\n"
        "                                  'asyncpg') or name.startswith('google.protobuf'):\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "from agentfield_tpu_torch.control_plane.admin_grpc import admin_client_call, "
        "start_admin_grpc\n"
        "from agentfield_tpu_torch.control_plane.storage import SQLiteStorage\n"
        "from agentfield_tpu_torch.control_plane.storage_pg import PostgresStorage\n"
        "from agentfield_tpu_torch.control_plane.types import AgentNode\n"
        "from agentfield_tpu_torch.control_plane.proto import modelnode_pb2\n"
        "import socket\n"
        "with socket.socket() as s:\n"
        "    s.bind(('127.0.0.1', 0)); port = s.getsockname()[1]\n"
        "st = SQLiteStorage(':memory:')\n"
        "st.upsert_node(AgentNode(node_id='n1', base_url='http://x'))\n"
        "srv = start_admin_grpc(st, port)\n"
        "assert [n.node_id for n in admin_client_call(port, 'ListNodes').nodes] == ['n1']\n"
        "srv.stop(0)\n"
        "m = modelnode_pb2.GenerateRequest(tokens=[1, -2], temperature=0.5)\n"
        "assert modelnode_pb2.GenerateRequest.FromString(m.SerializeToString()) == m\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env={"PATH": "/usr/bin:/bin",
                                                      "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]
