"""Agent package installation: the port's copy of
``agentfield_tpu/cli/packages.py``, reading ``agentfield.yaml`` with the
port's YAML subset (``config.load_yaml``) where the JAX module uses PyYAML.

Parity with the reference's package system (internal/packages/installer.go:
186 install from local path or git URL, agentfield.yaml metadata, an
installed.json registry, dependency install hooks). Packages land under
``<data_dir>/packages/<name>`` and `aftpu run <name>` resolves them.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

from agentfield_tpu_torch.config import load_yaml

_NAME_RE = re.compile(r"[A-Za-z0-9][A-Za-z0-9._-]{0,63}")


class PackageError(Exception):
    pass


def _registry_path(data_dir: Path) -> Path:
    return data_dir / "packages" / "installed.json"


def load_registry(data_dir: Path) -> dict:
    p = _registry_path(data_dir)
    if not p.exists():
        return {}
    try:
        return json.loads(p.read_text())
    except (json.JSONDecodeError, OSError) as e:
        print(f"[aftpu] warning: corrupt package registry {p} ({e}); ignoring", file=sys.stderr)
        return {}


def _save_registry(data_dir: Path, reg: dict) -> None:
    p = _registry_path(data_dir)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_suffix(".tmp")
    tmp.write_text(json.dumps(reg, indent=2))
    tmp.rename(p)  # atomic: a crash never leaves a truncated registry


def read_manifest(pkg_dir: Path) -> dict:
    mf = pkg_dir / "agentfield.yaml"
    if not mf.exists():
        raise PackageError(f"{pkg_dir} has no agentfield.yaml manifest")
    doc = load_yaml(mf.read_text()) or {}
    if not isinstance(doc, dict) or not doc.get("name"):
        raise PackageError("agentfield.yaml must define at least 'name'")
    name = str(doc["name"])
    if not _NAME_RE.fullmatch(name):
        # A name with separators/'..' would escape the packages dir on
        # install AND make uninstall rmtree an arbitrary path.
        raise PackageError(
            f"invalid package name {name!r}: letters/digits/._- only, no separators"
        )
    if name in ("installed.json", "installed.tmp"):  # registry file + its
        # atomic-write temp — a package dir at either path wedges the registry
        raise PackageError(f"package name {name!r} is reserved")
    doc["name"] = name
    doc.setdefault("entry", "main.py")
    return doc


def install(source: str, data_dir: Path, force: bool = False) -> dict:
    """Install from a local directory or a git URL/path (anything `git clone`
    accepts). Returns the registry entry."""
    packages_dir = data_dir / "packages"
    packages_dir.mkdir(parents=True, exist_ok=True)

    src = Path(source).expanduser()
    if src.is_dir() and (src / "agentfield.yaml").exists():
        # A local working tree wins over its git history — installing your
        # edited-but-uncommitted agent must install what you see on disk.
        manifest = read_manifest(src)
        name = manifest["name"]
        dest = packages_dir / name
        if dest.exists():
            if not force:
                raise PackageError(f"package {name!r} already installed (use --force)")
            shutil.rmtree(dest)
        shutil.copytree(
            src,
            dest,
            ignore=shutil.ignore_patterns(
                ".git", "__pycache__", "*.pyc", ".venv", "venv", ".env",
                "node_modules", ".pytest_cache",
            ),
        )
        origin = {"type": "local", "path": str(src.resolve())}
    else:
        # git source (URL, or a local path that is a git repo)
        tmp = packages_dir / ".clone_tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        try:
            proc = subprocess.run(
                ["git", "clone", "--depth", "1", source, str(tmp)],
                capture_output=True,
                text=True,
                timeout=300,
            )
        except subprocess.TimeoutExpired:
            shutil.rmtree(tmp, ignore_errors=True)
            raise PackageError(f"git clone timed out after 300s: {source}") from None
        if proc.returncode != 0:
            shutil.rmtree(tmp, ignore_errors=True)
            raise PackageError(f"git clone failed: {proc.stderr.strip()[:300]}")
        try:
            manifest = read_manifest(tmp)
            name = manifest["name"]
            dest = packages_dir / name
            if dest.exists():
                if not force:
                    raise PackageError(f"package {name!r} already installed (use --force)")
                shutil.rmtree(dest)
            shutil.rmtree(tmp / ".git", ignore_errors=True)
            tmp.rename(dest)
        finally:
            if tmp.exists():
                shutil.rmtree(tmp)
        origin = {"type": "git", "url": source}

    entry = {
        "name": name,
        "path": str(dest),
        "entry": manifest["entry"],
        "description": manifest.get("description", ""),
        "origin": origin,
        "installed_at": time.time(),
    }
    reg = load_registry(data_dir)
    reg[name] = entry
    _save_registry(data_dir, reg)
    return entry


def uninstall(name: str, data_dir: Path) -> bool:
    reg = load_registry(data_dir)
    entry = reg.pop(name, None)
    if entry is None:
        return False
    shutil.rmtree(entry["path"], ignore_errors=True)
    _save_registry(data_dir, reg)
    return True


def resolve_entrypoint(name_or_path: str, data_dir: Path) -> Path | None:
    """`aftpu run X`: installed package name first, filesystem path second."""
    reg = load_registry(data_dir)
    if name_or_path in reg:
        e = reg[name_or_path]
        return Path(e["path"]) / e["entry"]
    return None
