"""Configuration system: YAML file + environment overrides — the port's copy
of ``agentfield_tpu/config.py``.

Mirrors the reference's config surface (internal/config/config.go:15-180 —
server port, execution queue tuning, cleanup, storage, CORS/data dirs, with
viper env overrides). Env vars use the AGENTFIELD_ prefix with __ as the
section separator, e.g. AGENTFIELD_SERVER__PORT=9000 overrides server.port.

The JAX module reads YAML with PyYAML, which the card's machine lacks.
``load_yaml`` reads the subset that config files and ``agentfield.yaml``
package manifests use, with PyYAML's ``safe_load`` results: block mappings
and block lists nested by indentation (a list may sit at its key's
indentation), plain, single- and double-quoted scalars on one line,
comments, a leading ``---``, the flow forms ``[]``, ``{}`` and ``[a, b]``
of scalars, and PyYAML's implicit scalar types (bool, int, float, null;
YAML 1.1 spellings such as ``yes``, ``0x1f``, ``1_000``, ``.inf``). A
document outside that subset (anchors, aliases, tags, block scalars ``|``
and ``>``, flow mappings with entries, multi-line scalars, tabs in the
indentation, dates) raises ValueError naming its line.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
from pathlib import Path
from typing import Any

ENV_PREFIX = "AGENTFIELD_"


@dataclasses.dataclass
class ServerConfig:
    host: str = "127.0.0.1"
    port: int = 8800
    db_path: str = "~/.agentfield_tpu/control_plane.db"
    webhook_secret: str | None = None
    keystore_passphrase: str | None = None  # None → AGENTFIELD_KEYSTORE_PASSPHRASE env


@dataclasses.dataclass
class ExecutionConfig:
    agent_timeout: float = 90.0  # reference: execute.go:187
    sync_wait_timeout: float = 600.0
    async_workers: int = 8
    queue_capacity: int = 1024  # reference: execute.go:1373
    cleanup_interval: float = 60.0
    stale_after: float = 3600.0
    retention: float = 86400.0


@dataclasses.dataclass
class PresenceConfig:
    heartbeat_ttl: float = 300.0  # reference: server.go:131-137
    sweep_interval: float = 30.0
    evict_after: float = 1800.0


@dataclasses.dataclass
class ModelNodeConfig:
    model: str = "llama-3.2-1b"
    checkpoint: str | None = None  # HF checkpoint dir (safetensors)
    lora: str | None = None  # LoRA adapter dir (training.lora.save_adapter),
    # merged into the base weights at load
    tokenizer: str | None = None
    max_batch: int = 32
    page_size: int = 16
    num_pages: int = 2048
    max_pages_per_seq: int = 32
    attn_impl: str = "ref"  # the JAX engine's switches: one path each in the
    prefill_impl: str = "ref"  # port (serving.engine.resolve_impls)
    prefill_chunk: int | None = None  # chunked prefill (>= 16) or whole-prompt
    decode_span: int = 1  # decode steps per device dispatch
    kv_quant_dtype: str = "none"  # quantized KV pages: "int8" | "fp8"
    grammar_slots: int = 256  # constrained-decoding bank rows (0 disables)
    grammar_whitespace: bool = False  # accept bounded whitespace in
    # schema-constrained output (the JAX node's option; not ported)
    vision: str | None = None  # vision tower config name → serve image inputs
    audio: str | None = None  # audio tower config name → serve audio inputs
    tts: str | None = None  # TTS head config name → serve audio OUTPUT
    imagegen: str | None = None  # image-gen head config name → serve
    # output="image" rendering
    quant: str | None = None  # "int8" weight-only quantized serving
    spec_draft: str | None = None  # draft preset/checkpoint for speculative
    # decoding (with spec_k > 0)
    spec_k: int = 0  # speculative proposals per decode step (0 disables)
    tp: int = 1  # tensor-parallel degree


@dataclasses.dataclass
class Config:
    server: ServerConfig = dataclasses.field(default_factory=ServerConfig)
    execution: ExecutionConfig = dataclasses.field(default_factory=ExecutionConfig)
    presence: PresenceConfig = dataclasses.field(default_factory=PresenceConfig)
    model_node: ModelNodeConfig = dataclasses.field(default_factory=ModelNodeConfig)
    data_dir: str = "~/.agentfield_tpu"

    def expanded_data_dir(self) -> Path:
        return Path(os.path.expanduser(self.data_dir))


_SECTIONS = {
    "server": ServerConfig,
    "execution": ExecutionConfig,
    "presence": PresenceConfig,
    "model_node": ModelNodeConfig,
}


def _coerce(value: str, target_type: Any) -> Any:
    if target_type is bool or target_type == "bool":
        return value.lower() in ("1", "true", "yes")
    for t in (int, float):
        if target_type is t:
            return t(value)
    return value


def load_config(path: str | None = None, env: dict[str, str] | None = None) -> Config:
    """YAML (optional) then env overrides (AGENTFIELD_SECTION__FIELD)."""
    cfg = Config()
    if path:
        doc = load_yaml(Path(path).read_text()) or {}
        if not isinstance(doc, dict):
            raise ValueError(f"config file {path} must contain a mapping")
        for section, cls in _SECTIONS.items():
            if section in doc and isinstance(doc[section], dict):
                known = {f.name for f in dataclasses.fields(cls)}
                unknown = set(doc[section]) - known
                if unknown:
                    raise ValueError(f"unknown keys in [{section}]: {sorted(unknown)}")
                setattr(cfg, section, cls(**doc[section]))
        if "data_dir" in doc:
            cfg.data_dir = doc["data_dir"]

    env = env if env is not None else dict(os.environ)
    for key, value in env.items():
        if not key.startswith(ENV_PREFIX) or "__" not in key:
            continue
        section_name, _, field_name = key[len(ENV_PREFIX) :].lower().partition("__")
        if section_name not in _SECTIONS:
            continue
        section = getattr(cfg, section_name)
        for f in dataclasses.fields(section):
            if f.name == field_name:
                setattr(section, f.name, _coerce(value, f.type if isinstance(f.type, type) else type(getattr(section, f.name))))
    return cfg


# -- the YAML subset ------------------------------------------------------

# PyYAML's implicit resolvers (yaml/resolver.py), YAML 1.1
_BOOL = re.compile(r"yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)")
_INT = re.compile(r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+")
_NULL = re.compile(r"~|null|Null|NULL|")
_TIMESTAMP = re.compile(r"[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
                        r"(?:(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
                        r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)?")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX = {"x": 2, "u": 4, "U": 8}


class _Line:
    __slots__ = ("no", "indent", "text")

    def __init__(self, no: int, indent: int, text: str):
        self.no, self.indent, self.text = no, indent, text


def _fail(no: int, what: str) -> ValueError:
    return ValueError(f"YAML line {no}: {what} is outside the subset this reader takes "
                      "(agentfield_tpu_torch.config.load_yaml)")


def _sexagesimal(text: str, conv) -> Any:
    sign = -1 if text.startswith("-") else 1
    digits = [conv(p) for p in text.lstrip("+-").split(":")]
    value, base = 0, 1
    for d in reversed(digits):
        value += d * base
        base *= 60
    return sign * value


def _plain(text: str, no: int) -> Any:
    """A plain scalar's value, as PyYAML's safe_load resolves it."""
    if _NULL.fullmatch(text):
        return None
    if _BOOL.fullmatch(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.fullmatch(text):
        t = text.replace("_", "")
        sign = -1 if t.startswith("-") else 1
        body = t.lstrip("+-")
        if ":" in body:
            return _sexagesimal(t, int)
        if body.startswith("0b"):
            return sign * int(body[2:], 2)
        if body.startswith("0x"):
            return sign * int(body[2:], 16)
        if body != "0" and body.startswith("0"):
            return sign * int(body, 8)
        return sign * int(body)
    if _FLOAT.fullmatch(text):
        t = text.replace("_", "").lower()
        if t.lstrip("+-") == ".inf":
            return -math.inf if t.startswith("-") else math.inf
        if t == ".nan":
            return math.nan
        if ":" in t:
            return _sexagesimal(t, float)
        return float(t)
    if _TIMESTAMP.fullmatch(text):
        raise _fail(no, f"a timestamp ({text!r})")
    if text[0] in "&*!|>%@`{[" or text.startswith(("- ", "? ", ": ")) or text in ("-", "?"):
        raise _fail(no, f"the scalar {text!r}")
    return text


def _quoted(text: str, no: int) -> tuple[str, str]:
    """(value, rest of the line) of a quoted scalar at the start of ``text``."""
    q = text[0]
    out, i = [], 1
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if text[i + 1 : i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1 :]
        if q == '"' and c == '"':
            return "".join(out), text[i + 1 :]
        if q == '"' and c == "\\":
            e = text[i + 1 : i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
                continue
            if e in _HEX:
                n = _HEX[e]
                digits = text[i + 2 : i + 2 + n]
                if len(digits) != n or not all(ch in "0123456789abcdefABCDEF" for ch in digits):
                    raise _fail(no, f"the escape \\{e}{digits}")
                out.append(chr(int(digits, 16)))
                i += 2 + n
                continue
            raise _fail(no, f"the escape \\{e}")
        out.append(c)
        i += 1
    raise _fail(no, "a quoted scalar that goes on past its line")


def _strip_comment(text: str) -> str:
    """``text`` without a trailing comment (a ``#`` after whitespace,
    outside quotes) and trailing whitespace."""
    q = None
    i = 0
    while i < len(text):
        c = text[i]
        if q is None:
            if c in "'\"" and (i == 0 or text[i - 1] in " [,:{-"):
                q = c
            elif c == "#" and (i == 0 or text[i - 1] in " \t"):
                return text[:i].rstrip()
        elif q == "'" and c == "'":
            if text[i + 1 : i + 2] == "'":
                i += 1
            else:
                q = None
        elif q == '"' and c == "\\":
            i += 1
        elif q == '"' and c == '"':
            q = None
        i += 1
    return text.rstrip()


def _scalar(text: str, no: int) -> Any:
    """A value written on one line: a quoted or plain scalar, or a flow
    sequence of scalars, ``[]`` or ``{}``."""
    if text[0] in "'\"":
        value, rest = _quoted(text, no)
        if rest.strip():
            raise _fail(no, f"text after a quoted scalar ({rest.strip()!r})")
        return value
    if text == "{}":
        return {}
    if text.startswith("["):
        if not text.endswith("]"):
            raise _fail(no, "a flow sequence that goes on past its line")
        inner = text[1:-1].strip()
        if not inner:
            return []
        items, rest = [], inner
        while True:
            rest = rest.strip()
            if rest[:1] in ("'", '"'):
                value, rest = _quoted(rest, no)
                items.append(value)
                rest = rest.strip()
            else:
                part, sep, tail = rest.partition(",")
                part = part.strip()
                if not part or any(c in part for c in "[]{}"):
                    raise _fail(no, f"the flow sequence {text!r}")
                items.append(_plain(part, no))
                rest = sep + tail
            if not rest:
                return items
            if not rest.startswith(","):
                raise _fail(no, f"the flow sequence {text!r}")
            rest = rest[1:]
    return _plain(text, no)


def _split_key(text: str, no: int) -> tuple[Any, str] | None:
    """(key, value text) when ``text`` is a mapping entry, else None."""
    if text[0] in "'\"":
        key, rest = _quoted(text, no)
        if rest.startswith(":") and (len(rest) == 1 or rest[1] in " \t"):
            return key, rest[1:].strip()
        return None
    if text[0] in "[{":
        return None
    m = re.search(r":(?:[ \t]|$)", text)
    if m is None:
        return None
    return _plain(text[: m.start()].rstrip(), no), text[m.end() :].strip()


def load_yaml(text: str) -> Any:
    """The document in ``text`` as ``yaml.safe_load`` gives it, for the
    subset above; ValueError naming the line otherwise."""
    lines: list[_Line] = []
    for no, raw in enumerate(text.splitlines(), 1):
        body = raw.lstrip(" ")
        if body.startswith("\t") or (body and raw[: len(raw) - len(body)].count("\t")):
            raise _fail(no, "a tab in the indentation")
        stripped = _strip_comment(body)
        if not stripped:
            continue
        if stripped == "---" and not lines:
            continue
        if stripped.startswith(("---", "...", "%")):
            raise _fail(no, f"the directive or marker {stripped!r}")
        lines.append(_Line(no, len(raw) - len(body), stripped))
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0].indent)
    if i < len(lines):
        raise _fail(lines[i].no, f"the line {lines[i].text!r} (indentation)")
    return value


def _block(lines: list[_Line], i: int, indent: int) -> tuple[Any, int]:
    """The block node whose first line is ``lines[i]`` at ``indent``."""
    first = lines[i]
    if first.text == "-" or first.text.startswith("- "):
        return _sequence(lines, i, indent)
    if _split_key(first.text, first.no) is not None:
        return _mapping(lines, i, indent)
    if i + 1 < len(lines) and lines[i + 1].indent >= indent:
        raise _fail(lines[i + 1].no, "a multi-line scalar")
    return _scalar(first.text, first.no), i + 1


def _value_after(lines, i: int, parent_indent: int, rest: str, no: int,
                 seq_same_indent: bool) -> tuple[Any, int]:
    """The value of an entry whose text after ``key:`` / ``-`` is ``rest``;
    ``i`` is the next line's index."""
    if rest:
        value = _scalar(rest, no)
        if i < len(lines) and lines[i].indent > parent_indent:
            raise _fail(lines[i].no, "a multi-line scalar")
        return value, i
    if i < len(lines):
        nxt = lines[i]
        if nxt.indent > parent_indent:
            return _block(lines, i, nxt.indent)
        if (seq_same_indent and nxt.indent == parent_indent
                and (nxt.text == "-" or nxt.text.startswith("- "))):
            return _sequence(lines, i, parent_indent)
    return None, i


def _mapping(lines: list[_Line], i: int, indent: int) -> tuple[dict, int]:
    out: dict = {}
    while i < len(lines) and lines[i].indent == indent:
        ln = lines[i]
        kv = _split_key(ln.text, ln.no)
        if kv is None:
            raise _fail(ln.no, f"the line {ln.text!r} inside a mapping")
        key, rest = kv
        try:
            hash(key)
        except TypeError:
            raise _fail(ln.no, f"the key {key!r}") from None
        out[key], i = _value_after(lines, i + 1, indent, rest, ln.no, True)
    if i < len(lines) and lines[i].indent > indent:
        raise _fail(lines[i].no, f"the line {lines[i].text!r} (indentation)")
    return out, i


def _sequence(lines: list[_Line], i: int, indent: int) -> tuple[list, int]:
    out: list = []
    while i < len(lines) and lines[i].indent == indent and (
            lines[i].text == "-" or lines[i].text.startswith("- ")):
        ln = lines[i]
        rest = ln.text[1:].lstrip(" ")
        if rest and (rest.startswith(("- ",)) or rest == "-"
                     or _split_key(rest, ln.no) is not None):
            # a nested block that starts on the item's own line: re-read the
            # rest as a line of its own at the column it starts in
            col = indent + len(ln.text) - len(rest)
            lines[i] = _Line(ln.no, col, rest)
            value, i = _block(lines, i, col)
            out.append(value)
            continue
        value, i = _value_after(lines, i + 1, indent, rest, ln.no, False)
        out.append(value)
    if i < len(lines) and lines[i].indent > indent:
        raise _fail(lines[i].no, f"the line {lines[i].text!r} (indentation)")
    return out, i
