"""Structured output for ai(): schema-instructed generation + robust parse.

The port's copy of ``agentfield_tpu/sdk/structured.py``. The JAX module
validates with ``jsonschema``, which the card's machine lacks; here
``validate`` checks an instance against the JSON-schema keywords that
``serving/grammar.py`` compiles into its token mask (``type``, ``enum``,
``const``, ``properties``, ``required``, ``items``, ``minItems``,
``maxItems``, ``maxLength``, ``anyOf``, ``oneOf``, ``allOf``, ``$ref``
into ``$defs``/``definitions``), with ``jsonschema``'s semantics for each
(an integer-valued float is an ``integer``, a bool is no number, ``1 ==
1.0`` in ``enum``/``const`` but ``True != 1``, a keyword applies only to its
instance type, ``$ref`` applies beside its siblings). Annotations
(``title``, ``description``, ``default``, ``examples``, ``$schema``,
``$id``, ``$comment``) are ignored. Any other keyword (``pattern``,
``minimum``, ``additionalProperties``, ...) raises StructuredOutputError
naming it: the mask never enforced it, and a silent pass would claim it
did.
"""

from __future__ import annotations

import json
import math
from typing import Any


class StructuredOutputError(ValueError):
    pass


# what serving/grammar.py compiles, and what the validator checks
KEYWORDS = frozenset({
    "type", "enum", "const", "properties", "required", "items", "minItems", "maxItems",
    "maxLength", "anyOf", "oneOf", "allOf", "$ref", "$defs", "definitions",
})
ANNOTATIONS = frozenset({
    "title", "description", "default", "examples", "$schema", "$id", "$comment",
})


def schema_instruction(schema: dict[str, Any]) -> str:
    return (
        "\n\nRespond ONLY with a single JSON object that validates against "
        f"this JSON schema, with no surrounding prose:\n{json.dumps(schema)}\nJSON:"
    )


def extract_json(text: str) -> Any:
    """Parse the first complete JSON value in `text`: strict parse first, then
    a balanced-delimiter scan (handles strings/escapes) for embedded objects."""
    text = text.strip()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        pass
    for open_ch, close_ch in (("{", "}"), ("[", "]")):
        start = text.find(open_ch)
        while start != -1:
            depth = 0
            in_str = False
            escape = False
            for i in range(start, len(text)):
                ch = text[i]
                if escape:
                    escape = False
                    continue
                if ch == "\\":
                    escape = in_str
                    continue
                if ch == '"':
                    in_str = not in_str
                    continue
                if in_str:
                    continue
                if ch == open_ch:
                    depth += 1
                elif ch == close_ch:
                    depth -= 1
                    if depth == 0:
                        try:
                            return json.loads(text[start : i + 1])
                        except json.JSONDecodeError:
                            break
            start = text.find(open_ch, start + 1)
    raise StructuredOutputError(f"no JSON value found in model output: {text[:200]!r}")


def _is_type(x: Any, t: str) -> bool:
    if t == "string":
        return isinstance(x, str)
    if t == "integer":
        return (isinstance(x, int) and not isinstance(x, bool)) or (
            isinstance(x, float) and math.isfinite(x) and x.is_integer())
    if t == "number":
        return isinstance(x, (int, float)) and not isinstance(x, bool)
    if t == "boolean":
        return isinstance(x, bool)
    if t == "null":
        return x is None
    if t == "array":
        return isinstance(x, list)
    if t == "object":
        return isinstance(x, dict)
    raise StructuredOutputError(f"unknown JSON-schema type {t!r}")


def _equal(a: Any, b: Any) -> bool:
    """JSON equality as jsonschema has it: numbers by value, bools apart."""
    if isinstance(a, bool) or isinstance(b, bool):
        return isinstance(a, bool) and isinstance(b, bool) and a == b
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, dict)) or isinstance(b, (list, dict)):
        return False
    return a == b


def _resolve(root: Any, ref: str) -> Any:
    if not ref.startswith("#"):
        raise StructuredOutputError(f"only intra-document $ref is supported, got {ref!r}")
    node = root
    for part in ref[1:].lstrip("/").split("/") if ref not in ("#", "#/") else []:
        part = part.replace("~1", "/").replace("~0", "~")
        if not isinstance(node, dict) or part not in node:
            raise StructuredOutputError(f"$ref {ref!r} does not resolve")
        node = node[part]
    return node


def _errors(x: Any, schema: Any, root: Any, path: str, depth: int = 0) -> list[str]:
    """Every way ``x`` fails ``schema`` (empty: it validates)."""
    if depth > 64:
        raise StructuredOutputError("schema $ref chain deeper than 64")
    if schema is True:
        return []
    if schema is False:
        return [f"{path}: no value is allowed here"]
    errs: list[str] = []
    if "$ref" in schema:
        errs += _errors(x, _resolve(root, schema["$ref"]), root, path, depth + 1)
    t = schema.get("type")
    if t is not None:
        types = t if isinstance(t, list) else [t]
        if not any(_is_type(x, one) for one in types):
            errs.append(f"{path}: {x!r} is not of type {t!r}")
    if "enum" in schema and not any(_equal(x, e) for e in schema["enum"]):
        errs.append(f"{path}: {x!r} is not one of {schema['enum']!r}")
    if "const" in schema and not _equal(x, schema["const"]):
        errs.append(f"{path}: {schema['const']!r} was expected")
    if isinstance(x, str) and "maxLength" in schema and len(x) > schema["maxLength"]:
        errs.append(f"{path}: {x!r} is longer than {schema['maxLength']}")
    if isinstance(x, list):
        if "minItems" in schema and len(x) < schema["minItems"]:
            errs.append(f"{path}: {x!r} has fewer than {schema['minItems']} items")
        if "maxItems" in schema and len(x) > schema["maxItems"]:
            errs.append(f"{path}: {x!r} has more than {schema['maxItems']} items")
        if "items" in schema:
            for i, item in enumerate(x):
                errs += _errors(item, schema["items"], root, f"{path}[{i}]", depth)
    if isinstance(x, dict):
        for name, sub in (schema.get("properties") or {}).items():
            if name in x:
                errs += _errors(x[name], sub, root, f"{path}.{name}", depth)
        missing = [n for n in schema.get("required") or () if n not in x]
        if missing:
            errs.append(f"{path}: {missing!r} required")
    for key, need in (("anyOf", "any"), ("oneOf", "one"), ("allOf", "all")):
        if key not in schema:
            continue
        ok = [not _errors(x, sub, root, path, depth + 1) for sub in schema[key]]
        if (need == "any" and not any(ok)) or (need == "all" and not all(ok)) or (
                need == "one" and sum(ok) != 1):
            errs.append(f"{path}: {x!r} fails {key} ({sum(ok)} of {len(ok)} branches hold)")
    return errs


def check_keywords(schema: Any, where: str = "$") -> None:
    """Raise StructuredOutputError naming the first keyword, anywhere in
    ``schema``, outside KEYWORDS and ANNOTATIONS."""
    if isinstance(schema, bool):
        return
    if not isinstance(schema, dict):
        raise StructuredOutputError(f"{where}: a schema must be an object or a bool, "
                                    f"got {schema!r}")
    unknown = sorted(set(schema) - KEYWORDS - ANNOTATIONS)
    if unknown:
        raise StructuredOutputError(
            f"{where}: schema keyword(s) {unknown} are outside what constrained decoding "
            f"compiles ({sorted(KEYWORDS)}): the port cannot validate them")
    for key in ("properties", "$defs", "definitions"):
        for name, sub in (schema.get(key) or {}).items():
            check_keywords(sub, f"{where}.{key}.{name}")
    if "items" in schema:
        check_keywords(schema["items"], f"{where}.items")
    for key in ("anyOf", "oneOf", "allOf"):
        for i, sub in enumerate(schema.get(key) or ()):
            check_keywords(sub, f"{where}.{key}[{i}]")


def validate(instance: Any, schema: dict[str, Any]) -> None:
    """Raise StructuredOutputError if ``instance`` does not validate
    against ``schema`` (or the schema uses a keyword outside KEYWORDS)."""
    check_keywords(schema)
    errs = _errors(instance, schema, schema, "$")
    if errs:
        raise StructuredOutputError(f"model output does not match schema: {errs[0]}")


def parse_structured(text: str, schema: dict[str, Any] | None = None) -> Any:
    obj = extract_json(text)
    if schema is not None:
        validate(obj, schema)
    return obj
