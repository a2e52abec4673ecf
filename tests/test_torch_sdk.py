"""The port's SDK pieces held against the JAX package's and the libraries
the JAX package uses (pydantic, jsonschema, PyYAML), which the card's
machine lacks and the port replaces:

- the input schema a component registers (``_schema_from_signature``)
  equals pydantic's ``model_json_schema()`` over a list of signatures, and
  its lax validation accepts, rejects and coerces as pydantic v2 does, on
  hypothesis-generated JSON values; an annotation outside the supported
  set raises TypeError at decoration;
- ``structured.validate`` agrees with ``jsonschema`` on instances of
  schemas that ``serving/grammar.py`` compiles, and refuses a keyword it
  cannot check; ``extract_json`` equals the JAX one;
- ``multimodal``, the execution context's headers and ``ResultCache``
  equal the JAX modules';
- ``config.load_yaml`` equals ``yaml.safe_load`` on generated documents of
  its subset, and names the line of one outside it.
"""

from __future__ import annotations

import base64
import json
import math
import typing
from typing import Any, Literal, Optional

import jsonschema
import pydantic
import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from agentfield_tpu.sdk import context as jax_context
from agentfield_tpu.sdk import multimodal as jax_mm
from agentfield_tpu.sdk import result_cache as jax_rc
from agentfield_tpu.sdk import structured as jax_structured
from agentfield_tpu_torch import config as port_config
from agentfield_tpu_torch.sdk import agent as port_agent
from agentfield_tpu_torch.sdk import context as port_context
from agentfield_tpu_torch.sdk import multimodal as port_mm
from agentfield_tpu_torch.sdk import result_cache as port_rc
from agentfield_tpu_torch.sdk import structured as port_structured

# derandomized: the same examples every run, so a pass is reproducible
SETTINGS = settings(max_examples=150, deadline=None, derandomize=True,
                    suppress_health_check=[HealthCheck.too_slow])

# annotations in the supported set, with a default or none (...)
FIELDS = [
    (str, ...), (int, ...), (float, ...), (bool, ...), (Any, ...), (list, ...), (dict, ...),
    (int, 3), (float, 1.5), (float, 1), (bool, False), (str, None), (str, "x"),
    (list[int], ...), (list[str], ["a"]), (list[list[float]], ...), (list[Any], ...),
    (dict[str, int], ...), (dict[str, Any], {}), (dict[str, list[int]], {"a": [1]}),
    (dict[str, Optional[int]], ...), (Optional[int], None), (int | None, ...),
    (Optional[list[int]], None), (Optional[Any], None), (Optional[dict], None),
    (Literal["a", "b"], "a"), (Literal[1, 2], ...), (Literal["only"], ...),
    (Literal[True, False], True), (Literal["a", None], None), (Literal[None], None),
    (Optional[Literal["x", "y"]], None), (list[Optional[bool]], ...),
    (dict, {"z": 1, "a": {"y": 2, "b": 3}}),
]


def _fn(name: str, fields: dict) -> typing.Callable:
    """A function whose signature carries ``fields`` (name -> (ann, default))."""
    import inspect

    params = [inspect.Parameter(n, inspect.Parameter.POSITIONAL_OR_KEYWORD,
                                annotation=ann,
                                default=inspect.Parameter.empty if d is ... else d)
              for n, (ann, d) in fields.items()]
    params.sort(key=lambda p: p.default is not inspect.Parameter.empty)  # required first

    def f(**kw):
        return kw

    f.__signature__ = inspect.Signature(params)
    f.__name__ = name
    return f


def _models(fields: dict):
    f = _fn("probe", fields)
    port_model, port_schema, ctx = port_agent._schema_from_signature(f)
    pd_model = pydantic.create_model("probe_Input", **{
        n: (ann, d) for n, (ann, d) in
        sorted(fields.items(), key=lambda kv: kv[1][1] is not ...)})
    return port_model, port_schema, pd_model


@pytest.mark.parametrize("i", range(len(FIELDS)))
def test_schema_equals_pydantic_one_field(i):
    ann, default = FIELDS[i]
    port_model, port_schema, pd_model = _models({"value_x": (ann, default)})
    want = pd_model.model_json_schema()
    assert port_schema == want
    assert json.dumps(port_schema) == json.dumps(want)  # key order too


@SETTINGS
@given(st.lists(st.sampled_from(range(len(FIELDS))), min_size=0, max_size=6))
def test_schema_equals_pydantic_signatures(picks):
    fields = {f"p{j}_{i}": FIELDS[i] for j, i in enumerate(picks)}
    _, port_schema, pd_model = _models(fields)
    assert json.dumps(port_schema) == json.dumps(pd_model.model_json_schema())


def test_ctx_params_and_annotation_refusals():
    def greet(ctx, name: str, context=None, excited: bool = False) -> str:
        return name

    model, schema, ctx = port_agent._schema_from_signature(greet)
    assert ctx == ["ctx", "context"] and list(schema["properties"]) == ["name", "excited"]
    for ann in (tuple, set, int | str, dict[int, str], pydantic.BaseModel, bytes):
        def bad(x: ann):  # noqa: B023
            return x
        with pytest.raises(TypeError, match="outside what the port's SDK validates"):
            port_agent._schema_from_signature(bad)


JSONISH = st.recursive(
    st.none() | st.booleans() | st.integers(-(2**70), 2**70)
    | st.floats(allow_nan=True, allow_infinity=True)
    | st.sampled_from([0.0, -0.0, 1.0, 2.0, 1.5, 1e20, 2.0**63, -(2.0**63), 9.2e18, 2.0**62])
    | st.sampled_from(["3", " 3 ", "3.0", "3.00", "3.5", "1e2", "1_000", "+4", "-4", "",
                       "abc", "true", "True", "yes", "on", "off", "no", "f", "t", "y", "n",
                       "0", "1", "2", "1.0", "nan", "inf", "-inf", "infinity", "0x10", "00",
                       "-0", ".5", "1.", "TRUE", "Off", "\t7\n", "a", "b", "x", "only",
                       "None", "12345678901234567890"])
    | st.text(max_size=6),
    lambda kids: st.lists(kids, max_size=3) | st.dictionaries(st.text(max_size=3), kids,
                                                               max_size=3),
    max_leaves=6)


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


@SETTINGS
@given(st.sampled_from(range(len(FIELDS))), JSONISH)
def test_lax_validation_equals_pydantic(i, value):
    ann, default = FIELDS[i]
    port_model, _, pd_model = _models({"v": (ann, default)})
    try:
        want = pd_model(v=value).v
        ok = True
    except pydantic.ValidationError:
        ok = False
    try:
        got = port_model.validate({"v": value})["v"]
        assert ok, f"{ann}: the port accepted {value!r} as {got!r}; pydantic refuses it"
        assert _same(got, want), (ann, value, got, want)
    except port_agent.ValidationError:
        assert not ok, f"{ann}: the port refused {value!r}; pydantic gives {want!r}"


def test_missing_unknown_and_defaults_as_pydantic():
    port_model, _, pd_model = _models({"a": (int, ...), "b": (list[int], [1, 2])})
    with pytest.raises(port_agent.ValidationError, match="Field required"):
        port_model.validate({"b": [3]})
    with pytest.raises(pydantic.ValidationError):
        pd_model(b=[3])
    got = port_model.validate({"a": "7", "zzz": 1})
    assert got == dict(pd_model(a="7", zzz=1)) == {"a": 7, "b": [1, 2]}
    got["b"].append(9)  # a default is a copy
    assert port_model.validate({"a": 1})["b"] == [1, 2]


# schemas that serving/grammar.py compiles
LEAF_SCHEMAS = st.sampled_from([
    {"type": "string"}, {"type": "string", "maxLength": 3}, {"type": "integer"},
    {"type": "number"}, {"type": "boolean"}, {"type": "null"}, {"enum": [1, "a", None, True]},
    {"const": 1}, {"const": [1, 2]}, {"type": ["string", "null"]}, {"enum": [1.0, False]},
])
SCHEMAS = st.recursive(LEAF_SCHEMAS, lambda kids: st.one_of(
    st.builds(lambda items, lo, hi: {"type": "array", "items": items, "minItems": lo,
                                     **({"maxItems": lo + hi} if hi is not None else {})},
              kids, st.integers(0, 2), st.none() | st.integers(0, 2)),
    st.builds(lambda props, req: {"type": "object", "properties": props,
                                  **({"required": sorted(props)[: req]} if req else {})},
              st.dictionaries(st.sampled_from("abc"), kids, max_size=3), st.integers(0, 3)),
    st.builds(lambda bs: {"anyOf": bs}, st.lists(kids, min_size=1, max_size=3)),
    st.builds(lambda bs: {"oneOf": bs}, st.lists(kids, min_size=1, max_size=3)),
    st.builds(lambda b: {"allOf": [b]}, kids),
), max_leaves=6)
# a $ref resolves against the document's root: it and its $defs sit there
ROOT_SCHEMAS = SCHEMAS | st.builds(
    lambda b, sib: {"$defs": {"d": b}, "$ref": "#/$defs/d", "title": "t", **sib}, SCHEMAS,
    st.sampled_from([{}, {"type": "object"}, {"type": ["array", "string"]}]))


@SETTINGS
@given(ROOT_SCHEMAS, JSONISH)
def test_structured_validate_equals_jsonschema(schema, instance):
    want = jsonschema.Draft202012Validator(schema).is_valid(instance)
    try:
        port_structured.validate(instance, schema)
        got = True
    except port_structured.StructuredOutputError:
        got = False
    assert got == want, (schema, instance)


def test_structured_refuses_keywords_it_cannot_check():
    for schema in ({"type": "integer", "minimum": 0},
                   {"type": "object", "properties": {"a": {"type": "string", "pattern": "x"}}},
                   {"type": "object", "additionalProperties": False}):
        with pytest.raises(port_structured.StructuredOutputError, match="outside what"):
            port_structured.parse_structured("{}", schema)
    assert port_structured.schema_instruction({"type": "null"}) == \
        jax_structured.schema_instruction({"type": "null"})


@SETTINGS
@given(st.text(max_size=40) | st.builds(
    lambda pre, v, post: pre + json.dumps(v) + post, st.text(max_size=8), JSONISH,
    st.text(max_size=8)))
def test_extract_json_equals_jax(text):
    def run(mod):
        try:
            return ("ok", mod.extract_json(text))
        except mod.StructuredOutputError as e:
            return ("err", str(e))

    a, b = run(jax_structured), run(port_structured)
    assert a[0] == b[0] and _same(a[1], b[1]) or (a[0] == "err" and a == b), (text, a, b)


def test_multimodal_equals_jax(tmp_path):
    png = b"\x89PNG\r\n\x1a\n" + b"0" * 16
    wav = b"RIFF\x00\x00\x00\x00WAVEfmt " + b"\x00" * 8
    txt = tmp_path / "notes.md"
    txt.write_text("# hi\nthere")
    parts = ["describe", png, wav, "and", txt.read_bytes()]
    for mod in (jax_mm, port_mm):
        assert [type(mod.classify(p)).__name__ for p in parts] == [
            type(jax_mm.classify(p)).__name__ for p in parts]
    j = jax_mm.split_prompt_and_media(list(parts))
    p = port_mm.split_prompt_and_media(list(parts))
    assert repr(j) == repr(p)
    fj, fp = jax_mm.FileContent.from_file(txt), port_mm.FileContent.from_file(txt)
    assert jax_mm.file_prompt_block(fj) == port_mm.file_prompt_block(fp)
    assert jax_mm.file_to_text(fj) == port_mm.file_to_text(fp)
    with pytest.raises(port_mm.UnsupportedModalityError):
        port_mm.file_to_text(port_mm.FileContent(b"\x00\x01\xff", name="b.bin"))
    res = {"text": "x", "parts": [{"type": "audio", "b64": base64.b64encode(wav).decode(),
                                   "mime": "audio/wav"}]}
    assert repr(jax_mm.detect_multimodal_response(dict(res))) == \
        repr(port_mm.detect_multimodal_response(dict(res)))


@SETTINGS
@given(st.dictionaries(st.sampled_from(["X-Run-ID", "x-execution-id", "X-Parent-Execution-ID",
                                        "X-Session-ID", "x-actor-id", "Other"]),
                       st.text(max_size=5), max_size=6))
def test_context_headers_equal_jax(headers):
    j = jax_context.ExecutionContext.from_headers(headers)
    p = port_context.ExecutionContext.from_headers(headers)
    assert (j is None) == (p is None)
    if j is None:
        return
    if not headers.get("X-Run-ID"):  # a fresh run id each: compare the rest
        j.run_id = p.run_id = "run"
    assert j.to_headers() == p.to_headers()
    jc, pc = j.child(), p.child()
    assert (jc.run_id, jc.parent_execution_id, jc.session_id) == \
        (pc.run_id, pc.parent_execution_id, pc.session_id)


def test_result_cache_equals_jax(monkeypatch):
    clock = [100.0]
    for mod in (jax_rc, port_rc):
        monkeypatch.setattr(mod.time, "monotonic", lambda: clock[0])
    caches = [jax_rc.ResultCache(max_entries=3, ttl=10.0), port_rc.ResultCache(3, 10.0)]
    script = [("put", "a"), ("put", "b"), ("get", "a"), ("put", "c"), ("put", "d"),
              ("get", "b"), ("tick", 6), ("put", "e"), ("tick", 5), ("get", "a"),
              ("get", "e"), ("purge", None), ("get", "d")]
    logs = [[], []]
    for op, arg in script:
        if op == "tick":
            clock[0] += arg
            continue
        for c, log in zip(caches, logs):
            if op == "put":
                c.put(arg, {"v": arg})
            elif op == "get":
                log.append(c.get(arg))
            else:
                log.append(c.purge_expired())
    assert logs[0] == logs[1] and caches[0].stats() == caches[1].stats()


# -- the YAML subset ------------------------------------------------------

KEYS = st.sampled_from(["server", "port", "host", "name", "entry", "model_node", "a", "b_c",
                        "data_dir", "x1"])
SCALARS = st.sampled_from([
    "1", "-3", "0", "010", "0x1f", "0b101", "1_000", "1.5", "-2.50", ".5", "1.0e+5", "1e5",
    ".inf", "-.inf", "yes", "No", "TRUE", "off", "On", "null", "~", "Null", "hello", "hello world",
    "http://x:80/y", "a-b", "'quoted # not a comment'", "'it''s'", '"esc\\n\\t\\u00e9"',
    '"a: b"', "''", '""', "[]", "{}", "[1, two, 3.5]", "['a', \"b\"]", "~/.agentfield_tpu",
    "llama-3.2-1b", "1:20", "190:20:30.15",
])


def _doc(tree, indent: int = 0) -> list[str]:
    pad = " " * indent
    out = []
    if isinstance(tree, dict):
        for k, v in tree.items():
            if isinstance(v, (dict, list)) and v:
                out.append(f"{pad}{k}:  # nested")
                out += _doc(v, indent + 2)
            else:
                out.append(f"{pad}{k}: {v if not isinstance(v, (dict, list)) else ('{}' if isinstance(v, dict) else '[]')}")
    else:
        for v in tree:
            if isinstance(v, dict) and v:
                lines = _doc(v, indent + 2)
                out.append(f"{pad}- {lines[0].lstrip()}")
                out += lines[1:]
            elif isinstance(v, list) and v:
                out.append(f"{pad}-")
                out += _doc(v, indent + 2)
            else:
                out.append(f"{pad}- {v if not isinstance(v, (dict, list)) else '[]'}")
    return out


TREES = st.recursive(st.dictionaries(KEYS, SCALARS, min_size=1, max_size=3),
                     lambda kids: st.dictionaries(KEYS, kids | SCALARS, min_size=1, max_size=3)
                     | st.lists(kids | SCALARS, min_size=1, max_size=3), max_leaves=8)


@SETTINGS
@given(TREES)
def test_yaml_subset_equals_safe_load(tree):
    text = "# generated\n---\n" + "\n".join(_doc(tree)) + "\n"
    want = yaml.safe_load(text)
    got = port_config.load_yaml(text)
    assert json.dumps(got, sort_keys=True, default=str) == json.dumps(want, sort_keys=True,
                                                                       default=str), text


@pytest.mark.parametrize("text,line", [
    ("a: &anchor 1\n", 1), ("a: *alias\n", 1), ("a: !!str 1\n", 1), ("a: |\n  block\n", 1),
    ("a: >\n  folded\n", 1), ("a: 2024-01-02\n", 1), ("a:\n\tb: 1\n", 2),
    ("a: {b: 1}\n", 1), ("a: 'open\n  more'\n", 1), ("x: 1\n  y: 2\n", 2),
])
def test_yaml_outside_the_subset_names_its_line(text, line):
    with pytest.raises(ValueError, match=f"YAML line {line}:"):
        port_config.load_yaml(text)
