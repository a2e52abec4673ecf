"""The agent-developer SDK: ``Agent``, ``@reasoner``/``@skill``, ``call()``,
``ai()`` — the port's copy of ``agentfield_tpu/sdk/agent.py``.

It serves on ``control_plane/http.py`` where the JAX module serves on
aiohttp, and serves the gateway's channel at ``GET /channel`` with the
asyncio node half of ``control_plane/channel.py``. Its ``ai()`` reaches the
port's model node through the gateway, as the JAX ``Agent``'s reaches the
JAX node; the node runs the hand-written kernels on the card.

One difference is deliberate. The JAX module builds a pydantic model from
each component's signature; the card's machine has no pydantic, so
``_schema_from_signature`` synthesizes the same ``model_json_schema()``
document itself and validates an input as pydantic v2's lax mode does
(``"3"`` → ``3`` for ``int``, ``1.0`` → ``1``, ``"true"`` → ``True``;
missing required fields fail, unknown keys are ignored; a failure answers
422 on a direct call and fails a tracked execution), for the annotations
agent code uses: ``str``, ``int``, ``float``, ``bool``, ``None``, ``Any``,
``list``/``list[X]``, ``dict``/``dict[str, X]``, ``Optional[X]``/``X |
None``, ``Literal[...]``, with defaults. Any other annotation (a pydantic
model class, ``tuple``, a union of two types) raises TypeError at
decoration, naming that set.

Re-design of the reference's Agent core (sdk/python/agentfield/agent.py:305:
a FastAPI subclass whose decorators synthesize pydantic input models, HTTP
endpoints and tracked wrappers; serve() registers with the control plane and
heartbeats). Differences, deliberate:

- asyncio HTTP instead of FastAPI (toolchain), same decorator ergonomics.
- ``ai()`` routes to an in-tree model node through the control plane
  (reference delegates to litellm/external providers, agent_ai.py:342) —
  no external LLM API in the loop.
- The 202-ack + status-callback contract is identical in spirit to the
  reference (agent.py:1182-1197: spawn task, ack, POST status later).
"""

from __future__ import annotations

import asyncio
import contextvars
import copy
import dataclasses
import inspect
import json
import math
import os
import random
import re
import types
import typing
from typing import Any, Callable, Literal

from agentfield_tpu_torch.control_plane import http
from agentfield_tpu_torch.logging import get_logger
from agentfield_tpu_torch.sdk.client import ControlPlaneClient, ControlPlaneError
from agentfield_tpu_torch.sdk.context import (
    ExecutionContext,
    current_context,
    reset_context,
    set_context,
)

log = get_logger("sdk.agent")

# Backpressure backoff bounds (docs/FAULT_TOLERANCE.md overload control):
# a server Retry-After hint wins over the local exponential schedule, but a
# confused server must not park clients for an hour. The cap is DELIBERATELY
# tighter than the gateway's own 120s hint ceiling: past 30s of advertised
# wait, ai()'s failover loop is better served trying another candidate (or
# surfacing the overload) than parking on one node's estimate.
_RETRY_AFTER_CAP_S = 30.0
_BACKOFF_CAP_S = 5.0


def _backpressure_delay(attempts: int, retry_after: float | None = None) -> float:
    """Seconds to wait before retrying a 429/503 (or QueueFullError-failed)
    call. The server's Retry-After hint is authoritative when present —
    jittered UPWARD only (retrying before the server's own estimate just
    buys another 429, and multiplicative spread breaks up the herd that got
    the same hint), then capped: the cap is the true maximum sleep, jitter
    included. Without a hint: capped exponential with half-jitter, so
    patience still grows with consecutive rejections."""
    if retry_after is not None and retry_after > 0:
        # "Retry-After: 0" (RFC-legal from proxies) is NOT an invitation to
        # hot-loop an overloaded server — a non-positive hint falls through
        # to the exponential schedule below, which always sleeps.
        return min(retry_after * random.uniform(1.0, 1.25), _RETRY_AFTER_CAP_S)
    base = min(0.2 * (2**attempts), _BACKOFF_CAP_S)
    return random.uniform(base / 2, base)

DEFAULT_CONTROL_PLANE = os.environ.get("AGENTFIELD_URL", "http://127.0.0.1:8800")


# -- input models: pydantic's schema and lax validation, for the annotations
# agent code uses

SUPPORTED_ANNOTATIONS = ("str, int, float, bool, None, Any, list, list[X], dict, "
                         "dict[str, X], Optional[X] / X | None, Literal[...]")
_NONE = type(None)
_INT_TEXT = re.compile(r"[+-]?[0-9]+(?:_[0-9]+)*(?:\.0+)?")
_TRUE = frozenset({"1", "on", "t", "true", "y", "yes"})
_FALSE = frozenset({"0", "off", "f", "false", "n", "no"})


class ValidationError(ValueError):
    """An input that does not fit a component's parameters (the JAX SDK's
    ``pydantic.ValidationError``): ``errors()`` lists each failure as
    ``{"type", "loc", "msg", "input"}``."""

    def __init__(self, title: str, errors: list[dict[str, Any]]):
        self.title = title
        self._errors = errors
        lines = [f"{len(errors)} validation error{'s' if len(errors) != 1 else ''} for {title}"]
        for e in errors:
            lines.append(".".join(str(p) for p in e["loc"]))
            lines.append(f"  {e['msg']} [type={e['type']}, input_value={e['input']!r}]")
        super().__init__("\n".join(lines))

    def errors(self) -> list[dict[str, Any]]:
        return list(self._errors)


class _Invalid(Exception):
    def __init__(self, kind: str, msg: str):
        self.kind, self.msg = kind, msg


def _check_annotation(ann: Any, where: str) -> None:
    """TypeError unless ``ann`` is in SUPPORTED_ANNOTATIONS (recursively)."""
    if ann in (str, int, float, bool, _NONE, None, Any, list, dict):
        return
    origin, args = typing.get_origin(ann), typing.get_args(ann)
    if origin is list and len(args) == 1:
        return _check_annotation(args[0], where)
    if origin is dict and len(args) == 2 and args[0] is str:
        return _check_annotation(args[1], where)
    if origin is Literal and all(isinstance(a, (str, int, bool, _NONE)) for a in args):
        return
    if origin in (typing.Union, types.UnionType) and _NONE in args and len(args) == 2:
        return _check_annotation(next(a for a in args if a is not _NONE), where)
    raise TypeError(
        f"{where}: annotation {ann!r} is outside what the port's SDK validates "
        f"({SUPPORTED_ANNOTATIONS}); use one of those (or Any)")


def _type_schema(ann: Any) -> dict[str, Any]:
    """pydantic v2's JSON schema of one annotation (before sorting)."""
    if ann is Any:
        return {}
    if ann is None or ann is _NONE:
        return {"type": "null"}
    simple = {str: "string", int: "integer", float: "number", bool: "boolean"}
    if ann in simple:
        return {"type": simple[ann]}
    origin, args = typing.get_origin(ann), typing.get_args(ann)
    if ann is list or origin is list:
        return {"items": _type_schema(args[0] if args else Any), "type": "array"}
    if ann is dict or origin is dict:
        value = args[1] if args else Any
        return {"additionalProperties": True if value is Any else _type_schema(value),
                "type": "object"}
    if origin is Literal:
        out: dict[str, Any] = {"const": args[0]} if len(args) == 1 else {"enum": list(args)}
        kinds = {type(a) for a in args}
        named = {frozenset({str}): "string", frozenset({int}): "integer",
                 frozenset({bool}): "boolean", frozenset({_NONE}): "null"}
        if frozenset(kinds) in named:
            out["type"] = named[frozenset(kinds)]
        return out
    inner = next(a for a in args if a is not _NONE)  # Optional[X]
    return {"anyOf": [_type_schema(inner), {"type": "null"}]}


def _jsonable(v: Any) -> Any:
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return v


def _sorted_schema(value: Any, parent_key: str | None = None) -> Any:
    """pydantic's key order: alphabetical, recursively, except the keys
    under ``properties`` and ``default`` (field order kept)."""
    if isinstance(value, dict):
        keys = value.keys() if parent_key in ("properties", "default") else sorted(value)
        return {k: _sorted_schema(value[k], k) for k in keys}
    if isinstance(value, list):
        return [_sorted_schema(v, parent_key) for v in value]
    return value


def _to_int(x: Any) -> int:
    if isinstance(x, bool):
        return int(x)
    if isinstance(x, int):
        return x
    if isinstance(x, float):
        if not math.isfinite(x):
            raise _Invalid("finite_number", "Input should be a finite number")
        if not x.is_integer():
            raise _Invalid("int_from_float",
                           "Input should be a valid integer, got a number with a fractional part")
        if abs(x) >= 2.0**63:
            raise _Invalid("int_parsing_size",
                           "Unable to parse input string as an integer, exceeded maximum size")
        return int(x)
    if isinstance(x, str):
        s = x.strip()
        if not _INT_TEXT.fullmatch(s):
            raise _Invalid("int_parsing",
                           "Input should be a valid integer, unable to parse string as an integer")
        return int(s.split(".")[0].replace("_", ""))
    raise _Invalid("int_type", "Input should be a valid integer")


def _to_float(x: Any) -> float:
    if isinstance(x, bool):
        return float(x)
    if isinstance(x, int):
        try:
            return float(x)
        except OverflowError:
            raise _Invalid("float_type", "Input should be a valid number") from None
    if isinstance(x, float):
        return x
    if isinstance(x, str):
        s = x.strip()
        if s.isascii() and not (s.startswith("_") or s.endswith("_") or "__" in s):
            try:
                return float(s.replace("_", ""))
            except ValueError:
                pass
        raise _Invalid("float_parsing",
                       "Input should be a valid number, unable to parse string as a number")
    raise _Invalid("float_type", "Input should be a valid number")


def _to_bool(x: Any) -> bool:
    if isinstance(x, bool):
        return x
    if isinstance(x, (int, float)) and x in (0, 1):
        return bool(x)
    if isinstance(x, str):
        low = x.lower()
        if low in _TRUE:
            return True
        if low in _FALSE:
            return False
        raise _Invalid("bool_parsing",
                       "Input should be a valid boolean, unable to interpret input")
    if isinstance(x, int) and -(2**63) <= x < 2**63:
        raise _Invalid("bool_parsing", "Input should be a valid boolean, unable to interpret input")
    raise _Invalid("bool_type", "Input should be a valid boolean")


def _coerce(ann: Any, x: Any, loc: tuple, errs: list[dict]) -> Any:
    """``x`` validated against ``ann`` in pydantic's lax mode; each failure
    appended to ``errs`` (the return value is then meaningless)."""
    def fail(kind: str, msg: str) -> None:
        errs.append({"type": kind, "loc": loc, "msg": msg, "input": x})

    try:
        if ann is Any:
            return x
        if ann is None or ann is _NONE:
            if x is not None:
                fail("none_required", "Input should be None")
            return None
        if ann is str:
            if not isinstance(x, str):
                fail("string_type", "Input should be a valid string")
            return x
        if ann is int:
            return _to_int(x)
        if ann is float:
            return _to_float(x)
        if ann is bool:
            return _to_bool(x)
    except _Invalid as e:
        fail(e.kind, e.msg)
        return None
    origin, args = typing.get_origin(ann), typing.get_args(ann)
    if ann is list or origin is list:
        if not isinstance(x, (list, tuple, set, frozenset)):
            fail("list_type", "Input should be a valid list")
            return None
        item = args[0] if args else Any
        return [_coerce(item, v, loc + (i,), errs) for i, v in enumerate(x)]
    if ann is dict or origin is dict:
        if not isinstance(x, dict):
            fail("dict_type", "Input should be a valid dictionary")
            return None
        value = args[1] if args else Any
        out = {}
        for k, v in x.items():
            if not isinstance(k, str):
                errs.append({"type": "string_type", "loc": loc + (k, "[key]"),
                             "msg": "Input should be a valid string", "input": k})
                continue
            out[k] = _coerce(value, v, loc + (k,), errs)
        return out
    if origin is Literal:
        for e in args:
            if isinstance(e, str) or isinstance(x, str):
                if isinstance(e, str) and isinstance(x, str) and e == x:
                    return e
            elif e is None or x is None:
                if e is x:
                    return e
            elif isinstance(x, (int, float)) and x == e:
                return e
        fail("literal_error", "Input should be " + " or ".join(repr(a) for a in args))
        return None
    if x is None:  # Optional[X]
        return None
    return _coerce(next(a for a in args if a is not _NONE), x, loc, errs)


@dataclasses.dataclass
class FieldInfo:
    annotation: Any
    default: Any = inspect.Parameter.empty

    def is_required(self) -> bool:
        return self.default is inspect.Parameter.empty


class InputModel:
    """A component's input: the fields of its signature, the schema
    registration carries (``model_json_schema``, pydantic's document) and
    the lax validation of a payload (``validate``)."""

    def __init__(self, title: str, fields: dict[str, FieldInfo]):
        self.title = title
        self.model_fields = fields

    def model_json_schema(self) -> dict[str, Any]:
        props, required = {}, []
        for name, f in self.model_fields.items():
            prop = {**_type_schema(f.annotation), "title": name.title().replace("_", " ")}
            if f.is_required():
                required.append(name)
            else:
                prop["default"] = _jsonable(f.default)
            props[name] = prop
        doc: dict[str, Any] = {"properties": props}
        if required:
            doc["required"] = required
        doc.update(title=self.title, type="object")
        return _sorted_schema(doc)

    def validate(self, payload: dict[str, Any]) -> dict[str, Any]:
        """The keyword arguments for ``payload``: each field coerced, a
        missing one defaulted (a copy of its default); unknown keys are
        ignored. Raises ValidationError listing every failure."""
        out, errs = {}, []
        for name, f in self.model_fields.items():
            if name in payload:
                out[name] = _coerce(f.annotation, payload[name], (name,), errs)
            elif f.is_required():
                errs.append({"type": "missing", "loc": (name,), "msg": "Field required",
                             "input": payload})
            else:
                out[name] = copy.deepcopy(f.default)
        if errs:
            raise ValidationError(self.title, errs)
        return out


def _schema_from_signature(fn: Callable) -> tuple[InputModel, dict, list[str]]:
    """Synthesize the input model from the function signature
    (reference builds InputSchema the same way, agent.py:1150-1162).
    Parameters named ctx/context receive the current ExecutionContext at
    invocation instead of appearing in the schema."""
    try:
        hints = typing.get_type_hints(fn)
    except Exception:  # noqa: BLE001 — unresolvable names: the raw annotations
        hints = {}
    fields: dict[str, FieldInfo] = {}
    ctx_params: list[str] = []
    for name, p in inspect.signature(fn).parameters.items():
        if name == "self":
            continue
        if name in ("ctx", "context"):
            ctx_params.append(name)
            continue
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            raise TypeError(f"{fn.__name__}: *{name} has no place in a component's input schema")
        ann = hints.get(name, p.annotation)
        ann = Any if ann is inspect.Parameter.empty else ann
        _check_annotation(ann, f"{fn.__name__}({name})")
        fields[name] = FieldInfo(ann, p.default)
    model = InputModel(f"{fn.__name__}_Input", fields)
    return model, model.model_json_schema(), ctx_params


@dataclasses.dataclass(frozen=True)
class AIConfig:
    """Default ai() parameters, merged hierarchically: agent-level <
    reasoner-level < explicit call-site arguments (reference AIConfig merge,
    agent_ai.py:189-215). None fields are "unset" and defer to the next
    level down; unset everywhere falls back to ai()'s builtin defaults."""

    model: str | None = None
    max_new_tokens: int | None = None
    temperature: float | None = None
    top_k: int | None = None
    top_p: float | None = None
    stop_token_ids: tuple[int, ...] | None = None
    timeout: float | None = None
    context_overflow: str | None = None
    output: str | None = None

    def overrides(self) -> dict[str, Any]:
        return {
            k: v for k, v in dataclasses.asdict(self).items() if v is not None
        }


def _norm_ai_defaults(v: "AIConfig | dict | None", where: str) -> "AIConfig | None":
    if v is None or isinstance(v, AIConfig):
        return v
    if isinstance(v, dict):
        known = {f.name for f in dataclasses.fields(AIConfig)}
        bad = set(v) - known
        if bad:
            raise ValueError(
                f"{where}: unknown ai_defaults keys {sorted(bad)}; "
                f"known: {sorted(known)}"
            )
        return AIConfig(**v)
    raise TypeError(f"{where}: ai_defaults must be AIConfig or dict, got {type(v).__name__}")


# The component currently executing on this task (set around dispatch) —
# how ai() finds the reasoner-level AIConfig without threading it through
# every call site.
_current_component: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "agentfield_current_component", default=None
)


class ComponentDef:
    def __init__(
        self, id: str, kind: str, fn: Callable, description: str,
        ai_defaults: "AIConfig | dict | None" = None,
    ):
        self.id = id
        self.kind = kind  # "reasoner" | "skill"
        self.fn = fn
        self.description = description
        self.ai_defaults = _norm_ai_defaults(ai_defaults, f"{kind} {id!r}")
        self.input_model, self.input_schema, self.ctx_params = _schema_from_signature(fn)
        self._passthrough = False

    @classmethod
    def passthrough(
        cls, id: str, kind: str, handler: Callable, description: str, input_schema: dict
    ) -> "ComponentDef":
        """Component with an externally-supplied JSON schema whose handler
        receives the raw payload dict (MCP tools: the server owns validation)."""
        comp = object.__new__(cls)
        comp.id = id
        comp.kind = kind
        comp.fn = handler
        comp.description = description
        comp.ai_defaults = None
        comp.input_model = None
        comp.input_schema = input_schema
        comp.ctx_params = []
        comp._passthrough = True
        return comp

    async def invoke(self, payload: Any, ctx: "ExecutionContext | None" = None) -> Any:
        if self._passthrough:
            if payload is not None and not isinstance(payload, dict):
                raise TypeError(
                    f"{self.id}: payload must be a JSON object of tool arguments, "
                    f"got {type(payload).__name__}"
                )
            result = self.fn(payload or {})
            if inspect.isawaitable(result):
                result = await result
            return result
        if isinstance(payload, dict):
            kwargs = self.input_model.validate(payload)
        elif payload is None:
            kwargs = self.input_model.validate({})
        else:
            required = [
                n for n, f in self.input_model.model_fields.items() if f.is_required()
            ]
            if len(required) != 1:
                raise TypeError(
                    f"{self.id} expects keyword arguments {list(self.input_model.model_fields)}"
                )
            kwargs = self.input_model.validate({required[0]: payload})
        for name in self.ctx_params:
            kwargs[name] = ctx
        result = self.fn(**kwargs)
        if inspect.isawaitable(result):
            result = await result
        return result


class AgentRouter:
    """Composable component group attached via include_router (reference:
    sdk/python/agentfield/router.py:13 + agent.py:2042 — prefixing semantics)."""

    def __init__(self, prefix: str = ""):
        self.prefix = prefix.strip("_")
        self.components: list[ComponentDef] = []

    def reasoner(self, id: str | None = None, description: str = "", ai_defaults=None):
        return self._decorator("reasoner", id, description, ai_defaults)

    def skill(self, id: str | None = None, description: str = "", ai_defaults=None):
        return self._decorator("skill", id, description, ai_defaults)

    def _decorator(self, kind: str, id: str | None, description: str, ai_defaults=None):
        def deco(fn):
            cid = id or fn.__name__
            if self.prefix:
                cid = f"{self.prefix}_{cid}"
            self.components.append(
                ComponentDef(cid, kind, fn, description or (fn.__doc__ or ""),
                             ai_defaults=ai_defaults)
            )
            return fn

        return deco


class Agent:
    def __init__(
        self,
        node_id: str,
        control_plane: str = DEFAULT_CONTROL_PLANE,
        host: str = "127.0.0.1",
        port: int = 0,  # 0 → auto-assign (reference AGENTFIELD_AUTO_PORT)
        kind: str = "agent",
        heartbeat_interval: float = 2.0,  # reference enhanced-heartbeat cadence
        metadata: dict | None = None,
        ai_defaults: "AIConfig | dict | None" = None,  # agent-level ai()
        # defaults; per-reasoner ai_defaults= and explicit call arguments
        # override field-by-field (reference agent_ai.py:189-215)
        channel: bool = True,  # serve the persistent gateway↔node channel
        # (GET /channel, advertised via metadata.channel): the gateway
        # multiplexes executions over ONE WebSocket instead of a POST per
        # request, and token-streaming components (model nodes) stream
        # end-to-end. False → per-execution POSTs only, the pre-channel
        # wire behavior (docs/ARCHITECTURE.md data plane).
    ):
        if "." in node_id:
            raise ValueError("node_id must not contain '.'")
        self.ai_defaults = _norm_ai_defaults(ai_defaults, f"Agent {node_id!r}")
        self.node_id = node_id
        self.kind = kind
        self.host = host
        self.port = port
        self.metadata = metadata or {}
        self.channel_server = None
        if channel:
            from agentfield_tpu_torch.control_plane.channel import ChannelServer

            self.channel_server = ChannelServer(invoke=self._channel_invoke)
            self.metadata.setdefault("channel", True)
        self.heartbeat_interval = heartbeat_interval
        self.client = ControlPlaneClient(control_plane)
        self.components: dict[str, ComponentDef] = {}
        self.mcp = None  # set via attach_mcp()
        self.extra_routes: list[tuple[str, str, Any]] = []  # (method, path, handler)
        self._runner: http.AppRunner | None = None
        self._hb_task: asyncio.Task | None = None
        self._pending: set[asyncio.Task] = set()
        self._reconnect_cbs: list[Any] = []

    # -- decorators -----------------------------------------------------

    def reasoner(self, id: str | None = None, description: str = "", ai_defaults=None):
        return self._decorator("reasoner", id, description, ai_defaults)

    def skill(self, id: str | None = None, description: str = "", ai_defaults=None):
        return self._decorator("skill", id, description, ai_defaults)

    def _decorator(self, kind: str, id: str | None, description: str, ai_defaults=None):
        def deco(fn):
            comp = ComponentDef(
                id or fn.__name__, kind, fn, description or (fn.__doc__ or ""),
                ai_defaults=ai_defaults,
            )
            self._add_component(comp)
            return fn

        return deco

    def _add_component(self, comp: ComponentDef) -> None:
        if comp.id in self.components:
            raise ValueError(f"duplicate component id {comp.id!r}")
        self.components[comp.id] = comp

    def include_router(self, router: AgentRouter) -> None:
        for comp in router.components:
            self._add_component(comp)

    def attach_mcp(self, manager) -> list[str]:
        """Register a started MCPManager's tools as skills and surface its
        health through /health."""
        self.mcp = manager
        return manager.attach_to_agent(self)

    # -- HTTP surface ---------------------------------------------------

    def _build_app(self) -> http.Application:
        app = http.Application()

        async def handle(req: http.Request) -> http.Response:
            comp = self.components.get(req.match_info["cid"])
            kind = "reasoner" if req.path.startswith("/reasoners/") else "skill"
            if comp is None or comp.kind != kind:
                return http.json_response({"error": "unknown component"}, status=404)
            try:
                body = await req.json() if req.can_read_body else {}
            except Exception:
                return http.json_response({"error": "invalid JSON"}, status=400)
            if not isinstance(body, dict):
                return http.json_response({"error": "JSON object body required"}, status=400)
            payload = body.get("input")
            ctx = ExecutionContext.from_headers(req.headers)
            if ctx is None:
                # Direct invocation (no gateway execution id): run inline.
                try:
                    result = await self._run(comp, payload, ExecutionContext.new_root())
                except ValidationError as e:
                    return http.json_response({"error": str(e)}, status=422)
                except Exception as e:
                    return http.json_response({"error": repr(e)}, status=500)
                return http.json_response({"result": result})
            # Gateway-tracked: ack 202, execute in background, call back
            # (reference: agent.py:1182-1197 + _execute_async_with_callback).
            task = asyncio.create_task(self._run_tracked(comp, payload, ctx))
            self._pending.add(task)
            task.add_done_callback(self._pending.discard)
            return http.Response(status=202)

        async def health(_req):
            doc = {
                "status": "ok",
                "node_id": self.node_id,
                # control-plane link state (reference: ConnectionManager's
                # degraded-mode flag, connection_manager.py) — the agent
                # keeps serving locally even while the link is down
                "control_plane": self.connection_state,
            }
            if self.mcp is not None:
                doc["mcp"] = self.mcp.health()  # aggregated by the control
                # plane's HealthMonitor (reference: checkMCPHealthForNode)
            return http.json_response(doc)

        async def list_components(req: http.Request):
            kind = "reasoner" if req.path == "/reasoners" else "skill"
            return http.json_response(
                {
                    kind + "s": [
                        {"id": c.id, "description": c.description, "input_schema": c.input_schema}
                        for c in self.components.values()
                        if c.kind == kind
                    ]
                }
            )

        app.router.add_route("POST", "/reasoners/{cid}", handle)
        app.router.add_route("POST", "/skills/{cid}", handle)
        app.router.add_route("GET", "/health", health)
        app.router.add_route("GET", "/reasoners", list_components)
        app.router.add_route("GET", "/skills", list_components)
        if self.channel_server is not None:
            app.router.add_route("GET", "/channel", self.channel_server.handler)
        for method, path, handler in self.extra_routes:
            app.router.add_route(method, path, handler)
        return app

    def add_route(self, method: str, path: str, handler) -> None:
        """Attach a raw ``http`` route (e.g. the model node's token-stream
        endpoint). Must be called before start()."""
        self.extra_routes.append((method, path, handler))

    async def _channel_invoke(
        self, comp_id: str, payload: Any, headers: dict[str, str]
    ) -> Any:
        """Channel-submitted execution: same component dispatch as the POST
        handler, but the result rides back as a terminal frame instead of a
        status callback — one hop fewer, same DAG context propagation.
        Exceptions become terminal `failed` frames at the channel server
        (mirroring _run_tracked's repr(e) callbacks)."""
        comp = self.components.get(comp_id)
        if comp is None:
            raise LookupError(f"unknown component {comp_id!r}")
        ctx = ExecutionContext.from_headers(headers) or ExecutionContext.new_root()
        return await self._run(comp, payload, ctx)

    def channel_stream(self, comp_id: str, fn) -> None:
        """Register a token-streaming channel handler for a component (the
        model node registers `generate`); `fn(payload, headers, emit)`
        returns the final result after awaiting `emit(frame)` per token."""
        if self.channel_server is None:
            raise RuntimeError("channel disabled on this agent")
        self.channel_server.stream_handler(comp_id, fn)

    async def _run(self, comp: ComponentDef, payload: Any, ctx: ExecutionContext) -> Any:
        token = set_context(ctx)
        ctoken = _current_component.set(comp.id)
        try:
            return await comp.invoke(payload, ctx)
        finally:
            _current_component.reset(ctoken)
            reset_context(token)

    async def _run_tracked(self, comp: ComponentDef, payload: Any, ctx: ExecutionContext) -> None:
        try:
            result = await self._run(comp, payload, ctx)
            json.dumps(result)  # fail fast: an unserializable result must
            # surface as a failed execution, not a stranded-until-stale one
        except Exception as e:
            await self._safe_status(ctx.execution_id, "failed", error=repr(e))
        else:
            await self._safe_status(ctx.execution_id, "completed", result=result)

    async def _safe_status(self, execution_id: str, status: str, **kw) -> None:
        try:
            await self.client.post_status(execution_id, status, **kw)
        except Exception as e:
            # Control plane unreachable; the execution will be marked stale
            # by its cleanup — leave the operator a trace of the lost ack.
            log.debug(
                "status callback failed",
                execution_id=execution_id, status=status, error=repr(e),
            )

    # -- outbound: call() and ai() -------------------------------------

    def _outbound_ctx(self) -> ExecutionContext:
        ctx = current_context()
        return ctx.child() if ctx else ExecutionContext.new_root()

    async def call(self, target: str, _payload: Any = None, **kwargs) -> Any:
        """Cross-agent invocation through the gateway with DAG linkage
        (reference: Agent.call, agent.py:2472)."""
        payload = _payload if _payload is not None else (kwargs or None)
        doc = await self.client.execute(target, payload, headers=self._outbound_ctx().to_headers())
        if doc["status"] != "completed":
            raise RuntimeError(f"call {target} {doc['status']}: {doc.get('error')}")
        return doc["result"]

    async def _resolve_model_node(self, model: str | None) -> dict[str, Any]:
        return (await self._model_candidates(model))[0]

    async def _model_candidates(
        self, model: str | None, need: set[str] | None = None
    ) -> list[dict[str, Any]]:
        """Failover set: the named node alone, or every active model node in
        registration order (the reference's fallback chain iterates provider
        models, agent_ai.py:345-384 — here the units of failure are nodes).

        With `need` (required modalities, e.g. {"audio-out"}), nodes whose
        metadata advertises them come FIRST — in a mixed cluster a TTS/image
        request must not land on a node without the head. Nodes that
        advertise no modality list (older registrations) keep their place
        after advertising ones: unknown ≠ incapable, so failover still
        reaches them."""
        nodes = await self.client.list_nodes()
        if model is not None:
            for n in nodes:
                if n["node_id"] == model:
                    return [n]
            raise RuntimeError(f"model node {model!r} not registered")
        candidates = [n for n in nodes if n.get("kind") == "model" and n["status"] == "active"]
        if not candidates:
            raise RuntimeError("no active model node registered")
        if need:
            def rank(n: dict[str, Any]) -> int:
                mods = (n.get("metadata") or {}).get("modalities")
                if mods is None:
                    return 1  # unknown: after advertisers, before refusers
                return 0 if need.issubset(mods) else 2
            candidates.sort(key=rank)  # stable: registration order within rank
        return candidates

    _AI_BUILTIN = {
        "model": None, "max_new_tokens": 128, "temperature": 0.0,
        "top_k": 0, "top_p": 1.0, "stop_token_ids": None, "timeout": 600.0,
        "context_overflow": "truncate_left", "output": "text",
    }

    def _resolve_ai_params(self, explicit: dict[str, Any]) -> dict[str, Any]:
        """builtin < agent ai_defaults < executing reasoner's ai_defaults <
        explicit (non-None) call arguments — reference agent_ai.py:189-215."""
        merged = dict(self._AI_BUILTIN)
        if self.ai_defaults is not None:
            merged.update(self.ai_defaults.overrides())
        cid = _current_component.get()
        comp = self.components.get(cid) if cid else None
        if comp is not None and comp.ai_defaults is not None:
            merged.update(comp.ai_defaults.overrides())
        merged.update({k: v for k, v in explicit.items() if v is not None})
        if merged["stop_token_ids"] is not None:
            merged["stop_token_ids"] = list(merged["stop_token_ids"])
        return merged

    @staticmethod
    def _doc_node_down(doc: dict[str, Any]) -> bool:
        """Structured node-down detection, shared by every model-failover
        path (ai(), ai_embed): the transport layer records a synthesized
        ``status: node_down``, and a FAILED execution whose error names a
        gateway-level delivery failure (unreachable / vanished mid-call /
        5xx) means the node, not the request, is the problem — fail over.
        Deterministic request errors (bad pooling, empty input, schema
        violations) never match: replaying those cluster-wide is useless."""
        if doc.get("status") == "node_down":
            return True
        # dead_letter = the GATEWAY already retried node-level failures to
        # budget exhaustion on our behalf — by definition a node problem.
        if doc.get("status") == "dead_letter":
            return True
        if doc.get("status") != "failed":
            return False
        err = str(doc.get("error") or "")
        return (
            "agent call failed" in err
            or "vanished" in err
            or "agent returned 5" in err
        )

    async def ai(
        self,
        prompt: str | None = None,
        tokens: list[int] | None = None,
        model: str | None = None,
        max_new_tokens: int | None = None,
        temperature: float | None = None,
        top_k: int | None = None,
        top_p: float | None = None,
        stop_token_ids: list[int] | None = None,
        timeout: float | None = None,
        schema: dict[str, Any] | None = None,
        context_overflow: str | None = None,
        images: list[Any] | None = None,
        audio: list[Any] | None = None,
        files: list[Any] | None = None,
        output: str | None = None,
        messages: list[dict[str, str]] | None = None,  # chat form
        # ([{role, content}]): the MODEL NODE applies its tokenizer's chat
        # template (reference CompleteWithMessages, sdk/go/ai/client.go:61).
        # Exclusive with prompt/tokens; media markers inside message content
        # still fuse.
        priority: int = 0,  # overload control (docs/FAULT_TOLERANCE.md):
        # rides the execute body through the gateway to the model node's
        # admission window — higher admits first under load, and a starved
        # higher-priority request may preempt a lower-priority slot.
        deadline_s: float | None = None,  # wall-clock budget from submit;
        # the gateway sheds the call (TIMEOUT) if it expires pre-dispatch
        # and forwards the REMAINING budget to the engine.
        n_branches: int = 1,  # test-time scaling (docs/PREFIX_CACHING.md
        # "Fork / COW branches"): the ENGINE forks the request's KV after
        # one prefill into this many branches, decodes them as batch-mates,
        # prunes per branch_policy, and returns only the winner — the
        # result gains a "branches" summary block. Text-only.
        branch_policy: Any = None,  # "best_of_n" (default) | "beam" | a
        # {"type", "verifier", "beam_width", "beam_interval"} object; a
        # "verifier" names a reasoner target the node dispatches candidate
        # texts to (through the gateway) instead of scoring by logprob sum.
        expect_followup: bool = False,  # agent-aware serving (docs/
        # OPERATIONS.md "Agent-aware serving"): declare that this session
        # will be hit again right after this call (a tool-call loop) — the
        # serving node pins the session's KV warm instead of racing its
        # TTL. The gateway also INFERS this for non-root steps of a
        # session-carrying chain; the explicit flag covers roots and
        # out-of-band callers. A latency hint only: results are identical.
        followup_candidates: list[str] | None = None,  # candidate next-step
        # texts (e.g. likely tool results rendered into the next prompt's
        # suffix) the node may speculatively prefill while the tool runs —
        # the real follow-up then pays TTFT only for what diverges.
        # Requires expect_followup; invalid entries are dropped, never
        # errors. Text-only.
        stream: bool = False,  # token streaming THROUGH the gateway: returns
        # an async iterator of frames instead of the result dict — token
        # frames from TTFT, then one {"terminal": True, "result": ...} frame.
        # Unlike ai_stream() (which bypasses the control plane and hits the
        # node directly), this path keeps gateway retry/failover, DAG
        # tracking, and the recorded execution row. Text-only.
    ) -> dict[str, Any]:
        """LLM call served by an in-tree model node (replaces the
        reference's litellm path, agent_ai.py:95-447). Placement v0: first
        active model node (or `model` node id, used directly — the gateway
        validates it), with node-down failover across the remaining active
        model nodes.

        `context_overflow` defaults to "truncate_left" — over-long prompts
        keep their most recent tokens, mirroring the reference's token-aware
        trimming (agent_ai.py:262-325); pass "error" for a hard
        RequestTooLongError instead. A truncated call reports
        `truncated_prompt_tokens` in its result.

        With `schema` (a JSON schema), decoding is CONSTRAINED on the model
        node: the schema compiles to a token-level DFA whose mask makes
        invalid tokens unsampleable (serving/grammar.py), so the decoded text
        is schema-valid JSON by construction — no regex salvage (the
        reference's failure mode, agent_ai.py:424-447). The prompt still
        gains a strict-JSON instruction (steers content quality; correctness
        comes from the mask), and the result dict gains a "parsed" key.

        Parameters left at None resolve through the config hierarchy:
        agent-level ``Agent(ai_defaults=...)`` < the executing reasoner's
        ``@app.reasoner(ai_defaults=...)`` < explicit arguments here.

        ``files`` takes text-like attachments (paths, bytes, FileContent,
        or {"b64"/"path", "name", "mime"} dicts): their text inlines into
        the prompt as fenced blocks; binary files raise
        UnsupportedModalityError naming the supported routes."""
        p = self._resolve_ai_params({
            "model": model, "max_new_tokens": max_new_tokens,
            "temperature": temperature, "top_k": top_k, "top_p": top_p,
            "stop_token_ids": stop_token_ids, "timeout": timeout,
            "context_overflow": context_overflow, "output": output,
        })
        model = p["model"]
        max_new_tokens, temperature = p["max_new_tokens"], p["temperature"]
        top_k, top_p = p["top_k"], p["top_p"]
        stop_token_ids, timeout = p["stop_token_ids"], p["timeout"]
        context_overflow, output = p["context_overflow"], p["output"]
        if messages is not None:
            if prompt is not None or tokens is not None:
                raise ValueError("messages is exclusive with prompt/tokens")
            if not messages:
                raise ValueError("messages must be non-empty")
            messages = [dict(m) for m in messages]  # appends stay caller-invisible
        if n_branches != 1 and (schema is not None or images or audio or output != "text"):
            raise ValueError(
                "ai(n_branches=...) is text-only branch decoding; schema/"
                "media/output modes use an unbranched call"
            )
        if stream:
            if schema is not None or images or audio or files or output != "text":
                raise ValueError(
                    "ai(stream=True) is text-only token streaming; schema/"
                    "media/output modes use the unary ai() path"
                )
            return self._ai_stream_frames(
                prompt=prompt, tokens=tokens, messages=messages, model=model,
                max_new_tokens=max_new_tokens, temperature=temperature,
                top_k=top_k, top_p=top_p, stop_token_ids=stop_token_ids,
                timeout=timeout, priority=priority, deadline_s=deadline_s,
                n_branches=n_branches, branch_policy=branch_policy,
                expect_followup=expect_followup,
                followup_candidates=followup_candidates,
            )

        def _carrier_text() -> str | None:
            """The text the markers/instructions live in: the prompt, or the
            concatenated chat contents."""
            if messages is not None:
                return "\n".join(str(m.get("content", "")) for m in messages)
            return prompt

        def _carrier_append(text: str) -> None:
            """Append to the prompt, or to the LAST chat message's content
            (file blocks, missing media markers, the schema instruction)."""
            nonlocal prompt, messages
            if messages is not None:
                messages[-1]["content"] = str(messages[-1].get("content", "")) + text
            else:
                prompt = (prompt or "") + text

        if files:
            if tokens is not None:
                # _submit generates from `tokens` and ignores `prompt`; the
                # inlined file text would silently vanish (same contract as
                # the media-vs-tokens rejection on the model node)
                raise ValueError("files require a text 'prompt', not 'tokens'")
            from agentfield_tpu_torch.sdk.multimodal import file_prompt_block

            blocks = [file_prompt_block(f) for f in _normalize_files(files)]
            if messages is None and prompt is None:
                prompt = "\n".join(blocks)
            else:
                _carrier_append("\n" + "\n".join(blocks))
        if images:
            if _carrier_text() is None:
                raise ValueError("images require a text prompt (or messages)")
            images = _normalize_images(images)
            # Each image needs an <image> marker in the prompt/chat; unmarked
            # images append at the end (reference: image parts are appended
            # in argument order, agent_ai.py:449).
            have = _carrier_text().count("<image>")
            missing = len(images) - have
            if missing < 0:
                raise ValueError(
                    f"prompt has {have} <image> markers "
                    f"but only {len(images)} images were passed"
                )
            if missing:
                _carrier_append("\n<image>" * missing)
        if audio:
            if _carrier_text() is None:
                raise ValueError("audio inputs require a text prompt (or messages)")
            audio = _normalize_audio(audio)
            have = _carrier_text().count("<audio>")
            missing = len(audio) - have
            if missing < 0:
                raise ValueError(
                    f"prompt has {have} <audio> markers "
                    f"but only {len(audio)} audio parts were passed"
                )
            if missing:
                _carrier_append("\n<audio>" * missing)
        if output not in ("text", "audio", "speech", "image"):
            raise ValueError(
                f"unknown output modality {output!r}: 'text' | 'audio' "
                "(speak the prompt, reference agent_ai.py:750 TTS) | "
                "'speech' (generate text, then speak it — chat-audio) | "
                "'image' (render the prompt, reference agent_ai.py:1004)"
            )
        if output != "text" and schema is not None:
            raise ValueError("schema-constrained decoding is text-only")
        if schema is not None:
            if _carrier_text() is None:
                raise ValueError("schema requires a text prompt (or messages)")
            from agentfield_tpu_torch.sdk.structured import schema_instruction

            # the DFA mask on the node enforces correctness; this steers
            _carrier_append(schema_instruction(schema))
        ctx = current_context()
        payload = {
            "prompt": prompt,
            "tokens": tokens,
            "messages": messages,
            "images": images or None,
            "audios": audio or None,
            "output": output,
            "max_new_tokens": max_new_tokens,
            "temperature": temperature,
            "top_k": top_k,
            "top_p": top_p,
            "stop_token_ids": stop_token_ids or [],
            # Session affinity → model-node prefix-cache reuse across turns.
            "session_id": ctx.session_id if ctx else None,
            "response_schema": schema,
            "context_overflow": context_overflow,
        }
        if expect_followup:
            # Agent-aware serving: generate-input hints (the execute-body
            # flag below drives the gateway; these drive the model node).
            # Omitted entirely when unset — the generate schema's strict
            # bool rejects an explicit null.
            payload["expect_followup"] = True
            if followup_candidates:
                payload["followup_candidates"] = followup_candidates
        # Backpressure retry (the reference's rate limiter plays this role for
        # provider 429s — rate_limiter.py). Engine exhaustion reaches us two
        # ways: HTTP 503 (node inactive / async queue full) OR a FAILED
        # execution whose error names QueueFullError (the model node's
        # generate raised it and reported failure through the callback).
        # Node-down failures (unreachable / 5xx / vanished mid-call) fail over
        # to the next active model node — the reference's fallback-model chain
        # (agent_ai.py:345-384) re-designed for in-tree serving, where the
        # unit of failure is a node, not a provider model.
        need: set[str] = set()
        if images:
            need.add("image-in")
        if audio:
            need.add("audio-in")
        if output in ("audio", "speech"):
            need.add("audio-out")
        elif output == "image":
            need.add("image-out")
        candidates = await self._model_candidates(model, need=need or None)
        node_errors: list[str] = []
        doc: dict[str, Any] = {}
        for ci, cand in enumerate(candidates):
            node_id = cand["node_id"]
            attempts = 0
            while True:
                try:
                    # Fresh execution id per attempt: a failed/retried
                    # execution's id is already recorded, and replaying it
                    # would 409.
                    doc = await self.client.execute(
                        f"{node_id}.generate",
                        payload,
                        headers=self._outbound_ctx().to_headers(),
                        timeout=timeout,
                        priority=priority,
                        deadline_s=deadline_s,
                        n_branches=n_branches,
                        branch_policy=branch_policy,
                        expect_followup=expect_followup,
                    )
                except ControlPlaneError as e:
                    has_next = ci + 1 < len(candidates)
                    msg = str(e)
                    gone = any(
                        s in msg for s in ("is inactive", "is stopping", "is starting")
                    )
                    if e.status in (404, 410) or (e.status == 503 and gone):
                        # Node deregistered or marked inactive at the gateway
                        # — a down NODE, not backpressure: fail over now
                        # (retrying a dead node 5x first would defeat the
                        # failover this path exists for).
                        if has_next:
                            doc = {"status": "node_down", "error": str(e)}
                            break
                        raise
                    # 429 = transient overload with a Retry-After estimate;
                    # 503 = no capacity. Both are backpressure, not a dead
                    # node: retry here with patience.
                    if e.status not in (429, 503) or attempts >= 5:
                        if e.status in (429, 503) and has_next:
                            # persistent backpressure on this node: another
                            # candidate may have capacity
                            doc = {"status": "node_down", "error": str(e)}
                            break
                        raise
                    attempts += 1
                    await asyncio.sleep(_backpressure_delay(attempts, e.retry_after))
                    continue
                err = str(doc.get("error") or "")
                if (
                    # dead_letter: the gateway's own retries saw the same
                    # backpressure — still worth client-side patience
                    doc["status"] in ("failed", "dead_letter")
                    and ("QueueFullError" in err or "queue at capacity" in err)
                    and attempts < 5
                ):
                    attempts += 1
                    await asyncio.sleep(_backpressure_delay(attempts))
                    continue
                break
            if self._doc_node_down(doc) and ci + 1 < len(candidates):
                node_errors.append(f"{node_id}: {doc.get('error')}")
                continue
            break
        if doc.get("status") != "completed":
            detail = f"; failed over from {node_errors}" if node_errors else ""
            raise RuntimeError(f"ai() {doc.get('status')}: {doc.get('error')}{detail}")
        result = doc["result"]
        if schema is not None:
            from agentfield_tpu_torch.sdk.structured import (
                StructuredOutputError,
                parse_structured,
            )

            if result.get("finish_reason") == "length":
                # The mask guarantees a valid *prefix*; only an EOS finish
                # guarantees a complete value.
                raise StructuredOutputError(
                    "constrained generation hit max_new_tokens before the "
                    "value completed — raise max_new_tokens (or bound the "
                    "schema, e.g. maxLength/maxItems)"
                )
            result["parsed"] = parse_structured(result.get("text", ""), schema)
        if isinstance(result, dict) and result.get("parts"):
            from agentfield_tpu_torch.sdk.multimodal import detect_multimodal_response

            return detect_multimodal_response(result)
        return result

    async def _ai_stream_frames(
        self, *, prompt, tokens, messages, model, max_new_tokens, temperature,
        top_k, top_p, stop_token_ids, timeout, priority, deadline_s,
        n_branches=1, branch_policy=None, expect_followup=False,
        followup_candidates=None,
    ):
        """ai(stream=True) driver: token frames through the gateway's
        streaming execute, with node-down failover across model candidates
        — but ONLY while zero token frames have been yielded (a consumer
        that saw tokens must never see them twice; mid-stream loss surfaces
        as the gateway's dead-letter terminal instead)."""
        payload = {
            "prompt": prompt,
            "tokens": tokens,
            "messages": messages,
            "max_new_tokens": max_new_tokens,
            "temperature": temperature,
            "top_k": top_k,
            "top_p": top_p,
            "stop_token_ids": stop_token_ids or [],
            "session_id": (current_context().session_id if current_context() else None),
        }
        if expect_followup:
            payload["expect_followup"] = True
            if followup_candidates:
                payload["followup_candidates"] = followup_candidates
        candidates = await self._model_candidates(model)
        node_errors: list[str] = []
        for ci, cand in enumerate(candidates):
            node_id = cand["node_id"]
            yielded = False
            terminal: dict[str, Any] | None = None
            try:
                async for frame in self.client.execute_stream(
                    f"{node_id}.generate",
                    payload,
                    headers=self._outbound_ctx().to_headers(),
                    timeout=timeout,
                    priority=priority,
                    deadline_s=deadline_s,
                    n_branches=n_branches,
                    branch_policy=branch_policy,
                    expect_followup=expect_followup,
                ):
                    kind = frame.get("kind")
                    if kind == "token":
                        yielded = True
                        yield {
                            "token": frame.get("token"),
                            "index": frame.get("index"),
                            "finished": bool(frame.get("finished")),
                            "finish_reason": frame.get("finish_reason"),
                            "text": frame.get("text"),
                            "logprob": frame.get("logprob"),
                        }
                    elif kind in ("terminal", "dropped"):
                        terminal = frame
                        break
            except (ControlPlaneError, http.ClientError) as e:
                if yielded or ci + 1 >= len(candidates):
                    raise
                node_errors.append(f"{node_id}: {e}")
                continue
            if terminal is None or terminal.get("kind") == "dropped":
                raise RuntimeError(
                    "stream ended without a terminal frame "
                    f"({(terminal or {}).get('error') or 'connection dropped'})"
                )
            if terminal.get("status") == "completed":
                yield {
                    "terminal": True,
                    "finished": True,
                    "status": "completed",
                    "result": terminal.get("result"),
                    "execution_id": terminal.get("execution_id"),
                }
                return
            doc = {"status": terminal.get("status"), "error": terminal.get("error")}
            if not yielded and self._doc_node_down(doc) and ci + 1 < len(candidates):
                node_errors.append(f"{node_id}: {doc.get('error')}")
                continue
            detail = f"; failed over from {node_errors}" if node_errors else ""
            raise RuntimeError(
                f"ai(stream=True) {doc.get('status')}: {doc.get('error')}{detail}"
            )

    async def ai_with_vision(self, prompt: str, image: Any, **kw) -> dict[str, Any]:
        """Image-understanding sugar (reference: ai_with_vision,
        agent_ai.py:1004 — there image *generation* via providers; here the
        served direction is image INPUT through the model node's vision
        tower)."""
        return await self.ai(prompt, images=[image], **kw)

    async def ai_with_multimodal(self, *parts: Any, **kw) -> dict[str, Any]:
        """Mixed-content call (reference: ai_with_multimodal,
        agent_ai.py:1069): args classify in order — text joins the prompt,
        images ride to the vision tower, audio to the audio tower."""
        from agentfield_tpu_torch.sdk.multimodal import split_prompt_and_media

        prompt, images, audios = split_prompt_and_media(list(parts))
        return await self.ai(
            prompt, images=images or None, audio=audios or None, **kw
        )

    async def generate_image(self, prompt: str, **kw) -> dict[str, Any]:
        """Text-to-image sugar (reference: generate_image, agent_ai.py:1004
        forwards to provider image APIs; here the node's in-tree image head
        renders). Returns a MultimodalResponse whose first part is a PNG."""
        kw.setdefault("output", "image")
        return await self.ai(prompt, **kw)

    async def ai_with_audio(
        self, prompt: str, audio: Any = None, **kw
    ) -> dict[str, Any]:
        """Audio sugar (reference: ai_with_audio, agent_ai.py:750). With an
        ``audio`` input the clip is understood through the node's audio tower
        (``<audio>`` early fusion); without one the call is TTS — the node's
        TTS head speaks the generated text (output='speech')."""
        if audio is not None:
            return await self.ai(prompt, audio=[audio], **kw)
        kw.setdefault("output", "speech")
        return await self.ai(prompt, **kw)

    async def ai_embed(
        self,
        prompt: str | None = None,
        tokens: list[int] | None = None,
        model: str | None = None,
        pooling: str = "mean",
        context_overflow: str = "error",
        timeout: float = 600.0,
    ) -> dict[str, Any]:
        """Text → L2-normalized embedding from a model node's LM hidden
        states. The reference cannot embed in-cluster (its memory vector API
        expects provider-produced vectors); here
        ``vector_set(key, (await ai_embed(text))["embedding"])`` →
        ``vector_search`` closes the loop with no external API.

        Failover applies only to TRANSPORT/node-down failures — a
        deterministic request error (bad pooling, empty input) raises
        immediately instead of replaying the doomed request cluster-wide.
        Caveat: vectors from DIFFERENT models are different embedding
        spaces; pin ``model`` (or Agent ai_defaults) when more than one
        model node serves, and never mix models within one vector scope
        (the result's "model" field is there to check)."""
        model = self._resolve_ai_params({"model": model})["model"]
        candidates = await self._model_candidates(model, need=None)
        errors: list[str] = []
        doc: dict[str, Any] = {}
        for ci, cand in enumerate(candidates):
            node_id = cand["node_id"]
            try:
                doc = await self.client.execute(
                    f"{node_id}.embed",
                    {"prompt": prompt, "tokens": tokens, "pooling": pooling,
                     "context_overflow": context_overflow},
                    headers=self._outbound_ctx().to_headers(),
                    timeout=timeout,
                )
            except ControlPlaneError as e:
                if ci + 1 < len(candidates):
                    errors.append(f"{node_id}: {e}")
                    continue
                raise
            if doc.get("status") == "completed":
                return doc["result"]
            if self._doc_node_down(doc) and ci + 1 < len(candidates):
                errors.append(f"{node_id}: {doc.get('error')}")
                continue
            break  # deterministic failure: do not replay cluster-wide
        detail = f"; failed over from {errors}" if errors else ""
        raise RuntimeError(
            f"ai_embed {doc.get('status')}: {doc.get('error')}{detail}"
        )

    async def ai_stream(
        self,
        prompt: str | None = None,
        tokens: list[int] | None = None,
        model: str | None = None,
        max_new_tokens: int | None = None,
        temperature: float | None = None,
        top_k: int | None = None,
        top_p: float | None = None,
        stop_token_ids: list[int] | None = None,
        timeout: float | None = None,
        messages: list[dict[str, str]] | None = None,  # chat form (the node
        # applies its tokenizer's chat template, as in ai())
    ):
        """Token-streaming LLM call: SSE straight from the model node (data
        plane), with DAG visibility via workflow lifecycle events. Yields
        {"token", "index", "finished", "finish_reason", "text"?} frames.

        Early exit: a consumer that `break`s out is recorded as a *completed*
        execution with finish_reason "client_stopped". Note that generator
        finalization after `break` is deferred to GC unless you iterate under
        ``contextlib.aclosing(...)`` — use that for deterministic DAG events."""
        # same defaults hierarchy as ai(): agent < reasoner < explicit args
        rp = self._resolve_ai_params({
            "model": model, "max_new_tokens": max_new_tokens,
            "temperature": temperature, "top_k": top_k, "top_p": top_p,
            "stop_token_ids": stop_token_ids, "timeout": timeout,
        })
        model = rp["model"]
        max_new_tokens, temperature = rp["max_new_tokens"], rp["temperature"]
        top_k, top_p = rp["top_k"], rp["top_p"]
        stop_token_ids, timeout = rp["stop_token_ids"], rp["timeout"]
        if messages is not None:
            if prompt is not None or tokens is not None:
                raise ValueError("messages is exclusive with prompt/tokens")
            if not messages:
                raise ValueError("messages must be non-empty")
        node = await self._resolve_model_node(model)
        ctx = self._outbound_ctx()
        base = {
            "event": "start",
            "execution_id": ctx.execution_id,
            "run_id": ctx.run_id,
            "parent_execution_id": ctx.parent_execution_id,
            "target": f"{node['node_id']}.generate",
            "input": {
                "prompt": prompt, "messages": messages,
                "max_new_tokens": max_new_tokens, "stream": True,
            },
        }
        try:
            await self.client.post_workflow_event(base)
        except Exception as e:
            # tracking is best-effort; the stream itself must not fail
            log.debug("workflow start event failed", error=repr(e))
        payload = {
            "prompt": prompt,
            "tokens": tokens,
            "messages": messages,
            "max_new_tokens": max_new_tokens,
            "temperature": temperature,
            "top_k": top_k,
            "top_p": top_p,
            "stop_token_ids": stop_token_ids or [],
            "session_id": ctx.session_id,
        }
        collected: list[int] = []
        finish_reason = None
        failed = False
        try:
            async with http.ClientSession(
                timeout=http.ClientTimeout(total=timeout)
            ) as s:
                async with s.post(
                    f"{node['base_url'].rstrip('/')}/generate/stream", json=payload
                ) as resp:
                    if resp.status != 200:
                        failed = True
                        err = (await resp.text())[:300]
                        raise RuntimeError(f"stream failed [{resp.status}]: {err}")
                    async for line in resp.content:
                        if not line.startswith(b"data: "):
                            continue
                        frame = json.loads(line[6:])
                        collected.append(frame["token"])
                        finish_reason = frame.get("finish_reason")
                        yield frame
                        if frame.get("finished"):
                            break
        except BaseException:
            failed = failed or finish_reason is None and collected == []
            raise
        finally:
            # A consumer break is a legitimate completion ("client_stopped");
            # only genuine transport/model failures record an error event.
            done = dict(base)
            if failed:
                done["event"] = "error"
                done["error"] = "stream aborted"
            else:
                done["event"] = "complete"
            done["result"] = {
                "tokens": collected,
                "finish_reason": finish_reason or "client_stopped",
            }
            try:
                await self.client.post_workflow_event(done)
            except Exception as e:
                # best-effort tracking, same contract as the start event
                log.debug("workflow done event failed", error=repr(e))

    async def handle_serverless(self, event: dict[str, Any]) -> dict[str, Any]:
        """Process one invocation without a long-lived HTTP server (reference:
        Agent.handle_serverless, agent.py:566 — the Lambda-style entrypoint;
        the control plane registers such nodes with kind='serverless' and the
        platform's URL as base_url). Event shape:
        {"component": "<id>", "input": ..., "headers": {X-* context}}."""
        comp = self.components.get(event.get("component", ""))
        if comp is None:
            return {"status": "failed", "error": f"unknown component {event.get('component')!r}"}
        ctx = ExecutionContext.from_headers(event.get("headers", {})) or ExecutionContext.new_root()
        try:
            result = await self._run(comp, event.get("input"), ctx)
            json.dumps(result)
        except Exception as e:
            return {"status": "failed", "error": repr(e), "execution_id": ctx.execution_id}
        return {"status": "completed", "result": result, "execution_id": ctx.execution_id}

    async def note(self, note: Any, actor: str | None = None) -> None:
        """Attach a note to the current execution (reference: Agent.note,
        agent.py:2804 → execution notes API). No-op outside an execution."""
        ctx = current_context()
        if ctx is None:
            return
        try:
            await self.client.add_note(ctx.execution_id, note, actor or self.node_id)
        except Exception as e:
            # notes are advisory; never fail the reasoner over one
            log.debug(
                "note delivery failed",
                execution_id=ctx.execution_id, error=repr(e),
            )

    # -- memory façade --------------------------------------------------

    @property
    def memory(self) -> ControlPlaneClient:
        """Scoped memory API (reference: Agent.memory, agent.py:750)."""
        return self.client

    # -- lifecycle ------------------------------------------------------

    def _callback_candidates(self) -> list[str]:
        """Candidate callback URLs in preference order, mirroring the
        reference's container-IP cooperation (sdk agent.py:66-303 detects
        candidates; the control plane probes them, nodes.go:205-276):
        explicit env override > bound host > detected outbound IP >
        hostname > loopback."""
        import os
        import socket

        out: list[str] = []

        def add(url: str | None) -> None:
            if url and url not in out:
                out.append(url)

        add(os.environ.get("AGENT_CALLBACK_URL"))
        if self.host not in ("0.0.0.0", "::", ""):
            add(f"http://{self.host}:{self.port}")
        try:
            # UDP connect never sends a packet; it just resolves the route,
            # yielding the address a remote control plane could reach us on.
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
                s.connect(("10.255.255.255", 1))
                add(f"http://{s.getsockname()[0]}:{self.port}")
        except OSError:
            pass
        try:
            add(f"http://{socket.gethostbyname(socket.gethostname())}:{self.port}")
        except OSError:
            pass
        add(f"http://127.0.0.1:{self.port}")
        return out

    def _node_spec(self) -> dict[str, Any]:
        return {
            "node_id": self.node_id,
            "base_url": f"http://{self.host}:{self.port}",
            "callback_candidates": self._callback_candidates(),
            "kind": self.kind,
            "metadata": self.metadata,
            "reasoners": [
                {"id": c.id, "description": c.description, "input_schema": c.input_schema}
                for c in self.components.values()
                if c.kind == "reasoner"
            ],
            "skills": [
                {"id": c.id, "description": c.description, "input_schema": c.input_schema}
                for c in self.components.values()
                if c.kind == "skill"
            ],
        }

    async def start(self) -> None:
        """Start the HTTP server, register, begin heartbeating."""
        self._runner = http.AppRunner(self._build_app())
        await self._runner.setup()
        # Bind port 0 directly and read back the kernel-assigned port — no
        # probe-close-rebind TOCTOU race.
        site = http.TCPSite(self._runner, self.host, self.port)
        await site.start()
        if self.port == 0:
            self.port = self._runner.addresses[0][1]
        await self.client.register_node(self._node_spec())
        self._hb_task = asyncio.create_task(self._heartbeat_loop())

    async def stop(self) -> None:
        if self._hb_task:
            self._hb_task.cancel()
            await asyncio.gather(self._hb_task, return_exceptions=True)
        if self._pending:
            await asyncio.gather(*self._pending, return_exceptions=True)
        try:
            await self.client.heartbeat(self.node_id, status="stopping")
        # afcheck: ignore[except-swallow] shutdown courtesy beat; the plane may already be gone and the lease sweep covers us
        except Exception:
            pass
        if self.channel_server is not None:
            await self.channel_server.close()
        if self._runner:
            await self._runner.cleanup()
        await self.client.close()

    # Optional provider of live stats shipped with each heartbeat (model
    # nodes set this to their engine counters).
    heartbeat_stats: Any = None  # callable -> dict | None
    # Link-state machine (reference: ConnectionManager, connection_manager.py
    # :197 — background reconnect loop + degraded-mode flag): "connected" |
    # "degraded" (heartbeats failing, local serving continues) — transitions
    # are driven by the heartbeat loop; on_reconnect callbacks fire when the
    # link heals after a degraded stretch.
    connection_state: str = "connected"
    _DEGRADED_AFTER = 3  # consecutive heartbeat failures

    def on_reconnect(self, cb) -> None:
        """Register a callback (sync or async, no args) fired after the
        control-plane link recovers from a degraded stretch."""
        self._reconnect_cbs.append(cb)

    def _fire_reconnect(self) -> None:
        """Run observers off the heartbeat loop — a slow callback must never
        stall heartbeating (the node would flap dead again immediately)."""

        async def run() -> None:
            for cb in self._reconnect_cbs:
                try:
                    r = cb()
                    if inspect.isawaitable(r):
                        await r
                except Exception as e:
                    # observer errors must not break heartbeating
                    log.debug(
                        "reconnect observer failed",
                        observer=getattr(cb, "__name__", repr(cb)),
                        error=repr(e),
                    )

        task = asyncio.create_task(run())
        self._pending.add(task)
        task.add_done_callback(self._pending.discard)

    async def _heartbeat_loop(self) -> None:
        failures = 0
        while True:
            await asyncio.sleep(self.heartbeat_interval)
            # A broken stats provider must degrade to a stats-less heartbeat,
            # never suppress the heartbeat itself (the node would be marked
            # dead while perfectly healthy).
            stats = None
            try:
                if callable(self.heartbeat_stats):
                    stats = self.heartbeat_stats()
            except Exception as e:
                log.debug("heartbeat stats provider failed", error=repr(e))
            try:
                await self.client.heartbeat(self.node_id, stats=stats)
            except ControlPlaneError as e:
                failures += 1
                if e.status == 404:  # control plane restarted: re-register
                    try:
                        await self.client.register_node(self._node_spec())
                    except Exception as re_err:
                        # next heartbeat retries; keep the failure visible
                        log.debug(
                            "re-registration after 404 failed",
                            node_id=self.node_id, error=repr(re_err),
                        )
                    else:
                        # The node is live on the fresh plane NOW — that is
                        # the recovery, not the next heartbeat. A 404 proves
                        # the plane lost our registration (restart), so
                        # observers resync even if we never went degraded
                        # (fast restart between two heartbeats).
                        failures = 0
                        self.connection_state = "connected"
                        self._fire_reconnect()
            except Exception:
                failures += 1  # transient; keep heartbeating
            else:
                if self.connection_state == "degraded":
                    self.connection_state = "connected"
                    # a proxy blip heals silently (no 404) — observers still
                    # hear about the recovery
                    self._fire_reconnect()
                failures = 0
            if failures >= self._DEGRADED_AFTER:
                self.connection_state = "degraded"

    def serve(self) -> None:
        """Blocking entrypoint for standalone agent processes. Registration
        retries with backoff — a control plane that is still booting (or
        briefly down) must not kill the agent (reference: ConnectionManager
        retry loop, connection_manager.py:197)."""

        requested_port = self.port  # 0 → re-draw a fresh port on every retry

        async def main():
            delay = 1.0
            while True:
                try:
                    await self.start()
                    break
                except (ControlPlaneError, http.ClientError, ConnectionError, OSError) as e:
                    # Retry only genuinely transient conditions. A 4xx from
                    # registration is a config error; EADDRINUSE on a FIXED
                    # port won't heal (port 0 re-draws, so that retries fine).
                    # Order matters: http.ClientError (network to the
                    # control plane, incl. ClientConnectorError which IS an
                    # OSError but not a ConnectionError) must retry.
                    if isinstance(e, ControlPlaneError) and e.status < 500:
                        raise
                    if (
                        not isinstance(e, (http.ClientError, ConnectionError))
                        and isinstance(e, OSError)
                        and requested_port != 0
                    ):
                        raise
                    print(
                        f"[agentfield] {self.node_id}: control plane not ready "
                        f"({e!r}); retrying in {delay:.0f}s",
                        flush=True,
                    )
                    if self._runner:  # unbind before retrying start()
                        await self._runner.cleanup()
                        self._runner = None
                    self.port = requested_port
                    await asyncio.sleep(delay)
                    delay = min(delay * 2, 30.0)
            print(
                f"[agentfield] {self.node_id} serving on {self.host}:{self.port} "
                f"({len(self.components)} components), control plane {self.client.base_url}",
                flush=True,
            )
            stop = asyncio.Event()
            try:
                await stop.wait()
            finally:
                await self.stop()

        asyncio.run(main())


def _normalize_images(items: list[Any]) -> list[dict[str, Any]]:
    """ai(images=...) accepts ImageContent, raw bytes, file paths, pre-built
    {"b64": ...} wire dicts, or pixel arrays; everything normalizes to the
    model node's wire forms (base64 blob or nested array)."""
    import base64 as _b64
    from pathlib import Path as _Path

    from agentfield_tpu_torch.sdk.multimodal import ImageContent, classify

    out: list[dict[str, Any]] = []
    for item in items:
        if isinstance(item, dict) and "b64" in item:
            out.append(item)
            continue
        if isinstance(item, (str, _Path)):
            item = ImageContent.from_file(item)
        elif isinstance(item, bytes):
            item = classify(item)
        if isinstance(item, ImageContent):
            out.append({"b64": _b64.b64encode(item.data).decode()})
        elif isinstance(item, (list, tuple)) or hasattr(item, "__array__"):
            import numpy as _np

            # tolist() all the way down: a shallow list() of a 3-D ndarray
            # would put ndarrays inside the JSON payload
            out.append(_np.asarray(item).tolist())
        else:
            raise TypeError(f"cannot use {type(item).__name__} as an image input")
    return out


def _normalize_files(items: list[Any]) -> list[Any]:
    """ai(files=...) accepts FileContent, file paths, raw bytes, or
    {"b64"/"path", "name", "mime"} dicts — everything normalizes to
    FileContent for prompt inlining. Image/audio bytes are redirected with
    a pointed error (they have dedicated tower routes)."""
    import base64 as _b64
    from pathlib import Path as _Path

    from agentfield_tpu_torch.sdk.multimodal import (
        AudioContent,
        FileContent,
        ImageContent,
        classify,
    )

    out: list[Any] = []
    for item in items:
        if isinstance(item, dict):
            if "b64" in item:
                data = _b64.b64decode(item["b64"])
                name = item.get("name", "blob")
                if "mime" in item:
                    item = FileContent(data, name=name, mime=item["mime"])
                else:
                    # sniff magic like the raw-bytes path, so b64-wrapped
                    # media gets the pointed images=/audio= redirect below
                    sniffed = classify(data)
                    item = (
                        FileContent(data, name=name, mime=sniffed.mime)
                        if isinstance(sniffed, FileContent)
                        else sniffed
                    )
            elif "path" in item:
                item = FileContent.from_file(item["path"])
            else:
                raise TypeError("file dicts need 'b64' or 'path'")
        elif isinstance(item, (str, _Path)):
            item = FileContent.from_file(item)
        elif isinstance(item, bytes):
            item = classify(item)  # sniffs magic: may be image/audio bytes
        if isinstance(item, (ImageContent, AudioContent)):
            kind = "images=" if isinstance(item, ImageContent) else "audio="
            raise TypeError(
                f"this looks like {'an image' if kind == 'images=' else 'audio'} — "
                f"pass it via {kind} (it routes to the model node's tower)"
            )
        if not isinstance(item, FileContent):
            raise TypeError(f"cannot use {type(item).__name__} as a file input")
        out.append(item)
    return out


def _normalize_audio(items: list[Any]) -> list[dict[str, Any]]:
    """ai(audio=...) accepts AudioContent, raw WAV bytes, file paths,
    pre-built {"b64": ...} wire dicts, or sample arrays; everything
    normalizes to the model node's wire forms (base64 WAV or sample list)."""
    import base64 as _b64
    from pathlib import Path as _Path

    from agentfield_tpu_torch.sdk.multimodal import AudioContent, classify

    out: list[dict[str, Any]] = []
    for item in items:
        if isinstance(item, dict) and "b64" in item:
            out.append(item)
            continue
        if isinstance(item, (str, _Path)):
            item = AudioContent.from_file(item)
        elif isinstance(item, bytes):
            item = classify(item)
        if isinstance(item, AudioContent):
            out.append({"b64": _b64.b64encode(item.data).decode()})
        elif isinstance(item, (list, tuple)) or hasattr(item, "__array__"):
            import numpy as _np

            out.append(_np.asarray(item, _np.float32).reshape(-1).tolist())
        else:
            raise TypeError(f"cannot use {type(item).__name__} as an audio input")
    return out
