"""Constrained decoding: JSON schema → token-level DFA for sampler masking.

The port's copy of ``agentfield_tpu/serving/grammar.py`` (numpy only; the
JAX package's ``serving/__init__`` pulls jax in, so the port keeps its own).
``tests/test_torch_grammar.py`` holds its tables bit-equal to the JAX
package's.

The reference enforces structured output by prompt injection and salvages the
result with regex (sdk/python/agentfield/agent_ai.py:221-245, 424-447). This
replacement makes schema-invalid tokens *unsampleable*: a JSON
schema compiles to a character-level DFA, which closes over the tokenizer
vocabulary into a token-level transition table ``trans[state, token] →
next_state | -1``. The serving engine keeps the table device-resident and, at
every decode step, masks logits with ``trans[state] >= 0`` before sampling and
advances ``state = trans[state, sampled]`` on-device — so constrained rows ride
the same (graph-captured) decode step as free rows, with no host round-trip
and no re-parse fallback.

Pipeline:
  schema --(build_json_nfa)--> byte-level NFA fragments (concat/alt/star)
         --(subset construction)--> DFA over byte classes
         --(close_over_vocab, numpy-vectorized)--> Grammar(trans, accept)

Generation defaults to canonical compact JSON: object properties in schema
order, no whitespace — a deliberate restriction that keeps the automaton small
and the output deterministic to validate. Two v2 relaxations are available:

- ``required``: when a schema object carries a ``required`` list, only those
  properties must appear; the rest are optional (still in declaration order,
  comma placement handled by the automaton). Without ``required`` every
  declared property is emitted (v1-compatible canonical form).
- ``whitespace=True`` (``compile_json_schema``): accepts up to ``max_ws``
  whitespace bytes (space/tab/CR/LF) after ``{`` ``[`` ``,`` ``:`` and before
  ``}`` ``]`` — enough for pretty-printed output. Bounded repetition (not a
  Kleene star) so masked generation can never stall in an infinite-whitespace
  loop: after ``max_ws`` blanks the only legal continuation is real JSON.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np

# ---------------------------------------------------------------------------
# NFA with byte-range edges
# ---------------------------------------------------------------------------

EPS = -1  # epsilon edge marker


class _NFA:
    """Thompson-style NFA builder. States are ints; edges are (lo, hi) byte
    ranges (inclusive) or epsilon. Fragments expose (start, accept) and are
    combined functionally."""

    # Hard bound on NFA construction: schemas arrive over the wire
    # (model_node compiles per-request), and $ref fan-out can blow a
    # few-KB schema up exponentially — fail with SchemaError, not OOM.
    MAX_STATES = 200_000

    def __init__(self):
        self.edges: list[list[tuple[int, int, int]]] = []  # state -> [(lo, hi, dst)]
        self.eps: list[list[int]] = []  # state -> [dst]

    def state(self) -> int:
        if len(self.edges) >= self.MAX_STATES:
            raise SchemaError(
                f"schema expands past {self.MAX_STATES} NFA states "
                "(deep $ref fan-out?) — simplify or bound the schema"
            )
        self.edges.append([])
        self.eps.append([])
        return len(self.edges) - 1

    def add(self, src: int, lo: int, hi: int, dst: int) -> None:
        self.edges[src].append((lo, hi, dst))

    def add_eps(self, src: int, dst: int) -> None:
        self.eps[src].append(dst)

    # -- fragments ---------------------------------------------------------

    def lit(self, text: str | bytes) -> tuple[int, int]:
        data = text.encode("utf-8") if isinstance(text, str) else text
        start = self.state()
        cur = start
        for b in data:
            nxt = self.state()
            self.add(cur, b, b, nxt)
            cur = nxt
        return start, cur

    def char_class(self, ranges: list[tuple[int, int]]) -> tuple[int, int]:
        start, end = self.state(), self.state()
        for lo, hi in ranges:
            self.add(start, lo, hi, end)
        return start, end

    def concat(self, *frags: tuple[int, int]) -> tuple[int, int]:
        frags = [f for f in frags if f is not None]
        if not frags:
            s = self.state()
            return s, s
        for (_, a_end), (b_start, _) in zip(frags, frags[1:]):
            self.add_eps(a_end, b_start)
        return frags[0][0], frags[-1][1]

    def alt(self, *frags: tuple[int, int]) -> tuple[int, int]:
        start, end = self.state(), self.state()
        for f_start, f_end in frags:
            self.add_eps(start, f_start)
            self.add_eps(f_end, end)
        return start, end

    def star(self, frag: tuple[int, int]) -> tuple[int, int]:
        start, end = self.state(), self.state()
        self.add_eps(start, frag[0])
        self.add_eps(frag[1], frag[0])
        self.add_eps(frag[1], end)
        self.add_eps(start, end)
        return start, end

    def opt(self, frag: tuple[int, int]) -> tuple[int, int]:
        start, end = self.state(), self.state()
        self.add_eps(start, frag[0])
        self.add_eps(frag[1], end)
        self.add_eps(start, end)
        return start, end

    def plus(self, frag: tuple[int, int]) -> tuple[int, int]:
        return self.concat(frag, self.star(frag))


# ---------------------------------------------------------------------------
# JSON-schema → NFA
# ---------------------------------------------------------------------------

_ASCII_STRING_RANGES = [
    (0x20, 0x21),  # printable minus '"' (0x22) and '\' (0x5C)
    (0x23, 0x5B),
    (0x5D, 0x7E),
]
_ESCAPABLE = b'"\\/bfnrt'
_DIGIT = [(0x30, 0x39)]
_DIGIT19 = [(0x31, 0x39)]


class SchemaError(ValueError):
    pass


def _utf8_char(n: _NFA) -> tuple[int, int]:
    """One well-formed multi-byte UTF-8 character (RFC 3629 table — excludes
    overlongs and surrogates). Byte-level BPE tokens can be partial UTF-8
    fragments, so the DFA must track continuation structure or masked
    generation could stitch invalid byte sequences across token boundaries."""
    cont = lambda: n.char_class([(0x80, 0xBF)])
    two = n.concat(n.char_class([(0xC2, 0xDF)]), cont())
    three = n.alt(
        n.concat(n.char_class([(0xE0, 0xE0)]), n.char_class([(0xA0, 0xBF)]), cont()),
        n.concat(n.char_class([(0xE1, 0xEC), (0xEE, 0xEF)]), cont(), cont()),
        n.concat(n.char_class([(0xED, 0xED)]), n.char_class([(0x80, 0x9F)]), cont()),
    )
    four = n.alt(
        n.concat(n.char_class([(0xF0, 0xF0)]), n.char_class([(0x90, 0xBF)]), cont(), cont()),
        n.concat(n.char_class([(0xF1, 0xF3)]), cont(), cont(), cont()),
        n.concat(n.char_class([(0xF4, 0xF4)]), n.char_class([(0x80, 0x8F)]), cont(), cont()),
    )
    return n.alt(two, three, four)


def _string_body(n: _NFA) -> tuple[int, int]:
    """Characters inside a JSON string: plain ASCII, well-formed UTF-8
    multibyte chars, or \\-escapes (incl. \\uXXXX)."""
    plain = n.alt(n.char_class(_ASCII_STRING_RANGES), _utf8_char(n))
    esc_simple = n.concat(n.lit("\\"), n.char_class([(c, c) for c in _ESCAPABLE]))
    hexd = [(0x30, 0x39), (0x41, 0x46), (0x61, 0x66)]
    esc_u = n.concat(
        n.lit("\\u"),
        n.char_class(hexd), n.char_class(hexd), n.char_class(hexd), n.char_class(hexd),
    )
    return n.star(n.alt(plain, esc_simple, esc_u))


def _json_string(n: _NFA, max_length: int | None = None) -> tuple[int, int]:
    if max_length is not None:
        # NFA fragments are graph nodes, not reusable combinators — each
        # character position needs a freshly built fragment (sharing one would
        # let later positions re-enter earlier states, i.e. an unbounded loop).
        hexd = [(0x30, 0x39), (0x41, 0x46), (0x61, 0x66)]

        def one_char():
            plain = n.alt(n.char_class(_ASCII_STRING_RANGES), _utf8_char(n))
            esc = n.concat(n.lit("\\"), n.char_class([(c, c) for c in _ESCAPABLE]))
            esc_u = n.concat(
                n.lit("\\u"),
                n.char_class(hexd), n.char_class(hexd), n.char_class(hexd), n.char_class(hexd),
            )
            return n.alt(plain, esc, esc_u)

        body = None
        for _ in range(max_length):
            piece = n.opt(one_char())
            body = piece if body is None else n.concat(body, piece)
        return n.concat(n.lit('"'), body, n.lit('"')) if body else n.lit('""')
    return n.concat(n.lit('"'), _string_body(n), n.lit('"'))


def _json_number(n: _NFA, integer: bool = False) -> tuple[int, int]:
    sign = n.opt(n.lit("-"))
    int_part = n.alt(n.lit("0"), n.concat(n.char_class(_DIGIT19), n.star(n.char_class(_DIGIT))))
    if integer:
        return n.concat(sign, int_part)
    frac = n.opt(n.concat(n.lit("."), n.plus(n.char_class(_DIGIT))))
    exp = n.opt(
        n.concat(
            n.char_class([(0x45, 0x45), (0x65, 0x65)]),  # e | E
            n.opt(n.char_class([(0x2B, 0x2B), (0x2D, 0x2D)])),  # + | -
            n.plus(n.char_class(_DIGIT)),
        )
    )
    return n.concat(sign, int_part, frac, exp)


_WS_RANGES = [(0x09, 0x0A), (0x0D, 0x0D), (0x20, 0x20)]  # \t \n \r space


def _make_ws(n: _NFA, max_ws: int):
    """Returns a factory for fresh optional-whitespace fragments (≤ max_ws
    blanks), or a None-returning factory when whitespace is disabled.
    Fragments are graph nodes, so every insertion point needs its own."""
    if max_ws <= 0:
        return lambda: None

    def ws() -> tuple[int, int]:
        frag = None
        for _ in range(max_ws):
            piece = n.opt(n.char_class(_WS_RANGES))
            frag = piece if frag is None else n.concat(frag, piece)
        return frag

    return ws


def build_schema_nfa(
    n: _NFA, schema: dict[str, Any], depth: int = 0, ws=None,
    root: dict[str, Any] | None = None, active_refs: frozenset = frozenset(),
) -> tuple[int, int]:
    """Recursively build the NFA fragment for one schema node. Canonical
    compact JSON (properties in declaration order); `required` marks the
    mandatory subset, `ws()` (when enabled) yields optional-whitespace
    fragments inserted at structural boundaries.

    pydantic-emitted constructs are supported: ``$ref``/``$defs`` (resolved
    against ``root``; RECURSIVE refs are rejected — a DFA is finite and
    recursive JSON is not a regular language), ``anyOf``/``oneOf``
    (alternation; oneOf's exclusivity is relaxed to acceptance — standard in
    token-masking decoders), and single-element ``allOf`` (pydantic v1's
    ref-wrapping)."""
    if ws is None:
        ws = lambda: None
    if root is None:
        root = schema
    # depth counts STRUCTURAL nesting (arrays/objects) only; $ref/anyOf/
    # allOf unwrapping layers carry a separate, larger budget so pydantic
    # model chains (each level = object + $ref, often + allOf) aren't
    # rejected at half the advertised structural depth.
    if depth > 16:
        raise SchemaError("schema nesting deeper than 16 (arrays/objects)")
    if len(active_refs) > 64:
        raise SchemaError("more than 64 chained $refs")

    def recur(sub: dict, bump: bool = True, extra_ref: str | None = None):
        refs = active_refs | {extra_ref} if extra_ref else active_refs
        return build_schema_nfa(n, sub, depth + (1 if bump else 0), ws, root, refs)

    if "$ref" in schema:
        ref = schema["$ref"]
        if ref in active_refs:
            raise SchemaError(
                f"recursive $ref {ref!r}: a token-mask DFA is finite and "
                "cannot accept recursive schemas"
            )
        if not ref.startswith("#/"):
            raise SchemaError(f"only intra-document $ref supported, got {ref!r}")
        node: Any = root
        for part in ref[2:].split("/"):
            part = part.replace("~1", "/").replace("~0", "~")
            if not isinstance(node, dict) or part not in node:
                raise SchemaError(f"$ref {ref!r} does not resolve")
            node = node[part]
        return recur(node, bump=False, extra_ref=ref)
    if "anyOf" in schema or "oneOf" in schema:
        branches = schema.get("anyOf") or schema.get("oneOf")
        if not isinstance(branches, list) or not branches:
            raise SchemaError("anyOf/oneOf must be a non-empty list")
        return n.alt(*[recur(b, bump=False) for b in branches])
    if "allOf" in schema:
        branches = schema["allOf"]
        if isinstance(branches, list) and len(branches) == 1:
            # pydantic v1 wraps refs as allOf=[{$ref}] (+ sibling metadata)
            merged = {**branches[0], **{k: v for k, v in schema.items() if k != "allOf"}}
            return recur(merged, bump=False)
        raise SchemaError("allOf with multiple subschemas is not supported")
    if "enum" in schema:
        return n.alt(*[n.lit(json.dumps(v, separators=(",", ":"))) for v in schema["enum"]])
    if "const" in schema:
        return n.lit(json.dumps(schema["const"], separators=(",", ":")))
    t = schema.get("type")
    if isinstance(t, list):
        return n.alt(*[recur({**schema, "type": one}, bump=False) for one in t])
    if t == "string":
        return _json_string(n, schema.get("maxLength"))
    if t == "integer":
        return _json_number(n, integer=True)
    if t == "number":
        return _json_number(n)
    if t == "boolean":
        return n.alt(n.lit("true"), n.lit("false"))
    if t == "null":
        return n.lit("null")
    if t == "array":
        items = schema.get("items", {"type": ["string", "number", "boolean", "null"]})
        min_items = schema.get("minItems", 0)
        max_items = schema.get("maxItems")

        def item():
            return recur(items)

        def comma_item():
            return n.concat(n.lit(","), ws(), item())

        if max_items is not None:
            if max_items < min_items:
                raise SchemaError("maxItems < minItems")
            # Optionality must NEST (item (',' item)?)? — flat opt(item)
            # opt(',item') would accept a leading comma like '[,1]'. Build the
            # optional tail inside-out from the last position.
            tail = None  # optional ',item' chain after position i
            for _ in range(max_items - max(min_items, 1)):
                piece = comma_item()
                tail = n.opt(piece if tail is None else n.concat(piece, tail))
            if min_items >= 1:
                frag = None
                for i in range(min_items):
                    piece = item() if i == 0 else comma_item()
                    frag = piece if frag is None else n.concat(frag, piece)
                body = frag if tail is None else n.concat(frag, tail)
            else:
                first = item()
                body = n.opt(first if tail is None else n.concat(first, tail))
            return n.concat(n.lit("["), ws(), body, ws(), n.lit("]"))
        nonempty = n.concat(item(), n.star(comma_item()))
        body = nonempty if min_items >= 1 else n.opt(nonempty)
        return n.concat(n.lit("["), ws(), body, ws(), n.lit("]"))
    if t == "object" or "properties" in schema:
        props = list(schema.get("properties", {}).items())
        req = schema.get("required")
        if req is not None:
            unknown = set(req) - {name for name, _ in props}
            if unknown:
                # Checked before the empty-props early-out: an unsatisfiable
                # schema must fail loudly, not compile to a {}-only grammar.
                raise SchemaError(f"required names undeclared properties: {sorted(unknown)}")
        if not props:
            return n.concat(n.lit("{"), ws(), n.lit("}"))
        if req is None:
            # v1-compatible canonical form: every declared property emitted.
            required = {name for name, _ in props}
        else:
            required = set(req)

        def prop(name: str, sub: dict, lead_comma: bool) -> tuple[int, int]:
            parts = [n.lit(","), ws()] if lead_comma else []
            parts += [
                n.lit(json.dumps(name)),
                n.lit(":"),
                ws(),
                recur(sub),
            ]
            return n.concat(*[p for p in parts if p is not None])

        # tails[i]: properties i.. given one already emitted (comma-led); an
        # optional property alternates between appearing and falling through
        # to the rest. Shared-subgraph NFA, built inside-out like arrays.
        tails: list[tuple[int, int] | None] = [None] * (len(props) + 1)
        # heads only consume tails[1..] — property 0 is never comma-led
        for i in range(len(props) - 1, 0, -1):
            name, sub = props[i]
            full = prop(name, sub, True)
            if tails[i + 1] is not None:
                full = n.concat(full, tails[i + 1])
            if name in required:
                tails[i] = full
            elif tails[i + 1] is None:
                tails[i] = n.opt(full)
            else:
                tails[i] = n.alt(full, tails[i + 1])
        # heads: alternation over which property is emitted FIRST (no comma);
        # only properties preceded exclusively by optionals can be first.
        heads = []
        for i, (name, sub) in enumerate(props):
            h = prop(name, sub, False)
            if tails[i + 1] is not None:
                h = n.concat(h, tails[i + 1])
            heads.append(h)
            if name in required:
                break
        body = heads[0] if len(heads) == 1 else n.alt(*heads)
        if not required:  # fully-optional object may be empty
            body = n.opt(body)
        return n.concat(n.lit("{"), ws(), body, ws(), n.lit("}"))
    raise SchemaError(f"unsupported schema node: {schema!r}")


# ---------------------------------------------------------------------------
# NFA → DFA (subset construction over byte alphabet, class-compressed)
# ---------------------------------------------------------------------------


def _eps_closure(n: _NFA, states: frozenset[int]) -> frozenset[int]:
    stack, seen = list(states), set(states)
    while stack:
        s = stack.pop()
        for d in n.eps[s]:
            if d not in seen:
                seen.add(d)
                stack.append(d)
    return frozenset(seen)


def nfa_to_dfa(n: _NFA, start: int, accept: int) -> tuple[np.ndarray, np.ndarray]:
    """Returns (T [n_states, 256] int32 with -1 = reject, accept_mask
    [n_states] bool). State 0 is the DFA start."""
    # Partition the byte alphabet into classes that behave identically to keep
    # subset construction cheap: boundaries from every edge's lo/hi+1.
    bounds = {0, 256}
    for src in range(len(n.edges)):
        for lo, hi, _ in n.edges[src]:
            bounds.add(lo)
            bounds.add(hi + 1)
    cuts = sorted(bounds)
    classes = list(zip(cuts[:-1], cuts[1:]))  # [(lo, hi_excl)]

    start_set = _eps_closure(n, frozenset([start]))
    dfa_states: dict[frozenset[int], int] = {start_set: 0}
    work = [start_set]
    trans_rows: list[dict[int, int]] = [{}]  # per dfa state: class idx -> dst

    while work:
        cur = work.pop()
        cur_id = dfa_states[cur]
        for ci, (lo, hi_excl) in enumerate(classes):
            nxt = set()
            for s in cur:
                for elo, ehi, dst in n.edges[s]:
                    if elo <= lo and hi_excl - 1 <= ehi:
                        nxt.add(dst)
            if not nxt:
                continue
            closed = _eps_closure(n, frozenset(nxt))
            if closed not in dfa_states:
                dfa_states[closed] = len(dfa_states)
                trans_rows.append({})
                work.append(closed)
            trans_rows[cur_id][ci] = dfa_states[closed]

    n_states = len(dfa_states)
    T = np.full((n_states, 256), -1, np.int32)
    for sid, row in enumerate(trans_rows):
        for ci, dst in row.items():
            lo, hi_excl = classes[ci]
            T[sid, lo:hi_excl] = dst
    accept_mask = np.zeros((n_states,), bool)
    for sset, sid in dfa_states.items():
        if accept in sset:
            accept_mask[sid] = True
    return T, accept_mask


# ---------------------------------------------------------------------------
# DFA × vocabulary → token-level Grammar
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Grammar:
    """Token-level automaton over a specific vocabulary.

    trans[state, token] = next state, or -1 if the token (or any byte inside
    it) leaves the language. accept[state] marks positions where the value is
    complete — the engine allows EOS exactly there (and only there for rows
    with no other outgoing transition).
    """

    trans: np.ndarray  # [n_states, vocab] int32
    accept: np.ndarray  # [n_states] bool
    start: int = 0

    @property
    def n_states(self) -> int:
        return self.trans.shape[0]


def close_over_vocab(
    T: np.ndarray, accept: np.ndarray, vocab: list[bytes]
) -> Grammar:
    """Walk every vocab token through the byte DFA from every state at once
    (vectorized over states; iterates max-token-length times)."""
    n_states = T.shape[0]
    V = len(vocab)
    # Trap state n_states: all bytes stay trapped.
    T_ext = np.concatenate([T, np.full((1, 256), n_states, T.dtype)], axis=0)
    T_ext = np.where(T_ext < 0, n_states, T_ext)

    max_len = max((len(t) for t in vocab), default=1)
    byte_mat = np.zeros((V, max_len), np.int32)
    len_arr = np.zeros((V,), np.int32)
    for i, tok in enumerate(vocab):
        len_arr[i] = len(tok)
        if tok:
            byte_mat[i, : len(tok)] = np.frombuffer(tok, np.uint8)

    # state[v, s] = DFA state after feeding token v's first p bytes from s
    state = np.broadcast_to(np.arange(n_states, dtype=np.int32), (V, n_states)).copy()
    done = np.zeros((V, n_states), np.int32)
    for p in range(max_len):
        active = (len_arr > p)[:, None]  # tokens still feeding bytes
        stepped = T_ext[state, byte_mat[:, p][:, None]]
        state = np.where(active, stepped, state)
        if p + 1 <= max_len:
            just_done = (len_arr == p + 1)[:, None]
            done = np.where(just_done, state, done)
    done = np.where((len_arr == 0)[:, None], state, done)

    trans = np.where(done >= n_states, -1, done).astype(np.int32).T  # [n_states, V]
    # Zero-length tokens (shouldn't exist) stay in place; forbid them to be
    # safe — they would stall generation.
    if (len_arr == 0).any():
        trans[:, len_arr == 0] = -1
    return Grammar(trans=trans, accept=accept.copy(), start=0)


def compile_json_schema(
    schema: dict[str, Any],
    vocab: list[bytes],
    *,
    whitespace: bool = False,
    max_ws: int = 8,
) -> Grammar:
    """schema + tokenizer vocabulary → token-level Grammar.

    whitespace=True additionally accepts ≤ max_ws blanks at structural
    boundaries (pretty-printed output); bounded so generation cannot stall
    sampling whitespace forever."""
    n = _NFA()
    frag = build_schema_nfa(n, schema, ws=_make_ws(n, max_ws if whitespace else 0))
    T, accept = nfa_to_dfa(n, frag[0], frag[1])
    return close_over_vocab(T, accept, vocab)


def match_bytes(T: np.ndarray, accept: np.ndarray, data: bytes) -> bool:
    """Test helper: does the byte DFA accept `data`?"""
    s = 0
    for b in data:
        s = T[s, b]
        if s < 0:
            return False
    return bool(accept[s])
