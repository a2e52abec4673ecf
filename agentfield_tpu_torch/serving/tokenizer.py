"""Tokenizers for the port's model node.

``ByteTokenizer`` is the port's copy of ``agentfield_tpu/serving/
model_node.py``'s byte-level tokenizer (same ids).

``HFTokenizer`` is the counterpart of that file's ``HFTokenizer``, which wraps
``transformers.AutoTokenizer``. The card's machine has neither
``transformers`` nor ``tokenizers`` (nor ``regex``), so this one reads a
checkpoint's ``tokenizer.json`` and ``tokenizer_config.json`` itself and
reproduces what ``AutoTokenizer`` (a fast tokenizer) does with them:

- added tokens are split out of the raw text first (leftmost-longest, with
  their ``lstrip``/``rstrip`` flags), those with
  ``normalized`` out of each normalized piece after it;
- normalizers ``Prepend``, ``Replace`` and a ``Sequence`` of them;
- pre-tokenizers ``ByteLevel``, ``Split`` (its regex translated for
  Python's ``re``: ``\\p{..}`` classes built from ``unicodedata`` and ``\\s``
  as the White_Space property, which is what the Rust library matches),
  ``Metaspace`` and a ``Sequence`` of them;
- the ``BPE`` model with ``byte_fallback``, ``ignore_merges`` and
  ``fuse_unk``, merging by a rank heap as the Rust library does, with a
  per-word cache;
- post-processors ``TemplateProcessing`` and ``ByteLevel`` (and a
  ``Sequence`` of them): ``encode`` adds the special tokens as
  ``AutoTokenizer.encode(text)`` does;
- decoders ``ByteLevel``, ``Metaspace`` and a ``Sequence`` of ``Replace``,
  ``ByteFallback``, ``Fuse`` and ``Strip``; ``decode`` keeps special tokens
  and applies ``clean_up_tokenization_spaces`` as transformers does.

Any other component raises ``ValueError`` naming it: a JAX node would
tokenize such a file through transformers, so falling back to bytes would
answer differently. ``apply_chat_template`` renders the checkpoint's
``chat_template`` as transformers does (an immutable sandboxed jinja2
environment, ``trim_blocks``, ``lstrip_blocks``, ``loopcontrols``,
``raise_exception``, ``tojson``, ``strftime_now``, the special tokens in
scope); jinja2 is imported only then.

One difference stays: ``unicodedata`` carries Python's Unicode version, so
a code point assigned by a later Unicode version than Python's is a letter
or number to the Rust library's regex and unassigned here.
"""

from __future__ import annotations

import heapq
import json
import re
import sys
import unicodedata
from pathlib import Path
from typing import Any, Callable


class ByteTokenizer:
    """Trivial byte-level tokenizer for random-weight models.

    decode(encode(x)) is lossy for ids >= 256, so TEXT-level multi-turn
    prompts won't prefix-match the session KV cache through this tokenizer —
    pass `tokens` for session reuse."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size
        self.eos_token_id = 0  # NUL: never legal inside generated text

    def encode(self, text: str) -> list[int]:
        return [b % self.vocab_size for b in text.encode("utf-8")]

    def decode(self, tokens: list[int]) -> str:
        return bytes(t % 256 for t in tokens).decode("utf-8", errors="replace")

    def token_bytes(self, vocab_size: int) -> list[bytes]:
        """Per-id byte strings for grammar compilation (serving/grammar.py).
        Ids >= 256 alias low bytes through decode(), but for constrained
        decoding they are redundant: they map to NUL, so the grammar only
        ever selects the canonical single-byte ids."""
        out = [bytes([i]) for i in range(min(256, vocab_size))]
        out += [b"\x00"] * (vocab_size - len(out))
        return out


# ---------------------------------------------------------------------------
# Character classes: the Rust library's regex (Oniguruma) semantics
# ---------------------------------------------------------------------------

# \s: the Unicode White_Space property (Rust's char::is_whitespace too). It is
# str.isspace() without \x1c-\x1f.
WHITE_SPACE = ("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005"
               "\u2006\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000")
_WS_SET = frozenset(WHITE_SPACE)
_CATEGORY_RANGES: dict[str, list[tuple[int, int]]] = {}


def _category_ranges() -> dict[str, list[tuple[int, int]]]:
    """General category -> code point ranges, from ``unicodedata`` (built
    once: one pass over the code space)."""
    if not _CATEGORY_RANGES:
        cat = unicodedata.category
        prev, start = None, 0
        for cp in range(sys.maxunicode + 1):
            c = cat(chr(cp))
            if c != prev:
                if prev is not None:
                    _CATEGORY_RANGES.setdefault(prev, []).append((start, cp - 1))
                prev, start = c, cp
        _CATEGORY_RANGES.setdefault(prev, []).append((start, sys.maxunicode))
    return _CATEGORY_RANGES


def _esc(cp: int) -> str:
    return f"\\U{cp:08x}"


def _class_body(name: str) -> str:
    """The body of a ``re`` character class for ``\\p{name}``: a general
    category (``Lu``) or a major class (``L``)."""
    ranges = _category_ranges()
    cats = [c for c in ranges if c == name or (len(name) == 1 and c[0] == name)]
    if not cats:
        raise ValueError(f"tokenizer regex: unsupported property \\p{{{name}}}")
    spans = sorted(r for c in cats for r in ranges[c])
    return "".join(_esc(a) if a == b else f"{_esc(a)}-{_esc(b)}" for a, b in spans)


_WS_BODY = "".join(_esc(ord(c)) for c in WHITE_SPACE)
_REGEX_CACHE: dict[str, re.Pattern] = {}


def onig_regex(pattern: str) -> re.Pattern:
    """Compile a tokenizer.json regex (Oniguruma syntax) for Python's ``re``:
    ``\\p{X}`` becomes an explicit class from ``unicodedata``,
    ``\\s``/``\\S`` the White_Space set; everything else the two engines
    read alike (alternation, greedy quantifiers, lookahead, scoped flags)."""
    hit = _REGEX_CACHE.get(pattern)
    if hit is not None:
        return hit
    out: list[str] = []
    i, in_class = 0, False
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            n = pattern[i + 1]
            if n == "p" and pattern[i + 2:i + 3] == "{":
                j = pattern.index("}", i)
                body = _class_body(pattern[i + 3:j])
                out.append(body if in_class else f"[{body}]")
                i = j + 1
                continue
            if n == "s":
                out.append(_WS_BODY if in_class else f"[{_WS_BODY}]")
            elif n == "S":
                if in_class:
                    raise ValueError("tokenizer regex: \\S inside a class is not supported")
                out.append(f"[^{_WS_BODY}]")
            else:
                out.append(pattern[i:i + 2])
            i += 2
            continue
        if c == "[" and not in_class:
            in_class = True
            out.append(c)
            if pattern[i + 1:i + 2] == "^":
                out.append("^")
                i += 1
        elif c == "]" and in_class:
            in_class = False
            out.append(c)
        else:
            out.append(c)
        i += 1
    rx = re.compile("".join(out))
    _REGEX_CACHE[pattern] = rx
    return rx


def _pattern(spec: dict) -> re.Pattern:
    if "Regex" in spec:
        return onig_regex(spec["Regex"])
    if "String" in spec:
        return re.compile(re.escape(spec["String"]))
    raise ValueError(f"tokenizer.json: unsupported pattern {spec!r}")


def _split(text: str, rx: re.Pattern, behavior: str) -> list[str]:
    """``NormalizedString::split`` under ``behavior``, "Isolated" or
    "MergedWithNext" (empty pieces dropped)."""
    marks: list[tuple[int, int, bool]] = []
    prev = 0
    for m in rx.finditer(text):
        a, b = m.span()
        if a == b:
            continue
        if prev != a:
            marks.append((prev, a, False))
        marks.append((a, b, True))
        prev = b
    if prev != len(text):
        marks.append((prev, len(text), False))
    if behavior == "Isolated":
        spans = [(a, b) for a, b, _ in marks]
    else:  # MergedWithNext: a match joins the piece after it
        spans, prev_hit = [], False
        for a, b, hit in reversed(marks):
            if hit and not prev_hit and spans:
                spans[-1] = (a, spans[-1][1])
            else:
                spans.append((a, b))
            prev_hit = hit
        spans.reverse()
    return [text[a:b] for a, b in spans if b > a]


# ---------------------------------------------------------------------------
# Byte-level alphabet (GPT-2's bytes_to_unicode)
# ---------------------------------------------------------------------------


def _bytes_to_unicode() -> dict[int, str]:
    bs = list(range(0x21, 0x7F)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


BYTE_TO_CHAR = _bytes_to_unicode()
CHAR_TO_BYTE = {c: b for b, c in BYTE_TO_CHAR.items()}
# GPT-2's pattern, which the ByteLevel pre-tokenizer splits with (use_regex)
GPT2_PATTERN = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"


# ---------------------------------------------------------------------------
# Components
# ---------------------------------------------------------------------------

Piece = tuple[str, bool]  # (text, starts at offset 0 of the original string)


def _normalizer(spec: dict | None) -> Callable[[str], str] | None:
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [_normalizer(s) for s in spec["normalizers"]]

        def seq(s: str) -> str:
            for p in parts:
                s = p(s)
            return s

        return seq
    if kind == "Prepend":
        pre = spec["prepend"]
        return lambda s: pre + s if s else s
    if kind == "Replace":
        rx, content = _pattern(spec["pattern"]), spec["content"]
        return lambda s: rx.sub(lambda _m: content, s)
    raise ValueError(f"tokenizer.json: unsupported normalizer {kind!r}")


def _pre_tokenizer(spec: dict | None) -> Callable[[list[Piece]], list[Piece]] | None:
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def seq(pieces: list[Piece]) -> list[Piece]:
            for p in parts:
                pieces = p(pieces)
            return pieces

        return seq
    if kind == "Split":
        rx, behavior = _pattern(spec["pattern"]), spec["behavior"]
        if spec.get("invert") or behavior != "Isolated":
            raise ValueError(f"tokenizer.json: unsupported Split behavior {behavior!r} "
                             f"(invert={spec.get('invert')})")
        return lambda pieces: [(s, at0 and k == 0) for text, at0 in pieces
                               for k, s in enumerate(_split(text, rx, behavior))]
    if kind == "ByteLevel":
        prefix, use_regex = spec.get("add_prefix_space", False), spec.get("use_regex", True)
        rx = onig_regex(GPT2_PATTERN) if use_regex else None

        def byte_level(pieces: list[Piece]) -> list[Piece]:
            out = []
            for text, at0 in pieces:
                if prefix and not text.startswith(" "):
                    text = " " + text
                for k, s in enumerate(_split(text, rx, "Isolated") if rx else [text]):
                    out.append(("".join(BYTE_TO_CHAR[b] for b in s.encode("utf-8")),
                                at0 and k == 0))
            return out

        return byte_level
    if kind == "Metaspace":
        rep = spec["replacement"]
        scheme = spec.get("prepend_scheme", "always" if spec.get("add_prefix_space", True)
                          else "never")
        split = spec.get("split", True)
        rx = re.compile(re.escape(rep))

        def metaspace(pieces: list[Piece]) -> list[Piece]:
            out = []
            for text, at0 in pieces:
                text = text.replace(" ", rep)
                if not text.startswith(rep) and (scheme == "always" or (scheme == "first" and at0)):
                    text = rep + text
                parts = _split(text, rx, "MergedWithNext") if split else [text]
                out += [(s, at0 and k == 0) for k, s in enumerate(parts) if s]
            return out

        return metaspace
    raise ValueError(f"tokenizer.json: unsupported pre_tokenizer {kind!r}")


def _decoder(spec: dict | None) -> Callable[[list[str]], list[str]] | None:
    """A decoder's ``decode_chain``: tokens -> tokens (joined at the end)."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [_decoder(s) for s in spec["decoders"]]

        def seq(tokens: list[str]) -> list[str]:
            for p in parts:
                tokens = p(tokens)
            return tokens

        return seq
    if kind == "ByteLevel":
        def byte_level(tokens: list[str]) -> list[str]:
            out = bytearray()
            for t in tokens:
                try:
                    out += bytes(CHAR_TO_BYTE[c] for c in t)
                except KeyError:
                    out += t.encode("utf-8")
            return [out.decode("utf-8", errors="replace")]

        return byte_level
    if kind == "Replace":
        rx, content = _pattern(spec["pattern"]), spec["content"]
        return lambda tokens: [rx.sub(lambda _m: content, t) for t in tokens]
    if kind == "ByteFallback":
        def byte_fallback(tokens: list[str]) -> list[str]:
            out: list[str] = []
            pending = bytearray()

            def flush():
                if pending:
                    try:
                        out.append(pending.decode("utf-8"))
                    except UnicodeDecodeError:
                        out.extend("�" for _ in pending)
                    pending.clear()

            for t in tokens:
                b = None
                if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
                    try:
                        b = int(t[3:5], 16)
                    except ValueError:
                        b = None
                if b is not None:
                    pending.append(b)
                else:
                    flush()
                    out.append(t)
            flush()
            return out

        return byte_fallback
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Strip":
        content, start, stop = spec["content"], spec["start"], spec["stop"]

        def strip(tokens: list[str]) -> list[str]:
            out = []
            for t in tokens:
                a, b = 0, len(t)
                while a < min(start, len(t)) and t[a] == content:
                    a += 1
                for k in range(stop):
                    i = len(t) - k - 1
                    if i < 0 or t[i] != content:
                        break
                    b = i
                out.append(t[a:b] if b > a else "")
            return out

        return strip
    if kind == "Metaspace":
        rep = spec["replacement"]
        scheme = spec.get("prepend_scheme", "always" if spec.get("add_prefix_space", True)
                          else "never")
        return lambda tokens: ["".join(("" if i == 0 and scheme != "never" else " ")
                                       if c == rep else c for c in t)
                               for i, t in enumerate(tokens)]
    raise ValueError(f"tokenizer.json: unsupported decoder {kind!r}")


def _post_processor(spec: dict | None, token_id: Callable[[str], int]
                    ) -> Callable[[list[int]], list[int]] | None:
    """``post_process`` of one sequence with ``add_special_tokens=True``."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [p for p in (_post_processor(s, token_id) for s in spec["processors"]) if p]

        def seq(ids: list[int]) -> list[int]:
            for p in parts:
                ids = p(ids)
            return ids

        return seq
    if kind == "ByteLevel":
        return None  # offsets only
    if kind == "TemplateProcessing":
        specials = spec.get("special_tokens", {})
        items: list[list[int] | None] = []
        for item in spec["single"]:
            if "Sequence" in item:
                items.append(None)
            elif "SpecialToken" in item:
                name = item["SpecialToken"]["id"]
                if name not in specials:
                    raise ValueError(f"tokenizer.json: template token {name!r} is not defined")
                items.append(list(specials[name]["ids"]))
            else:
                raise ValueError(f"tokenizer.json: unsupported template item {item!r}")
        return lambda ids: [t for it in items for t in (ids if it is None else it)]
    raise ValueError(f"tokenizer.json: unsupported post_processor {kind!r}")


class BPE:
    """The ``BPE`` model of tokenizer.json: a word's characters (with
    ``byte_fallback``: the ``<0xXX>`` tokens of a character not in the
    vocab; else ``unk_token``, fused when ``fuse_unk``) merged pair by pair,
    lowest merge rank first and leftmost among equals (the Rust library's
    heap order); with ``ignore_merges`` a word in the vocab is one id."""

    CACHE_MAX = 100_000

    def __init__(self, spec: dict):
        if spec.get("type", "BPE") != "BPE":
            raise ValueError(f"tokenizer.json: unsupported model {spec.get('type')!r}")
        if spec.get("dropout") not in (None, 0, 0.0):
            raise ValueError("tokenizer.json: BPE dropout is not supported")
        for key in ("continuing_subword_prefix", "end_of_word_suffix"):
            if spec.get(key):
                raise ValueError(f"tokenizer.json: BPE {key} is not supported")
        self.vocab: dict[str, int] = dict(spec["vocab"])
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.unk_token = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.merges: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, m in enumerate(spec.get("merges", [])):
            a, b = m.split(" ") if isinstance(m, str) else m
            try:
                pair = (self.vocab[a], self.vocab[b])
                self.merges[pair] = (rank, self.vocab[a + b])
            except KeyError:
                raise ValueError(f"tokenizer.json: merge {a!r} {b!r} is out of the vocab") from None
        self._cache: dict[str, list[int]] = {}

    def tokenize(self, word: str) -> list[int]:
        if not word:
            return []
        if self.ignore_merges:
            hit = self.vocab.get(word)
            if hit is not None:
                return [hit]
        ids = self._cache.get(word)
        if ids is None:
            ids = self._merge_word(word)
            if len(self._cache) >= self.CACHE_MAX:
                self._cache.clear()
            self._cache[word] = ids
        return ids

    def _symbols(self, word: str) -> list[int]:
        out: list[int] = []
        unk: int | None = None  # a pending unk id (fused while fuse_unk)
        for ch in word:
            i = self.vocab.get(ch)
            if i is not None:
                if unk is not None:
                    out.append(unk)
                    unk = None
                out.append(i)
                continue
            if self.byte_fallback:
                codes = [self.vocab.get(f"<0x{b:02X}>") for b in ch.encode("utf-8")]
                if all(c is not None for c in codes):
                    out += codes
                    continue
            if self.unk_token is not None:
                unk_id = self.vocab.get(self.unk_token)
                if unk_id is None:
                    raise ValueError(f"tokenizer.json: unk_token {self.unk_token!r} is not in the vocab")
                if unk is not None and not self.fuse_unk:
                    out.append(unk)
                unk = unk_id
        if unk is not None:
            out.append(unk)
        return out

    def _merge_word(self, word: str) -> list[int]:
        sym = self._symbols(word)
        n = len(sym)
        if n < 2:
            return sym
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        alive = [True] * n
        merges = self.merges
        heap = []
        for i in range(n - 1):
            m = merges.get((sym[i], sym[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            rank, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] >= n:
                continue
            right = nxt[pos]
            m = merges.get((sym[pos], sym[right]))
            if m is None or m[1] != new_id:
                continue  # an expired entry
            sym[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[right] < n:
                prev[nxt[right]] = pos
            if prev[pos] >= 0:
                m = merges.get((sym[prev[pos]], new_id))
                if m is not None:
                    heapq.heappush(heap, (m[0], prev[pos], m[1]))
            if nxt[pos] < n:
                m = merges.get((new_id, sym[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [s for s, a in zip(sym, alive) if a]


def _token_content(value) -> str | None:
    if value is None or isinstance(value, str):
        return value
    if isinstance(value, dict) and "content" in value:
        return value["content"]
    raise ValueError(f"tokenizer_config.json: unreadable special token {value!r}")


SPECIAL_TOKEN_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token",
                      "cls_token", "mask_token")


def _clean_up_tokenization(s: str) -> str:
    return (s.replace(" .", ".").replace(" ?", "?").replace(" !", "!").replace(" ,", ",")
            .replace(" ' ", "'").replace(" n't", "n't").replace(" 'm", "'m")
            .replace(" 's", "'s").replace(" 've", "'ve").replace(" 're", "'re"))


class HFTokenizer:
    """A Hugging Face tokenizer read from a checkpoint directory
    (``tokenizer.json``, ``tokenizer_config.json``, optional
    ``special_tokens_map.json`` and ``chat_template.jinja``), with the
    interface of the JAX node's transformers adapter: ``vocab_size`` (the
    model's vocab without added tokens), ``eos_token_id``, ``encode``,
    ``decode``, ``token_bytes``; plus ``chat_template`` and
    ``apply_chat_template``."""

    def __init__(self, path: str | Path):
        path = Path(path)
        doc = json.loads((path / "tokenizer.json").read_text(encoding="utf-8"))
        cfg_file = path / "tokenizer_config.json"
        cfg = json.loads(cfg_file.read_text(encoding="utf-8")) if cfg_file.exists() else {}
        stm_file = path / "special_tokens_map.json"
        if stm_file.exists():  # transformers lets this file override the config's tokens
            cfg.update(json.loads(stm_file.read_text(encoding="utf-8")))
        if doc.get("truncation") or doc.get("padding"):
            raise ValueError("tokenizer.json: truncation/padding settings are not supported")
        self.model = BPE(doc["model"])
        self._normalize = _normalizer(doc.get("normalizer"))
        self._pre_tokenize = _pre_tokenizer(doc.get("pre_tokenizer"))
        self._decode_chain = _decoder(doc.get("decoder"))
        # added tokens: content -> {id, special, lstrip, rstrip, single_word,
        # normalized}; ids are assigned as the Rust library assigns them on load
        self.added: dict[str, dict] = {}
        for t in doc.get("added_tokens", []):
            if t.get("single_word"):
                raise ValueError(f"tokenizer.json: single_word added token {t['content']!r} is "
                                 "not supported")
            self.added[t["content"]] = {
                "id": self._next_id(t["content"]), "special": t.get("special", False),
                "lstrip": t.get("lstrip", False), "rstrip": t.get("rstrip", False),
                "single_word": t.get("single_word", False),
                "normalized": t.get("normalized", not t.get("special", False))}
        self._check_added_tokens_decoder(cfg.get("added_tokens_decoder") or {})
        self.special_tokens_map: dict[str, Any] = {}
        for key in SPECIAL_TOKEN_KEYS:
            content = _token_content(cfg.get(key))
            if content:
                self.special_tokens_map[key] = content
        extra = [_token_content(t) for t in cfg.get("additional_special_tokens") or []]
        if extra:
            self.special_tokens_map["additional_special_tokens"] = extra
        for content in self._all_special_tokens():
            if content not in self.added:  # transformers adds the config's tokens
                self._add_special(content)
        self._refresh_added()
        self._post_process = _post_processor(doc.get("post_processor"), self.token_to_id)
        self.vocab_size = len(self.model.vocab)
        eos = self.special_tokens_map.get("eos_token")
        self.eos_token_id = self.token_to_id(eos) if eos is not None else None
        self.clean_up_tokenization_spaces = bool(cfg.get("clean_up_tokenization_spaces", False))
        template = cfg.get("chat_template")
        jinja_file = path / "chat_template.jinja"
        if jinja_file.exists():
            template = jinja_file.read_text(encoding="utf-8")
        if isinstance(template, list):  # named templates: transformers takes "default"
            named = {t["name"]: t["template"] for t in template}
            if "default" not in named:
                raise ValueError(f"tokenizer_config.json: chat templates {sorted(named)} have no "
                                 "'default'")
            template = named["default"]
        self.chat_template: str | None = template or None
        self._compiled_template = None

    # -- vocabulary ----------------------------------------------------------

    def _check_added_tokens_decoder(self, decoder: dict) -> None:
        for idx, t in decoder.items():
            have = self.added.get(t.get("content"))
            flags = ("special", "lstrip", "rstrip", "single_word", "normalized")
            if have is None or have["id"] != int(idx) or any(
                    k in t and bool(t[k]) != bool(have[k]) for k in flags):
                raise ValueError(
                    f"tokenizer_config.json: added token {idx} {t.get('content')!r} differs "
                    "from tokenizer.json's added_tokens")

    def _all_special_tokens(self) -> list[str]:
        seen: list[str] = []
        for v in self.special_tokens_map.values():
            for t in (v if isinstance(v, list) else [v]):
                if t not in seen:
                    seen.append(t)
        return seen

    def _next_id(self, content: str) -> int:
        """The id the Rust library gives an added token (its
        ``AddedVocabulary::add_tokens``; the id written in tokenizer.json is
        not read): the token's vocab id if it has one, else the next id
        after the vocab and the added tokens so far."""
        idx = self.model.vocab.get(content)
        if idx is None:
            size = len(self.model.vocab)
            mx = max((t["id"] for t in self.added.values()), default=None)
            idx = size if mx is None else (mx + 1 if mx >= size or size == 0 else size)
        return idx

    def _add_special(self, content: str) -> None:
        """A config special token that tokenizer.json does not list is added
        as transformers adds it (``_next_id``)."""
        self.added[content] = {"id": self._next_id(content), "special": True, "lstrip": False,
                               "rstrip": False, "single_word": False, "normalized": False}

    def _refresh_added(self) -> None:
        self._added_by_id = {t["id"]: c for c, t in self.added.items()}

        def matcher(tokens: list[str]) -> re.Pattern | None:
            if not tokens:
                return None
            # leftmost-longest, as the Rust library's Aho-Corasick matcher
            return re.compile("|".join(re.escape(t) for t in sorted(tokens, key=len, reverse=True)))

        raw = [c for c, t in self.added.items() if not t["normalized"]]
        norm: dict[str, str] = {}
        for c, t in self.added.items():
            if t["normalized"]:
                norm[self._normalize(c) if self._normalize else c] = c
        self._raw_matcher = matcher(raw)
        self._norm_matcher = matcher(list(norm))
        self._norm_content = norm

    def token_to_id(self, token: str) -> int | None:
        t = self.added.get(token)
        return t["id"] if t is not None else self.model.vocab.get(token)

    def get_vocab(self) -> dict[str, int]:
        vocab = dict(self.model.vocab)
        vocab.update({c: t["id"] for c, t in self.added.items()})
        return vocab

    @property
    def all_special_ids(self) -> list[int]:
        return [self.token_to_id(t) for t in self._all_special_tokens()]

    # -- encode ----------------------------------------------------------------

    def _find_added(self, text: str, matcher: re.Pattern | None, contents: dict | None
                    ) -> list[tuple[str, int | None]]:
        """The Rust ``AddedVocabulary::find_matches``: text -> pieces, an
        added token's piece carrying its id."""
        if matcher is None or not text:
            return [(text, None)]
        out: list[tuple[str, int | None]] = []
        start_offset = 0
        for m in matcher.finditer(text):
            start, stop = m.span()
            tok = self.added[contents[m.group()] if contents else m.group()]
            if tok["lstrip"]:
                s = start
                while s > 0 and text[s - 1] in _WS_SET:
                    s -= 1
                start = max(s, start_offset)
            if tok["rstrip"]:
                while stop < len(text) and text[stop] in _WS_SET:
                    stop += 1
            if start_offset < start:
                out.append((text[start_offset:start], None))
            out.append((text[start:stop], tok["id"]))
            start_offset = stop
        if start_offset != len(text):
            out.append((text[start_offset:], None))
        return out

    def encode(self, text: str) -> list[int]:
        """Token ids of ``text`` with the post-processor's special tokens
        (``AutoTokenizer.encode(text)``)."""
        ids: list[int] = []
        offset = 0
        for piece, tid in self._find_added(text, self._raw_matcher, None):
            at0 = offset == 0
            offset += len(piece)
            if tid is not None:
                ids.append(tid)
                continue
            if not piece:
                continue
            normed = self._normalize(piece) if self._normalize else piece
            for k, (sub, sid) in enumerate(self._find_added(normed, self._norm_matcher,
                                                             self._norm_content)):
                if sid is not None:
                    ids.append(sid)
                elif sub:
                    pieces = [(sub, at0 and k == 0)]
                    if self._pre_tokenize is not None:
                        pieces = self._pre_tokenize(pieces)
                    for word, _ in pieces:
                        ids += self.model.tokenize(word)
        return self._post_process(ids) if self._post_process else ids

    # -- decode ----------------------------------------------------------------

    def decode(self, tokens: list[int]) -> str:
        """``AutoTokenizer.decode(tokens)``: special tokens kept, ids unknown
        to the tokenizer skipped, then ``clean_up_tokenization_spaces``."""
        toks = []
        for i in tokens:
            t = self._added_by_id.get(i)
            if t is None:
                t = self.model.id_to_token.get(i)
            if t is not None:
                toks.append(t)
        text = "".join(self._decode_chain(toks)) if self._decode_chain else " ".join(toks)
        return _clean_up_tokenization(text) if self.clean_up_tokenization_spaces else text

    def token_bytes(self, vocab_size: int) -> list[bytes]:
        """Per-id byte strings for grammar compilation (the JAX adapter's
        logic). Byte-level BPE (GPT-2/Llama-3) maps a token's characters
        through the bytes<->unicode table; SentencePiece maps ``▁`` to a
        space and ``<0xXX>`` to the raw byte. Special tokens map to NUL
        (never legal inside JSON), so the grammar can't select them; EOS
        reaches the sampler through the accept-state allowance."""
        out = [b"\x00"] * vocab_size
        special = set(self.all_special_ids)
        vocab = self.get_vocab()
        byte_level = any(tok.startswith("Ġ") for tok in vocab)
        for tok, idx in vocab.items():
            if idx >= vocab_size or idx in special:
                continue
            if tok.startswith("<0x") and tok.endswith(">") and len(tok) == 6:
                try:
                    out[idx] = bytes([int(tok[3:5], 16)])
                    continue
                except ValueError:
                    pass
            if byte_level:
                try:
                    out[idx] = bytes(CHAR_TO_BYTE[c] for c in tok)
                    continue
                except KeyError:
                    pass
            out[idx] = tok.replace("▁", " ").encode("utf-8")
        return out

    # -- chat template -------------------------------------------------------------

    def apply_chat_template(self, messages: list[dict], add_generation_prompt: bool = True) -> str:
        """Render ``messages`` through the checkpoint's chat template, as
        transformers' ``apply_chat_template(tokenize=False)`` does."""
        if not self.chat_template:
            raise ValueError("this tokenizer has no chat_template")
        if self._compiled_template is None:
            self._compiled_template = compile_chat_template(self.chat_template)
        return self._compiled_template.render(
            messages=messages, tools=None, documents=None,
            add_generation_prompt=add_generation_prompt, **self.special_tokens_map)


def compile_chat_template(template: str):
    """A chat template compiled as transformers compiles it: an immutable
    sandboxed jinja2 environment with ``trim_blocks``, ``lstrip_blocks`` and
    ``loopcontrols``, its ``tojson`` filter (no HTML escaping) and the
    ``raise_exception`` and ``strftime_now`` globals."""
    from datetime import datetime

    import jinja2
    import jinja2.ext
    from jinja2.sandbox import ImmutableSandboxedEnvironment

    def raise_exception(message):
        raise jinja2.exceptions.TemplateError(message)

    def tojson(x, ensure_ascii=False, indent=None, separators=None, sort_keys=False):
        return json.dumps(x, ensure_ascii=ensure_ascii, indent=indent, separators=separators,
                          sort_keys=sort_keys)

    def strftime_now(fmt):
        return datetime.now().strftime(fmt)

    env = ImmutableSandboxedEnvironment(trim_blocks=True, lstrip_blocks=True,
                                        extensions=[jinja2.ext.loopcontrols])
    env.filters["tojson"] = tojson
    env.globals["raise_exception"] = raise_exception
    env.globals["strftime_now"] = strftime_now
    return env.from_string(template)
