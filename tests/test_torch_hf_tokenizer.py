"""The port's ``HFTokenizer`` (``agentfield_tpu_torch/serving/tokenizer.py``),
which reads ``tokenizer.json`` itself, against the JAX node's
``HFTokenizer`` (``transformers.AutoTokenizer``) on the CPU.

Four tokenizers are trained here with the ``tokenizers`` library on a
seeded corpus and written as checkpoint tokenizer files:

- ``llama3``: byte-level BPE in Llama-3's form (its split pattern with
  ``\\p{L}``/``\\p{N}``, ``ByteLevel(use_regex=false)``, ``ignore_merges``,
  a ``Sequence[ByteLevel, TemplateProcessing]`` post-processor adding
  ``<|begin_of_text|>``, special tokens after the vocab);
- ``llama2``: Llama-2/Mistral SentencePiece-style BPE with byte fallback
  (``Prepend``/``Replace`` normalizer, ``<0xXX>`` tokens, ``fuse_unk``, the
  ``Replace``/``ByteFallback``/``Fuse``/``Strip`` decoder, ``<s>`` added);
- ``llama2-metaspace``: the same vocabulary behind a ``Metaspace``
  pre-tokenizer (``prepend_scheme="first"``), as newer conversions write it;
- ``gpt2``: GPT-2 ``ByteLevel`` with its regex, plus a normalized
  non-special added token and one with ``lstrip``/``rstrip``.

Checks: ``encode``, ``decode``, ``token_bytes``, ``vocab_size`` and
``eos_token_id`` equal over hypothesis strings (Unicode letters and marks,
digit runs, ``\\r\\n`` and other whitespace runs, ``\\x1c-\\x1f``, ``\\x85``,
``\\xa0``, upper-case contractions, special-token text inside a prompt); the
Llama-3-Instruct and Mistral-Instruct chat templates (published text below)
render as the JAX node renders them, ``raise_exception`` included; and
``build_model_node(checkpoint=...)`` on the CPU gives the JAX node's token ids
for an SDK ``messages`` payload and its greedy answer.

Strings hold only code points that Python's ``unicodedata`` assigns: the
``tokenizers`` library's regex carries a newer Unicode version, which makes
letters and numbers of code points Python does not know yet (documented in
the tokenizer's module).
"""

from __future__ import annotations

import json

import jinja2
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

tokenizers = pytest.importorskip("tokenizers")
pytest.importorskip("transformers")

from tokenizers import (  # noqa: E402
    AddedToken, Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers, processors,
    trainers,
)

from agentfield_tpu.serving.model_node import HFTokenizer as JaxHFTokenizer  # noqa: E402
from agentfield_tpu_torch.serving.tokenizer import HFTokenizer  # noqa: E402

LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
                  r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
# meta-llama/Meta-Llama-3-8B-Instruct, tokenizer_config.json "chat_template"
LLAMA3_TEMPLATE = (
    "{% set loop_messages = messages %}{% for message in loop_messages %}{% set content = "
    "'<|start_header_id|>' + message['role'] + '<|end_header_id|>\n\n'+ message['content'] | "
    "trim + '<|eot_id|>' %}{% if loop.index0 == 0 %}{% set content = bos_token + content %}"
    "{% endif %}{{ content }}{% endfor %}{% if add_generation_prompt %}{{ "
    "'<|start_header_id|>assistant<|end_header_id|>\n\n' }}{% endif %}")
# mistralai/Mistral-7B-Instruct-v0.1, tokenizer_config.json "chat_template"
MISTRAL_TEMPLATE = (
    "{{ bos_token }}{% for message in messages %}{% if (message['role'] == 'user') != "
    "(loop.index0 % 2 == 0) %}{{ raise_exception('Conversation roles must alternate "
    "user/assistant/user/assistant/...') }}{% endif %}{% if message['role'] == 'user' %}"
    "{{ '[INST] ' + message['content'] + ' [/INST]' }}{% elif message['role'] == 'assistant' %}"
    "{{ message['content'] + eos_token}}{% else %}{{ raise_exception('Only user and assistant "
    "roles are supported!') }}{% endif %}{% endfor %}")
LLAMA3_SPECIALS = ["<|begin_of_text|>", "<|end_of_text|>", "<|reserved_special_token_0|>",
                   "<|reserved_special_token_1|>", "<|start_header_id|>", "<|end_header_id|>",
                   "<|reserved_special_token_2|>", "<|eot_id|>"]
KINDS = ("llama3", "llama2", "llama2-metaspace", "gpt2")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread and no tokenizers thread pool (its trainer fans out
    over every core): this file stays off the cores that concurrent test
    workers time their locks on."""
    import os

    n, env = torch.get_num_threads(), os.environ.get("TOKENIZERS_PARALLELISM")
    torch.set_num_threads(1)
    os.environ["TOKENIZERS_PARALLELISM"] = "false"
    yield
    torch.set_num_threads(n)
    if env is None:
        os.environ.pop("TOKENIZERS_PARALLELISM", None)
    else:
        os.environ["TOKENIZERS_PARALLELISM"] = env
WORDS = ("the agent calls a tool and waits for its answer while the model decodes tokens "
         "Hello World it's DON'T we'll THEY'RE I'M you've she'd café naïve résumé Ünïcödé "
         "straße Привет мир γειά σου 日本語 テキスト 中文字符 العربية हिन्दी 한국어 emoji 🙂🚀 "
         "x1 2024 3.14159 100000 007 (parens) [brackets] {braces} <angle> path/to/file.py "
         "a_b-c+d=e snake_case CamelCase").split()


def _corpus(seed: int = 0, n: int = 400) -> list[str]:
    rng = np.random.default_rng(seed)
    seps = [" ", " ", " ", "  ", "\n", "\r\n", "\t", ", ", ". ", "! ", "? ", "\n\n"]
    out = []
    for _ in range(n):
        k = int(rng.integers(4, 24))
        out.append("".join(WORDS[int(rng.integers(len(WORDS)))] + seps[int(rng.integers(len(seps)))]
                           for _ in range(k)))
    return out


def _write(d, tok: Tokenizer, config: dict, edit=None):
    d.mkdir(parents=True, exist_ok=True)
    doc = json.loads(tok.to_str())
    if edit is not None:
        edit(doc)
    (d / "tokenizer.json").write_text(json.dumps(doc, ensure_ascii=False), encoding="utf-8")
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast", "model_max_length": 8192, **config},
        ensure_ascii=False), encoding="utf-8")
    return d


def build_tokenizer(kind: str, d, vocab: int = 700):
    """Train ``kind`` on the seeded corpus and write it under ``d``."""
    corpus = _corpus()
    if kind == "llama3":
        tok = Tokenizer(models.BPE(ignore_merges=True))
        tok.pre_tokenizer = pre_tokenizers.Sequence([
            pre_tokenizers.Split(Regex(LLAMA3_PATTERN), behavior="isolated", invert=False),
            pre_tokenizers.ByteLevel(add_prefix_space=False, trim_offsets=True, use_regex=False)])
        tok.decoder = decoders.ByteLevel()
        tok.train_from_iterator(corpus, trainers.BpeTrainer(
            vocab_size=vocab, initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
            show_progress=False))
        tok.add_special_tokens(LLAMA3_SPECIALS)
        bos = tok.token_to_id("<|begin_of_text|>")
        tok.post_processor = processors.Sequence([
            processors.ByteLevel(trim_offsets=False),
            processors.TemplateProcessing(single="<|begin_of_text|> $A",
                                          pair="<|begin_of_text|> $A <|begin_of_text|> $B:1",
                                          special_tokens=[("<|begin_of_text|>", bos)])])
        return _write(d, tok, {"bos_token": "<|begin_of_text|>", "eos_token": "<|eot_id|>",
                               "clean_up_tokenization_spaces": True,
                               "chat_template": LLAMA3_TEMPLATE})
    if kind.startswith("llama2"):
        tok = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True, fuse_unk=True))
        tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                               normalizers.Replace(" ", "▁")])
        tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="never",
                                                     split=True)  # for training only
        tok.train_from_iterator(corpus, trainers.BpeTrainer(
            vocab_size=vocab, limit_alphabet=60, show_progress=False,
            special_tokens=["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]))
        tok.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(),
                                         decoders.Fuse(), decoders.Strip(" ", 1, 0)])
        tok.post_processor = processors.TemplateProcessing(
            single="<s> $A", pair="<s> $A <s> $B", special_tokens=[("<s>", 1)])

        def edit(doc):
            # the byte tokens are vocab entries, not added tokens
            doc["added_tokens"] = [t for t in doc["added_tokens"] if t["id"] < 3]
            if kind == "llama2":
                doc["pre_tokenizer"] = None
            else:
                doc["normalizer"] = None
                doc["pre_tokenizer"] = {"type": "Metaspace", "replacement": "▁",
                                        "prepend_scheme": "first", "split": False}

        return _write(d, tok, {"bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>",
                               "clean_up_tokenization_spaces": False,
                               "chat_template": MISTRAL_TEMPLATE}, edit)
    assert kind == "gpt2"
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=True)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(corpus, trainers.BpeTrainer(
        vocab_size=vocab, initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        show_progress=False))
    tok.post_processor = processors.ByteLevel(trim_offsets=True)
    tok.add_special_tokens(["<|endoftext|>", AddedToken("<mask>", lstrip=True, rstrip=True,
                                                         special=True)])
    tok.add_tokens([AddedToken("tool_call", normalized=True)])
    return _write(d, tok, {"bos_token": "<|endoftext|>", "eos_token": "<|endoftext|>",
                           "clean_up_tokenization_spaces": True})


@pytest.fixture(scope="module")
def toks(tmp_path_factory):
    out = {}
    for kind in KINDS:
        d = build_tokenizer(kind, tmp_path_factory.mktemp(kind))
        out[kind] = (HFTokenizer(d), JaxHFTokenizer(str(d)), d)
    return out


SPECIAL_TEXT = ["<|begin_of_text|>", "<|eot_id|>", "<s>", "</s>", "<unk>", "<|endoftext|>",
                " <mask> ", "<mask>", "tool_call", "<|start_header_id|>user<|end_header_id|>"]
ODD_SPACE = ["\r\n", "\n\n", "\t", "  ", "   ", "\x1c", "\x1d", "\x1e", "\x1f", "\x85", "\xa0",
             " ", "　", " \n ", "\x0b", "\x0c"]
chars = st.characters(exclude_categories=("Cs", "Cn"))
fragments = st.one_of(
    st.sampled_from(WORDS),
    st.sampled_from(["'s", "'S", "'T", "'RE", "'Ve", "'M", "'LL", "'D", "n't", "N'T"]),
    # what clean_up_tokenization_spaces rewrites on decode
    st.sampled_from([" .", " ?", " !", " ,", " ' ", " n't", " 'm", " 's", " 've", " 're"]),
    st.sampled_from(SPECIAL_TEXT),
    st.sampled_from(ODD_SPACE),
    st.from_regex(r"[0-9]{1,9}", fullmatch=True),
    st.text(alphabet=st.characters(categories=("L", "M")), min_size=1, max_size=8),
    st.text(alphabet=chars, min_size=1, max_size=6),
    st.text(alphabet=st.sampled_from(" .,!?;:-_()[]{}<>/\\'\"#@$%^&*+=~`|"), min_size=1,
            max_size=4),
)
texts = st.lists(fragments, max_size=12).map("".join)
HYPO = settings(max_examples=150, deadline=None, derandomize=True,
                suppress_health_check=[HealthCheck.too_slow, HealthCheck.function_scoped_fixture])


@pytest.mark.parametrize("kind", KINDS)
def test_attributes_and_token_bytes_match_jax(toks, kind):
    port, jax_tok, _ = toks[kind]
    assert port.vocab_size == jax_tok.vocab_size
    assert port.eos_token_id == jax_tok.eos_token_id is not None
    assert sorted(port.all_special_ids) == sorted(jax_tok._tok.all_special_ids)
    assert port.get_vocab() == jax_tok._tok.get_vocab()
    n = len(port.get_vocab()) + 5
    assert port.token_bytes(n) == jax_tok.token_bytes(n)
    assert port.chat_template == jax_tok._tok.chat_template


@pytest.mark.parametrize("kind", KINDS)
@HYPO
@given(text=texts)
def test_encode_decode_match_jax(toks, kind, text):
    port, jax_tok, _ = toks[kind]
    ids = jax_tok.encode(text)
    assert port.encode(text) == ids, text
    assert port.decode(ids) == jax_tok.decode(ids), text


@pytest.mark.parametrize("kind", KINDS)
@HYPO
@given(data=st.data())
def test_decode_of_any_ids_matches_jax(toks, kind, data):
    """Ids the model may sample in any order: added and special tokens,
    byte tokens cut mid-character, ids past the tokenizer's vocabulary."""
    port, jax_tok, _ = toks[kind]
    n = len(port.get_vocab())
    ids = data.draw(st.lists(st.integers(0, n + 3), max_size=20))
    assert port.decode(ids) == jax_tok.decode(ids), ids


@pytest.mark.parametrize("kind", KINDS)
def test_corpus_round_trips_and_uses_merges(toks, kind):
    """The training corpus itself: equal ids, and merges do shorten it."""
    port, jax_tok, _ = toks[kind]
    n_ids = n_bytes = 0
    for text in _corpus(seed=1, n=40):
        ids = jax_tok.encode(text)
        assert port.encode(text) == ids
        assert port.decode(ids) == jax_tok.decode(ids)
        n_ids, n_bytes = n_ids + len(ids), n_bytes + len(text.encode("utf-8"))
    assert n_ids < 0.7 * n_bytes


def test_llama3_ignore_merges_and_bos(toks):
    port, jax_tok, _ = toks["llama3"]
    bos = port.token_to_id("<|begin_of_text|>")
    ids = port.encode("Hello world")
    assert ids[0] == bos and ids == jax_tok.encode("Hello world")
    # a pre-token that is itself in the vocab is one id, merges or not
    word = max((t for t in port.model.vocab if t.startswith("Ġ") and len(t) > 4), key=len)
    assert port.model.tokenize(word) == [port.model.vocab[word]]
    # special-token text in a prompt is the special id, once
    assert port.encode("<|eot_id|>x").count(port.token_to_id("<|eot_id|>")) == 1


def test_llama2_byte_fallback_and_bos(toks):
    port, jax_tok, _ = toks["llama2"]
    text = "日本語 ∮ 🚀"  # characters outside the trained alphabet
    ids = port.encode(text)
    assert ids == jax_tok.encode(text) and ids[0] == 1
    assert any(3 <= i < 259 for i in ids)  # <0xXX> byte tokens
    assert port.decode(ids) == jax_tok.decode(ids)


def test_unsupported_components_raise(tmp_path):
    d = build_tokenizer("gpt2", tmp_path / "t")
    doc = json.loads((d / "tokenizer.json").read_text())
    for key, spec in (("normalizer", {"type": "NFKC"}),
                      ("pre_tokenizer", {"type": "Whitespace"}),
                      ("decoder", {"type": "WordPiece", "prefix": "##", "cleanup": True}),
                      ("post_processor", {"type": "RobertaProcessing", "sep": ["</s>", 2],
                                          "cls": ["<s>", 0]})):
        bad = dict(doc, **{key: spec})
        (d / "tokenizer.json").write_text(json.dumps(bad))
        with pytest.raises(ValueError, match=spec["type"]):
            HFTokenizer(d)
    (d / "tokenizer.json").write_text(json.dumps(dict(doc, model={"type": "Unigram",
                                                                  "vocab": []})))
    with pytest.raises(ValueError, match="Unigram"):
        HFTokenizer(d)
    split = {"type": "Split", "pattern": {"String": " "}, "behavior": "Removed", "invert": False}
    (d / "tokenizer.json").write_text(json.dumps(dict(doc, pre_tokenizer=split)))
    with pytest.raises(ValueError, match="Removed"):
        HFTokenizer(d)
    single = dict(doc["added_tokens"][0], content="<word>", id=9999, single_word=True)
    (d / "tokenizer.json").write_text(json.dumps(dict(doc, added_tokens=doc["added_tokens"]
                                                      + [single])))
    with pytest.raises(ValueError, match="single_word"):
        HFTokenizer(d)


CHATS = [
    [{"role": "user", "content": "Hello there"}],
    [{"role": "user", "content": "  What is 2+2?  "},
     {"role": "assistant", "content": "4"},
     {"role": "user", "content": "Und auf Deutsch? <|eot_id|> café"}],
    [{"role": "system", "content": "You are terse."},
     {"role": "user", "content": "Name a color.\n"}],
    [{"role": "assistant", "content": "I start."}],
]


@pytest.mark.parametrize("kind", ["llama3", "llama2"])
@pytest.mark.parametrize("chat", range(len(CHATS)))
def test_chat_template_matches_jax_node(toks, kind, chat):
    """The node's ``apply_chat_template`` on both nodes: the same string
    (and its ids), or the same template error (Mistral's template raises on
    a system turn and on a conversation that does not start with the
    user)."""
    from agentfield_tpu.serving.model_node import ModelBackend as JaxBackend
    from agentfield_tpu_torch.serving.model_node import ModelBackend

    port, jax_tok, _ = toks[kind]
    messages = CHATS[chat]
    jax_node = JaxBackend.__new__(JaxBackend)
    jax_node.tokenizer = jax_tok
    node = ModelBackend.__new__(ModelBackend)
    node.tokenizer = port
    try:
        want = JaxBackend.apply_chat_template(jax_node, messages)
    except jinja2.exceptions.TemplateError as e:
        with pytest.raises(jinja2.exceptions.TemplateError, match=str(e).replace(".", r"\.")):
            ModelBackend.apply_chat_template(node, messages)
        return
    got = ModelBackend.apply_chat_template(node, messages)
    assert got == want
    assert port.encode(got) == jax_tok.encode(want)


def test_template_globals_and_no_template_fallback(toks, tmp_path):
    port, jax_tok, _ = toks["gpt2"]
    from agentfield_tpu_torch.serving.model_node import ModelBackend

    node = ModelBackend.__new__(ModelBackend)
    node.tokenizer = port
    msgs = [{"role": "user", "content": "hi"}]
    assert port.chat_template is None
    assert ModelBackend.apply_chat_template(node, msgs) == "user: hi\nassistant:"
    template = ("{{ messages | tojson }}|{{ bos_token }}|{{ eos_token }}|"
                "{% for m in messages %}{% if loop.index > 0 %}{% break %}{% endif %}{% endfor %}"
                "{{ strftime_now('%Y') | length }}")
    port.chat_template = jax_tok._tok.chat_template = template
    try:
        assert port.apply_chat_template(msgs) == jax_tok._tok.apply_chat_template(
            msgs, tokenize=False, add_generation_prompt=True)
    finally:
        port.chat_template = jax_tok._tok.chat_template = None
        port._compiled_template = None


def test_sandbox_refuses_unsafe_templates(toks):
    port, _, _ = toks["llama3"]
    saved = port.chat_template
    port.chat_template, port._compiled_template = "{{ messages.append(1) }}", None
    try:
        with pytest.raises(jinja2.exceptions.SecurityError):
            port.apply_chat_template([{"role": "user", "content": "x"}])
    finally:
        port.chat_template, port._compiled_template = saved, None


# ---------------------------------------------------------------------------
# The node on a checkpoint directory


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """llama-tiny (f32) written by the JAX writer with the llama3 tokenizer
    beside it (its vocab fits the model's 512 ids)."""
    import dataclasses

    import jax

    from agentfield_tpu.models import configs as jax_configs
    from agentfield_tpu.models import llama as jax_llama
    from agentfield_tpu.models.hf_loader import save_hf_checkpoint

    d = tmp_path_factory.mktemp("ckpt")
    jcfg = dataclasses.replace(jax_configs.get_config("llama-tiny"), dtype="float32")
    save_hf_checkpoint(d, jcfg, jax_llama.init_params(jcfg, jax.random.PRNGKey(3)))
    build_tokenizer("llama3", d, vocab=500 - len(LLAMA3_SPECIALS))
    return d


def test_node_on_checkpoint_matches_jax_node(ckpt, monkeypatch):
    """``build_model_node(checkpoint=dir)`` on both packages: the same
    tokenizer ids for an SDK ``messages`` payload (the template's BOS and the
    post-processor's second one included), and the same greedy answer. Both
    nodes load bf16; this run loads float32 on both sides (each package's
    loader default replaced), so the two engines compute alike."""
    import asyncio
    import functools

    import chip_smoke
    from agentfield_tpu.models import hf_loader as jax_hf
    from agentfield_tpu.serving import engine as jax_engine
    from agentfield_tpu.serving.model_node import build_model_node as jax_build
    from agentfield_tpu_torch.models import hf_loader
    from agentfield_tpu_torch.serving import engine
    from agentfield_tpu_torch.serving.model_node import build_model_node

    monkeypatch.setattr(jax_hf, "load_hf_checkpoint",
                        functools.partial(jax_hf.load_hf_checkpoint, dtype="float32"))
    monkeypatch.setattr(hf_loader, "load_hf_checkpoint",
                        functools.partial(hf_loader.load_hf_checkpoint, dtype="float32"))
    ecfg = dict(max_batch=2, page_size=16, num_pages=32, max_pages_per_seq=4)
    _, jb = jax_build(checkpoint=str(ckpt), ecfg=jax_engine.EngineConfig(**ecfg))
    _, tb = build_model_node(checkpoint=str(ckpt), device="cpu",
                             ecfg=engine.EngineConfig(**ecfg))
    assert isinstance(tb.tokenizer, HFTokenizer) and tb.model_name == str(ckpt)
    assert tb.engine.params["embed"].dtype == torch.float32
    payload = chip_smoke.sdk_payload(prompt=None, messages=[
        {"role": "system", "content": "Be brief."}, {"role": "user", "content": "Hello world"}],
        max_new_tokens=6)
    text = tb.apply_chat_template(payload["messages"])
    assert text == jb.apply_chat_template(payload["messages"])
    ids = tb.tokenizer.encode(text)
    assert ids == jb.tokenizer.encode(text)
    bos = tb.tokenizer.token_to_id("<|begin_of_text|>")
    assert ids[:2] == [bos, bos]  # the template's BOS, then the post-processor's
    tb.start()
    try:
        got = tb.generate(**payload)
    finally:
        tb.stop()

    async def jax_generate():
        await jb.start()
        try:
            return await jb.generate(**payload)
        finally:
            await jb.stop()

    want = asyncio.run(jax_generate())
    assert got["tokens"] == want["tokens"] and got["text"] == want["text"]
