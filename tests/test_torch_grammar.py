"""Grammar-constrained decoding in the port against the JAX package, on the
CPU: the port's copy of ``serving/grammar.py`` compiles bit-equal tables,
and the engine's transition bank, admission checks, masked first token and
masked decode step give the JAX engine's tokens (llama-tiny, float32,
carried weights), with one constrained and one free row in one batch, at
full and at bucket width. Sampled constrained rows cannot match the JAX
engine's draws (another generator): their output must lie in the schema's
language, or be a prefix of it when ``max_new_tokens`` cut it."""

from __future__ import annotations

import dataclasses
import json

import jax
import numpy as np
import pytest

from agentfield_tpu.models import configs as jax_configs
from agentfield_tpu.models import llama as jax_llama
from agentfield_tpu.serving import engine as jax_engine
from agentfield_tpu.serving import grammar as jax_grammar
from agentfield_tpu.serving.model_node import ByteTokenizer as JaxByteTokenizer
from agentfield_tpu.serving.sampler import SamplingParams as JaxSampling
from agentfield_tpu_torch.models.configs import get_config
from agentfield_tpu_torch.models.convert import params_from_numpy
from agentfield_tpu_torch.serving import engine, grammar
from agentfield_tpu_torch.serving.sampler import SamplingParams
from agentfield_tpu_torch.serving.tokenizer import ByteTokenizer

LP_TOL = 1e-4
ENGINE_SCHEMA = {
    "type": "object",
    "properties": {
        "name": {"type": "string", "maxLength": 6},
        "age": {"type": "integer"},
        "ok": {"type": "boolean"},
    },
}
OPT_SCHEMA = {
    "type": "object",
    "properties": {
        "name": {"type": "string"},
        "age": {"type": "integer"},
        "ok": {"type": "boolean"},
    },
    "required": ["name"],
}
SCHEMAS = {
    "engine": (ENGINE_SCHEMA, False),
    "enum_const_array_null_number": ({
        "type": "object",
        "properties": {
            "kind": {"enum": ["alpha", "beta", 3]},
            "v": {"const": "fixed"},
            "xs": {"type": "array", "items": {"type": "number"}},
            "z": {"type": "null"},
        },
    }, False),
    "array_bounds": ({"type": "array", "items": {"type": "integer"}, "minItems": 1,
                      "maxItems": 3}, False),
    "string_max_length": ({"type": "string", "maxLength": 3}, False),
    "optional_required": (OPT_SCHEMA, False),
    "whitespace": (OPT_SCHEMA, True),
    "whitespace_nested": ({
        "type": "object",
        "properties": {
            "tags": {"type": "array", "items": {"type": "integer"}},
            "sub": {"type": "object", "properties": {"v": {"type": "number"}}, "required": []},
        },
        "required": ["tags"],
    }, True),
    "ref_anyof": ({
        "$defs": {"Item": {"type": "object", "properties": {"id": {"type": "integer"},
                                                            "tag": {"enum": ["a", "b"]}}}},
        "type": "object",
        "properties": {
            "item": {"$ref": "#/$defs/Item"},
            "v": {"anyOf": [{"type": "boolean"}, {"type": "null"}]},
        },
    }, False),
}
# multi-byte tokens beside the bytes: the vocabulary closure walks them
EXTRA_TOKENS = [b'{"', b'"}', b'":', b'","', b"name", b"age", b"ok", b"true", b"false",
                b'{"name":"', b'",led', b"  ", b"\n"]


@pytest.mark.parametrize("name", list(SCHEMAS))
def test_compiled_tables_bit_equal(name):
    schema, ws = SCHEMAS[name]
    V = get_config("llama-tiny").vocab_size
    assert ByteTokenizer(V).token_bytes(V) == JaxByteTokenizer(V).token_bytes(V)
    vocab = ByteTokenizer(V).token_bytes(V)[: V - len(EXTRA_TOKENS)] + EXTRA_TOKENS
    got = grammar.compile_json_schema(schema, vocab, whitespace=ws)
    want = jax_grammar.compile_json_schema(schema, vocab, whitespace=ws)
    assert got.trans.dtype == want.trans.dtype and np.array_equal(got.trans, want.trans)
    assert got.accept.dtype == want.accept.dtype and np.array_equal(got.accept, want.accept)
    assert (got.start, got.n_states) == (want.start, want.n_states)


def test_schema_errors_match():
    for bad in ({"type": "frobnicate"},
                {"type": "object", "properties": {"a": {"type": "integer"}}, "required": ["z"]}):
        with pytest.raises(jax_grammar.SchemaError):
            jax_grammar.compile_json_schema(bad, [b"a"])
        with pytest.raises(grammar.SchemaError):
            grammar.compile_json_schema(bad, [b"a"])


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_configs.get_config("llama-tiny"), dtype="float32")
    tree = jax.tree.map(np.asarray, jax_llama.init_params(jcfg, jax.random.PRNGKey(0)))
    cfg = get_config("llama-tiny")
    params = params_from_numpy(tree, cfg, device="cpu")
    vocab = ByteTokenizer(cfg.vocab_size).token_bytes(cfg.vocab_size)
    return {
        "jcfg": jcfg, "tree": tree, "cfg": cfg, "params": params,
        "port": grammar.compile_json_schema(ENGINE_SCHEMA, vocab),
        "jax": jax_grammar.compile_json_schema(ENGINE_SCHEMA, vocab),
    }


def _ecfg(g, **kw):
    return dict(dict(max_batch=4, page_size=16, num_pages=64, max_pages_per_seq=8,
                     grammar_slots=g.n_states + 1), **kw)


def _mixed(eng, req_cls, samp_cls, g):
    free = req_cls(id="free", prompt=[1, 2, 3], sampling=samp_cls(max_new_tokens=8))
    con = req_cls(id="con", prompt=[4, 5, 6], grammar=g,
                  sampling=samp_cls(max_new_tokens=60, stop_token_ids=(0,)))
    out = {"free": [], "con": []}
    eng.submit(free)
    eng.submit(con)
    while eng.has_work():
        for ev in eng.step():
            out[ev.request_id].append((ev.token, ev.logprob))
    return out


def _in_language(toks, g, schema) -> bool:
    """True when ``toks`` end in the stop id after a document of the schema
    (checked by the grammar's own ``match_bytes`` and by JSON parsing);
    False when they are a legal prefix that ``max_new_tokens`` cut."""
    if 0 in toks:
        body = bytes(toks[: toks.index(0)])
        # byte-vocabulary grammar: token id b is byte b, so its table is a
        # byte DFA from state 0
        assert grammar.match_bytes(g.trans, g.accept, body), body
        doc = json.loads(body.decode("utf-8"))
        assert set(doc) <= set(schema["properties"])
        return True
    state = g.start
    for t in toks:
        state = int(g.trans[state, t])
        assert state >= 0, f"illegal token {t} in {bytes(toks)!r}"
    return False


@pytest.mark.parametrize("buckets", [None, (2,)], ids=["full", "bucket"])
def test_constrained_and_free_rows_match_jax(setup, buckets):
    ecfg = _ecfg(setup["port"], decode_buckets=buckets)
    jeng = jax_engine.InferenceEngine(setup["tree"], setup["jcfg"], jax_engine.EngineConfig(**ecfg))
    want = _mixed(jeng, jax_engine.Request, JaxSampling, setup["jax"])
    teng = engine.InferenceEngine(setup["params"], setup["cfg"], engine.EngineConfig(**ecfg))
    got = _mixed(teng, engine.Request, SamplingParams, setup["port"])
    for rid in ("free", "con"):
        assert [t for t, _ in got[rid]] == [t for t, _ in want[rid]], rid
        np.testing.assert_allclose([lp for _, lp in got[rid]], [lp for _, lp in want[rid]],
                                   atol=LP_TOL, rtol=0, err_msg=rid)
    assert teng.stats["decode_steps"] == jeng.stats["decode_steps"]
    toks = [t for t, _ in got["con"]]
    _in_language(toks, setup["port"], ENGINE_SCHEMA)  # every token legal
    assert teng.grammar_bank_stats() == jeng.grammar_bank_stats()
    ent = teng._gbank_entries[id(setup["port"])]
    assert ent["refs"] == 0 and ent["n"] == setup["port"].n_states
    # the free row decodes as in an engine without a grammar bank
    plain = engine.InferenceEngine(setup["params"], setup["cfg"], engine.EngineConfig(
        max_batch=4, page_size=16, num_pages=64, max_pages_per_seq=8))
    ref = plain.run_to_completion([engine.Request("free", [1, 2, 3], SamplingParams(max_new_tokens=8))])
    assert [t for t, _ in got["free"]] == ref["free"]


def test_sampled_constrained_rows_stay_in_the_language(setup):
    g = setup["port"]
    eng = engine.InferenceEngine(setup["params"], setup["cfg"], engine.EngineConfig(**_ecfg(g)))
    reqs = [engine.Request(f"s{i}", [65 + i, 66, 67], grammar=g, sampling=SamplingParams(
        temperature=t, top_p=p, max_new_tokens=48, stop_token_ids=(0,)))
        for i, (t, p) in enumerate([(1.0, 1.0), (1.5, 0.9), (0.7, 1.0)])]
    res = eng.run_to_completion(reqs)
    assert len(res) == 3
    for toks in res.values():
        _in_language(toks, g, ENGINE_SCHEMA)
    assert len(eng._gbank_entries) == 1  # one registration, shared


def test_submit_checks_match_jax(setup):
    g, jg = setup["port"], setup["jax"]
    base = dict(max_batch=2, page_size=16, num_pages=32, max_pages_per_seq=4)
    cases = [
        (dict(base), dict(stop_token_ids=(0,)), "grammar_slots=0"),
        (_ecfg(g, **{k: v for k, v in base.items()}), dict(), "stop_token_ids"),
        (_ecfg(g, **base), dict(stop_token_ids=tuple(range(9))), "at most 8"),
    ]
    for ecfg, samp, match in cases:
        teng = engine.InferenceEngine(setup["params"], setup["cfg"], engine.EngineConfig(**ecfg))
        jeng = jax_engine.InferenceEngine(setup["tree"], setup["jcfg"], jax_engine.EngineConfig(**ecfg))
        with pytest.raises(ValueError, match=match):
            teng.submit(engine.Request("x", [1], SamplingParams(**samp), grammar=g))
        with pytest.raises(ValueError, match=match):
            jeng.submit(jax_engine.Request(id="x", prompt=[1], sampling=JaxSampling(**samp), grammar=jg))
        assert not teng.pending and not teng._gbank_entries
    teng = engine.InferenceEngine(setup["params"], setup["cfg"], engine.EngineConfig(**_ecfg(g)))
    other = grammar.compile_json_schema({"type": "boolean"}, [b"t", b"f"])
    with pytest.raises(ValueError, match="vocab"):
        teng.submit(engine.Request("v", [1], SamplingParams(max_new_tokens=4, stop_token_ids=(0,)),
                                   grammar=other))


def test_bank_capacity_and_eviction_match_jax(setup):
    """A bank too small for the schema raises GrammarCapacityError; an idle
    grammar evicts for one that does not fit beside it; the counters and
    gauges equal the JAX engine's over the same sequence."""
    V = setup["cfg"].vocab_size
    vocab = ByteTokenizer(V).token_bytes(V)
    small = (grammar.compile_json_schema({"type": "boolean"}, vocab),
             jax_grammar.compile_json_schema({"type": "boolean"}, vocab))
    big = (setup["port"], setup["jax"])

    def run(eng, req_cls, samp_cls, k, err_cls):
        def one(g, rid):
            eng.submit(req_cls(id=rid, prompt=[1, 2, 3], grammar=g,
                               sampling=samp_cls(max_new_tokens=4, stop_token_ids=(0,))))
            while eng.has_work():
                eng.step()

        one(big[k], "a")
        one(small[k], "b")  # does not fit beside the idle big one: evicts it
        assert id(big[k]) not in eng._gbank_entries and id(small[k]) in eng._gbank_entries
        return eng

    ecfg = _ecfg(setup["port"], max_batch=2, grammar_slots=setup["port"].n_states + 2)
    teng = run(engine.InferenceEngine(setup["params"], setup["cfg"], engine.EngineConfig(**ecfg)),
               engine.Request, SamplingParams, 0, engine.GrammarCapacityError)
    jeng = run(jax_engine.InferenceEngine(setup["tree"], setup["jcfg"], jax_engine.EngineConfig(**ecfg)),
               jax_engine.Request, JaxSampling, 1, jax_engine.GrammarCapacityError)
    assert teng.grammar_bank_stats() == jeng.grammar_bank_stats()
    for k in ("grammar_evictions", "grammar_capacity_errors"):
        assert teng.stats[k] == jeng.stats[k], k
    assert teng.stats["grammar_evictions"] == 1

    tiny = dict(max_batch=2, page_size=16, num_pages=32, max_pages_per_seq=4, grammar_slots=4)
    teng = engine.InferenceEngine(setup["params"], setup["cfg"], engine.EngineConfig(**tiny))
    jeng = jax_engine.InferenceEngine(setup["tree"], setup["jcfg"], jax_engine.EngineConfig(**tiny))
    with pytest.raises(engine.GrammarCapacityError):
        teng.submit(engine.Request("x", [1], SamplingParams(max_new_tokens=4, stop_token_ids=(0,)),
                                   grammar=setup["port"]))
    with pytest.raises(jax_engine.GrammarCapacityError):
        jeng.submit(jax_engine.Request(id="x", prompt=[1], grammar=setup["jax"],
                                       sampling=JaxSampling(max_new_tokens=4, stop_token_ids=(0,))))
    assert teng.stats["grammar_capacity_errors"] == jeng.stats["grammar_capacity_errors"] == 1
    assert teng.grammar_bank_stats() == jeng.grammar_bank_stats()
    assert not teng.pending


def test_queue_full_releases_the_grammar(setup):
    g = setup["port"]
    eng = engine.InferenceEngine(setup["params"], setup["cfg"],
                                 engine.EngineConfig(**_ecfg(g, max_pending=1)))
    samp = SamplingParams(max_new_tokens=4, stop_token_ids=(0,))
    eng.submit(engine.Request("a", [1], samp, grammar=g))
    with pytest.raises(engine.QueueFullError):
        eng.submit(engine.Request("b", [2], samp, grammar=g))
    assert eng._gbank_entries[id(g)]["refs"] == 1  # only the queued request's
