"""The port's speculative decoding against the JAX engine's, on the CPU, in
float32, with the same weights carried JAX -> numpy -> torch: llama-tiny as
the target and llama-nano as the draft (or the target itself), under the
geometry of ``tests/test_speculative.py`` (``BASE``). Its scripts run through
both engines: greedy tokens, ``spec_steps``, ``spec_emitted``,
``decode_steps`` and ``free_pages`` must be equal, and greedy speculative
tokens must equal the port's plain greedy tokens. Sampled tokens differ (the
two packages draw from different generators), so the rejection sampler is
held by its own Monte-Carlo check against the exact tempered distribution.

One spec step is also held against the JAX ``_spec_decode_fn`` on fixed
inputs: greedy tokens and counts equal, logprobs within ``LP_TOL`` (float32
forwards of two frameworks sum in another order; the JAX engine's own
float32 parity tests allow 1e-4 on logprobs)."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentfield_tpu.models import configs as jax_configs
from agentfield_tpu.models import llama as jax_llama
from agentfield_tpu.serving import engine as jax_engine
from agentfield_tpu.serving import grammar as jax_grammar
from agentfield_tpu.serving.sampler import SamplingParams as JaxSampling
from agentfield_tpu_torch.models.configs import get_config
from agentfield_tpu_torch.models.convert import params_from_numpy
from agentfield_tpu_torch.serving import engine, grammar
from agentfield_tpu_torch.serving.kv_cache import PagedKVCache
from agentfield_tpu_torch.serving.sampler import SamplingParams
from agentfield_tpu_torch.serving.spec_decode import PagedModel, rows_forward, spec_step

BASE = dict(max_batch=4, page_size=16, num_pages=64, max_pages_per_seq=4)
COUNTERS = ("spec_steps", "spec_emitted", "decode_steps", "decode_tokens", "prefill_tokens",
            "requests_finished", "prefix_cache_hits", "prefix_index_hits",
            "prefix_tokens_reused")
LP_TOL = 1e-4
SCALE_ULPS = 8
TARGET, DRAFT = "llama-tiny", "llama-nano"


def _carry(name: str, seed: int):
    jcfg = dataclasses.replace(jax_configs.get_config(name), dtype="float32")
    cfg = dataclasses.replace(get_config(name), dtype="float32")
    tree = jax.tree.map(np.asarray, jax_llama.init_params(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, tree, params_from_numpy(tree, cfg, device="cpu"), cfg


@pytest.fixture(scope="module")
def models():
    """{"target": (jax cfg, numpy tree, port params, port cfg), "draft": ...}"""
    out = {}
    for role, name, seed in (("target", TARGET, 0), ("draft", DRAFT, 1)):
        out[role] = _carry(name, seed)
    return out


def _engines(models, ecfg: dict, draft: str | None = "draft"):
    """(JAX engine, port engine) on the target, with ``draft`` ("draft",
    "self" or None) as their draft model."""
    jcfg, tree, params, cfg = models["target"]
    jdraft = tdraft = None
    if draft is not None:
        d = models["target" if draft == "self" else "draft"]
        jdraft, tdraft = (d[1], d[0]), (d[2], d[3])
    return (jax_engine.InferenceEngine(tree, jcfg, jax_engine.EngineConfig(**ecfg), draft=jdraft),
            engine.InferenceEngine(params, cfg, engine.EngineConfig(**ecfg), draft=tdraft))


def _req(mod, rid, prompt, new, temp=0.0, **kw):
    samp_kw = {k: kw.pop(k) for k in ("top_k", "top_p", "stop_token_ids") if k in kw}
    samp = (JaxSampling if mod is jax_engine else SamplingParams)(
        max_new_tokens=new, temperature=temp, **samp_kw)
    return mod.Request(id=rid, prompt=prompt, sampling=samp, **kw)


def _reqs(mod, n=3, new=12, temp=0.0):
    """The JAX test's ``_reqs``."""
    return [_req(mod, f"s{i}", [7 + i, 11, 13, 17 + i, 19][: 3 + (i % 3)], new, temp)
            for i in range(n)]


def _same_counters(jeng, teng, keys=COUNTERS):
    for k in keys:
        assert teng.stats[k] == jeng.stats[k], (k, teng.stats[k], jeng.stats[k])
    assert teng.allocator.free_pages == jeng.allocator.free_pages


def test_spec_matches_plain_greedy_and_jax(models):
    jeng, teng = _engines(models, dict(spec_k=3, **BASE))
    want = jeng.run_to_completion(_reqs(jax_engine))
    got = teng.run_to_completion(_reqs(engine))
    assert got == want
    _same_counters(jeng, teng)
    assert teng.stats["spec_steps"] > 0
    # the first token of each request comes from the prefill sample
    assert teng.stats["spec_emitted"] == sum(len(v) for v in got.values()) - len(got)
    _, plain = _engines(models, BASE, draft=None)
    assert plain.run_to_completion(_reqs(engine)) == got


def test_self_draft_emits_what_the_jax_engine_emits(models):
    """Draft == target: nearly every proposal is accepted; tokens per spec
    step (and every counter) equal the JAX engine's."""
    jeng, teng = _engines(models, dict(spec_k=3, **BASE), draft="self")
    want = jeng.run_to_completion(_reqs(jax_engine, n=2, new=16))
    got = teng.run_to_completion(_reqs(engine, n=2, new=16))
    assert got == want and all(len(v) == 16 for v in got.values())
    _same_counters(jeng, teng)
    per_step = teng.stats["spec_emitted"] / teng.stats["spec_steps"]
    assert per_step == jeng.stats["spec_emitted"] / jeng.stats["spec_steps"]
    assert per_step > 2.0, teng.stats
    _, plain = _engines(models, BASE, draft=None)
    assert plain.run_to_completion(_reqs(engine, n=2, new=16)) == got


@pytest.mark.parametrize("draft", ["draft", "self"])
def test_mixed_batch_greedy_rows_match(models, draft):
    """A temperature row speculates beside greedy rows in the same
    dispatches (rejection sampling for it, argmax agreement for them): the
    greedy rows' tokens equal the JAX engine's and the port's plain ones."""
    jeng, teng = _engines(models, dict(spec_k=3, **BASE), draft=draft)
    out = {}
    for mod, eng in ((jax_engine, jeng), (engine, teng)):
        out[mod] = eng.run_to_completion(
            _reqs(mod, n=2, new=8) + [_req(mod, "hot", [3, 5, 9], 8, temp=0.9)])
        assert all(len(v) == 8 for v in out[mod].values())
        assert eng.stats["spec_steps"] > 0
    _, plain = _engines(models, BASE, draft=None)
    want = plain.run_to_completion(_reqs(engine, n=2, new=8))
    for rid in want:
        assert out[engine][rid] == out[jax_engine][rid] == want[rid], rid


def _grammars(schema: dict):
    V = get_config(TARGET).vocab_size
    vocab = [bytes([i]) for i in range(256)] + [b"\x00\x01"] * (V - 256)
    return jax_grammar.compile_json_schema(schema, vocab), grammar.compile_json_schema(schema, vocab)


def _count_resyncs(eng) -> list[int]:
    """Wrap ``eng._resync_draft``: the tokens each call replays."""
    gaps: list[int] = []
    orig = eng._resync_draft

    def counted(active_idx):
        gaps.append(sum(eng.slots[i].length - eng.slots[i].draft_len for i in active_idx))
        orig(active_idx)

    eng._resync_draft = counted
    return gaps


def test_grammar_row_falls_back_then_draft_resyncs(models):
    """The JAX ``test_draft_resyncs_after_fallback_steps`` script (self
    draft): no spec dispatch while the grammar row is active, then the draft
    replays the tokens it missed and speculation resumes at full
    acceptance; counters and tokens equal the JAX engine's."""
    gj, gt = _grammars({"type": "boolean"})
    jeng, teng = _engines(models, dict(spec_k=3, grammar_slots=64, **BASE), draft="self")
    gaps = _count_resyncs(teng)

    def reqs(mod, g):
        return [_req(mod, "greedy", [5, 6, 7], 20),
                _req(mod, "hot", [9, 10], 6, grammar=g, stop_token_ids=(0,))]

    want = jeng.run_to_completion(reqs(jax_engine, gj))
    got = teng.run_to_completion(reqs(engine, gt))
    assert got == want
    assert len(got["greedy"]) == 20 and 1 <= len(got["hot"]) <= 6
    _same_counters(jeng, teng)
    assert teng.stats["decode_steps"] > teng.stats["spec_steps"] > 0  # fell back, then resumed
    assert any(n > 0 for n in gaps), gaps  # the draft replayed the fallback steps' tokens
    assert teng.stats["spec_emitted"] / teng.stats["spec_steps"] > 2.0, teng.stats
    _, plain = _engines(models, dict(grammar_slots=64, **BASE), draft=None)
    assert plain.run_to_completion(reqs(engine, gt))["greedy"] == got["greedy"]


def test_grammar_row_disables_spec(models):
    gj, gt = _grammars({"type": "object", "properties": {"a": {"type": "integer"}},
                        "required": ["a"]})
    ecfg = dict(spec_k=3, grammar_slots=gt.n_states + 1, **BASE)
    jeng, teng = _engines(models, ecfg)
    outs = []
    for mod, eng, g in ((jax_engine, jeng, gj), (engine, teng, gt)):
        outs.append(eng.run_to_completion(
            _reqs(mod, n=1, new=6) + [_req(mod, "j", [3, 5], 6, grammar=g, stop_token_ids=(0,))]))
    assert outs[0] == outs[1]
    assert teng.stats["spec_steps"] == 0 == jeng.stats["spec_steps"]
    _same_counters(jeng, teng)


def test_session_reuse_replays_the_draft(models):
    """The second turn hits its session: the suffix prefill runs over both
    pools, so the draft's proposals see the whole context."""
    jeng, teng = _engines(models, dict(spec_k=2, enable_prefix_cache=True, **BASE))
    for mod, eng in ((jax_engine, jeng), (engine, teng)):
        out1 = eng.run_to_completion([_req(mod, "a", [5, 6, 7, 8], 6, session_id="sess")])["a"]
        out2 = eng.run_to_completion(
            [_req(mod, "b", [5, 6, 7, 8] + out1[:-1] + [9], 6, session_id="sess")])["b"]
        assert len(out2) == 6 and eng.stats["prefix_cache_hits"] >= 1
        assert eng.stats["spec_steps"] > 0
    _same_counters(jeng, teng)


def test_shared_prefix_hit_sees_draft_kv(models):
    """A request that reuses another's published pages through the shared
    prefix index reads the draft's KV on the same page ids (self draft: it
    accepts as much as the JAX engine's)."""
    rng = np.random.default_rng(3)
    shared = rng.integers(0, 512, 34).tolist()  # 2 full pages
    script = [("p0", shared + [1, 2], 10), ("p1", shared + [3], 10)]
    jeng, teng = _engines(models, dict(spec_k=3, **BASE), draft="self")
    outs = []
    for mod, eng in ((jax_engine, jeng), (engine, teng)):
        outs.append({rid: eng.run_to_completion([_req(mod, rid, p, n)])[rid]
                     for rid, p, n in script})
        assert eng.stats["prefix_index_hits"] == 1
    assert outs[0] == outs[1]
    _same_counters(jeng, teng)


def test_all_truncated_batch_skips_spec(models):
    jeng, teng = _engines(models, dict(spec_k=3, **BASE))
    for mod, eng in ((jax_engine, jeng), (engine, teng)):
        out = eng.run_to_completion([_req(mod, "n", [3, 5], 6, temp=0.8, top_p=0.9)])
        assert len(out["n"]) == 6
        assert eng.stats["spec_steps"] == 0
    assert teng.stats["decode_steps"] == jeng.stats["decode_steps"]


def test_config_checks_match_jax(models):
    """A missing draft, a vocabulary mismatch, and ``mixed_step`` with
    ``spec_k > 0`` ("auto" resolves to off, True is refused), each with the
    JAX engine's message."""
    jcfg, tree, params, cfg = models["target"]
    bad_cfg = get_config("llama-smoke")
    jbad = jax_configs.get_config("llama-smoke")
    cases = [
        (dict(spec_k=2, **BASE), None, None, "needs a draft model"),
        (dict(spec_k=2, **BASE), (None, bad_cfg), (None, jbad), "vocab"),
        (dict(spec_k=2, mixed_step=True, **BASE), (params, cfg), (tree, jcfg),
         "incompatible with spec_k"),
    ]
    for ecfg, tdraft, jdraft, match in cases:
        with pytest.raises(ValueError, match=match) as te:
            engine.InferenceEngine(params, cfg, engine.EngineConfig(**ecfg), draft=tdraft)
        with pytest.raises(ValueError, match=match) as je:
            jax_engine.InferenceEngine(tree, jcfg, jax_engine.EngineConfig(**ecfg), draft=jdraft)
        assert str(te.value) == str(je.value)
    auto = dict(spec_k=2, mixed_step="auto", **BASE)
    assert engine.InferenceEngine(params, cfg, engine.EngineConfig(**auto),
                                  draft=(params, cfg)).ecfg.mixed_step is False
    assert jax_engine.InferenceEngine(tree, jcfg, jax_engine.EngineConfig(**auto),
                                      draft=(tree, jcfg)).ecfg.mixed_step is False


def test_model_node_spec_knobs(models, tmp_path):
    from agentfield_tpu_torch.serving.model_node import build_model_node, load_draft_model, main

    _, _, params, cfg = models["target"]
    _, backend = build_model_node(TARGET, params=params, device="cpu",
                                  ecfg=engine.EngineConfig(**BASE), spec_draft=DRAFT, spec_k=2)
    eng = backend.engine
    assert eng.ecfg.spec_k == 2 and eng.draft_cfg.num_layers == get_config(DRAFT).num_layers
    assert eng.draft_params["embed"].dtype == params["embed"].dtype
    backend.start()
    try:
        r = backend.generate(prompt="go", max_new_tokens=6)
        assert len(r["tokens"]) == 6 and eng.stats["spec_steps"] > 0
    finally:
        backend.stop()
    with pytest.raises(ValueError, match="spec_draft"):
        build_model_node(TARGET, params=params, device="cpu", spec_k=2)
    with pytest.raises(FileNotFoundError):  # a directory without a checkpoint
        load_draft_model(str(tmp_path), cfg.vocab_size, device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        load_draft_model("llama-3.2-draft", cfg.vocab_size, device="cpu")
    with pytest.raises(SystemExit):  # the flags parse; a bad value is refused
        main(["--spec-k", "x"])


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_draft_pool_matches_jax(models, mode):
    """With ``kv_quant_dtype`` the draft's pool is quantized too. After the
    first spec step its values are bit-equal to the JAX draft cache's on
    every live page, and its per-slot scales within ``SCALE_ULPS`` units in
    the last place: the scale is max|x| / 127 (or / 448) of K/V that two
    frameworks' float32 matmuls round apart by an ulp or two (the quantizer
    itself is held bit for bit in ``test_torch_kv_quant.py``). The run then
    finishes with the JAX engine's tokens and counters."""
    from test_torch_kv_quant import _np_bits

    jeng, teng = _engines(models, dict(spec_k=3, kv_quant_dtype=mode, **BASE))
    for mod, eng in ((jax_engine, jeng), (engine, teng)):
        for r in _reqs(mod):
            eng.submit(r)
        while eng.stats["spec_steps"] < 1:
            eng.step()
        eng._harvest_inflight()
    for got, want in ((teng.draft_cache.k_pages, jeng.draft_cache.k_pages),
                      (teng.draft_cache.v_pages, jeng.draft_cache.v_pages)):
        np.testing.assert_array_equal(_np_bits(got.q)[:, 1:], _np_bits(want.q)[:, 1:])
        a, b = (_np_bits(x.scale)[:, 1:].astype(np.int64) for x in (got, want))
        assert np.abs(a - b).max() <= SCALE_ULPS  # positive floats: bits order as values
    assert teng.stats["kv_quant_pages_total"] > 0
    rest = []
    for eng in (jeng, teng):
        toks: dict[str, list[int]] = {}
        while eng.has_work():
            for ev in eng.step():
                toks.setdefault(ev.request_id, []).append(ev.token)
        rest.append(toks)
    assert rest[0] == rest[1]
    _same_counters(jeng, teng)


# ---------------------------------------------------------------------------
# one spec step on fixed inputs


def _pools(cfg, P, ps, rng):
    shape = (cfg.num_layers, P, cfg.num_kv_heads, ps, cfg.head_dim)
    return [(rng.standard_normal(shape) * 0.5).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("draft", ["draft", "self"])
@pytest.mark.parametrize("k", [1, 3])
def test_one_step_matches_jax_spec_decode_fn(models, draft, k):
    """One ``spec_step`` against the JAX ``_spec_decode_fn`` on the same
    pools (random cached KV), rows at contexts 5, 17 and 40 and one padding
    row, greedy: emitted tokens, counts, lengths and next tokens equal,
    logprobs within ``LP_TOL``, both models' pools within 1e-5 (the KV the
    step writes) and bit-equal where nothing was written."""
    jcfg, tree, params, cfg = models["target"]
    d = models["target" if draft == "self" else "draft"]
    ps, maxp = 16, 4
    B = 4
    P = B * maxp + 1
    rng = np.random.default_rng(11 + k)
    tk, tv = _pools(cfg, P, ps, rng)
    dk, dv = (tk, tv) if draft == "self" else _pools(d[3], P, ps, rng)
    tables = (np.arange(B * maxp, dtype=np.int32) + 1).reshape(B, maxp)
    seq_lens = np.array([5, 17, 0, 40], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
    temps = np.zeros(B, np.float32)
    top_ks, top_ps = np.zeros(B, np.int32), np.ones(B, np.float32)
    jecfg = jax_engine.EngineConfig(spec_k=k, chunk_attn_impl="ref", **BASE)
    fn = jax_engine._spec_decode_fn(jcfg, d[0], jecfg)
    j = fn(tree, jnp.asarray(tk), jnp.asarray(tv), d[1], jnp.asarray(dk), jnp.asarray(dv),
           *(jnp.asarray(a) for a in (tokens, seq_lens, tables, temps, top_ks, top_ps)),
           jax.random.PRNGKey(0))
    j = [np.asarray(a) for a in j]

    def cache(c, kp, vp):
        return PagedKVCache(torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy()), ps)

    tgt = PagedModel(params, cfg, cache(cfg, tk, tv), None)
    drf = PagedModel(d[2], d[3], cache(d[3], dk, dv), None)
    out = spec_step(tgt, drf, torch.from_numpy(tokens.astype(np.int64)),
                    torch.from_numpy(seq_lens), torch.from_numpy(tables),
                    *(torch.from_numpy(a) for a in (temps, top_ks, top_ps)),
                    k, torch.Generator().manual_seed(0), "greedy")
    counts = out.counts.numpy()
    np.testing.assert_array_equal(counts, j[2])
    live = np.arange(k + 1)[:, None] < counts[None]  # [W, B] emitted positions
    np.testing.assert_array_equal(out.emitted.numpy()[live], j[0][live])
    np.testing.assert_allclose(out.logprobs.numpy()[live], j[1][live], atol=LP_TOL, rtol=0)
    np.testing.assert_array_equal(out.new_seq_lens.numpy(), j[3])
    np.testing.assert_array_equal(out.next_tokens.numpy(), j[4])
    if draft == "self":
        assert counts.max() == k + 1  # the self draft is accepted
    for got, want, before in ((tgt.cache.k_pages, j[5], tk), (tgt.cache.v_pages, j[6], tv),
                              (drf.cache.k_pages, j[7], dk), (drf.cache.v_pages, j[8], dv)):
        got = got.numpy()
        np.testing.assert_allclose(got[:, 1:], want[:, 1:], atol=1e-5, rtol=0)
        same = (want == before)
        np.testing.assert_array_equal(got[:, 1:][same[:, 1:]], before[:, 1:][same[:, 1:]])


@pytest.mark.parametrize("draft", ["independent", "overlapping"])
def test_rejection_sampling_gives_the_tempered_target_distribution(models, draft):
    """Monte Carlo on ``spec_step`` itself: 6000 rows share one context
    (each its own pages), the target's lm_head scaled 30x so its tempered
    distribution p is peaked. The draft is either the independent
    llama-nano, flat (low acceptance: the residual path carries most of the
    mass; 2% of first proposals accepted), or the target with its lm_head
    scaled 12x, a flatter q of the same shape (43% accepted: the
    acceptance test decides much of the mass).
    The first emitted token of every row must follow p, computed exactly
    from the dense forward: Pearson's chi-square over the tokens expected 5
    or more times (the rest lumped) stays below the 0.1% critical value.
    The draws are seeded, so the run is deterministic."""
    from scipy.stats import chi2

    jcfg, tree, params, cfg = models["target"]
    sharp = dict(params, lm_head=params["lm_head"] * 30.0)
    if draft == "independent":
        _, _, dparams, dcfg = models["draft"]
    else:
        dparams, dcfg = dict(params, lm_head=params["lm_head"] * 12.0), cfg
    B, ps, k, temp = 6000, 16, 2, 1.0
    prompt, nxt = [7, 11, 13], 19
    P = B + 1
    tables = (np.arange(B, dtype=np.int32) + 1)[:, None]
    tgt = PagedModel(sharp, cfg, PagedKVCache.create(cfg, P, ps, "float32", device="cpu"), None)
    drf = PagedModel(dparams, dcfg, PagedKVCache.create(dcfg, P, ps, "float32", device="cpu"), None)
    toks = torch.tensor([prompt], dtype=torch.int64).expand(B, -1)
    zeros = torch.zeros(B, dtype=torch.int32)
    for m in (tgt, drf):  # the prompt's KV into every row's page
        rows_forward(m, toks, zeros, zeros + len(prompt), torch.from_numpy(tables), unembed=False)
    out = spec_step(tgt, drf, torch.full((B,), nxt, dtype=torch.int64), zeros + len(prompt),
                    torch.from_numpy(tables), torch.full((B,), temp), zeros, torch.ones(B), k,
                    torch.Generator().manual_seed(1), "sampled")
    first = out.emitted[0].numpy()
    from agentfield_tpu_torch.models import llama

    logits, _ = llama.forward(sharp, cfg, torch.tensor([prompt + [nxt]]),
                              torch.arange(len(prompt) + 1)[None], collect_kv=False)
    p = torch.softmax(logits[0, -1] / temp, dim=-1).double().numpy()
    assert p.max() > 0.05  # the scaling concentrated it
    counts = np.bincount(first, minlength=p.size)
    accepted = float((out.counts.numpy() > 1).mean())
    # which path carries the mass
    assert accepted < 0.1 if draft == "independent" else accepted > 0.3, accepted
    big = p * B >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(p[big] * B, p[~big].sum() * B)
    stat = float(((obs - exp) ** 2 / exp).sum())
    assert stat < chi2.ppf(0.999, len(obs) - 1), (stat, len(obs))


# ---------------------------------------------------------------------------
# chip_smoke.py's spec phase and shapes


def test_smoke_spec_phase_rehearses_on_cpu(models):
    """``chip_smoke.phase_spec`` end to end on the CPU at a small size
    (llama-tiny target, llama-nano as the independent draft, short
    prompts): all four runs answer every request and balance their pages,
    the self draft emits more than 2 tokens a row per spec step, the
    verify's position-0 logits equal the plain step's (one plain version on
    both sides), the schema row holds speculation off until it finishes and
    the draft then replays the tokens it missed."""
    import chip_smoke

    _, _, params, cfg = models["target"]
    results = {"forward": {"tol_bf16": 1e-5}}
    chip_smoke.phase_spec(results, {"params": params, "cfg": cfg}, 0, max_new=80,
                          prompt_lengths=(20, 60, 100, 150), draft_preset=DRAFT, device="cpu")
    spec = results["spec"]
    assert spec["b_self_k3"]["tokens_per_row_spec_step"] > 2.0
    assert spec["b_self_k3"]["greedy_tokens_equal_to_plain"] == 1.0  # float32: no near-tie flips
    assert spec["b_self_k3"]["verify_logits_check"]["max_abs_err"] <= 1e-5
    for run in ("c_draft_k3", "c_draft_k1"):
        assert spec[run]["spec_steps"] > 0 and spec[run]["resync_tokens"] > 0
        assert spec[run]["requests"] == 7
    assert spec["a_plain"]["spec_steps"] == 0


def test_smoke_holds_the_spec_launches_at_full_width():
    """``chip_smoke.py`` checks, times and fault-tests the verify launch at
    Llama-3-8B heads (W = k + 1 rows, one a sequence, contexts 1900 to
    2048 - W, at the decode buckets of 4 and 16 rows; k = 3 through the
    tensor-core tile, k = 1 through the split-context path at its 8-row
    instance) and the draft's decode at llama-3.2-draft's heads, each also
    over int8 and fp8 pools."""
    import chip_smoke

    from agentfield_tpu_torch.models.configs import PRESETS

    l3, draft = PRESETS["llama-3-8b"], PRESETS[chip_smoke.SPEC_DRAFT]
    shapes = chip_smoke.spec_shapes()
    for k, rows in chip_smoke.SPEC_VERIFY:
        p = shapes[f"llama3_verify_k{k}_b{rows}_ctx2k"]
        assert (p["kh"], p["kh"] * p["rep"], p["hd"]) == (l3.num_kv_heads, l3.num_heads, l3.head_dim)
        assert p["W"] == k + 1 and all(n == k + 1 for _, n in p["chunk_list"])
        ctx = [c for c, _ in p["chunk_list"]]
        assert len(ctx) == rows and min(ctx) == 1900 and max(ctx) == 2048 - (k + 1)
    assert {(k, r) for k, r in chip_smoke.SPEC_VERIFY} == {(1, 4), (1, 16), (3, 4), (3, 16)}
    d = shapes["llama-3.2-draft_decode_ctx2k"]
    assert (d["kh"], d["kh"] * d["rep"], d["hd"]) == (draft.num_kv_heads, draft.num_heads,
                                                      draft.head_dim)
    assert set(shapes) <= set(chip_smoke.ragged_shapes())
    assert "llama3_verify_k3_b4_ctx2k" in chip_smoke.FAULT_SHAPES
    assert {f"{n}_{m}" for n in shapes for m in chip_smoke.QUANT_MODES} <= set(
        chip_smoke.quant_shapes())
