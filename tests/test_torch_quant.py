"""The port's weight-only int8 quantization (``agentfield_tpu_torch.models.
quant``) against the JAX package's (``agentfield_tpu.models.quant``) and
``tests/test_quant.py``'s scripts, on the CPU (llama-tiny, float32):

- ``quantize_weight`` on the same numpy weights: q bit-equal and scale
  equal, with a column of zeros (the 1e-8 floor) and exact .5 ties (both
  round half to even); ``QUANT_KEYS`` equal; ``quantize_params`` idempotent;
- the plain ``x @ QuantW`` (the JAX formula, which CPU tensors run) within
  1e-5 relative of the JAX ``x @ QuantW``;
- the converter carries a JAX-quantized tree across bit for bit;
- dense ``forward`` logits and ``forward(return_hidden=True)`` of both
  packages on the same quantized weights within ``ATOL`` (float32 sums in
  another order);
- ``test_engine_serves_quantized``'s script through both engines: equal
  greedy tokens; ``build_model_node(quant="int8")`` and its errors; embed on
  an int8 node against the JAX node's within 1e-5;
- ``chip_smoke.phase_quant`` rehearsed at llama-tiny size on the CPU;
- the kernel's launch plan takes every preset's widths and refuses others,
  and the CUDA dispatch never falls back to the plain version.
"""

from __future__ import annotations

import asyncio
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentfield_tpu.models import configs as jax_configs
from agentfield_tpu.models import llama as jax_llama
from agentfield_tpu.models import quant as jax_quant
from agentfield_tpu.serving import engine as jax_engine
from agentfield_tpu.serving import model_node as jax_node
from agentfield_tpu.serving.sampler import SamplingParams as JaxSampling
from agentfield_tpu_torch.models import llama
from agentfield_tpu_torch.models import quant
from agentfield_tpu_torch.models.configs import PRESETS, get_config
from agentfield_tpu_torch.models.convert import params_from_numpy
from agentfield_tpu_torch.ops.cuda import quant_matmul as qm
from agentfield_tpu_torch.ops.cuda import ragged_paged_attention as rpa
from agentfield_tpu_torch.serving import engine
from agentfield_tpu_torch.serving.engine import EngineConfig
from agentfield_tpu_torch.serving.model_node import ModelBackend, build_model_node
from agentfield_tpu_torch.serving.sampler import SamplingParams
from agentfield_tpu_torch.serving.tokenizer import ByteTokenizer

ATOL = 1e-5  # float32: the same products summed in another order
RTOL_MATMUL = 1e-5  # x @ QuantW, relative to max |y|
ECFG = dict(max_batch=2, page_size=16, num_pages=32, max_pages_per_seq=4)  # test_quant.py's
CFG = get_config("llama-tiny")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """llama-tiny gains nothing from intra-op threads; one keeps this file
    off the cores that concurrent test workers time their locks on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """(jax cfg, the JAX fp tree as numpy, the JAX quantized tree as numpy
    leaves, the port's quantized params carried across)."""
    jcfg = dataclasses.replace(jax_configs.get_config("llama-tiny"), dtype="float32")
    tree = jax_llama.init_params(jcfg, jax.random.PRNGKey(0))
    fp = jax.tree.map(np.asarray, tree)
    qtree = jax.tree.map(np.asarray, jax_quant.quantize_params(tree))
    return jcfg, fp, qtree, params_from_numpy(qtree, CFG, device="cpu")


def _ties_and_zeros(rng) -> np.ndarray:
    """[64, 8] weights: column 0 all zero (the 1e-8 floor), columns 1-3
    with amax 127 * 2^-7 (scale exactly 2^-7) and entries k + 0.5 in units
    of the scale (exact ties), the rest random."""
    w = (rng.standard_normal((64, 8)) * 0.05).astype(np.float32)
    w[:, 0] = 0.0
    s = np.float32(2.0**-7)
    for c in (1, 2, 3):
        k = rng.integers(-126, 126, 64).astype(np.float32)
        w[:, c] = (k + np.float32(0.5)) * s
        w[0, c] = 127 * s * (1 if c != 2 else -1)
    return w


@pytest.mark.parametrize("shape", [(16, 24), (3, 64, 32), "ties_zeros"], ids=str)
def test_quantize_weight_bit_equal_to_jax(shape):
    rng = np.random.default_rng(1)
    w = _ties_and_zeros(rng) if shape == "ties_zeros" else (
        rng.standard_normal(shape) * 0.1).astype(np.float32)
    want = jax_quant.quantize_weight(jnp.asarray(w))
    got = quant.quantize_weight(torch.from_numpy(w))
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    if shape == "ties_zeros":
        assert (got.q[:, 0] == 0).all() and got.scale[0] == np.float32(1e-8) / np.float32(127)
        assert (got.scale[1:4] == 2.0**-7).all()
        # ties went to the even neighbour
        k = w[1:, 1:4] / 2.0**-7
        assert np.array_equal(got.q[1:, 1:4].numpy(), np.round(k).astype(np.int8))


def test_quant_keys_and_idempotent_params(weights):
    assert quant.QUANT_KEYS == jax_quant.QUANT_KEYS
    fp = params_from_numpy(weights[1], CFG, device="cpu")
    qp = quant.quantize_params(fp)
    assert quant.is_quantized(qp) and not quant.is_quantized(fp)
    for k in quant.QUANT_KEYS:
        assert isinstance(qp["layers"][k], quant.QuantW)
    assert qp["layers"]["attn_norm"] is fp["layers"]["attn_norm"]
    assert qp["embed"] is fp["embed"]
    qp2 = quant.quantize_params(qp)
    assert qp2["layers"]["wq"] is qp["layers"]["wq"]  # no double-quant
    # the port's quantization of the carried fp tree equals the JAX one's
    for k in quant.QUANT_KEYS:
        assert torch.equal(qp["layers"][k].q, weights[3]["layers"][k].q), k
        assert torch.equal(qp["layers"][k].scale, weights[3]["layers"][k].scale), k


@pytest.mark.parametrize("xshape", [(4, 16), (2, 3, 16)], ids=["2d", "3d"])
def test_rmatmul_matches_jax(xshape):
    rng = np.random.default_rng(2)
    w = rng.standard_normal((16, 24)).astype(np.float32)
    x = rng.standard_normal(xshape).astype(np.float32)
    want = np.asarray(jnp.asarray(x) @ jax_quant.quantize_weight(jnp.asarray(w)))
    got = (torch.from_numpy(x) @ quant.quantize_weight(torch.from_numpy(w))).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL_MATMUL * np.abs(want).max())
    # the plain version is the JAX formula; the dequantized product agrees
    deq = x @ quant.quantize_weight(torch.from_numpy(w)).dequantize().numpy()
    np.testing.assert_allclose(got, deq, rtol=1e-5, atol=1e-5)


def test_converter_carries_quantized_tree_bit_for_bit(weights):
    _, _, qtree, params = weights
    for k in quant.QUANT_KEYS:
        leaf, got = qtree["layers"][k], params["layers"][k]
        assert isinstance(got, quant.QuantW)
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(leaf.q))
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(leaf.scale))
    # fp leaves carried as before
    np.testing.assert_array_equal(params["embed"].numpy(), np.asarray(qtree["embed"]))
    # a (q, scale) pair is taken too, and a shape mismatch raises
    pair = {**qtree, "layers": {**qtree["layers"],
                                "wq": (qtree["layers"]["wq"].q, qtree["layers"]["wq"].scale)}}
    assert torch.equal(params_from_numpy(pair, CFG, device="cpu")["layers"]["wq"].q,
                       params["layers"]["wq"].q)
    bad = {**qtree, "layers": {**qtree["layers"],
                               "wk": (qtree["layers"]["wk"].q[:, :, :8],
                                      qtree["layers"]["wk"].scale[:, :8])}}
    with pytest.raises(ValueError, match="layers.wk"):
        params_from_numpy(bad, CFG, device="cpu")
    with pytest.raises(ValueError, match="int8"):  # q must stay int8
        params_from_numpy({**qtree, "layers": {**qtree["layers"], "wq": (
            np.asarray(qtree["layers"]["wq"].q, np.float32), qtree["layers"]["wq"].scale)}},
            CFG, device="cpu")


@pytest.mark.parametrize("impl", [("ref", "ref"), ("flash", "kernel")], ids=["ref", "kernel"])
def test_forward_matches_jax_on_quantized_weights(weights, impl):
    jcfg, _, qtree, params = weights
    jtree = jax.tree.map(jnp.asarray, qtree)
    rng = np.random.default_rng(4)
    B, S = 2, 16
    tokens = rng.integers(0, CFG.vocab_size, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    for hidden in (False, True):
        want, _ = jax_llama.forward_impl(jtree, jcfg, jnp.asarray(tokens), jnp.asarray(pos),
                                         collect_kv=False, attn_impl=impl[0],
                                         return_hidden=hidden)
        got, _ = llama.forward(params, CFG, torch.from_numpy(tokens).long(),
                               torch.from_numpy(pos), attn_impl=impl[1], collect_kv=False,
                               return_hidden=hidden)
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=ATOL, rtol=0)


def test_engine_serves_quantized_like_jax(weights):
    """``tests/test_quant.py::test_engine_serves_quantized``'s script
    through both engines on the same int8 weights: equal greedy tokens, and
    the repeated prompt decodes the same again."""
    jcfg, _, qtree, params = weights

    def script(eng, req, samp):
        out = eng.run_to_completion([
            req(id="q0", prompt=[1, 2, 3], sampling=samp(max_new_tokens=8)),
            req(id="q1", prompt=[9, 8, 7, 6], sampling=samp(max_new_tokens=8)),
        ])
        out.update(eng.run_to_completion([req(id="q2", prompt=[1, 2, 3],
                                              sampling=samp(max_new_tokens=8))]))
        return out

    jeng = jax_engine.InferenceEngine(jax.tree.map(jnp.asarray, qtree), jcfg,
                                      jax_engine.EngineConfig(**ECFG))
    want = script(jeng, jax_engine.Request, JaxSampling)
    teng = engine.InferenceEngine(params, CFG, EngineConfig(**ECFG))
    try:
        got = script(teng, engine.Request, SamplingParams)
    finally:
        teng.close()
    assert got == want
    assert all(len(v) == 8 for v in got.values()) and got["q2"] == got["q0"]


def test_build_model_node_quant_knob():
    server, backend = build_model_node("llama-tiny", ecfg=EngineConfig(**ECFG), device="cpu",
                                       quant="int8")
    assert quant.is_quantized(backend.engine.params)
    assert not isinstance(backend.engine.params["embed"], quant.QuantW)
    backend.start()
    try:
        r = backend.generate(prompt="hi", max_new_tokens=4)
        assert len(r["tokens"]) == 4
    finally:
        backend.stop()
        backend.engine.close()
    with pytest.raises(ValueError, match="unknown quant mode"):
        build_model_node("llama-tiny", device="cpu", quant="fp4")
    from agentfield_tpu_torch.serving.model_node import main

    with pytest.raises(SystemExit):  # the flag parses; another mode is refused
        main(["--quant", "fp4"])


def test_embed_on_int8_node_matches_jax(weights):
    jcfg, _, qtree, params = weights
    ecfg = dict(max_batch=2, page_size=8, num_pages=64, max_pages_per_seq=8)

    async def jax_embed():
        b = jax_node.ModelBackend(jax.tree.map(jnp.asarray, qtree), jcfg,
                                  jax_node.EngineConfig(**ecfg),
                                  tokenizer=jax_node.ByteTokenizer(CFG.vocab_size))
        return await b.embed(prompt="int8 embedding check")

    want = asyncio.run(jax_embed())
    b = ModelBackend(params, CFG, EngineConfig(**ecfg), tokenizer=ByteTokenizer(CFG.vocab_size),
                     idle_sleep=0.001)
    b.start()
    try:
        got = b.embed(prompt="int8 embedding check")
    finally:
        b.stop()
        b.engine.close()
    assert got["dim"] == CFG.hidden_size == want["dim"]
    assert abs(math.sqrt(sum(v * v for v in got["embedding"])) - 1.0) < 1e-5
    np.testing.assert_allclose(got["embedding"], want["embedding"], atol=1e-5, rtol=0)


def test_smoke_quant_phase_rehearses_on_cpu(weights):
    """``chip_smoke.phase_quant`` end to end on the CPU at llama-tiny size:
    the int8 node answers the serve's script (short prompts), the kernel
    and plain logits agree (both the plain version here), and the mixed
    burst and the speculative pass (llama-nano draft) run on the int8
    target."""
    import chip_smoke

    fp = params_from_numpy(weights[1], CFG, device="cpu")
    ecfg = EngineConfig(max_batch=8, page_size=16, num_pages=256, max_pages_per_seq=32,
                        decode_buckets=(4,), grammar_slots=64)
    results: dict = {}
    chip_smoke.phase_quant(results, {"params": fp, "cfg": CFG, "ecfg": ecfg}, 0, device="cpu",
                           model="llama-tiny", lengths=(8, 20, 33), max_new=6, S=24,
                           burst=((10, 20), (40,)), spec_prompts=(12, 30), draft_preset="llama-nano")
    out = results["quant"]
    assert results["serve_w8"]["requests"] == 6
    assert out["logits"]["max_abs_err_f32"] == 0.0 and out["logits"]["max_abs_err_bf16"] == 0.0
    assert out["mixed"]["mixed_ticks"] > 0 and out["spec"]["spec_steps"] > 0
    assert out["weights"]["layer_int8_bytes"] < out["weights"]["layer_bf16_bytes"]


@pytest.mark.parametrize("name", sorted(n for n, c in PRESETS.items() if c.num_experts == 0))
def test_plan_takes_every_preset_width(name):
    """At every projection width of the preset and the main path's row
    counts: the plan names an instance the source builds; its CTAs cover
    every output tile (panel x rows of x) and every K tile exactly once,
    and each cluster's combine covers the tile's rows exactly once; a
    cluster is portable (at most 8 splits) and a CTA's partial tile fits
    the shared memory its ring takes (no workspace, no counters); x pads at
    most 7 rows at decode widths."""
    cfg = PRESETS[name]
    d, f = cfg.hidden_size, cfg.intermediate_size
    for K, N in ((d, cfg.q_dim), (d, cfg.kv_dim), (cfg.q_dim, d), (d, f), (f, d)):
        for M in (1, 8, 16, 32, 64, 200, 512, 1920, 2048):
            p = qm.plan(M, K, N)
            nx, cw, splits, per = p["nx"], p["cw"], p["splits"], p["kt_per_split"]
            nkt, panels = -(-K // qm.K_TILE), -(-N // qm.PANEL)
            assert (nx, cw) in qm.INSTANCES and 1 <= splits <= qm.MAX_SPLITS
            assert p["path"] == ("stream" if M <= qm.STREAM_MAX_M else "tiled")
            if M <= qm.STREAM_MAX_M:
                assert 0 <= nx - M <= 7
            # K tiles: split s takes [s * per, min((s + 1) * per, nkt)), never empty
            kt = np.zeros(nkt, int)
            for sp in range(splits):
                lo, hi = sp * per, min((sp + 1) * per, nkt)
                assert hi > lo
                kt[lo:hi] += 1
            # panels: group g takes [g * cw, g * cw + live); rows: tile z [z * nx, ...)
            pn = np.zeros(p["groups"] * cw, int)
            for g in range(p["groups"]):
                live = min(cw, panels - g * cw)
                assert live >= 1
                pn[g * cw:g * cw + live] += 1
            rows = np.zeros(p["m_tiles"] * nx, int)
            for z in range(p["m_tiles"]):
                rows[z * nx:(z + 1) * nx] += 1
            # a tile's rows among the cluster's ranks in the combine
            comb = np.zeros(nx, int)
            for rk in range(splits):
                comb[rk * nx // splits:(rk + 1) * nx // splits] += 1
            assert (kt == 1).all() and (pn[:panels] == 1).all() and (pn[panels:] == 0).all()
            assert (rows[:M] == 1).all() and (comb == 1).all()
            assert p["ctas"] == splits * p["groups"] * p["m_tiles"]
            sm = qm.cta_smem(nx, cw)
            assert sm["stages"] >= 2 and sm["smem_bytes"] <= qm.SMEM_LIMIT
            assert sm["partial_bytes"] <= sm["smem_bytes"]


def test_first_product_on_a_device_is_not_captured(monkeypatch):
    """The kernel is set up on a device (its instances' shared-memory
    limits, the tensor-map encoder) at the device's first product; a first
    product inside a graph capture is refused, and nothing is set up."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="first product on a device"):
        qm._device_state(torch.device("cuda", 97))
    assert 97 not in qm._sms


def test_plan_refuses_widths_it_cannot_tile():
    for K, N in ((4100, 4096), (4096, 1000), (0, 4096)):
        with pytest.raises(ValueError, match="multiple"):
            qm.plan(8, K, N)


def test_cuda_dispatch_never_falls_back():
    """A tensor off the CPU goes to the kernel's wrapper, which raises on
    what it cannot launch: a ``meta`` tensor is refused, not sent to the
    plain version, and so is a packed q beside CPU tensors; and a launch
    the runtime refuses raises with its CUDA error, counting nothing."""
    w = quant.quantize_weight(torch.randn(64, 32))
    x = torch.empty((4, 64), device="meta")
    meta_w = quant.QuantW(w.q.to("meta"), w.scale.to("meta"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        x @ meta_w
    with pytest.raises(ValueError, match="not supported"):
        qm.int8_weight_matmul_cuda(x.to(torch.float16), meta_w.q, meta_w.scale)
    with pytest.raises(ValueError, match="CUDA tensor"):  # packed, but on the CPU
        qm.int8_weight_matmul_cuda(torch.randn(4, 64), qm.pack_int8_weight(w.q), w.scale)

    calls = []

    def refused(*args):  # the C entry of a launch the runtime refused
        calls.append(args)
        return 98  # cudaErrorInvalidDeviceFunction

    before = rpa.launch_counts()
    y = torch.empty((4, 32))
    with pytest.raises(RuntimeError, match="CUDA error 98 \\(invalid device function\\)"):
        qm._launch(refused, lambda rc: b"invalid device function", torch.randn(4, 64),
                   qm.pack_int8_weight(w.q), w.scale, y, 4, 64, 32, qm.plan(4, 64, 32), 0)
    assert len(calls) == 1 and rpa.launch_counts() == before


def test_launch_counters_join_the_graph_accounting():
    """The int8 matmul's counters are among the ones a decode graph's owner
    reads and replays (``rpa.launch_counts`` / ``add_launches``), and
    ``reset_launches`` clears them."""
    counts = rpa.launch_counts()
    assert {"int8_weight_matmul", "w8_stream", "w8_tiled", "w8_splitk"} <= set(counts)
    rpa.add_launches({"int8_weight_matmul": 224, "w8_stream": 224})
    assert qm.LAUNCHES["int8_weight_matmul"] == counts["int8_weight_matmul"] + 224
    rpa.reset_launches()
    assert not any(rpa.launch_counts().values())


def test_cpu_tensors_take_the_plain_version():
    w = quant.quantize_weight(torch.randn(64, 32))
    x = torch.randn(3, 64)
    before = rpa.launch_counts()
    y = x @ w
    assert rpa.launch_counts() == before
    assert torch.equal(y, qm.int8_weight_matmul_ref(x, w.q, w.scale))
    sl = quant.quantize_weight(torch.randn(2, 64, 32))[1]
    assert sl.q.shape == (64, 32) and sl.scale.shape == (32,)
    # an expert stack's contraction takes the JAX formula on CPU tensors
    ew = quant.quantize_weight(torch.randn(2, 64, 32))
    before = rpa.launch_counts()
    y = ew.expert_einsum("bsd,edf->besf", x[None])
    assert rpa.launch_counts() == before and tuple(y.shape) == (1, 2, 3, 32)
    assert torch.equal(y, torch.einsum("bsd,edf->besf", x[None], ew.q.float())
                       * ew.scale[:, None, :])
    with pytest.raises(ValueError, match="expert_einsum supports"):
        w.expert_einsum("bsd,df->bsf", x)


def test_smoke_holds_every_projection_and_rejects_faults():
    """``chip_smoke.py`` holds the kernel at every Llama-3-8B projection for
    the main path's row counts and at a phi-3-mini width; its element bound
    (rehearsed here with the plain version standing in for the kernel)
    passes the intact product and rejects a zeroed K tile and a doubled
    column scale at both fault shapes; the kernels line carries the
    kernel's entry."""
    import chip_smoke as c

    shapes = c.w8_shapes()
    cfg = get_config("llama-3-8b")
    d, f = cfg.hidden_size, cfg.intermediate_size
    for K, N in ((d, cfg.q_dim), (d, cfg.kv_dim), (cfg.q_dim, d), (d, f), (f, d)):
        assert {M for M, k, n in shapes.values() if (k, n) == (K, N)} == set(c.W8_M)
    assert {1, 8, 16, 32, 512, 2048} <= set(c.W8_M)
    assert any(K == get_config("phi-3-mini").hidden_size for _, K, _ in shapes.values())
    assert set(c.W8_FAULT_SHAPES) <= set(shapes)
    g = torch.Generator().manual_seed(0)
    for name in c.W8_FAULT_SHAPES:
        M, K, N = shapes[name]
        N = 512  # the faults are per column; a slice of N keeps this quick
        w = quant.quantize_weight(torch.empty((K, N)).normal_(0.0, 0.02, generator=g))
        x = torch.empty((M, K)).normal_(0.0, 1.0, generator=g)
        y_r = (x @ w.q.float()) * w.scale
        s_abs = (x.abs() @ w.q.float().abs()) * w.scale
        for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            assert c.w8_compare(y_r.to(dt), y_r, s_abs, K, dname)[0]
            bad_q = w.q.clone()
            k0 = c.K_TILE_ROWS * ((K // c.K_TILE_ROWS) // 2)
            bad_q[k0:k0 + c.K_TILE_ROWS] = 0
            bad_s = w.scale.clone()
            bad_s[int(y_r.abs().amax(0).argmax())] *= 2
            for fy in ((x @ bad_q.float()) * w.scale, (x @ w.q.float()) * bad_s):
                assert c.w8_compare(fy.to(dt), y_r, s_abs, K, dname)[2] > 1.0
    rows = {f"w8_{k}/{dn}": {"kernel": "int8_weight_matmul", "dtype": dn, "ms": 1.0,
                             "call_ms": 1.0, "plain_ms": 2.0, "bound_ms": 0.5,
                             "bound_by": "bytes", "library_ms": None, "cublas_bf16_ms": 1.0,
                             "max_abs_err": 0.01, "max_err_over_bound": 0.2}
            for k in shapes for dn in ("float32", "bfloat16")}
    entry = c.w8_kernel_entry({"shapes": rows, "quant": {"launches": {"int8_weight_matmul": 7}},
                               "serve_w8": {"w8_launches_per_decode_step": 224},
                               "moe": {"launches": {"int8_weight_matmul": 28},
                                       "w8_launches_per_decode_step": 896}})
    # the quant and moe phases' launches
    assert entry["name"] == "int8_weight_matmul" and entry["launches"] == 7 + 28
    assert entry["launches_per_decode_step_moe"] == 896
    assert entry["source"] == c.W8_SRC and entry["replaces"].startswith(
        "agentfield_tpu/models/quant.py:")
    assert {k for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err",
                        "route")} <= set(entry)
