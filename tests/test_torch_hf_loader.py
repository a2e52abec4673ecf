"""The port's checkpoint loader (``agentfield_tpu_torch/models/hf_loader.py``)
against the JAX package's (``agentfield_tpu/models/hf_loader.py``) on the CPU.

Checkpoints, written here:

- by the JAX ``save_hf_checkpoint`` (float32): llama-tiny, a qwen2-style
  config with QKV biases, gemma-tiny (the ``norm_offset`` fold) and
  mixtral-tiny, with random norms and biases so the fold and the biases show;
- by transformers' ``save_pretrained`` in bfloat16 and float32 with a small
  ``max_shard_size`` (shards and ``model.safetensors.index.json``): the Phi-3
  (fused ``qkv_proj``/``gate_up_proj``) and Mistral sliding-window configs
  of ``tests/test_llama.py``, Qwen2 and Mixtral (``block_sparse_moe``).

Checks: every leaf bit-equal to the JAX loader's at ``dtype`` float32 and
bfloat16; ``config_from_hf`` field for field, and its four ``ValueError``s;
the missing-tensor ``KeyError`` and an unknown header dtype; the port's
``save_hf_checkpoint`` read back by the JAX loader; ``quant="int8"`` equal
to the JAX ``quantize_params`` of the JAX load, q and scale bit for bit;
``load_draft_model(dir)``; a two-layer engine's greedy answer on the loaded
weights equal to the JAX engine's (float32); ``chip_smoke.phase_ckpt``
rehearsed with ``device="cpu"`` at llama-nano and mixtral-tiny size, and
the smoke's own Llama-3-form tokenizer read by transformers.
"""

from __future__ import annotations

import dataclasses
import json
import struct

import jax
import numpy as np
import pytest
import torch

from agentfield_tpu.models import configs as jax_configs
from agentfield_tpu.models import hf_loader as jax_hf
from agentfield_tpu.models import llama as jax_llama
from agentfield_tpu.models import quant as jax_quant
from agentfield_tpu.serving import engine as jax_engine
from agentfield_tpu.serving.sampler import SamplingParams as JaxSampling
from agentfield_tpu_torch.models import hf_loader
from agentfield_tpu_torch.models.configs import get_config
from agentfield_tpu_torch.models.quant import QuantW
from agentfield_tpu_torch.serving import engine
from agentfield_tpu_torch.serving.sampler import SamplingParams

transformers = pytest.importorskip("transformers")

DTYPES = ("float32", "bfloat16")
ECFG = dict(max_batch=2, page_size=16, num_pages=32, max_pages_per_seq=4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny models gain nothing from intra-op threads; one keeps this file
    off the cores that concurrent test workers time their locks on."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tree(name: str, seed: int, **over):
    jcfg = dataclasses.replace(jax_configs.get_config(name), dtype="float32", **over)
    tree = jax.tree.map(np.asarray, jax_llama.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    layers = tree["layers"]
    for k in ("attn_norm", "mlp_norm", "bq", "bk", "bv"):  # make the fold and biases show
        if k in layers:
            layers[k] = rng.normal(1.0 if "norm" in k else 0.0, 0.1, layers[k].shape).astype(
                np.float32)
    tree["final_norm"] = rng.normal(1.0, 0.1, tree["final_norm"].shape).astype(np.float32)
    return jcfg, tree


def _hf_model(kind: str):
    common = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
                  rope_theta=10000.0, tie_word_embeddings=False)
    if kind == "phi3":  # tests/test_llama.py:364
        cfg = transformers.Phi3Config(rms_norm_eps=1e-5, pad_token_id=0, bos_token_id=1,
                                      eos_token_id=2, **common)
        cls = transformers.Phi3ForCausalLM
    elif kind == "mistral-window":  # tests/test_llama.py:270
        cfg = transformers.MistralConfig(head_dim=16, rms_norm_eps=1e-5, sliding_window=4,
                                         **common)
        cls = transformers.MistralForCausalLM
    elif kind == "qwen2":
        cfg = transformers.Qwen2Config(rms_norm_eps=1e-6, use_sliding_window=False, **common)
        cls = transformers.Qwen2ForCausalLM
    else:
        assert kind == "mixtral-hf"
        cfg = transformers.MixtralConfig(num_local_experts=4, num_experts_per_tok=2,
                                         head_dim=16, rms_norm_eps=1e-5, **common)
        cls = transformers.MixtralForCausalLM
    torch.manual_seed(0)
    model = cls(cfg).eval()
    with torch.no_grad():  # random norms (HF inits them to 1)
        for n, p in model.named_parameters():
            if "norm" in n:
                p.normal_(1.0, 0.1)
    return model


JAX_WRITTEN = {"llama": ("llama-tiny", {}), "qwen2-bias": ("llama-tiny", {"attn_bias": True}),
               "gemma": ("gemma-tiny", {}), "mixtral": ("mixtral-tiny", {})}
HF_WRITTEN = ("phi3", "mistral-window", "qwen2", "mixtral-hf")
CKPTS = list(JAX_WRITTEN) + [f"{k}-{dt}" for k in HF_WRITTEN for dt in ("bf16", "f32")]


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    out = {}
    for key, (name, over) in JAX_WRITTEN.items():
        d = tmp_path_factory.mktemp(key)
        jcfg, tree = _jax_tree(name, seed=len(out), **over)
        jax_hf.save_hf_checkpoint(d, jcfg, tree)
        out[key] = d
    for kind in HF_WRITTEN:
        model = _hf_model(kind)
        for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            d = tmp_path_factory.mktemp(f"{kind}-{tag}")
            model.to(dt).save_pretrained(d, safe_serialization=True, max_shard_size="60KB")
            out[f"{kind}-{tag}"] = d
    return out


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _assert_same_tree(port: dict, jtree: dict, label: str):
    want = dict(_leaves(jtree))
    got = dict(_leaves(port))
    assert set(got) == set(want), label
    for name, a in want.items():
        t = got[name]
        if isinstance(t, QuantW):
            assert np.array_equal(t.q.numpy(), np.asarray(a.q)), (label, name)
            assert np.array_equal(t.scale.numpy(), np.asarray(a.scale)), (label, name)
            continue
        a = np.asarray(a)
        assert tuple(t.shape) == a.shape, (label, name)
        assert str(t.dtype).removeprefix("torch.") == str(a.dtype), (label, name)
        # bit for bit: both widened to float32 exactly
        assert np.array_equal(t.float().numpy(), a.astype(np.float32)), (label, name)


def test_checkpoints_have_shards_and_index(ckpts):
    for kind in HF_WRITTEN:
        d = ckpts[f"{kind}-bf16"]
        assert len(list(d.glob("*.safetensors"))) > 1
        assert (d / "model.safetensors.index.json").exists()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ckpt", CKPTS)
def test_leaves_bit_equal_to_jax_loader(ckpts, ckpt, dtype):
    jcfg, jtree = jax_hf.load_hf_checkpoint(ckpts[ckpt], dtype=dtype)
    cfg, params = hf_loader.load_hf_checkpoint(ckpts[ckpt], dtype=dtype, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    _assert_same_tree(params, jtree, ckpt)


@pytest.mark.parametrize("ckpt", CKPTS)
def test_config_from_hf_field_by_field(ckpts, ckpt):
    jcfg = jax_hf.config_from_hf(ckpts[ckpt])
    cfg = hf_loader.config_from_hf(ckpts[ckpt])
    assert [f.name for f in dataclasses.fields(cfg)] == [f.name for f in dataclasses.fields(jcfg)]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


def test_config_from_hf_llama3_8b_and_rope_scaling(tmp_path):
    """The published Meta-Llama-3-8B config gives the llama-3-8b preset; a
    llama3 rope_scaling comes across as the JAX loader reads it."""
    doc = {"model_type": "llama", "vocab_size": 128256, "hidden_size": 4096,
           "intermediate_size": 14336, "num_hidden_layers": 32, "num_attention_heads": 32,
           "num_key_value_heads": 8, "rope_theta": 500000.0, "rms_norm_eps": 1e-5,
           "max_position_embeddings": 8192, "tie_word_embeddings": False,
           "hidden_act": "silu", "torch_dtype": "bfloat16", "bos_token_id": 128000,
           "eos_token_id": 128001}
    (tmp_path / "config.json").write_text(json.dumps(doc))
    assert hf_loader.config_from_hf(tmp_path) == get_config("llama-3-8b")
    doc["rope_scaling"] = {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                           "high_freq_factor": 4.0, "original_max_position_embeddings": 8192}
    (tmp_path / "config.json").write_text(json.dumps(doc))
    assert dataclasses.asdict(hf_loader.config_from_hf(tmp_path)) == dataclasses.asdict(
        jax_hf.config_from_hf(tmp_path))


def test_null_head_dim_is_the_default(ckpts, tmp_path):
    """transformers writes ``"head_dim": null`` into a Mixtral config by
    default. The JAX function passes the null through (its config then has
    no head dim); the port takes hidden_size / num_attention_heads."""
    doc = json.loads((ckpts["mixtral-hf-f32"] / "config.json").read_text())
    doc["head_dim"] = None
    (tmp_path / "config.json").write_text(json.dumps(doc))
    assert jax_hf.config_from_hf(tmp_path).head_dim is None
    cfg = hf_loader.config_from_hf(tmp_path)
    assert cfg.head_dim == doc["hidden_size"] // doc["num_attention_heads"] == 16
    assert dataclasses.replace(cfg, head_dim=None) == dataclasses.replace(
        hf_loader.config_from_hf(ckpts["mixtral-hf-f32"]), head_dim=None)


@pytest.mark.parametrize("edit", [
    {"model_type": "gpt2"},
    {"partial_rotary_factor": 0.5},
    {"rope_scaling": {"rope_type": "yarn", "factor": 4.0}},
    {"hidden_act": "quick_gelu"},
], ids=["model_type", "partial_rotary_factor", "rope_scaling", "hidden_act"])
def test_config_from_hf_errors_match_jax(ckpts, tmp_path, edit):
    doc = json.loads((ckpts["llama"] / "config.json").read_text())
    doc.update(edit)
    (tmp_path / "config.json").write_text(json.dumps(doc))
    with pytest.raises(ValueError) as want:
        jax_hf.config_from_hf(tmp_path)
    with pytest.raises(ValueError) as got:
        hf_loader.config_from_hf(tmp_path)
    assert str(got.value) == str(want.value)


def test_missing_tensor_and_unknown_dtype_raise(ckpts, tmp_path):
    import shutil

    d = tmp_path / "ckpt"
    shutil.copytree(ckpts["llama"], d)
    st = hf_loader.SafetensorsFile(d / "model.safetensors")
    entries = [(n, st.entries[n][1], torch.float32, (lambda n=n: st.get(n).clone()))
               for n in st.keys() if n != "model.layers.1.mlp.up_proj.weight"]
    hf_loader.write_safetensors(tmp_path / "part.safetensors", entries)
    st.close()
    (d / "model.safetensors").unlink()
    shutil.move(tmp_path / "part.safetensors", d / "model.safetensors")
    with pytest.raises(KeyError) as want:
        jax_hf.load_hf_checkpoint(d, dtype="float32")
    with pytest.raises(KeyError) as got:
        hf_loader.load_hf_checkpoint(d, dtype="float32", device="cpu")
    assert str(got.value) == str(want.value)
    # an I64 tensor where a weight should be: the error names the dtype
    raw = (ckpts["llama"] / "model.safetensors").read_bytes()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n])
    name = "model.layers.0.self_attn.q_proj.weight"
    shape = header[name]["shape"]
    header[name]["dtype"], header[name]["shape"] = "I64", [shape[0], shape[1] // 2]
    new = json.dumps(header).encode()
    new += b" " * (-len(new) % 8)
    (d / "model.safetensors").write_bytes(struct.pack("<Q", len(new)) + new + raw[8 + n:])
    with pytest.raises(ValueError, match="I64"):
        hf_loader.load_hf_checkpoint(d, dtype="float32", device="cpu")
    with pytest.raises(FileNotFoundError):
        hf_loader.load_hf_checkpoint(tmp_path / "nothing", cfg=get_config("llama-tiny"),
                                     device="cpu")


@pytest.mark.parametrize("ckpt", list(JAX_WRITTEN))
@pytest.mark.parametrize("dtype", DTYPES)
def test_port_writer_read_back_by_jax_loader(ckpts, tmp_path, ckpt, dtype):
    """The port's ``save_hf_checkpoint`` (float32 by default, or bf16 in 3
    shards) read back by the JAX loader: the leaves the JAX loader gives
    from the JAX writer's file, and the same ``config.json`` keys."""
    cfg, params = hf_loader.load_hf_checkpoint(ckpts[ckpt], dtype="float32", device="cpu")
    d = tmp_path / "out"
    if dtype == "float32":
        hf_loader.save_hf_checkpoint(d, cfg, params)
        assert json.loads((d / "config.json").read_text()) == json.loads(
            (ckpts[ckpt] / "config.json").read_text())
    else:
        hf_loader.save_hf_checkpoint(d, cfg, params, dtype="bfloat16", shards=3)
        idx = json.loads((d / "model.safetensors.index.json").read_text())
        assert sorted(set(idx["weight_map"].values())) == sorted(
            p.name for p in d.glob("*.safetensors")) and len(idx["weight_map"]) > 3
    _, want = jax_hf.load_hf_checkpoint(ckpts[ckpt], dtype=dtype)
    _, got = jax_hf.load_hf_checkpoint(d, dtype=dtype)
    _assert_same_tree(jax.tree.map(lambda a: torch.from_numpy(np.asarray(a, np.float32)), got),
                      jax.tree.map(lambda a: np.asarray(a, np.float32), want), ckpt)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ckpt", ["llama", "qwen2-bias", "mixtral", "phi3-bf16", "mixtral-hf-f32"])
def test_int8_on_load_equals_jax_quantize_params(ckpts, ckpt, dtype):
    """``quant="int8"`` quantizes each matrix as it loads; the JAX node
    quantizes the loaded tree: every q and every scale equal."""
    _, jtree = jax_hf.load_hf_checkpoint(ckpts[ckpt], dtype=dtype)
    jq = jax.tree.map(np.asarray, jax_quant.quantize_params(jtree))
    _, params = hf_loader.load_hf_checkpoint(ckpts[ckpt], dtype=dtype, device="cpu",
                                             quant="int8")
    assert all(isinstance(params["layers"][k], QuantW) for k in jax_quant.QUANT_KEYS)
    _assert_same_tree(params, jq, ckpt)


def test_load_draft_model_from_a_directory(ckpts):
    from agentfield_tpu_torch.serving.model_node import load_draft_model

    params, cfg = load_draft_model(str(ckpts["llama"]), 512, device="cpu", dtype="float32")
    _, want = jax_hf.load_hf_checkpoint(ckpts["llama"], dtype="float32")
    _assert_same_tree(params, jax.tree.map(np.asarray, want), "draft")
    params, _ = load_draft_model(str(ckpts["llama"]), 512, device="cpu")
    assert params["embed"].dtype == torch.bfloat16  # the JAX loader's default
    with pytest.raises(ValueError, match="vocab"):
        load_draft_model(str(ckpts["llama"]), 1024, device="cpu")


@pytest.mark.parametrize("ckpt", ["llama", "phi3-f32"])
def test_engine_greedy_on_loaded_weights_matches_jax(ckpts, ckpt):
    jcfg, jtree = jax_hf.load_hf_checkpoint(ckpts[ckpt], dtype="float32")
    cfg, params = hf_loader.load_hf_checkpoint(ckpts[ckpt], dtype="float32", device="cpu")
    jcfg = dataclasses.replace(jcfg, dtype="float32")
    cfg = dataclasses.replace(cfg, dtype="float32")
    rng = np.random.default_rng(0)
    prompts = {"a": rng.integers(1, 512, 7).tolist(), "b": rng.integers(1, 512, 20).tolist()}
    jeng = jax_engine.InferenceEngine(jtree, jcfg, jax_engine.EngineConfig(**ECFG))
    want = jeng.run_to_completion([jax_engine.Request(id=k, prompt=p, sampling=JaxSampling(
        max_new_tokens=8)) for k, p in prompts.items()])
    teng = engine.InferenceEngine(params, cfg, engine.EngineConfig(**ECFG))
    got = teng.run_to_completion([engine.Request(id=k, prompt=p, sampling=SamplingParams(
        max_new_tokens=8)) for k, p in prompts.items()])
    assert got == want


@pytest.mark.parametrize("model", ["llama-nano", "mixtral-tiny"])
def test_phase_ckpt_rehearsed_on_cpu(tmp_path, model):
    """``chip_smoke.phase_ckpt`` end to end on the CPU at a small size
    (llama-nano: bf16, as the card serves): the
    written checkpoint loads bit-equal, its greedy answers equal a
    ``params=`` node's, its tokenizer round-trips and answers a ``messages``
    payload and a schema request, int8 on load equals quantizing the loaded
    matrices, and a draft directory serves; for mixtral-tiny
    ``phase_ckpt_moe``: the experts quantized on load bit-equal, the serve
    under soft and sparse prefill. The temporary directories are gone."""
    import chip_smoke

    results: dict = {}
    chip_smoke.phase_ckpt_rehearsal(results, model, tmp_path)
    r = results["ckpt"]
    if model == "llama-nano":
        assert r["leaves_bit_equal"] and r["greedy_equal"]
        assert r["text"]["round_trip"] and r["text"]["schema_valid"]
        assert r["int8"]["bit_equal"] and r["draft"]["leaves_bit_equal"]
        assert r["draft"]["requests"] == 2 and r["draft"]["spec_steps"] > 0
        assert results["serve_ckpt"]["requests"] == 7  # 4 greedy, sampled, schema, turn 2
    else:
        assert r["moe"]["bit_equal"] and r["moe"]["load"]["experts_checked"] == 2 * 4 * 3
        for mode in ("dense", "sparse"):
            assert results[f"serve_ckpt_moe_{mode}"]["requests"] == 5
    assert list(tmp_path.iterdir()) == []


def test_smoke_tokenizer_matches_transformers(tmp_path):
    """The smoke's own Llama-3-form tokenizer (``chip_smoke.
    write_llama3_tokenizer``, merges learned by ``train_bpe``) read by
    transformers and by the port: the same ids and text, the specials at the
    last ids of the vocab, two BOS for a templated prompt."""
    import chip_smoke
    from agentfield_tpu.serving.model_node import HFTokenizer as JaxHFTokenizer
    from agentfield_tpu_torch.serving.tokenizer import HFTokenizer

    info = chip_smoke.write_llama3_tokenizer(str(tmp_path), 4096, 0, n_specials=256, merges=800)
    assert info["merges"] == 800 and info["first_special"] == 3840
    port, ref = HFTokenizer(tmp_path), JaxHFTokenizer(str(tmp_path))
    assert port.vocab_size == ref.vocab_size == 3840 and info["learned_vocab"] == 256 + 800
    assert port.eos_token_id == ref.eos_token_id == 3841
    text = chip_smoke.ckpt_text(np.random.default_rng(5), 3000)
    ids = ref.encode(text)
    assert port.encode(text) == ids and len(ids) < 0.5 * len(text.encode("utf-8"))
    assert port.decode(ids) == ref.decode(ids) == "<|begin_of_text|>" + text
    assert port.token_bytes(4096) == ref.token_bytes(4096)
    msgs = [{"role": "user", "content": text[:200]}]
    rendered = port.apply_chat_template(msgs)
    assert rendered == ref._tok.apply_chat_template(msgs, tokenize=False,
                                                    add_generation_prompt=True)
    assert port.encode(rendered)[:2] == [3840, 3840]


def test_chunked_transposed_copies_give_the_same_leaves(ckpts, monkeypatch):
    """A transposed tensor crosses in row chunks (``COPY_CHUNK_BYTES``):
    chunks of a few rows give the leaves one chunk gives."""
    _, whole = hf_loader.load_hf_checkpoint(ckpts["mixtral"], dtype="bfloat16", device="cpu")
    monkeypatch.setattr(hf_loader, "COPY_CHUNK_BYTES", 1000)
    _, chunked = hf_loader.load_hf_checkpoint(ckpts["mixtral"], dtype="bfloat16", device="cpu")
    a, b = dict(_leaves(whole)), dict(_leaves(chunked))
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_node_tokenizer_choice(ckpts, tmp_path):
    """``build_model_node(checkpoint=...)``: no tokenizer.json gives the byte
    tokenizer (as the JAX node falls back); a tokenizer.json the port
    cannot read raises instead of falling back; ``--checkpoint`` parses."""
    import shutil

    from agentfield_tpu_torch.serving.model_node import build_model_node, main
    from agentfield_tpu_torch.serving.tokenizer import ByteTokenizer

    d = tmp_path / "ckpt"
    shutil.copytree(ckpts["llama"], d)
    _, backend = build_model_node(checkpoint=str(d), device="cpu",
                                  ecfg=engine.EngineConfig(**ECFG))
    assert isinstance(backend.tokenizer, ByteTokenizer) and backend.tokenizer.vocab_size == 512
    assert backend.engine.params["embed"].dtype == torch.bfloat16  # the JAX node's load dtype
    (d / "tokenizer.json").write_text(json.dumps({"model": {"type": "WordPiece", "vocab": {}}}))
    with pytest.raises(ValueError, match="WordPiece"):
        build_model_node(checkpoint=str(d), device="cpu", ecfg=engine.EngineConfig(**ECFG))
    with pytest.raises(SystemExit):
        main(["--checkpoint"])
