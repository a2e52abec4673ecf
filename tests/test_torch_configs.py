"""The port's own copies of the JAX package's jax-free pieces stay equal to
them: model presets, the byte tokenizer, the prefix chain hash, the kernel
row-packing table and the kernel gate's shape mixes."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from agentfield_tpu import prefix_hash as jax_prefix_hash
from agentfield_tpu.models import configs as jax_configs
from agentfield_tpu.ops.pallas import kernel_autotune as jax_autotune
from agentfield_tpu.serving.model_node import ByteTokenizer as JaxByteTokenizer
from agentfield_tpu_torch import prefix_hash as pt_prefix_hash
from agentfield_tpu_torch.models import configs as pt_configs
from agentfield_tpu_torch.ops import kernel_autotune as pt_autotune
from agentfield_tpu_torch.ops import kernel_shapes as pt_shapes
from agentfield_tpu_torch.serving.tokenizer import ByteTokenizer
from tools.perf import kernel_gate


def test_same_preset_names():
    assert list(pt_configs.PRESETS) == list(jax_configs.PRESETS)


@pytest.mark.parametrize("name", list(jax_configs.PRESETS))
def test_preset_equal_field_by_field(name):
    j, t = jax_configs.get_config(name), pt_configs.get_config(name)
    jf = [f.name for f in dataclasses.fields(j)]
    assert [f.name for f in dataclasses.fields(t)] == jf
    for f in jf:
        jv, tv = getattr(j, f), getattr(t, f)
        if dataclasses.is_dataclass(jv):
            assert dataclasses.asdict(tv) == dataclasses.asdict(jv), f
        else:
            assert tv == jv, f
    # derived properties too
    for prop in ("head_dim", "q_dim", "kv_dim"):
        assert getattr(t, prop) == getattr(j, prop)


def test_get_config_unknown_raises():
    with pytest.raises(KeyError):
        pt_configs.get_config("no-such-model")


@pytest.mark.parametrize("text", ["", "hello", "héllo wörld ✓", "\x00\x7f tail"])
@pytest.mark.parametrize("vocab", [128, 256, 128256])
def test_byte_tokenizer_same_ids(text, vocab):
    j, t = JaxByteTokenizer(vocab), ByteTokenizer(vocab)
    assert t.encode(text) == j.encode(text)
    ids = list(range(0, 300, 7))
    assert t.decode(ids) == j.decode(ids)
    assert t.eos_token_id == j.eos_token_id


def test_chain_hash_same_bytes():
    rng = np.random.default_rng(0)
    prev = b""
    for n in (1, 8, 16, 37):
        toks = rng.integers(0, 128256, n).tolist()
        hj = jax_prefix_hash.chain_hash(prev, toks)
        ht = pt_prefix_hash.chain_hash(prev, toks)
        assert ht == hj and len(ht) == 16
        prev = hj


@pytest.mark.parametrize("ps", [1, 8, 16])
def test_page_chain_hashes_same_bytes(ps):
    toks = np.random.default_rng(ps).integers(0, 1000, 101).tolist()
    assert pt_prefix_hash.page_chain_hashes(toks, ps) == jax_prefix_hash.page_chain_hashes(toks, ps)


def test_autotune_table_copied():
    assert pt_autotune.DEFAULT_TABLE == jax_autotune.DEFAULT_TABLE
    assert pt_autotune.KernelBlocks._fields == jax_autotune.KernelBlocks._fields


@pytest.mark.parametrize("ps", [8, 16, 128, 32])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("bucket", [1, 16, 100, 256, 512, 1024])
def test_lookup_blocks_same(ps, hd, bucket, monkeypatch):
    monkeypatch.delenv("AGENTFIELD_KERNEL_AUTOTUNE", raising=False)
    want = jax_autotune.lookup_blocks(ps, hd, bucket)
    got = pt_autotune.lookup_blocks(ps, hd, bucket)
    assert tuple(got) == tuple(want)


def test_kernel_gate_shapes_copied():
    for name, tiers in pt_shapes.SHAPES.items():
        assert tiers == kernel_gate.SHAPES[name]
    assert set(pt_shapes.SHAPES) == {
        k for k, v in kernel_gate.SHAPES.items() if "kv_dtype" not in v["fast"]
    }
    assert pt_shapes.PARITY_TOL == kernel_gate.PARITY_TOL


@pytest.mark.parametrize("name", list(pt_shapes.SHAPES))
def test_build_case_same_draws(name):
    want = [np.asarray(a) for a in kernel_gate.build_case(name, fast=True, seed=3)]
    got = pt_shapes.build_case(name, fast=True, seed=3)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
