"""The port's tensor-parallel pieces against the JAX package's mesh, on the
CPU's 8 virtual devices (``tests/conftest.py``), in one process: a port
rank is a ``parallel.mesh.Mesh`` coordinate (no process group), and what it
holds must be the block the JAX mesh gives that rank's device.

- ``param_pspecs`` leaf for leaf, ``check_divisibility``'s messages, the
  axes and ``auto_mesh_shape``;
- each rank's weights — ``params_from_numpy(shard=)``, ``shard_params`` and
  ``init_params(shard=)`` — bit-equal to ``addressable_shards[r].data`` of
  the JAX ``shard_params`` at tp 2 (llama-tiny) and tp 8
  (llama-tiny-tp8: one KV head a rank), fp and int8 (q cut on its sharded
  axis, a row-parallel scale whole);
- each rank's KV pool against the JAX ``PagedKVCache.create(mesh=)``
  shard: shape, dtype, zeros, and the global byte counts;
- ``ragged_paged_attention(mesh=)`` per rank against the JAX plain path
  run on arrays placed on the mesh (f32 within 1e-5, the two plain
  versions' float32 order; pools bit-equal outside page 0), bf16-free and
  over int8 pools.
"""

from __future__ import annotations

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from agentfield_tpu.models import configs as jax_configs
from agentfield_tpu.models import llama as jax_llama
from agentfield_tpu.models import quant as jax_quant
from agentfield_tpu.ops.kv_quant import QuantPages as JaxQuantPages
from agentfield_tpu.parallel import mesh as jax_mesh
from agentfield_tpu.parallel import sharding as jax_sharding
from agentfield_tpu.serving.kv_cache import PagedKVCache as JaxPagedKVCache
from agentfield_tpu_torch.models import llama
from agentfield_tpu_torch.models.configs import get_config
from agentfield_tpu_torch.models.convert import params_from_numpy
from agentfield_tpu_torch.models.quant import QuantW, quantize_params
from agentfield_tpu_torch.ops import paged_attention as pa
from agentfield_tpu_torch.ops.kernel_shapes import build_case
from agentfield_tpu_torch.ops.kv_quant import QuantPages
from agentfield_tpu_torch.parallel import mesh as tmesh
from agentfield_tpu_torch.parallel import sharding
from agentfield_tpu_torch.serving.kv_cache import PagedKVCache

jax_pa = importlib.import_module("agentfield_tpu.ops.paged_attention")

REF_TOL = 1e-5
CARVES = [("llama-tiny", 2), ("llama-tiny-tp8", 8)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def coord(tp: int, rank: int) -> tmesh.Mesh:
    return tmesh.make_mesh({"model": tp}, rank)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("name", ["llama-tiny", "llama-tiny-tp8", "gemma-tiny", "qwen2-7b",
                                  "mixtral-tiny", "llama-3-8b"])
def test_param_pspecs_match_jax(name):
    want = dict(_leaves(jax_sharding.param_pspecs(jax_configs.get_config(name))))
    got = dict(_leaves(sharding.param_pspecs(get_config(name))))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == tuple(want[k]), k


@pytest.mark.parametrize("tp", [2, 3, 4, 8, 16])
@pytest.mark.parametrize("paged_kv", [False, True])
@pytest.mark.parametrize("name", ["llama-tiny", "llama-tiny-tp8", "llama-3-8b"])
def test_check_divisibility_messages(name, tp, paged_kv):
    def outcome(fn, cfg):
        try:
            fn(cfg, tp, paged_kv=paged_kv)
        except ValueError as e:
            return str(e)
        return None

    want = outcome(jax_sharding.check_divisibility, jax_configs.get_config(name))
    assert outcome(sharding.check_divisibility, get_config(name)) == want


def test_axes_and_auto_mesh_shape():
    assert tmesh.CANONICAL_ORDER == jax_mesh.CANONICAL_ORDER
    for n in (1, 2, 3, 4, 6, 8, 12, 16, 32):
        assert tmesh.auto_mesh_shape(n) == jax_mesh.auto_mesh_shape(n)
    assert tmesh.auto_mesh_shape(8, tp=2) == jax_mesh.auto_mesh_shape(8, tp=2)
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.auto_mesh_shape(6, tp=4)
    m = coord(4, 3)
    assert (m.tp, m.rank, m.is_root, m.shape["data"]) == (4, 3, False, 1)
    for ax, item in (("expert", "EP"), ("seq", "ring"), ("stage", "pipeline"),
                     ("data", "trainer")):
        with pytest.raises(NotImplementedError, match=f"A5.*{item}"):
            tmesh.make_mesh({ax: 2, "model": 2})
    with pytest.raises(ValueError, match="rank 2 outside"):
        tmesh.make_mesh({"model": 2}, rank=2)
    with pytest.raises(ValueError, match="nccl needs one card a rank"):
        tmesh.make_mesh({"model": 2}, backend="nccl", init_method="tcp://127.0.0.1:1")
    with pytest.raises(RuntimeError, match="coordinate only"):
        coord(2, 0).all_reduce(torch.ones(2))


def _jax_tree(name: str, quant: bool):
    jcfg = dataclasses.replace(jax_configs.get_config(name), dtype="float32")
    tree = jax_llama.init_params(jcfg, jax.random.PRNGKey(0))
    if quant:
        tree = jax_quant.quantize_params(tree)
    return jcfg, tree


def _rank_block(arr, mesh, rank: int) -> np.ndarray:
    """The data of the shard on the mesh's rank-th device (its position on
    the ``model`` axis)."""
    dev = mesh.devices.reshape(-1)[rank]
    (shard,) = [s for s in arr.addressable_shards if s.device == dev]
    return np.asarray(shard.data)


def _port_leaf(t):
    if isinstance(t, QuantW):
        return {"q": t.q.numpy(), "scale": t.scale.numpy()}
    return t.numpy()


def _jax_leaf(a, mesh, rank):
    if isinstance(a, jax_quant.QuantW):
        return {"q": _rank_block(a.q, mesh, rank), "scale": _rank_block(a.scale, mesh, rank)}
    return _rank_block(a, mesh, rank)


def _assert_tree_equal(got: dict, want: dict, where: str):
    assert got.keys() == want.keys(), where
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, dict):
            _assert_tree_equal(g, w, f"{where}.{k}")
        else:
            assert g.shape == w.shape, (f"{where}.{k}", g.shape, w.shape)
            np.testing.assert_array_equal(g, w, err_msg=f"{where}.{k}")


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("name,tp", CARVES)
def test_rank_weights_bit_equal_jax_shards(name, tp, quant):
    """Every rank's tree, three ways, is the JAX mesh's block of its
    device: the numpy carry with ``shard=``, ``shard_params`` of the whole
    carried tree, and (random weights, port-only) ``init_params(shard=)``
    against ``shard_params(init_params())``."""
    jcfg, tree = _jax_tree(name, quant)
    jm = jax_mesh.make_mesh({"model": tp})
    placed = jax_sharding.shard_params(tree, jcfg, jm)
    cfg = dataclasses.replace(get_config(name), dtype="float32")
    whole = params_from_numpy(jax.tree.map(np.asarray, tree), cfg, device="cpu")
    for rank in range(tp):
        want = _rank_tree(placed, jm, rank)
        m = coord(tp, rank)
        carried = params_from_numpy(jax.tree.map(np.asarray, tree), cfg, device="cpu", shard=m)
        _assert_tree_equal(_port_tree(carried), want, f"carried r{rank}")
        _assert_tree_equal(_port_tree(sharding.shard_params(whole, cfg, m)), want,
                           f"shard_params r{rank}")
    full = llama.init_params(cfg, seed=3, device="cpu", quantize=quant)
    for rank in (0, tp - 1):
        m = coord(tp, rank)
        _assert_tree_equal(
            _port_tree(llama.init_params(cfg, seed=3, device="cpu", quantize=quant, shard=m)),
            _port_tree(sharding.shard_params(full, cfg, m)), f"init r{rank}")


def _rank_tree(placed, jm, rank):
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _jax_leaf(node, jm, rank)

    return walk(placed)


def _port_tree(params):
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _port_leaf(node)

    return walk(params)


def test_quantized_rank_slices_follow_the_specs():
    """Column-parallel: q and scale cut on the output axis; row-parallel
    (wo, w_down): q cut on the input axis, the scale whole."""
    cfg = get_config("llama-tiny")
    qp = quantize_params(llama.init_params(cfg, seed=0, device="cpu"))
    r1 = sharding.shard_params(qp, cfg, coord(2, 1))["layers"]
    wq, wo = qp["layers"]["wq"], qp["layers"]["wo"]
    n = cfg.q_dim // 2
    assert torch.equal(r1["wq"].q, wq.q[..., n:]) and torch.equal(r1["wq"].scale, wq.scale[..., n:])
    assert torch.equal(r1["wo"].q, wo.q[:, n:]) and torch.equal(r1["wo"].scale, wo.scale)
    with pytest.raises(NotImplementedError, match="A5: EP"):
        sharding.shard_params(llama.init_params(get_config("mixtral-tiny"), device="cpu",
                                                dtype="float32"),
                              get_config("mixtral-tiny"), coord(2, 0))


@pytest.mark.parametrize("kv_quant", ["none", "int8", "fp8"])
@pytest.mark.parametrize("name,tp", CARVES)
def test_rank_pools_match_jax_shards(name, tp, kv_quant):
    jcfg = jax_configs.get_config(name)
    jm = jax_mesh.make_mesh({"model": tp})
    jc = JaxPagedKVCache.create(jcfg, 16, 8, "float32", mesh=jm, kv_quant=kv_quant)
    cfg = get_config(name)
    for rank in (0, tp - 1):
        c = PagedKVCache.create(cfg, 16, 8, "float32", device="cpu", kv_quant=kv_quant,
                                mesh=coord(tp, rank))
        for got, want in zip(c.leaves(), jax.tree.leaves((jc.k_pages, jc.v_pages))):
            block = _rank_block(want, jm, rank)
            assert tuple(got.shape) == block.shape
            assert str(got.dtype).split(".")[-1] == str(block.dtype)
            assert not got.float().abs().sum() and not np.abs(block.astype(np.float32)).sum()
        assert c.page_bytes() == PagedKVCache.create(cfg, 16, 8, "float32", device="cpu",
                                                     kv_quant=kv_quant).page_bytes()
        assert c.hbm_bytes() == jc.hbm_bytes()


def _heads(t: torch.Tensor, axis: int, m: tmesh.Mesh) -> torch.Tensor:
    """Rank ``m.rank``'s block of ``t``'s head axis (the JAX spec's
    ``model`` entry: axis 2 of q and the new K/V, axis 1 of the pools)."""
    spec = tuple("model" if i == axis else None for i in range(t.dim()))
    return sharding.shard_tensor(t, spec, m.tp, m.rank)


def _placed_case(case, jm, quant: bool):
    """The case's arrays on the JAX mesh: q/k_new/v_new on their head axis,
    pools (and scales) on their KV-head axis, descriptors replicated."""
    m = "model"
    heads = NamedSharding(jm, P(None, None, m, None))
    pools = NamedSharding(jm, P(None, m, None, None))
    scales = NamedSharding(jm, P(None, m, None))
    rep = NamedSharding(jm, P())
    q, kn, vn, kp, vp, *desc = case[:10]
    out = [jax.device_put(jnp.asarray(a), heads) for a in (q, kn, vn)]
    if quant:
        ks, vs = case[10:12]
        out += [JaxQuantPages(jax.device_put(jnp.asarray(kp.numpy()), pools),
                              jax.device_put(jnp.asarray(ks.numpy()), scales)),
                JaxQuantPages(jax.device_put(jnp.asarray(vp.numpy()), pools),
                              jax.device_put(jnp.asarray(vs.numpy()), scales))]
    else:
        out += [jax.device_put(jnp.asarray(a), pools) for a in (kp, vp)]
    return out + [jax.device_put(jnp.asarray(a), rep) for a in desc]


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("mix", ["pure_decode", "mixed_ragged"])
@pytest.mark.parametrize("tp", [2, 8])
def test_ragged_under_mesh_per_rank(tp, mix, kv_quant):
    """Each rank's launch on its head slice against the JAX plain path on
    the placed arrays: the rank's block of the output, and of the pools the
    call updated in place."""
    params = {"pure_decode": dict(rows=6, ctx=70, page_size=8, maxp=16, kh=8, rep=2, hd=16),
              "mixed_ragged": dict(rows=4, ctx=40, chunk=24, chunks=2, page_size=8, maxp=16,
                                   kh=8, rep=2, hd=16)}[mix]
    if kv_quant != "none":
        params = dict(params, kv_dtype=kv_quant)
    case = build_case(mix, params=params, seed=1)
    quant = kv_quant != "none"
    jm = jax_mesh.make_mesh({"model": tp})
    with jax_mesh.use_mesh(jm):
        want = jax_pa.ragged_paged_attention(*_placed_case(case, jm, quant), impl="ref",
                                             mesh=jm)
    want_out = np.asarray(want[0])
    want_pools = [np.asarray(x) for x in jax.tree.leaves(want[1:])]
    for rank in range(tp):
        m = coord(tp, rank)
        t = [torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray) else a.clone()
             for a in case]
        q, kn, vn, kp, vp = (_heads(t[0], 2, m), _heads(t[1], 2, m), _heads(t[2], 2, m),
                             _heads(t[3], 1, m), _heads(t[4], 1, m))
        if quant:
            kp = QuantPages(kp, _heads(t[10], 1, m))
            vp = QuantPages(vp, _heads(t[11], 1, m))
        out, kp2, vp2 = pa.ragged_paged_attention(q, kn, vn, kp, vp, *t[5:10], mesh=m)
        h = want_out.shape[2] // tp
        np.testing.assert_allclose(out.numpy(), want_out[:, :, rank * h:(rank + 1) * h],
                                   atol=REF_TOL, rtol=0)
        kh = want_pools[0].shape[1] // tp
        got_pools = [x for p in (kp2, vp2) for x in (p if quant else (p,))]
        for g, w in zip(got_pools, want_pools):
            np.testing.assert_array_equal(g[1:].numpy(), w[1:, rank * kh:(rank + 1) * kh])
    bad = coord(tp, 0)
    with pytest.raises(ValueError, match="head split"):
        pa.ragged_paged_attention(t[0], t[1], t[2], _heads(t[3], 1, bad), t[4],
                                  *t[5:10], mesh=bad)


@pytest.mark.parametrize("quant", [None, "int8"], ids=["fp", "int8"])
@pytest.mark.parametrize("name,tp", CARVES)
def test_checkpoint_loads_a_rank_slice(tmp_path, name, tp, quant):
    """``load_hf_checkpoint(shard=)`` reads one rank's rows or columns of
    each stored tensor (an int8 matrix whole, quantized, then cut): every
    leaf bit-equal to ``shard_params`` of the whole load."""
    from agentfield_tpu_torch.models.hf_loader import load_hf_checkpoint, save_hf_checkpoint

    cfg = get_config(name)
    save_hf_checkpoint(tmp_path, cfg, llama.init_params(cfg, seed=5, device="cpu"), shards=2)
    _, whole = load_hf_checkpoint(tmp_path, cfg, dtype="float32", device="cpu", quant=quant)
    for rank in (0, tp - 1):
        m = coord(tp, rank)
        _, mine = load_hf_checkpoint(tmp_path, cfg, dtype="float32", device="cpu", quant=quant,
                                     shard=m)
        _assert_tree_equal(_port_tree(mine), _port_tree(sharding.shard_params(whole, cfg, m)),
                           f"ckpt r{rank}")
