"""The port's embeddings against the JAX package's, on the CPU (llama-tiny,
float32, the same carried weights):

- ``forward(return_hidden=True)`` against the JAX ``forward_impl(...,
  return_hidden=True)``: the final-norm hidden states, both attention
  implementations (the port's ``"kernel"`` takes ``dense_causal_attention``'s
  plain version on CPU tensors, the JAX ``"flash"`` its Pallas kernel in
  interpret mode);
- ``ModelBackend.embed`` against the JAX node's: mean and last pooling, one
  prompt, token ids, the ``prompts`` batch, and inputs truncated under
  ``context_overflow="truncate_left"``. Vectors agree within 1e-5 max-abs
  (``ATOL``); every other key of the result is equal. The JAX node pads to
  its prefill bucket and the port to the longest row: padding follows every
  real token, so it changes nothing the pooling keeps;
- bad requests raise the same exception class with the same message;
- the port runs the forward on the engine's drive thread, between ticks,
  and an embed during a live decode leaves the decode's tokens unchanged.
"""

from __future__ import annotations

import asyncio
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentfield_tpu.models import configs as jax_configs
from agentfield_tpu.models import llama as jax_llama
from agentfield_tpu.serving import model_node as jax_node
from agentfield_tpu_torch.models import llama
from agentfield_tpu_torch.models.configs import get_config
from agentfield_tpu_torch.models.convert import params_from_numpy
from agentfield_tpu_torch.serving import model_node
from agentfield_tpu_torch.serving.engine import EngineConfig
from agentfield_tpu_torch.serving.model_node import ModelBackend
from agentfield_tpu_torch.serving.tokenizer import ByteTokenizer

ATOL = 1e-5  # max-abs over every vector element, float32
ECFG = dict(max_batch=4, page_size=8, num_pages=64, max_pages_per_seq=8)  # max_context 64
V = 512


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
    jcfg = dataclasses.replace(jax_configs.get_config("llama-tiny"), dtype="float32")
    tree = jax.tree.map(np.asarray, jax_llama.init_params(jcfg, jax.random.PRNGKey(3)))
    return jcfg, tree, params_from_numpy(tree, get_config("llama-tiny"), device="cpu")


@pytest.fixture(scope="module")
def backend(weights):
    b = ModelBackend(weights[2], get_config("llama-tiny"), EngineConfig(**ECFG),
                     tokenizer=ByteTokenizer(V), idle_sleep=0.001)
    b.start()
    yield b
    b.stop()


def _jax_embed(weights, calls: list[dict]) -> list:
    """Each call's result (or the exception it raised) from the JAX node's
    ``embed``."""
    jcfg, tree, _ = weights

    async def main():
        b = jax_node.ModelBackend(tree, jcfg, jax_node.EngineConfig(**ECFG),
                                  tokenizer=jax_node.ByteTokenizer(V))
        out = []
        for kw in calls:
            try:
                out.append(await b.embed(**kw))
            except Exception as e:  # noqa: BLE001 — compared below
                out.append(e)
        return out

    return asyncio.run(main())


@pytest.mark.parametrize("impl", [("ref", "ref"), ("flash", "kernel")], ids=["ref", "kernel"])
def test_forward_return_hidden_matches_jax(weights, impl):
    jcfg, tree, params = weights
    jax_impl, port_impl = impl
    rng = np.random.default_rng(4)
    B, S = 2, 20
    tokens = rng.integers(0, V, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    want, wkv = jax_llama.forward_impl(tree, jcfg, jnp.asarray(tokens), jnp.asarray(pos),
                                       collect_kv=False, attn_impl=jax_impl, return_hidden=True)
    got, kv = llama.forward(params, get_config("llama-tiny"), torch.from_numpy(tokens).long(),
                            torch.from_numpy(pos), attn_impl=port_impl, collect_kv=False,
                            return_hidden=True)
    assert kv is None and wkv is None
    assert tuple(got.shape) == (B, S, jcfg.hidden_size) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


LONG = "the quick brown fox jumps over the lazy dog " * 2  # 88 bytes > max_context 64
CASES = {
    "mean_single": dict(prompt="embed me, mean pooled"),
    "last_single": dict(prompt="embed me, last token", pooling="last"),
    "mean_tokens": dict(tokens=[5, 17, 300, 2, 9, 41]),
    "mean_batch": dict(prompts=["a", "two words", "a somewhat longer third prompt here"]),
    "last_batch": dict(prompts=["short", "x" * 40, "mid length prompt"], pooling="last"),
    "truncated_single": dict(prompt=LONG, context_overflow="truncate_left"),
    "truncated_batch": dict(prompts=[LONG, "fits"], pooling="last",
                            context_overflow="truncate_left"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_embed_matches_jax(weights, backend, case):
    kw = CASES[case]
    [want] = _jax_embed(weights, [kw])
    got = backend.embed(**kw)
    key = "embeddings" if "prompts" in kw else "embedding"
    np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key]), atol=ATOL, rtol=0)
    assert {k: v for k, v in got.items() if k != key} == {k: v for k, v in want.items()
                                                          if k != key}
    assert np.allclose(np.linalg.norm(np.atleast_2d(got[key]), axis=-1), 1.0, atol=1e-6)
    if "truncate" in case:
        assert got["truncated_tokens"]


BAD = {
    "pooling": dict(prompt="x", pooling="max"),
    "overflow_policy": dict(prompt="x", context_overflow="drop"),
    "too_long": dict(prompt=LONG),
    "empty": dict(tokens=[]),
    "nothing": dict(),
    "exclusive": dict(prompt="x", prompts=["y"]),
    "empty_batch": dict(prompts=[]),
}


def test_embed_errors_match_jax(weights, backend):
    want = _jax_embed(weights, list(BAD.values()))
    for (name, kw), w in zip(BAD.items(), want):
        assert isinstance(w, Exception), name
        with pytest.raises(type(w)) as e:
            backend.embed(**kw)
        assert str(e.value) == str(w), name


def test_embed_runs_on_the_drive_thread(weights, backend, monkeypatch):
    """The forward runs as a job of the drive loop (thread ``engine``), not
    on the caller's thread; a backend whose loop is not running (nothing
    can overlap it) runs it inline."""
    seen = []
    rows = model_node.embed_rows

    def spy(*a, **k):
        seen.append(threading.current_thread().name)
        return rows(*a, **k)

    monkeypatch.setattr(model_node, "embed_rows", spy)
    backend.embed(prompt="which thread")
    idle = ModelBackend(weights[2], get_config("llama-tiny"), EngineConfig(**ECFG),
                        tokenizer=ByteTokenizer(V))
    idle.embed(prompt="which thread")
    assert seen == ["engine", threading.current_thread().name]


def test_embed_during_a_live_decode_keeps_its_tokens(backend):
    prompt = "a decode while an embed comes"
    want = backend.generate(prompt=prompt, max_new_tokens=24)["tokens"]
    rid, q, _ = backend.submit_stream(prompt=prompt, max_new_tokens=24)
    first = q.get(timeout=60)
    vec = backend.embed(prompts=["embedded mid-decode", "and another row"])
    evs = [first]
    while not evs[-1].finished:
        evs.append(q.get(timeout=60))
    backend.release_stream(rid)
    assert [e.token for e in evs if e.token >= 0] == want
    assert len(vec["embeddings"]) == 2


def test_embed_chunks_cut_at_the_token_budget():
    """Rows go in order of length; a chunk pads to its longest row and
    stays within the budget; a row longer than the budget goes alone."""
    lens = [64, 1500, 200, 333, 1000, 480, 700, 1200]
    chunks = model_node.embed_chunks(lens, 2048)
    assert [[lens[i] for i in c] for c in chunks] == [
        [64, 200, 333, 480], [700, 1000], [1200], [1500]]
    assert sorted(i for c in chunks for i in c) == list(range(len(lens)))
    assert model_node.embed_chunks([5000, 3], 2048) == [[1], [0]]


@pytest.mark.parametrize("case", ["mean_batch", "last_batch", "truncated_batch"])
def test_chunked_embed_matches_jax(weights, backend, monkeypatch, case):
    """A budget small enough to split every batch into several forwards
    gives the JAX node's vectors in the caller's row order."""
    monkeypatch.setattr(model_node, "EMBED_CHUNK_TOKENS", 40)
    kw = CASES[case]
    lens = [min(len(ByteTokenizer(V).encode(p)), ECFG["max_pages_per_seq"] * ECFG["page_size"])
            for p in kw["prompts"]]
    assert len(model_node.embed_chunks(lens, 40)) > 1
    [want] = _jax_embed(weights, [kw])
    got = backend.embed(**kw)
    np.testing.assert_allclose(np.asarray(got["embeddings"]), np.asarray(want["embeddings"]),
                               atol=ATOL, rtol=0)
    assert got["tokens_used"] == want["tokens_used"]


def test_embed_chunks_interleave_with_ticks(backend, monkeypatch):
    """Each chunk is one job of the drive loop: while a decode runs, the
    loop ticks between two chunks, so the decode waits for one chunk at
    most."""
    monkeypatch.setattr(model_node, "EMBED_CHUNK_TOKENS", 40)
    order = []
    rows, step = model_node.embed_rows, backend.engine.step

    def spy_rows(*a, **k):
        order.append("chunk")
        return rows(*a, **k)

    def spy_step():
        order.append("tick")
        return step()

    monkeypatch.setattr(model_node, "embed_rows", spy_rows)
    monkeypatch.setattr(backend.engine, "step", spy_step)
    rid, q, _ = backend.submit_stream(prompt="a decode", max_new_tokens=48)
    first = q.get(timeout=60)
    prompts = ["x" * 30, "y" * 35, "z" * 38, "w" * 39]  # one chunk each at 40 tokens
    vec = backend.embed(prompts=prompts)
    ev = first
    while not ev.finished:
        ev = q.get(timeout=60)
    backend.release_stream(rid)
    chunks = [i for i, what in enumerate(order) if what == "chunk"]
    assert len(chunks) == len(prompts) and len(vec["embeddings"]) == len(prompts)
    assert all("tick" in order[a + 1:b] for a, b in zip(chunks, chunks[1:])), order


def test_embed_while_stopping_is_refused(weights):
    """Once stop is under way and the drive loop may still be in its last
    step, an embed is refused rather than run beside it; after the loop is
    joined it runs inline."""
    b = ModelBackend(weights[2], get_config("llama-tiny"), EngineConfig(**ECFG),
                     tokenizer=ByteTokenizer(V), idle_sleep=0.001)
    b.start()
    b._stop.set()
    with pytest.raises(RuntimeError, match="model node stopped"):
        b.embed(prompt="during shutdown")
    b.stop()
    assert len(b.embed(prompt="after shutdown")["embedding"]) == get_config("llama-tiny").hidden_size
