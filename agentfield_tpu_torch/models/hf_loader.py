"""Hugging Face checkpoint loading — counterpart of
``agentfield_tpu/models/hf_loader.py``.

A checkpoint directory holds ``config.json`` and one or more
``*.safetensors`` shards (a sharded one also ``model.safetensors.index.json``,
which the loader does not need: every shard is opened, in sorted order, as
the JAX loader opens them). The port reads the safetensors format itself —
an 8-byte little-endian header length, a JSON header naming each tensor's
``dtype``, ``shape`` and ``data_offsets``, then the data — because the card's
machine has no ``safetensors`` package (and numpy has no bfloat16).
Each file is memory-mapped and each tensor taken with ``torch.frombuffer``
over its byte range: no file is read whole into host memory.

``load_hf_checkpoint`` follows the JAX mapping leaf for leaf: HF ``[out,
in]`` projections become the port's stacked ``[L, in, out]`` (transposed on
the target device, after the copy), Mixtral's ``block_sparse_moe`` gate and
experts become ``router`` and ``[L, E, in, out]`` expert stacks, Phi-3's
fused ``qkv_proj``/``gate_up_proj`` are split by rows, Qwen2's biases and an
untied ``lm_head`` are read, and a ``norm_offset`` (gemma) norm gets its
``+ 1.0`` after the cast, in the load dtype, as the JAX loader adds it.
Every leaf is preallocated on the target device and filled one matrix at a
time: no stack is built on the host. With ``quant="int8"`` each
``models.quant.QUANT_KEYS`` matrix is cast to the load dtype and then
quantized (and, on a CUDA device, packed) as it arrives, so the fp stack is
never held whole — the JAX node's ``quantize_params(load_hf_checkpoint(...))``
bit for bit.

``save_hf_checkpoint`` is the inverse (the JAX tensor names, float32 values
and ``config.json`` keys by default), written by the port's own writer; it
can also write another dtype and several shards with their index.
"""

from __future__ import annotations

import json
import math
import mmap
import struct
from pathlib import Path
from typing import Any, Callable, Iterable

import torch

from agentfield_tpu_torch.models.configs import LlamaConfig, RopeScaling
from agentfield_tpu_torch.models.llama import Params, resolve_dtype
from agentfield_tpu_torch.models.quant import QUANT_KEYS, QuantW, _quantize_stack

COPY_CHUNK_BYTES = 64 << 20  # a transposed tensor crosses to the device in row chunks
# the safetensors dtypes a checkpoint's weights come in
ST_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32}
_ST_NAMES = {dt: name for name, dt in ST_DTYPES.items()}


def config_from_hf(path: str | Path) -> LlamaConfig:
    doc = json.loads((Path(path) / "config.json").read_text())
    if doc.get("model_type") not in (
        "llama", "mistral", "qwen2", "gemma", "mixtral", "phi3", None
    ):
        raise ValueError(
            f"unsupported model_type={doc.get('model_type')!r} "
            "(llama/mistral/qwen2/gemma/mixtral/phi3)"
        )
    if float(doc.get("partial_rotary_factor", 1.0)) != 1.0:
        raise ValueError(
            "partial_rotary_factor != 1.0 is not implemented; loading would "
            "silently produce wrong logits"
        )
    gemma = doc.get("model_type") == "gemma"
    sliding_window = None
    if doc.get("sliding_window") and doc.get("use_sliding_window", True):
        # (Qwen2 configs carry sliding_window but disable it via
        # use_sliding_window=false — full attention matches the reference.)
        sliding_window = int(doc["sliding_window"])
    rope_scaling = None
    rs = doc.get("rope_scaling")
    if rs:
        kind = rs.get("rope_type", rs.get("type", "default"))
        if kind == "llama3":
            rope_scaling = RopeScaling(
                factor=float(rs["factor"]),
                low_freq_factor=float(rs.get("low_freq_factor", 1.0)),
                high_freq_factor=float(rs.get("high_freq_factor", 4.0)),
                original_max_position_embeddings=int(
                    rs.get("original_max_position_embeddings", 8192)
                ),
            )
        elif kind not in ("default", None):
            raise ValueError(
                f"unsupported rope_scaling type {kind!r} (only 'llama3'/'default'); "
                "loading would silently produce wrong logits"
            )
    hidden = doc["hidden_size"]
    heads = doc["num_attention_heads"]
    return LlamaConfig(
        vocab_size=doc["vocab_size"],
        hidden_size=hidden,
        intermediate_size=doc["intermediate_size"],
        num_layers=doc["num_hidden_layers"],
        num_heads=heads,
        num_kv_heads=doc.get("num_key_value_heads", heads),
        # a null head_dim (transformers' Mixtral config writes one) is the
        # default too; the JAX function passes the null through
        head_dim=doc.get("head_dim") or hidden // heads,
        rope_theta=doc.get("rope_theta", 10000.0),
        rope_scaling=rope_scaling,
        attn_bias=doc.get("attention_bias", doc.get("model_type") == "qwen2"),
        rms_norm_eps=doc.get("rms_norm_eps", 1e-5),
        max_seq_len=doc.get("max_position_embeddings", 8192),
        # HF GemmaConfig defaults tie_word_embeddings=True (often omitted)
        tie_embeddings=doc.get("tie_word_embeddings", gemma),
        # gemma family: GeGLU MLP, x*(1+w) norms, sqrt(d)-scaled embeddings
        mlp_act=_mlp_act_from_hf(doc.get("hidden_act"), gemma),
        norm_offset=gemma,
        scale_embeddings=gemma,
        num_experts=doc.get("num_local_experts", 0),
        num_experts_per_tok=doc.get("num_experts_per_tok", 2),
        sliding_window=sliding_window,
    )


def _mlp_act_from_hf(hidden_act: str | None, gemma: bool) -> str:
    """Exact activation mapping: a near-miss (quick_gelu, erf gelu) fails
    loudly instead of computing a different function."""
    if hidden_act in (None, "silu", "swish"):
        return "gelu" if gemma else "silu"  # gemma's config default is GeGLU
    if hidden_act in ("gelu_pytorch_tanh", "gelu_tanh"):
        return "gelu"  # the tanh approximation, as the forward computes it
    raise ValueError(
        f"unsupported hidden_act={hidden_act!r} (silu / gelu_pytorch_tanh); "
        "loading would silently produce wrong logits"
    )


# ---------------------------------------------------------------------------
# The safetensors format
# ---------------------------------------------------------------------------


class SafetensorsFile:
    """One ``.safetensors`` file, memory-mapped (copy-on-write, so the
    buffer is writable for ``torch.frombuffer`` and the file is never
    written). ``get(name)`` is a CPU tensor over the mapped bytes — no copy;
    it lives as long as the mapping, so copy it before ``close()``."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        with open(self.path, "rb") as f:
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        size = len(self._mm)
        if size < 8:
            raise ValueError(f"{self.path}: not a safetensors file ({size} bytes)")
        (n,) = struct.unpack("<Q", self._mm[:8])
        if 8 + n > size:
            raise ValueError(f"{self.path}: header of {n} bytes overruns the file")
        header = json.loads(self._mm[8:8 + n])
        header.pop("__metadata__", None)
        self._base = 8 + n
        self.entries: dict[str, tuple[str, tuple[int, ...], int, int]] = {}
        for name, e in header.items():
            begin, end = e["data_offsets"]
            if not 0 <= begin <= end <= size - self._base:
                raise ValueError(f"{self.path}: tensor {name!r} lies outside the file")
            self.entries[name] = (e["dtype"], tuple(e["shape"]), begin, end)

    def keys(self) -> list[str]:
        return list(self.entries)

    def get(self, name: str) -> torch.Tensor:
        dtype_name, shape, begin, end = self.entries[name]
        dt = ST_DTYPES.get(dtype_name)
        if dt is None:
            raise ValueError(
                f"{self.path}: tensor {name!r} has dtype {dtype_name}; the loader reads "
                f"{sorted(ST_DTYPES)}")
        count = math.prod(shape)
        if (end - begin) != count * dt.itemsize:
            raise ValueError(
                f"{self.path}: tensor {name!r} holds {end - begin} bytes, its "
                f"{dtype_name} shape {list(shape)} needs {count * dt.itemsize}")
        if count == 0:
            return torch.empty(shape, dtype=dt)
        return torch.frombuffer(self._mm, dtype=dt, count=count,
                                offset=self._base + begin).view(shape)

    def close(self) -> None:
        try:
            self._mm.close()
        except BufferError:  # a tensor still views the mapping: it closes with it
            pass


def open_checkpoint(path: str | Path) -> dict[str, SafetensorsFile]:
    """Every tensor name of the sorted ``*.safetensors`` files under
    ``path`` -> its file (a later shard's name wins, as in the JAX loader)."""
    files = sorted(Path(path).glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no *.safetensors under {path}")
    handles: dict[str, SafetensorsFile] = {}
    for f in files:
        st = SafetensorsFile(f)
        for name in st.keys():
            handles[name] = st
    return handles


def write_safetensors(path: str | Path,
                      entries: Iterable[tuple[str, tuple[int, ...], torch.dtype,
                                              Callable[[], torch.Tensor]]]) -> int:
    """Write one ``.safetensors`` file from ``(name, shape, dtype, make)``
    entries, streaming: the header is written from the shapes, then each
    ``make()`` is called in turn and its tensor (any device; cast to
    ``dtype``) copied to the host and written before the next is made.
    Returns the bytes of tensor data written."""
    entries = list(entries)
    header: dict[str, Any] = {"__metadata__": {"format": "pt"}}
    offset = 0
    for name, shape, dt, _ in entries:
        nbytes = math.prod(shape) * dt.itemsize
        header[name] = {"dtype": _ST_NAMES[dt], "shape": list(shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name, shape, dt, make in entries:
            t = make().detach().to(dt).contiguous()
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"tensor {name!r}: shape {tuple(t.shape)} != {tuple(shape)}")
            f.write(t.cpu().view(torch.uint8).numpy().data if t.numel() else b"")
    return offset


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------


def _leaf_sources(cfg: LlamaConfig, names: set[str]) -> dict[str, tuple[tuple[int, ...], bool, Callable]]:
    """The port's leaves -> ``(shape, transpose, src)``: ``src(get, i)``
    gives the i-th HF matrix or vector of the leaf (its leading axes
    flattened) as stored, ``[out, in]`` where ``transpose``."""
    L, d, f, v, E = (cfg.num_layers, cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                     cfg.num_experts)
    p = "model.layers.{i}."
    fused_qkv = "model.layers.0.self_attn.qkv_proj.weight" in names
    fused_mlp = "model.layers.0.mlp.gate_up_proj.weight" in names

    def plain(fmt):
        return lambda get, i: get(fmt.format(i=i))

    def rows(fmt, lo, hi):  # Phi-3: a fused [out, in] tensor's rows lo:hi
        return lambda get, i: get(fmt.format(i=i))[lo:hi]

    def expert(fmt):  # [L, E] flattened: i = layer * E + expert
        return lambda get, i: get(fmt.format(i=i // E, e=i % E))

    q, kv = cfg.q_dim, cfg.kv_dim
    out: dict[str, tuple[tuple[int, ...], bool, Callable]] = {
        "attn_norm": ((L, d), False, plain(p + "input_layernorm.weight")),
        "mlp_norm": ((L, d), False, plain(p + "post_attention_layernorm.weight")),
        "wo": ((L, q, d), True, plain(p + "self_attn.o_proj.weight")),
    }
    if fused_qkv:  # Phi-3 qkv_proj rows: q (q_dim) then k then v (kv_dim each)
        qkv = p + "self_attn.qkv_proj.weight"
        out.update(wq=((L, d, q), True, rows(qkv, 0, q)),
                   wk=((L, d, kv), True, rows(qkv, q, q + kv)),
                   wv=((L, d, kv), True, rows(qkv, q + kv, q + 2 * kv)))
    else:
        out.update(wq=((L, d, q), True, plain(p + "self_attn.q_proj.weight")),
                   wk=((L, d, kv), True, plain(p + "self_attn.k_proj.weight")),
                   wv=((L, d, kv), True, plain(p + "self_attn.v_proj.weight")))
    if E > 0:
        # Mixtral block_sparse_moe: gate = router, experts.N.w1/w3/w2 =
        # gate/up/down (modeling_mixtral naming)
        moe = p + "block_sparse_moe."
        out.update(router=((L, d, E), True, plain(moe + "gate.weight")),
                   w_gate=((L, E, d, f), True, expert(moe + "experts.{e}.w1.weight")),
                   w_up=((L, E, d, f), True, expert(moe + "experts.{e}.w3.weight")),
                   w_down=((L, E, f, d), True, expert(moe + "experts.{e}.w2.weight")))
    elif fused_mlp:  # Phi-3 gate_up_proj: [2f, d] rows = gate then up
        gu = p + "mlp.gate_up_proj.weight"
        out.update(w_gate=((L, d, f), True, rows(gu, 0, f)),
                   w_up=((L, d, f), True, rows(gu, f, 2 * f)),
                   w_down=((L, f, d), True, plain(p + "mlp.down_proj.weight")))
    else:
        out.update(w_gate=((L, d, f), True, plain(p + "mlp.gate_proj.weight")),
                   w_up=((L, d, f), True, plain(p + "mlp.up_proj.weight")),
                   w_down=((L, f, d), True, plain(p + "mlp.down_proj.weight")))
    if cfg.attn_bias:
        out.update(bq=((L, q), False, plain(p + "self_attn.q_proj.bias")),
                   bk=((L, kv), False, plain(p + "self_attn.k_proj.bias")),
                   bv=((L, kv), False, plain(p + "self_attn.v_proj.bias")))
    return out


def load_hf_checkpoint(
    path: str | Path,
    cfg: LlamaConfig | None = None,
    dtype: str | torch.dtype = "bfloat16",
    device: str | torch.device = "cuda",
    quant: str | None = None,
) -> tuple[LlamaConfig, Params]:
    """Returns ``(config, params)`` with every leaf on ``device`` in
    ``dtype``. Each HF tensor is copied to ``device`` as stored and
    transposed and cast there, into its slot of the preallocated leaf.
    ``quant="int8"`` quantizes each ``QUANT_KEYS`` matrix (after its cast to
    ``dtype``) as it arrives."""
    if quant not in (None, "int8"):
        raise ValueError(f"unknown quant mode {quant!r} (have: 'int8')")
    path = Path(path)
    if cfg is None:
        cfg = config_from_hf(path)
    dt = resolve_dtype(dtype)
    device = torch.device(device)
    handles = open_checkpoint(path)

    def get(name: str) -> torch.Tensor:
        if name not in handles:
            raise KeyError(f"tensor {name!r} missing from checkpoint {path}")
        return handles[name].get(name)

    def put(dst: torch.Tensor, t: torch.Tensor, transpose: bool) -> None:
        """``dst`` (on ``device``, in ``dtype``) <- the stored tensor ``t``:
        copied as stored, then transposed and cast there, in row chunks of
        at most ``COPY_CHUNK_BYTES`` (the card holds one chunk beside the
        tree, not a second ``lm_head``)."""
        if not transpose:
            dst.copy_(t)
            return
        rows = max(1, COPY_CHUNK_BYTES // max(1, t.shape[1] * t.element_size()))
        for a in range(0, t.shape[0], rows):
            dst[:, a:a + rows].copy_(t[a:a + rows].to(device).T)

    def fill(shape, transpose: bool, src) -> torch.Tensor:
        out = torch.empty(shape, dtype=dt, device=device)
        flat = out.view(-1, *shape[-2 if transpose else -1:])
        for i in range(flat.shape[0]):
            put(flat[i], src(get, i), transpose)
        return out

    def fill_quant(shape, src) -> QuantW:
        # each whole matrix on the device in ``dtype``: its column scales
        # need every row (the fp stack is never held)
        return _quantize_stack(shape, device, lambda i: src(get, i).to(device).T.to(dt))

    def single(name: str, transpose: bool = False) -> torch.Tensor:
        t = get(name)
        out = torch.empty(t.shape[::-1] if transpose else t.shape, dtype=dt, device=device)
        put(out, t, transpose)
        return out

    try:
        layers: dict[str, Any] = {}
        for leaf, (shape, transpose, src) in _leaf_sources(cfg, set(handles)).items():
            if quant and leaf in QUANT_KEYS:
                layers[leaf] = fill_quant(shape, src)
            else:
                layers[leaf] = fill(shape, transpose, src)
        params: Params = {"embed": single("model.embed_tokens.weight"), "layers": layers,
                          "final_norm": single("model.norm.weight")}
        if cfg.norm_offset:
            # norm_offset checkpoints store w for x*(1+w); the 1.0 is added
            # after the cast, in the load dtype, so the runtime rms_norm
            # stays one code path (models/llama.py)
            for k in ("attn_norm", "mlp_norm"):
                layers[k] += 1.0
            params["final_norm"] += 1.0
        if not cfg.tie_embeddings:
            params["lm_head"] = single("lm_head.weight", transpose=True)
    finally:
        for st in set(handles.values()):
            st.close()
    return cfg, params


# ---------------------------------------------------------------------------
# Saving
# ---------------------------------------------------------------------------


def hf_config_dict(cfg: LlamaConfig) -> dict[str, Any]:
    """The ``config.json`` keys the JAX ``save_hf_checkpoint`` writes."""
    doc: dict[str, Any] = {
        "model_type": ("gemma" if cfg.norm_offset
                       else "mixtral" if cfg.num_experts > 0 else "llama"),
    }
    if cfg.num_experts > 0:
        doc.update(num_local_experts=cfg.num_experts,
                   num_experts_per_tok=cfg.num_experts_per_tok)
    doc.update(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads, num_key_value_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta)
    if cfg.rope_scaling:
        rs = cfg.rope_scaling
        doc["rope_scaling"] = {
            "rope_type": "llama3", "factor": rs.factor,
            "low_freq_factor": rs.low_freq_factor, "high_freq_factor": rs.high_freq_factor,
            "original_max_position_embeddings": rs.original_max_position_embeddings}
    doc.update(
        rms_norm_eps=cfg.rms_norm_eps, max_position_embeddings=cfg.max_seq_len,
        tie_word_embeddings=cfg.tie_embeddings, attention_bias=cfg.attn_bias,
        # explicit so a gelu llama-architecture model survives the round trip
        hidden_act="gelu_pytorch_tanh" if cfg.mlp_act == "gelu" else "silu")
    if cfg.sliding_window is not None:
        doc["sliding_window"] = cfg.sliding_window
    return doc


def hf_tensors(cfg: LlamaConfig, params: Params, dtype: torch.dtype
               ) -> list[tuple[str, tuple[int, ...], torch.dtype, Callable[[], torch.Tensor]]]:
    """The HF tensors of ``params`` (the JAX ``save_hf_checkpoint``'s names
    and order of values), each made on demand on the params' device:
    ``[out, in]`` projections, norms with a ``norm_offset`` model's 1.0
    taken back out (in float32, as the JAX writer does)."""
    noff = 1.0 if cfg.norm_offset else 0.0
    f32 = torch.float32
    out: list = []

    def add(name, fn, shape):
        out.append((name, tuple(shape), dtype, fn))

    def norm(t):
        return lambda: t.to(f32) - noff

    def mat(t):  # [in, out] -> [out, in]
        return lambda: t.T.to(f32)

    add("model.embed_tokens.weight", lambda: params["embed"].to(f32), params["embed"].shape)
    add("model.norm.weight", norm(params["final_norm"]), params["final_norm"].shape)
    lp = params["layers"]
    E = cfg.num_experts
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        if E > 0:
            r = lp["router"][i]
            add(p + "block_sparse_moe.gate.weight", mat(r), r.shape[::-1])
            for ours, theirs in (("w_gate", "w1"), ("w_up", "w3"), ("w_down", "w2")):
                for e in range(E):
                    w = lp[ours][i, e]
                    add(f"{p}block_sparse_moe.experts.{e}.{theirs}.weight", mat(w), w.shape[::-1])
    names = [("attn_norm", "input_layernorm.weight"),
             ("mlp_norm", "post_attention_layernorm.weight"),
             ("wq", "self_attn.q_proj.weight"), ("wk", "self_attn.k_proj.weight"),
             ("wv", "self_attn.v_proj.weight"), ("wo", "self_attn.o_proj.weight")]
    if E == 0:
        names += [("w_gate", "mlp.gate_proj.weight"), ("w_up", "mlp.up_proj.weight"),
                  ("w_down", "mlp.down_proj.weight")]
    if cfg.attn_bias:
        names += [("bq", "self_attn.q_proj.bias"), ("bk", "self_attn.k_proj.bias"),
                  ("bv", "self_attn.v_proj.bias")]
    for ours, theirs in names:
        for i in range(cfg.num_layers):
            t = lp[ours][i]
            if ours in ("attn_norm", "mlp_norm"):
                add(f"model.layers.{i}.{theirs}", norm(t), t.shape)
            elif t.dim() == 2:
                add(f"model.layers.{i}.{theirs}", mat(t), t.shape[::-1])
            else:  # a bias
                add(f"model.layers.{i}.{theirs}", lambda t=t: t.to(f32), t.shape)
    if not cfg.tie_embeddings:
        add("lm_head.weight", mat(params["lm_head"]), params["lm_head"].shape[::-1])
    return out


def save_hf_checkpoint(path: str | Path, cfg: LlamaConfig, params: Params,
                       dtype: str | torch.dtype = "float32", shards: int = 1) -> None:
    """Write ``params`` (fp leaves) as an HF checkpoint: ``config.json``
    and the tensors in ``dtype``, one tensor at a time from the params'
    device. ``shards > 1`` writes ``model-0000k-of-0000n.safetensors`` of
    about equal bytes and ``model.safetensors.index.json``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    entries = hf_tensors(cfg, params, resolve_dtype(dtype))
    if shards <= 1:
        write_safetensors(path / "model.safetensors", entries)
    else:
        sizes = [math.prod(s) * dt.itemsize for _, s, dt, _ in entries]
        total, groups, acc = sum(sizes), [[] for _ in range(shards)], 0
        for e, n in zip(entries, sizes):
            groups[min(shards - 1, acc * shards // total)].append(e)
            acc += n
        weight_map = {}
        for k, group in enumerate(groups):
            fname = f"model-{k + 1:05d}-of-{shards:05d}.safetensors"
            write_safetensors(path / fname, group)
            weight_map.update({name: fname for name, *_ in group})
        (path / "model.safetensors.index.json").write_text(json.dumps(
            {"metadata": {"total_size": total}, "weight_map": weight_map}, indent=2))
    (path / "config.json").write_text(json.dumps(hf_config_dict(cfg)))
