"""Decoder-only LM family: GPT-2, OPT, BLOOM.

Counterpart of the reference's ``models/transformer_lm.py``: the config
half (``LMConfig`` and the presets) and the float / fake-quant model
(``TransformerLM``, ``Block``, ``SelfAttention``) whose matmul sites are
``QuantDense`` layers (``nn/layers.py``), as the reference's quantizer
swap places them; the lm_head and the embeddings stay unquantized.

Modules are named as the reference's flax modules, so a parameter's
``state_dict`` key is its flax path joined by dots (``h_0.attn.q.kernel``,
``wte.embedding``, ``ln_f.scale``) and :func:`params_tree` gives the
reference's params tree (the engine's ``build_engine_params`` input).
LayerNorm follows flax (f32 statistics, variance E[x^2] - E[x]^2 clipped
at 0); attention divides the f32 scores by f32(sqrt(head_dim)), masks
with the f32 minimum and takes an f32 softmax. f32 products run without
TF32. Prefill and decode with an f32 cache (``init_kv_caches``; decode
writes the new K/V into the given cache in place and returns it).
Tensor parallel: ``forward(..., tp_group=)`` runs the model on this
rank's shards (``parallel/mesh.py``'s rules; :func:`tp_logits` places
them), with the collectives of ``parallel/comm.py`` where the
reference's GSPMD program has them. The embeddings are split along the
model dimension and each lookup is gathered; q, k, v, qkv and fc_in are
column parallel and out and fc_out row parallel (``QuantDense``). Split
q, k and v give each rank its own heads (and their ALiBi slopes); the
fused qkv's contiguous column shard mixes q, k and v, so its output is
gathered, attention runs on every head, and the rank keeps its slice of
the result for the row-parallel out. The tied head multiplies this
rank's slice of the model dimension and sums over the group; an untied
head's columns are gathered. Every rank of the group gets the same
logits, and a backward gives each rank the gradient of its shards.
HuggingFace checkpoints load through ``models/import_hf.py``; the BERT
and BART encoders (``models/bert.py``, ``models/bart.py``) reuse this
module's ``LayerNorm`` and ``Embed``, the ViT (``models/vit.py``) its
``LayerNorm``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .._ext import resolve_device
from ..kernels.qmatmul import tf32_off
from ..nn.config import QuantConfig
from ..nn.layers import QuantDense, load_quant_tree
from ..parallel import comm

__all__ = ["LMConfig", "gpt2_config", "opt_config", "bloom_config",
           "alibi_slopes", "conv1d_site_names", "ALL_SITES",
           "TransformerLM", "Block", "SelfAttention", "LayerNorm", "Embed",
           "init_kv_caches", "params_tree", "tp_logits"]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    d_ff: int
    max_seq: int = 1024
    positions: str = "learned"        # learned | learned_offset2 | alibi
    activation: str = "gelu_new"      # gelu_new | gelu | relu
    fused_qkv: bool = True
    embed_ln: bool = False            # BLOOM word-embedding LayerNorm
    ln_eps: float = 1e-5
    tie_word_embeddings: bool = True
    # GPT-2's matmul sites are Conv1D, quantized per INPUT channel with
    # OVP pairs along the output axis. True = every site, False = none
    # (Linear semantics), or a tuple of site names.
    conv1d_sites: Any = False
    dtype: Any = torch.float32

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def gpt2_config(size: str = "xl", **kw) -> LMConfig:
    dims = {"small": (768, 12, 12), "medium": (1024, 24, 16),
            "large": (1280, 36, 20), "xl": (1600, 48, 25)}
    d, l, h = dims[size]
    return LMConfig(vocab_size=50257, d_model=d, n_layers=l, n_heads=h,
                    d_ff=4 * d, max_seq=1024, positions="learned",
                    activation="gelu_new", fused_qkv=True,
                    conv1d_sites=True, **kw)


def opt_config(size: str = "6.7b", **kw) -> LMConfig:
    dims = {"125m": (768, 12, 12, 3072), "1.3b": (2048, 24, 32, 8192),
            "6.7b": (4096, 32, 32, 16384), "13b": (5120, 40, 40, 20480)}
    d, l, h, ff = dims[size]
    return LMConfig(vocab_size=50272, d_model=d, n_layers=l, n_heads=h,
                    d_ff=ff, max_seq=2048, positions="learned_offset2",
                    activation="relu", fused_qkv=False, **kw)


def bloom_config(size: str = "7b1", **kw) -> LMConfig:
    dims = {"560m": (1024, 24, 16), "1b7": (2048, 24, 16),
            "3b": (2560, 30, 32), "7b1": (4096, 30, 32)}
    d, l, h = dims[size]
    return LMConfig(vocab_size=250880, d_model=d, n_layers=l, n_heads=h,
                    d_ff=4 * d, max_seq=2048, positions="alibi",
                    activation="gelu", fused_qkv=True, embed_ln=True, **kw)


def alibi_slopes(n_heads: int) -> np.ndarray:
    """ALiBi per-head slopes (BLOOM's build_alibi_tensor semantics)."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(np.log2(n) - 3)))
        return start * (start ** np.arange(n))

    if np.log2(n_heads).is_integer():
        return pow2_slopes(n_heads)
    closest = 2 ** int(np.floor(np.log2(n_heads)))
    base = pow2_slopes(closest)
    extra = pow2_slopes(2 * closest)[0::2][: n_heads - closest]
    return np.concatenate([base, extra])


ALL_SITES = ("qkv", "q", "k", "v", "out", "fc_in", "fc_out")


def conv1d_site_names(c: LMConfig) -> frozenset:
    """Normalized set of sites with Conv1D quantizer semantics."""
    if c.conv1d_sites is True:
        return frozenset(ALL_SITES)
    if not c.conv1d_sites:
        return frozenset()
    return frozenset(c.conv1d_sites)


def _qdense(c: LMConfig, qcfg: QuantConfig, in_features: int,
            features: int, name: str, device) -> QuantDense:
    """QuantDense with the site's quantizer axes (``conv1d_sites``)."""
    ca, pa = (0, 1) if name in conv1d_site_names(c) else (-1, 0)
    return QuantDense(in_features, features, qcfg, dtype=c.dtype,
                      channel_axis=ca, pair_axis=pa, device=device,
                      parallel="row" if name in ("out", "fc_out")
                      else "column")


class LayerNorm(nn.Module):
    """flax's LayerNorm: f32 mean and E[x^2] - mean^2 (clipped at 0), then
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""

    def __init__(self, d: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones((d,), device=device))
        self.bias = nn.Parameter(torch.zeros((d,), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        mean = xf.mean(dim=-1, keepdim=True)
        mean2 = (xf * xf).mean(dim=-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mean) * mul + self.bias).to(
            torch.promote_types(x.dtype, torch.float32))


class Embed(nn.Module):
    """An embedding table ``embedding`` (n, d), looked up in ``dtype``."""

    def __init__(self, n: int, d: int, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty((n, d), device=device))
        nn.init.normal_(self.embedding, std=1.0 / math.sqrt(d))

    def forward(self, ids: torch.Tensor, tp_group=None) -> torch.Tensor:
        """The rows of ``ids``; under a ``tp_group`` the table is split
        along d and the rank's columns are gathered."""
        y = self.embedding[ids].to(self.dtype)
        return y if tp_group is None else comm.gather_from_group(
            y, tp_group, -1)


def _activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name in ("gelu_new", "gelu"):
        # BLOOM's gelu is the tanh form as well
        c = float(np.sqrt(2.0 / np.pi))
        return 0.5 * x * (1.0 + torch.tanh(
            c * (x + 0.044715 * torch.pow(x, 3.0))))
    if name == "relu":
        return torch.relu(x)
    raise ValueError(name)


class SelfAttention(nn.Module):
    def __init__(self, c: LMConfig, qcfg: QuantConfig, device=None):
        super().__init__()
        self.c = c
        d = c.d_model
        names = ("qkv",) if c.fused_qkv else ("q", "k", "v")
        for n in names:
            self.add_module(n, _qdense(c, qcfg, d, 3 * d if n == "qkv"
                                       else d, n, device))
        self.out = _qdense(c, qcfg, d, d, "out", device)

    def forward(self, x, mask, alibi_bias=None, kv_cache=None,
                cache_index=None, tp_group=None):
        c = self.c
        hd = c.head_dim
        if c.fused_qkv:
            qkv = self.qkv(x, tp_group)
            if tp_group is not None:
                qkv = comm.gather_from_group(qkv, tp_group, -1)
            q, k, v = qkv.split(c.d_model, dim=-1)
        else:
            q, k, v = (getattr(self, n)(x, tp_group) for n in ("q", "k", "v"))
        h = q.shape[-1] // hd           # this rank's heads
        if alibi_bias is not None and h < c.n_heads:
            r = dist.get_rank(tp_group)
            alibi_bias = alibi_bias[:, r * h:(r + 1) * h]
        B, T = x.shape[0], x.shape[1]
        q = q.reshape(B, T, h, hd)
        k = k.reshape(B, T, h, hd)
        v = v.reshape(B, T, h, hd)
        new_cache = None
        if kv_cache is not None:
            ck, cv = kv_cache                              # (B, S, h, hd)
            ck[:, cache_index:cache_index + T] = k.to(ck.dtype)
            cv[:, cache_index:cache_index + T] = v.to(cv.dtype)
            k, v = ck, cv
            new_cache = (ck, cv)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k.to(q.dtype))
        scores = scores / torch.tensor(np.float32(np.sqrt(hd)),
                                       device=x.device)
        if alibi_bias is not None:
            scores = scores + alibi_bias
        neg = torch.tensor(torch.finfo(scores.dtype).min, dtype=scores.dtype,
                           device=x.device)
        attn = torch.softmax(torch.where(mask, scores, neg), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v.to(attn.dtype))
        out = out.reshape(B, T, h * hd)
        if c.fused_qkv and tp_group is not None:
            out = comm.scatter_to_group(out, tp_group, -1)
        return self.out(out, tp_group), new_cache


class Block(nn.Module):
    def __init__(self, c: LMConfig, qcfg: QuantConfig, device=None):
        super().__init__()
        self.c = c
        self.ln_1 = LayerNorm(c.d_model, c.ln_eps, device)
        self.attn = SelfAttention(c, qcfg, device)
        self.ln_2 = LayerNorm(c.d_model, c.ln_eps, device)
        self.fc_in = _qdense(c, qcfg, c.d_model, c.d_ff, "fc_in", device)
        self.fc_out = _qdense(c, qcfg, c.d_ff, c.d_model, "fc_out", device)

    def forward(self, x, mask, alibi_bias=None, kv_cache=None,
                cache_index=None, tp_group=None):
        a, new_cache = self.attn(self.ln_1(x), mask, alibi_bias, kv_cache,
                                 cache_index, tp_group)
        x = x + a
        h = _activation(self.c.activation,
                        self.fc_in(self.ln_2(x), tp_group))
        return x + self.fc_out(h, tp_group), new_cache


class TransformerLM(nn.Module):
    """The decoder LM on ``device`` (default "cuda"): input_ids (B, T) ->
    logits (B, T, V). Prefill: ``kv_caches`` None, causal attention over
    T. Decode: ``kv_caches`` per layer (k, v) of (B, S, h, hd) and
    ``cache_index`` the fill position; returns (logits, caches). Weights
    start as normal samples of std 1/sqrt(fan in) (LayerNorms at 1 and 0,
    biases 0); load real ones with ``load_state_dict`` (a reference
    params tree through ``convert.from_jax_lm_params``). ``tp_group``:
    the model's parameters are this rank's shards (see the module's
    docstring and :func:`tp_logits`)."""

    def __init__(self, cfg: LMConfig, qcfg: QuantConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        c = self.cfg = cfg
        self.qcfg = qcfg
        self.wte = Embed(c.vocab_size, c.d_model, c.dtype, dev)
        if c.positions == "learned":
            self.wpe = Embed(c.max_seq, c.d_model, c.dtype, dev)
        elif c.positions == "learned_offset2":
            # OPT's learned positions add 2 to every index
            self.wpe = Embed(c.max_seq + 2, c.d_model, c.dtype, dev)
        elif c.positions != "alibi":
            raise ValueError(c.positions)
        if c.embed_ln:
            self.embed_ln = LayerNorm(c.d_model, c.ln_eps, dev)
        for i in range(c.n_layers):
            self.add_module(f"h_{i}", Block(c, qcfg, dev))
        self.ln_f = LayerNorm(c.d_model, c.ln_eps, dev)
        if not c.tie_word_embeddings:
            self.lm_head = nn.Module()
            self.lm_head.kernel = nn.Parameter(torch.empty(
                (c.d_model, c.vocab_size), device=dev))
            nn.init.normal_(self.lm_head.kernel,
                            std=1.0 / math.sqrt(c.d_model))

    def forward(self, input_ids, kv_caches=None, cache_index=None,
                tp_group=None):
        with tf32_off():
            return self._forward(input_ids, kv_caches, cache_index,
                                 tp_group)

    def _forward(self, input_ids, kv_caches, cache_index, tp_group):
        c = self.cfg
        g = tp_group
        dev = self.ln_f.scale.device
        ids = torch.as_tensor(input_ids, device=dev).long()
        B, T = ids.shape
        x = self.wte(ids, g)
        if cache_index is None:
            pos0, kv_len = 0, T
        else:
            pos0, kv_len = int(cache_index), kv_caches[0][0].shape[1]
        positions = pos0 + torch.arange(T, device=dev)
        if c.positions == "learned":
            x = x + self.wpe(positions, g)
        elif c.positions == "learned_offset2":
            x = x + self.wpe(positions + 2, g)
        if c.embed_ln:
            x = self.embed_ln(x)
        q_pos = positions[:, None]
        k_pos = torch.arange(kv_len, device=dev)[None, :]
        mask = (k_pos <= q_pos)[None, None]               # (1, 1, T, S)
        alibi_bias = None
        if c.positions == "alibi":
            slopes = torch.tensor(alibi_slopes(c.n_heads), dtype=x.dtype,
                                  device=dev)
            rel = (k_pos - q_pos).to(x.dtype)
            alibi_bias = slopes[None, :, None, None] * rel[None, None]
        new_caches = [] if kv_caches is not None else None
        for i in range(c.n_layers):
            kv = kv_caches[i] if kv_caches is not None else None
            x, nc = getattr(self, f"h_{i}")(x, mask, alibi_bias, kv,
                                            pos0 if kv is not None else None,
                                            g)
            if new_caches is not None:
                new_caches.append(nc)
        x = self.ln_f(x)
        if g is None:
            head = (self.wte.embedding.t() if c.tie_word_embeddings
                    else self.lm_head.kernel)
            logits = x @ head.to(x.dtype)
        elif c.tie_word_embeddings:
            logits = comm.reduce_from_group(
                comm.scatter_to_group(x, g, -1)
                @ self.wte.embedding.t().to(x.dtype), g)
        else:
            logits = comm.gather_from_group(
                comm.copy_to_group(x, g) @ self.lm_head.kernel.to(x.dtype),
                g, -1)
        if new_caches is not None:
            return logits, new_caches
        return logits


def init_kv_caches(cfg: LMConfig, batch: int, max_len: int,
                   dtype=torch.float32, device=None) -> List:
    """Fresh per-layer (k, v) buffers (B, S, h, hd) for decode."""
    dev = resolve_device(device)
    shape = (batch, max_len, cfg.n_heads, cfg.head_dim)
    return [(torch.zeros(shape, dtype=dtype, device=dev),
             torch.zeros(shape, dtype=dtype, device=dev))
            for _ in range(cfg.n_layers)]


def params_tree(model: nn.Module) -> Dict:
    """The model's parameters (detached) as the reference's nested params
    tree, ``{"h_0": {"attn": {"q": {"kernel", "bias"}}}, "wte":
    {"embedding"}, ...}``."""
    tree: Dict = {}
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = p.detach()
    return tree


def tp_logits(model: "TransformerLM", params: Dict, quant, ids,
              tp_group) -> torch.Tensor:
    """Logits (B, T, V) of this rank's batch rows ``ids`` from this rank's
    shards of the params tree (``params_tree``'s form; leaves that
    require grad get their gradients) and of the quant tree (None or {}
    when unquantized), run through ``model`` (any instance of the
    config: its own parameters are not read, and its states are set to
    ``quant``) with ``torch.func.functional_call``. Every rank of
    ``tp_group`` gets the same logits."""
    if quant:
        load_quant_tree(model, quant)
    flat: Dict = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat[".".join(path + (k,))] = v

    walk(params, ())
    return torch.func.functional_call(model, flat, (ids,),
                                      {"tp_group": tp_group}, strict=True)
