"""Quantized BERT encoder with its task heads (GLUE classification, SQuAD
QA).

Counterpart of the reference's ``models/bert.py``: the HF BertModel
(post-LN encoder) whose every dense layer is a ``QuantDense``
(``nn/layers.py``), as the reference's Linear swap places them; the
embeddings and LayerNorms stay full precision. Modules carry the flax
names, so a parameter's ``state_dict`` key is its flax path joined by
dots (``bert.layer_0.attention.query.kernel``) and a quant tree's paths
are the reference's. LayerNorm and Embed are the flax-exact ones of
``models/transformer_lm.py``; attention divides the f32 scores by
f32(sqrt(head_dim)) and adds ``(1 - mask) * finfo(f32).min``; GELU is the
exact erf form, ``0.5 x erfc(-x sqrt(1/2))`` as ``jax.nn.gelu``
computes it. f32 products run without TF32.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from .._ext import resolve_device
from ..kernels.qmatmul import tf32_off
from ..nn.config import QuantConfig
from ..nn.layers import QuantDense
from .transformer_lm import Embed, LayerNorm

__all__ = ["BertConfig", "bert_base_config", "bert_large_config",
           "BertSelfAttention", "BertLayer", "BertModel", "BertPooler",
           "BertForSequenceClassification", "BertForQuestionAnswering",
           "import_hf_bert", "gelu_erf", "additive_mask", "attend"]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_seq: int = 512
    type_vocab_size: int = 2
    ln_eps: float = 1e-12
    num_labels: int = 2


def bert_base_config(**kw) -> BertConfig:
    return BertConfig(**kw)


def bert_large_config(**kw) -> BertConfig:
    return BertConfig(d_model=1024, n_layers=24, n_heads=16, d_ff=4096, **kw)


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU with ``jax.nn.gelu(approximate=False)``'s cast points."""
    sqrt_half = float(np.sqrt(0.5).astype(np.float32))
    return 0.5 * x * torch.special.erfc(-x * sqrt_half)


def additive_mask(attention_mask: Optional[torch.Tensor]
                  ) -> Optional[torch.Tensor]:
    """(B, S) 0/1 mask -> (B, 1, 1, S) f32: 0 where kept, the f32 minimum
    where masked."""
    if attention_mask is None:
        return None
    m = 1.0 - attention_mask[:, None, None, :].to(torch.float32)
    return m * torch.finfo(torch.float32).min


def attend(q, k, v, mask, n_heads: int, scale_div=None):
    """Multi-head softmax attention of (B, T, d) q over (B, S, d) k and v:
    f32 scores (divided by ``scale_div`` when given), plus the additive
    ``mask``, softmax over the keys; returns (B, T, d)."""
    B, T, d = q.shape
    S = k.shape[1]
    hd = d // n_heads
    q = q.reshape(B, T, n_heads, hd)
    k = k.reshape(B, S, n_heads, hd)
    v = v.reshape(B, S, n_heads, hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if scale_div is not None:
        scores = scores / scale_div
    if mask is not None:
        scores = scores + mask
    attn = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, T, d)


class BertSelfAttention(nn.Module):
    def __init__(self, c: BertConfig, qcfg: QuantConfig, device=None):
        super().__init__()
        self.c = c
        d = c.d_model
        for name in ("query", "key", "value", "output"):
            self.add_module(name, QuantDense(d, d, qcfg, device=device))

    def forward(self, x, mask):
        c = self.c
        hd = c.d_model // c.n_heads
        # np.sqrt(hd) is an f64 scalar that JAX takes as f32
        div = torch.tensor(np.float32(np.sqrt(hd)), device=x.device)
        out = attend(self.query(x), self.key(x), self.value(x), mask,
                     c.n_heads, div)
        return self.output(out)


class BertLayer(nn.Module):
    def __init__(self, c: BertConfig, qcfg: QuantConfig, device=None):
        super().__init__()
        self.attention = BertSelfAttention(c, qcfg, device)
        self.attention_ln = LayerNorm(c.d_model, c.ln_eps, device)
        self.intermediate = QuantDense(c.d_model, c.d_ff, qcfg, device=device)
        self.output = QuantDense(c.d_ff, c.d_model, qcfg, device=device)
        self.output_ln = LayerNorm(c.d_model, c.ln_eps, device)

    def forward(self, x, mask):
        x = self.attention_ln(x + self.attention(x, mask))
        h = self.output(gelu_erf(self.intermediate(x)))
        return self.output_ln(x + h)


class BertModel(nn.Module):
    """input_ids (B, T) -> the sequence output (B, T, d)."""

    def __init__(self, c: BertConfig, qcfg: QuantConfig, device=None):
        super().__init__()
        self.c = c
        self.word_embeddings = Embed(c.vocab_size, c.d_model, torch.float32,
                                     device)
        self.position_embeddings = Embed(c.max_seq, c.d_model,
                                         torch.float32, device)
        self.token_type_embeddings = Embed(c.type_vocab_size, c.d_model,
                                           torch.float32, device)
        self.embeddings_ln = LayerNorm(c.d_model, c.ln_eps, device)
        for i in range(c.n_layers):
            self.add_module(f"layer_{i}", BertLayer(c, qcfg, device))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        dev = self.embeddings_ln.scale.device
        ids = torch.as_tensor(input_ids, device=dev).long()
        T = ids.shape[1]
        tt = (torch.zeros_like(ids) if token_type_ids is None
              else torch.as_tensor(token_type_ids, device=dev).long())
        x = self.word_embeddings(ids)
        x = x + self.position_embeddings(torch.arange(T, device=dev))
        x = x + self.token_type_embeddings(tt)
        x = self.embeddings_ln(x)
        mask = additive_mask(None if attention_mask is None else
                             torch.as_tensor(attention_mask, device=dev))
        for i in range(self.c.n_layers):
            x = getattr(self, f"layer_{i}")(x, mask)
        return x


class BertPooler(nn.Module):
    def __init__(self, c: BertConfig, qcfg: QuantConfig, device=None):
        super().__init__()
        self.dense = QuantDense(c.d_model, c.d_model, qcfg, device=device)

    def forward(self, seq):
        return torch.tanh(self.dense(seq[:, 0]))


class BertForSequenceClassification(nn.Module):
    """The GLUE head on ``device`` (default "cuda"): (input_ids,
    token_type_ids, attention_mask) -> logits (B, num_labels). Weights
    start as normal samples of std 1/sqrt(fan in) (LayerNorms at 1 and 0,
    biases 0); load real ones with ``load_state_dict``."""

    def __init__(self, cfg: BertConfig, qcfg: QuantConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.bert = BertModel(cfg, qcfg, dev)
        self.pooler = BertPooler(cfg, qcfg, dev)
        self.classifier = QuantDense(cfg.d_model, cfg.num_labels, qcfg,
                                     device=dev)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        with tf32_off():
            seq = self.bert(input_ids, token_type_ids, attention_mask)
            return self.classifier(self.pooler(seq))


class BertForQuestionAnswering(nn.Module):
    """The SQuAD head on ``device`` (default "cuda"): -> (start_logits,
    end_logits), each (B, T)."""

    def __init__(self, cfg: BertConfig, qcfg: QuantConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.bert = BertModel(cfg, qcfg, dev)
        self.qa_outputs = QuantDense(cfg.d_model, 2, qcfg, device=dev)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        with tf32_off():
            logits = self.qa_outputs(self.bert(input_ids, token_type_ids,
                                               attention_mask))
        return logits[..., 0], logits[..., 1]


# ---------------------------------------------------------------------------
# HF checkpoint import
# ---------------------------------------------------------------------------

def import_hf_bert(sd: Mapping, cfg: BertConfig,
                   head: str = "classification") -> dict:
    """HF BertForSequenceClassification / BertForQuestionAnswering (or a
    bare BertModel, prefix-insensitive) state dict -> the reference's
    params tree (leaves of the input's kind; dense kernels (in, out))."""
    def g(key):
        for pfx in ("", "bert."):
            if pfx + key in sd:
                return sd[pfx + key]
        raise KeyError(key)

    def ln(key):
        return {"scale": g(f"{key}.weight"), "bias": g(f"{key}.bias")}

    def lin(key):
        return {"kernel": g(f"{key}.weight").T, "bias": g(f"{key}.bias")}

    bert = {
        "word_embeddings": {
            "embedding": g("embeddings.word_embeddings.weight")},
        "position_embeddings": {
            "embedding": g("embeddings.position_embeddings.weight")},
        "token_type_embeddings": {
            "embedding": g("embeddings.token_type_embeddings.weight")},
        "embeddings_ln": ln("embeddings.LayerNorm"),
    }
    for i in range(cfg.n_layers):
        b = f"encoder.layer.{i}"
        bert[f"layer_{i}"] = {
            "attention": {
                "query": lin(f"{b}.attention.self.query"),
                "key": lin(f"{b}.attention.self.key"),
                "value": lin(f"{b}.attention.self.value"),
                "output": lin(f"{b}.attention.output.dense"),
            },
            "attention_ln": ln(f"{b}.attention.output.LayerNorm"),
            "intermediate": lin(f"{b}.intermediate.dense"),
            "output": lin(f"{b}.output.dense"),
            "output_ln": ln(f"{b}.output.LayerNorm"),
        }
    params = {"bert": bert}
    if "bert.pooler.dense.weight" in sd or "pooler.dense.weight" in sd:
        params["pooler"] = {"dense": lin("pooler.dense")}
    if head == "classification" and "classifier.weight" in sd:
        params["classifier"] = {"kernel": sd["classifier.weight"].T,
                                "bias": sd["classifier.bias"]}
    if head == "qa" and "qa_outputs.weight" in sd:
        params["qa_outputs"] = {"kernel": sd["qa_outputs.weight"].T,
                                "bias": sd["qa_outputs.bias"]}
    return params
