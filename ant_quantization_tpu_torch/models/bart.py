"""Quantized BART encoder-decoder with its task heads.

Counterpart of the reference's ``models/bart.py``: HF BART (post-LN,
learned positions at an offset of 2, exact GELU, one embedding table
shared by encoder and decoder) with every attention projection and FFN
linear a ``QuantDense``; embeddings and LayerNorms stay full precision.
Modules carry the flax names (``model.enc_0.self_attn.q_proj.kernel``).
q is multiplied by head_dim^-0.5 after its bias, as the reference does;
masks are added as ``(1 - mask) * finfo(f32).min`` (padding) and as 0 or
the f32 minimum (the decoder's causal self-mask). The classification
head pools the decoder state at each row's last eos (position 0 when a
row has none).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
from torch import nn

from .._ext import resolve_device
from ..kernels.qmatmul import tf32_off
from ..nn.config import QuantConfig
from ..nn.layers import QuantDense
from .bert import additive_mask, attend, gelu_erf
from .transformer_lm import Embed, LayerNorm

__all__ = ["BartConfig", "bart_base_config", "bart_large_config",
           "BartAttention", "BartEncoderLayer", "BartDecoderLayer",
           "BartModel", "BartClassificationHead",
           "BartForSequenceClassification", "BartForQuestionAnswering",
           "import_hf_bart"]


@dataclasses.dataclass(frozen=True)
class BartConfig:
    vocab_size: int = 50265
    d_model: int = 768
    enc_layers: int = 6
    dec_layers: int = 6
    n_heads: int = 12
    d_ff: int = 3072
    max_seq: int = 1024
    ln_eps: float = 1e-5
    num_labels: int = 2
    eos_token_id: int = 2
    pad_token_id: int = 1
    decoder_start_token_id: int = 2


def bart_base_config(**kw) -> BartConfig:
    return BartConfig(**kw)


def bart_large_config(**kw) -> BartConfig:
    return BartConfig(d_model=1024, enc_layers=12, dec_layers=12,
                      n_heads=16, d_ff=4096, **kw)


class BartAttention(nn.Module):
    """Self-attention, or cross-attention over ``kv`` when given."""

    def __init__(self, c: BartConfig, qcfg: QuantConfig, device=None):
        super().__init__()
        self.c = c
        d = c.d_model
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, QuantDense(d, d, qcfg, device=device))

    def forward(self, x, kv=None, mask=None):
        c = self.c
        kv = x if kv is None else kv
        q = self.q_proj(x) * ((c.d_model // c.n_heads) ** -0.5)
        out = attend(q, self.k_proj(kv), self.v_proj(kv), mask, c.n_heads)
        return self.out_proj(out)


class BartEncoderLayer(nn.Module):
    def __init__(self, c: BartConfig, qcfg: QuantConfig, device=None):
        super().__init__()
        self.self_attn = BartAttention(c, qcfg, device)
        self.self_attn_ln = LayerNorm(c.d_model, c.ln_eps, device)
        self.fc1 = QuantDense(c.d_model, c.d_ff, qcfg, device=device)
        self.fc2 = QuantDense(c.d_ff, c.d_model, qcfg, device=device)
        self.final_ln = LayerNorm(c.d_model, c.ln_eps, device)

    def forward(self, x, mask):
        x = self.self_attn_ln(x + self.self_attn(x, mask=mask))
        return self.final_ln(x + self.fc2(gelu_erf(self.fc1(x))))


class BartDecoderLayer(nn.Module):
    def __init__(self, c: BartConfig, qcfg: QuantConfig, device=None):
        super().__init__()
        self.self_attn = BartAttention(c, qcfg, device)
        self.self_attn_ln = LayerNorm(c.d_model, c.ln_eps, device)
        self.encoder_attn = BartAttention(c, qcfg, device)
        self.encoder_attn_ln = LayerNorm(c.d_model, c.ln_eps, device)
        self.fc1 = QuantDense(c.d_model, c.d_ff, qcfg, device=device)
        self.fc2 = QuantDense(c.d_ff, c.d_model, qcfg, device=device)
        self.final_ln = LayerNorm(c.d_model, c.ln_eps, device)

    def forward(self, x, enc, self_mask, cross_mask):
        x = self.self_attn_ln(x + self.self_attn(x, mask=self_mask))
        x = self.encoder_attn_ln(
            x + self.encoder_attn(x, kv=enc, mask=cross_mask))
        return self.final_ln(x + self.fc2(gelu_erf(self.fc1(x))))


class BartModel(nn.Module):
    """(input_ids, attention_mask, decoder_input_ids) -> (decoder states,
    encoder states). Without ``decoder_input_ids`` the decoder reads the
    input shifted right behind ``decoder_start_token_id``, as HF's
    BartModel does."""

    def __init__(self, c: BartConfig, qcfg: QuantConfig, device=None):
        super().__init__()
        self.c = c
        f32 = torch.float32
        self.shared = Embed(c.vocab_size, c.d_model, f32, device)
        self.encoder_pos = Embed(c.max_seq + 2, c.d_model, f32, device)
        self.encoder_embed_ln = LayerNorm(c.d_model, c.ln_eps, device)
        for i in range(c.enc_layers):
            self.add_module(f"enc_{i}", BartEncoderLayer(c, qcfg, device))
        self.decoder_pos = Embed(c.max_seq + 2, c.d_model, f32, device)
        self.decoder_embed_ln = LayerNorm(c.d_model, c.ln_eps, device)
        for i in range(c.dec_layers):
            self.add_module(f"dec_{i}", BartDecoderLayer(c, qcfg, device))

    def forward(self, input_ids, attention_mask=None, decoder_input_ids=None):
        c = self.c
        dev = self.encoder_embed_ln.scale.device
        ids = torch.as_tensor(input_ids, device=dev).long()
        if decoder_input_ids is None:
            start = torch.full((ids.shape[0], 1), c.decoder_start_token_id,
                               dtype=ids.dtype, device=dev)
            dec_ids = torch.cat([start, ids[:, :-1]], dim=1)
        else:
            dec_ids = torch.as_tensor(decoder_input_ids, device=dev).long()
        T = ids.shape[1]
        x = self.shared(ids) + self.encoder_pos(
            torch.arange(T, device=dev) + 2)
        x = self.encoder_embed_ln(x)
        enc_mask = additive_mask(None if attention_mask is None else
                                 torch.as_tensor(attention_mask, device=dev))
        for i in range(c.enc_layers):
            x = getattr(self, f"enc_{i}")(x, enc_mask)
        enc = x
        Td = dec_ids.shape[1]
        y = self.shared(dec_ids) + self.decoder_pos(
            torch.arange(Td, device=dev) + 2)
        y = self.decoder_embed_ln(y)
        # causal only: HF passes no decoder mask on these heads' paths
        causal = torch.tril(torch.ones((Td, Td), dtype=torch.bool,
                                       device=dev))[None, None]
        self_mask = torch.where(
            causal, torch.tensor(0.0, device=dev),
            torch.tensor(torch.finfo(torch.float32).min, device=dev))
        for i in range(c.dec_layers):
            y = getattr(self, f"dec_{i}")(y, enc, self_mask, enc_mask)
        return y, enc


class BartClassificationHead(nn.Module):
    def __init__(self, c: BartConfig, qcfg: QuantConfig, device=None):
        super().__init__()
        self.dense = QuantDense(c.d_model, c.d_model, qcfg, device=device)
        self.out_proj = QuantDense(c.d_model, c.num_labels, qcfg,
                                   device=device)

    def forward(self, x):
        return self.out_proj(torch.tanh(self.dense(x)))


class BartForSequenceClassification(nn.Module):
    """The GLUE head on ``device`` (default "cuda"): (input_ids,
    token_type_ids (unused: BART has none), attention_mask) -> logits
    (B, num_labels), from the decoder state at each row's last eos
    (position 0 in a row without one). Weights start as normal samples of
    std 1/sqrt(fan in); load real ones with ``load_state_dict``."""

    def __init__(self, cfg: BartConfig, qcfg: QuantConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.model = BartModel(cfg, qcfg, dev)
        self.classification_head = BartClassificationHead(cfg, qcfg, dev)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        with tf32_off():
            dec, _ = self.model(input_ids, attention_mask)
            ids = torch.as_tensor(input_ids, device=dec.device).long()
            pos = torch.arange(ids.shape[1], device=dec.device)[None, :]
            idx = torch.where(ids == self.cfg.eos_token_id, pos,
                              -1).amax(dim=1).clamp(min=0)
            pooled = dec[torch.arange(dec.shape[0], device=dec.device), idx]
            return self.classification_head(pooled)


class BartForQuestionAnswering(nn.Module):
    """The SQuAD head on ``device`` (default "cuda"): -> (start_logits,
    end_logits) over the decoder states."""

    def __init__(self, cfg: BartConfig, qcfg: QuantConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.model = BartModel(cfg, qcfg, dev)
        self.qa_outputs = QuantDense(cfg.d_model, 2, qcfg, device=dev)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        with tf32_off():
            dec, _ = self.model(input_ids, attention_mask)
            logits = self.qa_outputs(dec)
        return logits[..., 0], logits[..., 1]


# ---------------------------------------------------------------------------
# HF import
# ---------------------------------------------------------------------------

def import_hf_bart(sd: Mapping, cfg: BartConfig,
                   head: str = "classification") -> dict:
    """HF BartForSequenceClassification / BartForQuestionAnswering (or a
    bare BartModel, prefix-insensitive) state dict -> the reference's
    params tree (leaves of the input's kind; dense kernels (in, out))."""
    def g(key):
        for pfx in ("", "model."):
            if pfx + key in sd:
                return sd[pfx + key]
        raise KeyError(key)

    def ln(key):
        return {"scale": g(f"{key}.weight"), "bias": g(f"{key}.bias")}

    def lin(key):
        p = {"kernel": g(f"{key}.weight").T}
        if f"{key}.bias" in sd or f"model.{key}.bias" in sd:
            p["bias"] = g(f"{key}.bias")
        return p

    def attn(key):
        return {f: lin(f"{key}.{f}")
                for f in ("q_proj", "k_proj", "v_proj", "out_proj")}

    model = {
        "shared": {"embedding": g("shared.weight")},
        "encoder_pos": {"embedding": g("encoder.embed_positions.weight")},
        "decoder_pos": {"embedding": g("decoder.embed_positions.weight")},
        "encoder_embed_ln": ln("encoder.layernorm_embedding"),
        "decoder_embed_ln": ln("decoder.layernorm_embedding"),
    }
    for i in range(cfg.enc_layers):
        b = f"encoder.layers.{i}"
        model[f"enc_{i}"] = {
            "self_attn": attn(f"{b}.self_attn"),
            "self_attn_ln": ln(f"{b}.self_attn_layer_norm"),
            "fc1": lin(f"{b}.fc1"),
            "fc2": lin(f"{b}.fc2"),
            "final_ln": ln(f"{b}.final_layer_norm"),
        }
    for i in range(cfg.dec_layers):
        b = f"decoder.layers.{i}"
        model[f"dec_{i}"] = {
            "self_attn": attn(f"{b}.self_attn"),
            "self_attn_ln": ln(f"{b}.self_attn_layer_norm"),
            "encoder_attn": attn(f"{b}.encoder_attn"),
            "encoder_attn_ln": ln(f"{b}.encoder_attn_layer_norm"),
            "fc1": lin(f"{b}.fc1"),
            "fc2": lin(f"{b}.fc2"),
            "final_ln": ln(f"{b}.final_layer_norm"),
        }
    params = {"model": model}
    if head == "classification" and "classification_head.dense.weight" in sd:
        params["classification_head"] = {
            "dense": {"kernel": sd["classification_head.dense.weight"].T,
                      "bias": sd["classification_head.dense.bias"]},
            "out_proj": {
                "kernel": sd["classification_head.out_proj.weight"].T,
                "bias": sd["classification_head.out_proj.bias"]},
        }
    if head == "qa" and "qa_outputs.weight" in sd:
        params["qa_outputs"] = {"kernel": sd["qa_outputs.weight"].T,
                                "bias": sd["qa_outputs.bias"]}
    return params
