"""OPT (facebook/opt-*): learned positions offset by 2, pre-LayerNorm
blocks with separate q, k and v projections, ReLU, tied embeddings; the
shared arithmetic is ``decoder.py``'s."""

from __future__ import annotations

import sys

import torch

from portbench.reference import decoder

head_logits = decoder.head_logits


def embed(top: dict, ids: torch.Tensor, lm: dict) -> torch.Tensor:
    pos = torch.arange(ids.shape[0], device=ids.device) + 2
    return (top["wte_i8"][ids].float() * top["wte_scale"][ids].float()[:, None]
            + top["wpe"][pos].float())


def attention_bias(lm: dict, T: int, device):
    return None


def activation(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def split_qkv(site: dict, x: torch.Tensor):
    return site["q"](x), site["k"](x), site["v"](x)


def final_hidden(config, ep, seqs, precision, device):
    return decoder.final_hidden(sys.modules[__name__], config, ep, seqs,
                                precision, device)
