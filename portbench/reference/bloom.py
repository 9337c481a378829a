"""BLOOM (bigscience/bloom-*): ALiBi in place of positions, a LayerNorm
on the word embeddings, pre-LayerNorm blocks with a fused qkv projection
(the engine's [q | k | v] column thirds), the tanh GELU, tied
embeddings; the shared arithmetic is ``decoder.py``'s."""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from portbench.reference import decoder

head_logits = decoder.head_logits


def alibi_slopes(n_heads: int) -> np.ndarray:
    """BLOOM's per-head slopes (``build_alibi_tensor``)."""
    def pow2(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return start * (start ** np.arange(n))

    if math.log2(n_heads).is_integer():
        return pow2(n_heads)
    closest = 2 ** int(math.floor(math.log2(n_heads)))
    return np.concatenate([pow2(closest),
                           pow2(2 * closest)[0::2][:n_heads - closest]])


def embed(top: dict, ids: torch.Tensor, lm: dict) -> torch.Tensor:
    return top["wte_i8"][ids].float() * top["wte_scale"][ids].float()[:, None]


def attention_bias(lm: dict, T: int, device) -> torch.Tensor:
    """(H, T, T): slope times (key position - query position); the
    query's own term cancels in the softmax, as in BLOOM's form."""
    slopes = torch.tensor(alibi_slopes(lm["n_heads"]), dtype=torch.float32,
                          device=device)
    pos = torch.arange(T, device=device, dtype=torch.float32)
    return slopes[:, None, None] * (pos[None, None, :] - pos[None, :, None])


def activation(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def split_qkv(site: dict, x: torch.Tensor):
    return site["qkv"](x).chunk(3, dim=-1)


def final_hidden(config, ep, seqs, precision, device):
    return decoder.final_hidden(sys.modules[__name__], config, ep, seqs,
                                precision, device)
