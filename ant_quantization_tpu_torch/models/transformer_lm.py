"""Decoder-only LM configuration: GPT-2, OPT, BLOOM geometries.

The config half of the reference's ``models/transformer_lm.py``, as plain
Python. The model modules themselves come in a later slice (ROADMAP
Queue 1 item 10).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

__all__ = ["LMConfig", "gpt2_config", "opt_config", "bloom_config",
           "alibi_slopes", "conv1d_site_names", "ALL_SITES"]


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
