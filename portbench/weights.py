"""Seeded random engine parameters of a configuration, made on the device.

The harness makes these tensors and hands the same ones to the program
and to the plain reference. They are the serving engine's inputs in its
layouts (``serve/engine.py``: site weights ``w_i8`` (L, N, K) as int8
codebook values with an f32 per-output-channel ``oscale``, the
activation codebook ``a_q`` and ``a_scale``, the int8 head ``wte_i8``
with per-row ``wte_scale``), drawn much as the repository's benchmarks draw
them, changed so that the model's greedy tokens depend on its input as a
trained model's do (a random model otherwise settles on one token and
the check could see no fault):

- the weight codes are the flint grid's 16 int8 codebook values, drawn
  uniformly (4-bit weights); each row's second half is its first half
  negated in a permuted order, so the row sums to zero and no site adds
  an output common to every token; each site's scale gives its
  dequantized weight a standard deviation of 1/sqrt(K), and at the
  projections into the residual stream (``out``, ``fc_out``) of
  1/sqrt(K * 2 * n_layers), as GPT-2 initialises them (at full scale 32
  layers of A4 codes flipped by bf16 rounding cascade, and the served
  tokens of a sound program depart from the float32 reference's as far
  as a lower precision's do);
- each site snaps its input onto the activation grid its
  configuration names (``a_site``): signed where the input is signed,
  unsigned after the activation function;
- the word-embedding LayerNorm's scale, where the model has one, is
  drawn around ``embed_ln_scale``.

Everything is drawn by one ``torch.Generator`` on the device, in a few
large calls, in the type it is served in.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from . import counts


def int8_codebook(grid16) -> tuple:
    """A 16-entry grid as int8 values times a unit: the smallest D <= 127
    with ``grid * D / max|grid|`` integral (copied from the port's
    ``kernels/qmatmul.py:int8_codebook``). -> (q16 int8, unit, exact)."""
    g = np.asarray(grid16, np.float64).reshape(-1)
    vmax = float(np.max(np.abs(g)))
    if vmax == 0.0:
        return np.zeros(g.shape, np.int8), 1.0, True
    u = g / vmax
    for d in range(1, 128):
        q = u * d
        if float(np.max(np.abs(q - np.round(q)))) < 1e-6:
            return np.round(q).astype(np.int8), vmax / d, True
    return np.round(u * 127).astype(np.int8), vmax / 127, False


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float16": torch.float16,
            "float32": torch.float32}[name]


def make(config: dict, seed: int, device) -> Dict:
    """The engine params of ``config`` from ``seed`` on ``device``."""
    lm, quant = config["lm"], config["quant"]
    dtype = dtype_of(config["engine"]["dtype"])
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (2 ** 63))
    L, d, V = lm["n_layers"], lm["d_model"], lm["vocab_size"]
    wq16, _, _ = int8_codebook(quant["w_grid"])
    if sorted(wq16.tolist()) != sorted((-wq16).tolist()):
        raise ValueError("the weight codebook is not symmetric")
    w_table = torch.tensor(wq16.astype(np.int8), device=dev)
    w_rms = float(np.sqrt(np.mean(wq16.astype(np.float64) ** 2)))
    a_alpha = float(quant["a_alpha"])

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    def normal(shape, std, mean=0.0, dt=torch.float32):
        return torch.empty(shape, dtype=dt, device=dev).normal_(
            mean, std, generator=gen)

    def per_layer(row):
        return torch.tensor(np.broadcast_to(np.asarray(row, np.float32),
                                            (L, 16)).copy(), device=dev)

    layers = {}
    residual = 1.0 / math.sqrt(2 * L)
    for name, (K, N) in counts.site_shapes(lm).items():
        codes = torch.empty((L, N, K), dtype=torch.int8, device=dev)
        h = K // 2
        for l in range(L):          # int32 indices of one layer at a time
            idx = torch.randint(0, 16, (N, h), dtype=torch.int32,
                                device=dev, generator=gen)
            codes[l, :, :h] = w_table[idx]
            perm = torch.randperm(h, device=dev, generator=gen)
            codes[l, :, h:2 * h] = -codes[l, :, perm]
            if K % 2:
                codes[l, :, K - 1] = 0
            del idx, perm
        a_grid = quant["a_grids"][quant["a_site"][name]]
        aq16, a_unit, a_exact = int8_codebook(a_grid)
        if not a_exact:
            raise ValueError(f"{name}: the activation grid has no int8-exact "
                             "codebook")
        a_scale = np.float32(a_alpha) / np.float32(np.max(a_grid)) \
            * np.float32(a_unit)
        layers[name] = {
            "w_i8": codes,
            "oscale": full((L, N), (residual if name in ("out", "fc_out")
                                    else 1.0) / (math.sqrt(K) * w_rms)),
            "bias": normal((L, N), 0.01),
            "a_grid": per_layer(a_grid),
            "a_alpha": full((L,), a_alpha),
            "a_q": per_layer(aq16.astype(np.float32)),
            "a_scale": full((L,), float(a_scale)),
        }
    for name in ("ln_1", "ln_2"):
        layers[name] = {"scale": normal((L, d), 0.05, 1.0),
                        "bias": normal((L, d), 0.02)}
    ln = lambda: {"scale": normal((d,), 0.05, 1.0), "bias": normal((d,), 0.02)}
    top = {"ln_f": ln(),
           "wte_i8": torch.randint(-127, 128, (V, d), dtype=torch.int8,
                                   device=dev, generator=gen),
           "wte_scale": torch.empty((V,), device=dev).uniform_(
               0.5 * 0.02 / 127, 1.5 * 0.02 / 127, generator=gen)}
    if lm["positions"] in ("learned", "learned_offset2"):
        top["wpe"] = normal((config["engine"]["max_seq"] + 2, d), 0.02,
                            dt=dtype)
    if lm["embed_ln"]:
        g = float(config["embed_ln_scale"])
        top["embed_ln"] = {"scale": normal((d,), 0.05 * g, g),
                           "bias": normal((d,), 0.02 * g)}
    return {"layers": layers, "top": top}
