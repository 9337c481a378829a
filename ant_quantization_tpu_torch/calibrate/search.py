"""Calibration: clip-scale (alpha) search, adaptive numeric-type selection
and QuantState construction.

Counterpart of the reference's ``calibrate/search.py``, the reference
Quantizer's ``_init_quant_para`` (ANT and OliVe). Its ``lax.scan`` over
the ratio ladder is a loop here that keeps the per-channel running best
on x's device (no host read per ratio); the 4/8-bit ``lax.cond`` and the
type choice are host branches, one device read each per tensor. Every
parity rule of the reference is kept:

- per-channel weights, per-tensor activations;
- the initial clip x_max: absmax, or mean +- 3 std (Bessel-corrected) for
  OliVe with outliers;
- the ratio ladder i/100 for i in [low, up) in steps of 1 (ANT) or 2
  (OliVe); ANT starts at 95 above 6 bits;
- a strict-improvement update, so the earliest ratio wins a tie of MSE;
- the type by the summed per-channel best MSE, a stable argmin (the
  earlier candidate wins a tie);
- above 6 bits the int codebook; float2..float4 are searched with one
  exponent bit but finalized with their stated width (and the ladder
  re-run on the final grid).

The scores are f32 means: the port and the reference sum them in other
orders, so two ratios or two types whose scores lie within a few ulps
can swap; states agree bit for bit only away from such near-ties.
"""

from __future__ import annotations

import numpy as np
import torch

from ..numerics import codebooks as cb
from ..ops.fake_quant import ant_fake_quant, olive_fake_quant
from ..ops.outlier import outlier_fake_quant, outlier_thresholds
from .spec import GRID_PAD, OUTLIER_PAD, QuantState, SiteConfig, pad_grid

__all__ = ["calibrate", "apply_quant", "mode_index"]


def mode_index(mode: str) -> int:
    """Canonical index of a numeric type (into ``ANT_MODES``)."""
    return cb.ANT_MODES.index(mode)


def _grid_pair(cfg: SiteConfig, mode: str, bit: int,
               search: bool) -> np.ndarray:
    """(2, G) [unsigned, signed] grids of one mode at one bit, padded to a
    common length. ``search`` applies the float2..4 one-exponent-bit
    search quirk."""
    if cfg.family == "olive":
        g_u = cb.olive_grid(mode, bit, False)
        g_s = cb.olive_grid(mode, bit, True)
    else:
        m = mode
        if search and mode in ("float2", "float3", "float4"):
            m = "float1"
        g_u = cb.ant_grid(m, bit, False)
        g_s = cb.ant_grid(m, bit, True)
    n = max(g_u.shape[0], g_s.shape[0])
    return np.stack([pad_grid(g_u, n), pad_grid(g_s, n)])


def _outlier_pair(bit: int) -> np.ndarray:
    g_u = cb.olive_outlier_values(bit, False)
    g_s = cb.olive_outlier_values(bit, True)
    n = max(g_u.shape[0], g_s.shape[0])
    return np.stack([pad_grid(g_u, n), pad_grid(g_s, n)])


def _x_max(x2: torch.Tensor, cfg: SiteConfig,
           per_channel: bool) -> torch.Tensor:
    """Initial clip scale: absmax, or 3 sigma when OliVe outliers are on
    (the std Bessel-corrected, as torch's ``.std()``)."""
    if cfg.use_ovp:
        if per_channel:
            mean = x2.mean(dim=1)
            std = x2.std(dim=1, correction=1)
        else:
            mean = x2.mean()
            std = x2.std(correction=1)
        return torch.maximum((mean + 3 * std).abs(), (mean - 3 * std).abs())
    if per_channel:
        return x2.abs().amax(dim=1)
    return x2.abs().max()


def _fq(x2, grid, outliers, alpha, cfg: SiteConfig, per_channel: bool):
    """Fake-quant in the search's (C, K) / (N,) layout; OVP pairs along
    the row-major order of (C, K)."""
    ca = 0 if per_channel else None
    if cfg.use_ovp:
        return olive_fake_quant(x2, grid, outliers, alpha, channel_axis=ca,
                                pair_axis=1 if per_channel else 0)
    return ant_fake_quant(x2, grid, alpha, channel_axis=ca)


def _mse(q, x2, per_channel: bool) -> torch.Tensor:
    se = torch.square(q - x2)
    return se.mean(dim=1) if per_channel else se.mean()


def _scan_alpha(x2, grid, outliers, base, ratios: np.ndarray,
                cfg: SiteConfig, per_channel: bool):
    """Best (score, alpha) over the ratio ladder, on x2's device; the
    strict update keeps the earliest ratio of a tie."""
    rs = torch.tensor(ratios, dtype=torch.float32, device=x2.device)
    best_score = torch.full_like(base, 1e10)
    best_alpha = base
    for i in range(rs.shape[0]):
        a = base * rs[i]
        score = _mse(_fq(x2, grid, outliers, a, cfg, per_channel), x2,
                     per_channel)
        upd = score < best_score
        best_score = torch.where(upd, score, best_score)
        best_alpha = torch.where(upd, a, best_alpha)
    return best_score, best_alpha


def _ratio_ladder(low: int, up: int, step: int) -> np.ndarray:
    return np.arange(low, up, step, dtype=np.float64) * 0.01


def _search_bit(x2, cfg: SiteConfig, bit: int, modes: tuple, low: int,
                per_channel: bool, signed: bool, sticky: int = -1):
    """Type and scale search at one bit-width. ``sticky`` (-1: none) pins
    the type to a previously chosen one: the reference's first
    calibration overwrites its mode with the concrete type, so a
    recalibration re-runs only the alpha ladder. Returns (mode index,
    alpha, per-channel score, padded grid, padded outliers)."""
    dev = x2.device
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    ratios = _ratio_ladder(low, cfg.up, cfg.scan_step)
    base = _x_max(x2, cfg, per_channel)
    sidx = int(signed)
    outliers = t(_outlier_pair(bit)[sidx]) if cfg.use_ovp else None
    scores, alphas = [], []
    for m in modes:
        grid = t(_grid_pair(cfg, m, bit, search=True)[sidx])
        s, a = _scan_alpha(x2, grid, outliers, base, ratios, cfg,
                           per_channel)
        scores.append(s.sum())
        alphas.append(a)
    chosen = int(torch.argmin(torch.stack(scores)))   # first of a tie
    mode_ids = [mode_index(m) for m in modes]
    if len(modes) > 1 and sticky >= 0 and sticky in mode_ids:
        chosen = mode_ids.index(sticky)
    final = _grid_pair(cfg, modes[chosen], bit, search=False)[sidx]
    final_grid = t(final)
    if any(m in ("float2", "float3", "float4") for m in modes):
        # the final grid may differ from the searched one: the ladder
        # runs again on it
        score, alpha = _scan_alpha(x2, final_grid, outliers, base, ratios,
                                   cfg, per_channel)
    else:
        alpha = alphas[chosen]
        score = _mse(_fq(x2, final_grid, outliers, alpha, cfg, per_channel),
                     x2, per_channel)
    grid256 = t(pad_grid(final.astype(np.float32), GRID_PAD))
    out256 = (t(pad_grid(_outlier_pair(bit)[sidx].astype(np.float32),
                         OUTLIER_PAD)) if cfg.use_ovp
              else torch.zeros((OUTLIER_PAD,), device=dev))
    return mode_ids[chosen], alpha, score, grid256, out256


def _scalar(v, dtype, device) -> torch.Tensor:
    return torch.tensor(v, dtype=dtype, device=device)


def calibrate(x: torch.Tensor, cfg: SiteConfig, promoted=None,
              prev_mode=None) -> QuantState:
    """Calibrate one tensor (on its device) and return its QuantState.

    ``promoted`` (bool, or a bool tensor) switches the site to 8-bit int;
    ``prev_mode`` (int, -1 = first calibration) pins a previously chosen
    adaptive type. Weights are channel-last (the (K, N) kernel);
    ``cfg.channel_axis`` selects the per-channel dim."""
    if cfg.mode == "outlier":
        return _calibrate_outlier(x, cfg)
    dev = x.device
    per_channel = cfg.per_channel
    if per_channel:
        x2 = torch.movedim(x, cfg.channel_axis, 0).reshape(
            x.shape[cfg.channel_axis], -1)
    else:
        x2 = x.reshape(-1)
    signed = bool(cfg.is_signed) or bool(x.min() < 0)
    promoted = promoted is not None and bool(promoted)
    prev = -1 if prev_mode is None else int(prev_mode)
    if not promoted:
        bit, modes = cfg.bit, cfg.candidate_modes
        low = 95 if (cfg.family == "ant" and bit > 6) else cfg.low
        # above 6 bits both references force the int codebook; only the
        # 95% lower bound is ANT's
        if bit > 6:
            modes = ("int",)
        m, a, s, g, o = _search_bit(x2, cfg, bit, modes, low, per_channel,
                                    signed, sticky=prev)
    else:
        bit = 8
        low = 95 if cfg.family == "ant" else cfg.low
        m, a, s, g, o = _search_bit(x2, cfg, 8, ("int",), low, per_channel,
                                    signed)
    return QuantState(
        alpha=a, grid=g, outliers=o,
        bit=_scalar(bit, torch.int32, dev),
        mode_idx=_scalar(m, torch.int32, dev),
        is_signed=_scalar(signed, torch.bool, dev),
        mse=s.mean() if per_channel else s.to(torch.float32),
        initialized=_scalar(True, torch.bool, dev),
        aux=_scalar(0.0, torch.float32, dev))


def _calibrate_outlier(x: torch.Tensor, cfg: SiteConfig) -> QuantState:
    """GOBO-mode calibration: per-tensor percentile and absmax thresholds,
    the int grid, no MSE search."""
    dev = x.device
    signed = bool(cfg.is_signed) or bool(x.min() < 0)
    t4, t16 = outlier_thresholds(x, cfg.percent)
    grid = _grid_pair(cfg, "int", cfg.bit, search=False)[int(signed)]
    return QuantState(
        alpha=t4,
        grid=torch.as_tensor(pad_grid(grid.astype(np.float32), GRID_PAD),
                             device=dev),
        outliers=torch.zeros((OUTLIER_PAD,), device=dev),
        bit=_scalar(cfg.bit, torch.int32, dev),
        mode_idx=_scalar(mode_index("int"), torch.int32, dev),
        is_signed=_scalar(signed, torch.bool, dev),
        mse=_scalar(0.0, torch.float32, dev),
        initialized=_scalar(True, torch.bool, dev), aux=t16)


def apply_quant(x: torch.Tensor, state: QuantState,
                cfg: SiteConfig) -> torch.Tensor:
    """Fake-quantize ``x`` with a calibrated state (the model's forward)."""
    if not cfg.enabled:
        return x
    if cfg.mode == "outlier":
        return outlier_fake_quant(x, state.grid, state.alpha, state.aux,
                                  cfg.percent, state.is_signed)
    ca = cfg.channel_axis if cfg.per_channel else None
    if cfg.use_ovp:
        return olive_fake_quant(x, state.grid, state.outliers, state.alpha,
                                channel_axis=ca, pair_axis=cfg.pair_axis,
                                static_bit=cfg.bit, dyn_bit=state.bit)
    return ant_fake_quant(x, state.grid, state.alpha, channel_axis=ca,
                          static_bit=cfg.bit, dyn_bit=state.bit)
