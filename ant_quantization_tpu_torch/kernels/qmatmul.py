"""Host-side weight packing for the int8-value weight mode ("w4").

Counterpart of the reference's ``kernels/qmatmul.py`` packing half:
``int8_codebook`` and ``quantize_weights_w4_i8``. The weights are stored
as the exact int8 *values* of their 4-bit codebook entries, so the serving
matmul is an int8 x int8 product with one f32 scale per output channel.
Packed nibbles (``pack_w4``) and the OVP encodings belong to later slices
of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.snap import snap_codes

__all__ = ["int8_codebook", "quantize_weights_w4_i8"]


def int8_codebook(grid16) -> tuple[np.ndarray, float, bool]:
    """Exact int8 restatement of a 16-entry codebook.

    Every ANT 4-bit grid is a set of dyadic rationals times a common
    factor, so there is an integer D <= 127 with ``grid * D / max|grid|``
    integral. Returns ``(q16 int8, unit, exact)`` with
    ``grid[i] == q16[i] * unit``; grids without an exact restatement fall
    back to D = 127 rounding (``exact`` False).
    """
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


def quantize_weights_w4_i8(w: torch.Tensor, grid, alpha,
                           axis: int = 1
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize a (K, N) f32 weight onto a 16-entry grid.

    Returns ``(w_i8 (K, N) int8, scale (N,) f32)`` with the dequantized
    weight equal to ``w_i8 * scale[None, :]``. The per-channel scale is
    ``alpha / max(grid)``, the SIGNED max (the reference quantizer's
    convention; it differs from the absmax on the asymmetric int grids),
    times the codebook's unit. Only per-output-channel (Linear) scales are
    ported; GPT-2's per-input-channel Conv1D sites come later (ROADMAP
    Queue 1 item 8.3).
    """
    if axis != 1:
        raise NotImplementedError(
            "per-input-channel (Conv1D, 'kscale') weights are not ported "
            "yet (ROADMAP Queue 1 item 8.3)")
    dev = w.device
    g16 = np.asarray(grid, np.float32).reshape(-1)[:16]
    q16, unit, _ = int8_codebook(g16)
    vmax = torch.tensor(float(np.max(g16)), dtype=torch.float32, device=dev)
    alpha_t = torch.tensor(np.asarray(alpha, np.float32), device=dev)
    scale = alpha_t.reshape(-1).expand(w.shape[1]) / vmax
    codes = snap_codes(w.to(torch.float32) / scale[None, :],
                       torch.tensor(g16, device=dev))
    w_i8 = torch.as_tensor(q16, device=dev)[codes.long()]
    unit_t = torch.tensor(np.float32(unit), device=dev)
    return w_i8, scale * unit_t
