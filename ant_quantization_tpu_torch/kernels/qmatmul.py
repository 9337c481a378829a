"""Weight packing; K8, the packed-4-bit f32 matmul; K9, the fused W8A8
matmul.

Counterpart of the reference's ``kernels/qmatmul.py``:

- the int8-value weight mode ("w4"): ``int8_codebook`` and
  ``quantize_weights_w4_i8`` store the exact int8 *values* of the 4-bit
  codebook entries, so the serving matmul is an int8 x int8 product with
  one f32 scale per output channel;
- the OVP section: the sign-offset int8 encoding of OliVe weights
  (outlier-victim pairs), whose abfloat outliers do not fit an int8
  codebook;
- the packed mode ("w4pack"): ``pack_w4``, ``quantize_weights_w4``,
  ``dequant_w4_reference`` and K8, :func:`quantized_matmul_w4`;
- K9, :func:`fused_w8a8_matmul`: the snap of ``x * (1 / a_scale)`` onto
  an int8-domain codebook and an int8 product against one standalone
  int8 weight (no engine path calls it; the reference keeps it for
  weights outside the layer stacks).

Packed layout. The reference packs a (K, N) code matrix into (K/2, N)
bytes in split-K halves: the byte at (i, n) holds code(i, n) in the low
nibble and code(i + K/2, n) in the high nibble. The port keeps the
split-K halves but stores the bytes N-major, ``(N, K/2)`` per layer and
``(L, N, K/2)`` for a stack, as it stores the int8 stacks ``(L, N, K)``:
one output column's packed bytes are contiguous, which both of its
kernels stream (K6 in ``kernels/stacked.py`` one column per warp, K8 in
column tiles). ``convert.py`` transposes the reference's stacks.

K8 computes ``x (M, K) @ grid[codes] * scale`` with f32 products and
sums: on a CUDA tensor it launches ``csrc/qmatmul_w4.cu`` (bf16 tensor
cores on operands that bf16 holds exactly), on a CPU tensor its plain
version. :func:`w4_term_plan` states each grid as bf16 terms (the grid
itself, its int8 restatement with the unit in the epilogue, or a split
into up to three terms), a bf16 x is one term and an f32 x three, and
:func:`w4_products` lists the term products the kernel issues: those
whose bound can exceed 1/16 of ``K8_RTOL``. The f32 sum order differs
between kernel, plain version and reference, so they agree within
``K8_RTOL`` of each output's sum of term magnitudes, not bit for bit.

K9 launches ``csrc/w8a8_matmul.cu`` on a CUDA tensor and runs its plain
version on a CPU tensor; both are bit-equal to the reference (exact
int32 sums, the same f32 steps). Its weight is N-major ``(N, K)``, as
the port stores every int8 weight (the reference's is ``(K, N)``).

Both serve any K the reference serves (K8 any even K, K9 any K). Where a
kernel needs a K quantum (K8: K/2 a multiple of 16, the 16-byte rows of
its TMA copies; K9: K a multiple of 16, of 64 above 64 rows), the
operands are padded with zeros: x on each call (a copy of x), the weight
once per stack where it is a layer view ``stack[l]``, as the engine
passes it (``_weight_padded`` keeps the padded stack, K_pad / K of the
stack's bytes, as long as the stack lives), any other weight on each
call. K8's x is padded in each split-K half, its
packed bytes with code 0 in both nibbles at the end of each row: a zero
x column times any finite grid value is an exact 0 in every bf16 term.
K9's weight takes zero int8 columns (x's pad snaps to the codebook value
nearest 0, which need not be 0), so the int32 sums are the unpadded
ones.
"""

from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch

from .. import _ext
from ..ops.ovp import apply_ovp
from ..ops.snap import snap_codes, snap_concat

__all__ = ["int8_codebook", "quantize_weights_w4_i8", "OVP_OFFSET",
           "OVP_SHIFT", "ovp_unit", "quantize_weights_ovp_i8",
           "ovp_encode_scalar", "ovp_clip", "ovp_decode_values",
           "pack_w4", "unpack_w4", "quantize_weights_w4",
           "dequant_w4_reference", "tf32_off", "f32_product",
           "f32_out_product", "K8_RTOL", "TERM_BOUND", "bf16_terms",
           "w4_term_plan", "w4_products", "quantized_matmul_w4",
           "quantized_matmul_w4_plain", "int8_matmul", "w8a8_snap",
           "fused_w8a8_matmul", "fused_w8a8_matmul_plain", "w4_padded",
           "w8a8_padded", "K8_COUNTS", "K9_COUNTS"]

# launches of each CUDA kernel, and calls of its plain version
K8_COUNTS = {"launches": 0, "plain_calls": 0}
K9_COUNTS = {"launches": 0, "plain_calls": 0}

_SOURCE = "qmatmul_w4.cu"
_W8A8_SOURCE = "w8a8_matmul.cu"
_W8A8_MAX_G = 16        # the reference's fused path takes <= 4-bit codebooks


def int8_matmul(a: torch.Tensor, w_nk: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 product ``a (M, K) @ w_nk (N, K).T``.

    A library call (``torch._int_mm``), used outside any kernel: for the
    prefill-size matmuls and the int8 lm_head, as the reference leaves
    those dots to XLA. On CUDA ``_int_mm`` needs M > 16 and K, N multiples
    of 8, so M is padded with zero rows and K with zero columns of both
    operands (exact: a zero column adds nothing), and on every device the
    last N % 8 output columns (GPT-2's vocabulary of 50,257 at the head)
    are an f64 product of the same codes, exact (each sum is below
    K 127^2 < 2^53)."""
    M, N, K = a.shape[0], w_nk.shape[0], a.shape[1]
    if a.is_cuda and K % 8:
        pad = -K % 8
        a = torch.cat([a, a.new_zeros((M, pad))], dim=1)
        w_nk = torch.cat([w_nk, w_nk.new_zeros((N, pad))], dim=1)
    if a.is_cuda and (M <= 16 or M % 8):
        Mp = max(32, -(-M // 8) * 8)
        a = torch.cat([a, a.new_zeros((Mp - M, a.shape[1]))])
    n8 = N - N % 8
    out = torch._int_mm(a, w_nk[:n8].t())[:M] if n8 else None
    if n8 == N:
        return out
    tail = (a[:M].to(torch.float64) @ w_nk[n8:].to(torch.float64).t()).to(
        torch.int32)
    return tail if out is None else torch.cat([out, tail], dim=1)


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

    Returns ``(w_i8 (K, N) int8, scale f32)`` with the dequantized weight
    equal to ``w_i8 * scale`` broadcast along ``axis``, the per-channel
    dim: 1 (per output channel, Linear semantics; scale (N,)) or 0 (per
    input channel, GPT-2's Conv1D semantics; scale (K,), which the engine
    keeps as ``kscale``). The engine stores ``w_i8`` transposed, (N, K),
    so a ``kscale`` runs along the LAST axis of the port's weight (along
    K: ``w_i8[l] * kscale[l][None, :]``). The per-channel scale is ``alpha
    / max(grid)``, the SIGNED max (the reference quantizer's convention;
    it differs from the absmax on the asymmetric int grids), times the
    codebook's unit.
    """
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    dev = w.device
    g16 = np.asarray(grid, np.float32).reshape(-1)[:16]
    q16, unit, _ = int8_codebook(g16)
    scale = _channel_scale(w, alpha, float(np.max(g16)), axis)
    codes = snap_codes(w.to(torch.float32) / _along(scale, axis),
                       torch.tensor(g16, device=dev))
    w_i8 = torch.as_tensor(q16, device=dev)[codes.long()]
    unit_t = torch.tensor(np.float32(unit), device=dev)
    return w_i8, scale * unit_t


def _channel_scale(w: torch.Tensor, alpha, vmax: float,
                   axis: int) -> torch.Tensor:
    """alpha / vmax per channel of ``w`` along ``axis``, in f32."""
    alpha_t = torch.tensor(np.asarray(alpha, np.float32), device=w.device)
    vmax_t = torch.tensor(vmax, dtype=torch.float32, device=w.device)
    return alpha_t.reshape(-1).expand(w.shape[axis]) / vmax_t


def _along(scale: torch.Tensor, axis: int) -> torch.Tensor:
    """A per-channel scale broadcast against a (K, N) weight."""
    return scale[None, :] if axis == 1 else scale[:, None]


# OVP: OliVe weights in one int8 stream.
#
# There is a unit u with every normal value an integer multiple of u of
# magnitude <= 64, and every abfloat outlier magnitude of the form
# (64 + 16 m) u with integer 1 <= m <= 63. One int8 byte c then carries
# either kind:
#
#     normal  v:  c = v/u                       (|c| <= OVP_OFFSET)
#     outlier v:  c = sign(v) (OVP_OFFSET + m),  m = (|v|/u - 64)/16
#
# and the decode is linear in two int8 streams:
#
#     v/u = 16 c - 15 clip(c, -64, 64)
#
# so x @ W is two exact int8 dots of one weight stream (K3, the OVP mode
# of kernels/stacked.py).

OVP_OFFSET = 64
OVP_SHIFT = 16


def ovp_unit(grid16, out16) -> tuple[float, bool]:
    """Largest unit u that makes the sign-offset OVP encoding exact:
    normals/u integral with |.| <= OVP_OFFSET, and every outlier
    magnitude |o|/u = 64 + 16 m with integer 1 <= m <= 63. Returns
    (u, exact); u = vmax/127 when no exact unit exists."""
    g = np.asarray(grid16, np.float64).reshape(-1)
    o = np.asarray(out16, np.float64).reshape(-1)
    vmax = float(np.max(np.abs(g)))
    if vmax == 0.0:
        return 1.0, True
    # zero-padded or absent outlier entries are ordinary (zero) values:
    # only magnitudes beyond the normal grid constrain u
    o = o[np.abs(o) > vmax + 1e-9]
    for d in range(1, 128):
        u = vmax / d
        qn = g / u
        ok_n = (np.max(np.abs(qn - np.round(qn))) < 1e-6
                and np.max(np.abs(qn)) <= OVP_OFFSET + 1e-9)
        if not ok_n:
            continue
        if o.size == 0:
            return u, True
        m = (np.abs(o) / u - OVP_OFFSET) / OVP_SHIFT
        if (np.max(np.abs(m - np.round(m))) < 1e-6
                and np.min(m) >= 1 - 1e-9
                and np.max(m) <= 127 - OVP_OFFSET + 1e-9):
            return u, True
    return vmax / 127, False


def ovp_encode_scalar(v: float, u: float, normal_max: float) -> int:
    """Sign-offset byte of ONE integer-domain value: normals at unit u,
    outliers past +-OVP_OFFSET. Used by the weight packer and by the
    engine's activation tables."""
    if abs(v) <= normal_max + 1e-9:
        return int(round(v / u))
    m = int(round((abs(v) / u - OVP_OFFSET) / OVP_SHIFT))
    return int(np.sign(v)) * (OVP_OFFSET + m)


def quantize_weights_ovp_i8(w: torch.Tensor, grid, outliers, alpha,
                            pair_axis: int = 0, axis: int = 1
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """OVP-quantize a (K, N) f32 weight and store it sign-offset encoded.

    Snap onto the grid || outliers concat, zero the victims along
    ``pair_axis`` (0: pairs along K, the Linear sites; 1: along N, GPT-2's
    Conv1D sites), encode. Returns ``(w_enc (K, N) int8, scale f32)`` with
    the dequantized weight equal to ``ovp_decode_values(w_enc) * scale``
    broadcast along ``axis`` (1: scale (N,), per output channel; 0: scale
    (K,), per input channel, kept as ``kscale``, which runs along the
    last axis of the engine's transposed (N, K) weight). The per-channel
    scale is ``alpha / max(grid)`` (the SIGNED max) times the unit. Runs
    on the device of ``w``.
    """
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    dev = w.device
    g16 = np.asarray(grid, np.float32).reshape(-1)[:16]
    o16 = np.asarray(outliers, np.float32).reshape(-1)[:16]
    u, exact = ovp_unit(g16, o16)
    if not exact:
        raise ValueError(
            "no exact sign-offset OVP unit for this grid/outlier pair: "
            "these weights cannot be served losslessly in 'w4'")
    scale = _channel_scale(w, alpha, float(np.max(g16)), axis)
    full = torch.tensor(np.concatenate([g16, o16]), device=dev)
    q, _ = snap_concat(w.to(torch.float32) / _along(scale, axis), full)
    q = apply_ovp(q, pair_axis=pair_axis)          # victims -> 0
    # integer-domain value -> encoded byte, one compare per codebook value
    vals = np.unique(np.concatenate([g16, o16, [0.0]]))
    thr = float(np.max(np.abs(g16)))
    w_enc = torch.zeros(q.shape, dtype=torch.int8, device=dev)
    for v in vals:
        near = ((q - torch.tensor(np.float32(v), device=dev)).abs()
                < torch.tensor(np.float32(1e-5 * max(1, abs(v))),
                               device=dev))
        w_enc = torch.where(near, torch.tensor(
            ovp_encode_scalar(v, u, thr), dtype=torch.int8, device=dev),
            w_enc)
    return w_enc, scale * torch.tensor(np.float32(u), device=dev)


def ovp_clip(c: torch.Tensor) -> torch.Tensor:
    """clip(c, -64, 64) as int8: the second dot's operand."""
    return torch.clamp(c.to(torch.int32), -OVP_OFFSET,
                       OVP_OFFSET).to(torch.int8)


def ovp_decode_values(c: torch.Tensor) -> torch.Tensor:
    """Encoded int8 -> integer-domain values (int32):
    16 c - 15 clip(c, -64, 64)."""
    ci = c.to(torch.int32)
    return OVP_SHIFT * ci - (OVP_SHIFT - 1) * torch.clamp(
        ci, -OVP_OFFSET, OVP_OFFSET)


# Packed 4-bit weights ("w4pack") and K8.

def pack_w4(codes: torch.Tensor) -> torch.Tensor:
    """(K, N) int codes in [0, 16) -> (N, K/2) uint8, split-K packed: the
    byte at (n, i) holds code(i, n) low and code(i + K/2, n) high."""
    K = codes.shape[0]
    if K % 2:
        raise ValueError("K must be even for split-K packing")
    c = codes.t().to(torch.uint8)
    return (c[:, :K // 2] | (c[:, K // 2:] << 4)).contiguous()


def unpack_w4(packed: torch.Tensor) -> torch.Tensor:
    """(..., N, K/2) uint8 -> (..., N, K) int64 codes, in logical K
    order (low nibbles first, then the high ones)."""
    p = packed.to(torch.int64)
    return torch.cat([p & 0xF, p >> 4], dim=-1)


def _decode16(nibbles: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Codes (any shape) -> the f32 values of a 16-entry grid."""
    return grid.to(torch.float32)[nibbles.long()]


def quantize_weights_w4(w: torch.Tensor, grid, alpha
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize a (K, N) f32 weight onto a 16-entry grid with per-output-
    channel alpha. Returns ``(packed (N, K/2) uint8, scale (N,) f32)``:
    scale = alpha / max(grid) (the SIGNED max), codes = snap(w / scale),
    the reference's arithmetic. Runs on the device of ``w``."""
    dev = w.device
    g16 = np.asarray(grid, np.float32).reshape(-1)[:16]
    vmax = torch.tensor(float(np.max(g16)), dtype=torch.float32, device=dev)
    alpha_t = torch.tensor(np.asarray(alpha, np.float32), device=dev)
    scale = alpha_t.reshape(-1).expand(w.shape[1]) / vmax
    codes = snap_codes(w.to(torch.float32) / scale[None, :],
                       torch.tensor(g16, device=dev))
    return pack_w4(codes), scale


def dequant_w4_reference(packed: torch.Tensor, scale: torch.Tensor,
                         grid: torch.Tensor) -> torch.Tensor:
    """Unpack + look up + scale: packed (N, K/2) -> the (K, N) f32 weight
    (the reference's logical layout)."""
    w = _decode16(unpack_w4(packed), grid).t()
    return w * scale.reshape(-1).to(torch.float32).expand(w.shape[1])[None]


@contextlib.contextmanager
def tf32_off():
    """CUDA f32 matrix products and cuDNN f32 convolutions in full f32 (no
    TF32) inside the block; a backward pass run inside it too."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def f32_product(a: torch.Tensor, w_nk: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ w_nk (N, K).T with products and sums in f32, as the
    reference's ``dot(.., preferred_element_type=f32)``: the operands are
    taken to f32 (exact from bf16) and TF32 is held off for the call, so
    the result is never rounded to bf16 or TF32."""
    a, w = a.to(torch.float32), w_nk.to(torch.float32)
    with tf32_off():
        return a @ w.t()


def f32_out_product(a: torch.Tensor, w_nk: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ w_nk (N, K).T as the reference's ``dot(.., preferred_
    element_type=f32)`` on operands of one dtype: products exact, sums and
    the result in f32. On a CUDA device two bf16 operands take cuBLAS's
    bf16 tensor-core product with an f32 output (``torch.mm``'s
    ``out_dtype``), which neither rounds the result to bf16 nor runs as an
    f32 SGEMM at a fifteenth of the rate; everything else takes
    :func:`f32_product`. The two differ only in the order of the f32
    sums."""
    if (a.is_cuda and a.dtype == torch.bfloat16
            and w_nk.dtype == torch.bfloat16):
        return torch.mm(a, w_nk.t(), out_dtype=torch.float32)
    return f32_product(a, w_nk)


# K8's hold: within this share of each output's sum of term magnitudes
# |x| @ |W| of the f32 product (a random-sign sum of K roundings stays near
# 2^-24 of it)
K8_RTOL = 1e-5
# the largest magnitude of term i of bf16_terms, relative to the value:
# hi rounds to 8 significant bits (the rest is at most 2^-8 of the
# value), mid to 8 more (the rest at most 2^-17 of it)
TERM_BOUND = (1.0, 2.0 ** -8, 2.0 ** -17)


def bf16_terms(v: torch.Tensor) -> torch.Tensor:
    """f32 values -> (3, ...) f32 tensors of bf16 values, hi first: each
    the bf16 rounding of what the earlier ones leave (those differences
    are exact in f32). The three terms sum to every f32 value exactly."""
    rest = v.to(torch.float32)
    out = []
    for _ in range(3):
        t = rest.to(torch.bfloat16).to(torch.float32)
        out.append(t)
        rest = rest - t
    return torch.stack(out)


def w4_term_plan(grid16) -> tuple[np.ndarray, float, int]:
    """K8's weight table for one 16-entry grid, decided on the host once
    per grid: ``(terms (3, 16) f32, unit, n)`` with ``sum_j terms[j] *
    unit`` the grid and every value exact in bf16, rows past ``n`` zero.

    1. the grid itself, where bf16 holds every entry (flint, pot, float);
    2. else its int8 restatement ``q16`` (:func:`int8_codebook`), with the
       unit moved into the epilogue (the int grid: 10/7 k);
    3. else the grid split into bf16 terms (:func:`bf16_terms`)."""
    g = np.asarray(grid16, np.float32).reshape(-1)[:16]
    tab = np.zeros((3, 16), np.float32)
    gt = torch.from_numpy(g.copy())
    if torch.equal(gt.to(torch.bfloat16).to(torch.float32), gt):
        tab[0] = g
        return tab + 0.0, 1.0, 1
    q16, unit, exact = int8_codebook(g)
    if exact and np.all(np.abs(q16 * np.float64(unit) - g)
                        <= 2.0 ** -22 * np.abs(g)):
        tab[0] = q16
        return tab + 0.0, float(unit), 1
    tab[:] = bf16_terms(gt).numpy()
    if not np.array_equal(tab.astype(np.float64).sum(0), g.astype(np.float64)):
        raise ValueError(f"grid {g} has no exact three-term bf16 split")
    n = max(j + 1 for j in range(3) if np.any(tab[j] != 0)) \
        if np.any(tab != 0) else 1
    return tab + 0.0, 1.0, n


def w4_products(x_terms: int, w_terms: int = 3) -> list:
    """The (x term, weight term) products K8 issues: those whose bound
    ``TERM_BOUND[i] * TERM_BOUND[j]`` of the output's term-magnitude sum
    exceeds 1/16 of ``K8_RTOL`` (the rest, together at most 2 * 2^-25,
    leave the hold to the f32 sums). A bf16 x against one weight term: 1
    product; an f32 x (three terms) against one: 3; against three: 6."""
    return [(i, j) for i in range(x_terms) for j in range(w_terms)
            if TERM_BOUND[i] * TERM_BOUND[j] > K8_RTOL / 16]


def quantized_matmul_w4_plain(x: torch.Tensor, packed: torch.Tensor,
                              scale: torch.Tensor, grid: torch.Tensor,
                              terms: torch.Tensor = None,
                              unit: torch.Tensor = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`quantized_matmul_w4`: the decoded
    f32 weight, an f32 product, then the scale. It decodes ``grid``
    itself: ``terms`` and ``unit`` are the kernel's operands, taken for a
    like call and not read."""
    K8_COUNTS["plain_calls"] += 1
    w = _decode16(unpack_w4(packed), grid)                    # (N, K)
    return f32_product(x, w) * scale.to(torch.float32)[None, :]


def _weight_padded(w: torch.Tensor, key: tuple, make) -> torch.Tensor:
    """``make(w)``, the padded copy of a weight, made once per layout
    ``key``: where ``w`` is a layer view ``stack[l]`` of a contiguous
    stack (the engine's sites), the stack is padded once
    (``kernels/stacked.py:_padded``, which keeps the copy as long as the
    stack lives) and its layer returned; any other tensor is padded on
    each call."""
    from .stacked import _padded
    base = w._base
    if (base is not None and w.is_contiguous() and base.is_contiguous()
            and tuple(base.shape[1:]) == tuple(w.shape)):
        off = w.storage_offset() - base.storage_offset()
        if off % w.numel() == 0:
            return _padded(base, key, lambda: make(base))[off // w.numel()]
    return make(w)


def w4_padded(x: torch.Tensor, packed: torch.Tensor):
    """x (M, K) and packed (N, K/2) with each half of K padded to a
    multiple of 16, as K8's kernel takes them: x's halves with zero
    columns, the packed rows with zero bytes (code 0 in both nibbles)."""
    h = packed.shape[-1]
    if h % 16 == 0:
        return x, packed
    h_pad = -(-h // 16) * 16
    zx = x.new_zeros((x.shape[0], h_pad - h))
    xp = torch.cat([x[:, :h], zx, x[:, h:], zx], dim=1)
    return xp, _weight_padded(
        packed, ("w4", h_pad),
        lambda w: torch.nn.functional.pad(w, (0, h_pad - h)))


def _launch_w4(x, packed, scale, terms, unit):
    N, K2 = packed.shape
    M, K = x.shape
    dev = x.device
    if K != 2 * K2 or M == 0:
        raise ValueError(f"x (M, {2 * K2}) expected, got x "
                         f"{tuple(x.shape)}, packed {tuple(packed.shape)}")
    x, packed = w4_padded(x, packed)
    K2 = packed.shape[1]
    K = 2 * K2
    for name, t, dt, shape in (("x", x, x.dtype, (M, K)),
                               ("packed", packed, torch.uint8, (N, K2)),
                               ("scale", scale, torch.float32, (N,)),
                               ("terms", terms, torch.float32, (3, 16)),
                               ("unit", unit, torch.float32, (1,))):
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dt} tensor of "
                             f"shape {shape} on {dev}")
    if x.data_ptr() % 16 or packed.data_ptr() % 16:
        raise ValueError("x and packed must be 16-byte aligned")
    x_f32 = x.dtype == torch.float32
    # smallest bound first: the corrections are summed at their own scale
    # before the leading product's sum takes them in
    pairs = w4_products(3 if x_f32 else 1)[::-1]
    lib = _ext.load(_SOURCE)
    fn = lib.w4_bf16_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    xs = (torch.empty((3, M, K), dtype=torch.bfloat16, device=dev)
          if x_f32 else None)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    pa = (ctypes.c_int * len(pairs))(*(a for a, _ in pairs))
    pb = (ctypes.c_int * len(pairs))(*(b for _, b in pairs))
    code = fn(x.data_ptr(), 0 if xs is None else xs.data_ptr(),
              packed.data_ptr(), scale.data_ptr(), terms.data_ptr(),
              unit.data_ptr(), out.data_ptr(), M, K, N, int(x_f32), pa, pb,
              len(pairs), _ext.stream_ptr(dev))
    _ext.check(lib, code, "w4_bf16_matmul")
    K8_COUNTS["launches"] += 1
    return out


def quantized_matmul_w4(x: torch.Tensor, packed: torch.Tensor,
                        scale: torch.Tensor, grid: torch.Tensor,
                        terms: torch.Tensor = None,
                        unit: torch.Tensor = None) -> torch.Tensor:
    """K8: ``x @ dequant(packed) * scale`` -> (M, N) f32.

    x:      (M, K) activations, bf16 (one term on the card, as the engine
            passes them in ``cfg.dtype``) or f32 (three terms); other
            dtypes are taken to f32
    packed: (N, K/2) uint8 split-K packed codes: one layer of the
            engine's (L, N, K/2) stack is the view ``stack[l]``, no copy
            (where K/2 is no multiple of 16 the stack is padded once,
            :func:`w4_padded`)
    scale:  (N,) f32 per-output-channel scale, alpha / max(grid)
    grid:   (16,) f32 integer-domain codebook
    terms, unit: :func:`w4_term_plan` of ``grid`` as (3, 16) and () f32
            tensors (the engine keeps them with the stack); on the card
            without them the plan is made from ``grid``, which reads it
            back to the host
    """
    if x.is_cuda:
        if x.dtype not in (torch.bfloat16, torch.float32):
            x = x.to(torch.float32)
        if terms is None or unit is None:
            tab, u, _ = w4_term_plan(grid.detach().cpu().numpy())
            terms = torch.tensor(tab, device=x.device)
            unit = torch.tensor(np.float32(u), device=x.device)
        return _launch_w4(x.contiguous(), packed,
                          scale.to(torch.float32).contiguous(),
                          terms.to(torch.float32).contiguous(),
                          unit.to(torch.float32).reshape(1).contiguous())
    return quantized_matmul_w4_plain(x, packed, scale, grid)


# K9: the fused W8A8 matmul for a standalone weight.

def w8a8_padded(x: torch.Tensor, w_i8: torch.Tensor):
    """x (M, K) and w_i8 (N, K) padded along K with zeros to K9's quantum
    (16 up to 64 rows, else 64)."""
    K = x.shape[1]
    quantum = 16 if x.shape[0] <= 64 else 64
    k_pad = -(-K // quantum) * quantum
    if k_pad == K:
        return x, w_i8
    pad = lambda t: torch.nn.functional.pad(t, (0, k_pad - K))
    return pad(x), _weight_padded(w_i8, ("w8a8", k_pad), pad)


def w8a8_snap(x: torch.Tensor, a_q: torch.Tensor,
              a_scale: torch.Tensor) -> torch.Tensor:
    """K9's activation codes: ``inv = 1 / a_scale`` (a tensor division,
    as the reference divides once), ``x * inv``, the count of f32
    midpoints at or below it, that entry of a_q as int8."""
    aq = a_q.to(torch.float32).reshape(-1)
    if aq.shape[0] > _W8A8_MAX_G:
        raise ValueError(f"K9 takes at most {_W8A8_MAX_G} codebook "
                         f"entries, got {aq.shape[0]}")
    sc = a_scale.to(torch.float32).reshape(())
    inv = torch.ones_like(sc) / sc
    xs = x.to(torch.float32) * inv
    idx = torch.zeros(xs.shape, dtype=torch.int64, device=xs.device)
    for i in range(aq.shape[0] - 1):
        idx += (xs >= (aq[i] + aq[i + 1]) * 0.5).to(torch.int64)
    return aq[idx].to(torch.int8)


def fused_w8a8_matmul_plain(x: torch.Tensor, w_i8: torch.Tensor,
                            a_q: torch.Tensor, a_scale: torch.Tensor,
                            out_scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_w8a8_matmul`, the reference
    kernel's arithmetic: :func:`w8a8_snap`, an exact int8 product, one
    f32 multiply."""
    K9_COUNTS["plain_calls"] += 1
    acc = int8_matmul(w8a8_snap(x, a_q, a_scale), w_i8)
    return acc.to(torch.float32) * out_scale.to(torch.float32)[None, :]


def _launch_w8a8(x, w_i8, a_q, a_scale, out_scale):
    M, K = x.shape
    N = w_i8.shape[0]
    G = a_q.shape[0]
    dev = x.device
    if M == 0:
        raise ValueError("K9 needs M > 0")
    if G > _W8A8_MAX_G:
        raise ValueError(f"K9 takes at most {_W8A8_MAX_G} codebook "
                         f"entries, got {G}")
    for name, t, dt, shape in (("x", x, torch.float32, (M, K)),
                               ("w_i8", w_i8, torch.int8, (N, K)),
                               ("a_q", a_q, torch.float32, (G,)),
                               ("a_scale", a_scale, torch.float32, (1,)),
                               ("out_scale", out_scale, torch.float32,
                                (N,))):
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dt} tensor of "
                             f"shape {shape} on {dev}")
    x, w_i8 = w8a8_padded(x, w_i8)
    K = x.shape[1]
    if x.data_ptr() % 16 or w_i8.data_ptr() % 16:
        raise ValueError("x and w_i8 must be 16-byte aligned")
    from .stacked import launch_k1_args
    lib = _ext.load(_W8A8_SOURCE)
    fn = lib.w8a8_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    xq = (torch.empty((M, K), dtype=torch.int8, device=dev) if M > 64
          else None)
    ws, count, mt, splits = (launch_k1_args(M, K, N, dev) if M <= 64
                             else (0, 0, 1, 1))
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    code = fn(x.data_ptr(), 0 if xq is None else xq.data_ptr(),
              w_i8.data_ptr(), a_q.data_ptr(), a_scale.data_ptr(),
              out_scale.data_ptr(), out.data_ptr(), ws, count, M, K, N, G,
              mt, splits, _ext.stream_ptr(dev))
    _ext.check(lib, code, "w8a8_matmul")
    K9_COUNTS["launches"] += 1
    return out


def fused_w8a8_matmul(x: torch.Tensor, w_i8: torch.Tensor,
                      a_q: torch.Tensor, a_scale: torch.Tensor,
                      out_scale: torch.Tensor) -> torch.Tensor:
    """K9: ``snap(x * (1 / a_scale); a_q) @ w_i8.T * out_scale`` -> (M, N)
    f32.

    x:         (M, K) activations (taken to f32)
    w_i8:      (N, K) int8 codebook values, N-major (the reference's
               (K, N) weight transposed)
    a_q:       (G <= 16,) sorted int8-domain activation codebook
    a_scale:   scalar activation scale: x is multiplied by its
               reciprocal, unlike K1, which divides
    out_scale: (N,) f32, a_scale times the per-channel weight scale
    """
    if x.is_cuda:
        return _launch_w8a8(x.to(torch.float32).contiguous(), w_i8,
                            a_q.to(torch.float32).reshape(-1).contiguous(),
                            a_scale.to(torch.float32).reshape(1).contiguous(),
                            out_scale.to(torch.float32).contiguous())
    return fused_w8a8_matmul_plain(x, w_i8, a_q, a_scale, out_scale)
