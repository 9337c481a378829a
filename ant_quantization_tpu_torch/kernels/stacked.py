"""K1: stacked-layer snap + int8 matmul, the decode-path workhorse.

Counterpart of the reference's ``kernels/stacked.py:stacked_quant_matmul``
in mode "i8" without OVP. The serving engine keeps every site's weights
for all layers in one stack; one call computes, for layer ``l``,

    snap(x / a_scale[l]; a_q[l]) (int8) @ W[l] (int8), int32 accumulation,
    times scales[l] (f32, per output channel)

On a CUDA tensor :func:`stacked_quant_matmul` launches the hand-written
Hopper kernel in ``csrc/stacked_i8.cu`` (which says what bounds it and
how it is laid out); on a CPU tensor it runs
:func:`stacked_quant_matmul_plain`, the plain PyTorch version with the
same arithmetic, which the tests hold against the JAX reference and
``chip_smoke.py`` holds against the kernel, bit for bit.

The port's weight stack is N-major, ``(L, N, K)`` int8, so that one output
column's K weights are contiguous (``convert.py`` transposes the
reference's ``(L, K, N)`` stacks).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _ext
from ..ops.snap import snap_value

__all__ = ["stacked_quant_matmul", "stacked_quant_matmul_plain",
           "int8_matmul", "COUNTS"]

# launches of the CUDA kernel, and calls of the plain version
COUNTS = {"launches": 0, "plain_calls": 0}

_SOURCE = "stacked_i8.cu"


def int8_matmul(a: torch.Tensor, w_nk: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 product ``a (M, K) @ w_nk (N, K).T``.

    A library call (``torch._int_mm``), used outside any kernel: for the
    prefill-size matmuls and the int8 lm_head, as the reference leaves
    those dots to XLA. On CUDA ``_int_mm`` needs M > 16 and K, N multiples
    of 8, so M is padded with zero rows."""
    M = a.shape[0]
    if a.is_cuda and (M <= 16 or M % 8):
        Mp = max(32, -(-M // 8) * 8)
        a = torch.cat([a, a.new_zeros((Mp - M, a.shape[1]))])
    return torch._int_mm(a, w_nk.t())[:M]


def stacked_quant_matmul_plain(l: int, x: torch.Tensor, w: torch.Tensor,
                               scales: torch.Tensor, a_q: torch.Tensor,
                               a_scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`stacked_quant_matmul`."""
    COUNTS["plain_calls"] += 1
    xq = snap_value(x.to(torch.float32) / a_scale[l],
                    a_q[l].to(torch.float32)).to(torch.int8)
    return int8_matmul(xq, w[l]).to(torch.float32) * scales[l]


def _launch(l, x, w, scales, a_q, a_scale):
    L, N, K = w.shape
    M = x.shape[0]
    G = a_q.shape[1]
    dev = x.device
    if K % 16:
        raise ValueError(f"K = {K} must be a multiple of 16")
    if x.ndim != 2 or x.shape[1] != K or M == 0:
        raise ValueError(f"x must be (M, {K}), got {tuple(x.shape)}")
    for name, t, dt in (("x", x, torch.float32), ("w", w, torch.int8),
                        ("scales", scales, torch.float32),
                        ("a_q", a_q, torch.float32),
                        ("a_scale", a_scale, torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
    if scales.shape != (L, N) or a_scale.shape != (L,) or a_q.shape[0] != L:
        raise ValueError("scales (L, N), a_q (L, G), a_scale (L,) expected")
    lib = _ext.load(_SOURCE)
    fn = lib.stacked_i8_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    xq = torch.empty((M, K), dtype=torch.int8, device=dev)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    code = fn(x.data_ptr(), xq.data_ptr(), w.data_ptr(), a_q.data_ptr(),
              a_scale.data_ptr(), scales.data_ptr(), out.data_ptr(),
              l, M, K, N, G, _ext.stream_ptr(dev))
    _ext.check(lib, code, "stacked_i8_matmul")
    COUNTS["launches"] += 1
    return out


def stacked_quant_matmul(l: int, x: torch.Tensor, w: torch.Tensor,
                         scales: torch.Tensor, a_q: torch.Tensor,
                         a_scale: torch.Tensor) -> torch.Tensor:
    """``snap(x / a_scale[l]; a_q[l]) @ W[l].T * scales[l]`` -> (M, N) f32.

    l:       layer index (Python int)
    x:       (M, K) f32 activations (M <= 64 on the serving path)
    w:       (L, N, K) int8 codebook values
    scales:  (L, N) f32, a_scale * per-channel weight scale, folded
    a_q:     (L, G) f32 int8-domain activation codebook, sorted
    a_scale: (L,) f32 activation scale (an IEEE division, not a
             multiply by the reciprocal)
    """
    if not 0 <= l < w.shape[0]:
        raise IndexError(f"layer {l} outside a stack of {w.shape[0]}")
    if x.is_cuda:
        return _launch(l, x.to(torch.float32).contiguous(), w, scales, a_q,
                       a_scale)
    return stacked_quant_matmul_plain(l, x, w, scales, a_q, a_scale)
