"""K2 and K7: causal attention over the INT8 KV cache.

K2, :func:`stacked_int8_kv_attention`, is the counterpart of the
reference's ``kernels/attention.py:stacked_int8_kv_attention`` and reads
layer ``l`` of the flat stacked cache (``kernels/kv_cache.py``); K7,
:func:`int8_kv_attention`, is the counterpart of the reference's
``int8_kv_attention`` and reads one layer's (B, H, S, D) cache (the engine
passes the view ``cache.k[l]``, no copy). Both compute, per (b, h, t):

    s   = (q * f32(1/sqrt(D))) . k_i8 * k_scale + slope * rel
    rel = k_pos - (pos0[b] + t);  s = f32 min where rel > 0
    out = ((exp(s - max) * v_scale) @ v_i8) / sum(exp(s - max))

On a CUDA tensor each wrapper launches its hand-written Hopper kernel
(``csrc/int8_kv_attention.cu``: one launch for any T, decode and prefill
alike; ``csrc/int8_kv_attention_split.cu``: T <= 16, the positions split
across blocks); on a CPU tensor it runs its plain version, which repeats
the reference kernel's arithmetic in plain PyTorch. :func:`attention_oracle`
is the reference's test oracle (it divides by sqrt(D) where the kernels
multiply).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .. import _ext

__all__ = ["stacked_int8_kv_attention", "stacked_int8_kv_attention_plain",
           "int8_kv_attention", "int8_kv_attention_plain",
           "attention_oracle", "COUNTS", "K7_COUNTS", "K7_MAX_T"]

# launches of each CUDA kernel, and calls of its plain version
COUNTS = {"launches": 0, "plain_calls": 0}        # K2
K7_COUNTS = {"launches": 0, "plain_calls": 0}

_SOURCE = "int8_kv_attention.cu"
_SPLIT_SOURCE = "int8_kv_attention_split.cu"
_NEG_BIG = float(np.finfo(np.float32).min)
K7_MAX_T = 16       # K7 serves at most this many queries per call
_SPAN = 512         # K7's positions per block


def _qscale(D: int) -> float:
    return float(np.float32(1.0 / np.sqrt(D)))


def _rel(pos0: torch.Tensor, T: int, S: int) -> torch.Tensor:
    """(B, T, S) int: key position minus query position."""
    dev = pos0.device
    q_pos = pos0.to(torch.int64)[:, None] + torch.arange(T, device=dev)
    return torch.arange(S, device=dev)[None, None, :] - q_pos[:, :, None]


def _attend_plain(q, k, v, k_scale, v_scale, pos0, slopes, out_dtype):
    """The reference kernel's arithmetic on one layer's (B, H, S, D)
    cache, in plain PyTorch."""
    B, H, T, D = q.shape
    S = k.shape[2]
    qs = q.to(torch.float32) * _qscale(D)
    s = torch.matmul(qs, k.to(torch.float32).transpose(-1, -2))
    s = s * k_scale[:, :, None, :]
    rel = _rel(pos0, T, S)[:, None]                          # (B, 1, T, S)
    if slopes is None:
        slopes = torch.zeros(H, dtype=torch.float32, device=q.device)
    s = s + slopes.to(torch.float32)[None, :, None, None] * rel.to(
        torch.float32)
    s = torch.where(rel <= 0, s, torch.full_like(s, _NEG_BIG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    lsum = p.sum(dim=-1, keepdim=True)
    pv = p * v_scale[:, :, None, :]
    o = torch.matmul(pv, v.to(torch.float32))
    return (o / lsum).to(out_dtype)


def stacked_int8_kv_attention_plain(
        l: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        k_scale: torch.Tensor, v_scale: torch.Tensor, pos0: torch.Tensor,
        slopes: Optional[torch.Tensor] = None, *,
        out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of :func:`stacked_int8_kv_attention`."""
    COUNTS["plain_calls"] += 1
    return _attend_plain(q, k[l], v[l], k_scale[l], v_scale[l], pos0, slopes,
                         out_dtype)


def int8_kv_attention_plain(q: torch.Tensor, k_i8: torch.Tensor,
                            v_i8: torch.Tensor, k_scale: torch.Tensor,
                            v_scale: torch.Tensor, pos0: torch.Tensor,
                            slopes: Optional[torch.Tensor] = None, *,
                            out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of :func:`int8_kv_attention`."""
    K7_COUNTS["plain_calls"] += 1
    return _attend_plain(q, k_i8, v_i8, k_scale, v_scale, pos0, slopes,
                         out_dtype)


def _check_tensors(checks, dev):
    for name, t, dt, shape in checks:
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dt} {shape} "
                             f"tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _launch(l, q, k, v, k_scale, v_scale, pos0, slopes, out_dtype):
    B, H, T, D = q.shape
    L, _, _, S, _ = k.shape
    dev = q.device
    if D != 128:
        raise NotImplementedError(
            f"the CUDA kernel is written for head_dim 128, got {D}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype {out_dtype} not supported")
    if slopes is None:
        slopes = torch.zeros(H, dtype=torch.float32, device=dev)
    _check_tensors((("q", q, torch.float32, (B, H, T, D)),
                    ("k", k, torch.int8, (L, B, H, S, D)),
                    ("v", v, torch.int8, (L, B, H, S, D)),
                    ("k_scale", k_scale, torch.float32, (L, B, H, S)),
                    ("v_scale", v_scale, torch.float32, (L, B, H, S)),
                    ("pos0", pos0, torch.int32, (B,)),
                    ("slopes", slopes, torch.float32, (H,))), dev)
    lib = _ext.load(_SOURCE)
    fn = lib.stacked_int8_kv_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    out = torch.empty((B, H, T, D), dtype=out_dtype, device=dev)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
              v_scale.data_ptr(), pos0.data_ptr(), slopes.data_ptr(),
              out.data_ptr(), int(out_dtype == torch.bfloat16), l, B, H, T,
              S, _qscale(D), _ext.stream_ptr(dev))
    _ext.check(lib, code, "stacked_int8_kv_attention")
    COUNTS["launches"] += 1
    return out


def stacked_int8_kv_attention(l: int, q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, k_scale: torch.Tensor,
                              v_scale: torch.Tensor, pos0: torch.Tensor,
                              slopes: Optional[torch.Tensor] = None, *,
                              out_dtype=torch.bfloat16) -> torch.Tensor:
    """Causal attention of q against layer ``l`` of the stacked cache.

    l:                layer index (Python int)
    q:                (B, H, T, D) float; query t sits at pos0[b] + t
    k, v:             (L, B, H, S, D) int8 codes
    k_scale, v_scale: (L, B, H, S) f32 per-position scales
    pos0:             (B,) int32 first query position per sequence
    slopes:           optional (H,) f32 ALiBi slopes
    returns           (B, H, T, D) out_dtype
    """
    if not 0 <= l < k.shape[0]:
        raise IndexError(f"layer {l} outside a cache of {k.shape[0]}")
    if q.is_cuda:
        return _launch(l, q.to(torch.float32).contiguous(), k, v, k_scale,
                       v_scale, pos0, slopes, out_dtype)
    return stacked_int8_kv_attention_plain(l, q, k, v, k_scale, v_scale,
                                           pos0, slopes,
                                           out_dtype=out_dtype)


def _launch_split(q, k, v, k_scale, v_scale, pos0, slopes, out_dtype):
    B, H, T, D = q.shape
    S = k.shape[2]
    dev = q.device
    if D != 128:
        raise NotImplementedError(
            f"the CUDA kernel is written for head_dim 128, got {D}")
    if not 1 <= T <= K7_MAX_T:
        raise ValueError(f"K7 takes 1 to {K7_MAX_T} queries, got {T}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype {out_dtype} not supported")
    if slopes is None:
        slopes = torch.zeros(H, dtype=torch.float32, device=dev)
    _check_tensors((("q", q, torch.float32, (B, H, T, D)),
                    ("k_i8", k, torch.int8, (B, H, S, D)),
                    ("v_i8", v, torch.int8, (B, H, S, D)),
                    ("k_scale", k_scale, torch.float32, (B, H, S)),
                    ("v_scale", v_scale, torch.float32, (B, H, S)),
                    ("pos0", pos0, torch.int32, (B,)),
                    ("slopes", slopes, torch.float32, (H,))), dev)
    lib = _ext.load(_SPLIT_SOURCE)
    fn = lib.int8_kv_attention_split
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    n_split = -(-S // _SPAN)
    # per split: the unnormalized output, and the max and sum of exp
    part_o = torch.empty((B, H, n_split, T, D), dtype=torch.float32,
                         device=dev)
    part_ml = torch.empty((2, B, H, n_split, T), dtype=torch.float32,
                          device=dev)
    out = torch.empty((B, H, T, D), dtype=out_dtype, device=dev)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
              v_scale.data_ptr(), pos0.data_ptr(), slopes.data_ptr(),
              part_o.data_ptr(), part_ml[0].data_ptr(),
              part_ml[1].data_ptr(), out.data_ptr(),
              int(out_dtype == torch.bfloat16), B, H, T, S, _SPAN,
              _qscale(D), _ext.stream_ptr(dev))
    _ext.check(lib, code, "int8_kv_attention_split")
    K7_COUNTS["launches"] += 1
    return out


def int8_kv_attention(q: torch.Tensor, k_i8: torch.Tensor,
                      v_i8: torch.Tensor, k_scale: torch.Tensor,
                      v_scale: torch.Tensor, pos0: torch.Tensor,
                      slopes: Optional[torch.Tensor] = None, *,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """K7: causal attention of up to ``K7_MAX_T`` queries against one
    layer's cache.

    q:                (B, H, T, D) float, T <= 16; query t sits at
                      pos0[b] + t
    k_i8, v_i8:       (B, H, S, D) int8 codes (a layer of the stacked
                      cache: ``cache.k[l]`` is a contiguous view)
    k_scale, v_scale: (B, H, S) f32 per-position scales
    pos0:             (B,) int32 first query position per sequence
    slopes:           optional (H,) f32 ALiBi slopes
    returns           (B, H, T, D) out_dtype
    """
    if q.is_cuda:
        return _launch_split(q.to(torch.float32).contiguous(), k_i8, v_i8,
                             k_scale, v_scale, pos0, slopes, out_dtype)
    return int8_kv_attention_plain(q, k_i8, v_i8, k_scale, v_scale, pos0,
                                   slopes, out_dtype=out_dtype)


def attention_oracle(q, k_i8, v_i8, k_scale, v_scale, pos0, slopes=None):
    """Plain f32 oracle for one layer's (B, H, S, D) cache (tests)."""
    B, H, T, D = q.shape
    S = k_i8.shape[2]
    kf = k_i8.to(torch.float32) * k_scale[..., None]
    vf = v_i8.to(torch.float32) * v_scale[..., None]
    s = torch.einsum("bhtd,bhsd->bhts", q.to(torch.float32), kf)
    s = s / np.sqrt(D)
    pos0 = torch.as_tensor(pos0, dtype=torch.int32,
                           device=q.device).reshape(-1).expand(B)
    rel = _rel(pos0, T, S)[:, None]
    if slopes is not None:
        s = s + slopes[None, :, None, None] * rel.to(torch.float32)
    s = torch.where(rel <= 0, s, torch.full_like(s, _NEG_BIG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", p, vf)
