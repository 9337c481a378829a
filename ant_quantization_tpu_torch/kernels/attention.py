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

On a CUDA tensor each wrapper makes one launch of a hand-written Hopper
kernel on the layer (K2: the view ``k[l]`` of its stack, no copy): up to
``K7_MAX_T`` queries the split pass (``csrc/int8_kv_attention_split.cu``
on ``csrc/kv_split.cuh``: the positions split across blocks), above it
the prefill kernel (``csrc/int8_kv_attention.cu``: the products on the
bf16 tensor cores). Both serve every head_dim from 1 to
``MAX_HEAD_DIM`` (256): the kernels are built for the widths of
``KERNEL_WIDTHS`` and a head_dim D runs at the smallest of them at or
above D, with zeros past D (:func:`kernel_width`); a larger head_dim
raises ``NotImplementedError`` on the card. On a CPU tensor each runs its
plain version, which repeats the reference kernel's arithmetic in plain
PyTorch. :func:`attention_oracle` is the reference's
test oracle (it divides by sqrt(D) where the kernels multiply).
:func:`stacked_int8_kv_attention_hilo` repeats the tensor-core arithmetic
of K2's prefill regime (each f32 operand as three bf16 terms) on the CPU,
for the tests.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .. import _ext
from ..utils.profiling import span

__all__ = ["stacked_int8_kv_attention", "stacked_int8_kv_attention_plain",
           "int8_kv_attention", "int8_kv_attention_plain",
           "attention_oracle", "stacked_int8_kv_attention_hilo",
           "split_ranges", "kernel_width", "COUNTS", "K7_COUNTS", "K7_MAX_T",
           "KERNEL_WIDTHS", "MAX_HEAD_DIM"]

# launches of each CUDA kernel, and calls of its plain version
COUNTS = {"launches": 0, "plain_calls": 0}        # K2
K7_COUNTS = {"launches": 0, "plain_calls": 0}

_SOURCE = "int8_kv_attention.cu"
_SPLIT_SOURCE = "int8_kv_attention_split.cu"
_NEG_BIG = float(np.finfo(np.float32).min)
K7_MAX_T = 16       # K2 and K7 split the positions at this T and
                    # below; above it both take the prefill kernel
_KT = 64            # key positions per tile of the kernels
_SPAN_MAX = 512     # positions per split block, at most
_SPLIT_BLOCKS = 16 * 132   # split blocks to aim for: 16 per H100 SM
# the widths the CUDA kernels are built for: KV_WIDTHS of csrc/kv_split.cuh
KERNEL_WIDTHS = (16, 32, 64, 80, 96, 128, 256)
# the largest head_dim served: one head's K and V tiles of 64 positions,
# widened to bf16, and the 64 queries of a prefill block in three bf16
# terms fit the 227 KB of shared memory at width 256 (about 197 KB)
MAX_HEAD_DIM = KERNEL_WIDTHS[-1]


def kernel_width(D: int) -> int:
    """The width the CUDA kernels serve head_dim ``D`` at: the smallest of
    ``KERNEL_WIDTHS`` at or above it (q and the tiles are zero past D)."""
    return next(w for w in KERNEL_WIDTHS if w >= D)


def _qscale(D: int) -> float:
    return float(np.float32(1.0 / np.sqrt(D)))


def _span(B: int, H: int, S: int) -> int:
    """Positions per split block for a (B, H, S) cache: enough splits
    that B * H * splits fills the SMs several times, in whole tiles of
    64, between 64 and 512 (at B * H = 128: 64 at S = 608, 128 at 2048,
    512 from 8,192 on)."""
    span = -(-S * B * H // _SPLIT_BLOCKS)
    return min(_SPAN_MAX, max(_KT, -(-span // _KT) * _KT))


def split_ranges(p0: int, T: int, S: int, span: int) -> list:
    """The [begin, end) positions that each split block reads for a
    sequence at pos0 ``p0``, as the split pass computes them: splits
    past the last visible position ``p0 + T - 1`` exit without reading."""
    kmax = min(p0 + T - 1, S - 1)
    return [(b, min(b + span, kmax + 1))
            for b in range(0, -(-S // span) * span, span) if b <= kmax]


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


def _kernel_q(q: torch.Tensor) -> torch.Tensor:
    """q as the kernels read it: bf16 as it is (they convert exactly),
    anything else as f32; contiguous."""
    if q.dtype != torch.bfloat16:
        q = q.to(torch.float32)
    return q.contiguous()


def _checked_operands(q, k, v, k_scale, v_scale, pos0, slopes, out_dtype,
                      cache_shape):
    """Check the operands of either kernel; returns the slopes' device
    pointer, 0 when there are none (the kernels then add no ALiBi term)."""
    B, H, T, D = q.shape
    dev = q.device
    if not 1 <= D <= MAX_HEAD_DIM:
        raise NotImplementedError(
            f"the CUDA kernels serve head_dim 1 to {MAX_HEAD_DIM}, got {D}: "
            "one head's tiles must fit in shared memory (ROADMAP Queue 3, "
            "the deliberate limit)")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype {out_dtype} not supported")
    checks = [("q", q, q.dtype, (B, H, T, D)),
              ("k", k, torch.int8, cache_shape + (D,)),
              ("v", v, torch.int8, cache_shape + (D,)),
              ("k_scale", k_scale, torch.float32, cache_shape),
              ("v_scale", v_scale, torch.float32, cache_shape),
              ("pos0", pos0, torch.int32, (B,))]
    if slopes is not None:
        checks.append(("slopes", slopes, torch.float32, (H,)))
    _check_tensors(checks, dev)
    return 0 if slopes is None else slopes.data_ptr()


def _split_scratch(B, H, T, S, D, dev):
    """The split pass's span and its scratch: per split the unnormalized
    output, and the max and sum of exp."""
    span = _span(B, H, S)
    n_split = -(-S // span)
    part_o = torch.empty((B, H, n_split, T, D), dtype=torch.float32,
                         device=dev)
    part_ml = torch.empty((2, B, H, n_split, T), dtype=torch.float32,
                          device=dev)
    return span, part_o, part_ml


def _entry(lib, name: str, n_scratch: int):
    """A C entry point taking (q, q_bf16, the cache, pos0 and slopes
    pointers, ``n_scratch`` scratch pointers, out, out_bf16, B, H, T, S, D,
    then for the split pass its span, qscale, stream)."""
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_void_p] * (6 + n_scratch)
                       + [ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_int] * (5 + (n_scratch > 0))
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, k_scale, v_scale, pos0, slopes, out_dtype, counts):
    """One launch on one layer's (B, H, S, D) cache (a view of K2's
    stack, or K7's layer): the split pass up to ``K7_MAX_T`` queries, the
    prefill kernel above; counted in ``counts``."""
    B, H, T, D = q.shape
    S = k.shape[2]
    dev = q.device
    if T < 1:
        raise ValueError(f"at least one query expected, got {T}")
    slopes_ptr = _checked_operands(q, k, v, k_scale, v_scale, pos0, slopes,
                                   out_dtype, (B, H, S))
    out = torch.empty((B, H, T, D), dtype=out_dtype, device=dev)
    head = (q.data_ptr(), int(q.dtype == torch.bfloat16), k.data_ptr(),
            v.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
            pos0.data_ptr(), slopes_ptr)
    tail = (out.data_ptr(), int(out_dtype == torch.bfloat16), B, H, T, S, D)
    if T <= K7_MAX_T:
        name, lib = "int8_kv_attention_split", _ext.load(_SPLIT_SOURCE)
        span, part_o, part_ml = _split_scratch(B, H, T, S, D, dev)
        code = _entry(lib, name, 3)(
            *head, part_o.data_ptr(), part_ml[0].data_ptr(),
            part_ml[1].data_ptr(), *tail, span, _qscale(D),
            _ext.stream_ptr(dev))
    else:
        name, lib = "int8_kv_attention_prefill", _ext.load(_SOURCE)
        code = _entry(lib, name, 0)(*head, *tail, _qscale(D),
                                    _ext.stream_ptr(dev))
    _ext.check(lib, code, name)
    counts["launches"] += 1
    return out


def stacked_int8_kv_attention(l: int, q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, k_scale: torch.Tensor,
                              v_scale: torch.Tensor, pos0: torch.Tensor,
                              slopes: Optional[torch.Tensor] = None, *,
                              out_dtype=torch.bfloat16) -> torch.Tensor:
    """Causal attention of q against layer ``l`` of the stacked cache.

    l:                layer index (Python int)
    q:                (B, H, T, D) float, D <= ``MAX_HEAD_DIM`` on the
                      card; query t sits at pos0[b] + t
    k, v:             (L, B, H, S, D) int8 codes (the port's flat cache)
    k_scale, v_scale: (L, B, H, S) f32 per-position scales
    pos0:             (B,) int32 first query position per sequence
    slopes:           optional (H,) f32 ALiBi slopes
    returns           (B, H, T, D) out_dtype
    """
    with span("kernel.launch"):
        if not 0 <= l < k.shape[0]:
            raise IndexError(f"layer {l} outside a cache of {k.shape[0]}")
        if q.is_cuda:
            return _launch(_kernel_q(q), k[l], v[l], k_scale[l], v_scale[l],
                           pos0, slopes, out_dtype, COUNTS)
        return stacked_int8_kv_attention_plain(l, q, k, v, k_scale, v_scale,
                                               pos0, slopes,
                                               out_dtype=out_dtype)


def int8_kv_attention(q: torch.Tensor, k_i8: torch.Tensor,
                      v_i8: torch.Tensor, k_scale: torch.Tensor,
                      v_scale: torch.Tensor, pos0: torch.Tensor,
                      slopes: Optional[torch.Tensor] = None, *,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """K7: causal attention of T queries against one layer's cache (the
    reference's engine sends it at most ``K7_MAX_T``; more take the
    prefill kernel on the layer, one launch all the same).

    q:                (B, H, T, D) float, D <= ``MAX_HEAD_DIM`` on the
                      card; query t sits at pos0[b] + t
    k_i8, v_i8:       (B, H, S, D) int8 codes (a layer of the stacked
                      cache: ``cache.k[l]`` is a contiguous view)
    k_scale, v_scale: (B, H, S) f32 per-position scales
    pos0:             (B,) int32 first query position per sequence
    slopes:           optional (H,) f32 ALiBi slopes
    returns           (B, H, T, D) out_dtype
    """
    with span("kernel.launch"):
        if q.is_cuda:
            return _launch(_kernel_q(q), k_i8, v_i8, k_scale, v_scale, pos0,
                           slopes, out_dtype, K7_COUNTS)
        return int8_kv_attention_plain(q, k_i8, v_i8, k_scale, v_scale,
                                       pos0, slopes, out_dtype=out_dtype)


def _bf16_parts(x: torch.Tensor, parts: int) -> list:
    """f32 x as ``parts`` bf16 terms, largest first, each back in f32:
    hi = bf16(x), then bf16 of what is left. Three parts hold every f32
    value exactly (8 + 8 + 8 significant bits)."""
    out = []
    for _ in range(parts):
        term = x.to(torch.bfloat16).to(torch.float32)
        out.append(term)
        x = x - term
    return out


def stacked_int8_kv_attention_hilo(
        l: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        k_scale: torch.Tensor, v_scale: torch.Tensor, pos0: torch.Tensor,
        slopes: Optional[torch.Tensor] = None, *, parts: int = 3,
        out_dtype=torch.float32) -> torch.Tensor:
    """The arithmetic of K2's prefill regime in plain PyTorch (tests only):
    qs = f32(q) * qscale and p * v_scale each split into ``parts`` bf16
    terms (the kernel takes 3) against the exact int8 codes, f32 sums, an
    online softmax over key tiles of 64 taken in order, with the rescale
    of the running output and sum; at the kernel's width (q, k and v
    zero past D, qscale of D itself, the columns past D dropped)."""
    B, H, T, D = q.shape
    S = k.shape[3]
    pad = kernel_width(D) - D
    widen = lambda a: torch.nn.functional.pad(a, (0, pad))
    qp = _bf16_parts(widen(q.to(torch.float32)) * _qscale(D), parts)
    kf, vf = widen(k[l].to(torch.float32)), widen(v[l].to(torch.float32))
    rel = _rel(pos0, T, S)[:, None]                          # (B, 1, T, S)
    if slopes is None:
        slopes = torch.zeros(H, dtype=torch.float32, device=q.device)
    alibi = slopes.to(torch.float32)[None, :, None, None] * rel.to(
        torch.float32)
    m = torch.full((B, H, T, 1), -float("inf"), device=q.device)
    lsum = torch.zeros((B, H, T, 1), device=q.device)
    o = torch.zeros((B, H, T, D + pad), device=q.device)
    kmax = min(int(pos0.max()) + T - 1, S - 1)
    for k0 in range(0, kmax + 1, _KT):
        sl = slice(k0, min(k0 + _KT, S))
        kt = kf[:, :, sl].transpose(-1, -2)
        s = sum(torch.matmul(a, kt) for a in qp)
        s = s * k_scale[l][:, :, None, sl] + alibi[..., sl]
        s = torch.where(rel[..., sl] <= 0, s, torch.full_like(s, _NEG_BIG))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        lsum = lsum * corr + p.sum(dim=-1, keepdim=True)
        pv = _bf16_parts(p * v_scale[l][:, :, None, sl], parts)
        o = o * corr + sum(torch.matmul(a, vf[:, :, sl]) for a in pv)
        m = m_new
    return (o[..., :D] / lsum).to(out_dtype)


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
