"""KV-cache storage: INT8 codes, or raw values (the bf16 cache).

Counterpart of the reference's ``kernels/kv_cache.py``. An int8 cache
stores K/V as int8 codes with one f32 scale per (layer, batch, head,
position): symmetric absmax over the head dim, round half to even, clip
to +-127. A cache of any other dtype (the reference's bf16 baseline,
``kv_int8=False``) stores the values themselves, cast to f32 and then to
the cache dtype as the reference casts them; its scales are kept, as
there, but never written or read.

The port's layout is flat and stacked over layers: codes
``(L, B, H, S, D)`` int8, scales ``(L, B, H, S)`` f32. The reference's
lane folding and plane-major scales are TPU layout workarounds; tests
compare the two caches by position. Writes update the cache tensors in
place (the reference returns new arrays), which keeps the cache at one
copy on the card.

On a CUDA cache :func:`append_kv_stacked` is one launch a layer of a
hand-written kernel (``csrc/kv_append.cu``): it quantizes (or casts) every
sequence's new K and V and writes codes and scales at each sequence's
own position, read on the device. On a CPU cache it runs its plain
version, :func:`append_kv_stacked_plain`, the quantize and one indexed
copy per tensor and sequence, which the tests hold to the reference.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .. import _ext
from ..utils.profiling import count, span

__all__ = ["QuantKV", "init_kv", "quantize_kv", "append_kv_stacked",
           "append_kv_stacked_plain", "dequant_kv", "COUNTS",
           "MAX_HEAD_DIM"]

# launches of the CUDA kernel, and calls of its plain version
COUNTS = {"launches": 0, "plain_calls": 0}

_SOURCE = "kv_append.cu"
MAX_HEAD_DIM = 256         # the kernel holds a row in 8 values a lane
# the cache dtypes the kernel writes: int8 codes, or raw values
_OUT_KIND = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}


class QuantKV(NamedTuple):
    k: torch.Tensor        # (L, B, H, S, D) int8 (or raw bf16 / f32)
    v: torch.Tensor        # (L, B, H, S, D) like k
    k_scale: torch.Tensor  # (L, B, H, S) f32
    v_scale: torch.Tensor  # (L, B, H, S) f32


def init_kv(n_layers: int, batch: int, max_len: int, n_heads: int,
            head_dim: int, device: torch.device,
            dtype=torch.int8) -> QuantKV:
    """An empty cache whose k and v are ``dtype``: int8 codes, or the raw
    values of the bf16 (or f32) cache."""
    shape = (n_layers, batch, n_heads, max_len)
    z8 = lambda: torch.zeros(shape + (head_dim,), dtype=dtype,
                             device=device)
    zs = lambda: torch.zeros(shape, dtype=torch.float32, device=device)
    return QuantKV(z8(), z8(), zs(), zs())


def quantize_kv(x: torch.Tensor):
    """(..., D) f32 -> (int8 codes, f32 scale over the last dim); the
    scale is 1.0 where the row is all zeros."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    # divide by a tensor on x's device: CUDA turns a division by a
    # Python scalar into a multiply by its reciprocal, which can move
    # the scale by one ulp
    with span("host.sync"):
        c127 = amax.new_tensor(127.0)
    with span("host.sync"):
        one = amax.new_tensor(1.0)
    scale = torch.where(amax > 0, amax / c127, one)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0].to(torch.float32)


def _write_starts(index, B: int, T: int, S: int):
    """Each sequence's first write position as host ints (None for an
    int shared by the batch); raises on a write past the end of the
    cache."""
    if isinstance(index, int):
        starts, checked = None, [index]
    else:
        starts = [int(i) for i in (index.tolist() if isinstance(
            index, torch.Tensor) else index)]
        if len(starts) != B:
            raise ValueError(f"{len(starts)} write positions for a "
                             f"batch of {B}")
        checked = starts
    for i in checked:
        if i < 0 or i + T > S:
            raise ValueError(f"write of {T} positions at {i} exceeds "
                             f"the cache length {S}")
    return starts


def append_kv_stacked(cache: QuantKV, k: torch.Tensor, v: torch.Tensor,
                      layer: int, index,
                      pos_vec: Optional[torch.Tensor] = None) -> QuantKV:
    """Write new (B, T, H, D) keys/values for one layer, in place, at
    positions ``index .. index+T-1``: ``index`` is an int shared by the
    batch, or per sequence a (B,) int tensor or a sequence of B ints
    (sequence b's rows go to ``index[b] .. index[b]+T-1``). An int8 cache
    takes the quantized codes and scales, any other the raw values. A
    write past the end of the cache raises, before anything is written.
    Returns the same cache.

    On a CUDA cache one launch of ``csrc/kv_append.cu`` writes the layer;
    ``pos_vec``, the same positions as a (B,) int32 tensor on the card
    (``forward`` has it for K2), spares the upload. On a CPU cache the
    plain version runs. ``kv.copies`` counts the writes into the cache:
    1 a launch, or the plain version's indexed copies."""
    with span("kv.append"):
        if not cache.k.is_cuda:
            return append_kv_stacked_plain(cache, k, v, layer, index)
        B, T = k.shape[:2]
        starts = _write_starts(index, B, T, cache.k.shape[3])
        if pos_vec is None:
            if starts is None:
                pos_vec = torch.full((B,), index, dtype=torch.int32,
                                     device=cache.k.device)
            else:
                with span("host.sync"):
                    pos_vec = torch.tensor(starts, dtype=torch.int32,
                                           device=cache.k.device)
        _launch(cache, k, v, layer, pos_vec)
        count("kv.copies", 1)
    return cache


def append_kv_stacked_plain(cache: QuantKV, k: torch.Tensor,
                            v: torch.Tensor, layer: int,
                            index) -> QuantKV:
    """Plain PyTorch version of :func:`append_kv_stacked`: the quantize,
    then per tensor one indexed copy for a shared position or one per
    sequence, counted as ``kv.copies``."""
    COUNTS["plain_calls"] += 1
    B, T = k.shape[:2]
    starts = _write_starts(index, B, T, cache.k.shape[3])
    raw = cache.k.dtype != torch.int8
    for codes, scales, x in ((cache.k, cache.k_scale, k),
                             (cache.v, cache.v_scale, v)):
        x = x.to(torch.float32).transpose(1, 2)
        q, s = (x.to(codes.dtype), None) if raw else quantize_kv(x)
        if starts is None:
            codes[layer, :, :, index:index + T] = q
            if s is not None:
                scales[layer, :, :, index:index + T] = s
            continue
        for b, i in enumerate(starts):
            codes[layer, b, :, i:i + T] = q[b]
            if s is not None:
                scales[layer, b, :, i:i + T] = s[b]
    count("kv.copies", 2 * (1 if raw else 2)
          * (1 if starts is None else B))
    return cache


def _launch(cache: QuantKV, k: torch.Tensor, v: torch.Tensor, layer: int,
            pos_vec: torch.Tensor) -> None:
    """One launch of the kernel on layer ``layer`` of a CUDA cache; k and
    v are read through their strides (no copy). Raises on what the
    kernel does not take."""
    L, B, H, S, D = cache.k.shape
    T = k.shape[1]
    dev = cache.k.device
    if not -L <= layer < L:
        raise IndexError(f"layer {layer} of a cache of {L} layers")
    layer %= L
    if not 1 <= D <= MAX_HEAD_DIM:
        raise NotImplementedError(
            f"the KV append kernel serves head_dim 1 to {MAX_HEAD_DIM}, "
            f"got {D}")
    out_kind = _OUT_KIND.get(cache.k.dtype)
    if out_kind is None:
        raise ValueError(f"no KV append kernel for a {cache.k.dtype} cache")
    for name, x in (("k", k), ("v", v)):
        if (x.device != dev or x.dtype not in (torch.bfloat16, torch.float32)
                or x.dtype != k.dtype or tuple(x.shape) != (B, T, H, D)):
            raise ValueError(f"{name} must be a bf16 or f32 {(B, T, H, D)} "
                             f"tensor on {dev} of k's dtype, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    for name, t, dt, shape in (
            ("k cache", cache.k, cache.k.dtype, cache.k.shape),
            ("v cache", cache.v, cache.k.dtype, cache.k.shape),
            ("k_scale", cache.k_scale, torch.float32, cache.k.shape[:4]),
            ("v_scale", cache.v_scale, torch.float32, cache.k.shape[:4]),
            ("pos_vec", pos_vec, torch.int32, (B,))):
        if (t.device != dev or t.dtype != dt or t.shape != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dt} "
                             f"{tuple(shape)} tensor on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if B * T == 0:
        return
    # layer ``layer`` of each stacked (contiguous) tensor, without a view
    at = lambda t: t.data_ptr() + layer * t.stride(0) * t.element_size()
    scale_ptr = (lambda t: 0) if out_kind else at
    lib = _ext.load(_SOURCE)
    fn = lib.kv_append
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_longlong] * 8 + [ctypes.c_void_p] * 4
                       + [ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    code = fn(k.data_ptr(), v.data_ptr(), int(k.dtype == torch.bfloat16),
              *k.stride(), *v.stride(), at(cache.k), at(cache.v),
              scale_ptr(cache.k_scale), scale_ptr(cache.v_scale), out_kind,
              pos_vec.data_ptr(),
              B, T, H, S, D, _ext.stream_ptr(dev))
    _ext.check(lib, code, "kv_append")
    COUNTS["launches"] += 1


def dequant_kv(cache: QuantKV, dtype=torch.bfloat16):
    """Materialized (k, v) in ``dtype``: codes times their scales."""
    k = cache.k.to(dtype) * cache.k_scale[..., None].to(dtype)
    v = cache.v.to(dtype) * cache.v_scale[..., None].to(dtype)
    return k, v
