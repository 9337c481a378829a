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
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.profiling import count, span

__all__ = ["QuantKV", "init_kv", "quantize_kv", "append_kv_stacked",
           "dequant_kv"]


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


def append_kv_stacked(cache: QuantKV, k: torch.Tensor, v: torch.Tensor,
                      layer: int, index) -> QuantKV:
    """Write new (B, T, H, D) keys/values for one layer, in place, at
    positions ``index .. index+T-1``: ``index`` is an int shared by the
    batch, or per sequence a (B,) int tensor or a sequence of B ints
    (sequence b's rows go to ``index[b] .. index[b]+T-1``). An int8 cache
    takes the quantized codes and scales, any other the raw values. A
    write past the end of the cache raises. Returns the same cache. Counts
    its indexed copies as ``kv.copies``."""
    with span("kv.append"):
        B, T = k.shape[:2]
        S = cache.k.shape[3]
        if isinstance(index, int):
            starts = None
            checked = [index]
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


def dequant_kv(cache: QuantKV, dtype=torch.bfloat16):
    """Materialized (k, v) in ``dtype``: codes times their scales."""
    k = cache.k.to(dtype) * cache.k_scale[..., None].to(dtype)
    v = cache.v.to(dtype) * cache.v_scale[..., None].to(dtype)
    return k, v
