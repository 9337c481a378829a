"""Collective matmuls: the ring all-gather and reduce-scatter fused with
the product, over a tensor-parallel process group.

Counterpart of the reference's ``parallel/collective_matmul.py``, with
its hop order and indexing: in the all-gather ring the activation chunks
travel backward (rank d sends to d - 1) and at step s a rank multiplies
the chunk that started at rank (i + s) mod P; in the reduce-scatter ring
the partial sums travel forward (d to d + 1) and at step s a rank adds
its product for shard (i + P - 1 - s) mod P. Each hop's exchange
(``batch_isend_irecv``) is posted before that hop's product, so the
transfer is in flight while the rank computes.

Weights are in the port's N-major layout: ``w_nk`` (N, K). The f32 rings
take the f32 product with TF32 off (``kernels/qmatmul.py:f32_product``);
the int8 rings (the serving engine's sequence-parallel prefill) carry
int8 codes in the all-gather and exact int32 partial sums in the
reduce-scatter, each hop an int8 x int8 -> int32 library product
(``kernels/qmatmul.py:int8_matmul``), so a plain int8 ring equals the
single-device product bit for bit. OVP operands (sign-offset codes) add
one exact int32 dot per clipped operand, combined in f32 as the
reference combines them; the weight's clip is taken once, outside the
ring, and the ring carries one int8 stream.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..kernels.qmatmul import f32_product, int8_matmul, ovp_clip
from . import comm

__all__ = ["ring_allgather_matmul", "matmul_reducescatter",
           "ring_allgather_matmul_i8", "matmul_reducescatter_i8"]


def _allgather_ring(x_local: torch.Tensor, n_out: int, out_dtype, group,
                    dot) -> torch.Tensor:
    """(M_loc, K) shard -> (P * M_loc, n_out): ``dot`` of every rank's
    chunk, each written at its origin's rows."""
    p, i = dist.get_world_size(group), dist.get_rank(group)
    m = x_local.shape[0]
    out = torch.zeros((p * m, n_out), dtype=out_dtype,
                      device=x_local.device)
    chunk = x_local.contiguous()
    for s in range(p):
        src = (i + s) % p
        pending = None
        if s < p - 1:
            nxt = torch.empty_like(chunk)
            pending = comm.start_exchange([(chunk, (i - 1) % p)],
                                          [(nxt, (i + 1) % p)], group)
        out[src * m:(src + 1) * m] = dot(chunk).to(out_dtype)
        if pending is not None:
            chunk = pending.wait()[0]
    return out


def _reducescatter_ring(x: torch.Tensor, acc_dtype, group,
                        dot) -> torch.Tensor:
    """(M, K_loc) rows -> (M / P, N): this rank's row shard of the sum over
    the group of ``dot(rows)``."""
    p, i = dist.get_world_size(group), dist.get_rank(group)
    m = x.shape[0] // p

    def part(s):
        shard = (i + (p - 1) - s) % p
        return dot(x[shard * m:(shard + 1) * m]).to(acc_dtype)

    first = part(0)
    acc = torch.zeros_like(first) + first
    for s in range(1, p):
        buf = torch.empty_like(acc)
        pending = comm.start_exchange([(acc, (i + 1) % p)],
                                      [(buf, (i - 1) % p)], group)
        mine = part(s)
        acc = pending.wait()[0] + mine
    return acc


def ring_allgather_matmul(x_local: torch.Tensor, w_nk: torch.Tensor,
                          group) -> torch.Tensor:
    """(gathered x) @ w without materializing the gather. x_local (M_loc,
    K): this rank's shard of a (P * M_loc, K) activation; w_nk (N_loc, K):
    this rank's columns. Returns (P * M_loc, N_loc) in x's dtype."""
    return _allgather_ring(x_local, w_nk.shape[0], x_local.dtype, group,
                           lambda c: f32_product(c, w_nk))


def matmul_reducescatter(x: torch.Tensor, w_local_nk: torch.Tensor,
                         group) -> torch.Tensor:
    """Row-parallel product with the sum fused into a ring reduce-scatter.
    x (M, K_loc): full rows, this rank's K slice; w_local_nk (N, K_loc).
    Returns (M / P, N) f32: this rank's M shard of the summed product."""
    return _reducescatter_ring(x, torch.float32, group,
                               lambda rows: f32_product(rows, w_local_nk))


def _ovp_local_dot(chunk: torch.Tensor, w: torch.Tensor,
                   w_clip: Optional[torch.Tensor],
                   a_ovp: bool) -> torch.Tensor:
    """One hop's product with the OVP decode folded in. Sign-offset codes
    decode linearly, value(c) = 16 c - 15 clip(c), so an OVP operand costs
    one more int8 dot. Plain x plain is the int32 dot; any OVP form the
    f32 combine, in the reference's order."""
    d = lambda a, b: int8_matmul(a, b).to(torch.float32)
    if not a_ovp and w_clip is None:
        return int8_matmul(chunk, w)
    if not a_ovp:
        return 16.0 * d(chunk, w) - 15.0 * d(chunk, w_clip)
    px = ovp_clip(chunk)
    if w_clip is None:
        return 16.0 * d(chunk, w) - 15.0 * d(px, w)
    return (256.0 * d(chunk, w) - 240.0 * d(chunk, w_clip)
            - 240.0 * d(px, w) + 225.0 * d(px, w_clip))


def ring_allgather_matmul_i8(xq_local: torch.Tensor, w_i8: torch.Tensor,
                             group, w_ovp: bool = False,
                             a_ovp: bool = False) -> torch.Tensor:
    """Quantized column-parallel ring: int8 codes travel the ring.

    xq_local (M_loc, K) int8: this rank's activation shard, snapped to the
    per-tensor int8 codebook domain (every rank snaps alike), or
    sign-offset codes with ``a_ovp``; w_i8 (N_loc, K) int8 codebook
    values, or sign-offset OVP codes with ``w_ovp``. Returns (P * M_loc,
    N_loc): int32 for plain operands, f32 for any OVP form. Every output
    block is one full-K product, so the result equals the single-device
    product bit for bit."""
    w_clip = ovp_clip(w_i8) if w_ovp else None
    out_dtype = torch.float32 if (w_ovp or a_ovp) else torch.int32
    return _allgather_ring(
        xq_local, w_i8.shape[0], out_dtype, group,
        lambda c: _ovp_local_dot(c, w_i8, w_clip, a_ovp))


def matmul_reducescatter_i8(xq: torch.Tensor, w_i8_local: torch.Tensor,
                            group, w_ovp: bool = False,
                            a_ovp: bool = False) -> torch.Tensor:
    """Quantized row-parallel ring: partial sums travel the ring.

    xq (M, K_loc) int8: full rows of this rank's K slice (sign-offset
    codes with ``a_ovp``); w_i8_local (N, K_loc). Returns (M / P, N):
    this rank's M shard of the summed product, int32 (exact: no order
    effects) for plain operands, f32 for OVP forms (the per-hop combine
    rides the ring)."""
    w_clip = ovp_clip(w_i8_local) if w_ovp else None
    acc_dtype = torch.float32 if (w_ovp or a_ovp) else torch.int32
    return _reducescatter_ring(
        xq, acc_dtype, group,
        lambda rows: _ovp_local_dot(rows, w_i8_local, w_clip, a_ovp))
