"""Stacked-layer quantized matmuls, the decode-path workhorses.

Counterparts of the reference's ``kernels/stacked.py``. The serving
engine keeps every site's weights for all layers in one stack; one call
computes one layer ``l``:

- K1, :func:`stacked_quant_matmul` (``ovp=False``): snap(x / a_scale[l];
  a_q[l]) (int8) @ W[l] (int8 codebook values), int32 accumulation,
  times scales[l] (f32, per output channel).
- K3, :func:`stacked_quant_matmul` with ``ovp=True``: the same snap
  against sign-offset OVP weight bytes c (``kernels/qmatmul.py``),
  decoded exactly as 16 x@c - 15 x@clip(c, +-64). As in the reference,
  that int32 value is formed per 256-row sub-chunk, converted to f32,
  summed in order within each K block of ``_fit(K, block_k)`` rows, and
  the blocks are summed in order into an f32 accumulator.
- K4, :func:`stacked_quant_matmul_aovp`: full OliVe. x / prescale[l] is
  snapped onto the (unsorted) grid || outlier concat by 31 midpoints
  with tie flags, looked up to its sign-offset byte cx, the OVP victims
  along K are zeroed, and px = clip(cx, +-64). Per K block, the int32
  dots d1 = cx@w, d2 = cx@pw, d3 = px@w, d4 = px@pw (pw = clip(w, +-64))
  are combined in f32 as ((256 d1 - 240 d2) - 240 d3) + 225 d4, or
  16 d1 - 15 d3 for int8-value weights, summed block by block, times
  scales[l].

- K5, :func:`stacked_quant_matmul` at M > 256 (the reference's
  ``_prefill_i8``): K1 or K3 for prefill-size M, on the int8 tensor
  cores (wgmma in both modes; OVP bytes with the weight tile as the
  register-held operand, laid out by :func:`k5_ovp_plan`), with the same
  numbers (the reference holds its M-blocked kernel
  bit-identical to the decode kernel, so K5's plain version is K1's or
  K3's). As in the reference, 64 < M <= 256 stays on K1/K3.
- K6, :func:`stacked_quant_matmul_p4`: the packed 4-bit weights of
  "w4pack" (``kernels/qmatmul.py``: split-K nibbles, (L, N, K/2) uint8).
  Each nibble decodes to int8 as ``code - 8`` (``affine``) or through
  the layer's 16-entry int8 table q16[l]; the low nibble of byte i pairs
  with snap(x)[:, i], the high one with snap(x)[:, i + K/2]. int32
  accumulation, times scales[l].

``block_k`` therefore sets the f32 partition of K3 and K4, and is part
of their numbers (``EngineConfig.stacked_block_k``).

On a CUDA tensor each wrapper launches its hand-written Hopper kernel
(``csrc/stacked_i8.cu`` for K1, on the staged split-K weight stream of
``csrc/i8_stream.cuh`` laid out by :func:`k1_plan`, and K3,
``csrc/stacked_aovp.cu`` for K4, both on that stream in
``csrc/ovp_stream.cuh`` laid out by :func:`k34_plan`,
``csrc/stacked_prefill.cu`` for K5, ``csrc/stacked_p4.cu`` for K6 on K1's
stream with a nibble decode, laid out by :func:`k6_plan`; each source
says what bounds it and how it is laid out); on a CPU tensor
it runs its plain PyTorch version, which has the same arithmetic in the
same order and which the tests hold against the JAX reference and
``chip_smoke.py`` holds against the kernel, bit for bit.

The port's weight stack is N-major, ``(L, N, K)`` int8, so that one output
column's K weights are contiguous (``convert.py`` transposes the
reference's ``(L, K, N)`` stacks).

Any K is served, as the reference's kernels fit any K. Where a kernel
needs a K quantum (K1 16, K5 64, K6 16 bytes of each packed half) or
equal f32 segments of whole stages (K3, K4, K5's OVP mode: ``_fit(K,
block_k)``-row blocks cut into sub-chunks of at most 256 rows, K4 one
per block; the last sub-chunk of a block may be shorter), the operands
are padded with zeros: x per call, the weight stack once per layout,
cached beside the stack (``_padded``). A zero weight column adds nothing
to an int32 sum, whatever x's pad snaps to, so the numbers are those of
the unpadded product. OVP segments are padded each to one length in
place (:func:`ovp_layout`), so every segment's int32 dot and the f32
order of the blocks stay the reference's, and OVP pairs (2i, 2i + 1)
stay whole (segments start at even offsets). The plain versions of K3
and K4 take the same layout; presets (K a multiple of 64, blocks of 1024
rows) need none.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.utils.weak import WeakIdKeyDictionary

from .. import _ext
from ..ops.ovp import victim_mask
from ..ops.snap import snap_value
from .qmatmul import OVP_OFFSET, int8_matmul, ovp_clip, unpack_w4

__all__ = ["stacked_quant_matmul", "stacked_quant_matmul_plain",
           "stacked_quant_matmul_aovp", "stacked_quant_matmul_aovp_plain",
           "stacked_quant_matmul_p4", "stacked_quant_matmul_p4_plain",
           "int8_matmul", "COUNTS", "K3_COUNTS", "K4_COUNTS", "K5_COUNTS",
           "K6_COUNTS", "PREFILL_M", "prefill_snap", "k1_plan", "k6_plan",
           "k34_plan", "k5_ovp_plan", "split_workspace"]

# launches of each CUDA kernel, and calls of its plain version (K5 counts
# both of its modes, int8 values and OVP)
COUNTS = {"launches": 0, "plain_calls": 0}        # K1
K3_COUNTS = {"launches": 0, "plain_calls": 0}
K4_COUNTS = {"launches": 0, "plain_calls": 0}
K5_COUNTS = {"launches": 0, "plain_calls": 0}
K6_COUNTS = {"launches": 0, "plain_calls": 0}

_SOURCE = "stacked_i8.cu"
_AOVP_SOURCE = "stacked_aovp.cu"
_PREFILL_SOURCE = "stacked_prefill.cu"
_P4_SOURCE = "stacked_p4.cu"
_SUB = 256          # K3's int32 sub-chunk rows (the reference's `sub`)
PREFILL_M = 256     # larger M takes K5 (the reference's M-blocked route)
_K5_BK = 64         # K5's K tile: K and the OVP segments are multiples
# K5's OVP product (csrc/ovp_wgmma.cuh): weight columns and x rows per
# block, TMA stages in flight
K5_WN, K5_XM, K5_STAGES = 128, 128, 4
# K1's weight stream (csrc/i8_stream.cuh): output columns per block, K
# bytes per stage, stages in flight, threads per block, the SMs to fill,
# and the tile counters at the head of the split-K workspace
K1_COLS, K1_STEP, K1_STAGES, K1_THREADS, K1_SMS = 128, 128, 4, 256, 132
K1_COUNTERS = 1 << 16
K1_MT = (1, 2, 4, 8, 16)        # x rows per block
K34_MT = (1, 2, 4, 8)           # K3's and K4's
K34_XROW = K1_STEP + 16         # their shared code rows, bytes


def _stream_grid(M: int, K: int, N: int, mts: tuple) -> dict:
    """The grid of K1's weight stream (also K3's and K4's): ``mt`` x rows
    per block (the smallest of ``mts`` that covers M, else the largest,
    then M tiles of it) and ``splits`` K ranges of whole ``K1_STEP``-byte
    stages, as many as keep the grid within one wave of two blocks per
    SM, never more than there are stages."""
    mt = next((t for t in mts if t >= M), mts[-1])
    m_tiles, n_tiles = -(-M // mt), -(-N // K1_COLS)
    steps = -(-K // K1_STEP)
    splits = min(steps, max(1, 2 * K1_SMS // (m_tiles * n_tiles)))
    return {"mt": mt, "m_tiles": m_tiles, "n_tiles": n_tiles,
            "steps": steps, "splits": splits,
            "blocks": m_tiles * n_tiles * splits}


def k1_plan(M: int, K: int, N: int) -> dict:
    """K1's launch plan at (M, K, N), M <= 256: :func:`_stream_grid` over
    ``K1_MT``. ``smem`` is a block's shared memory as the kernel counts
    it: the stage ring, the other half-column's int32 sums, and two
    stages' x codes."""
    p = _stream_grid(M, K, N, K1_MT)
    tpc = K1_THREADS // K1_COLS
    p["smem"] = (1024 + K1_STAGES * (K1_COLS * K1_STEP + 8) + 2 * 16 * 4
                 + (tpc - 1) * p["mt"] * K1_COLS * 4 + 2 * p["mt"] * K1_STEP)
    return p


def k6_plan(M: int, K: int, N: int) -> dict:
    """K6's launch plan at (M, K, N), any M: K1's stream
    (:func:`_stream_grid` over ``K1_MT``, so M above 16 runs in M tiles)
    over the K/2 packed bytes of each column. ``smem``: K1's block, but a
    stage pairs with two x ranges, each kept as whole eight-row tiles of
    the mma's B in rows of ``K34_XROW`` bytes (``codes`` per buffer)."""
    p = _stream_grid(M, K // 2, N, K1_MT)
    p["codes"] = 2 * -(-p["mt"] // 8) * 8 * K34_XROW
    p["smem"] = (1024 + K1_STAGES * (K1_COLS * K1_STEP + 8) + 2 * 16 * 4
                 + p["mt"] * K1_COLS * 4 + 2 * p["codes"])
    return p


def k34_plan(M: int, K: int, N: int, seg: int, fold: int, aovp: bool,
             w_ovp: bool = True) -> dict:
    """K3's (``aovp`` False) or K4's launch plan on K1's stream
    (``csrc/ovp_stream.cuh``), for segments of ``seg`` rows in f32 blocks
    of ``fold`` segments (``ovp_layout``; K4: one). A segment is
    ``ss`` whole stages (``seg`` is a multiple of ``K1_STEP`` or all of
    K). The grid is :func:`_stream_grid`'s over ``K34_MT``, but K is split
    only between f32 blocks, ``units`` of them: every segment's int32 dots
    stay whole in one block, which forms its blocks' f32 sums in order, and
    the tile's last split chains them (``ws`` f32 between the splits).
    ``smem``: the stage ring, the tables, and two stages' x codes (K4: cx
    and px), rows of ``K34_XROW`` bytes, eight or sixteen (the mma's B
    columns)."""
    if K % (seg * fold) or (seg % K1_STEP and seg != K):
        raise ValueError(f"f32 blocks of {fold} x {seg} rows do not cut "
                         f"K = {K} into whole {K1_STEP}-byte stages")
    p = _stream_grid(M, K, N, K34_MT)
    ss = -(-seg // K1_STEP)
    units = p["steps"] // (ss * fold)
    splits = min(units, p["splits"])
    rows = -(-(2 if aovp else 1) * p["mt"] // 8) * 8
    p.update(splits=splits, blocks=p["m_tiles"] * p["n_tiles"] * splits,
             ss=ss, units=units, ws=units * M * N if splits > 1 else 0,
             smem=1024 + K1_STAGES * (K1_COLS * K1_STEP + 8) + 3 * 32 * 4
             + 2 * rows * K34_XROW)
    return p


_SPLIT_WS: dict = {}


def split_workspace(dev: torch.device, n: int) -> torch.Tensor:
    """The split-K workspace of K1, K3 and K4 on ``dev``: ``K1_COUNTERS``
    tile counters, zero, then room for ``n`` 4-byte partials (K1's int32
    sums, K3's and K4's f32 block sums). The kernels overwrite the
    partials and leave the counters zero, so one buffer serves every call
    on the device (one stream at a time); it is made outside CUDA graph
    captures, as their warm-up calls do."""
    n += K1_COUNTERS
    ws = _SPLIT_WS.get(dev)
    if ws is None or ws.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the split-K workspace grows inside a CUDA "
                               "graph capture; call once before capturing")
        ws = torch.zeros(max(n, 1 << 20), dtype=torch.int32, device=dev)
        _SPLIT_WS[dev] = ws
    return ws


def _split_args(plan: dict, n: int, dev: torch.device) -> tuple:
    """(partials pointer, counters pointer) for one launch on the stream
    with ``n`` partials; (0, 0) without a split."""
    if plan["splits"] == 1:
        return 0, 0
    if plan["m_tiles"] * plan["n_tiles"] > K1_COUNTERS:
        raise ValueError(f"{plan['m_tiles']} x {plan['n_tiles']} tiles "
                         f"exceed the {K1_COUNTERS} split-K counters")
    ws = split_workspace(dev, n)
    return ws.data_ptr() + 4 * K1_COUNTERS, ws.data_ptr()


def launch_k1_args(M: int, K: int, N: int, dev: torch.device) -> tuple:
    """(partials pointer, counters pointer, mt, splits) for one launch of
    K1's product."""
    plan = k1_plan(M, K, N)
    ws, count = _split_args(plan, plan["splits"] * M * N, dev)
    return ws, count, plan["mt"], plan["splits"]


def _fit(n: int, want: int, quantum: int = 128) -> int:
    """The reference's block size: the largest multiple of ``quantum``
    up to ``want`` that divides n, else n."""
    if n <= want:
        return n
    b = (want // quantum) * quantum
    while b >= quantum:
        if n % b == 0:
            return b
        b -= quantum
    return n


def _segment_dots(a: torch.Tensor, ws, seg: int) -> list:
    """Exact int8 dots per K segment: a (M, K) int8 against each (N, K)
    int8 of ``ws`` -> (K/seg, M, N) int64 each. Products of int8 values
    and their sums stay far inside float64's 53 bits, so a float64
    product is exact on every device and under any TF32 setting."""
    M, K = a.shape
    n_seg = K // seg
    a3 = a.to(torch.float64).reshape(M, n_seg, seg).transpose(0, 1)
    outs = []
    for w in ws:
        w3 = w.to(torch.float64).reshape(w.shape[0], n_seg, seg)
        outs.append(torch.matmul(a3, w3.permute(1, 2, 0)).to(torch.int64))
    return outs


def _blocked_sum(p: torch.Tensor, per_block: int) -> torch.Tensor:
    """f32 values p (n_seg, M, N) summed in the reference's order: in
    sequence within each block of ``per_block`` segments, then the
    blocks in sequence."""
    acc = None
    for b0 in range(0, p.shape[0], per_block):
        part = p[b0]
        for s in range(b0 + 1, b0 + per_block):
            part = part + p[s]
        acc = part if acc is None else acc + part
    return acc


def ovp_layout(K: int, block_k: int, sub: int
               ) -> tuple[int, int, Optional[torch.Tensor]]:
    """(seg, fold, dst) of K3 (``sub`` 256), K4 (``sub`` K) and K5's OVP
    mode at K: the reference's f32 blocks of ``_fit(K, block_k)`` rows,
    each cut into sub-chunks of ``min(block, sub)`` rows (the last one of
    a block maybe shorter), as ``fold`` segments of ``seg`` rows per
    block. ``dst`` is None where the kernels take the segments as they
    are: all of one length, a multiple of 64, and a multiple of 512 or a
    divisor of it, and whole 128-byte stages or all of K. Otherwise every
    segment is padded to ``seg``, the smallest of 128, 256 and 512 (else a
    multiple of 512) that holds the longest, and ``dst`` gives each
    original row's padded position (K' = K / block x fold x seg)."""
    bk = _fit(K, block_k)
    step = min(bk, sub)
    lens = [min(step, bk - s) for s in range(0, bk, step)]
    seg, fold = lens[0], len(lens)
    if (all(n == seg for n in lens) and seg % 64 == 0
            and (seg % 512 == 0 or 512 % seg == 0)
            and (seg % K1_STEP == 0 or seg == K)):
        return seg, fold, None
    top = max(lens)
    seg = next((p for p in (128, 256, 512) if p >= top),
               -(-top // 512) * 512)
    dst = torch.cat([torch.arange(n) + (b * fold + i) * seg
                     for b in range(K // bk) for i, n in enumerate(lens)])
    return seg, fold, dst


# padded weight stacks, by stack and layout; an entry lives as long as
# its stack
_PADDED: WeakIdKeyDictionary = WeakIdKeyDictionary()


def _padded(w: torch.Tensor, key: tuple, make) -> torch.Tensor:
    """``make()``'s padded copy of the stack ``w``, made once per layout
    ``key``."""
    cache = _PADDED.get(w)
    if cache is None:
        cache = _PADDED[w] = {}
    if key not in cache:
        cache[key] = make()
    return cache[key]


def _scatter_k(t: torch.Tensor, dst: torch.Tensor, k_pad: int,
               fill: int = 0) -> torch.Tensor:
    """t (..., K) -> (..., k_pad), column j at dst[j], the rest ``fill``."""
    out = torch.full((*t.shape[:-1], k_pad), fill, dtype=t.dtype,
                     device=t.device)
    out[..., dst.to(t.device)] = t
    return out


def _ovp_operands(x: torch.Tensor, w: torch.Tensor, block_k: int,
                  sub: int):
    """(x, w, seg, fold) in K3's / K4's layout at w's K (``ovp_layout``):
    the operands themselves where no padding is needed."""
    K = w.shape[2]
    seg, fold, dst = ovp_layout(K, block_k, sub)
    if dst is None:
        return x, w, seg, fold
    k_pad = (K // _fit(K, block_k)) * fold * seg
    wp = _padded(w, ("ovp", block_k, sub),
                 lambda: _scatter_k(w, dst, k_pad))
    return _scatter_k(x, dst, k_pad), wp, seg, fold


def _end_padded(x: torch.Tensor, w: torch.Tensor, quantum: int):
    """x and w zero-padded along K to a multiple of ``quantum`` (the int32
    products of K1 and K5's int8 mode, whose order is free)."""
    K = w.shape[2]
    if K % quantum == 0:
        return x, w
    k_pad = -(-K // quantum) * quantum
    dst = torch.arange(K)
    return (_scatter_k(x, dst, k_pad),
            _padded(w, ("end", quantum),
                    lambda: _scatter_k(w, dst, k_pad)))


def stacked_quant_matmul_plain(l: int, x: torch.Tensor, w: torch.Tensor,
                               scales: torch.Tensor, a_q: torch.Tensor,
                               a_scale: torch.Tensor, ovp: bool = False,
                               block_k: int = 1024) -> torch.Tensor:
    """Plain PyTorch version of :func:`stacked_quant_matmul` (K1, or K3
    with ``ovp``; K5 above ``PREFILL_M`` rows, with the same numbers)."""
    if x.shape[0] > PREFILL_M:
        K5_COUNTS["plain_calls"] += 1
    else:
        (K3_COUNTS if ovp else COUNTS)["plain_calls"] += 1
    xq = snap_value(x.to(torch.float32) / a_scale[l],
                    a_q[l].to(torch.float32)).to(torch.int8)
    if not ovp:
        return int8_matmul(xq, w[l]).to(torch.float32) * scales[l]
    xq, w, seg, per_block = _ovp_operands(xq, w, block_k, _SUB)
    d1, d2 = _segment_dots(xq, (w[l], ovp_clip(w[l])), seg)
    p = (16 * d1 - 15 * d2).to(torch.float32)      # exact int32 values
    return _blocked_sum(p, per_block) * scales[l]


def _check_operands(name_tensors, dev):
    for name, t, dt in name_tensors:
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")


def _fn(lib, name: str, n_ptr: int, n_int: int):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(l, x, w, scales, a_q, a_scale, ovp, seg_fold):
    """K1, K3 (``ovp``: ``seg_fold`` its segments and f32 fold) or, above
    ``PREFILL_M`` rows, K5, on operands already laid out for them."""
    L, N, K = w.shape
    M = x.shape[0]
    G = a_q.shape[1]
    dev = x.device
    if K % 16:
        raise ValueError(f"K = {K} must be a multiple of 16")
    if x.ndim != 2 or x.shape[1] != K or M == 0:
        raise ValueError(f"x must be (M, {K}), got {tuple(x.shape)}")
    _check_operands((("x", x, torch.float32), ("w", w, torch.int8),
                     ("scales", scales, torch.float32),
                     ("a_q", a_q, torch.float32),
                     ("a_scale", a_scale, torch.float32)), dev)
    if scales.shape != (L, N) or a_scale.shape != (L,) or a_q.shape[0] != L:
        raise ValueError("scales (L, N), a_q (L, G), a_scale (L,) expected")
    if M > PREFILL_M:
        return _launch_prefill(l, x, w, scales, a_q, a_scale, ovp, seg_fold)
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("x and w must be 16-byte aligned")
    lib = _ext.load(_SOURCE)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if ovp:
        seg, per_block = seg_fold
        plan = k34_plan(M, K, N, seg, per_block, aovp=False)
        ws, count = _split_args(plan, plan["ws"], dev)
        fn = _fn(lib, "stacked_i8_ovp_matmul", 8, 10)
        code = fn(x.data_ptr(), w.data_ptr(), a_q.data_ptr(),
                  a_scale.data_ptr(), scales.data_ptr(), out.data_ptr(), ws,
                  count, l, L, M, K, N, G, seg, per_block, plan["mt"],
                  plan["splits"], _ext.stream_ptr(dev))
        _ext.check(lib, code, "stacked_i8_ovp_matmul")
        K3_COUNTS["launches"] += 1
    else:
        ws, count, mt, splits = launch_k1_args(M, K, N, dev)
        fn = _fn(lib, "stacked_i8_matmul", 8, 8)
        code = fn(x.data_ptr(), w.data_ptr(), a_q.data_ptr(),
                  a_scale.data_ptr(), scales.data_ptr(), out.data_ptr(), ws,
                  count, l, L, M, K, N, G, mt, splits, _ext.stream_ptr(dev))
        _ext.check(lib, code, "stacked_i8_matmul")
        COUNTS["launches"] += 1
    return out


def k5_ovp_plan(M: int, K: int, N: int, seg: int, fold: int) -> dict:
    """The launch plan of K5's OVP product (``csrc/ovp_wgmma.cuh``) at
    (M, K, N) for segments of ``seg`` rows in f32 blocks of ``fold``
    segments: blocks of ``K5_WN`` weight columns (two consumer warpgroups
    of 64, wgmma's register-held A) by ``K5_XM`` x rows (its B), M tiles
    fastest; ``stages`` TMA stages of ``K1_STEP`` K bytes of both tiles;
    K walked in ``k_steps`` wgmma steps of 32 bytes, two to a commit
    group, a segment ``seg_steps`` of them. ``smem``: the ring, its
    barriers and the f32 totals of the finished blocks (one per output of
    the block's tile). ``regs``: a consumer thread's 32-bit registers for
    the two int32 dots, the running f32 sum and one pair's A fragments (c
    and its clip)."""
    if K % _K5_BK or seg % _K5_BK or K % (seg * fold):
        raise ValueError(f"K5 needs K and its OVP segments in multiples of "
                         f"{_K5_BK} rows and whole f32 blocks: K = {K}, "
                         f"{fold} segments of {seg}")
    m_tiles, n_tiles = -(-M // K5_XM), -(-N // K5_WN)
    acc = K5_XM // 2                # one m64 x XM int32 dot per thread
    return {"xm": K5_XM, "wn": K5_WN, "m_tiles": m_tiles,
            "n_tiles": n_tiles, "blocks": m_tiles * n_tiles,
            "stages": K5_STAGES, "stage_ks": -(-K // K1_STEP),
            "k_steps": K // 32, "seg_steps": seg // 32, "fold": fold,
            "smem": (1024 + K5_STAGES * (K5_WN + K5_XM) * K1_STEP
                     + 2 * K5_STAGES * 8 + K5_WN * K5_XM * 4),
            "regs": 2 * acc + acc + 2 * 2 * 4}


def _launch_prefill(l, x, w, scales, a_q, a_scale, ovp, seg_fold):
    """K5: the snap pre-kernel, then the int8 tensor-core product."""
    L, N, K = w.shape
    M = x.shape[0]
    dev = x.device
    if K % _K5_BK:
        raise ValueError(f"K = {K} must be a multiple of {_K5_BK} for K5")
    seg, per_block = seg_fold if ovp else (K, 1)
    if ovp:
        k5_ovp_plan(M, K, N, seg, per_block)
    lib = _ext.load(_PREFILL_SOURCE)
    fn = _fn(lib, "stacked_prefill_matmul", 7, 9)
    xq = torch.empty((M, K), dtype=torch.int8, device=dev)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    code = fn(x.data_ptr(), xq.data_ptr(), w.data_ptr(), a_q.data_ptr(),
              a_scale.data_ptr(), scales.data_ptr(), out.data_ptr(),
              l, L, M, K, N, a_q.shape[1], seg, per_block, int(ovp),
              _ext.stream_ptr(dev))
    _ext.check(lib, code, "stacked_prefill_matmul")
    K5_COUNTS["launches"] += 1
    return out


def prefill_snap(l: int, x: torch.Tensor, a_q: torch.Tensor,
                 a_scale: torch.Tensor) -> torch.Tensor:
    """K5's snap pre-kernel alone, ``int8(snap(x / a_scale[l]; a_q[l]))``
    -> (M, K) int8, to time it apart from the product (the engine never
    calls it, and it counts as no K5 launch). A CPU tensor takes the
    plain version's snap."""
    if not x.is_cuda:
        return snap_value(x.to(torch.float32) / a_scale[l],
                          a_q[l].to(torch.float32)).to(torch.int8)
    M, K = x.shape
    dev = x.device
    _check_operands((("x", x, torch.float32), ("a_q", a_q, torch.float32),
                     ("a_scale", a_scale, torch.float32)), dev)
    lib = _ext.load(_PREFILL_SOURCE)
    fn = _fn(lib, "snap_i8_matrix", 4, 4)
    xq = torch.empty((M, K), dtype=torch.int8, device=dev)
    code = fn(x.data_ptr(), xq.data_ptr(), a_q.data_ptr(),
              a_scale.data_ptr(), l, M, K, a_q.shape[1],
              _ext.stream_ptr(dev))
    _ext.check(lib, code, "snap_i8_matrix")
    return xq


def stacked_quant_matmul(l: int, x: torch.Tensor, w: torch.Tensor,
                         scales: torch.Tensor, a_q: torch.Tensor,
                         a_scale: torch.Tensor, ovp: bool = False,
                         block_k: int = 1024) -> torch.Tensor:
    """``snap(x / a_scale[l]; a_q[l]) @ W[l].T * scales[l]`` -> (M, N) f32.

    l:       layer index (Python int)
    x:       (M, K) f32 activations: M <= 64 at decode; M > 256 (K5)
             with ``EngineConfig.stacked_prefill``
    w:       (L, N, K) int8 codebook values, or sign-offset OVP bytes
             (``ovp``: K3)
    scales:  (L, N) f32, a_scale * per-channel weight scale, folded
    a_q:     (L, G) f32 int8-domain activation codebook, sorted
    a_scale: (L,) f32 activation scale (an IEEE division, not a
             multiply by the reciprocal)
    block_k: K3's f32 partition of K (the reference's ``block_k``)
    """
    if not 0 <= l < w.shape[0]:
        raise IndexError(f"layer {l} outside a stack of {w.shape[0]}")
    if x.is_cuda:
        x = x.to(torch.float32)
        seg_fold = None
        if ovp:
            x, w, seg, fold = _ovp_operands(x, w, block_k, _SUB)
            seg_fold = (seg, fold)
        else:
            x, w = _end_padded(x, w, _K5_BK if x.shape[0] > PREFILL_M
                               else 16)
        return _launch(l, x.contiguous(), w, scales, a_q, a_scale, ovp,
                       seg_fold)
    return stacked_quant_matmul_plain(l, x, w, scales, a_q, a_scale, ovp,
                                      block_k)


def stacked_quant_matmul_p4_plain(l: int, x: torch.Tensor, w: torch.Tensor,
                                  scales: torch.Tensor, a_q: torch.Tensor,
                                  a_scale: torch.Tensor, q16: torch.Tensor,
                                  affine: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`stacked_quant_matmul_p4`: K1's
    snap, the codes decoded to int8, one exact int32 product (the sum of
    the reference's two half-K dots)."""
    K6_COUNTS["plain_calls"] += 1
    xq = snap_value(x.to(torch.float32) / a_scale[l],
                    a_q[l].to(torch.float32)).to(torch.int8)
    codes = unpack_w4(w[l])                                   # (N, K)
    wv = codes - 8 if affine else q16[l].to(torch.int64)[codes]
    return int8_matmul(xq, wv.to(torch.int8)).to(torch.float32) * scales[l]


def _launch_p4(l, x, w, scales, a_q, a_scale, q16, affine):
    L, N, K2 = w.shape
    K, M = 2 * K2, x.shape[0]
    dev = x.device
    if K2 % 16:
        raise ValueError(f"K/2 = {K2} must be a multiple of 16")
    if x.ndim != 2 or x.shape[1] != K or M == 0:
        raise ValueError(f"x must be (M, {K}), got {tuple(x.shape)}")
    _check_operands((("x", x, torch.float32), ("w", w, torch.uint8),
                     ("scales", scales, torch.float32),
                     ("a_q", a_q, torch.float32),
                     ("a_scale", a_scale, torch.float32),
                     ("q16", q16, torch.int32)), dev)
    if (scales.shape != (L, N) or a_scale.shape != (L,)
            or a_q.shape[0] != L or q16.shape != (L, 16)):
        raise ValueError("scales (L, N), a_q (L, G), a_scale (L,), q16 "
                         "(L, 16) expected")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("x and w must be 16-byte aligned")
    plan = k6_plan(M, K, N)
    ws, count = _split_args(plan, plan["splits"] * M * N, dev)
    lib = _ext.load(_P4_SOURCE)
    fn = _fn(lib, "stacked_p4_matmul", 9, 9)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    code = fn(x.data_ptr(), w.data_ptr(), q16.data_ptr(), a_q.data_ptr(),
              a_scale.data_ptr(), scales.data_ptr(), out.data_ptr(), ws,
              count, l, L, M, K, N, a_q.shape[1], int(affine), plan["mt"],
              plan["splits"], _ext.stream_ptr(dev))
    _ext.check(lib, code, "stacked_p4_matmul")
    K6_COUNTS["launches"] += 1
    return out


def _p4_padded(x: torch.Tensor, w: torch.Tensor, q16: torch.Tensor,
               affine: bool):
    """x (M, K) and packed w (L, N, K/2) with each half of K padded to a
    multiple of 16: x's halves with zeros, w's bytes with each layer's
    code of 0 in both nibbles (8 affine, else the index of 0 in q16[l])."""
    h = w.shape[2]
    if h % 16 == 0:
        return x, w
    h_pad = -(-h // 16) * 16

    def make():
        L = w.shape[0]
        if affine:
            zero = torch.full((L,), 8, dtype=torch.int64, device=w.device)
        else:
            is0 = q16 == 0
            if not bool(is0.any(dim=1).all()):
                raise ValueError("K6 pads K/2 to a multiple of 16 with the "
                                 "code of 0, which a layer's q16 lacks")
            zero = is0.to(torch.int64).argmax(dim=1)
        byte = (zero | (zero << 4)).to(torch.uint8)
        pad = byte[:, None, None].expand(L, w.shape[1], h_pad - h)
        return torch.cat([w, pad], dim=2)

    zx = x.new_zeros((x.shape[0], h_pad - h))
    xp = torch.cat([x[:, :h], zx, x[:, h:], zx], dim=1)
    return xp, _padded(w, ("p4", h_pad, affine), make)


def stacked_quant_matmul_p4(l: int, x: torch.Tensor, w: torch.Tensor,
                            scales: torch.Tensor, a_q: torch.Tensor,
                            a_scale: torch.Tensor, q16: torch.Tensor,
                            affine: bool = False) -> torch.Tensor:
    """K6: ``snap(x / a_scale[l]; a_q[l]) @ dec(W[l]).T * scales[l]`` over
    packed 4-bit weights -> (M, N) f32.

    l:       layer index (Python int)
    x:       (M, K) f32 activations (any M; the engine sends M <= 64)
    w:       (L, N, K/2) uint8 split-K packed codes (``kernels/qmatmul.py``)
    scales:  (L, N) f32, a_scale * oscale (oscale = scale * the table's
             unit), folded
    a_q:     (L, G) f32 int8-domain activation codebook, sorted
    a_scale: (L,) f32 activation scale (an IEEE division)
    q16:     (L, 16) int32 int8 values of each layer's weight grid
    affine:  decode as ``code - 8`` (every layer's q16 is arange(16) - 8)
    """
    if not 0 <= l < w.shape[0]:
        raise IndexError(f"layer {l} outside a stack of {w.shape[0]}")
    if x.is_cuda:
        x, w = _p4_padded(x.to(torch.float32), w, q16, affine)
        return _launch_p4(l, x.contiguous(), w, scales, a_q, a_scale, q16,
                          affine)
    return stacked_quant_matmul_p4_plain(l, x, w, scales, a_q, a_scale, q16,
                                         affine)


def aovp_snap_encode(xs: torch.Tensor, mids: torch.Tensor,
                     ties: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
    """The tie-flagged concat snap of pre-scaled xs (M, K) f32 straight to
    the encoded byte value (f32), before the victims are zeroed."""
    cxf = enc[0].expand(xs.shape).clone()
    for i in range(mids.shape[0]):
        take = (xs > mids[i]) | ((xs == mids[i]) & (ties[i] > 0))
        cxf = torch.where(take, enc[i + 1], cxf)
    return cxf


def aovp_encode(xs: torch.Tensor, mids: torch.Tensor, ties: torch.Tensor,
                enc: torch.Tensor) -> torch.Tensor:
    """K4's activation encode on pre-scaled xs (M, K) f32:
    :func:`aovp_snap_encode`, then the OVP victims along K zeroed
    (|byte| > 64 marks an outlier)."""
    cxf = aovp_snap_encode(xs, mids, ties, enc)
    victims = victim_mask(cxf.abs() > OVP_OFFSET, pair_axis=-1)
    return torch.where(victims, torch.zeros_like(cxf), cxf)


def stacked_quant_matmul_aovp_plain(l: int, x: torch.Tensor,
                                    w: torch.Tensor, scales: torch.Tensor,
                                    prescale: torch.Tensor,
                                    mids: torch.Tensor, ties: torch.Tensor,
                                    enc: torch.Tensor, w_ovp: bool = False,
                                    block_k: int = 1024) -> torch.Tensor:
    """Plain PyTorch version of :func:`stacked_quant_matmul_aovp`."""
    K4_COUNTS["plain_calls"] += 1
    # one segment per f32 block
    x, w, seg, _ = _ovp_operands(x, w, block_k, w.shape[2])
    cxf = aovp_encode(x.to(torch.float32) / prescale[l], mids[l], ties[l],
                      enc[l])
    cx = cxf.to(torch.int8)
    px = torch.clamp(cxf, -OVP_OFFSET, OVP_OFFSET).to(torch.int8)
    wl = w[l]
    f = lambda d: d.to(torch.float32)
    if w_ovp:
        (d1, d2), (d3, d4) = (_segment_dots(a, (wl, ovp_clip(wl)), seg)
                              for a in (cx, px))
        part = (256.0 * f(d1) - 240.0 * f(d2) - 240.0 * f(d3)
                + 225.0 * f(d4))
    else:
        (d1,), (d3,) = (_segment_dots(a, (wl,), seg) for a in (cx, px))
        part = 16.0 * f(d1) - 15.0 * f(d3)
    return _blocked_sum(part, 1) * scales[l]


def _launch_aovp(l, x, w, scales, prescale, mids, ties, enc, w_ovp, seg):
    L, N, K = w.shape
    M = x.shape[0]
    G1 = mids.shape[1]
    dev = x.device
    if K % 16:
        raise ValueError(f"K = {K} must be a multiple of 16")
    if x.ndim != 2 or x.shape[1] != K or M == 0:
        raise ValueError(f"x must be (M, {K}), got {tuple(x.shape)}")
    _check_operands((("x", x, torch.float32), ("w", w, torch.int8),
                     ("scales", scales, torch.float32),
                     ("prescale", prescale, torch.float32),
                     ("mids", mids, torch.float32),
                     ("ties", ties, torch.int32),
                     ("enc", enc, torch.float32)), dev)
    if (scales.shape != (L, N) or prescale.shape != (L,)
            or mids.shape != (L, G1) or ties.shape != (L, G1)
            or enc.shape != (L, G1 + 1)):
        raise ValueError("scales (L, N), prescale (L,), mids and ties "
                         "(L, G-1), enc (L, G) expected")
    if G1 + 1 > 32:
        raise ValueError(f"K4 takes at most 32 table entries, got {G1 + 1}")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("x and w must be 16-byte aligned")
    plan = k34_plan(M, K, N, seg, 1, aovp=True, w_ovp=w_ovp)
    ws, count = _split_args(plan, plan["ws"], dev)
    lib = _ext.load(_AOVP_SOURCE)
    fn = _fn(lib, "stacked_aovp_matmul", 10, 10)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    code = fn(x.data_ptr(), w.data_ptr(), prescale.data_ptr(),
              mids.data_ptr(), ties.data_ptr(), enc.data_ptr(),
              scales.data_ptr(), out.data_ptr(), ws, count, l, L, M, K, N,
              G1 + 1, seg, int(w_ovp), plan["mt"], plan["splits"],
              _ext.stream_ptr(dev))
    _ext.check(lib, code, "stacked_aovp_matmul")
    K4_COUNTS["launches"] += 1
    return out


def stacked_quant_matmul_aovp(l: int, x: torch.Tensor, w: torch.Tensor,
                              scales: torch.Tensor, prescale: torch.Tensor,
                              mids: torch.Tensor, ties: torch.Tensor,
                              enc: torch.Tensor, w_ovp: bool = False,
                              block_k: int = 1024) -> torch.Tensor:
    """Full-OliVe stacked matmul (K4) -> (M, N) f32.

    l:        layer index (Python int)
    x:        (M, K) f32 raw activations
    w:        (L, N, K) int8: codebook values, or OVP bytes (``w_ovp``)
    scales:   (L, N) f32 output scale (prescale x activation unit x
              weight scale, folded)
    prescale: (L,) f32 alpha / max(normal grid); x / prescale is the
              integer domain the concat snap runs in
    mids:     (L, 31) f32 sorted-concat midpoints
    ties:     (L, 31) int32 tie-to-the-later-entry flags
    enc:      (L, 32) f32 encoded byte of each sorted concat entry
    block_k:  the f32 partition of K (the reference's ``block_k``)
    """
    if not 0 <= l < w.shape[0]:
        raise IndexError(f"layer {l} outside a stack of {w.shape[0]}")
    if x.is_cuda:
        x, w, seg, _ = _ovp_operands(x.to(torch.float32), w, block_k,
                                     w.shape[2])
        return _launch_aovp(l, x.contiguous(), w, scales, prescale, mids,
                            ties, enc, w_ovp, seg)
    return stacked_quant_matmul_aovp_plain(l, x, w, scales, prescale, mids,
                                           ties, enc, w_ovp, block_k)
