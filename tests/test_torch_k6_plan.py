"""K6 on K1's staged split-K weight stream (csrc/i8_stream.cuh with the
nibble-decode policy, csrc/stacked_p4.cu), checked on the CPU where the
kernel does not run:

- its launch plan (``kernels/stacked.py:k6_plan``) at OPT-6.7B's three
  site shapes and at K = 4160 (K/2 = 2080, no multiple of the 128-byte
  stage), M 1, 4, 16, 64 and 300: two blocks' shared memory (the ring and
  two stages of codes for both x ranges) fit an SM, the K splits cut the
  K/2 packed bytes into whole stages, M runs in tiles, the grid fills the
  card (one wave of about two blocks per SM at decode);
- an emulation of the kernel's order of work in numpy: split s streams
  stages [s steps / splits, (s + 1) steps / splits) of 128 packed bytes;
  each stage pairs with two x ranges, [k0, k0 + 128) and [K/2 + k0,
  K/2 + k0 + 128), snapped by thresholds on x (K1's snap) with zero codes
  past K/2; the nibbles decoded by the kernel's own word arithmetic (an
  add and an xor per word, or a nibble unzip, two ``__byte_perm`` table
  lookups per half and the pick by a multiplied bit-3 mask); int32
  partials per split, added by the last split, one f32 multiply;
- the mma's accumulators cover each of a tile's MT x 128 sums once.
  Bit-equal to ``stacked_quant_matmul_p4_plain`` and to the Pallas
  ``stacked_quant_matmul(mode="p4")`` in interpret mode, affine and
  table decode, with exact midpoint ties."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ant_quantization_tpu.kernels.stacked import stacked_quant_matmul as jk
from ant_quantization_tpu_torch.kernels import stacked as tk
from ant_quantization_tpu_torch.kernels.qmatmul import int8_codebook
from ant_quantization_tpu_torch.numerics import codebooks as cb

pytestmark = pytest.mark.torchdep

F = np.float32
_SHAPES = {"opt q/k/v/out": (4096, 4096), "opt fc_in": (4096, 16384),
           "opt fc_out": (16384, 4096), "k 4160": (4160, 4104)}


@pytest.mark.parametrize("M", [1, 4, 16, 64, 300])
@pytest.mark.parametrize("site", list(_SHAPES))
def test_plan_fits_and_fills(site, M):
    K, N = _SHAPES[site]
    p = tk.k6_plan(M, K, N)
    step = tk.K1_STEP
    # two blocks' shared memory fit the 228 KB of an SM
    assert 2 * (p["smem"] + 1024) <= 228 * 1024
    # K1's block at the same mt, but two stages' codes hold both x ranges,
    # each whole eight-row tiles of the mma's B in padded rows
    k1 = tk.k1_plan(M, K, N)
    assert k1["mt"] == p["mt"]
    rows = -(-p["mt"] // 8) * 8
    assert rows >= p["mt"] and p["codes"] == 2 * rows * tk.K34_XROW
    assert p["smem"] - k1["smem"] == 2 * p["codes"] - 2 * p["mt"] * step
    assert p["mt"] in tk.K1_MT and p["mt"] * p["m_tiles"] >= M
    assert (p["m_tiles"] - 1) * p["mt"] < M
    # the splits cut the K/2 packed bytes into whole stages, each nonempty
    K2 = K // 2
    assert p["steps"] * step >= K2 > (p["steps"] - 1) * step
    bounds = [s * p["steps"] // p["splits"] for s in range(p["splits"] + 1)]
    assert bounds[0] == 0 and bounds[-1] == p["steps"]
    assert all(b1 > b0 for b0, b1 in zip(bounds, bounds[1:]))
    assert p["m_tiles"] * p["n_tiles"] <= tk.K1_COUNTERS
    tiles = p["m_tiles"] * p["n_tiles"]
    assert p["blocks"] == tiles * p["splits"]
    assert p["blocks"] >= min(1.4 * tk.K1_SMS, tiles * p["steps"]) / 2
    if M <= 16:                       # decode: one wave of two per SM
        assert p["blocks"] <= 2 * tk.K1_SMS


def _thresholds(aq, sc):
    """K1's fused snap: for each midpoint m the least f32 x with
    x / sc >= m, found from m * sc one ulp at a time (i8_stream.cuh)."""
    out = []
    for m in (aq[:-1] + aq[1:]) * F(0.5):
        t = F(m * sc)
        if t / sc >= m:
            p = np.nextafter(t, F(-np.inf))
            while p / sc >= m:
                t, p = p, np.nextafter(p, F(-np.inf))
        else:
            t = np.nextafter(t, F(np.inf))
            while not t / sc >= m:
                t = np.nextafter(t, F(np.inf))
        out.append(F(t))
    return np.asarray(out, F)


def _snap(x, aq, sc):
    thr = _thresholds(aq, sc)
    idx = np.minimum((x[..., None] >= thr).sum(-1), len(aq) - 1)
    return aq[idx].astype(np.int64)


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm(x, y, s) on uint32 arrays: result byte i is byte
    (s >> 4 i) & 7 of the eight bytes y:x (the selectors here never set
    the sign-replicate bit)."""
    both = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros_like(x, dtype=np.uint64)
    for i in range(4):
        b = (sel >> np.uint32(4 * i)) & np.uint32(7)
        byte = (both >> (b.astype(np.uint64) * np.uint64(8))) & np.uint64(255)
        out |= byte << np.uint64(8 * i)
    return out.astype(np.uint32)


def _words_to_bytes(w):
    return w.astype("<u4").view(np.uint8).reshape(*w.shape[:-1], -1)


def _decode(packed, q16, affine):
    """The kernel's decode_word on (..., 4 k) packed bytes, by its own word
    arithmetic: the low and the high nibbles' int8 values."""
    u = np.uint32
    w = packed.reshape(*packed.shape[:-1], -1, 4).astype(np.uint32)
    w = w[..., 0] | w[..., 1] << u(8) | w[..., 2] << u(16) | w[..., 3] << u(24)
    if affine:               # (code + 0x78) ^ 0x80 per byte: no carries
        lo = ((w & u(0x0F0F0F0F)) + u(0x78787878)) ^ u(0x80808080)
        hi = (((w >> u(4)) & u(0x0F0F0F0F)) + u(0x78787878)) ^ u(0x80808080)
    else:
        tab = np.zeros(4, np.uint32)
        for i, v in enumerate(q16):
            tab[i >> 2] |= u(int(v) & 0xFF) << u(8 * (i & 3))
        full = lambda v: np.full_like(w, v)
        bp = lambda x, y, sel: _byte_perm(x, y, sel & u(0xFFFF))
        d = (w ^ (w >> u(4))) & u(0x00F000F0)
        s7 = bp(w ^ d ^ (d << u(4)), full(0), full(0x3120)) & u(0x77777777)
        ml = (((w >> u(3)) & u(0x01010101)) * u(0xFF)).astype(np.uint32)
        mh = (((w >> u(7)) & u(0x01010101)) * u(0xFF)).astype(np.uint32)
        t01, t23 = (full(tab[0]), full(tab[1])), (full(tab[2]), full(tab[3]))
        lo = (bp(*t23, s7) & ml) | (bp(*t01, s7) & ~ml)
        hi = ((bp(*t23, s7 >> u(16)) & mh)
              | (bp(*t01, s7 >> u(16)) & ~mh))
    return [_words_to_bytes(v.astype(np.uint32)).astype(np.int8)
            .astype(np.int64) for v in (lo, hi)]


def _emulate(x, packed, q16, aq, sc, scales, affine, plan):
    """The kernel's order of work for one layer: x (M, K) f32, packed
    (N, K/2) uint8 -> (M, N) f32, and the int32 partials per split."""
    M, K = x.shape
    N, K2 = packed.shape
    step, steps, splits = tk.K1_STEP, plan["steps"], plan["splits"]
    parts = np.zeros((splits, M, N), np.int64)
    for s in range(splits):
        for j in range(s * steps // splits, (s + 1) * steps // splits):
            k0 = j * step
            kk = k0 + np.arange(step)
            inside = kk < K2
            # the stage's two x ranges, snapped; zero codes past K/2, where
            # TMA's zero bytes decode to no zero value
            xlo = np.where(inside, x[:, np.minimum(kk, K2 - 1)], F(0))
            xhi = np.where(inside, x[:, K2 + np.minimum(kk, K2 - 1)], F(0))
            clo = np.where(inside, _snap(xlo, aq, sc), 0)
            chi = np.where(inside, _snap(xhi, aq, sc), 0)
            stage = np.zeros((N, step), np.uint8)        # TMA's zero fill
            stage[:, :inside.sum()] = packed[:, k0:k0 + inside.sum()]
            lo, hi = _decode(stage, q16, affine)
            parts[s] += clo @ lo.T + chi @ hi.T
    assert np.abs(parts).max() < 2 ** 31
    total = parts.sum(0)
    assert np.abs(total).max() < 2 ** 31
    return total.astype(np.int32).astype(F) * scales, parts


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("M,K,N", [(4, 4160, 128), (1, 1024, 256),
                                   (64, 512, 128), (300, 256, 128),
                                   (16, 4096, 512)])
def test_stream_order_equals_plain_and_pallas(affine, M, K, N):
    rng = np.random.default_rng(M + K + affine)
    L, l = 2, 1
    flint = cb.ant_grid("flint", 4, True).astype(F)
    q16v = np.arange(16) - 8 if affine else int8_codebook(flint)[0]
    q16 = np.stack([q16v[::-1], q16v]).astype(np.int32)
    packed = rng.integers(0, 256, (L, N, K // 2)).astype(np.uint8)
    aq16 = int8_codebook(cb.ant_grid("flint", 4, False))[0].astype(F)
    a_q = np.stack([aq16[::-1] * -1, aq16]).astype(F)
    a_q = np.sort(a_q, axis=1)
    a_scale = F([0.5, 0.25])                # powers of two keep ties exact
    scales = rng.uniform(0.5, 2, (L, N)).astype(F)
    x = (rng.normal(size=(M, K)) * 30).astype(F)
    mids = (a_q[l, 1:] + a_q[l, :-1]) * F(0.5)
    x[0, :15] = mids * a_scale[l]                     # exact midpoint ties
    x[0, K // 2:K // 2 + 15] = mids * a_scale[l]      # in the high half too
    plan = tk.k6_plan(M, K, N)
    got, parts = _emulate(x, packed[l], q16[l], a_q[l], a_scale[l],
                          scales[l], affine, plan)
    want = tk.stacked_quant_matmul_p4_plain(
        l, torch.from_numpy(x), torch.from_numpy(packed),
        torch.from_numpy(scales), torch.from_numpy(a_q),
        torch.from_numpy(a_scale), torch.from_numpy(q16),
        affine=affine).numpy()
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(jk(
        jnp.int32(l), jnp.asarray(x),
        jnp.asarray(np.ascontiguousarray(packed.transpose(0, 2, 1))
                    .reshape(-1, N)),
        jnp.asarray(scales), jnp.asarray(a_q), jnp.asarray(a_scale[:, None]),
        jnp.asarray(q16), mode="p4", n_layers=L, affine=affine,
        interpret=True))
    np.testing.assert_array_equal(got, pallas)
    if plan["splits"] > 1:
        # the partials meet as int32: a multiply per split and an f32 sum
        # is another result
        per = sum(p.astype(np.int32).astype(F) * scales[l] for p in parts)
        assert not np.array_equal(per, want)


def test_decode_matches_unpacked_values():
    """The kernel's nibble arithmetic gives the plain version's values for
    every byte, affine and through a table with negative entries."""
    packed = np.arange(256, dtype=np.uint8)[None].repeat(2, 0)
    packed = np.concatenate([packed, packed[:, ::-1]], 1)        # (2, 512)
    flint = cb.ant_grid("flint", 4, True).astype(F)
    for affine, q16 in ((True, np.arange(16) - 8),
                        (False, int8_codebook(flint)[0])):
        lo, hi = _decode(packed, q16, affine)
        codes = np.stack([packed & 15, packed >> 4]).astype(np.int64)
        want = codes - 8 if affine else np.asarray(q16, np.int64)[codes]
        np.testing.assert_array_equal(lo, want[0])
        np.testing.assert_array_equal(hi, want[1])


@pytest.mark.parametrize("mt", tk.K1_MT)
def test_dot_fragments_cover_each_sum_once(mt):
    """K6's dots, mma.sync m16n8k32 with the weight columns as A and the
    code rows as B: register e of lane (g, t) of warp w in n8 tile b holds
    column 16 w + g + 8 (e >> 1) and x row 8 b + 2 t + (e & 1); the rows
    below mt cover the tile's mt x 128 sums exactly once."""
    seen = np.zeros((mt, tk.K1_COLS), np.int64)
    for warp in range(tk.K1_THREADS // 32):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for b in range(-(-mt // 8)):
                for e in range(4):
                    r = 8 * b + 2 * t + (e & 1)
                    if r < mt:
                        seen[r, 16 * warp + g + 8 * (e >> 1)] += 1
    assert (seen == 1).all()

