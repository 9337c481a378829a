"""K5's OVP mode on wgmma (csrc/ovp_wgmma.cuh), checked on the CPU where
the kernel does not run:

- its plan (``kernels/stacked.py:k5_ovp_plan``) at OPT-6.7B's three site
  shapes and M 257, 300, 2048 and 4096: the tile covers M and N, the ring,
  its barriers and the f32 block totals fit the 227 KB a block may use,
  and a consumer thread's dots, running sum and A fragments fit the
  registers that the kernel's ``setmaxnreg`` gives it;
- every (K, block_k), laid out as the wrappers lay it out
  (``ovp_layout``: the reference's segments, or each padded in place
  where the kernels need it, F5), is accepted;
- an emulation of the kernel's order of work in numpy: per block of 128
  weight columns by 128 x rows, each consumer warpgroup's A fragments
  read by the kernel's ``ldmatrix`` addresses from a stage laid out as
  TMA's 128-byte swizzle writes it (held to the weight tile), clamped for
  the second dot, the x codes as B with TMA's zero fill past M, N and K;
  the segment drains at the plan's 32-byte k steps (int32 16 d1 - 15 d2,
  its f32 value added into the block's sum in order), the block totals,
  and the epilogue's transposed placement of each accumulator register.
  Bit-equal to ``stacked_quant_matmul_plain(ovp=True)`` and to the JAX
  ``_prefill_i8`` in interpret mode, including sums past 2^24; where K
  holds two f32 blocks or more, one f32 chain over all segments of K (the
  block partition ignored) is shown to differ there."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ant_quantization_tpu.kernels.stacked import stacked_quant_matmul as jk
from ant_quantization_tpu_torch.kernels import stacked as tk
from ant_quantization_tpu_torch.ops.snap import snap_value

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.torchdep

F = np.float32
_SITES = {"opt q/k/v/out": (4096, 4096), "opt fc_in": (4096, 16384),
          "opt fc_out": (16384, 4096)}
# the kernel's setmaxnreg: consumers 240 registers a thread, the producer
# warpgroup 24, of an SM's 65,536 for 384 threads
_CONSUMER_REGS, _PRODUCER_REGS = 240, 24


@pytest.mark.parametrize("block_k", [1024, 128, 4096])
@pytest.mark.parametrize("M", [257, 300, 2048, 4096])
@pytest.mark.parametrize("site", list(_SITES))
def test_plan_fits(site, M, block_k):
    K, N = _SITES[site]
    seg, fold = tk.ovp_layout(K, block_k, tk._SUB)[:2]
    p = tk.k5_ovp_plan(M, K, N, seg, fold)
    assert p["smem"] <= 232448                     # 227 KB a block may use
    assert p["m_tiles"] * p["xm"] >= M > (p["m_tiles"] - 1) * p["xm"]
    assert p["n_tiles"] * p["wn"] >= N > (p["n_tiles"] - 1) * p["wn"]
    assert p["blocks"] == p["m_tiles"] * p["n_tiles"]
    assert p["wn"] == 2 * 64                       # two warpgroups' A
    assert p["xm"] % 16 == 0 and 8 <= p["xm"] <= 256   # wgmma's s8 N
    assert p["k_steps"] * 32 == K and p["seg_steps"] * 32 == seg
    assert p["stage_ks"] * tk.K1_STEP >= K and p["stages"] >= 2
    assert K % (seg * fold) == 0
    # the consumers' registers: dots, running sum, A fragments, with room
    # for addresses and counters; the SM's file holds all three groups
    assert p["regs"] + 24 <= _CONSUMER_REGS
    assert 2 * 128 * _CONSUMER_REGS + 128 * _PRODUCER_REGS <= 65536
    # M = 2048 cuts into whole tiles
    if M == 2048:
        assert M % p["xm"] == 0


def test_plan_takes_every_partition_k5_took():
    """K5 took an OVP partition whose segments were a multiple of 64 rows;
    since F5 the wrappers lay every other one out so (``ovp_layout``
    pads each segment in place), and k5_ovp_plan takes every layout."""
    padded = 0
    for K in range(64, 16385, 64):
        for block_k in (64, 128, 256, 512, 1024, 2048, 4096):
            seg, fold, dst = tk.ovp_layout(K, block_k, tk._SUB)
            k_pad = K if dst is None else (
                K // tk._fit(K, block_k) * fold * seg)
            padded += dst is not None
            p = tk.k5_ovp_plan(2048, k_pad, 4096, seg, fold)
            assert seg % 64 == 0, (K, block_k, seg, fold)
            assert p["seg_steps"] * p["fold"] * 32 * (
                k_pad // (seg * fold)) == k_pad
    assert padded > 0


def _swizzled(tile):
    """A (rows, 128) byte tile as TMA's 128-byte swizzle stores it: the
    16-byte chunk c of row r at chunk c ^ (r % 8)."""
    rows = tile.shape[0]
    r = np.arange(rows)[:, None]
    c = np.arange(8)[None, :]
    phys = np.zeros((rows, 8, 16), tile.dtype)
    phys[r, c ^ (r % 8)] = tile.reshape(rows, 8, 16)
    return phys.reshape(-1)


_LANE = np.arange(32)
_G, _T = _LANE // 4, _LANE % 4


def _a_fragments(phys, wgi, kk):
    """The consumer warpgroup's A tile (64 weight columns x 32 bytes of k
    step kk) as the kernel loads it: ldmatrix x4 at each lane's address
    (lanes 8 q .. 8 q + 7 give matrix q's row addresses; lane L receives
    bytes 4 (L % 4) .. + 3 of row L / 4 of each matrix), then read back
    through the register layout of an m64k32 s8 A fragment (per warp that
    of mma.sync m16n8k32's A: registers 0-3 are rows g, g + 8, g, g + 8 of
    bytes 4 t, 4 t, 16 + 4 t, 16 + 4 t)."""
    a = np.zeros((64, 32), np.int8)
    for w in range(4):
        a_row = 64 * wgi + 16 * w + (_LANE & 7) + 8 * ((_LANE >> 3) & 1)
        a_hi = _LANE >> 4
        addr = a_row * 128 + (((2 * kk + a_hi) ^ (a_row & 7)) << 4)
        for q, (dr, db) in enumerate(((0, 0), (8, 0), (0, 16), (8, 16))):
            src = addr[8 * q + _G] + 4 * _T                       # (32,)
            regs = phys[src[:, None] + np.arange(4)]              # (32, 4)
            a[(16 * w + _G + dr)[:, None],
              db + 4 * _T[:, None] + np.arange(4)] = regs
    return a


def _emulate(xq, w, scales, seg, fold, chain_all=False):
    """The kernel's order of work: xq (M, K) int codes, w (N, K) int8 OVP
    bytes -> (M, N) f32. ``chain_all``: one running f32 sum over every
    segment of K (another order, for contrast)."""
    M, K = xq.shape
    N = w.shape[0]
    p = tk.k5_ovp_plan(M, K, N, seg, fold)
    XM, WN, KP = p["xm"], p["wn"], p["stage_ks"] * tk.K1_STEP
    xpad = np.zeros((p["m_tiles"] * XM, KP), np.int64)     # TMA zero fill
    xpad[:M, :K] = xq
    wpad = np.zeros((p["n_tiles"] * WN, KP), np.int8)
    wpad[:N, :K] = w
    fold_k = 1 if chain_all else fold
    out = np.full((M, N), np.nan, F)
    for bm in range(p["m_tiles"]):
        m0 = bm * XM
        for bn in range(p["n_tiles"]):
            n0 = bn * WN
            stages = [_swizzled(wpad[n0:n0 + WN, k:k + tk.K1_STEP])
                      for k in range(0, KP, tk.K1_STEP)]
            for wgi in (0, 1):
                run = np.zeros((64, XM), F)       # D rows: weight columns
                tot = np.zeros((64, XM), F)
                left, segs, first = p["seg_steps"], 0, True
                for step in range(p["k_steps"]):
                    kt, kk = divmod(step, 4)
                    a = _a_fragments(stages[kt], wgi, kk)
                    k0 = kt * tk.K1_STEP + 32 * kk
                    np.testing.assert_array_equal(
                        a, wpad[n0 + 64 * wgi:n0 + 64 * wgi + 64, k0:k0 + 32])
                    a = a.astype(np.int64)
                    b = xpad[m0:m0 + XM, k0:k0 + 32]
                    c1, c2 = a @ b.T, np.clip(a, -64, 64) @ b.T
                    d1, d2 = (c1, c2) if first else (d1 + c1, d2 + c2)
                    first = False
                    left -= 1
                    if left:
                        continue
                    v = 16 * d1 - 15 * d2
                    assert np.abs(v).max() < 2 ** 31
                    run = run + v.astype(np.int32).astype(F)
                    left, first = p["seg_steps"], True
                    if fold_k > 1:
                        segs += 1
                        if segs == fold_k:
                            tot, run, segs = tot + run, np.zeros_like(run), 0
                val = tot if fold_k > 1 else run
                if chain_all:
                    val = run
                # the epilogue: register 4 i + 2 hh + e of lane (g, t) of
                # warp w holds D row 16 w + g + 8 hh, column 8 i + 2 t + e,
                # and the kernel writes it to out[m, n] below
                for wi in range(4):
                    for i in range(16):
                        for hh in range(2):
                            for e in range(2):
                                dr = 16 * wi + _G + 8 * hh
                                dc = 8 * i + 2 * _T + e
                                n = n0 + 64 * wgi + 16 * wi + _G + 8 * hh
                                m = m0 + 8 * i + 2 * _T + e
                                ok = (m < M) & (n < N)
                                assert np.all(np.isnan(out[m[ok], n[ok]]))
                                out[m[ok], n[ok]] = (
                                    val[dr[ok], dc[ok]] * scales[n[ok]])
    assert not np.isnan(out).any()           # every output written once
    return out


def _mixed(rng, shape, p_top, top, low):
    return np.where(rng.random(shape) < p_top, rng.choice(top, shape),
                    rng.choice(low, shape))


_A_VALS = np.round(np.linspace(-96, 127, 16)).astype(F)


def _operands(M, K, N, adversarial, seed):
    rng = np.random.default_rng(seed)
    L, sc = 2, F(0.25)
    if adversarial:
        # the codebook's top against mostly outlier weights: every 256-row
        # segment passes 2^24, and irregular values make their f32
        # roundings land differently in different orders
        x = (_mixed(rng, (M, K), 0.8, _A_VALS[-4:], _A_VALS[8:12])
             * sc).astype(F)
        w = _mixed(rng, (L, N, K), 0.8, np.arange(100, 128),
                   np.arange(1, 65)).astype(np.int8)
    else:
        x = (rng.normal(size=(M, K)) * 10).astype(F)
        x[0, :15] = (_A_VALS[1:] + _A_VALS[:-1]) * F(0.5) * sc   # ties
        w = rng.integers(-127, 128, (L, N, K)).astype(np.int8)
    a_q = np.stack([_A_VALS] * L)
    a_scale = np.full(L, sc, F)
    scales = rng.uniform(1e-3, 3e-3, (L, N)).astype(F)
    return x, w, scales, a_q, a_scale


@pytest.mark.parametrize("M,K,N,block_k,adversarial,pallas", [
    (300, 2048, 200, 1024, False, True),     # seg 256, fold 4; M, N tails
    (300, 2048, 128, 1024, True, True),      # past 2^24, fold 4
    (257, 1024, 128, 256, True, True),       # past 2^24, fold 1
    (300, 64, 136, 1024, False, True),       # a stage of two k steps
    (257, 1024, 128, 128, False, False),     # seg 128: one stage each
    (300, 2048, 128, 4096, True, False),     # fold 8
    (300, 2048, 128, 64, True, False)])      # block_k 64: all of K
def test_kernel_order_equals_plain_and_pallas(M, K, N, block_k, adversarial,
                                              pallas):
    x, w, scales, a_q, a_scale = _operands(M, K, N, adversarial, M + K + N)
    l = 1
    seg, fold = tk.ovp_layout(K, block_k, tk._SUB)[:2]
    xq = snap_value(torch.from_numpy(x) / torch.from_numpy(a_scale)[l],
                    torch.from_numpy(a_q[l])).numpy().astype(np.int64)
    got = _emulate(xq, w[l], scales[l], seg, fold)
    want = tk.stacked_quant_matmul_plain(
        l, torch.from_numpy(x), torch.from_numpy(w),
        torch.from_numpy(scales), torch.from_numpy(a_q),
        torch.from_numpy(a_scale), ovp=True, block_k=block_k).numpy()
    np.testing.assert_array_equal(got, want)
    if pallas:
        ref = np.asarray(jk(
            jnp.int32(l), jnp.asarray(x),
            jnp.asarray(np.ascontiguousarray(w.transpose(0, 2, 1))
                        .reshape(-1, N)),
            jnp.asarray(scales), jnp.asarray(a_q),
            jnp.asarray(a_scale[:, None]), None, mode="i8", n_layers=2,
            block_k=block_k, ovp=True, interpret=True))
        np.testing.assert_array_equal(got, ref)
    if adversarial:
        vals = 16 * w[l].astype(np.int64) - 15 * np.clip(w[l], -64, 64)
        assert np.abs(xq[:, :256] @ vals[:, :256].T).max() > 2 ** 24
        if fold > 1 and K > seg * fold:       # two f32 blocks or more
            other = _emulate(xq, w[l], scales[l], seg, fold, chain_all=True)
            assert not np.array_equal(other, want)
