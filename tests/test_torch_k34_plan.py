"""K3 and K4 on K1's staged split-K weight stream (csrc/ovp_stream.cuh),
checked on the CPU where the kernel does not run, by an emulation of its
arithmetic in numpy float32 and exact integers:

- K4's concat snap by thresholds on x: for each midpoint the least f32 x
  whose quotient by prescale passes the step (``>=`` with the tie flag,
  else ``>``), found by the same division; when the thresholds are
  non-decreasing a binary search over them, else the select chain on
  them. Held bit for bit to ``aovp_snap_encode`` and ``aovp_encode`` and,
  through a one-hot weight that reads each code back, to the Pallas
  ``_aovp_kernel`` in interpret mode: at, one ulp below and one ulp above
  every threshold, on the engine's tables for the signed and unsigned
  OliVe grids (a repeated midpoint among them), at prescales 0.25, 0.19,
  0.0123456 and 3.7, and on a table whose thresholds fall out of order;
- the split-K f32 order: the plan cuts K only between f32 blocks
  (``_fit(K, block_k)`` rows), so each segment's int32 dots are whole in
  one kernel block, which forms its blocks' f32 sums in order; the tile's
  last split chains them. On adversarial inputs past 2^24 that is
  bit-equal to the plain versions and to the Pallas kernels (K4 through
  XLA:CPU's contraction of its combine); a K3 split that added its own
  blocks first, or a K4 split that cut a segment and combined its part in
  f32, would not be;
- the plan (``kernels/stacked.py:k34_plan``) at the engine's site shapes:
  shared memory for two blocks per SM, at most one wave at decode, the
  tile counters, whole-stage segments, splits between f32 blocks."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ant_quantization_tpu.kernels.stacked import stacked_quant_matmul as jk3
from ant_quantization_tpu.kernels.stacked import (
    stacked_quant_matmul_aovp as jk4)
from ant_quantization_tpu.serve.engine import _aovp_encode_tables as jtables
from ant_quantization_tpu_torch.kernels import stacked as tk
from ant_quantization_tpu_torch.kernels.qmatmul import ovp_unit
from ant_quantization_tpu_torch.numerics import codebooks as cb
from ant_quantization_tpu_torch.ops.ovp import victim_mask
from ant_quantization_tpu_torch.serve.engine import _aovp_encode_tables

pytestmark = pytest.mark.torchdep

F = np.float32
INF = F(np.inf)
PRESCALES = (0.25, 0.19, 0.0123456, 3.7)
_SHAPES = {"opt q/k/v/out": (4096, 4096), "opt fc_in": (4096, 16384),
           "opt fc_out": (16384, 4096), "bloom qkv": (4096, 12288)}


def _pad16(a):
    return np.pad(np.asarray(a, F), (0, 16 - len(a)), mode="edge")


def _tables(signed):
    """The engine's K4 tables for the OliVe flint grid (padded grids, so
    the concat holds duplicates), as numpy: mids, ties, enc."""
    grid = _pad16(cb.olive_grid("flint", 4, signed))
    out = _pad16(cb.olive_outlier_values(4, signed))
    u_a, exact = ovp_unit(grid, out)
    assert exact
    t = _aovp_encode_tables(grid, out, u_a, torch.device("cpu"))
    ref = jtables(grid, out, u_a)
    for k in ("aovp_mids", "aovp_ties", "aovp_enc"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(ref[k]))
    return (t["aovp_mids"].numpy(), t["aovp_ties"].numpy(),
            t["aovp_enc"].numpy())


def _skewed(mids, ties, i=14):
    """Midpoint i + 1 moved onto midpoint i, tie flags (0, 1): an x exactly
    there fails step i and passes step i + 1."""
    mids, ties = mids.copy(), ties.copy()
    mids[i + 1] = mids[i]
    ties[i], ties[i + 1] = 0, 1
    return mids, ties


def _least_x(m, sc, ge):
    """The kernel's threshold search (ovp_stream.cuh:least_x) in float32."""
    m, sc = F(m), F(sc)
    if np.isnan(m):
        return F(np.nan)
    pred = ((lambda t: t / sc >= m) if ge else (lambda t: t / sc > m))
    with np.errstate(over="ignore"):
        t = F(m * sc)
        if pred(t):
            p = np.nextafter(t, -INF)
            while t > -INF and pred(p):
                t, p = p, np.nextafter(p, -INF)
        else:
            while True:
                if t == INF:
                    return F(np.nan)
                t = np.nextafter(t, INF)
                if pred(t):
                    break
    return t


def _thresholds(mids, ties, sc, slots):
    thr = np.full(slots, INF, F)
    for i, (m, t) in enumerate(zip(mids, ties)):
        thr[i] = _least_x(m, sc, t > 0)
    return thr


def _kernel_codes(x, sc, mids, ties, vals, log_t):
    """The kernel's snap of x (any shape, f32) to table values: thresholds,
    then a binary search (K4) or a count (K3) while they are
    non-decreasing, else the select chain on them; (codes, fast)."""
    x = np.asarray(x, F)
    G = len(vals)
    thr = _thresholds(mids, ties, sc, (1 << log_t) - 1)
    fast = bool(np.all(thr[:G - 2] <= thr[1:G - 1]))
    with np.errstate(invalid="ignore"):
        if fast:
            idx = np.zeros(x.shape, np.int64)
            step = 1 << (log_t - 1)
            while step:
                idx += step * (x >= thr[idx + step - 1])
                step >>= 1
            idx = np.minimum(idx, G - 1)
        else:
            idx = np.zeros(x.shape, np.int64)
            for g in range(G - 1):
                idx = np.where(x >= thr[g], g + 1, idx)
    return np.asarray(vals, F)[idx], fast


def _victims(c):
    v = victim_mask(torch.from_numpy(np.abs(c) > 64), pair_axis=-1).numpy()
    return np.where(v, F(0), c)


def _probe_x(mids, ties, sc, rng, n_rand=512):
    """Every threshold, one ulp either side, each midpoint's image, random
    values at the grid's scale and the special values, as an even-length
    f32 vector."""
    thr = _thresholds(mids, ties, sc, 31)
    thr = thr[np.isfinite(thr)]
    pts = [thr, np.nextafter(thr, -INF), np.nextafter(thr, INF),
           (mids * F(sc)).astype(F),
           (rng.normal(size=n_rand) * 150 * sc).astype(F),
           F([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-30, -1e-30, 3e38])]
    x = np.concatenate(pts).astype(F)
    return x[:len(x) // 2 * 2]


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("sc", PRESCALES)
def test_threshold_snap_equals_the_select_chain(signed, sc):
    mids, ties, enc = _tables(signed)
    rng = np.random.default_rng(int(sc * 1000) + signed)
    x = _probe_x(mids, ties, sc, rng)
    got, fast = _kernel_codes(x, sc, mids, ties, enc, 5)
    assert fast        # the engine's tables keep their thresholds in order
    xs = torch.from_numpy(x) / torch.tensor(F(sc))
    want = tk.aovp_snap_encode(xs, torch.from_numpy(mids),
                               torch.from_numpy(ties),
                               torch.from_numpy(enc)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        _victims(got[None])[0],
        tk.aovp_encode(xs[None], torch.from_numpy(mids),
                       torch.from_numpy(ties), torch.from_numpy(enc))[0])


@pytest.mark.parametrize("sc", [0.25, 0.19])
def test_out_of_order_thresholds_take_the_chain(sc):
    """A repeated midpoint whose tie flags are (0, 1): its thresholds fall
    out of order, so a count (or binary search) would give the earlier
    entry at the midpoint; the kernel runs the chain there instead."""
    mids, ties, enc = _tables(True)
    mids, ties = _skewed(mids, ties)
    rng = np.random.default_rng(3)
    x = _probe_x(mids, ties, sc, rng)
    got, fast = _kernel_codes(x, sc, mids, ties, enc, 5)
    assert not fast
    xs = torch.from_numpy(x) / torch.tensor(F(sc))
    want = tk.aovp_snap_encode(xs, torch.from_numpy(mids),
                               torch.from_numpy(ties),
                               torch.from_numpy(enc)).numpy()
    np.testing.assert_array_equal(got, want)
    if sc == 0.25:     # the midpoint itself survives x / 0.25 exactly
        thr = _thresholds(mids, ties, sc, 31)
        idx = np.minimum((x[:, None] >= thr[None]).sum(1), 31)
        assert not np.array_equal(enc[idx], want)


def _onehot_pallas(x, mids, ties, enc, sc):
    """The Pallas kernel's encoded activations read back through an
    identity int8-value weight: out[m, k] = 16 cx - 15 px, which is one
    to one in the byte."""
    M, K = x.shape
    w = np.eye(K, dtype=np.int8)[None]
    out = jk4(jnp.int32(0), jnp.asarray(x), jnp.asarray(w.reshape(K, K)),
              jnp.ones((1, K), jnp.float32), jnp.asarray(F([sc])),
              jnp.asarray(mids[None]), jnp.asarray(ties[None]),
              jnp.asarray(enc[None]), n_layers=1, w_ovp=False,
              interpret=True)
    return np.asarray(out)


@pytest.mark.parametrize("signed,sc", [(True, 0.19), (False, 3.7)])
def test_threshold_encode_equals_pallas(signed, sc):
    mids, ties, enc = _tables(signed)
    rng = np.random.default_rng(7)
    x = _probe_x(mids, ties, sc, rng, n_rand=1024)
    K = 256
    x = np.concatenate([x, np.zeros(-len(x) % K, F)]).reshape(-1, K)
    codes, fast = _kernel_codes(x, sc, mids, ties, enc, 5)
    assert fast
    c = _victims(codes)
    dec = 16 * c - 15 * np.clip(c, -64, 64)
    np.testing.assert_array_equal(dec, _onehot_pallas(x, mids, ties, enc,
                                                      sc))


def _segments(K, block_k, aovp):
    return tk._check_segments(K, block_k, K if aovp else tk._SUB)


def _emulate(planes, plan, seg, fold, combine, mode="kernel"):
    """The kernel's arithmetic after its dots: split s forms the f32 sums
    of its blocks [s U / splits, (s + 1) U / splits), each a sum of its
    ``fold`` segments' f32 values (``combine`` of a segment's exact int32
    dots) in order; then the blocks' sums are chained in order. Two ways
    it avoids: ``per_split``, each split adding its own blocks first and
    the splits' totals then added; ``cut``, each segment's value formed
    from its two halves, each combined in f32 (what a split that ended
    inside the segment would give)."""
    U, splits = plan["units"], plan["splits"]
    assert U * seg * fold == planes[0][0].shape[1] and splits <= U
    totals = []
    for s in range(splits):
        sums = []
        for u in range(s * U // splits, (s + 1) * U // splits):
            blk = F(0)
            for g in range(u * fold, (u + 1) * fold):
                ks = ([slice(g * seg, g * seg + seg // 2),
                       slice(g * seg + seg // 2, (g + 1) * seg)]
                      if mode == "cut" else [slice(g * seg, (g + 1) * seg)])
                v = None
                for k in ks:
                    d = [a[:, k] @ b[:, k].T for a, b in planes]
                    assert max(np.abs(x).max() for x in d) < 2 ** 31
                    v = combine(d) if v is None else v + combine(d)
                blk = blk + v
            sums.append(blk)
        if mode == "per_split":
            t = F(0)
            for b in sums:
                t = t + b
            sums = [t]
        totals += sums
    acc = F(0)
    for b in totals:
        acc = acc + b
    return acc


def _some_split_holds_two_blocks(plan):
    U, n = plan["units"], plan["splits"]
    return any((s + 1) * U // n - s * U // n > 1 for s in range(n))


def _k4_combine(w_ovp, fma):
    f = lambda d: d.astype(F)
    if fma:
        # XLA:CPU's contraction, emulated exactly in float64: it fuses the
        # first product of 256 d1 - 240 d2 (exact: a power of two times an
        # f32), and the products of the two later steps
        fm = lambda a, b, c: (np.float64(a) * b + np.float64(c)).astype(F)
        if w_ovp:
            return lambda d: fm(225, f(d[3]), fm(-240, f(d[2]), fm(
                256, f(d[0]), -(F(240) * f(d[1])))))
        return lambda d: fm(16, f(d[0]), -(F(15) * f(d[1])))
    if w_ovp:
        return lambda d: (((F(256) * f(d[0]) - F(240) * f(d[1]))
                           - F(240) * f(d[2])) + F(225) * f(d[3]))
    return lambda d: F(16) * f(d[0]) - F(15) * f(d[1])


def _mixed(rng, shape, p_top, top, low):
    """Values drawn from ``top`` with probability p_top, else from
    ``low``: positive, so the sums grow, and irregular, so that their f32
    roundings land in different places in different orders."""
    return np.where(rng.random(shape) < p_top, rng.choice(top, shape),
                    rng.choice(low, shape))


@pytest.mark.parametrize("w_ovp,adversarial,M,K,N,splits", [
    (True, True, 4, 2048, 128, 2), (False, False, 4, 2048, 128, 2),
    (True, True, 64, 4096, 1152, 3)])
def test_k4_split_blocks_equal_plain_and_pallas(w_ovp, adversarial, M, K,
                                                N, splits):
    """K4's segment is its f32 block (1024 rows, eight stages). At M = 64,
    K = 4096 and N = 1152 the plan splits K three ways, into 1, 1 and 2
    blocks."""
    L, l = 1, 0
    rng = np.random.default_rng(N + w_ovp)
    mids, ties, enc = _tables(True)
    sc = F(0.25)
    if adversarial:
        # outliers and the grid's upper normal values against outlier and
        # normal weights: 256 d1 needs 31 bits
        x = _mixed(rng, (M, K), 0.3, F([224, 320, 384]),
                   np.arange(20, 60, dtype=F)) * sc
        w = _mixed(rng, (N, K), 0.7, np.arange(100, 128),
                   np.arange(1, 65)).astype(np.int8)
    else:
        x = (rng.normal(size=(M, K)) * 6).astype(F)
        x[0, :31] = mids * sc
        w = (rng.integers(-127, 128, (N, K)) if w_ovp
             else rng.integers(-64, 65, (N, K))).astype(np.int8)
    x = x.astype(F)
    scales = rng.uniform(1e-3, 3e-3, (L, N)).astype(F)
    seg, fold = _segments(K, 1024, True)
    plan = tk.k34_plan(M, K, N, seg, fold, aovp=True, w_ovp=w_ovp)
    assert (fold, plan["splits"]) == (1, splits)
    codes, fast = _kernel_codes(x, sc, mids, ties, enc, 5)
    assert fast
    cx = _victims(codes).astype(np.int64)
    px = np.clip(cx, -64, 64)
    wl = w.astype(np.int64)
    pw = np.clip(wl, -64, 64)
    planes = (((cx, wl), (cx, pw), (px, wl), (px, pw)) if w_ovp
              else ((cx, wl), (px, wl)))
    got = _emulate(planes, plan, seg, fold, _k4_combine(w_ovp, False))
    want = tk.stacked_quant_matmul_aovp_plain(
        l, torch.from_numpy(x), torch.from_numpy(w[None]),
        torch.from_numpy(scales), torch.tensor([sc]),
        torch.from_numpy(mids[None]), torch.from_numpy(ties[None]),
        torch.from_numpy(enc[None]), w_ovp=w_ovp).numpy()
    np.testing.assert_array_equal(got * scales[l], want)
    if N == 128:
        fused = _emulate(planes, plan, seg, fold, _k4_combine(w_ovp, True))
        pallas = np.asarray(jk4(
            jnp.int32(l), jnp.asarray(x), jnp.asarray(w.T.copy()),
            jnp.asarray(scales), jnp.asarray(F([sc])),
            jnp.asarray(mids[None]), jnp.asarray(ties[None]),
            jnp.asarray(enc[None]), n_layers=L, w_ovp=w_ovp,
            interpret=True))
        np.testing.assert_array_equal(fused * scales[l], pallas)
    if adversarial:
        assert 256 * np.abs(cx[:, :1024] @ wl[:, :1024].T).max() > 2 ** 24
        cut = _emulate(planes, plan, seg, fold, _k4_combine(w_ovp, False),
                       "cut")
        assert not np.array_equal(cut * scales[l], want)


@pytest.mark.parametrize("adversarial,M,K,N,block_k,splits", [
    (True, 4, 2048, 128, 1024, 2), (True, 64, 4096, 1152, 1024, 3),
    (False, 4, 2048, 128, 256, 8)])
def test_k3_split_blocks_equal_plain_and_pallas(adversarial, M, K, N,
                                                block_k, splits):
    """K3's 256-row segments, four to an f32 block at block_k 1024 (one
    at 256): the plan splits K between blocks only."""
    L, l = 1, 0
    rng = np.random.default_rng(N + block_k)
    a_vals = np.round(np.linspace(-96, 127, 16)).astype(F)
    sc = F(0.25)
    if adversarial:
        # the codebook's top against mostly outlier weights: every
        # 256-row segment passes 2^24
        x = rng.uniform(100, 127, (M, K)).astype(F) * sc
        w = _mixed(rng, (N, K), 0.8, np.arange(100, 128),
                   np.arange(1, 65)).astype(np.int8)
    else:
        x = (rng.normal(size=(M, K)) * 10).astype(F)
        x[0, :15] = (a_vals[1:] + a_vals[:-1]) * F(0.5) * sc
        w = rng.integers(-127, 128, (N, K)).astype(np.int8)
    scales = rng.uniform(1e-3, 3e-3, (L, N)).astype(F)
    seg, fold = _segments(K, block_k, False)
    plan = tk.k34_plan(M, K, N, seg, fold, aovp=False)
    assert plan["splits"] == splits
    mids = (a_vals[1:] + a_vals[:-1]) * F(0.5)
    xq, fast = _kernel_codes(x, sc, mids, np.ones(15, np.int32), a_vals, 4)
    assert fast
    xq = xq.astype(np.int64)
    wl = w.astype(np.int64)
    v = 16 * wl - 15 * np.clip(wl, -64, 64)
    f32 = lambda d: d[0].astype(F)
    got = _emulate(((xq, v),), plan, seg, fold, f32)
    want = tk.stacked_quant_matmul_plain(
        l, torch.from_numpy(x), torch.from_numpy(w[None]),
        torch.from_numpy(scales), torch.from_numpy(a_vals[None]),
        torch.tensor([sc]), ovp=True, block_k=block_k).numpy()
    np.testing.assert_array_equal(got * scales[l], want)
    if N == 128:
        pallas = np.asarray(jk3(
            jnp.int32(l), jnp.asarray(x), jnp.asarray(w.T.copy()),
            jnp.asarray(scales), jnp.asarray(a_vals[None]),
            jnp.asarray(F([[sc]])), None, mode="i8", n_layers=L,
            block_k=block_k, ovp=True, interpret=True))
        np.testing.assert_array_equal(got * scales[l], pallas)
    if adversarial:
        assert np.abs(xq[:, :256] @ v[:, :256].T).max() > 2 ** 24
        if _some_split_holds_two_blocks(plan):
            other = _emulate(((xq, v),), plan, seg, fold, f32, "per_split")
            assert not np.array_equal(other * scales[l], want)


@pytest.mark.parametrize("M", [1, 4, 16, 64, 256])
@pytest.mark.parametrize("site", list(_SHAPES))
@pytest.mark.parametrize("aovp", [False, True])
def test_plan_fits_and_fills(site, M, aovp):
    K, N = _SHAPES[site]
    seg, fold = _segments(K, 1024, aovp)
    p = tk.k34_plan(M, K, N, seg, fold, aovp=aovp)
    # two blocks' shared memory fit an SM's 228 KB
    assert 2 * (p["smem"] + 1024) <= 228 * 1024
    assert p["mt"] * p["m_tiles"] >= M and p["mt"] in tk.K34_MT
    assert p["steps"] * tk.K1_STEP == K and p["ss"] * tk.K1_STEP == seg
    # K split only between f32 blocks, each split at least one
    assert p["units"] * seg * fold == K and p["units"] == K // 1024
    assert 1 <= p["splits"] <= p["units"]
    assert p["ws"] == (p["units"] * M * N if p["splits"] > 1 else 0)
    assert p["m_tiles"] * p["n_tiles"] <= tk.K1_COUNTERS
    # the grid fills the card as far as the blocks allow, in one wave of
    # two per SM at decode
    tiles = p["m_tiles"] * p["n_tiles"]
    assert p["blocks"] == tiles * p["splits"]
    assert p["blocks"] >= min(1.4 * tk.K1_SMS, tiles * p["units"]) / 2
    if M <= 8:
        assert p["blocks"] <= 2 * tk.K1_SMS


def test_plan_takes_every_partition_the_wrappers_take():
    """Every (K, block_k) that _check_segments accepts cuts into whole
    stages (or is one short segment) and whole f32 blocks, so k34_plan
    takes it."""
    for K in range(16, 4097, 16):
        for block_k in (128, 256, 512, 1024, 2048):
            for aovp in (False, True):
                try:
                    seg, fold = _segments(K, block_k, aovp)
                except ValueError:
                    continue
                p = tk.k34_plan(4, K, 256, seg, fold, aovp=aovp)
                assert p["units"] * p["ss"] * fold == p["steps"]
