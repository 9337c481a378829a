"""PyTorch port vs the JAX reference: K3 (the OVP dual dot of
stacked_quant_matmul) and K4 (stacked_quant_matmul_aovp), plain versions
(the CPU path of kernels/stacked.py) against the Pallas kernels in
interpret mode, including inputs whose int32 sums pass 2^24, where the
order of the f32 steps decides the result.

K3 is bit-equal: its f32 steps are additions only. K4's block combine
((256 d1 - 240 d2) - 240 d3) + 225 d4 is written as separate roundings,
and the port's kernel and plain version keep them so; XLA's CPU backend
contracts it into the FMA chain fma(225, d4, fma(-240, d3, fma(-240, d2,
256 d1))). So the K4 test checks two things: the port's encode, victims
and exact dots, combined with that FMA chain, give the reference's result
bit for bit; and the port's own result lies within the rounding of the
unfused steps of it: 16 ulp of the sum of the terms' magnitudes, times
the scale (each block rounds at most 9 times between the two forms, each
time by at most half an ulp of a value no larger than that sum).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ant_quantization_tpu.kernels.stacked import stacked_quant_matmul as jk
from ant_quantization_tpu.kernels.stacked import (
    stacked_quant_matmul_aovp as jk4)
from ant_quantization_tpu.serve.engine import _aovp_encode_tables as jtables
from ant_quantization_tpu_torch.kernels import stacked as tk
from ant_quantization_tpu_torch.kernels.qmatmul import ovp_unit
from ant_quantization_tpu_torch.numerics import codebooks as cb

pytestmark = pytest.mark.torchdep

_OVP_BYTES = np.array([-127, -100, -70, -65, -64, -33, -8, -2, 0, 2, 8, 33,
                       64, 65, 70, 100, 127], np.int8)


def _nk(w):
    """(L, K, N) reference stack -> the port's (L, N, K)."""
    return torch.from_numpy(np.ascontiguousarray(w.transpose(0, 2, 1)))


def _k3_case(M, K, adversarial, rng):
    L, N = 2, 128
    a_vals = np.round(np.linspace(-96, 127, 16)).astype(np.float32)
    a_q = np.stack([a_vals, a_vals])
    a_scale = np.float32([0.5, 0.25])     # powers of two keep ties exact
    if adversarial:
        # all-outlier columns against activations at the codebook's top:
        # every 256-row sub-chunk sum passes 2^24 (up to 127*1072*256)
        w = rng.choice(np.array([100, 110, 120, 127], np.int8),
                       size=(L, K, N))
        x = np.full((M, K), 127 * 0.25, np.float32)
        x[:, ::7] *= -0.5
    else:
        w = rng.choice(_OVP_BYTES, size=(L, K, N))
        x = rng.normal(size=(M, K)).astype(np.float32) * 10
        mids = (a_q[1, 1:] + a_q[1, :-1]) * np.float32(0.5)
        x[0, :mids.shape[0]] = mids * a_scale[1]      # exact midpoint ties
    scales = rng.uniform(1e-3, 3e-3, (L, N)).astype(np.float32)
    return L, N, a_q, a_scale, w, x, scales


@pytest.mark.parametrize("M,K,adversarial,block_k", [
    (3, 512, False, 1024), (8, 2048, False, 1024), (4, 2048, True, 1024),
    (4, 1024, False, 256)])
def test_k3_plain_bit_equal_to_pallas(M, K, adversarial, block_k):
    rng = np.random.default_rng(M + K)
    L, N, a_q, a_scale, w, x, scales = _k3_case(M, K, adversarial, rng)
    l = 1
    want = np.asarray(jk(
        jnp.int32(l), jnp.asarray(x), jnp.asarray(w.reshape(L * K, N)),
        jnp.asarray(scales), jnp.asarray(a_q), jnp.asarray(a_scale[:, None]),
        None, mode="i8", n_layers=L, block_k=block_k, ovp=True,
        interpret=True))
    before = dict(tk.K3_COUNTS)
    got = tk.stacked_quant_matmul(
        l, torch.from_numpy(x), _nk(w), torch.from_numpy(scales),
        torch.from_numpy(a_q), torch.from_numpy(a_scale), ovp=True,
        block_k=block_k).numpy()
    np.testing.assert_array_equal(got, want)
    assert tk.K3_COUNTS["plain_calls"] == before["plain_calls"] + 1
    assert tk.K3_COUNTS["launches"] == before["launches"]
    if adversarial:
        # the f32 order is really tested: sub-chunk sums pass 2^24, and
        # one rounding of the exact sum gives another result
        xq = tk.snap_value(torch.from_numpy(x) / a_scale[l],
                           torch.from_numpy(a_q[l])).numpy().astype(np.int64)
        vals = 16 * w[l].astype(np.int64) - 15 * np.clip(w[l], -64, 64)
        assert np.abs(xq[:, :256] @ vals[:256]).max() > 2 ** 24
        once = (xq @ vals).astype(np.float32) * scales[l]
        assert not np.array_equal(got, once)


def _tables(signed, L):
    grid = cb.olive_grid("flint", 4, signed)
    out = cb.olive_outlier_values(4, signed)
    pad = lambda a: np.pad(a, (0, 16 - a.shape[0]), mode="edge")
    a_grid, a_out = pad(grid).astype(np.float32), pad(out).astype(np.float32)
    u_a, exact = ovp_unit(a_grid, a_out)
    assert exact and u_a == 0.5
    tbl = {k: np.asarray(v) for k, v in jtables(a_grid, a_out, u_a).items()}
    tile = lambda a: np.stack([a] * L)
    return a_grid, a_out, u_a, tile(tbl["aovp_mids"]), \
        tile(tbl["aovp_ties"]), tile(tbl["aovp_enc"])


@pytest.mark.parametrize("w_ovp", [False, True])
@pytest.mark.parametrize("M,K,signed,adversarial", [
    (4, 256, True, False), (8, 2048, False, False), (4, 2048, True, True)])
def test_k4_plain_bit_equal_to_pallas(w_ovp, M, K, signed, adversarial):
    L, N, l = 2, 128, 1
    rng = np.random.default_rng(K + M + int(w_ovp))
    a_grid, a_out, u_a, mids, ties, enc = _tables(signed, L)
    prescale = np.float32([0.125, 0.25])          # exact ties survive x/p
    if adversarial:
        # every activation an outlier at the top (victims halve them),
        # against all-outlier weight columns: 240*d2 needs 31 bits
        x = np.full((M, K), 384 * 0.25, np.float32)
        x[:, 1::4] = -x[:, 1::4]
        w = rng.choice(np.array([100, 120, 127], np.int8), size=(L, K, N))
    else:
        x = rng.normal(size=(M, K)).astype(np.float32) * 8
        # exact concat midpoints (every tie flag, the padded duplicates)
        # and both members of outlier pairs
        x[0, :31] = mids[l] * prescale[l]
        x[1, :64:2] = 300 * prescale[l]
        x[1, 1:64:2] = -200 * prescale[l]
        w = (rng.choice(_OVP_BYTES, size=(L, K, N)) if w_ovp
             else rng.integers(-64, 65, (L, K, N)).astype(np.int8))
    if not signed:
        x = np.abs(x)
    scales = rng.uniform(1e-3, 3e-3, (L, N)).astype(np.float32)
    want = np.asarray(jk4(
        jnp.int32(l), jnp.asarray(x), jnp.asarray(w.reshape(L * K, N)),
        jnp.asarray(scales), jnp.asarray(prescale), jnp.asarray(mids),
        jnp.asarray(ties), jnp.asarray(enc), n_layers=L, w_ovp=w_ovp,
        interpret=True))
    before = dict(tk.K4_COUNTS)
    got = tk.stacked_quant_matmul_aovp(
        l, torch.from_numpy(x), _nk(w), torch.from_numpy(scales),
        torch.from_numpy(prescale), torch.from_numpy(mids),
        torch.from_numpy(ties), torch.from_numpy(enc), w_ovp=w_ovp).numpy()
    assert tk.K4_COUNTS["plain_calls"] == before["plain_calls"] + 1
    assert tk.K4_COUNTS["launches"] == before["launches"]
    # blocks of the reference's default block_k
    fused, size = _k4_fused(x, w, l, prescale, mids, ties, enc, scales,
                            w_ovp, min(K, 1024))
    np.testing.assert_array_equal(fused, want)
    tol = 16 * 2.0 ** -23 * size * scales[l]
    assert (np.abs(got.astype(np.float64) - want) <= tol).all()


def _k4_fused(x, w, l, prescale, mids, ties, enc, scales, w_ovp, bk):
    """K4 from the port's encode and exact int dots, combined with the
    FMA chain of XLA:CPU (emulated exactly in float64: every operand is
    an integer below 2^53), and the sum of the terms' magnitudes."""
    f32 = np.float32
    fma = lambda a, b, c: (np.float64(a) * b + np.float64(c)).astype(f32)
    cxf = tk.aovp_encode(torch.from_numpy(x) / prescale[l],
                         torch.from_numpy(mids[l]), torch.from_numpy(ties[l]),
                         torch.from_numpy(enc[l])).numpy()
    cx = cxf.astype(np.int64)
    px = np.clip(cxf, -64, 64).astype(np.int64)
    wl = w[l].astype(np.int64)
    pw = np.clip(wl, -64, 64)
    acc, size = None, 0.0
    for k0 in range(0, x.shape[1], bk):
        s = slice(k0, k0 + bk)
        if w_ovp:
            d = [(a[:, s] @ b[s]).astype(f32)
                 for a, b in ((cx, wl), (cx, pw), (px, wl), (px, pw))]
            part = fma(225, d[3], fma(-240, d[2], fma(-240, d[1],
                                                      f32(256) * d[0])))
            coef = (256, 240, 240, 225)
        else:
            d = [(a[:, s] @ wl[s]).astype(f32) for a in (cx, px)]
            part = fma(-15, d[1], f32(16) * d[0])
            coef = (16, 15)
        acc = part if acc is None else acc + part
        size = size + sum(c * np.abs(v.astype(np.float64))
                          for c, v in zip(coef, d))
    return acc * scales[l], size


def test_kernels_refuse_partitions_they_cannot_cut():
    x = torch.zeros(2, 640)
    w = torch.zeros(1, 8, 640, dtype=torch.int8)
    sc = torch.ones(1, 8)
    with pytest.raises(ValueError, match="equal segments"):
        tk.stacked_quant_matmul(0, x, w, sc, torch.zeros(1, 16),
                                torch.ones(1), ovp=True)
