"""K1's staged split-K weight stream (csrc/i8_stream.cuh), checked on the
CPU where it does not run:

- its launch plan (``kernels/stacked.py:k1_plan``) at every engine site
  shape (OPT-6.7B's 4096 x 4096, 4096 x 16384 and 16384 x 4096, BLOOM-7b1's
  fused qkv at N = 12,288) and M 1, 4, 64 and 256: a block's shared memory
  (its ring and the x codes of two stages) fits twice on an SM, the K
  splits cut K into whole stages the kernel streams, and the grid fills
  the card (at decode, one wave of about two blocks per SM);
- why the split partial sums meet as int32: their exact sum times the
  scale is the plain version bit for bit, a multiply per partial is not;
- the snap by thresholds on x: the least f32 x whose quotient by a_scale
  (or product with 1 / a_scale, K9's order) reaches a midpoint, found by
  the same division, decides every element as the division does, exact
  ties and their neighbours included (an emulation of the kernel's
  search in numpy float32)."""

import numpy as np
import pytest
import torch

from ant_quantization_tpu_torch.kernels import stacked as tk
from ant_quantization_tpu_torch.kernels.qmatmul import int8_codebook
from ant_quantization_tpu_torch.numerics import codebooks as cb
from ant_quantization_tpu_torch.ops.snap import snap_value

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.torchdep

_SHAPES = {"opt q/k/v/out": (4096, 4096), "opt fc_in": (4096, 16384),
           "opt fc_out": (16384, 4096), "bloom qkv": (4096, 12288)}


@pytest.mark.parametrize("M", [1, 4, 64, 256])
@pytest.mark.parametrize("site", list(_SHAPES))
def test_plan_fits_and_fills(site, M):
    K, N = _SHAPES[site]
    p = tk.k1_plan(M, K, N)
    step = tk.K1_STEP
    # two blocks' shared memory (x codes of two stages included) fit the
    # 228 KB of an SM; one block's the 227 KB a block may use
    assert 2 * (p["smem"] + 1024) <= 228 * 1024
    assert p["mt"] * p["m_tiles"] >= M and p["mt"] in tk.K1_MT
    # the kernel's split s covers stages [s * steps // splits, ...)
    bounds = [s * p["steps"] // p["splits"] for s in range(p["splits"] + 1)]
    assert bounds[0] == 0 and bounds[-1] == p["steps"]
    assert all(b1 > b0 for b0, b1 in zip(bounds, bounds[1:]))
    assert p["steps"] * step >= K > (p["steps"] - 1) * step
    assert step == 128               # one 128-byte-wide TMA box
    assert p["blocks"] >= 1.4 * tk.K1_SMS
    if M <= 16:                       # decode: one wave of two per SM
        assert p["blocks"] <= 2 * tk.K1_SMS


def test_split_partials_meet_as_int32():
    """At a plan that splits K 32 ways, the int32 partial sums added
    exactly and then multiplied once equal the plain version bit for bit;
    multiplying each partial and adding in f32 does not."""
    rng = np.random.default_rng(0)
    M, K, N = 4, 4096, 512
    p = tk.k1_plan(M, K, N)
    assert p["splits"] == 32
    step = tk.K1_STEP
    aq16, _, _ = int8_codebook(cb.ant_grid("flint", 4, False))
    a_q = torch.tensor(aq16.astype(np.float32))[None]
    a_scale = torch.tensor([0.25])
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32) * 2)
    w = torch.from_numpy(rng.integers(-64, 64, (1, N, K)).astype(np.int8))
    scales = torch.from_numpy(rng.uniform(1e-4, 1e-3, (1, N)).astype(
        np.float32))
    want = tk.stacked_quant_matmul_plain(0, x, w, scales, a_q, a_scale)
    xq = snap_value(x / a_scale[0], a_q[0]).to(torch.int64)
    parts = []
    for s in range(p["splits"]):
        k0 = s * p["steps"] // p["splits"] * step
        k1 = min((s + 1) * p["steps"] // p["splits"] * step, K)
        parts.append(xq[:, k0:k1] @ w[0, :, k0:k1].to(torch.int64).t())
    exact = torch.stack(parts).sum(0)
    assert exact.abs().max() < 2 ** 31
    got = exact.to(torch.int32).to(torch.float32) * scales[0]
    assert torch.equal(got, want)
    per_part = sum(q.to(torch.float32) * scales[0] for q in parts)
    assert not torch.equal(per_part, want)


def _thresholds(aq: np.ndarray, sc: np.float32, recip: bool) -> np.ndarray:
    """The kernel's search, in float32: for each midpoint m the least x
    with q(x) >= m, q(x) = x / sc (or x * (1 / sc)); start from m's image
    and step one ulp at a time."""
    inv = np.float32(1) / sc
    q = (lambda v: v * inv) if recip else (lambda v: v / sc)
    out = []
    for m in (aq[:-1] + aq[1:]) * np.float32(0.5):
        t = m / inv if recip else m * sc
        if q(t) >= m:
            p = np.nextafter(t, np.float32(-np.inf))
            while q(p) >= m:
                t, p = p, np.nextafter(p, np.float32(-np.inf))
        else:
            t = np.nextafter(t, np.float32(np.inf))
            while not q(t) >= m:
                t = np.nextafter(t, np.float32(np.inf))
        out.append(np.float32(t))
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("recip", [False, True])
@pytest.mark.parametrize("sc", [0.25, 0.19, 0.0123456, 3.7])
def test_threshold_snap_equals_division(sc, recip):
    aq16, _, _ = int8_codebook(cb.ant_grid("flint", 4, False))
    aq = aq16.astype(np.float32)
    sc = np.float32(sc)
    thr = _thresholds(aq, sc, recip)
    mids = (aq[:-1] + aq[1:]) * np.float32(0.5)
    rng = np.random.default_rng(1)
    # every midpoint's image, its neighbours by up to 3 ulps, random values
    edge = np.concatenate([mids / (np.float32(1) / sc) if recip
                           else mids * sc, thr])
    near = [edge]
    for d in (1, 2, 3):
        up, down = edge.copy(), edge.copy()
        for _ in range(d):
            up = np.nextafter(up, np.float32(np.inf))
            down = np.nextafter(down, np.float32(-np.inf))
        near += [up, down]
    x = np.concatenate(near + [
        (rng.normal(size=4096) * 4 * aq.max() * sc).astype(np.float32),
        np.float32([0.0, -0.0, np.inf, -np.inf, np.nan])]).astype(np.float32)
    inv = np.float32(1) / sc
    with np.errstate(invalid="ignore"):
        q = x * inv if recip else x / sc
        by_div = (q[:, None] >= mids[None]).sum(1)
        by_thr = np.minimum((x[:, None] >= thr[None]).sum(1), len(aq) - 1)
    np.testing.assert_array_equal(by_thr, by_div)
