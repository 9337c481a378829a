"""K8's tensor-core plan, checked on the CPU. The kernel
(csrc/qmatmul_w4.cu) multiplies bf16 terms on the tensor cores with f32
sums: the weight grid as the table ``w4_term_plan`` chooses (the grid
itself, its int8 restatement with the unit in the epilogue, or a split into
bf16 terms), x as one bf16 term or, for an f32 x, three (``bf16_terms``),
and only the term products ``w4_products`` lists. Its emulation here (the
same host functions, the same terms, products exact in f32, f32 sums) must
stay within K8's hold, ``K8_RTOL`` of each output's sum of term magnitudes
|x| @ |W| (the hold chip_smoke.py holds the kernel to), of the plain version
and of the Pallas kernel in interpret mode, on grids of all three routes
and on bf16 and full-mantissa f32 x of large and spread magnitudes. With
one term fewer on either side the hold is missed; the lowest terms the
plan keeps carry less than the hold but more than its sixteenth."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ant_quantization_tpu.kernels import qmatmul as jq
from ant_quantization_tpu_torch.kernels import qmatmul as tq
from ant_quantization_tpu_torch.numerics import codebooks as cb

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.torchdep

_K, _N, _M = 512, 96, 24
# (mode, signed): the route w4_term_plan must take, and its term count
_GRIDS = {("flint", True): ("exact", 1), ("pot", False): ("exact", 1),
          ("int", True): ("q16", 1), ("float", False): ("split", 3)}


def _grid(mode, signed):
    return cb.ant_grid(mode, 4, signed).astype(np.float32)


def _emulated(x: torch.Tensor, packed, scale, grid, x_terms=None,
              w_terms=None, skip=()) -> torch.Tensor:
    """K8's arithmetic: x as bf16 terms, the grid as the plan's bf16 table,
    the listed term products each exact in f32 and summed in f32, then
    the unit and the scale. ``x_terms`` / ``w_terms`` keep fewer terms,
    ``skip`` drops listed products."""
    tab, unit, n = tq.w4_term_plan(grid.numpy())
    if x.dtype == torch.bfloat16:
        xs = x.to(torch.float32)[None]
    else:
        xs = tq.bf16_terms(x)
    codes = tq.unpack_w4(packed)                            # (N, K)
    ws = torch.from_numpy(tab)[:, codes]                    # (3, N, K)
    nx = xs.shape[0] if x_terms is None else x_terms
    nw = n if w_terms is None else w_terms
    acc = torch.zeros((x.shape[0], packed.shape[0]), dtype=torch.float32)
    for i, j in tq.w4_products(xs.shape[0])[::-1]:     # the kernel's order
        if i < nx and j < nw and (i, j) not in skip:
            acc = acc + tq.f32_product(xs[i], ws[j])
    return acc * torch.tensor(np.float32(unit)) * scale[None, :]


def _case(mode, signed, dtype, seed):
    """Full-mantissa f32 x whose magnitudes spread over six decades (or
    its bf16 rounding), random packed codes, per-channel scales."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(_M, _K))
         * 10.0 ** rng.uniform(-3, 3, (_M, _K))).astype(np.float32)
    xt = torch.from_numpy(x).to(dtype)
    packed = torch.from_numpy(rng.integers(0, 256, (_N, _K // 2)).astype(
        np.uint8))
    scale = torch.from_numpy(rng.uniform(1e-3, 1e-2, _N).astype(np.float32))
    return xt, packed, scale, torch.from_numpy(_grid(mode, signed))


def _size(x, packed, scale, grid):
    w = tq.dequant_w4_reference(packed, scale, grid).abs().double()
    return x.abs().double() @ w                              # (M, N)


def _miss(got, want, size) -> float:
    """Largest |got - want| in units of the hold, K8_RTOL * size."""
    return float(((got.double() - want.double()).abs()
                  / (tq.K8_RTOL * size)).max())


@pytest.mark.parametrize("grid", list(_GRIDS))
def test_term_plan_routes(grid):
    route, n = _GRIDS[grid]
    g = _grid(*grid)
    tab, unit, got_n = tq.w4_term_plan(g)
    assert got_n == n and tab.dtype == np.float32
    as_bf16 = torch.from_numpy(tab).to(torch.bfloat16).to(torch.float32)
    np.testing.assert_array_equal(as_bf16.numpy(), tab)   # exact in bf16
    assert not np.any(tab[n:])
    want = g.astype(np.float64)
    if route == "q16":
        # the int grid is 10/7 k: bf16 does not hold it, its q16 does
        assert not np.array_equal(torch.from_numpy(g).to(torch.bfloat16)
                                  .to(torch.float32).numpy(), g)
        np.testing.assert_array_equal(tab[0], np.round(tab[0]))
        np.testing.assert_allclose(tab[0] * unit, want, rtol=2.0 ** -22)
    else:
        assert unit == 1.0
        np.testing.assert_array_equal(tab.astype(np.float64).sum(0), want)


def test_products_per_case():
    """The products the kernel issues, for each case of the source note."""
    assert tq.w4_products(1, 1) == [(0, 0)]                 # the engine's
    assert tq.w4_products(3, 1) == [(0, 0), (1, 0), (2, 0)]
    assert tq.w4_products(1, 3) == [(0, 0), (0, 1), (0, 2)]
    assert len(tq.w4_products(3, 3)) == 6
    dropped = [tq.TERM_BOUND[i] * tq.TERM_BOUND[j]
               for i in range(3) for j in range(3)
               if (i, j) not in tq.w4_products(3, 3)]
    assert sum(dropped) < tq.K8_RTOL / 100


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("grid", list(_GRIDS))
def test_emulation_holds_against_plain_and_pallas(grid, dtype):
    x, packed, scale, g = _case(*grid, dtype, seed=list(_GRIDS).index(grid))
    got = _emulated(x, packed, scale, g)
    size = _size(x, packed, scale, g)
    plain = tq.quantized_matmul_w4_plain(x, packed, scale, g)
    assert _miss(got, plain, size) <= 1.0
    jp = jnp.asarray(np.ascontiguousarray(packed.numpy().T))
    want = np.asarray(jq.quantized_matmul_w4(
        jnp.asarray(x.to(torch.float32).numpy()), jp,
        jnp.asarray(scale.numpy()), jnp.asarray(g.numpy()), interpret=True))
    assert _miss(got, torch.from_numpy(np.array(want)), size) <= 1.0


def _aligned_case(seed):
    """The worst case for dropped terms: every x positive with the largest
    lo term a three-term split leaves (x = 1 + 2^-9 + 2^-17 - 2^-23: hi 1,
    mid 2^-9, lo just under 2^-17), every weight positive."""
    rng = np.random.default_rng(seed)
    base = np.float32(1 + 2.0 ** -9 + 2.0 ** -17 - 2.0 ** -23)
    x = torch.from_numpy(np.full((_M, _K), base, np.float32)
                         * rng.choice([1.0, 2.0, 4.0], (_M, _K)).astype(
                             np.float32))
    packed = torch.from_numpy(rng.integers(0x99, 0x100, (_N, _K // 2))
                              .astype(np.uint8) | np.uint8(0x88))
    scale = torch.from_numpy(rng.uniform(1e-3, 1e-2, _N).astype(np.float32))
    return x, packed, scale


def test_one_term_fewer_misses_the_hold():
    """An f32 x as one bf16 term (hi only), and a split grid as one term,
    miss the hold by far: what the plan adds above them is needed."""
    x, packed, scale, g = _case("flint", True, torch.float32, seed=3)
    plain = tq.quantized_matmul_w4_plain(x, packed, scale, g)
    size = _size(x, packed, scale, g)
    assert _miss(_emulated(x, packed, scale, g, x_terms=1), plain,
                 size) > 10
    xb, packed, scale, g = _case("float", False, torch.bfloat16, seed=4)
    plain = tq.quantized_matmul_w4_plain(xb, packed, scale, g)
    size = _size(xb, packed, scale, g)
    assert _miss(_emulated(xb, packed, scale, g, w_terms=1), plain,
                 size) > 10


def test_lo_terms_carry_more_than_a_sixteenth_of_the_hold():
    """The plan keeps x's lo term (and a split grid's): alone it can reach
    2^-17 of the term-magnitude sum, under the hold (1e-5) but far above
    the 1/16 the plan leaves to dropped products. On aligned inputs
    dropping it moves the result by more than that sixteenth."""
    x, packed, scale = _aligned_case(5)
    g = torch.from_numpy(_grid("flint", True))
    size = _size(x, packed, scale, g)
    full = _emulated(x, packed, scale, g)
    no_lo = _emulated(x, packed, scale, g, skip={(2, 0)})
    share = _miss(no_lo, full, size) * tq.K8_RTOL
    assert 1 / 16 < share / tq.K8_RTOL < 1
    # its bound, 2^-17, up to the rounding of the two f32 sums compared
    assert share <= tq.TERM_BOUND[2] * 1.02
    plain = tq.quantized_matmul_w4_plain(x, packed, scale, g)
    assert _miss(full, plain, size) <= 1.0
