"""K2 and K7 on a CUDA card against their plain versions, at head_dims
beside the engine paths' 64, 80 and 128: 16 (the reference's flagship),
96 (BLOOM-1b1) and 256 (the widest the kernels are built for) at their
widths, and 33, 36 and 40, below their widths of 64, whose cache rows are
copied 1, 4 and 8 bytes at a time; the split pass (T 1) and the prefill
kernel (T 17), bf16 and f32, one launch a call, within atol 2e-2 + rtol
1e-2 (bf16 output) and atol 1e-4 (f32), ``K2_TOL`` of chip_smoke.py.

These need the card and nvcc, and skip without a CUDA device. This file
imports no JAX. On the card's machine (where JAX is absent, so without
the suite's conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_attention_card.py
"""

import numpy as np
import pytest
import torch

from ant_quantization_tpu_torch.kernels import attention as tk

pytestmark = pytest.mark.cuda

_TOL = {torch.bfloat16: (2e-2, 1e-2), torch.float32: (1e-4, 0.0)}
_L, _B, _H, _S = 2, 2, 3, 300


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run there")
    return torch.device("cuda")


@pytest.mark.parametrize("kernel", ["K2", "K7"])
@pytest.mark.parametrize("T", [1, 17])
@pytest.mark.parametrize("D", [16, 96, 256, 33, 36, 40])
def test_kernel_matches_plain(card, D, T, kernel):
    g = torch.Generator(device=card)
    g.manual_seed(1000 * D + T)
    codes = lambda: torch.randint(-127, 128, (_L, _B, _H, _S, D),
                                  dtype=torch.int8, device=card, generator=g)
    scales = lambda: torch.rand((_L, _B, _H, _S), device=card,
                                generator=g) * 0.02
    k, v, ks, vs = codes(), codes(), scales(), scales()
    pos0 = torch.tensor([0, _S - T], dtype=torch.int32, device=card)
    slopes = torch.tensor(np.float32([0.5, 0.25, 0.0625]), device=card)
    if kernel == "K2":
        fn, plain, counts = (
            lambda *a, **kw: tk.stacked_int8_kv_attention(1, *a, **kw),
            lambda *a, **kw: tk.stacked_int8_kv_attention_plain(1, *a,
                                                                **kw),
            tk.COUNTS)
        cache = (k, v, ks, vs)
    else:
        fn, plain, counts = (tk.int8_kv_attention, tk.int8_kv_attention_plain,
                             tk.K7_COUNTS)
        cache = (k[1], v[1], ks[1], vs[1])
    for dt, sl in ((torch.bfloat16, slopes), (torch.float32, None)):
        q = torch.randn((_B, _H, T, D), device=card, generator=g).to(dt)
        before = counts["launches"]
        got = fn(q, *cache, pos0, sl, out_dtype=dt)
        assert counts["launches"] == before + 1
        want = plain(q, *cache, pos0, sl, out_dtype=dt)
        torch.cuda.synchronize()
        atol, rtol = _TOL[dt]
        assert got.shape == want.shape and got.dtype == dt
        assert bool(torch.isfinite(got).all())
        err = (got.float() - want.float()).abs()
        assert bool((err <= atol + rtol * want.float().abs()).all()), \
            float(err.max())
