"""F5 (ROADMAP Queue 3): the padded operands that let the decode and
prefill kernels take any K, checked on the CPU through the plain versions
(the kernels themselves run on the card, where ``chip_smoke.py`` holds
them bit-equal to these plain versions at K = 196):

- K1 and K5's int8 mode: x and the weight stack zero-padded at the end of
  K (to 16 and 64), the same product bit for bit;
- K6: each packed half of K padded to 16 bytes, x's halves with zeros and
  the weight's bytes with each layer's code of 0, the same product bit
  for bit (affine and table decode);
- K3's and K4's segment layout (``ovp_layout``): the identity for the
  presets' K; elsewhere every reference segment at its own padded place,
  in order, OVP pairs whole; the padded stack made once per layout;
- the card-side wrappers hand those operands to their launches;
- F9: K8's operands with each packed half of K padded to 16 bytes (x's
  halves with zeros, the packed rows with zero bytes), within K8's
  tolerance of the unpadded product, the padded stack made once; K9's x
  and weight zero-padded along K (to 16, 64 above 64 rows), bit for bit;
  and their card-side wrappers launch on the padded operands.
"""

import numpy as np
import pytest
import torch

from ant_quantization_tpu_torch.kernels import qmatmul as tq
from ant_quantization_tpu_torch.kernels import stacked as tk
from ant_quantization_tpu_torch.kernels.qmatmul import (int8_codebook,
                                                        pack_w4)
from ant_quantization_tpu_torch.numerics import codebooks as cb

pytestmark = pytest.mark.torchdep


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tensors are tiny, and the suite's
    workers share the host's cores (many threads each spin on them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _k1_operands(M, K, N, L=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    aq16, _, _ = int8_codebook(cb.ant_grid("flint", 4, False))
    a_q = torch.tensor(np.stack([aq16] * L).astype(np.float32))
    a_scale = torch.full((L,), 0.25)
    w = torch.randint(-64, 64, (L, N, K), dtype=torch.int8, generator=g)
    scales = torch.rand((L, N), generator=g) * 1e-3
    x = torch.randn((M, K), generator=g) * 2
    return x, w, scales, a_q, a_scale


@pytest.mark.parametrize("M,K,quantum", [(4, 196, 16), (300, 196, 64),
                                         (3, 1000, 16)])
def test_end_padding_keeps_k1_and_k5(M, K, quantum):
    x, w, sc, aq, asc = _k1_operands(M, K, 24)
    xp, wp = tk._end_padded(x, w, quantum)
    assert xp.shape[1] % quantum == 0 and wp.shape[2] == xp.shape[1]
    assert tk._end_padded(x, w, quantum)[1] is wp          # made once
    want = tk.stacked_quant_matmul_plain(1, x, w, sc, aq, asc)
    got = tk.stacked_quant_matmul_plain(1, xp, wp, sc, aq, asc)
    assert torch.equal(got, want)


@pytest.mark.parametrize("affine", [True, False])
def test_p4_padding_keeps_k6(affine):
    M, K, N, L = 4, 196, 24, 2
    g = torch.Generator().manual_seed(1)
    x, _, sc, aq, asc = _k1_operands(M, K, N, L)
    grid = cb.ant_grid("int" if affine else "flint", 4, True)
    q16, _, _ = int8_codebook(grid)
    q16 = torch.tensor(np.stack([q16] * L).astype(np.int32))
    codes = torch.randint(0, 16, (L, K, N), generator=g)
    w = torch.stack([pack_w4(codes[i]) for i in range(L)])    # (L, N, 98)
    xp, wp = tk._p4_padded(x, w, q16, affine)
    assert wp.shape[2] == 112 and xp.shape[1] == 224
    want = tk.stacked_quant_matmul_p4_plain(1, x, w, sc, aq, asc, q16,
                                            affine)
    got = tk.stacked_quant_matmul_p4_plain(1, xp, wp, sc, aq, asc, q16,
                                           affine)
    assert torch.equal(got, want)


@pytest.mark.parametrize("K,block_k,sub", [
    (196, 1024, tk._SUB), (640, 1024, tk._SUB), (1220, 1024, tk._SUB),
    (196, 1024, 196), (3072, 1024, 3072), (6144, 1024, tk._SUB),
    (4096, 1024, tk._SUB), (16384, 1024, 16384)])
def test_ovp_layout(K, block_k, sub):
    seg, fold, dst = tk.ovp_layout(K, block_k, sub)
    bk = tk._fit(K, block_k)
    if K % 1024 == 0:
        assert dst is None            # presets: the native segments
        return
    assert dst is not None and seg % 128 == 0
    d = dst.numpy()
    k_pad = (K // bk) * fold * seg
    assert len(np.unique(d)) == K and d.max() < k_pad
    assert np.all(np.diff(d) > 0)                  # the order is kept
    assert np.all(d[0::2] % 2 == 0) and np.all(d[1::2] == d[0::2] + 1)
    step = min(bk, sub)
    for j in range(0, K, 97):                       # segment of each row
        b, r = divmod(j, bk)
        assert d[j] // seg == b * fold + r // step


def test_card_wrappers_take_the_padded_operands(monkeypatch):
    """The CUDA branch of each wrapper (a tensor that reports
    ``is_cuda``, the launches recorded instead of run) at K = 196: K1 gets
    K 208, K5 256, K3 and K4 the segment layout, K6 112 bytes a half."""
    seen = {}
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    def record(key):
        return lambda l, x, w, *a: seen.setdefault(
            key(x, a), (x.shape, w.shape, a[-1]))

    monkeypatch.setattr(tk, "_launch", record(
        lambda x, a: ("K3" if a[-2] else "K1", x.shape[0])))
    monkeypatch.setattr(tk, "_launch_aovp", record(lambda x, a: "K4"))
    monkeypatch.setattr(tk, "_launch_p4", record(lambda x, a: "K6"))
    K, N = 196, 24
    for M in (4, 300):
        x, w, sc, aq, asc = _k1_operands(M, K, N)
        for ovp in (False, True):
            tk.stacked_quant_matmul(1, x, w, sc, aq, asc, ovp=ovp)
    tk.stacked_quant_matmul_aovp(1, x[:4], w, sc, asc, aq[:, 1:], aq[:, 1:],
                                 aq)
    q16 = torch.tensor(np.stack([int8_codebook(cb.ant_grid("int", 4, True))
                                 [0]] * 2).astype(np.int32))
    tk.stacked_quant_matmul_p4(1, x[:4], w[:, :, :98].view(torch.uint8), sc,
                               aq, asc, q16, affine=True)
    assert seen[("K1", 4)] == ((4, 208), (2, N, 208), None)
    assert seen[("K1", 300)] == ((300, 256), (2, N, 256), None)
    for m in (4, 300):
        assert seen[("K3", m)] == ((m, 256), (2, N, 256), (256, 1))
    assert seen["K4"] == ((4, 256), (2, N, 256), 256)
    assert seen["K6"][:2] == ((4, 224), (2, N, 112))


def _w4_stack(K, N, L=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    codes = torch.randint(0, 16, (L, K, N), generator=g)
    return torch.stack([pack_w4(codes[i]) for i in range(L)])


@pytest.mark.parametrize("K,dtype", [(196, torch.float32),
                                     (196, torch.bfloat16),
                                     (2, torch.float32)])
def test_w4_padding_keeps_k8(K, dtype):
    """K8 at K/2 = 98 (and 1): the padded operands through the plain
    version within K8_RTOL of each output's term magnitudes |x| @ |W| of
    the unpadded product; a layer of a stack pads the stack once."""
    N = 24
    stack = _w4_stack(K, N)
    grid = torch.tensor(cb.ant_grid("flint", 4, True), dtype=torch.float32)
    scale = torch.rand((N,), generator=torch.Generator().manual_seed(1))
    x = torch.randn((5, K), generator=torch.Generator().manual_seed(2))
    x = x.to(dtype)
    xp, wp = tq.w4_padded(x, stack[1])
    h_pad = -(-K // 32) * 16
    assert xp.shape == (5, 2 * h_pad) and wp.shape == (N, h_pad)
    assert torch.equal(wp[:, :K // 2], stack[1])
    assert not wp[:, K // 2:].any()
    assert tq.w4_padded(x, stack[0])[1]._base is wp._base  # made once
    want = tq.quantized_matmul_w4_plain(x, stack[1], scale, grid)
    got = tq.quantized_matmul_w4_plain(xp, wp, scale, grid)
    wv = tq.dequant_w4_reference(stack[1], scale, grid).abs()
    size = tq.f32_product(x.abs(), wv.t())
    assert ((got - want).abs() <= tq.K8_RTOL * size).all()


@pytest.mark.parametrize("M,K,quantum", [(4, 196, 16), (300, 196, 64),
                                         (3, 1000, 16), (64, 100, 16)])
def test_w8a8_padding_keeps_k9(M, K, quantum):
    """K9 at K off its quantum: the padded x and weight through the plain
    version bit-equal to the unpadded product; a layer of a stack pads
    the stack once."""
    x, w, _, _, _ = _k1_operands(M, K, 24)
    aq16, _, _ = int8_codebook(cb.ant_grid("flint", 4, True))
    a_q = torch.tensor(np.sort(aq16).astype(np.float32))
    a_scale = torch.tensor(0.19)
    osc = torch.rand((24,), generator=torch.Generator().manual_seed(3))
    xp, wp = tq.w8a8_padded(x, w[1])
    assert xp.shape[1] % quantum == 0 and wp.shape == (24, xp.shape[1])
    assert not xp[:, K:].any() and not wp[:, K:].any()
    assert tq.w8a8_padded(x, w[0])[1]._base is wp._base     # made once
    want = tq.fused_w8a8_matmul_plain(x, w[1], a_q, a_scale, osc)
    got = tq.fused_w8a8_matmul_plain(xp, wp, a_q, a_scale, osc)
    assert torch.equal(got, want)


class _Entry:
    """A stand-in C entry point: records its arguments, returns 0."""

    def __init__(self, calls):
        self.calls, self.argtypes = calls, None

    def __call__(self, *args):
        assert len(args) == len(self.argtypes)
        self.calls.append(args)
        return 0


def test_k8_k9_card_wrappers_take_the_padded_operands(monkeypatch):
    """The CUDA branch of K8's and K9's wrappers (tensors that report
    ``is_cuda``, a stand-in library that records the launch) at K = 196:
    K8 launches at K 224 (halves of 112 bytes), K9 at K 208 (M 4) and 256
    (M 300), N as given, one launch each."""
    calls = {"w4": [], "w8a8": []}
    lib = type("Lib", (), {})()
    lib.w4_bf16_matmul = _Entry(calls["w4"])
    lib.w8a8_matmul = _Entry(calls["w8a8"])
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(tq._ext, "load", lambda src: lib)
    monkeypatch.setattr(tq._ext, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(tk._ext, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(tk, "_SPLIT_WS", {})    # K9's split-K workspace
    K, N = 196, 24
    stack = _w4_stack(K, N)
    grid = torch.tensor(cb.ant_grid("flint", 4, True), dtype=torch.float32)
    tab, unit, _ = tq.w4_term_plan(grid.numpy())
    x = torch.randn((300, K), generator=torch.Generator().manual_seed(4))
    tq.quantized_matmul_w4(x.to(torch.bfloat16), stack[1], torch.ones(N),
                           grid, torch.tensor(tab), torch.tensor([unit]))
    (args,) = calls["w4"]
    assert args[7:10] == (300, 224, N)
    assert args[2] == tq.w4_padded(x, stack[1])[1].data_ptr()
    aq16, _, _ = int8_codebook(cb.ant_grid("flint", 4, True))
    w = torch.randint(-64, 64, (2, N, K), dtype=torch.int8)
    for M, k_pad in ((4, 208), (300, 256)):
        tq.fused_w8a8_matmul(x[:M], w[1], torch.tensor(aq16.astype(
            np.float32)), torch.tensor(0.19), torch.ones(N))
        args = calls["w8a8"].pop()
        assert args[9:12] == (M, k_pad, N)
