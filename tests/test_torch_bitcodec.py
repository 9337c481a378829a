"""PyTorch port vs the JAX reference: ``numerics/bitcodec.py``, bit for
bit — the flint codeword tables, OVP pair packing with its little-endian
sideband, and the engine checkpoint codec ``pack_w4_stack`` /
``unpack_w4_stack`` on ANT stacks and on OVP stacks from the port's
``quantize_weights_ovp_i8`` along both pair axes (OPT/BLOOM sites pair
along K, GPT-2's Conv1D sites along N). The reference takes (L, K, N)
stacks, the port its N-major (L, N, K) ``w_i8``; the stored arrays are
the same."""

import numpy as np
import pytest
import torch

from ant_quantization_tpu.numerics import bitcodec as jbc
from ant_quantization_tpu_torch.kernels import qmatmul as tq
from ant_quantization_tpu_torch.numerics import bitcodec as tbc
from ant_quantization_tpu_torch.numerics import codebooks as cb

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.torchdep


def _pad(a, size=256):
    return np.pad(np.asarray(a, np.float32), (0, size - len(a)),
                  mode="edge")


@pytest.mark.parametrize("bit,signed", [(3, True), (4, True), (4, False),
                                        (5, True), (6, False), (8, True)])
def test_flint_tables_equal_reference(bit, signed):
    assert tbc.flint_codewords(bit, signed) == jbc.flint_codewords(bit,
                                                                   signed)
    got = tbc.flint_decode_table(bit, signed)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(),
                                  jbc.flint_decode_table(bit, signed))


@pytest.mark.parametrize("n", [2, 14, 16, 1030])
def test_ovp_pack_and_unpack_equal_reference(n):
    rng = np.random.default_rng(n)
    normal = rng.integers(0, 16, n).astype(np.uint8)
    outlier = rng.integers(0, 16, n).astype(np.uint8)
    slot = rng.integers(0, 3, n // 2)          # 0 none, 1 even, 2 odd
    mask = np.stack([slot == 1, slot == 2], 1).ravel()
    want = jbc.ovp_pack(normal, outlier, mask)
    got = tbc.ovp_pack(*(torch.from_numpy(a) for a in (normal, outlier,
                                                       mask)))
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8
        np.testing.assert_array_equal(g.numpy(), w)
    back = tbc.ovp_unpack(got[0], got[1], n)
    for g, w in zip(back, jbc.ovp_unpack(*want, n)):
        np.testing.assert_array_equal(g.numpy(), w)
    assert back[2].dtype == torch.bool
    both = torch.from_numpy(np.ones(n, bool))
    with pytest.raises(ValueError, match="both slots"):
        tbc.ovp_pack(torch.from_numpy(normal), torch.from_numpy(outlier),
                     both)


def test_packbits_is_numpys_little_endian():
    bits = np.random.default_rng(0).integers(0, 2, 77).astype(np.uint8)
    got = tbc.packbits(torch.from_numpy(bits))
    np.testing.assert_array_equal(got.numpy(),
                                  np.packbits(bits, bitorder="little"))
    np.testing.assert_array_equal(tbc.unpackbits(got, 77).numpy(), bits)


def _stack(kind, L, K, N, pair_axis, seed):
    """A port (L, N, K) ``w_i8`` of L layers from the port's quantizers:
    "ant" int8 codebook values of the flint grid (per output channel, or
    per input channel on a Conv1D site), "ovp" sign-offset OVP bytes with
    outliers, victims paired along ``pair_axis`` of (K, N)."""
    rng = np.random.default_rng(seed)
    axis = 1 if pair_axis == 0 else 0          # Conv1D: per input channel
    layers = []
    for _ in range(L):
        w = (rng.standard_t(3, size=(K, N)) / np.sqrt(K)).astype(np.float32)
        a = (2.5 * w.std(1 - axis)).astype(np.float32)
        if kind == "ovp":
            w_i8, _ = tq.quantize_weights_ovp_i8(
                torch.from_numpy(w), _pad(cb.olive_grid("flint", 4, True)),
                _pad(cb.olive_outlier_values(4, True)), a,
                pair_axis=pair_axis, axis=axis)
        else:
            w_i8, _ = tq.quantize_weights_w4_i8(
                torch.from_numpy(w), _pad(cb.ant_grid("flint", 4, True)), a,
                axis=axis)
        layers.append(w_i8.t())
    return torch.stack(layers).contiguous()


@pytest.mark.parametrize("kind", ["ant", "ovp"])
@pytest.mark.parametrize("pair_axis", [0, 1])
def test_pack_w4_stack_equals_reference(kind, pair_axis):
    """Every stored array bit-equal to the reference's for the same
    logical (L, K, N) stack; the round trip exact; an outlier-free stack
    stores no sideband; the packed bytes below 0.66 of the int8 bytes."""
    L, K, N = 3, 96, 40
    w = _stack(kind, L, K, N, pair_axis, seed=pair_axis)
    ref_w = w.transpose(1, 2).numpy()               # (L, K, N)
    if kind == "ovp":
        assert (w.abs() > 64).any()                # outliers were exercised
    want = jbc.pack_w4_stack(ref_w, ovp=kind == "ovp", pair_axis=pair_axis)
    got = tbc.pack_w4_stack(w, ovp=kind == "ovp", pair_axis=pair_axis)
    assert set(got) == set(want)
    assert ("w4_side" in got) == (kind == "ovp")
    for k, v in want.items():
        assert got[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    back = tbc.unpack_w4_stack(got)
    assert back.dtype == torch.int8 and back.shape == (L, N, K)
    assert torch.equal(back, w)
    np.testing.assert_array_equal(
        jbc.unpack_w4_stack({k: v.numpy() for k, v in got.items()}), ref_w)
    packed = sum(v.numel() * v.element_size() for v in got.values())
    assert packed < 0.66 * w.numel()


def test_pack_w4_stack_refuses_an_odd_pair_axis():
    """As the reference: OVP pairs must not straddle rows."""
    w = _stack("ovp", 1, 96, 40, 0, seed=3)[:, :, :95]      # K = 95
    with pytest.raises(ValueError, match="even pair-axis"):
        jbc.pack_w4_stack(w.transpose(1, 2).numpy(), ovp=True)
    with pytest.raises(ValueError, match="even pair-axis"):
        tbc.pack_w4_stack(w, ovp=True, pair_axis=0)
    w = _stack("ovp", 1, 96, 40, 1, seed=4)[:, :39]          # N = 39
    with pytest.raises(ValueError, match="even pair-axis"):
        tbc.pack_w4_stack(w, ovp=True, pair_axis=1)
