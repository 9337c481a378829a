"""K2's tensor-core plan, checked on the CPU: the prefill regime takes the
f32 operand of each product (qs, and p * v_scale) as three bf16 terms
(hi, mid, lo: every f32 value exactly) against the exact int8 codes, with
f32 sums over key tiles of 64 and an online softmax. Its emulation in
plain PyTorch (kernels/attention.py:stacked_int8_kv_attention_hilo) must
stay within K2's f32 tolerance (atol 1e-4, the one chip_smoke.py holds
the kernel to) of the plain version and of the Pallas kernel in
interpret mode, on the same numpy inputs. Also the decode regime's span rule: the splits cover
the visible positions exactly once, and split 0 holds position 0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ant_quantization_tpu.kernels.attention import (
    stacked_int8_kv_attention as jk2)
from ant_quantization_tpu_torch.kernels import attention as tk2

pytestmark = pytest.mark.torchdep

_ATOL = 1e-4        # K2_TOL["f32"] in chip_smoke.py
_L, _B, _H, _D = 2, 2, 2, 128
_SLOPES = np.float32([0.5, 0.0625])


def _inputs(T, S, seed, adversarial=False, top=-1):
    rng = np.random.default_rng(seed)
    k = rng.integers(-127, 128, (_L, _B, _H, S, _D)).astype(np.int8)
    v = rng.integers(-127, 128, (_L, _B, _H, S, _D)).astype(np.int8)
    q = rng.normal(size=(_B, _H, T, _D)).astype(np.float32)
    if adversarial:
        # large-magnitude q, scales spread over three decades (up to 1 the
        # plain version and the reference already differ by more than
        # the tolerance: test_scales_up_to_one_are_beyond_the_f32_...)
        q *= 8
        ks = (10.0 ** rng.uniform(-4, top, (_L, _B, _H, S))).astype(
            np.float32)
        vs = (10.0 ** rng.uniform(-4, top, (_L, _B, _H, S))).astype(
            np.float32)
    else:
        ks = rng.uniform(0.002, 0.02, (_L, _B, _H, S)).astype(np.float32)
        vs = rng.uniform(0.002, 0.02, (_L, _B, _H, S)).astype(np.float32)
    return q, k, v, ks, vs


_CASES = [(T, S, p0, alibi)
          for T, S in ((1, 64), (40, 64), (64, 130), (40, 130))
          for p0 in ("zero", "ragged")
          for alibi in (False, True)]


def _pos0(kind, T, S):
    if kind == "zero":
        return np.int32([0, 0])
    return np.int32([3, S - T])          # the last query at S - 1


def _run_all(T, S, p0, alibi, adversarial, seed, parts=3):
    q, k, v, ks, vs = _inputs(T, S, seed, adversarial)
    pos0 = _pos0(p0, T, S)
    slopes = _SLOPES if alibi else None
    l = 1
    t = torch.from_numpy
    ts = None if slopes is None else t(slopes)
    hilo = tk2.stacked_int8_kv_attention_hilo(
        l, t(q), t(k), t(v), t(ks), t(vs), t(pos0), ts,
        parts=parts).numpy()
    plain = tk2.stacked_int8_kv_attention_plain(
        l, t(q), t(k), t(v), t(ks), t(vs), t(pos0), ts,
        out_dtype=torch.float32).numpy()
    pallas = np.asarray(jk2(
        jnp.int32(l), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(pos0),
        None if slopes is None else jnp.asarray(slopes),
        out_dtype=jnp.float32, interpret=True))
    return hilo, plain, pallas


@pytest.mark.parametrize("T,S,p0,alibi", _CASES)
def test_hilo_plan_within_k2_tolerance(T, S, p0, alibi):
    hilo, plain, pallas = _run_all(T, S, p0, alibi, False, seed=T + S)
    np.testing.assert_allclose(hilo, plain, rtol=0, atol=_ATOL)
    np.testing.assert_allclose(hilo, pallas, rtol=0, atol=_ATOL)


@pytest.mark.parametrize("T,S,seed", [(40, 130, 7), (64, 64, 1),
                                        (64, 130, 2)])
def test_hilo_plan_adversarial(T, S, seed):
    hilo, plain, pallas = _run_all(T, S, "ragged", True, True, seed)
    assert np.abs(plain).max() > 5.0          # far beyond the tolerance
    # the case is within reach of f32: plain and reference agree
    np.testing.assert_allclose(plain, pallas, rtol=0, atol=_ATOL)
    np.testing.assert_allclose(hilo, plain, rtol=0, atol=_ATOL)
    np.testing.assert_allclose(hilo, pallas, rtol=0, atol=_ATOL)


def test_scales_up_to_one_are_beyond_the_f32_tolerance():
    """With k_scale and v_scale up to 1 the plain version and the
    reference themselves differ by more than atol 1e-4: the adversarial
    case tops its scales at 0.1."""
    T, S = 40, 130
    q, k, v, ks, vs = _inputs(T, S, 7, adversarial=True, top=0)
    pos0 = _pos0("ragged", T, S)
    t = torch.from_numpy
    plain = tk2.stacked_int8_kv_attention_plain(
        1, t(q), t(k), t(v), t(ks), t(vs), t(pos0), t(_SLOPES),
        out_dtype=torch.float32).numpy()
    pallas = np.asarray(jk2(
        jnp.int32(1), *(jnp.asarray(a) for a in (q, k, v, ks, vs, pos0,
                                                 _SLOPES)),
        out_dtype=jnp.float32, interpret=True))
    assert np.abs(plain - pallas).max() > _ATOL


def test_two_bf16_terms_miss_the_adversarial_case():
    """With two bf16 terms (hi, lo: about 16 of f32's 24 bits) the same
    adversarial inputs fall outside the tolerance: the third term is what
    the kernel needs."""
    hilo, plain, _ = _run_all(40, 130, "ragged", True, True, 7, parts=2)
    assert np.abs(hilo - plain).max() > _ATOL


def test_one_bf16_pass_would_not_do():
    """One bf16 term misses the tolerance on ordinary inputs too."""
    hilo, plain, _ = _run_all(40, 130, "zero", False, False, 3, parts=1)
    assert np.abs(hilo - plain).max() > _ATOL


@pytest.mark.parametrize("B,H,S,want", [(4, 32, 608, 64), (4, 32, 2048, 128),
                                        (4, 32, 16384, 512), (1, 1, 64, 64),
                                        (2, 2, 130, 64)])
def test_span_rule(B, H, S, want):
    span = tk2._span(B, H, S)
    assert span == want and span % 64 == 0 and 64 <= span <= 512


@pytest.mark.parametrize("S", [64, 130, 608, 2048, 16384])
@pytest.mark.parametrize("T", [1, 5, 16])
def test_splits_cover_visible_positions_once(S, T):
    span = tk2._span(4, 32, S)
    for p0 in sorted({0, 1, 63, 64, S // 2, S - T}):
        ranges = tk2.split_ranges(p0, T, S, span)
        assert ranges[0][0] == 0                  # split 0 holds position 0
        covered = [p for b, e in ranges for p in range(b, e)]
        assert covered == list(range(min(p0 + T, S)))
        assert all(e - b <= span for b, e in ranges)
        assert len(ranges) <= -(-S // span)
