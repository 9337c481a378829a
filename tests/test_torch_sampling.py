"""PyTorch port vs the JAX reference: the sampling stack
(``serve/sampling.py``). Filtering is deterministic and held to the JAX
function (masks equal, values within rtol 1e-5); draws come from a
``torch.Generator``, whose numbers are not ``jax.random``'s, so a draw is
held to its distribution and to the greedy equivalences."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ant_quantization_tpu.serve import sampling as jsm
from ant_quantization_tpu_torch.serve import sampling as tsm

pytestmark = pytest.mark.torchdep


def _gen(seed: int) -> torch.Generator:
    g = torch.Generator()
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (3, 1.0), (0, 0.8),
                                         (5, 0.6), (1, 1.0)])
def test_filter_logits_matches_reference(top_k, top_p):
    logits = np.random.default_rng(0).normal(size=(4, 16)).astype(
        np.float32) * 3
    kw = dict(temperature=0.7, top_k=top_k, top_p=top_p)
    want = np.asarray(jsm.filter_logits(jnp.asarray(logits),
                                        jsm.SamplingConfig(**kw)))
    got = tsm.filter_logits(torch.from_numpy(logits),
                            tsm.SamplingConfig(**kw)).numpy()
    np.testing.assert_array_equal(got > -1e29, want > -1e29)
    keep = want > -1e29
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-5)
    np.testing.assert_array_equal(got[~keep], want[~keep])


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (4, 0.9)])
def test_filtered_log_probs_matches_reference(top_k, top_p):
    logits = np.random.default_rng(1).normal(size=(3, 24)).astype(
        np.float32) * 2
    kw = dict(temperature=1.3, top_k=top_k, top_p=top_p)
    want = np.asarray(jsm.filtered_log_probs(jnp.asarray(logits),
                                             jsm.SamplingConfig(**kw)))
    got = tsm.filtered_log_probs(torch.from_numpy(logits),
                                 tsm.SamplingConfig(**kw)).numpy()
    keep = want > -1e29
    np.testing.assert_array_equal(got > -1e29, keep)
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, rtol=1e-5)


def test_temperature_zero_is_argmax():
    logits = torch.from_numpy(np.random.default_rng(1).normal(
        size=(8, 32)).astype(np.float32))
    cfg = tsm.SamplingConfig()
    assert tsm.filter_logits(logits, cfg) is logits
    got = tsm.sample(logits, cfg, _gen(0))
    np.testing.assert_array_equal(got.numpy(), logits.numpy().argmax(-1))


def test_top_k1_equals_greedy_at_any_temperature():
    logits = torch.from_numpy(np.random.default_rng(2).normal(
        size=(6, 24)).astype(np.float32))
    cfg = tsm.SamplingConfig(temperature=1.0, top_k=1)
    for seed in range(5):
        got = tsm.sample(logits, cfg, _gen(seed))
        np.testing.assert_array_equal(got.numpy(),
                                      logits.numpy().argmax(-1))


@pytest.mark.parametrize("top_k", [0, 3])
def test_sampled_distribution_matches_softmax(top_k):
    """4000 draws from one generator fall within the reference test's
    0.06 L1 of the filtered softmax."""
    row = np.asarray([[2.0, 1.0, 0.0, -1.0, -8.0]], np.float32)
    cfg = tsm.SamplingConfig(temperature=1.0, top_k=top_k)
    logits = torch.from_numpy(np.repeat(row, 4000, axis=0))
    draws = tsm.sample(logits, cfg, _gen(3)).numpy()
    counts = np.bincount(draws, minlength=5) / 4000
    want = np.exp(tsm.filtered_log_probs(torch.from_numpy(row),
                                         cfg).numpy()[0])
    assert np.abs(counts - want).sum() < 0.06, (counts, want)
    if top_k:
        assert counts[top_k:].sum() == 0
    # the same generator state draws the same tokens
    again = tsm.sample(logits, cfg, _gen(3)).numpy()
    np.testing.assert_array_equal(draws, again)


def test_top_p_support():
    logits = torch.tensor([[0.0, 0.0, -20.0, -20.0]])
    cfg = tsm.SamplingConfig(temperature=1.0, top_p=0.9)
    lp = tsm.filtered_log_probs(logits, cfg).numpy()[0]
    assert lp[2] < -20 and lp[3] < -20
    np.testing.assert_allclose(np.exp(lp[:2]), [0.5, 0.5], atol=1e-5)
