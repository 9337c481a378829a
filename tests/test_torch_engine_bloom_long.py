"""PyTorch port vs the JAX reference: the 2-layer BLOOM-shaped engine of
test_torch_engine_bloom.py on a long cache, where the reference leaves its
stacked attention kernel: at max_seq 12,288 one head's tile fills the
reference's whole budget (no query fits), so up to 16 queries take K7 and
longer calls the dequantizing einsum fallback. Scalar and per-sequence
pos0; logits within 5e-3 of the reference; the test asserts the route of
every attention call."""

import dataclasses

import pytest

from ant_quantization_tpu_torch.serve import engine as teng
from test_torch_engine_bloom import check_route, configs

pytestmark = pytest.mark.torchdep

_LONG = 12288


def test_routes_at_the_budget_edge():
    _, tcfg = configs(_LONG)
    c = tcfg.lm
    assert [teng.attention_route(c, t, _LONG) for t in (1, 8, 16, 17, 24)] \
        == ["K7"] * 3 + ["einsum"] * 2
    # head_dim 128: K2 keeps one query up to S = 12,190
    assert teng.attention_route(c, 1, 12190) == "K2"
    assert teng.attention_route(c, 1, 12191) == "K7"
    assert teng.attention_route(c, 8, 2048) == "K2"
    # head_dim 64: the reference folds its cache and never takes K7
    folded = dataclasses.replace(c, n_heads=4)
    assert teng.attention_route(folded, 1, 2 * _LONG) == "einsum"


@pytest.mark.parametrize("per_seq", [False, True])
def test_bloom_k7_route_matches_reference(monkeypatch, per_seq):
    seen = check_route(monkeypatch, _LONG, [8], 2, per_seq)
    assert seen == ["K7"] * 2 * 3


@pytest.mark.parametrize("per_seq", [False, True])
def test_bloom_einsum_route_matches_reference(monkeypatch, per_seq):
    seen = check_route(monkeypatch, _LONG, [24], 1, per_seq)
    assert seen == ["einsum"] * 2 + ["K7"] * 2
