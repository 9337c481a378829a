"""The closed-loop generator: lengths and ids as a function of the
seed."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import spec
from portbench.traffic import closed_loop

MIXES = ("docqa", "longgen")
VOCAB = 50272


def _mix(name: str) -> dict:
    return spec.load_json(spec.PKG / "traffic" / f"{name}.json")


def _draw(mix, seed, n):
    s = closed_loop.make(mix, VOCAB, seed)
    first = s.first_requests()
    return first, [s.next() for _ in range(n)]


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    mix = _mix(name)
    assert _draw(mix, 2 ** 31 + 11, 40) == _draw(mix, 2 ** 31 + 11, 40)


@pytest.mark.parametrize("name", MIXES)
def test_other_seed_other_order_same_sizes(name):
    """Two seeds serve the same sizes, round by round, in other orders,
    with other ids."""
    mix = _mix(name)
    n = 3 * mix["round"]
    sa, sb = closed_loop.make(mix, VOCAB, 1), closed_loop.make(
        mix, VOCAB, 2 ** 33 + 5)
    a = [sa.next() for _ in range(n)]
    b = [sb.next() for _ in range(n)]
    assert [len(p) for p, _ in a] != [len(p) for p, _ in b]
    assert sorted(len(p) for p, _ in a) == sorted(len(p) for p, _ in b)
    assert sorted(m for _, m in a) == sorted(m for _, m in b)
    assert a[0][0][:8] != b[0][0][:8]


@pytest.mark.parametrize("name", MIXES)
def test_rounds_hold_one_set_of_sizes(name):
    mix = _mix(name)
    r = mix["round"]
    s = closed_loop.make(mix, VOCAB, 77)
    reqs = [s.next() for _ in range(3 * r)]
    rounds = [reqs[k:k + r] for k in range(0, 3 * r, r)]
    p_sets = [sorted(len(p) for p, _ in rd) for rd in rounds]
    o_sets = [sorted(n for _, n in rd) for rd in rounds]
    assert p_sets[0] == p_sets[1] == p_sets[2]
    assert o_sets[0] == o_sets[1] == o_sets[2]
    lo, hi = mix["prompt_tokens"]
    assert lo <= p_sets[0][0] and p_sets[0][-1] <= hi
    lo, hi = mix["output_tokens"]
    assert lo <= o_sets[0][0] and o_sets[0][-1] <= hi
    # log-uniform quantiles: the geometric middle is the median
    mid = np.sqrt(np.prod(mix["prompt_tokens"]))
    assert abs(np.median(p_sets[0]) / mid - 1) < 0.15


@pytest.mark.parametrize("name", MIXES)
def test_ids_in_vocabulary_and_first_requests_shortened(name):
    mix = _mix(name)
    s = closed_loop.make(mix, VOCAB, 3)
    first = s.first_requests()
    assert len(first) == mix["clients"]
    for ids, n in first:
        assert all(0 <= i < VOCAB for i in ids)
        assert closed_loop.ClosedLoop.MIN_NEW <= n <= mix["output_tokens"][1]
    # stratified over the clients: remaining outputs spread from short
    # to long
    ns = sorted(n for _, n in first)
    assert ns[0] < mix["output_tokens"][0] <= ns[-1]
