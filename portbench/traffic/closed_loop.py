"""Closed-loop traffic: ``clients`` callers, each sending its next request
as soon as its reply is complete, as a batch job or a batch API does.

Every request is drawn from the seed alone: its prompt ids uniformly
from the vocabulary, its prompt and output lengths from the mix's
ranges. The lengths come in rounds of ``round`` requests that hold one
fixed set of sizes (the quantiles (j + 0.5) / round of the mix's
distribution) in an order the seed draws, prompts and outputs permuted
apart. So every seed serves the same mix of sizes in another order, and
a window of some hundred requests sees nearly the same work whatever
the seed. Decoding is greedy with no end-of-sequence token, so each
request runs to its drawn length and the whole schedule of ticks is a
function of the seed.

A client's first request is submitted during set-up; its remaining
output is drawn again, uniformly over (0, its drawn length] (stratified
over the clients in the same way), so that completions are spread from
the first tick and the window opens in steady state.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np


def _quantiles(lo: int, hi: int, n: int, kind: str) -> np.ndarray:
    q = (np.arange(n) + 0.5) / n
    if kind == "log_uniform":
        v = np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
    elif kind == "uniform":
        v = lo + q * (hi - lo)
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return np.clip(np.rint(v), lo, hi).astype(np.int64)


class ClosedLoop:
    """The request stream of one run. ``next()`` gives (prompt ids,
    max_new_tokens) in the order the clients ask for them."""

    MIN_NEW = 2     # the batcher always returns a prefill token and a tick's

    def __init__(self, mix: dict, vocab_size: int, seed: int):
        self.mix = mix
        self.vocab = int(vocab_size)
        self.clients = int(mix["clients"])
        self.round = int(mix["round"])
        kind = mix["lengths"]
        self._p_set = _quantiles(*mix["prompt_tokens"], self.round, kind)
        self._o_set = _quantiles(*mix["output_tokens"], self.round, kind)
        self._rng = np.random.default_rng([int(seed) & (2 ** 64 - 1),
                                           0x636C6F7365])
        self._lengths: List[Tuple[int, int]] = []
        self.drawn = 0

    def _refill(self) -> None:
        p = self._rng.permutation(self._p_set)
        o = self._rng.permutation(self._o_set)
        self._lengths.extend(zip(p.tolist(), o.tolist()))

    def next(self) -> Tuple[List[int], int]:
        if not self._lengths:
            self._refill()
        n_prompt, n_out = self._lengths.pop(0)
        ids = self._rng.integers(0, self.vocab, n_prompt).tolist()
        self.drawn += 1
        return ids, max(self.MIN_NEW, int(n_out))

    def first_requests(self) -> List[Tuple[List[int], int]]:
        """One request per client, each with its remaining output length
        drawn over (0, its length]."""
        reqs = [self.next() for _ in range(self.clients)]
        u = (self._rng.permutation(self.clients) + 0.5) / self.clients
        return [(ids, max(self.MIN_NEW, int(math.ceil(f * n))))
                for (ids, n), f in zip(reqs, u.tolist())]


def make(mix: dict, vocab_size: int, seed: int) -> ClosedLoop:
    return ClosedLoop(mix, vocab_size, seed)
