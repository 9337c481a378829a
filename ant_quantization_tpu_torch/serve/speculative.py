"""Speculative decoding over the serving engine.

Counterpart of the reference's ``serve/speculative.py``: a draft engine
proposes ``k`` greedy tokens, the target engine scores all k + 1
positions in one forward (T = k + 1 <= 16 keeps attention on K2's split
route, and M = B (k + 1) <= 64 keeps the site matmuls on K1), and the
longest prefix of drafts that matches the target's greedy choices is
accepted, followed by the target's own token there. Greedy against
greedy, the emitted stream is the target's alone, token for token.

With ``sampling`` at temperature > 0 each round runs Leviathan et al.'s
rejection sampling: draft x_i ~ q_i is accepted with probability
min(1, p_i(x_i) / q_i(x_i)); the first rejection draws from
normalize(max(p_i - q_i, 0)); when all k are accepted a bonus token is
drawn from p_k. p and q are the engines' filtered distributions
(``sampling.filtered_log_probs``), and the stream is distributed as the
target's own sampling.

Both engines write K/V rows for positions that may be rejected; the
causal mask hides them until a later forward at that position
overwrites them, as in the continuous batcher. Each round reads its
accepted counts on the host (``forward`` reads the positions there);
``rounds_per_dispatch`` rounds run per call of :meth:`rounds`, a Python
loop. Everything runs on the device of the target's params.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import engine as eng
from .sampling import (SamplingConfig, categorical, filtered_log_probs,
                       sample)
from .scheduler import tick_seed

__all__ = ["SpeculativeDecoder"]


class SpeculativeDecoder:
    """Draft-and-verify decoding: a draft engine and a target engine that
    share the vocabulary; ``k`` is the speculation depth (1 <= k <= 15,
    so that the verify forward stays a decode-size call)."""

    def __init__(self, target_cfg: eng.EngineConfig, target_ep: Dict,
                 draft_cfg: eng.EngineConfig, draft_ep: Dict, k: int = 4,
                 sampling: Optional[SamplingConfig] = None,
                 seed: int = 0):
        if not 1 <= k <= 15:
            raise ValueError(f"k must be in 1..15 (k + 1 <= 16), got {k}")
        if target_cfg.lm.vocab_size != draft_cfg.lm.vocab_size:
            raise ValueError("the draft and the target must share the "
                             "vocabulary")
        self.tcfg, self.tep = target_cfg, target_ep
        self.dcfg, self.dep = draft_cfg, draft_ep
        self.k = k
        self.sampling = sampling or SamplingConfig()
        self.seed = seed
        self._round = 0
        self.device = eng.params_device(target_ep)
        # re-seeded from (seed, round) before every round's draws
        self._gen = torch.Generator(device=self.device)
        self.accepted_hist: List[int] = []

    def _round_gen(self, r: int) -> torch.Generator:
        self._gen.manual_seed(tick_seed(self.seed, r))
        return self._gen

    def _target(self, ids, kv, pos, last_index=None):
        return eng.forward(self.tcfg, self.tep, ids, kv, pos,
                           last_index=last_index)

    def _draft(self, ids, kv, pos, last_index=None):
        return eng.forward(self.dcfg, self.dep, ids, kv, pos,
                           last_index=last_index)

    @torch.no_grad()
    def prefill(self, ids: torch.Tensor, kv_t, kv_d,
                gen: torch.Generator) -> torch.Tensor:
        """Both engines take the prompt at position 0; returns the
        target's first token (B, 1), drawn from its last position."""
        zero = torch.zeros((ids.shape[0],), dtype=torch.int32)
        lt, _ = self._target(ids, kv_t, zero, last_index=ids.shape[1] - 1)
        self._draft(ids, kv_d, zero, last_index=ids.shape[1] - 1)
        return sample(lt[:, -1:], self.sampling, gen)

    def _drafts(self, last, kv_d, pos, gen):
        """k + 1 draft steps from ``last`` at ``pos`` (the last only
        caches the k-th proposal's K/V): the k proposals (B, k) and, when
        sampling, their filtered log-probabilities (B, k, V)."""
        tok, drafts, logqs = last, [], []
        for i in range(self.k + 1):
            ld, _ = self._draft(tok, kv_d, torch.from_numpy(pos + i))
            if self.sampling.is_greedy:
                tok = torch.argmax(ld[:, -1:], dim=-1)
            else:
                logq = filtered_log_probs(ld[:, -1], self.sampling)
                tok = categorical(logq, gen)[:, None]
                logqs.append(logq)
            drafts.append(tok)
        drafts = torch.cat(drafts[:self.k], dim=1)
        return drafts, (torch.stack(logqs[:self.k], dim=1) if logqs
                        else None)

    @torch.no_grad()
    def step(self, kv_t, kv_d, last: torch.Tensor, pos: np.ndarray,
             gen: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, np.ndarray, torch.Tensor]:
        """One speculation round. ``last`` (B, 1): the newest emitted
        token, its K/V not cached yet; ``pos`` (B,): its cache row.
        Returns (out (B, k + 1): the emitted tokens, valid up to n_out;
        n_out (B,) on the host; the new ``last``); the new positions are
        ``pos + n_out``. ``gen`` supplies the draws when sampling."""
        B, k = last.shape[0], self.k
        drafts, logq = self._drafts(last, kv_d, pos, gen)
        ids = torch.cat([last, drafts], dim=1)                # (B, k+1)
        lt, _ = self._target(ids, kv_t, torch.from_numpy(pos))
        rows = torch.arange(B, device=ids.device)
        if self.sampling.is_greedy:
            tgt = torch.argmax(lt, dim=-1)                    # (B, k+1)
            match = (drafts == tgt[:, :k]).to(torch.int64)
            m = torch.cumprod(match, dim=1).sum(dim=1)
            corr = tgt[rows, m][:, None]
        else:
            m, corr = self._reject(lt, drafts, logq, gen)
        idx = torch.arange(k + 1, device=ids.device)[None, :]
        padded = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], 1)
        out = torch.where(idx < m[:, None], padded, corr)
        return out, (m + 1).cpu().numpy(), corr

    def _reject(self, lt, drafts, logq, gen):
        """Rejection sampling of one round: the accepted count m (B,)
        and the token at position m (B, 1)."""
        B, k = drafts.shape
        logp = filtered_log_probs(lt, self.sampling)          # (B,k+1,V)
        dev = lt.device
        bidx = torch.arange(B, device=dev)[:, None]
        iidx = torch.arange(k, device=dev)[None, :]
        lp_x = logp[:, :k][bidx, iidx, drafts]                # (B, k)
        lq_x = logq[bidx, iidx, drafts]
        u = torch.rand((B, k), device=dev, generator=gen) * (
            1.0 - 1e-20) + 1e-20
        accept = (torch.log(u) < (lp_x - lq_x)).to(torch.int64)
        m = torch.cumprod(accept, dim=1).sum(dim=1)           # (B,)
        # the residual at position m; q_k := 0 for the bonus draw
        q_pad = torch.cat([torch.exp(logq),
                           torch.zeros_like(logq[:, :1])], dim=1)
        rows = torch.arange(B, device=dev)
        p_m = torch.exp(logp[rows, m])                        # (B, V)
        resid = torch.clamp(p_m - q_pad[rows, m], min=0.0)
        rs = resid.sum(dim=-1, keepdim=True)
        # p == q exactly leaves no residual: rejection then had
        # probability 0 up to rounding, so draw from p_m
        resid = torch.where(rs > 0, resid / torch.clamp(rs, min=1e-30),
                            p_m)
        corr = categorical(torch.log(torch.clamp(resid, min=1e-30)),
                           gen)[:, None]
        return m, corr

    def rounds(self, kv_t, kv_d, last, pos: np.ndarray, round0: int,
               n_rounds: int):
        """``n_rounds`` rounds, round i drawing from the seed of round
        ``round0 + i`` (the stream does not depend on how rounds are
        grouped). Returns (toks (R, B, k+1), n_out (R, B), last, pos)
        on the host but ``last``. The caller keeps pos + n_rounds (k + 1)
        below max_seq."""
        outs, ns = [], []
        for i in range(n_rounds):
            gen = (None if self.sampling.is_greedy
                   else self._round_gen(round0 + i))
            out, n, last = self.step(kv_t, kv_d, last, pos, gen)
            outs.append(out)
            ns.append(n)
            pos = pos + n
        return (torch.stack(outs).cpu().numpy(), np.stack(ns), last, pos)

    @torch.no_grad()
    def generate(self, prompt_ids, max_new_tokens: int,
                 eos_id: Optional[int] = None,
                 rounds_per_dispatch: int = 8) -> List[List[int]]:
        """Decode ``max_new_tokens`` per sequence from (B, T) prompts (an
        array or a tensor);
        returns the emitted token lists (the target's greedy stream, or
        distributed as its sampling), cut after the first ``eos_id``.
        The stream does not depend on ``rounds_per_dispatch``."""
        ids = torch.as_tensor(prompt_ids, device=self.device).long()
        B, T = ids.shape
        kv_t = eng.init_cache(self.tcfg, B, device=self.device)
        kv_d = eng.init_cache(self.dcfg, B, device=self.device)
        last = self.prefill(ids, kv_t, kv_d, self._round_gen(self._round))
        self._round += 1
        out: List[List[int]] = [[t] for t in last[:, 0].tolist()]
        pos = np.full((B,), T, np.int64)
        limit = min(self.tcfg.max_seq, self.dcfg.max_seq)
        self.accepted_hist = []
        while (any(len(o) < max_new_tokens for o in out)
               and int(pos.max()) + self.k + 1 < limit):
            # the full group of rounds, or single rounds for the tail and
            # near the end of the cache (as the reference chooses)
            need = max(max_new_tokens - len(o) for o in out)
            fits = (limit - 1 - int(pos.max())) // (self.k + 1)
            r = rounds_per_dispatch if (
                need >= rounds_per_dispatch
                and fits >= rounds_per_dispatch) else 1
            toks, n, last, pos = self.rounds(kv_t, kv_d, last, pos,
                                             self._round, r)
            self._round += r
            for j in range(r):
                self.accepted_hist.append(int(n[j].sum() - B))
                for b in range(B):
                    if len(out[b]) >= max_new_tokens:
                        continue
                    if eos_id is not None and eos_id in out[b]:
                        continue
                    out[b].extend(int(t) for t in toks[j, b, :n[j, b]])
        for b in range(B):
            o = out[b][:max_new_tokens]
            if eos_id is not None and eos_id in o:
                o = o[:o.index(eos_id) + 1]
            out[b] = o
        return out
