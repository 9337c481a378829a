"""Continuous batching over the serving engine.

Counterpart of the reference's ``serve/scheduler.py``: a fixed pool of B
slots over one shared (L, B, ...) KV cache. A finished sequence frees its
slot at once and the next queued request takes it, so the batch does not
wait for its longest request.

- A prompt is padded to the smallest length bucket that holds it and
  prefilled at batch 1. It runs against a batch-1 scratch cache that the
  batcher owns and reuses, and rows [0, Tb) of every cache tensor are
  then copied into the slot's row: only those rows were written, and the
  other slots' rows stay untouched. (The reference slices the slot's row
  out of the cache, runs the forward on it and scatters it back; a slice
  of the port's cache is not contiguous, and the kernels take contiguous
  tensors.) The padded tail writes stale K/V past the prompt, which the
  causal mask hides until a decode at that position overwrites it.
- One decode tick advances every slot with a (B,) vector of positions;
  free slots decode garbage that the host ignores. Every tick clamps the
  positions to ``max_seq - 1`` (a free slot's stale length can pass the
  end within a chunk, and the port's cache raises on a write past it).
- ``step_chunk`` runs several ticks with the token fed back on the
  device and reads the tokens once at the end; ``forward`` reads each
  tick's positions on the host (they are passed as a CPU tensor).

Sampling follows ``serve/sampling.py``; each tick's draws come from a
generator seeded by (seed, absolute tick), so per-tick and chunked runs
draw alike, as the reference folds the tick into its key. Everything
runs on the device of the engine params.
"""

from __future__ import annotations

import dataclasses
import inspect
import itertools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels.kv_cache import QuantKV
from ..utils.profiling import span
from . import engine as eng
from .sampling import SamplingConfig, sample

__all__ = ["Request", "Completion", "ContinuousBatcher"]


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    id: Optional[int] = None


@dataclasses.dataclass
class Completion:
    id: int
    prompt: List[int]
    tokens: List[int]          # generated ids (without the prompt)
    finish_reason: str         # "eos" or "length"


def _bucket(n: int, buckets: Tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt of {n} tokens exceeds largest bucket "
                     f"{buckets[-1]}")


def tick_seed(seed: int, tick: int) -> int:
    """The seed of one tick's (or round's) draws, as the reference folds
    the tick into its root key: (seed, tick) mixed into 64 bits by
    splitmix64's finalizer (a CPU generator keeps only the low 32 bits,
    so they must depend on both)."""
    m = 0xFFFFFFFFFFFFFFFF
    x = (seed * 0x9E3779B97F4A7C15 + tick) & m
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & m
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & m
    return x ^ (x >> 31)


class ContinuousBatcher:
    """Slot-based continuous batching over the serving engine."""

    def __init__(self, cfg: eng.EngineConfig, ep: Dict, batch_slots: int,
                 prefill_buckets: Tuple[int, ...] = (32, 128, 512),
                 pad_id: int = 0,
                 forward_fn: Optional[Callable] = None,
                 sampling: Optional[SamplingConfig] = None,
                 seed: int = 0, kv: Optional[QuantKV] = None):
        """``forward_fn(ep, ids, kv, pos0, last_index=None) -> (logits,
        kv)`` defaults to :func:`engine.forward`; one without a
        ``last_index`` parameter gets the whole padded prompt's logits
        and the batcher takes the last real position's. ``kv`` is the
        slots' cache (an empty one of ``batch_slots`` rows); by default it
        is built empty on the params' device. Pass
        ``serve.sharded.make_sharded_forward``'s forward with this rank's
        shards (``ep``, ``kv``) to batch over a tp mesh. ``sampling``
        applies to every slot; the default (temperature 0) is exact
        greedy."""
        self.cfg = cfg
        self.ep = ep
        self.B = batch_slots
        self.buckets = tuple(sorted(prefill_buckets))
        self.pad_id = pad_id
        self.sampling = sampling or SamplingConfig()
        self.seed = seed
        self._tick = 0
        self.device = eng.params_device(ep)
        self._fwd = forward_fn or (
            lambda ep_, ids_, kv_, pos0_, last_index=None:
            eng.forward(cfg, ep_, ids_, kv_, pos0_, last_index=last_index))
        # only a forward that names ``last_index`` gets it (a **kwargs
        # catch-all does not count: a wrapper that swallowed it would
        # sample the padded tail)
        try:
            self._fwd_last = "last_index" in inspect.signature(
                self._fwd).parameters
        except (TypeError, ValueError):
            self._fwd_last = False
        # re-seeded from (seed, tick) before every tick's draws
        self._gen = torch.Generator(device=self.device)
        self.kv = kv if kv is not None else eng.init_cache(
            cfg, batch_slots, device=self.device)
        self._scratch = None            # the batch-1 prefill cache
        self.lengths = np.zeros(batch_slots, np.int64)   # fill depth
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.slot_tokens: List[List[int]] = [[] for _ in range(batch_slots)]
        self.last_token = np.zeros((batch_slots, 1), np.int64)
        self.queue: List[Request] = []
        self.done: List[Completion] = []
        self._ids = itertools.count()

    # ---- public API ----------------------------------------------------

    def submit(self, req: Request) -> int:
        if req.id is None:
            req.id = next(self._ids)
        self.queue.append(req)
        self._fill_free_slots()
        return req.id

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.slot_req)

    @torch.no_grad()
    def step(self) -> List[Completion]:
        """One decode tick for every active slot; returns the requests
        that finished (their slots are refilled from the queue)."""
        with span("batcher.dispatch"):
            self._fill_free_slots()
            if self.n_active == 0:
                out, self.done = self.done, []
                return out
            with span("host.sync"):
                tok = torch.as_tensor(self.last_token, device=self.device)
            with span("batcher.tick", key=self._tick):
                nxt = self._decode_tick(tok, self._positions(0),
                                        self._next_gen())
            with span("host.sync"):
                nxt = nxt.tolist()
            self._apply_tick(nxt)
            self._fill_free_slots()
            out, self.done = self.done, []
            return out

    @torch.no_grad()
    def step_chunk(self, n_ticks: int) -> List[Completion]:
        """``n_ticks`` decode ticks with the tokens fed back on the
        device and read once at the end. A slot that finishes within the
        chunk is refilled only at its end. Greedy completions equal
        per-tick stepping's; sampled ones use the same absolute-tick
        seeds, but a refill's timing can move a request onto other
        ticks."""
        with span("batcher.dispatch"):
            self._fill_free_slots()
            if self.n_active == 0 or n_ticks <= 1:
                return self.step()
            with span("host.sync"):
                tok = torch.as_tensor(self.last_token, device=self.device)
            toks = []
            for i in range(n_ticks):
                with span("batcher.tick", key=self._tick + i):
                    self._gen.manual_seed(tick_seed(self.seed,
                                                    self._tick + i))
                    nxt = self._decode_tick(tok, self._positions(i),
                                            self._gen)
                    toks.append(nxt)
                    tok = nxt[:, None]
            self._tick += n_ticks
            with span("host.sync"):
                rows = torch.stack(toks).tolist()       # (n_ticks, B)
            for row in rows:
                self._apply_tick(row)
            self._fill_free_slots()
            out, self.done = self.done, []
            return out

    def run(self, max_steps: int = 10_000,
            ticks_per_dispatch: int = 1) -> List[Completion]:
        """Drain the queue and the active slots. ``max_steps`` counts
        dispatches of ``ticks_per_dispatch`` ticks each."""
        finished: List[Completion] = []
        for _ in range(max_steps):
            finished.extend(self.step_chunk(ticks_per_dispatch)
                            if ticks_per_dispatch > 1 else self.step())
            if self.n_active == 0 and not self.queue:
                break
        return finished

    # ---- internals ------------------------------------------------------

    def _next_gen(self) -> torch.Generator:
        self._gen.manual_seed(tick_seed(self.seed, self._tick))
        self._tick += 1
        return self._gen

    def _positions(self, ahead: int) -> torch.Tensor:
        """Every slot's write position ``ahead`` ticks on, clamped to the
        last row of the cache, as a CPU tensor (forward reads it on the
        host)."""
        return torch.from_numpy(np.minimum(
            self.lengths + ahead, self.cfg.max_seq - 1).astype(np.int32))

    def _decode_tick(self, tok: torch.Tensor, pos: torch.Tensor,
                     gen: torch.Generator) -> torch.Tensor:
        logits, self.kv = self._fwd(self.ep, tok, self.kv, pos)
        return sample(logits[:, -1], self.sampling, gen)          # (B,)

    def _apply_tick(self, nxt: List[int]) -> None:
        """Fold one tick's tokens (B,) into the slots; a slot without a
        request ignores its (garbage) token."""
        with span("batcher.apply"):
            for b in range(self.B):
                req = self.slot_req[b]
                if req is None:
                    continue
                tok = int(nxt[b])
                self.slot_tokens[b].append(tok)
                self.lengths[b] += 1
                self.last_token[b, 0] = tok
                hit_eos = req.eos_id is not None and tok == req.eos_id
                full = (len(self.slot_tokens[b]) >= req.max_new_tokens
                        or self.lengths[b] + 1 >= self.cfg.max_seq)
                if hit_eos or full:
                    self._finish(b, "eos" if hit_eos else "length")

    def _finish(self, b: int, reason: str) -> None:
        req = self.slot_req[b]
        self.done.append(Completion(id=req.id, prompt=req.prompt,
                                    tokens=self.slot_tokens[b],
                                    finish_reason=reason))
        self.slot_req[b] = None
        self.slot_tokens[b] = []

    @torch.no_grad()
    def _prefill_slot(self, b: int, prompt: List[int]) -> int:
        """Prefill one slot through the scratch cache; returns its first
        token."""
        T = len(prompt)
        Tb = _bucket(T, self.buckets)
        ids = torch.full((1, Tb), self.pad_id, dtype=torch.int64)
        ids[0, :T] = torch.as_tensor(prompt, dtype=torch.int64)
        with span("host.sync"):
            ids = ids.to(self.device)
        if self._scratch is None:
            # the slots' cache at batch 1 (a tp rank's holds its heads)
            self._scratch = QuantKV(*(t.new_zeros((t.shape[0], 1)
                                                  + t.shape[2:])
                                      for t in self.kv))
        zero = torch.zeros((1,), dtype=torch.int32)
        if self._fwd_last:
            logits, self._scratch = self._fwd(self.ep, ids, self._scratch,
                                              zero, last_index=T - 1)
        else:
            logits, self._scratch = self._fwd(self.ep, ids, self._scratch,
                                              zero)
            logits = logits[:, T - 1:T]
        with span("batcher.slot_copy"):
            for dst, src in zip(self.kv, self._scratch):
                dst[:, b, :, :Tb].copy_(src[:, 0, :, :Tb])
        tok = sample(logits[:, -1], self.sampling, self._next_gen())
        with span("host.sync"):
            return int(tok[0])

    def _fill_free_slots(self) -> None:
        for b in range(self.B):
            if self.slot_req[b] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            if not req.prompt:
                raise ValueError(f"request {req.id} has an empty prompt")
            with span("batcher.prefill", key=req.id):
                tok = self._prefill_slot(b, req.prompt)
            self.slot_req[b] = req
            self.slot_tokens[b] = [tok]
            self.lengths[b] = len(req.prompt)
            self.last_token[b, 0] = tok
            if req.eos_id is not None and tok == req.eos_id:
                self._finish(b, "eos")
