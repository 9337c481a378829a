"""Fault-tolerant evaluation: resumable accumulation and transient retry.

Counterpart of the reference's ``harness/resilient.py`` (numpy only, the
same journal format):

- ``ResumableAccumulator``: folds per-batch results into a running state
  that is journaled to disk every ``save_every`` batches; a restarted
  process skips the batches already folded, so an evaluation that
  crashes loses at most ``save_every`` batches, not the whole sweep.
- ``retry_transient``: bounded-backoff retry for callables hitting
  transient runtime errors (device unavailable, RPC timeouts); other
  errors are raised at once.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

__all__ = ["ResumableAccumulator", "retry_transient"]

# deliberately narrow: deterministic failures (OOM/RESOURCE_EXHAUSTED,
# shape errors) must surface immediately, not retry
_TRANSIENT_MARKERS = ("UNAVAILABLE", "DEADLINE_EXCEEDED",
                      "Connection reset", "ConnectionError", "timed out",
                      "Socket closed", "INTERNAL: http")


def retry_transient(fn: Callable, *args, retries: int = 3,
                    backoff_s: float = 2.0, on_retry: Optional[Callable] = None,
                    **kwargs):
    """Call ``fn``; retry up to ``retries`` times (doubling backoff) when
    the error message looks transient; re-raise anything else."""
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except Exception as e:                      # noqa: BLE001
            msg = str(e)
            transient = any(m in msg for m in _TRANSIENT_MARKERS)
            if not transient or attempt >= retries:
                raise
            if on_retry:
                on_retry(attempt, e)
            time.sleep(backoff_s * (2 ** attempt))
            attempt += 1


class ResumableAccumulator:
    """Journaled fold over a batch stream.

        acc = ResumableAccumulator("/ckpt/eval.json",
                                   init={"correct": 0, "total": 0},
                                   save_every=50)
        for i, batch in enumerate(batches):
            if acc.already_done(i):
                continue
            out = eval_step(batch)                 # device work
            acc.fold(i, {"correct": out.c, "total": out.n})
        state = acc.finalize()

    State values are ints/floats (summed) or 1-D numpy arrays (summed);
    the journal is a small json + npz pair, atomically replaced.
    """

    def __init__(self, path: str, init: Dict[str, Any],
                 save_every: int = 50, fingerprint: str = ""):
        """``fingerprint``: identifies the computation (model, mode, data
        ...). A journal written under a different fingerprint is ignored
        and overwritten — a rerun with changed configuration recomputes
        instead of silently serving stale results."""
        self.path = path
        self.save_every = save_every
        self.fingerprint = fingerprint
        self.state: Dict[str, Any] = dict(init)
        self.next_index = 0
        self._dirty = 0
        if path and os.path.exists(self._journal_path):
            self._load(dict(init))

    # -- public ----------------------------------------------------------
    def already_done(self, index: int) -> bool:
        return index < self.next_index

    def fold(self, index: int, contrib: Dict[str, Any]) -> None:
        assert index == self.next_index, (
            f"batches must fold in order (got {index}, "
            f"expected {self.next_index})")
        for k, v in contrib.items():
            if k in self.state and self.state[k] is not None:
                self.state[k] = self.state[k] + v
            else:
                self.state[k] = v
        self.next_index += 1
        self._dirty += 1
        if self.path and self._dirty >= self.save_every:
            self.save()

    def finalize(self) -> Dict[str, Any]:
        if self.path:
            self.save()
        return dict(self.state)

    def save(self) -> None:
        """One atomic file: arrays + a json header, replaced in a single
        os.replace — a crash can never pair new arrays with an old
        next_index."""
        arrays = {k: np.asarray(v) for k, v in self.state.items()
                  if isinstance(v, np.ndarray)}
        scalars = {k: v for k, v in self.state.items()
                   if not isinstance(v, np.ndarray)}
        meta = json.dumps({"next_index": self.next_index,
                           "scalars": scalars,
                           "fingerprint": self.fingerprint})
        tmp = self._journal_path + ".tmp.npz"
        np.savez(tmp, __meta__=np.frombuffer(meta.encode(), np.uint8),
                 **arrays)
        os.replace(tmp, self._journal_path)
        self._dirty = 0

    # -- internals -------------------------------------------------------
    @property
    def _journal_path(self) -> str:
        return self.path + ".journal.npz"

    def _load(self, init: Dict[str, Any]) -> None:
        with np.load(self._journal_path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            if meta.get("fingerprint", "") != self.fingerprint:
                return                       # different run: start fresh
            self.next_index = int(meta["next_index"])
            self.state.update(meta["scalars"])
            for k in z.files:
                if k != "__meta__":
                    self.state[k] = z[k]
