"""Faults planted under the timed path, to show that the check catches
them (``tests/test_portbench_faults.py`` on the CPU at a tiny size;
``control.py --fault`` and ``tests/test_portbench_control_card.py`` on
the card at a cell's full size and limit). Never used by the
benchmark's own runs.

- ``token``: every decode tick's tokens altered where they are produced
  (each the next id of the vocabulary).
- ``unchanged``: every decode tick returns its state unchanged: it
  writes no key or value into the cache (its tokens are still the
  forward's).
"""

from __future__ import annotations

import contextlib
from unittest import mock

FAULTS = ("token", "unchanged")


@contextlib.contextmanager
def planted(name: str):
    from ant_quantization_tpu_torch.serve import engine as eng
    from ant_quantization_tpu_torch.serve import scheduler as sch
    tick = sch.ContinuousBatcher._decode_tick

    def token(self, tok, pos, gen):
        return (tick(self, tok, pos, gen) + 1) % self.cfg.lm.vocab_size

    def unchanged(self, tok, pos, gen):
        with mock.patch.object(eng, "append_kv_stacked",
                               lambda cache, *a: cache):
            return tick(self, tok, pos, gen)

    fn = {"token": token, "unchanged": unchanged}[name]
    with mock.patch.object(sch.ContinuousBatcher, "_decode_tick", fn):
        yield
