"""Simulator facade: layer specs -> cycles/energy, by the tensor tiling
search on a device.

Counterpart of the reference's ``perfmodel/simulator.py``, the equivalent
of bitfusion.src.simulator.Simulator.get_cycles (simulator.py:492-521):
convolutions and matmuls dispatch to the tiling search; matmul = 1x1
conv with batch = rows.

The search (:func:`model.search_layers`) runs on ``device``, the card by
default (it raises without one), a network's layers together. The
reference's native optimizer (``csrc/tileopt.cc``) gives the same
``LayerStats``; the port has the search alone.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from .. import _ext
from .energy import CONFIGS, energy_params
from .model import (AcceleratorConfig, EnergyParams, LayerStats, conv_cycles,
                    fc_cycles, search_layers)

__all__ = ["ConvSpec", "MatMulSpec", "Simulator"]


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """One conv layer: square kernel/output, same precision column layout
    as the reference bench tables."""
    k: int
    out: int          # output spatial size O
    stride: int
    ic: int
    oc: int
    iprec: int
    wprec: int
    name: str = ""


@dataclasses.dataclass(frozen=True)
class MatMulSpec:
    ni: int
    no: int
    iprec: int
    wprec: int
    rows: int = 1     # batch x seq collapsing, like dnnweaver2 MatMul B dim
    name: str = ""


class Simulator:
    def __init__(self, acc: AcceleratorConfig,
                 energy: Optional[EnergyParams] = None, device=None):
        self.acc = acc
        self.energy = energy or energy_params(acc)
        self.device = _ext.resolve_device(device)

    @classmethod
    def named(cls, name: str, **kw) -> "Simulator":
        return cls(CONFIGS[name], **kw)

    def conv(self, s: ConvSpec, batch: int,
             weight_stationary: bool = False) -> LayerStats:
        return conv_cycles(self.acc, s.k, s.out, s.stride, s.ic, s.oc,
                           s.iprec, s.wprec, batch,
                           weight_stationary, self.energy, self.device)

    def matmul(self, s: MatMulSpec, batch: int,
               weight_stationary: bool = False) -> LayerStats:
        return fc_cycles(self.acc, s.ni, s.no, s.iprec, s.wprec,
                         s.rows * batch, weight_stationary, self.energy,
                         self.device)

    def network(self, layers: Sequence, batch: int,
                weight_stationary: bool = False) -> LayerStats:
        # the whole network through the search's passes at once
        shapes = [(s.k, s.out, s.ic, s.oc, s.iprec, s.wprec, batch)
                  if isinstance(s, ConvSpec) else
                  (1, 1, s.ni, s.no, s.iprec, s.wprec, s.rows * batch)
                  for s in layers]
        stats = search_layers(self.acc, shapes, weight_stationary,
                              self.energy, self.device)
        total = None
        for st in stats:
            total = st if total is None else total + st
        return total
