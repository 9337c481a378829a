"""Analytic cycle/energy model of the ANT accelerator family, in torch.

Counterpart of the reference's ``perfmodel/model.py``: the BitFusion-
derived simulator (a precision-scalable N x M systolic array with
act/wgt/out SRAMs, double-buffered, a 1024-bit memory interface) and its
exhaustive tiling + loop-order search. The reference loops over the 120
loop orders in Python, each a vectorized numpy pass over one layer's tile
grid; here the orders are the leading dimension of one tensor pass, on
an explicit ``device`` (the card by default), and
a pass takes several layers at once (``search_layers``: each layer's
grid padded to the longest, the padding invalid), so a network costs a
few dispatched passes instead of one per layer.

The result is the reference's ``LayerStats``, int for int. So every
tensor keeps the dtype numpy gives it: the tile grid, the tile counts,
the footprints, the SRAM traffic and the compute cycles are int64; the
promotion walk's bit counts and everything derived from them float64,
floor-divided as ``-(-a // b)`` does; the energy is the reference's
separate roundings in its order (no fused op). The choice is the
reference's two stages in one: least total, then least energy, then the
first loop order in permutation order, then the lowest tiling index.

Quirk preserved bug-for-bug: the read-promotion walk records
``max_read_size = writes[ns]``, so a promoted 'out' read contributes 0
to the final-DRAM-write latency term.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from itertools import permutations
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import _ext

__all__ = ["LOOPS", "TILE_DEPS", "OPREC", "EnergyParams",
           "AcceleratorConfig", "LayerStats", "conv_cycles", "fc_cycles",
           "search_layers", "PASS_ELEMENTS"]

LOOPS = ("B/b", "OW/ow", "OH/oh", "IC/ic", "OC/oc")
# whether each tile loop forces re-reads of act/wgt/out (optimizer.py:18-23)
TILE_DEPS = {
    "B/b": (True, False, True),
    "OW/ow": (True, False, True),
    "OH/oh": (True, False, True),
    "IC/ic": (True, True, False),
    "OC/oc": (False, True, True),
}
OPREC = 16  # accumulator bits counted by the stats model (optimizer.py:63)

# the 120 loop orders, in itertools' permutation order, as loop indices
_ORDERS = tuple(permutations(range(len(LOOPS))))
# the walk's namespaces, in the reference's ``writes`` order
_NS = ("wgt", "act", "out")


@dataclasses.dataclass(frozen=True)
class EnergyParams:
    """pJ-scale per-event costs (EnergyTuple, simulator/energy.py)."""
    core_leak_energy: float
    core_dynamic_energy: float
    wbuf_read_energy: float
    wbuf_write_energy: float
    ibuf_read_energy: float
    ibuf_write_energy: float
    obuf_read_energy: float
    obuf_write_energy: float
    sram_leak_energy: float


@dataclasses.dataclass(frozen=True)
class AcceleratorConfig:
    """Geometry from the reference's conf_*.ini files."""
    n: int = 32                 # systolic rows (inputs)
    m: int = 32                 # systolic cols (outputs)
    pmax: int = 8
    pmin: int = 4
    sram_act: int = 262144      # bytes
    sram_wgt: int = 131072
    sram_out: int = 131072
    mem_if_width: int = 1024    # bits
    frequency: int = 500_000_000

    def perf_factor(self, prec: int) -> int:
        return int(self.pmax / max(prec, self.pmin))


@dataclasses.dataclass
class LayerStats:
    total_cycles: int
    mem_stall_cycles: int
    reads: Dict[str, int]
    writes: Dict[str, int]

    def energy(self, e: EnergyParams) -> float:
        """stats.py:58-80 (absolute scale follows the reference)."""
        dram_leak = 3838.05 / 500000
        dram_rd = 1.18294 / 1024
        dram_wr = 1.47797 / 1024
        dyn = self.total_cycles * (e.core_leak_energy + e.sram_leak_energy
                                   + dram_leak)
        dyn += (self.total_cycles - self.mem_stall_cycles) \
            * e.core_dynamic_energy
        dyn += self.reads["wgt"] * e.wbuf_read_energy
        dyn += self.writes["wgt"] * e.wbuf_write_energy
        dyn += self.reads["act"] * e.ibuf_read_energy
        dyn += self.writes["act"] * e.ibuf_write_energy
        dyn += self.reads["out"] * e.obuf_read_energy
        dyn += self.writes["out"] * e.obuf_write_energy
        dyn += self.reads["dram"] * dram_rd
        dyn += self.writes["dram"] * dram_wr
        return dyn

    def energy_breakdown(self, e: EnergyParams) -> Tuple[float, float,
                                                         float, float]:
        """(static, dram, sram, core), stats.py:84-112."""
        dram_leak = 484.615 / 500
        dram_rd = 0.644304 / 1024
        dram_wr = 0.784104 / 1024
        core = self.total_cycles * e.core_leak_energy
        core += (self.total_cycles - self.mem_stall_cycles) \
            * e.core_dynamic_energy
        sram = (self.reads["wgt"] * e.wbuf_read_energy
                + self.writes["wgt"] * e.wbuf_write_energy
                + self.reads["act"] * e.ibuf_read_energy
                + self.writes["act"] * e.ibuf_write_energy
                + self.reads["out"] * e.obuf_read_energy
                + self.writes["out"] * e.obuf_write_energy)
        dram = (self.reads["dram"] * dram_rd
                + self.writes["dram"] * dram_wr)
        static = self.total_cycles * dram_leak
        return static, dram, sram, core

    def __add__(self, other: "LayerStats") -> "LayerStats":
        return LayerStats(
            self.total_cycles + other.total_cycles,
            self.mem_stall_cycles + other.mem_stall_cycles,
            {k: self.reads[k] + other.reads[k] for k in self.reads},
            {k: self.writes[k] + other.writes[k] for k in self.writes})


def _n_choices(limit: int) -> int:
    """How many power-of-two tile sizes ``limit`` has (optimizer.py:386-433)."""
    return int(math.ceil(math.log2(limit))) + 1 if limit > 1 else 1


@functools.lru_cache(maxsize=None)
def _order_tables(dev: torch.device):
    """The orders (O, 5) as loop indices and each loop's dependences
    (5, 3) in _NS order, made once per device."""
    orders = torch.tensor(_ORDERS, dtype=torch.int64, device=dev)
    deps = torch.tensor([[TILE_DEPS[l][("act", "wgt", "out").index(ns)]
                          for ns in _NS] for l in LOOPS],
                        dtype=torch.bool, device=dev)
    return orders, deps


def _ceil(a, b):
    """Floor division in the dtype of the tensor operands (int64 or
    float64); a float64 tensor is divided by a tensor on its device, as a
    division by a host scalar is a multiply by its reciprocal on CUDA."""
    return -(-a // b)


# the elements of one (order, layer, tiling) tensor of a pass, by device
# type: layers are searched together up to this size. On the card a pass
# costs the host's dispatch of its ops, so it takes as many layers as a
# bounded memory allows (a float64 walk tensor of 3 x 2^22 elements is
# 100 MB); on the CPU it stays cache-sized (the search at vgg16, batch 4,
# took 2.6 s at 2^16 and 5.0 s at 2^22 on one thread of a CPU)
PASS_ELEMENTS = {"cuda": 1 << 22, "cpu": 1 << 16}


def conv_cycles(acc: AcceleratorConfig, K: int, O: int, S: int, IC: int,
                OC: int, iprec: int, wprec: int, B: int,
                weight_stationary: bool = False,
                energy: Optional[EnergyParams] = None,
                device=None) -> LayerStats:
    """Exhaustive tiling + loop-order search of one conv layer on
    ``device`` (the card by default; it raises without one).

    Returns the best-cycles (tie: best-energy) LayerStats, matching
    Simulator.get_conv_cycles (simulator.py:415-490, im2col=True).
    """
    return search_layers(acc, [(K, O, IC, OC, iprec, wprec, B)],
                         weight_stationary, energy, device)[0]


def fc_cycles(acc: AcceleratorConfig, ni: int, no: int, iprec: int,
              wprec: int, batch: int, weight_stationary: bool = False,
              energy: Optional[EnergyParams] = None,
              device=None) -> LayerStats:
    """FC = 1x1 conv (simulator.py:383-403)."""
    return conv_cycles(acc, 1, 1, 1, ni, no, iprec, wprec, batch,
                       weight_stationary, energy, device)


def search_layers(acc: AcceleratorConfig, layers: Sequence[tuple],
                  weight_stationary: bool = False,
                  energy: Optional[EnergyParams] = None,
                  device=None) -> List[LayerStats]:
    """:func:`conv_cycles` of each ``(K, O, IC, OC, iprec, wprec, B)`` in
    ``layers``, in order: the layers go through the search together, each
    its own search, in passes of at most PASS_ELEMENTS[device type]
    (order, layer, tiling) elements, grouped by grid size so that little
    is padding. ``device`` is the card by default."""
    dev = _ext.resolve_device(device)
    n_ord, limit = len(_ORDERS), PASS_ELEMENTS[dev.type]
    sizes = [_n_choices(B) * _n_choices(O) * _n_choices(IC) * _n_choices(OC)
             for K, O, IC, OC, iprec, wprec, B in layers]
    chunks = []       # layer indices, largest grid first
    for j in sorted(range(len(layers)), key=lambda j: -sizes[j]):
        if chunks and (n_ord * (len(chunks[-1]) + 1) * sizes[chunks[-1][0]]
                       <= limit):
            chunks[-1].append(j)
        else:
            chunks.append([j])
    out = [None] * len(layers)
    for chunk in chunks:
        stats = _search_pass(acc, [layers[j] for j in chunk],
                             sizes[chunk[0]], weight_stationary, energy, dev)
        for j, st in zip(chunk, stats):
            out[j] = st
    return out


def _search_pass(acc, layers, n_til, weight_stationary, energy,
                 dev) -> List[LayerStats]:
    """One pass over (order, layer, tiling): every layer's tile grid
    padded to ``n_til`` tilings, the padding invalid."""
    i64, f64 = torch.int64, torch.float64
    n_lay = len(layers)
    cols = torch.tensor(
        [[K, O, IC, OC, iprec, wprec, B, acc.perf_factor(iprec),
          acc.perf_factor(wprec), _n_choices(B), _n_choices(O),
          _n_choices(IC), _n_choices(OC)]
         for K, O, IC, OC, iprec, wprec, B in layers],
        dtype=i64, device=dev).t()[:, :, None]                 # (13, L, 1)
    K, O, IC, OC, iprec, wprec, B, pf_i, pf_w, nb, no_, nic, noc = cols

    # candidate tile sizes (optimizer.py:386-433; im2col keeps OC raw
    # pow2), tiling t of a layer in numpy's meshgrid order: t = ((i_b x
    # n_o + i_o) x n_ic + i_ic) x n_oc + i_oc
    t = torch.arange(n_til, dtype=i64, device=dev)[None, :]    # (1, T)
    pad = t >= nb * no_ * nic * noc
    two = torch.full((), 2, dtype=i64, device=dev)
    oc = torch.minimum(two ** (t % noc), OC)
    ic = torch.minimum(two ** (t // noc % nic), IC)
    ow = torch.minimum(two ** (t // (noc * nic) % no_), O)
    b = torch.minimum(two ** (t // (noc * nic * no_) % nb), B)
    oh = ow
    num_b, num_ow, num_ic, num_oc = (_ceil(B, b), _ceil(O, ow),
                                     _ceil(IC, ic), _ceil(OC, oc))
    num_oh = num_ow
    nums = torch.stack([num_b, num_ow, num_oh, num_ic, num_oc])  # LOOPS

    # initial per-tile SRAM footprints in bits (optimizer.py:54-65)
    w_wgt0 = (_ceil(K * K * ic, acc.n * pf_w) * acc.n * pf_w * oc * wprec)
    w_act0 = (ow * oh * _ceil(K * K * ic, acc.m * pf_i) * acc.m * pf_i
              * b * iprec)
    r_out0 = ow * oh * oc * b * OPREC

    cap_wgt = acc.sram_wgt * 8 / 2
    cap_act = acc.sram_act * 8 / 2
    cap_out = acc.sram_out * 8 / 2
    # int64 against float64 caps, as numpy compares them
    valid = ((w_wgt0.to(f64) <= cap_wgt)
             & (w_act0.to(f64) <= cap_act) & ~pad)  # w_out0 == 0

    # compute cycles per tile (accelerator.py:98-126, im2col)
    ni = K * K * ic
    no = oc
    batch = b * oh * ow
    if weight_stationary:
        tile_cycles = batch * _ceil(no, acc.m * pf_w) * _ceil(ni, acc.n * pf_i)
    else:
        tile_cycles = (_ceil(batch, acc.n * pf_i)
                       * _ceil(no, acc.m * pf_w) * ni)
    num_tiles = num_b * num_ow * num_oh * num_ic * num_oc
    compute_cycles = num_tiles * tile_cycles

    # per-tile SRAM traffic (optimizer.py:162-175)
    if weight_stationary:
        sr_act = num_tiles * (K * K * ic * oc) * (b * ow * oh) * iprec
        sr_out_r = num_tiles * (K * K * ic * oc) * (b * ow * oh) * OPREC
        sw_out = sr_out_r
        sr_wgt = num_tiles * (K * K * ic * oc) * wprec
    else:
        sr_act = num_tiles * (oc * oh * ow * b) * (K * K * ic) * iprec
        sw_out = num_tiles * (oc * oh * ow * b) * OPREC
        sr_wgt = num_tiles * (oc * oh * ow * b) * (K * K * ic) * wprec
        sr_out_r = num_tiles * (oc * oh * ow * b) * OPREC

    # SRAM promotion walk (optimizer.py:109-149), every order at once:
    # (namespace, order, layer, tiling) for the writes in _NS order,
    # (order, layer, tiling) for the 'out' reads
    n_ord = len(_ORDERS)
    orders, deps = _order_tables(dev)
    shape = (n_ord, n_lay, n_til)
    caps = torch.tensor([cap_wgt, cap_act, cap_out], dtype=f64,
                        device=dev)[:, None, None, None]
    writes = torch.stack([w_wgt0, w_act0, torch.zeros_like(w_wgt0)]).to(
        f64)[:, None].expand(3, *shape).clone()
    reads = r_out0.to(f64).expand(shape).clone()
    max_w = writes.clone()
    max_r = reads.clone()
    w_prom = torch.ones((3, *shape), dtype=torch.bool, device=dev)
    r_prom = torch.ones(shape, dtype=torch.bool, device=dev)
    for level in reversed(range(len(LOOPS))):
        loop = orders[:, level]                                 # (O,)
        nt = nums.index_select(0, loop)                         # (O, L, T)
        dep = deps.index_select(0, loop).t()[:, :, None, None]  # (3, O, 1, 1)
        grow = writes * nt
        writes = torch.where(w_prom & ~dep, writes, grow)
        over = w_prom & dep & (grow > caps)
        max_w = torch.where(w_prom & dep & ~over, grow, max_w)
        w_prom = w_prom & ~over
        dep_out = dep[2]
        grow = reads * nt
        reads = torch.where(r_prom & ~dep_out, reads, grow)
        over = r_prom & dep_out & (grow > cap_out)
        # reference quirk: records *writes*, not reads
        max_r = torch.where(r_prom & dep_out & ~over, writes[2], max_r)
        r_prom = r_prom & ~over

    width = torch.tensor(acc.mem_if_width, dtype=f64, device=dev)
    dram_r = writes[0] + writes[1] + writes[2]
    dram_w = reads
    initial = max_w[0] + max_w[1] + max_w[2]
    final = max_r
    latency = _ceil(initial, width) + _ceil(final, width)
    middle = dram_r + dram_w - initial - final
    mem_cycles = _ceil(middle, width)
    stalls = torch.clamp_min(mem_cycles - compute_cycles, 0) + latency
    total = compute_cycles + stalls
    total = torch.where(valid, total, math.inf)

    if energy is not None:
        e = energy
        dram_leak = 3838.05 / 500000
        f = lambda t: t.to(f64)
        en = total * (e.core_leak_energy + e.sram_leak_energy + dram_leak)
        en = en + (total - stalls) * e.core_dynamic_energy
        en = en + (f(sr_wgt) * e.wbuf_read_energy
                   + writes[0] * e.wbuf_write_energy
                   + f(sr_act) * e.ibuf_read_energy
                   + writes[1] * e.ibuf_write_energy
                   + (sr_out_r + reads) * e.obuf_read_energy
                   + (sw_out + writes[2]) * e.obuf_write_energy)
        en = en + dram_r * (1.18294 / 1024) + dram_w * (1.47797 / 1024)
    else:
        en = torch.zeros_like(total)

    # per layer: least total, then least energy among those, then the
    # first of the (order, tiling) grid in order-major order (the
    # reference's lexsort within an order and strict "<" across orders);
    # invalid tilings never reach a reduction but the first
    t_min = total.amin(dim=(0, 2), keepdim=True)
    tied = total == t_min
    e_min = torch.where(tied, en, math.inf).amin(dim=(0, 2), keepdim=True)
    first = (tied & (en == e_min)).transpose(0, 1).reshape(n_lay, -1)
    pick = torch.argmax(first.to(torch.uint8), dim=1)           # (L,)
    o, i = pick // n_til, pick % n_til
    lay = torch.arange(n_lay, device=dev)
    at = lambda x: x[lay, i]
    at_o = lambda x: x[o, lay, i]
    ints = torch.stack([at(sr_act), at(sr_wgt), at(sr_out_r), at(sw_out)])
    floats = torch.stack([at_o(total), at_o(stalls), at_o(writes[0]),
                          at_o(writes[1]), at_o(writes[2]), at_o(reads),
                          at_o(dram_r), at_o(dram_w)])
    stats = []
    for (sr_a, sr_w, sr_o, sw_o), (tot, stl, w_wgt, w_act, w_out, r_out,
                                    d_r, d_w) in zip(ints.t().tolist(),
                                                     floats.t().tolist()):
        if not math.isfinite(tot):
            raise AssertionError("no feasible tiling (SRAM too small?)")
        stats.append(LayerStats(
            int(tot), int(stl),
            {"act": sr_a, "wgt": sr_w, "out": int(sr_o + r_out),
             "dram": int(d_r)},
            {"act": int(w_act), "wgt": int(w_wgt),
             "out": int(sw_o + w_out), "dram": int(d_w)}))
    return stats
