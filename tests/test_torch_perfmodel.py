"""PyTorch port vs the JAX reference: ``perfmodel/``.

The port's tensor search (``model.conv_cycles``/``fc_cycles`` and
``search_layers``: the 120 loop orders and the layers as tensor
dimensions) on the CPU gives ``LayerStats`` equal to the reference's
numpy search and to its native optimizer (``csrc/tileopt.cc``), int for
int, on ``tests/test_perfmodel.py``'s cases, output- and
weight-stationary; ``energy_params`` for every configuration; the SRAM
model against the reference's; the results module's rows and the
architecture sweep's candidates, points and variable-precision benefit;
the graph IR and the loop nest on the inputs of ``test_graph_ir.py`` and
``test_loopnest.py``. The search needs a card unless the CPU is asked
for."""

import dataclasses
import functools
import itertools

import pytest
import torch

from ant_quantization_tpu.perfmodel import arch as jarch
from ant_quantization_tpu.perfmodel import energy as jenergy
from ant_quantization_tpu.perfmodel import graph as JG
from ant_quantization_tpu.perfmodel import loopnest as jloop
from ant_quantization_tpu.perfmodel import model as jmodel
from ant_quantization_tpu.perfmodel import results as jresults
from ant_quantization_tpu.perfmodel import simulator as jsim
from ant_quantization_tpu.perfmodel import sram as jsram
from ant_quantization_tpu_torch.perfmodel import arch as tarch
from ant_quantization_tpu_torch.perfmodel import energy as tenergy
from ant_quantization_tpu_torch.perfmodel import graph as TG
from ant_quantization_tpu_torch.perfmodel import loopnest as tloop
from ant_quantization_tpu_torch.perfmodel import model as tmodel
from ant_quantization_tpu_torch.perfmodel import results as tresults
from ant_quantization_tpu_torch.perfmodel import simulator as tsim
from ant_quantization_tpu_torch.perfmodel import sram as tsram

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.torchdep

# tests/test_perfmodel.py's cases: (K, O, S, IC, OC, iprec, wprec, B) and
# the FC cases (ni, no, iprec, wprec, rows) as 1x1 convs
CASES = [
    (3, 56, 1, 64, 64, 4, 4, 4),
    (7, 112, 2, 3, 64, 8, 8, 4),
    (1, 28, 1, 256, 512, 4, 4, 2),
    (3, 14, 2, 256, 512, 4, 8, 1),
]
FC_CASES = [
    (768, 3072, 4, 4, 128),
    (25088, 4096, 4, 4, 1),
]
ALL = CASES + [(1, 1, 1, ni, no, ip, wp, rows)
               for ni, no, ip, wp, rows in FC_CASES]


def _port_acc(acc):
    return tmodel.AcceleratorConfig(**dataclasses.asdict(acc))


def _port_energy(e):
    return tmodel.EnergyParams(**dataclasses.asdict(e))


@functools.lru_cache(maxsize=None)
def _jax_search(case, ws):
    K, O, S, IC, OC, ip, wp, B = case
    acc = jenergy.CONFIGS["ant"]
    return jmodel.conv_cycles(acc, K, O, S, IC, OC, ip, wp, B, ws,
                              jenergy.energy_params(acc))


@functools.lru_cache(maxsize=None)
def _port_search(case, ws):
    K, O, S, IC, OC, ip, wp, B = case
    acc = jenergy.CONFIGS["ant"]
    return tmodel.conv_cycles(_port_acc(acc), K, O, S, IC, OC, ip, wp, B,
                              ws, _port_energy(jenergy.energy_params(acc)),
                              device="cpu")


def _same(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b), (a, b)
    assert all(type(v) is int for v in
               [a.total_cycles, a.mem_stall_cycles, *a.reads.values(),
                *a.writes.values()]), a


@pytest.mark.parametrize("ws", [False, True])
@pytest.mark.parametrize("case", ALL)
def test_search_matches_reference(case, ws):
    _same(_port_search(case, ws), _jax_search(case, ws))


@pytest.mark.parametrize("ws", [False, True])
@pytest.mark.parametrize("case", ALL)
def test_search_matches_reference_native(case, ws):
    """The port's search through its ``Simulator`` against the
    reference's native optimizer."""
    K, O, S, IC, OC, ip, wp, B = case
    acc = jenergy.CONFIGS["ant"]
    ref = jsim.Simulator(acc, jenergy.energy_params(acc), use_native=True)
    assert ref.use_native, "csrc/libtileopt.so not built (make -C csrc)"
    port = tsim.Simulator.named("ant", device="cpu")
    if (K, O) == (1, 1):
        got = port.matmul(tsim.MatMulSpec(IC, OC, ip, wp, B), 1, ws)
        spec = (1, 1, 1, IC, OC, B, ip, wp, ws)
    else:
        got = port.conv(tsim.ConvSpec(K, O, S, IC, OC, ip, wp), B, ws)
        spec = (K, O, S, IC, OC, B, ip, wp, ws)
    _same(got, ref._conv_native(*spec))
    _same(got, _port_search(case, ws))


@pytest.mark.parametrize("limit", [1 << 12, 1 << 22])
@pytest.mark.parametrize("ws", [False, True])
def test_layers_searched_together(ws, limit, monkeypatch):
    """``search_layers`` over all the cases at once, in passes of one layer
    (2^12 elements) and of the card's size (2^22: several layers, each
    grid padded to the pass's largest): each layer's stats are the
    reference's, in the order given."""
    monkeypatch.setitem(tmodel.PASS_ELEMENTS, "cpu", limit)
    acc = jenergy.CONFIGS["ant"]
    shapes = [(K, O, IC, OC, ip, wp, B)
              for K, O, S, IC, OC, ip, wp, B in ALL]
    got = tmodel.search_layers(_port_acc(acc), shapes, ws, _port_energy(
        jenergy.energy_params(acc)), device="cpu")
    assert len(got) == len(ALL)
    for st, case in zip(got, ALL):
        _same(st, _jax_search(case, ws))


def test_fc_and_network_routes():
    """fc_cycles is the 1x1 conv, on both sides; a network's sum on the
    search route equals the reference's."""
    acc = jenergy.CONFIGS["olaccel"]
    e = jenergy.energy_params(acc)
    _same(tmodel.fc_cycles(_port_acc(acc), 512, 1000, 8, 8, 4, True,
                           _port_energy(e), device="cpu"),
          jmodel.fc_cycles(acc, 512, 1000, 8, 8, 4, True, e))
    layers = [(3, 56, 1, 64, 64, 4, 4), (512, 1000, 8, 8)]
    jl = [jsim.ConvSpec(*layers[0]), jsim.MatMulSpec(*layers[1])]
    tl = [tsim.ConvSpec(*layers[0]), tsim.MatMulSpec(*layers[1])]
    want = jsim.Simulator.named("ant", use_native=False).network(jl, 4)
    got = tsim.Simulator.named("ant", device="cpu").network(tl, 4)
    _same(got, want)
    assert got.energy(_port_energy(jenergy.energy_params(
        jenergy.CONFIGS["ant"]))) == want.energy(jenergy.energy_params(
            jenergy.CONFIGS["ant"]))
    e = jenergy.energy_params(jenergy.CONFIGS["ant"])
    assert got.energy_breakdown(_port_energy(e)) == want.energy_breakdown(e)


def test_no_feasible_tiling_raises():
    tiny = tmodel.AcceleratorConfig(sram_act=16, sram_wgt=16, sram_out=16)
    with pytest.raises(AssertionError, match="no feasible tiling"):
        tmodel.conv_cycles(tiny, 3, 8, 1, 64, 64, 8, 8, 1, device="cpu")
    sim = tsim.Simulator(tiny, device="cpu")
    with pytest.raises(AssertionError, match="no feasible tiling"):
        sim.conv(tsim.ConvSpec(3, 8, 1, 64, 64, 8, 8), 1)


@pytest.mark.parametrize("name", sorted(jenergy.CONFIGS))
def test_energy_params_match_reference(name):
    acc = jenergy.CONFIGS[name]
    assert dataclasses.asdict(tenergy.CONFIGS[name]) == \
        dataclasses.asdict(acc)
    assert dataclasses.asdict(tenergy.energy_params(tenergy.CONFIGS[name])) \
        == dataclasses.asdict(jenergy.energy_params(acc))
    # off the measured table: the SRAM model's extrapolation
    odd = dataclasses.replace(acc, sram_act=96 * 1024, sram_out=48 * 1024)
    assert dataclasses.asdict(tenergy.energy_params(_port_acc(odd))) == \
        dataclasses.asdict(jenergy.energy_params(odd))


SRAM_POINTS = list(itertools.product(
    (128.0, 1000.0, 4096.0, 8192.0, 65536.0, 3.5e5), (4.0, 64.0, 100.0),
    (0, 1)))


def test_sram_model_matches_reference():
    """The port's formulas against the reference's ``csrc/sram_model.cc``
    (bound where built, its own formulas otherwise)."""
    assert jsram._lib() is not None, "csrc/libsram_model.so not built"
    for s, b, p in SRAM_POINTS:
        assert tsram.sram_bank_model(s, b, p) == \
            jsram.sram_bank_model(s, b, p), (s, b, p)
        assert tsram.sram_area_mm2(s, b, p) == jsram.sram_area_mm2(s, b, p)


def test_search_needs_a_card(monkeypatch):
    """Every entry point runs the search on the card unless the CPU is
    asked for, and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    acc = tenergy.CONFIGS["ant"]
    calls = [
        lambda: tsim.Simulator.named("ant"),
        lambda: tresults.normalized_results(batch=1, nets=["resnet18"]),
        lambda: tarch.evaluate(acc, ["resnet18"], batch=1),
        lambda: tmodel.conv_cycles(acc, 3, 8, 1, 16, 16, 8, 8, 1),
        lambda: tmodel.fc_cycles(acc, 16, 16, 8, 8, 1),
        lambda: tmodel.search_layers(acc, [(1, 1, 16, 16, 8, 8, 1)]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert tsim.Simulator.named("ant", device="cpu").device.type == "cpu"


@functools.lru_cache(maxsize=None)
def _jax_rows():
    return jresults.normalized_results(nets=["resnet18"])


def test_normalized_results_match_reference():
    rows = tresults.normalized_results(nets=["resnet18"], device="cpu")
    assert rows == _jax_rows()
    assert tresults.summarize(rows) == jresults.summarize(rows)
    assert tresults.format_summary(rows) == jresults.format_summary(rows)
    assert tresults.ACCELS == jresults.ACCELS


def test_arch_candidates_and_areas_match_reference():
    for budget, kb in ((3.5, (32, 64, 128, 256)), (10.0, (64, 512))):
        got = tarch.candidates(budget, sram_kb=kb)
        want = jarch.candidates(budget, sram_kb=kb)
        assert [dataclasses.asdict(c) for c in got] == \
            [dataclasses.asdict(c) for c in want]
        assert [tarch.total_area_mm2(c) for c in got] == \
            [jarch.total_area_mm2(c) for c in want]
    assert tarch.pe_area_mm2(8, 4) == jarch.pe_area_mm2(8, 4)


def _point(p):
    return (dataclasses.asdict(p.cfg), p.area_mm2, p.mean_cycles,
            p.mean_energy_nj, p.edp)


@pytest.mark.parametrize("table", ["ant", "bitfusion"])
def test_variable_precision_benefit_matches_reference(table):
    cfg = dataclasses.replace(jenergy.CONFIGS["ant"], n=8, m=8)
    want = jarch.variable_precision_benefit(cfg, ["vgg16"], table, batch=4)
    got = tarch.variable_precision_benefit(_port_acc(cfg), ["vgg16"], table,
                                           batch=4, device="cpu")
    assert got["speedup"] == want["speedup"]
    assert got["area_overhead"] == want["area_overhead"]
    for k in ("variable", "fixed"):
        assert _point(got[k]) == _point(want[k]), k


def test_arch_sweep_matches_reference():
    kw = dict(batch=1, arrays=[(8, 8), (16, 16)], sram_kb=(32, 64))
    for rank in ("cycles", "edp"):
        got = tarch.sweep(3.5, ["vgg16"], rank=rank, device="cpu", **kw)
        want = jarch.sweep(3.5, ["vgg16"], rank=rank, **kw)
        assert [_point(p) for p in got] == [_point(p) for p in want], rank


# --------------------------------------------------------------------------
# the graph IR and the loop nest, on test_graph_ir.py's and
# test_loopnest.py's inputs
# --------------------------------------------------------------------------


def _vgg_block(G):
    g = G.Graph("block")
    with g:
        x = g.tensor((1, 32, 32, 3), "input", G.FQDtype.FXP8)
        with g.name_scope("conv1"):
            w = g.tensor((3, 3, 3, 16), "w", G.FQDtype.FXP4)
            x = G.conv2D(x, w, stride=1, pad=1)
            x = G.relu(x)
        x = G.maxPool(x, 2, 2)
        with g.name_scope("fc"):
            x = G.flatten(x)
            w2 = g.tensor((x.shape[-1], 10), "w", G.FQDtype.FXP4)
            x = G.matmul(x, w2)
    return g, x


def _lowered(G):
    g = G.Graph()
    with g:
        x = g.tensor((1, 56, 56, 64), "x", G.FQDtype.FXP4)
        w = g.tensor((3, 3, 64, 64), "w", G.FQDtype.FXP4)
        h = G.conv2D(x, w, stride=1, pad=1, name="c1")
        h = G.relu(h)
        h = G.flatten(h)
        wf = g.tensor((h.shape[-1], 100), "wf", G.FQDtype.FXP8)
        G.matmul(h, wf, name="m1")
        s = g.tensor((8, 128, 768), "acts", G.FQDtype.FXP4)
        G.matmul(s, g.tensor((768, 768), "w2", G.FQDtype.FXP4))
        a = g.tensor((1, 8, 8, 16), "a")
        b = g.tensor((1, 8, 8, 32), "b")
        c = G.concat([a, b], axis=-1)
        G.add(c, g.tensor((1, 8, 8, 48), "e"))
        y = G.conv2D(g.tensor((1, 224, 224, 3), "img"),
                     g.tensor((7, 7, 3, 64), "w7"), stride=2, pad=3)
        G.conv2D(g.tensor((1, 28, 28, 8), "x2"),
                 g.tensor((3, 3, 8, 8), "w3"), pad="SAME")
    return g, y


def _graph_summary(g, out):
    return (out.shape, sorted(g.ops), sorted(g.tensors),
            [(t.name, t.shape, str(t.dtype), t.size, t.size_in_bits,
              t.size_in_bytes) for t in g.tensors.values()],
            [(n, type(op).__name__, op.output.name)
             for n, op in g.ops.items()])


def test_graph_ir_matches_reference():
    for build in (_vgg_block, _lowered):
        (tg, tout), (jg, jout) = build(TG), build(JG)
        assert _graph_summary(tg, tout) == _graph_summary(jg, jout)
        got, want = TG.to_layer_specs(tg), JG.to_layer_specs(jg)
        assert [(type(s).__name__, dataclasses.asdict(s)) for s in got] == \
            [(type(s).__name__, dataclasses.asdict(s)) for s in want]
    specs = TG.to_layer_specs(_lowered(TG)[0])[:2]
    _same(tsim.Simulator.named("ant", device="cpu").network(specs, batch=4),
          jsim.Simulator.named("ant", use_native=False).network(
              JG.to_layer_specs(_lowered(JG)[0])[:2], batch=4))
    presets = lambda G: [(k, str(v), v.bits, getattr(v, "frac", None))
                         for k, v in vars(G.FQDtype).items()
                         if isinstance(v, G.Dtype)]
    assert presets(TG) == presets(JG) and len(presets(TG)) == 10
    assert str(TG.FQDtype.fxp(5)) == str(JG.FQDtype.fxp(5))


def _nests(L):
    mm = lambda: L.LoopNest([
        L.Loop("oc", 4, {"wgt": 1, "act": 0, "out": 1}),
        L.Loop("ic", 8, {"wgt": 1, "act": 1, "out": 0})])
    a = mm()
    a.add_read("wgt", 100)
    a.add_read("act", 50)
    a.add_write("out", 10)
    b = mm()
    b.add_write("out", 10)
    b.add_read("act", 50)
    b.promote({"wgt": 0, "act": 0, "out": 0})
    c = L.LoopNest([L.Loop("b", 3, {"wgt": 0}), L.Loop("oc", 4, {"wgt": 1}),
                    L.Loop("ow", 5, {"wgt": 0})])
    c.add_read("wgt", 7)
    c.promote({"wgt": 0})
    out = [a, b, c]
    for sram in (1000, 10_000):
        n = L.LoopNest([L.Loop("oc", 4, {"wgt": 1}),
                        L.Loop("ic", 8, {"wgt": 1})])
        n.add_read("wgt", 100)
        n.promote({"wgt": sram})
        out.append(n)
    d = mm()
    d.add_read("wgt", 4)
    d.promote({"wgt": 0})
    out.append(d)
    return out


def test_loopnest_matches_reference():
    for got, want in zip(_nests(tloop), _nests(jloop)):
        assert got.traffic() == want.traffic()
        assert got.describe() == want.describe()
        assert [(o.promoted_level, o.promoted_size) for o in got.ops] == \
            [(o.promoted_level, o.promoted_size) for o in want.ops]
