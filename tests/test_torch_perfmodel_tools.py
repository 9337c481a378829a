"""PyTorch port vs the JAX reference: the performance model's command
lines ``simulate``, ``arch_sweep``, ``print_result`` and
``plot_results``.

Each port tool's ``main(argv)`` prints what the reference's
``tools/<name>.py`` prints (loaded with importlib) and writes the same
files: ``simulate`` and ``arch_sweep`` (its sweep and
``--variable-precision``) with their search on ``--device cpu``;
``print_result`` on result JSONs; ``plot_results`` on a ``simulate`` CSV
in a ``tmp_path`` (its PNGs byte for byte). Without ``--device cpu`` the
search needs a card, and ``plot_results`` raises a clear error where
matplotlib is missing. The reference's full table and its ``arch_sweep``
lines are those that ``chip_smoke.py`` holds the card's runs to."""

import contextlib
import csv
import functools
import hashlib
import importlib.util
import io
import json
import os
import sys

import pytest
import torch

import chip_smoke as cs
from ant_quantization_tpu_torch.tools import (arch_sweep, plot_results,
                                              print_result, simulate)

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.torchdep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=None)
def _ref_tool(name):
    """The reference's ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def _read(path) -> str:
    with open(path) as f:
        return f.read()


@functools.lru_cache(maxsize=None)
def _ref_simulate(out_dir: str, args: tuple):
    path = os.path.join(out_dir, "ref.csv")
    text = _stdout(_ref_tool("simulate").main, list(args) + ["--out", path])
    return text.replace(path, "OUT"), _read(path)


@pytest.mark.parametrize("net", ["resnet18", "vgg16"])
def test_simulate_matches_reference(net, tmp_path_factory):
    ref_dir = str(tmp_path_factory.mktemp("simulate_ref"))
    args = ("--nets", net, "--batch", "1")
    want_text, want_csv = _ref_simulate(ref_dir, args)
    path = str(tmp_path_factory.mktemp(net) / "ant_res.csv")
    text = _stdout(simulate.main,
                   list(args) + ["--device", "cpu", "--out", path])
    assert text.replace(path, "OUT") == want_text
    assert _read(path) == want_csv
    assert "wrote 6 rows to OUT" in want_text


def test_full_table_is_chip_smokes(tmp_path):
    """The reference's full table at batch 64 and its ``arch_sweep`` lines
    are the constants the card's runs are held to."""
    path = str(tmp_path / "ant_res.csv")
    _stdout(_ref_tool("simulate").main,
            ["--batch", str(cs.PM_BATCH), "--out", path])
    with open(path, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == cs.PM_TABLE_SHA256
    with open(path) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 48
    assert cs.fig13_geomeans(rows) == cs.PM_TABLE_GEOMEANS
    for argv, want in cs.PM_ARCH.items():
        assert _stdout(_ref_tool("arch_sweep").main, list(argv)) == want


def test_simulate_search_needs_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate.main(["--nets", "resnet18", "--batch", "1",
                       "--out", str(tmp_path / "x.csv")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        arch_sweep.main(["--variable-precision", "--nets", "vgg16"])


@pytest.mark.parametrize("table", ["ant", "olaccel"])
def test_arch_sweep_variable_precision_matches_reference(table):
    args = ["--variable-precision", "--nets", "vgg16", "--batch", "4",
            "--table", table]
    want = _stdout(_ref_tool("arch_sweep").main, args)
    assert _stdout(arch_sweep.main, args + ["--device", "cpu"]) == want
    assert want.startswith("variable-precision speedup: ")


def test_arch_sweep_matches_reference(tmp_path):
    args = ["--nets", "vgg16", "--batch", "1", "--sram-kb", "32", "64",
            "--rank", "edp", "--top", "5"]
    ref_csv, port_csv = str(tmp_path / "ref.csv"), str(tmp_path / "port.csv")
    want = _stdout(_ref_tool("arch_sweep").main, args + ["--out", ref_csv])
    got = _stdout(arch_sweep.main, args + ["--device", "cpu",
                                           "--out", port_csv])
    assert got.replace(port_csv, "OUT") == want.replace(ref_csv, "OUT")
    assert _read(port_csv) == _read(ref_csv)
    # a budget nothing fits
    tiny = ["--budget", "0.01", "--nets", "vgg16", "--sram-kb", "32"]
    assert _stdout(arch_sweep.main, tiny + ["--device", "cpu"]) == \
        _stdout(_ref_tool("arch_sweep").main, tiny) == \
        "no configuration fits the area budget\n"


RESULT_ROWS = [
    {"task": "cola", "mode": "int", "mcc": 0.0},
    {"task": "cola", "mode": "ant-int-pot", "mcc": 52.61},
    {"task": "cola", "mode": "ant-int-pot-flint", "mcc": 53.91},
    {"task": "cola", "mode": "ant-int-pot-flint", "mcc": 56.33, "n8": 10},
    {"task": "sst2", "mode": "int", "accuracy": 79.93},
    {"task": "sst2", "mode": "ant-int-flint", "accuracy": 91.2,
     "f1": 90.0},
    {"model": "gpt2-xl", "mode": "ant-int-flint", "perplexity": 19.11},
    {"model": "resnet18", "mode": "ant-int-pot-float", "top1": 69.5},
    {"model": "vit", "mode": "custom", "top1": 80.1},
    {"no_mode": 1},
]


@pytest.mark.parametrize("metric", [[], ["--metric", "f1"]])
def test_print_result_matches_reference(tmp_path, metric):
    for i, r in enumerate(RESULT_ROWS):
        (tmp_path / f"r{i}.json").write_text(json.dumps(r))
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "bert_ANT4-8.json").write_text(
        json.dumps({"task": "mrpc", "mode": "int", "f1": 88.0}))
    (tmp_path / "broken.json").write_text("{")
    err_p, err_r = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err_p):
        got = _stdout(print_result.main, [str(tmp_path)] + metric)
    with contextlib.redirect_stderr(err_r):
        want = _stdout(_ref_tool("print_result").main,
                       [str(tmp_path)] + metric)
    assert got == want and err_p.getvalue() == err_r.getvalue()
    lines = got.splitlines()
    assert lines[0].strip().split("|")[-1].strip() == "ANT4-8"
    assert any(l.startswith("gpt2-xl") and "19.11" in l for l in lines)
    (tmp_path / "empty").mkdir()
    for main in (print_result.main, _ref_tool("print_result").main):
        with pytest.raises(SystemExit, match="no result files"):
            main([str(tmp_path / "empty")])


def test_plot_results_matches_reference(tmp_path):
    csv_path = str(tmp_path / "res.csv")
    simulate.main(["--nets", "resnet18", "--batch", "1", "--device", "cpu",
                   "--out", csv_path])
    outs = {}
    for name, main in (("port", plot_results.main),
                       ("ref", _ref_tool("plot_results").main)):
        d = str(tmp_path / name)
        outs[name] = (d, _stdout(main, [csv_path, "--out", d,
                                        "--accels", "ant_os", "adafloat"]))
    (pd, ptext), (rd, rtext) = outs["port"], outs["ref"]
    assert ptext.replace(pd, "OUT") == rtext.replace(rd, "OUT")
    for fig in ("cycles", "energy"):
        for ext in (".png", ".pdf"):
            assert os.path.getsize(os.path.join(pd, fig + ext)) > 1000
        with open(os.path.join(pd, fig + ".png"), "rb") as a, \
                open(os.path.join(rd, fig + ".png"), "rb") as b:
            assert a.read() == b.read(), fig
    rows = plot_results.read_rows(csv_path)
    assert rows == _ref_tool("plot_results").read_rows(csv_path)


def test_plot_results_without_matplotlib(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="needs matplotlib"):
        plot_results.main([str(tmp_path / "res.csv")])
