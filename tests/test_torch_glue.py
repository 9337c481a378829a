"""PyTorch port vs the JAX reference: the GLUE harness and the recipe
runner, on the CPU.

- ``harness/metrics.py``: every GLUE metric, Spearman with ties,
  multiclass Matthews correlation, perplexity past overflow, and the
  SQuAD metrics equal to the reference's (the same arithmetic: exact);
- ``harness/data.py``: ``load_glue_split`` on a generated TSV in every
  task's column layout and on jsonl, and ``encode_glue_batch`` with the
  port's WordPiece, equal to the reference's with its own;
- ``harness/evaluate.py:glue_eval`` on a 2-layer BERT (the reference's
  params carried across): the same predictions (classification) and
  metrics within 1e-9 (regression: logits within 1e-5, so the
  correlations within 1e-5);
- ``tools/glue_run.py``: ``main`` against the reference's (in process,
  both packages' base presets patched to a 2-layer BERT and a 1 + 1-layer
  BART of d_model 32 with vocab 30,522, so that the synthetic ids fit) on
  a generated HF directory (fp16 safetensors), WordPiece vocabulary and
  TSVs: BERT on the TSV route under ANT (the CLI's defaults) and the
  synthetic route unquantized, BART on the TSV route unquantized and the
  synthetic route under ANT with ``--n8`` (OliVe through a CLI is held
  in ``tests/test_torch_squad.py``). The same predictions, and the
  printed JSON equal (metrics within 1e-9). A run without ``--device
  cpu`` where there is no card raises (``--train`` too; the training
  itself is held in ``tests/test_torch_image_tools.py``), and so does a
  multi-host environment;
- ``tools/run_recipe.py``: every ``[[run]]`` of the six recipes maps to
  the port's module with the reference's flags, each accepted by the
  port's parser, or raises naming its ROADMAP item (a tool the port
  lacks); ``--set`` applies per run; ``--list`` and ``--dry-run``.

The generated data comes from ``chip_smoke.py``'s writers, which the
card's ``encoders`` phase uses at full size.
"""

import contextlib
import functools
import glob
import importlib.util
import io
import json
import os
import sys
import tempfile
from unittest import mock

import numpy as np
import pytest
import torch

from ant_quantization_tpu.harness import data as jD
from ant_quantization_tpu.harness import evaluate as jev
from ant_quantization_tpu.harness import metrics as jM
from ant_quantization_tpu.harness import tokenization as jtok
from ant_quantization_tpu.models import bart as jba
from ant_quantization_tpu.models import bert as jb
from ant_quantization_tpu.nn.config import QuantConfig as JQ
from ant_quantization_tpu_torch.harness import data as tD
from ant_quantization_tpu_torch.harness import evaluate as tev
from ant_quantization_tpu_torch.harness import metrics as tM
from ant_quantization_tpu_torch.harness import tokenization as ttok
from ant_quantization_tpu_torch.models import bart as tba
from ant_quantization_tpu_torch.models import bert as tb
from ant_quantization_tpu_torch.parallel.distributed import (free_port,
                                                             shutdown)
from ant_quantization_tpu_torch.tools import glue_run, run_recipe

import chip_smoke as cs
import test_torch_bert as tbert

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.torchdep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC_ATOL = 1e-9
TINY_BERT = dict(vocab_size=30522, d_model=32, n_layers=2, n_heads=4,
                 d_ff=32, max_seq=64)
TINY_BART = dict(vocab_size=30522, d_model=32, enc_layers=1, dec_layers=1,
                 n_heads=4, d_ff=32, max_seq=64)


def load_reference_tool(name):
    """The reference's ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _metric_cases():
    rng = np.random.default_rng(0)
    b = lambda n: rng.integers(0, 2, n)
    m = lambda n: rng.integers(0, 3, n)
    ties = rng.integers(0, 4, 40).astype(float)       # Spearman ties
    return {
        "binary": (b(50), b(50)),
        "multiclass": (m(60), m(60)),
        "constant_preds": (np.zeros(20, int), b(20)),
        "no_true_positive": (np.zeros(10, int), np.ones(10, int)),
        "regression_ties": (ties, ties + rng.integers(0, 2, 40)),
        "regression": (rng.normal(size=30), rng.normal(size=30)),
    }


@pytest.mark.parametrize("case", sorted(_metric_cases()))
def test_metrics_equal_the_reference(case):
    preds, labels = _metric_cases()[case]
    for name in ("accuracy", "matthews_corrcoef", "f1_binary", "pearson",
                 "spearman", "acc_and_f1", "pearson_and_spearman"):
        assert getattr(tM, name)(preds, labels) == \
            getattr(jM, name)(preds, labels), name
    for task in jD.GLUE_TASKS:
        if (task == "stsb") == case.startswith("regression"):
            assert tM.glue_compute_metrics(task, preds, labels) == \
                jM.glue_compute_metrics(task, preds, labels), task


def test_perplexity_and_squad_metrics_equal_the_reference():
    for loss in (0.0, 3.25, 1e4):
        assert tM.perplexity(loss) == jM.perplexity(loss)
    assert tM.perplexity(1e4) == float("inf")
    preds = {"a": "The cat sat", "b": "", "c": "a dog!", "d": "x y"}
    refs = {"a": ["the cat sat down", "cat sat"], "b": [], "c": ["Dog"],
            "d": ["y z", "w"], "e": ["missing"]}
    for no_ans in ((), ("b",)):
        assert tM.squad_metrics(preds, refs, no_ans) == \
            jM.squad_metrics(preds, refs, no_ans)


# ---------------------------------------------------------------------------
# GLUE data
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def sentences():
    return tuple(cs.enc_sentences(cs.ENC_SEED))


@functools.lru_cache(maxsize=None)
def vocab_file() -> str:
    d = tempfile.mkdtemp(prefix="wordpiece_")
    path = os.path.join(d, "vocab.txt")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(cs.wordpiece_vocab(sentences(), 800)) + "\n")
    return path


def glue_dir(task, n_train, n_dev, seed=0) -> str:
    """A GLUE task directory in ``task``'s TSV layout."""
    d = tempfile.mkdtemp(prefix=f"glue_{task}_")
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("dev", n_dev)):
        fname = tD.GLUE_TASKS[task]["dev"] if split == "dev" \
            else f"{split}.tsv"
        cs.write_glue_tsv(os.path.join(d, fname), task,
                          cs.glue_rows(task, list(sentences()), n, rng))
    return d


def _rows(examples):
    return [(e.text_a, e.text_b, e.label) for e in examples]


@pytest.mark.parametrize("task", sorted(tD.GLUE_TASKS))
def test_load_glue_split_tsv(task):
    d = glue_dir(task, 5, 7, seed=len(task))
    for split in ("train", "dev"):
        got = tD.load_glue_split(d, task, split)
        assert len(got) == (5 if split == "train" else 7)
        assert _rows(got) == _rows(jD.load_glue_split(d, task, split))
    assert tD.glue_num_labels(task) == jD.glue_num_labels(task)


def test_load_glue_split_jsonl(tmp_path):
    recs = [{"sentence1": "a b c", "sentence2": "d e", "label": 1},
            {"sentence": "only one", "label": "0"},
            {"text_a": "x", "text_b": "y z", "label": 0}]
    with open(tmp_path / "dev.jsonl", "w") as f:
        f.write("\n".join(json.dumps(r) for r in recs) + "\n")
    for task in ("mrpc", "sst2"):
        got = tD.load_glue_split(str(tmp_path), task, "dev")
        assert _rows(got) == _rows(jD.load_glue_split(str(tmp_path), task,
                                                      "dev"))
        assert [e.label for e in got] == [1, 0, 0]


@pytest.mark.parametrize("task", ["sst2", "mrpc"])
def test_encode_glue_batch_with_the_ports_wordpiece(task):
    ex = tD.load_glue_split(glue_dir(task, 2, 6), task, "dev")
    want = jD.encode_glue_batch(jtok.load_tokenizer(vocab_file()), ex, 24)
    got = tD.encode_glue_batch(ttok.load_tokenizer(vocab_file()), ex, 24)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


# ---------------------------------------------------------------------------
# glue_eval
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task", ["mrpc", "stsb"])
def test_glue_eval(task):
    """Classification: the same predictions and metrics within 1e-9;
    regression: the predictions are the logits (within 1e-5), so the
    correlations agree within 1e-5."""
    n_labels = tD.glue_num_labels(task)
    geom = dict(tbert.GEOM, num_labels=n_labels)
    params = tbert.jax_params(jb.BertForSequenceClassification,
                              tuple(geom.items()))
    jm = jb.BertForSequenceClassification(jb.BertConfig(**geom),
                                          JQ(enabled=False))
    tm = tbert.port_model(tb.BertForSequenceClassification,
                          tb.BertConfig(**geom), dict(enabled=False), params)
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(3):
        ids, tt, am = tbert.batch(int(rng.integers(100)), B=5)
        labels = (rng.normal(size=5) if n_labels == 1
                  else rng.integers(0, n_labels, 5))
        batches.append({"input_ids": ids, "token_type_ids": tt,
                        "attention_mask": am, "labels": labels})
    regression = n_labels == 1
    with recorded_predictions() as preds:
        want = jev.glue_eval(jm, {"params": params}, batches, task,
                             regression)
        got = tev.glue_eval(tm, batches, task, regression)
    assert set(got) == set(want)
    if regression:
        np.testing.assert_allclose(preds["port"], preds["reference"],
                                   rtol=0, atol=1e-5)
        for k in want:
            assert got[k] == pytest.approx(want[k], abs=1e-5), k
    else:
        assert preds["port"] == preds["reference"]
        for k in want:
            assert got[k] == pytest.approx(want[k], abs=METRIC_ATOL), k


@contextlib.contextmanager
def recorded_predictions():
    """Both packages' ``glue_compute_metrics`` wrapped to keep the
    predictions they score."""
    preds = {}

    def wrap(tag, real):
        def rec(task, p, labels):
            preds[tag] = list(p)
            return real(task, p, labels)
        return rec

    with mock.patch.object(jM, "glue_compute_metrics",
                           wrap("reference", jM.glue_compute_metrics)), \
            mock.patch.object(tM, "glue_compute_metrics",
                              wrap("port", tM.glue_compute_metrics)):
        yield preds


# ---------------------------------------------------------------------------
# glue_run against the reference's CLI
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def tiny_presets():
    """Both packages' base presets at TINY_BERT / TINY_BART (the CLIs
    build the preset whatever the checkpoint says)."""
    with mock.patch.object(jb, "bert_base_config",
                           lambda **kw: jb.BertConfig(**TINY_BERT, **kw)), \
            mock.patch.object(tb, "bert_base_config",
                              lambda **kw: tb.BertConfig(**TINY_BERT, **kw)), \
            mock.patch.object(jba, "bart_base_config",
                              lambda **kw: jba.BartConfig(**TINY_BART, **kw)), \
            mock.patch.object(tba, "bart_base_config",
                              lambda **kw: tba.BartConfig(**TINY_BART, **kw)):
        yield


@functools.lru_cache(maxsize=None)
def hf_dir(family: str, head: str = "classification",
           num_labels: int = 2) -> str:
    d = tempfile.mkdtemp(prefix=f"{family}_{head}_")
    c = (tb.BertConfig(**TINY_BERT, num_labels=num_labels)
         if family == "bert" else
         tba.BartConfig(**TINY_BART, num_labels=num_labels))
    cs.write_encoder_dir(torch, d, family, c, head, seed=7)
    return d


def run_reference(tool: str, argv):
    """The reference CLI's ``main`` in process: its JSON output."""
    mod = load_reference_tool(tool)
    buf = io.StringIO()
    with mock.patch.object(sys, "argv", [tool] + list(argv)), \
            contextlib.redirect_stdout(buf):
        mod.main()
    return json.loads(buf.getvalue())


def run_port(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = main(list(argv) + ["--device", "cpu"])
    out = json.loads(buf.getvalue())
    assert out == ret
    return out


def assert_same_json(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, float):
            assert got[k] == pytest.approx(w, abs=METRIC_ATOL), k
        else:
            assert got[k] == w, k


GLUE_CASES = {
    "bert-tsv-sst2-ant": ("bert", "sst2", True, []),
    "bert-synthetic-mrpc-fp32": ("bert", "mrpc", False,
                                 ["--disable_quant"]),
    "bart-tsv-mrpc-fp32": ("bart", "mrpc", True, ["--disable_quant"]),
    "bart-synthetic-sst2-ant-n8": ("bart", "sst2", False, ["--n8", "3"]),
}


@pytest.mark.parametrize("case", sorted(GLUE_CASES))
def test_glue_run_main_against_the_reference(case):
    family, task, tsv, flags = GLUE_CASES[case]
    argv = ["--task", task, "--model_family", family, "--weights",
            hf_dir(family), "--batch_size", "8", "--calib_batches", "1",
            "--max_seq_length", "32", *flags]
    if tsv:
        argv += ["--data_dir", glue_dir(task, 16, 20, seed=5),
                 "--tokenizer", vocab_file()]
    with tiny_presets(), recorded_predictions() as preds:
        want = run_reference("glue_run", argv)
        got = run_port(glue_run.main, argv)
    assert preds["port"] == preds["reference"]
    assert len(preds["port"]) == (20 if tsv else 32)
    assert_same_json(got, want)


def test_glue_run_raises_for_train_multihost_and_no_card(monkeypatch):
    """Under ``ANT_COORDINATOR`` glue_run joins a world of one rank and
    gives the same result as outside one; ``ANT_DISTRIBUTED=1`` without a
    launcher's variables raises naming them; without a card the default
    device raises, for evaluation and for ``--train``."""
    for k in ("ANT_COORDINATOR", "ANT_DISTRIBUTED", "RANK", "WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    argv = ["--task", "sst2", "--model_family", "bert", "--weights",
            hf_dir("bert"), "--batch_size", "8", "--calib_batches", "1",
            "--max_seq_length", "32", "--disable_quant"]
    with tiny_presets():
        alone = run_port(glue_run.main, argv)
        monkeypatch.setenv("ANT_COORDINATOR", f"127.0.0.1:{free_port()}")
        monkeypatch.setenv("ANT_NUM_PROCESSES", "1")
        monkeypatch.setenv("ANT_PROCESS_ID", "0")
        try:
            in_world = run_port(glue_run.main, argv)
            assert torch.distributed.is_initialized()
            assert torch.distributed.get_world_size() == 1
            assert torch.distributed.get_backend() == "gloo"
        finally:
            shutdown()
    assert_same_json(in_world, alone)
    monkeypatch.delenv("ANT_COORDINATOR")
    monkeypatch.setenv("ANT_DISTRIBUTED", "1")
    with pytest.raises(RuntimeError, match="MASTER_ADDR and MASTER_PORT"):
        glue_run.main(["--task", "sst2", "--device", "cpu"])
    monkeypatch.delenv("ANT_DISTRIBUTED")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        glue_run.main(["--task", "sst2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        glue_run.main(["--task", "sst2", "--train"])


# ---------------------------------------------------------------------------
# run_recipe
# ---------------------------------------------------------------------------

RECIPES = sorted(glob.glob(os.path.join(REPO, "recipes", "*.toml")))
# a flag each tool requires that no recipe sets (passed after "--")
REQUIRED = {"squad_run": ["--data", "dev.json"],
            "imagenet_eval": ["--data_dir", "synthetic"],
            "imagenet_qat": ["--train_dir", "synthetic", "--val_dir",
                             "synthetic"]}


@pytest.mark.parametrize("path", RECIPES, ids=os.path.basename)
def test_every_recipe_run_maps_to_the_port(path):
    ref = load_reference_tool("run_recipe")
    doc = run_recipe.load_recipe(path)
    defaults = doc.get("defaults", {})
    assert len(doc["run"]) == len(ref.load_recipe(path)["run"])
    for run in doc["run"]:
        merged = {**defaults, **run}
        tool = merged["tool"]
        if tool not in run_recipe.PORTED_TOOLS:
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                run_recipe.build_command(run, defaults, [])
            continue
        extra = REQUIRED.get(tool, [])
        got = run_recipe.build_command(run, defaults, extra)
        want = ref.build_command(run, defaults, extra)
        assert got[:3] == [sys.executable, "-m",
                           f"ant_quantization_tpu_torch.tools.{tool}"]
        assert got[3:] == want[2:], run["name"]
        mod = importlib.import_module(
            f"ant_quantization_tpu_torch.tools.{tool}")
        args = mod.parse_args(got[3:])
        for key, val in merged.items():
            if key not in run_recipe.RESERVED:
                assert str(getattr(args, key)) == str(val), (run["name"],
                                                             key)


def test_every_tool_of_the_recipes_is_ported_or_named():
    tools = {r.get("tool", run_recipe.load_recipe(p).get(
        "defaults", {}).get("tool"))
        for p in RECIPES for r in run_recipe.load_recipe(p)["run"]}
    assert tools <= set(run_recipe.PORTED_TOOLS) | set(
        run_recipe.MISSING_TOOLS)
    assert {"glue_run", "squad_run", "clm_eval"} <= tools


def test_run_recipe_set_overrides_per_run():
    sets = run_recipe.parse_sets(["*_squad:data=/d/v1.json",
                                  "*_squad2:data=/d/v2.json"])
    doc = run_recipe.load_recipe(os.path.join(REPO, "recipes",
                                              "olive_squad.toml"))
    for run in doc["run"]:
        cmd = run_recipe.build_command(run, doc["defaults"], [], sets)
        v2 = run["name"].endswith("_squad2")
        assert ("/d/v2.json" in cmd) == v2 and ("/d/v1.json" in cmd) != v2
        assert ("--version_2" in cmd) == v2


def test_run_recipe_main_dry_run_and_list(capsys):
    glue = os.path.join(REPO, "recipes", "olive_glue.toml")
    assert run_recipe.main([glue, "--only", "bart_*", "--dry-run", "--",
                            "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 5
    assert all(" -m ant_quantization_tpu_torch.tools.glue_run " in l
               and l.endswith("--device cpu") for l in lines)
    assert run_recipe.main([glue, "--list"]) == 0
    assert "bert_large_mrpc" in capsys.readouterr().out
    assert run_recipe.main([os.path.join(REPO, "recipes",
                                         "ant_bert_glue.toml"), "--only",
                            "sst2_IP-F", "--dry-run"]) == 0
    line, = capsys.readouterr().out.splitlines()
    assert " --train " in line and "--task sst2" in line
    cmd = run_recipe.build_command({"name": "x", "tool": "tp_bench",
                                    "tp": 2}, {}, ["--device", "cpu"])
    assert cmd[1:] == ["-m", "ant_quantization_tpu_torch.tools.tp_bench",
                       "--tp", "2", "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="no ROADMAP item"):
        run_recipe.build_command({"name": "x", "tool": "no_such_tool"}, {},
                                 [])
    cmd = run_recipe.build_command({"name": "x", "tool": "spec_bench",
                                    "layers": 8}, {}, ["--device", "cpu"])
    assert cmd[-5:] == ["ant_quantization_tpu_torch.tools.spec_bench",
                        "--layers", "8", "--device", "cpu"]
