"""PyTorch port vs the JAX reference: the image half of
``harness/data.py``, the image tools (``tools/imagenet_eval.py``,
``imagenet_qat.py``, ``qat_bench.py``), ``glue_run --train`` and
``run_recipe`` over all six recipes.

- the ImageFolder pipeline on generated PNG and JPEG files (portrait and
  landscape, two classes): the port's batches equal the reference's,
  f32 and uint8, threaded and not, with a limit and a shard; the CIFAR
  pipeline on generated pickles (train with its shuffle and augment,
  test); ``normalize_images`` on the device equal to the reference's;
  a host without PIL raises naming it;
- the tools' ``main`` in process on a tiny ResNet (the reference's and
  the port's ``resnet18_config`` both patched to one block a stage,
  crops of 32 px), from the same generated torchvision weights (.npz),
  the reference's calibration replaced by the port's states (its
  calibration is held in ``tests/test_torch_image_models.py``; this
  holds the tools' flows): ``imagenet_eval`` prints the reference's
  JSON; ``imagenet_qat`` (one step an epoch) prints the reference's
  JSON and its checkpoint holds the reference's update by the rule of
  ``tests/test_torch_train.py`` (direction and norm), its keys and its
  epoch; then ``--resume`` for a second epoch: the step from the port's
  checkpoint holds the reference's ``make_classification_step`` with a
  fresh optimizer from the same checkpoint (the reference's own
  ``--resume`` restores its quant tree without a template, as dicts); ``imagenet_eval --resume`` loads
  the port's checkpoint without calibrating;
- ``qat_bench`` on the CPU (ResNet and a tiny BERT);
- ``glue_run --train`` on a 2-layer BERT (2 steps of 8 rows, the
  port's calibration carried into the reference): the printed metrics
  equal and the trained parameters within STEP_ATOL of the reference's;
- ``run_recipe --dry-run`` over all six recipes: one command a run.
"""

import contextlib
import functools
import glob
import io
import os
import tempfile
from unittest import mock

import numpy as np
import pytest
import torch

import jax

from ant_quantization_tpu.harness import checkpoint as jC
from ant_quantization_tpu.harness import data as jD
from ant_quantization_tpu.harness import evaluate as jev
from ant_quantization_tpu.harness import train as JT
from ant_quantization_tpu.models import resnet as jres
from ant_quantization_tpu.nn.config import QuantConfig as JQ
from ant_quantization_tpu_torch import convert
from ant_quantization_tpu_torch.harness import checkpoint as tC
from ant_quantization_tpu_torch.harness import data as tD
from ant_quantization_tpu_torch.harness import train as TT
from ant_quantization_tpu_torch.harness import zoo as tzoo
from ant_quantization_tpu_torch.models import bert as tb
from ant_quantization_tpu_torch.models import resnet as tres
from ant_quantization_tpu_torch.models.import_hf import lm_state_dict
from ant_quantization_tpu_torch.nn.config import QuantConfig as TQ
from ant_quantization_tpu_torch.tools import (glue_run, imagenet_eval,
                                              imagenet_qat, qat_bench,
                                              run_recipe)

import chip_smoke as cs
from test_torch_bert import to_jax
from test_torch_glue import (REPO, TINY_BERT, assert_same_json, glue_dir,
                             hf_dir, load_reference_tool, run_port,
                             run_reference, tiny_presets, vocab_file)
from test_torch_train import (STEM, STEM_COS, UPDATE_COS,
                              UPDATE_NORM_RTOL)

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.torchdep

STEP_ATOL = 1e-5
FAST = ["--w_low", "100", "--w_up", "101", "--a_low", "100", "--a_up", "101"]


# ---------------------------------------------------------------------------
# Data pipelines
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def image_folder() -> str:
    from PIL import Image
    root = tempfile.mkdtemp(prefix="imagefolder_")
    rng = np.random.default_rng(0)
    sizes = [(40, 30), (30, 44), (37, 37)]
    for c in ("cat", "dog"):
        os.makedirs(os.path.join(root, c))
        for i, (w, h) in enumerate(sizes):
            img = Image.fromarray(rng.integers(0, 256, (h, w, 3),
                                               dtype=np.uint8))
            ext = ".png" if i % 2 else ".jpg"
            img.save(os.path.join(root, c, f"{i}{ext}"))
        open(os.path.join(root, c, "notes.txt"), "w").close()
    return root


@pytest.mark.parametrize("kw", [
    dict(workers=0), dict(workers=2, as_uint8=True),
    dict(workers=2, limit=5), dict(workers=0, shard=(1, 2),
                                   as_uint8=True)], ids=str)
def test_imagefolder_batches_against_jax(kw):
    with mock.patch.object(jD, "model_input_size", lambda n: (36, 32)), \
            mock.patch.object(tD, "model_input_size", lambda n: (36, 32)):
        want = list(jD.imagefolder_batches(image_folder(), 2, **kw))
        got = list(tD.imagefolder_batches(image_folder(), 2, **kw))
    assert len(got) == len(want) > 0
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == wi.dtype and gi.shape[1:] == (32, 32, 3)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    assert tD.list_imagefolder(image_folder()) == jD.list_imagefolder(
        image_folder())


def test_normalize_on_the_device_and_no_pil():
    x = np.random.default_rng(1).integers(0, 256, (2, 5, 4, 3),
                                          dtype=np.uint8)
    want = np.asarray(jD.normalize_images(x))
    got = tD.device_images(x, "cpu", tD.normalize_images)
    np.testing.assert_array_equal(got.numpy(), want.transpose(0, 3, 1, 2))
    assert got.is_contiguous()
    real = __import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real(name, *a, **k)

    path = glob.glob(os.path.join(image_folder(), "cat", "*"))[0]
    with mock.patch("builtins.__import__", no_pil):
        with pytest.raises(ImportError, match="PIL"):
            tD.load_image_u8(path, 36, 32)
    assert tD.synthetic_image_batches(2, 1, 8) is not None


def _cifar_dir() -> str:
    import pickle
    root = tempfile.mkdtemp(prefix="cifar_")
    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base)
    rng = np.random.default_rng(2)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump({"data": rng.integers(0, 256, (6, 3072),
                                              dtype=np.uint8),
                         "labels": list(rng.integers(0, 10, 6))}, f)
    return root


def test_cifar_batches_against_jax():
    root = _cifar_dir()
    for kw in (dict(split="train", augment=True, seed=3, batch_size=8),
               dict(split="test", batch_size=4, prefetch=0)):
        want = list(jD.cifar_batches(root, "cifar10", **kw))
        got = list(tD.cifar_batches(root, "cifar10", **kw))
        assert len(got) == len(want) > 0
        for (gi, gl), (wi, wl) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)


# ---------------------------------------------------------------------------
# imagenet_eval and imagenet_qat against the reference's tools
# ---------------------------------------------------------------------------

TINY = dict(block="basic", layers=(1, 1, 1, 1))


@contextlib.contextmanager
def tiny_resnet():
    """Both packages' resnet18 at one block a stage, crops of 32 px."""
    with mock.patch.object(jres, "resnet18_config",
                           lambda: jres.ResNetConfig(**TINY)), \
            mock.patch.object(tres, "resnet18_config",
                              lambda: tres.ResNetConfig(**TINY)), \
            mock.patch.object(jD, "model_input_size", lambda n: (36, 32)), \
            mock.patch.object(tD, "model_input_size", lambda n: (36, 32)):
        yield


@functools.lru_cache(maxsize=None)
def weights_file() -> str:
    with tiny_resnet():
        model = tzoo.get_image_model("resnet18", TQ(enabled=False),
                                     device="cpu")[0]
    sd = cs.image_checkpoint(torch, "resnet18", 5, "cpu", model=model)
    path = os.path.join(tempfile.mkdtemp(prefix="tv_"), "resnet18.npz")
    np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    return path


@contextlib.contextmanager
def shared_calibration(tool_mod):
    """The port's tool calibrates; the reference's (same first batch)
    takes the port's states instead of calibrating."""
    trees = []
    real = tool_mod.calibrate_on_batches

    def port(model, batches, **kw):
        trees.append(real(model, batches, **kw))
        return trees[-1]

    def reference(model, variables, batches, **kw):
        return to_jax(trees[-1])

    with mock.patch.object(tool_mod, "calibrate_on_batches", port), \
            mock.patch.object(jev, "calibrate_on_batches", reference):
        yield trees


def test_imagenet_eval_against_the_reference():
    argv = ["--model", "resnet18", "--weights", weights_file(),
            "--data_dir", "synthetic", "--batch_size", "4", *FAST]
    with tiny_resnet(), shared_calibration(imagenet_eval) as trees:
        got = run_port(imagenet_eval.main, argv)
        want = run_reference("imagenet_eval", argv)
    assert len(trees) == 1
    assert got == want
    assert set(got) == {"top1", "top5", "model", "mode", "wbit", "abit"}


def _start_state() -> dict:
    with tiny_resnet():
        _, conv, _ = tzoo.get_image_model("resnet18", TQ(enabled=False),
                                          device="cpu")
        params, _ = conv(tzoo.load_state_dict_file(weights_file()))
    return {k: v.numpy() for k, v in lm_state_dict(params).items()}


def _hwio(tree):
    return {k: _hwio(v) if isinstance(v, dict) else (
        np.ascontiguousarray(np.asarray(v).transpose(2, 3, 1, 0))
        if np.ndim(v) == 4 else np.asarray(v)) for k, v in tree.items()}


def _assert_same_update(port, ref, prev):
    """Each parameter's update from ``prev`` by the rule of
    tests/test_torch_train.py (direction and norm)."""
    for k in prev:
        a, b = (port[k] - prev[k]).ravel(), (ref[k] - prev[k]).ravel()
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        ratio = np.linalg.norm(a) / np.linalg.norm(b)
        stem = k.split(".")[0] in STEM
        assert cos >= (STEM_COS if stem else UPDATE_COS), (k, cos)
        assert abs(ratio - 1) <= UPDATE_NORM_RTOL, (k, ratio)


def _state(params) -> dict:
    return {k: np.asarray(v) for k, v in lm_state_dict(params).items()}


def test_imagenet_qat_and_resume_against_the_reference(tmp_path):
    """One step an epoch. Epoch 0: the port's tool against the
    reference's from the same weights. Epoch 1, ``--resume``: the port's
    tool from its own checkpoint against the reference's step
    (``make_classification_step`` with a fresh ``sgd_multistep``, as its
    tool builds them) from the same checkpoint."""
    base = ["--model", "resnet18", "--weights", weights_file(),
            "--train_dir", "synthetic", "--val_dir", "synthetic",
            "--batch_size", "4", "--steps_per_epoch", "1", "--lr", "0.01",
            "--milestones", "1", *FAST]
    dirs = {"port": str(tmp_path / "port"), "ref": str(tmp_path / "ref")}
    with tiny_resnet(), shared_calibration(imagenet_qat):
        got = run_port(imagenet_qat.main, base + [
            "--epochs", "1", "--ckpt_dir", dirs["port"]])
        want = run_reference("imagenet_qat", base + [
            "--epochs", "1", "--ckpt_dir", dirs["ref"]])
    assert got == want
    ck0 = tC.restore_checkpoint(dirs["port"], device="cpu")
    tref = jax.tree_util.tree_map(np.asarray,
                                  jC.restore_checkpoint(dirs["ref"]))
    assert ck0["epoch"] == int(tref["epoch"]) == 0
    assert set(ck0) == set(tref) == {"params", "quant", "extra", "epoch"}
    ref = {k: v.numpy() for k, v in convert.from_jax_image_params(
        tref["params"], device="cpu").items()}
    _assert_same_update(_state(ck0["params"]), ref, _start_state())

    with tiny_resnet():
        run_port(imagenet_qat.main, base + ["--epochs", "2", "--ckpt_dir",
                                            dirs["port"], "--resume"])
        ck1 = tC.restore_checkpoint(dirs["port"], device="cpu")
        assert ck1["epoch"] == 1
        jm = jres.ResNet(jres.resnet18_config(), JQ(
            mode="ant-int-pot-flint", w_low=100, w_up=101, a_low=100,
            a_up=101))
    tx = JT.sgd_multistep(0.01, [1], 0.1, 0.9, 1e-4)
    params = _hwio(ck0["params"])
    state = JT.TrainState(params, to_jax(TT._states(ck0["quant"])),
                          tx.init(params), {"batch_stats": _hwio(
                              ck0["extra"]["batch_stats"])})
    step = JT.make_classification_step(jm, tx, has_batch_stats=True)
    images, labels = next(iter(jD.synthetic_image_batches(4, 1, 32,
                                                          seed=1)))
    state, _ = step(state, jax.numpy.asarray(images),
                    jax.numpy.asarray(labels))
    ref1 = {k: v.numpy() for k, v in convert.from_jax_image_params(
        jax.tree_util.tree_map(np.asarray, state.params),
        device="cpu").items()}
    _assert_same_update(_state(ck1["params"]), ref1, _state(ck0["params"]))


def test_imagenet_eval_resumes_from_a_qat_checkpoint(tmp_path):
    ckpt = str(tmp_path / "qat")
    argv = ["--model", "resnet18", "--weights", weights_file(),
            "--train_dir", "synthetic", "--val_dir", "synthetic",
            "--batch_size", "4", "--steps_per_epoch", "1", "--epochs", "1",
            "--ckpt_dir", ckpt, *FAST]
    with tiny_resnet():
        run_port(imagenet_qat.main, argv)
        calls = []
        with mock.patch.object(imagenet_eval, "calibrate_on_batches",
                               lambda *a, **k: calls.append(1)):
            got = run_port(imagenet_eval.main, [
                "--model", "resnet18", "--data_dir", "synthetic",
                "--batch_size", "4", "--resume", ckpt])
        model = tzoo.get_image_model("resnet18", TQ(), device="cpu")[0]
        TT.load_checkpoint_tree(model, tC.restore_checkpoint(
            ckpt, device="cpu"))
        want = TT.evaluate_classification(
            model, tD.synthetic_image_batches(4, 4, 32))
    assert not calls
    assert {k: got[k] for k in want} == want


# ---------------------------------------------------------------------------
# qat_bench, glue_run --train, run_recipe
# ---------------------------------------------------------------------------

def test_qat_bench_on_the_cpu():
    args = ["--device", "cpu", "--inner", "1", "--reps", "1", "--json",
            "--batch", "2"]
    with tiny_resnet(), contextlib.redirect_stderr(io.StringIO()):
        out = qat_bench.main(args + ["--model", "resnet18", "--size", "32"])
    assert out["model"] == "resnet18" and out["overhead"] > 0
    assert out["qat_examples_per_s"] > 0
    with mock.patch.object(tb, "bert_base_config",
                           lambda **kw: tb.BertConfig(**TINY_BERT, **kw)), \
            contextlib.redirect_stderr(io.StringIO()):
        out = qat_bench.main(args + ["--model", "bert_base", "--seq", "8"])
    assert out["dense_ms_per_step"] > 0


def test_glue_run_train_against_the_reference():
    argv = ["--task", "sst2", "--model_family", "bert", "--weights",
            hf_dir("bert"), "--batch_size", "8", "--calib_batches", "1",
            "--max_seq_length", "32", "--data_dir", glue_dir("sst2", 16, 12,
                                                             seed=9),
            "--tokenizer", vocab_file(), "--train", "--epochs", "1",
            "--lr", "1e-3", "--warmup", "0.5", *FAST]
    seen = {}
    real_port, real_ref = glue_run.glue_eval, jev.glue_eval

    def port_eval(model, *a, **k):
        seen["port"] = {n: p.detach().clone()
                        for n, p in model.named_parameters()}
        return real_port(model, *a, **k)

    def ref_eval(model, variables, *a, **k):
        seen["ref"] = variables["params"]
        return real_ref(model, variables, *a, **k)

    with tiny_presets(), shared_calibration(glue_run), \
            mock.patch.object(glue_run, "glue_eval", port_eval), \
            mock.patch.object(jev, "glue_eval", ref_eval):
        got = run_port(glue_run.main, argv)
        want = run_reference("glue_run", argv)
    assert_same_json(got, want)
    ref = convert.from_jax_lm_params(jax.tree_util.tree_map(
        np.asarray, seen["ref"]), device="cpu")
    moved = 0
    for name, p in seen["port"].items():
        w = ref[name].numpy()
        if name.endswith("attention.key.bias"):
            continue            # a gradient of 0 in exact arithmetic
        np.testing.assert_allclose(p.numpy(), w, rtol=0,
                                   atol=STEP_ATOL * np.abs(w).max(),
                                   err_msg=name)
        moved += 1
    assert moved > 30


RECIPES = sorted(glob.glob(os.path.join(REPO, "recipes", "*.toml")))


@pytest.mark.parametrize("path", RECIPES, ids=os.path.basename)
def test_run_recipe_dry_run_over_every_recipe(path, capsys):
    n = len(run_recipe.load_recipe(path)["run"])
    assert run_recipe.main([path, "--dry-run", "--", "--device",
                            "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == n
    assert all(" -m ant_quantization_tpu_torch.tools." in l
               and l.endswith("--device cpu") for l in lines)
    ref = load_reference_tool("run_recipe")
    assert all(r.get("tool", ref.load_recipe(path).get("defaults", {}).get(
        "tool")) in run_recipe.PORTED_TOOLS
        for r in run_recipe.load_recipe(path)["run"])
    assert sorted(run_recipe.MISSING_TOOLS) == ["lm_bench", "spec_bench",
                                                "tp_bench"]


def test_image_entry_points_need_a_card_by_default(monkeypatch):
    """Without ``--device`` (``device=``) the tools and models ask for
    "cuda", and raise where there is no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in (
            (imagenet_eval.main, ["--model", "alexnet", "--data_dir",
                                  "synthetic"]),
            (imagenet_qat.main, ["--model", "alexnet", "--train_dir",
                                 "synthetic", "--val_dir", "synthetic"]),
            (qat_bench.main, ["--model", "alexnet"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tres.ResNet(tres.resnet18_config(), TQ())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tzoo.get_image_model("vit_b_16", TQ())
