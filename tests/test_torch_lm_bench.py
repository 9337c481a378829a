"""PyTorch port vs the JAX reference: ``tools/lm_bench.py``.
The six family presets field by field and ``matmul_flops``; the random
engine params at tiny widths (OPT-, BLOOM- and GPT-2-shaped, the Conv1D
and the Linear sites, "w4" and "bf16"): the reference's tree passed
through ``convert.from_jax_engine_params`` and the port's have the same
keys, shapes and dtypes, the same constant leaves bit for bit, and random
leaves in the reference's ranges; ``main`` at a tiny family in both modes,
with the bf16 baseline and with ``bf16_note`` forced by
``BENCH_HBM_BUDGET``: one JSON line whose keys and non-timing values are
the reference's."""

import contextlib
import dataclasses
import functools
import importlib.util
import io
import json
import math
import os
import re
from unittest import mock

import numpy as np
import pytest
import torch

import jax

from ant_quantization_tpu.models import transformer_lm as jlm
from ant_quantization_tpu.serve import engine as jeng
from ant_quantization_tpu_torch import convert
from ant_quantization_tpu_torch.models import transformer_lm as tlm
from ant_quantization_tpu_torch.serve import engine as teng
from ant_quantization_tpu_torch.tools import lm_bench

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.torchdep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=128, d_model=128, n_layers=2, n_heads=1, d_ff=256,
            max_seq=2048)
SHAPES = {
    "opt": dict(positions="learned_offset2", activation="relu",
                fused_qkv=False),
    "bloom": dict(positions="alibi", activation="gelu", fused_qkv=True,
                  embed_ln=True),
    "gpt2": dict(positions="learned", activation="gelu_new",
                 fused_qkv=True, conv1d_sites=True),
}
# the leaves drawn at random, by the range the reference draws them in
INT_RANGE = {"w_i8": (-64, 63), "wte_i8": (-127, 127)}
STD = {"wpe": 0.02, "wte": 0.02}


def load_reference_tool(name):
    """The reference's ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _ref():
    return load_reference_tool("lm_bench")


def _fields(c):
    return {f.name: getattr(c, f.name) for f in dataclasses.fields(c)
            if f.name != "dtype"}


def test_families_match_reference():
    ref = _ref()
    assert sorted(lm_bench.FAMILIES) == sorted(ref.FAMILIES)
    for name, make in lm_bench.FAMILIES.items():
        assert _fields(make()) == _fields(ref.FAMILIES[name]()), name


@pytest.mark.parametrize("family", sorted(lm_bench.FAMILIES))
def test_matmul_flops_match_reference(family):
    ref = _ref()
    c, jc = lm_bench.FAMILIES[family](), ref.FAMILIES[family]()
    for m in (4, 2048):
        for head_m in (None, 4):
            assert (lm_bench.matmul_flops(c, m, head_m)
                    == ref.matmul_flops(jc, m, head_m))
    assert lm_bench.PEAK_BF16 == 989e12 and lm_bench.PEAK_INT8 == 1979e12


def _configs(shape, linear_sites, weight_mode, max_seq=96):
    geom = {**TINY, **SHAPES[shape], "max_seq": max_seq}
    if linear_sites:
        geom["conv1d_sites"] = False
    kw = (dict(weight_mode="w4", act_bits=4, kv_int8=True,
               lm_head_int8=True) if weight_mode == "w4" else
          dict(weight_mode="bf16", act_bits=0, kv_int8=False))
    return (jeng.EngineConfig(lm=jlm.LMConfig(**geom), max_seq=max_seq, **kw),
            teng.EngineConfig(lm=tlm.LMConfig(**geom), max_seq=max_seq, **kw))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("weight_mode", ["w4", "bf16"])
@pytest.mark.parametrize("shape,linear_sites", [
    ("opt", False), ("bloom", False), ("gpt2", False), ("gpt2", True)])
def test_rand_engine_params_match_reference(shape, linear_sites,
                                            weight_mode):
    jcfg, tcfg = _configs(shape, linear_sites, weight_mode)
    ref = jax.tree_util.tree_map(
        np.asarray, _ref().rand_engine_params(jcfg, jax.random.PRNGKey(0)))
    want = dict(_flat(convert.from_jax_engine_params(ref, device="cpu")))
    ep = lm_bench.rand_engine_params(tcfg, 0, "cpu")
    got = dict(_flat(ep))
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        w, leaf = want[path], path[-1]
        assert g.shape == w.shape, path
        if leaf == "kernel":
            # the reference's bf16 draw times an f32 scalar is f32; the
            # port keeps dense kernels in cfg.dtype, as its engine builds
            # them
            assert (w.dtype, g.dtype) == (torch.float32, tcfg.dtype)
            std = 1.0 / math.sqrt(lm_bench.site_shapes(tcfg.lm)[path[1]][0])
        else:
            assert g.dtype == w.dtype, path
            std = STD.get(leaf)
        if leaf in INT_RANGE:
            assert (int(g.min()), int(g.max())) == INT_RANGE[leaf], path
        elif std is not None:
            gf = g.to(torch.float32)
            assert abs(float(gf.std()) / std - 1) < 0.1, path
            assert abs(float(gf.mean())) < 0.1 * std, path
        else:
            assert torch.equal(g, w), path
    # one engine step runs on the port's tree (the sites' routes take it)
    kv = teng.init_cache(tcfg, 2, device="cpu")
    logits, _ = teng.forward(tcfg, ep, torch.zeros((2, 3), dtype=torch.long),
                             kv, 0)
    assert logits.shape == (2, 3, 128) and bool(torch.isfinite(logits).all())


def test_rand_engine_params_are_seeded():
    _, tcfg = _configs("opt", False, "w4")
    a = dict(_flat(lm_bench.rand_engine_params(tcfg, 3, "cpu")))
    b = dict(_flat(lm_bench.rand_engine_params(tcfg, 3, "cpu")))
    c = dict(_flat(lm_bench.rand_engine_params(tcfg, 4, "cpu")))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a[("layers", "q", "w_i8")],
                           c[("layers", "q", "w_i8")])


# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------

ARGV = ["--family", "tiny", "--batch", "2", "--prefill", "40",
        "--decode", "2"]
TIMING = {"tokens_per_s", "ms_per_step", "bf16_tokens_per_s", "vs_bf16",
          "ms_per_prefill", "int8_mfu_pct", "serve_ms_per_prefill",
          "serve_tokens_per_s", "serve_int8_mfu_pct", "bf16_ms_per_prefill",
          "bf16_mfu_pct", "vs_bf16_depth_matched"}
NOTE = re.compile(r"bf16 needs ~([0-9.]+) GB > ([0-9]+) GB budget; "
                  r"not attempted")
CASES = {"decode": ([], None), "decode_forced": ([], "1e3"),
         "prefill": (["--mode", "prefill"], None),
         "prefill_forced": (["--mode", "prefill"], "1e3")}


def _run(main, extra, budget) -> dict:
    env = {} if budget is None else {"BENCH_HBM_BUDGET": budget}
    out = io.StringIO()
    with mock.patch.dict(os.environ, env), contextlib.redirect_stdout(out):
        main(ARGV + extra)
    line, = out.getvalue().splitlines()
    return json.loads(line)


@functools.lru_cache(maxsize=None)
def _ref_main(case: str) -> dict:
    ref = _ref()
    geom = {**TINY, **SHAPES["opt"]}
    with mock.patch.dict(ref.FAMILIES,
                         {"tiny": lambda: jlm.LMConfig(**geom)}):
        return _run(ref.main, *CASES[case])


@pytest.mark.parametrize("case", sorted(CASES))
def test_main_matches_reference(case, monkeypatch):
    extra, budget = CASES[case]
    monkeypatch.delenv("BENCH_HBM_BUDGET", raising=False)
    geom = {**TINY, **SHAPES["opt"]}
    monkeypatch.setitem(lm_bench.FAMILIES, "tiny",
                        lambda: tlm.LMConfig(**geom))
    want = _ref_main(case)
    got = _run(lm_bench.main, extra + ["--device", "cpu"], budget)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        if k in TIMING:
            assert math.isfinite(v) and v >= 0, (k, v)
        elif k == "bf16_note":
            # the budget is the same; the need is each engine's estimate
            g, w = NOTE.fullmatch(v), NOTE.fullmatch(want[k])
            assert g and w and g.group(2) == w.group(2), (v, want[k])
            need = lm_bench.bf16_bytes(tlm.LMConfig(**geom), 2, 40, 74)
            assert g.group(1) == f"{need / 1e9:.1f}"
        else:
            assert v == want[k], (k, v, want[k])
    if case == "prefill":
        assert got["bf16_layers"] == TINY["n_layers"]
    if case == "prefill_forced":
        assert got["bf16_layers"] == 1


def test_bf16_bytes_counts_the_static_footprint():
    """The estimate holds the bf16 weights, head and position table and
    the raw cache, and grows with the forward's tokens."""
    c = lm_bench.FAMILIES["opt-6.7b"]()
    static = (2 * 32 * (4 * 4096 ** 2 + 2 * 4096 * 16384)
              + 2 * 50272 * 4096 + 2 * 610 * 4096
              + 2 * 2 * 32 * 4 * 32 * 608 * 128)
    est = lm_bench.bf16_bytes(c, 4, 512, 608)
    assert static < est < static + 1.5e9
    assert lm_bench.bf16_bytes(c, 4, 1024, 608) > est


def test_main_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_bench.main(["--family", "opt-1.3b"])
