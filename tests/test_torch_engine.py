"""PyTorch port vs the JAX reference: the whole serving slice on a 2-layer
OPT-shaped W4A4 + INT8-KV + int8-lm_head engine (prefill through the
torch int8-matmul route, decode through K1), the port's own param
builder, the device rules of the entry points, and the package's
independence from JAX."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ant_quantization_tpu.calibrate.spec import QuantState, pad_grid
from ant_quantization_tpu.models.transformer_lm import LMConfig as JLMConfig
from ant_quantization_tpu.serve import engine as jeng
from ant_quantization_tpu_torch import _ext
from ant_quantization_tpu_torch import convert
from ant_quantization_tpu_torch.kernels import attention as tk2
from ant_quantization_tpu_torch.kernels import stacked as tk1
from ant_quantization_tpu_torch.models.transformer_lm import LMConfig
from ant_quantization_tpu_torch.numerics import codebooks as cb
from ant_quantization_tpu_torch.serve import engine as teng

pytestmark = pytest.mark.torchdep


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch. The suite runs six workers on the
    host's shared cores, where torch's OpenMP threads spin against each
    other and the JAX references' threads; the port's test files import
    this fixture (autouse in each module that holds it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

_GEOM = dict(vocab_size=128, d_model=256, n_layers=2, n_heads=2, d_ff=512,
             max_seq=96, positions="learned_offset2", activation="relu",
             fused_qkv=False)
_SITES = {"q": (256, 256), "k": (256, 256), "v": (256, 256),
          "out": (256, 256), "fc_in": (256, 512), "fc_out": (512, 256)}
_B, _T, _DECODE = 2, 40, 4          # prefill M = 80 > 64; decode M = 2


def _state(alpha, grid):
    return QuantState(
        alpha=jnp.asarray(alpha, jnp.float32),
        grid=jnp.asarray(pad_grid(grid)),
        outliers=jnp.zeros((256,), jnp.float32),
        bit=jnp.asarray(4, jnp.int32), mode_idx=jnp.asarray(0, jnp.int32),
        is_signed=jnp.asarray(True), mse=jnp.asarray(0.0, jnp.float32),
        initialized=jnp.asarray(True), aux=jnp.asarray(0.0, jnp.float32))


def _model(seed=0):
    """Random float weights and flint W4A4 states (the grids bench.py
    serves: signed flint weights, unsigned flint activations)."""
    rng = np.random.default_rng(seed)
    wgrid = cb.ant_grid("flint", 4, True)
    agrid = cb.ant_grid("flint", 4, False)
    f32 = lambda a: np.asarray(a, np.float32)
    ln = lambda: {"scale": f32(1 + 0.1 * rng.normal(size=256)),
                  "bias": f32(0.1 * rng.normal(size=256))}
    params, quant = {}, {}
    for i in range(_GEOM["n_layers"]):
        p = {"ln_1": ln(), "ln_2": ln(), "attn": {}}
        q = {"attn": {}}
        for site, (K, N) in _SITES.items():
            w = f32(rng.normal(size=(K, N)) / np.sqrt(K))
            node = {"kernel": w, "bias": f32(0.05 * rng.normal(size=N))}
            st = {"weight_q": _state(0.9 * np.abs(w).max(0), wgrid),
                  "input_q": _state(np.float32(rng.uniform(1.5, 3.0)),
                                    agrid)}
            (p["attn"] if site in ("q", "k", "v", "out") else p)[site] = node
            (q["attn"] if site in ("q", "k", "v", "out") else q)[site] = st
        params[f"h_{i}"], quant[f"h_{i}"] = p, q
    params["wte"] = {"embedding": f32(rng.normal(size=(128, 256)))}
    params["wpe"] = {"embedding": f32(0.3 * rng.normal(size=(98, 256)))}
    params["ln_f"] = ln()
    return params, quant


def _configs():
    kw = dict(weight_mode="w4", act_bits=4, kv_int8=True, lm_head_int8=True,
              max_seq=96)
    jcfg = jeng.EngineConfig(lm=JLMConfig(**_GEOM), dtype=jnp.float32,
                             interpret=True, **kw)
    tcfg = teng.EngineConfig(lm=LMConfig(**_GEOM), dtype=torch.float32, **kw)
    return jcfg, tcfg


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_engine_slice_matches_reference():
    params, quant = _model()
    jcfg, tcfg = _configs()
    jep = jeng.build_engine_params(jcfg, params, quant)
    tep = convert.from_jax_engine_params(_np_tree(jep), device="cpu")
    jfwd = jax.jit(lambda ep, ids, kv, pos: jeng.forward(jcfg, ep, ids, kv,
                                                         pos))
    ids = np.random.default_rng(1).integers(0, 128, (_B, _T))
    jkv = jeng.init_cache(jcfg, _B)
    tkv = teng.init_cache(tcfg, _B, device="cpu")
    k1, k2 = dict(tk1.COUNTS), dict(tk2.COUNTS)
    pos = 0
    for step in range(1 + _DECODE):
        jl, jkv = jfwd(jep, jnp.asarray(ids), jkv, pos)
        tl, tkv = teng.forward(tcfg, tep, torch.from_numpy(ids), tkv, pos)
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=5e-3, atol=5e-3,
                                   err_msg=f"step {step}")
        pos += ids.shape[1]
        ids = jl[:, -1:].argmax(-1)      # both engines take the same token
    # prefill took the torch route, each decode step K1 (plain on CPU):
    # 6 sites x 2 layers per step; K2 serves every forward
    assert tk1.COUNTS["plain_calls"] - k1["plain_calls"] == 12 * _DECODE
    assert tk2.COUNTS["plain_calls"] - k2["plain_calls"] == 2 * (1 + _DECODE)
    want = convert.from_jax_kv(_np_tree(jkv), 128, device="cpu")
    for name in ("k", "v"):
        g, w = getattr(tkv, name)[:, :, :, :pos], getattr(want, name)[
            :, :, :, :pos]
        assert (g == w).float().mean().item() >= 0.999, name
    np.testing.assert_allclose(tkv.k_scale.numpy(), want.k_scale.numpy(),
                               rtol=1e-3, atol=1e-6)


def test_build_engine_params_matches_converted():
    params, quant = _model(seed=2)
    jcfg, tcfg = _configs()
    got = teng.build_engine_params(tcfg, params, quant, device="cpu")
    want = convert.from_jax_engine_params(
        _np_tree(jeng.build_engine_params(jcfg, params, quant)),
        device="cpu")
    gl, wl = dict(teng._flatten(got)), dict(teng._flatten(want))
    assert set(gl) == set(wl)
    for path, w in wl.items():
        assert gl[path].dtype == w.dtype, path
        np.testing.assert_array_equal(gl[path].numpy(), w.numpy(),
                                      err_msg=str(path))


def test_engine_module_generate_matches_forward():
    params, quant = _model(seed=3)
    _, tcfg = _configs()
    ep = teng.build_engine_params(tcfg, params, quant, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, 128, (2, 7)))
    toks = teng.Engine(tcfg, ep, batch=2).generate(ids, 3)
    kv = teng.init_cache(tcfg, 2, device="cpu")
    logits, kv = teng.forward(tcfg, ep, ids, kv, 0, last_index=6)
    want = []
    for i in range(3):
        tok = logits[:, -1].argmax(-1, keepdim=True)
        want.append(tok)
        logits, kv = teng.forward(tcfg, ep, tok, kv, 7 + i)
    assert torch.equal(toks, torch.cat(want, 1))


def test_entry_points_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params, quant = _model()
    jcfg, tcfg = _configs()
    jep = _np_tree(jeng.build_engine_params(jcfg, params, quant))
    jkv = _np_tree(jeng.init_cache(jcfg, 1))
    for device in ("cuda", None):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _ext.resolve_device(device)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            teng.build_engine_params(tcfg, params, quant, device=device)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            teng.init_cache(tcfg, 1, device=device)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            convert.from_jax_engine_params(jep, device=device)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            convert.from_jax_kv(jkv, 128, device=device)


def test_unported_features_raise():
    """The unquantized options (dense bf16 weights, "w4" without
    activation quantization, the bf16 cache) and GPT-2's Conv1D sites
    (per-input-channel ``kscale``, ROADMAP Queue 1 item 5, from the port's
    build_engine_params and from a reference tree) build and serve; a
    tensor-parallel config is accepted and its forward asks for its tp
    group; on the card's path the attention kernels take head_dim 96 and
    raise past 256, the widest they are built for."""
    _, tcfg = _configs()
    params, quant = _model(seed=5)
    for i in range(_GEOM["n_layers"]):
        # a Conv1D site's weight state is per input channel: one alpha
        w = params[f"h_{i}"]["fc_in"]["kernel"]
        quant[f"h_{i}"]["fc_in"]["weight_q"] = _state(
            np.float32(0.9 * np.abs(w).max()), cb.ant_grid("flint", 4, True))
    conv = dataclasses.replace(tcfg, lm=dataclasses.replace(
        tcfg.lm, conv1d_sites=("fc_in",)))
    jcfg, _ = _configs()
    jconv = dataclasses.replace(jcfg, lm=dataclasses.replace(
        jcfg.lm, conv1d_sites=("fc_in",)))
    jep = _np_tree(jeng.build_engine_params(jconv, params, quant))
    assert "kscale" in jep["layers"]["fc_in"]
    built = {"conv1d": teng.build_engine_params(conv, params, quant,
                                                device="cpu"),
             "conv1d_converted": convert.from_jax_engine_params(
                 jep, device="cpu")}
    for change in (dict(weight_mode="bf16"), dict(act_bits=0),
                   dict(kv_int8=False), "conv1d", "conv1d_converted"):
        if isinstance(change, str):
            cfg, ep = conv, built[change]
            site = ep["layers"]["fc_in"]
            assert site["kscale"].shape == (2, 256)
            assert "oscale" not in site
        else:
            cfg = dataclasses.replace(tcfg, **change)
            teng._check_config(cfg)
            ep = teng.build_engine_params(cfg, params, quant, device="cpu")
        kv = teng.init_cache(cfg, 1, device="cpu")
        logits, _ = teng.forward(cfg, ep, torch.zeros((1, 3),
                                                      dtype=torch.int64),
                                 kv, 0)
        assert logits.shape == (1, 3, 128), change
        assert bool(torch.isfinite(logits).all()), change
    # tensor parallelism: a tp axis and a size that splits the heads and
    # d_ff; its forward runs with its tp group (serve.sharded)
    tp2 = dataclasses.replace(tcfg, tp_size=2, tp_axis="tp")
    teng._check_config(tp2)
    with pytest.raises(ValueError, match="needs a tp_axis"):
        teng._check_config(dataclasses.replace(tcfg, tp_size=2))
    with pytest.raises(ValueError, match="do not split"):
        teng._check_config(dataclasses.replace(tcfg, tp_size=3,
                                               tp_axis="tp"))
    ep = teng.build_engine_params(tcfg, params, quant, device="cpu")
    with pytest.raises(ValueError, match="tp group"):
        teng.forward(tp2, ep, torch.zeros((1, 3), dtype=torch.int64),
                     teng.init_cache(tcfg, 1, device="cpu"), 0)
    # head_dims on the card: BLOOM-1b1's 96 passes the kernels' operand
    # checks (on one layer, as both wrappers launch; no ALiBi: no slopes
    # pointer); 257, past the widest the CUDA kernels are built for,
    # raises before anything is built or launched
    B, H, S = 1, 2, 64
    pos0 = torch.zeros((B,), dtype=torch.int32)
    for D in (96, 257):
        q = torch.zeros((B, H, 1, D))
        kc = torch.zeros((B, H, S, D), dtype=torch.int8)
        sc = torch.zeros((B, H, S))
        args = (q, kc, kc, sc, sc, pos0, None, torch.float32, (B, H, S))
        if D == 96:
            assert tk2._checked_operands(*args) == 0
        else:
            with pytest.raises(NotImplementedError, match="ROADMAP Queue 3"):
                tk2._checked_operands(*args)


def test_package_imports_no_jax():
    """Importing every module of the port (all of the package, walked by
    ``pkgutil.walk_packages``) loads none of jax, flax, optax and the
    reference package, nor matplotlib (absent on the card's host;
    ``plot_results`` imports it when it draws)."""
    code = ("import importlib, pkgutil, sys\n"
            "import ant_quantization_tpu_torch as pkg\n"
            "mods = [m.name for m in pkgutil.walk_packages(\n"
            "    pkg.__path__, pkg.__name__ + '.')]\n"
            "for m in mods: importlib.import_module(m)\n"
            "want = {'serve.engine', 'kernels.stacked', 'harness.zoo',\n"
            "        'tools.serve_cli', 'tools.clm_eval', 'models.bert',\n"
            "        'models.bart', 'harness.qa_utils', 'tools.glue_run',\n"
            "        'tools.squad_run', 'tools.run_recipe', 'harness.train',\n"
            "        'harness.resilient', 'models.resnet', 'models.cnn',\n"
            "        'models.vit', 'models.inception', 'tools.imagenet_eval',\n"
            "        'tools.imagenet_qat', 'tools.qat_bench',\n"
            "        'tools.lm_bench', 'tools.spec_bench',\n"
            "        'utils.profiling', 'perfmodel.model',\n"
            "        'perfmodel.simulator', 'perfmodel.sram',\n"
            "        'perfmodel.energy', 'perfmodel.nets',\n"
            "        'perfmodel.results', 'perfmodel.arch',\n"
            "        'perfmodel.graph', 'perfmodel.loopnest',\n"
            "        'tools.simulate', 'tools.arch_sweep',\n"
            "        'tools.print_result', 'tools.plot_results',\n"
            "        'parallel.distributed', 'parallel.mesh',\n"
            "        'parallel.comm', 'parallel.collective_matmul',\n"
            "        'parallel.pipeline',\n"
            "        'serve.sharded', 'tools.tp_bench',\n"
            "        'tools.multihost_dryrun'}\n"
            "assert {pkg.__name__ + '.' + m for m in want} <= set(mods), "
            "mods\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'ant_quantization_tpu', "
            "'matplotlib')]\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
