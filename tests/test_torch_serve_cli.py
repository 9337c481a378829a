"""PyTorch port vs the JAX reference: the LM command lines
(``tools/serve_cli.py``, ``tools/clm_eval.py``) and engine checkpoints
(``harness/checkpoint.py``), called in process on the CPU on a tiny
local HF OPT directory (1 layer, d_model 128, 2 heads of 64, d_ff 128,
vocab 1024; fp16 weights in two safetensors shards, written here).

- the port CLI's engine under ``--family ant`` (its ``zoo.get_lm`` ->
  ``calibrate_on_batches`` -> ``build_engine_params``) against the JAX
  chain's on the same directory and calibration batch, converted: every
  leaf of the same dtype and shape, and bit-equal (the seed's
  calibration first checked clear of near-ties on the reference's
  scores, ``test_torch_calibrate._assert_clear_of_ties``) except the
  input states' alphas (``a_alpha``, ``a_scale``), held within 1e-5
  relative as ``test_torch_lm_calibrate.py`` holds them: past the first
  site the frameworks reach the activations by other f32 sum orders
  (LayerNorm, attention, the f32 products), and an ulp of an absmax is
  an ulp of alpha. Under OliVe the weights' 3-sigma bases are a mean
  and a std, summed in other orders too (within 2 ulps,
  ``test_torch_calibrate.py``), so its scales are not held bit for bit
  here;
- ``--save_engine`` then ``--load_engine``: a bit-equal tree, "w4"
  stacks stored packed, and identical greedy tokens, under ``--family
  olive`` (K4 at decode) and ``--family ant`` (K1);
- ROADMAP Queue 1 item 8's cross-check: an engine built by the JAX
  package and converted (``convert.from_jax_engine_params``), saved and
  loaded by the port, serves the converted engine's greedy tokens;
- ``clm_eval --disable_quant``: the perplexity within 1e-5 relative of
  the JAX chain's ``lm_perplexity`` on the same blocks;
- without ``--device cpu`` and without a card both CLIs raise; under
  ``ANT_COORDINATOR`` both join a world of one rank and give the same
  output as outside one.
"""

import contextlib
import dataclasses
import functools
import io
import json
import os
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ant_quantization_tpu.harness import evaluate as jev
from ant_quantization_tpu.harness import zoo as jzoo
from ant_quantization_tpu.nn.config import QuantConfig as JQ
from ant_quantization_tpu.serve import engine as jeng
from ant_quantization_tpu_torch import convert
from ant_quantization_tpu_torch.calibrate.spec import QuantState
from ant_quantization_tpu_torch.harness import checkpoint
from ant_quantization_tpu_torch.harness.safetensors_io import (
    write_safetensors)
from ant_quantization_tpu_torch.kernels import stacked as tk
from ant_quantization_tpu_torch.parallel.distributed import (free_port,
                                                             shutdown)
from ant_quantization_tpu_torch.serve import engine as teng
from ant_quantization_tpu_torch.serve.scheduler import (ContinuousBatcher,
                                                        Request)
from ant_quantization_tpu_torch.tools import clm_eval, serve_cli

import test_torch_calibrate as tcal

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.torchdep


D, FF, V, L = 128, 128, 1024, 1
PROMPTS = "5,6,7,8,9,10,11,12,13,14;20,21,22;300,2,999,40,41,42,43"
NEW = 4
FAMILIES = {"olive": "K4", "ant": "K1"}
_SEED = 0


def _write_opt_dir(path: str, seed: int) -> None:
    """An HF OPT-format directory: config.json and fp16 weights from a
    seeded generator (normal with std 1/sqrt(fan in); LayerNorms near 1
    and 0), split over two safetensors shards."""
    rng = np.random.default_rng(seed)
    config = {"model_type": "opt", "vocab_size": V, "hidden_size": D,
              "num_hidden_layers": L, "num_attention_heads": 2,
              "ffn_dim": FF, "max_position_embeddings": 64,
              "word_embed_proj_dim": D, "do_layer_norm_before": True}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float16))
    d = "model.decoder"
    sd = {f"{d}.embed_tokens.weight": t(rng.normal(size=(V, D))),
          f"{d}.embed_positions.weight": t(0.3 * rng.normal(size=(66, D))),
          f"{d}.final_layer_norm.weight": t(1 + 0.1 * rng.normal(size=D)),
          f"{d}.final_layer_norm.bias": t(0.1 * rng.normal(size=D))}
    for i in range(L):
        b = f"{d}.layers.{i}"
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            sd[f"{b}.{ln}.weight"] = t(1 + 0.1 * rng.normal(size=D))
            sd[f"{b}.{ln}.bias"] = t(0.1 * rng.normal(size=D))
        for name, (n_in, n_out) in (
                ("self_attn.q_proj", (D, D)), ("self_attn.k_proj", (D, D)),
                ("self_attn.v_proj", (D, D)), ("self_attn.out_proj", (D, D)),
                ("fc1", (D, FF)), ("fc2", (FF, D))):
            sd[f"{b}.{name}.weight"] = t(rng.normal(size=(n_out, n_in))
                                         / np.sqrt(n_in))
            sd[f"{b}.{name}.bias"] = t(0.05 * rng.normal(size=n_out))
    names = sorted(sd)
    half = len(names) // 2
    for i, part in enumerate((names[:half], names[half:])):
        write_safetensors(
            os.path.join(path, f"model-0000{i + 1}-of-00002.safetensors"),
            {k: sd[k] for k in part}, {"format": "pt"})


@functools.lru_cache(maxsize=None)
def _model_dir() -> str:
    d = tempfile.mkdtemp(prefix="opt_tiny_")
    _write_opt_dir(d, _SEED)
    return d


def _run(main, argv):
    """A CLI's ``main(argv)`` in process; its JSON output lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _serve_args(family, *extra):
    return ["--model", _model_dir(), "--device", "cpu", "--family", family,
            "--prompt-ids", PROMPTS, "--max_new_tokens", str(NEW),
            "--max_seq", "64", "--slots", "2", "--lm_head_int8", *extra]


def _tokens(out: str):
    lines = [json.loads(l) for l in out.splitlines()]
    return [l["tokens"] for l in lines[:-1]], lines[-1]


@functools.lru_cache(maxsize=None)
def _saved(family):
    """The port CLI run with ``--save_engine``: (engine dir, its engine
    params as built, its greedy tokens)."""
    path = tempfile.mkdtemp(prefix=f"engine_{family}_")
    built = {}
    save = serve_cli.save_engine

    def keep(p, cfg, ep):
        built.update(cfg=cfg, ep=ep)
        save(p, cfg, ep)

    serve_cli.save_engine = keep
    try:
        out = _run(serve_cli.main, _serve_args(family, "--save_engine",
                                               path))
    finally:
        serve_cli.save_engine = save
    return path, built["cfg"], built["ep"], _tokens(out)[0]


def _calib_ids():
    """The CLI's calibration batch: each prompt's first 8 ids, 0-padded."""
    ps = [[int(t) for t in p.split(",")] for p in PROMPTS.split(";")][:4]
    return np.asarray([p[:8] + [0] * max(0, 8 - len(p)) for p in ps],
                      np.int32)


@functools.lru_cache(maxsize=None)
def _jax_chain():
    """The reference's serve CLI chain on the same directory under
    ``--family ant`` ("ant-int-flint", W4A4): zoo.get_lm,
    calibrate_on_batches on the same batch, build_engine_params (leaves
    as numpy)."""
    model, cfg, params = jzoo.get_lm(_model_dir(), JQ(
        mode="ant-int-flint", family="ant", w_up=250, a_up=250))
    quant = jev.calibrate_on_batches(model, {"params": params},
                                     [(jnp.asarray(_calib_ids()),)])
    ecfg = jeng.EngineConfig(lm=cfg, weight_mode="w4", act_bits=4,
                             kv_int8=True, max_seq=64, lm_head_int8=True,
                             interpret=True)
    jep = jeng.build_engine_params(ecfg, params, quant)
    return params, quant, jax.tree_util.tree_map(np.asarray, jep)


def _site_inputs():
    """Each site's calibration input in the port's model (captured by
    forward pre-hooks on the CLI's batch)."""
    from ant_quantization_tpu_torch.harness import zoo
    from ant_quantization_tpu_torch.nn.config import QuantConfig
    from ant_quantization_tpu_torch.nn.layers import QuantDense
    model, _, _ = zoo.get_lm(_model_dir(), QuantConfig(enabled=False),
                             device="cpu")
    xs = {}

    def keep(name):
        def hook(m, args):
            xs[name] = args[0].detach().numpy()
        return hook

    hooks = [m.register_forward_pre_hook(keep(n))
             for n, m in model.named_modules() if isinstance(m, QuantDense)]
    with torch.no_grad():
        model(torch.from_numpy(_calib_ids()).long())
    for h in hooks:
        h.remove()
    return xs


def test_engine_leaves_equal_the_jax_chain():
    params, _, jep = _jax_chain()
    # the seed's weights and first inputs win their searches clearly on
    # the reference's scores
    w_kw = dict(bit=4, mode="ant-int-flint", family="ant", w_up=250,
                a_up=250, channel_axis=-1)
    xs = _site_inputs()
    for name in ("q", "out"):
        tcal._assert_clear_of_ties(
            np.asarray(params["h_0"]["attn"][name]["kernel"]), w_kw)
        tcal._assert_clear_of_ties(
            xs[f"h_0.attn.{name}"],
            dict(w_kw, is_input=True, is_signed=False, pair_axis=-1))
    _, cfg, got, _ = _saved("ant")
    want = convert.from_jax_engine_params(jep, device="cpu")
    gl, wl = dict(teng._flatten(got)), dict(teng._flatten(want))
    assert set(gl) == set(wl)
    for path, w in wl.items():
        g = gl[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        if path[-1] in ("a_alpha", "a_scale"):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=0)
        else:
            assert torch.equal(g, w), (path, int((g != w).sum()))
    assert torch.equal(gl[("layers", "q", "a_alpha")],
                       wl[("layers", "q", "a_alpha")])    # the first site
    assert "a_q" in got["layers"]["fc_in"]


def _same_tree(a, b):
    fa, fb = dict(teng._flatten(a)), dict(teng._flatten(b))
    assert set(fa) == set(fb)
    for path, t in fa.items():
        assert fb[path].dtype == t.dtype and torch.equal(fb[path], t), path


@pytest.mark.parametrize("family", list(FAMILIES))
def test_save_then_load_serves_the_same_tokens(family):
    """The loaded engine is the saved one bit for bit, serves the same
    greedy tokens, and its decode runs the family's stacked kernel (the
    plain version on the CPU) at every site."""
    path, cfg, built, toks = _saved(family)
    with open(os.path.join(path, "engine.json")) as f:
        meta = json.load(f)
    assert meta["w4_codec"] == 1
    assert meta["w4_bytes_packed"] < 0.66 * meta["w4_bytes_i8"]
    assert meta["lm"]["dtype"] == "float32" and meta["lm_head_int8"]
    lcfg, loaded = serve_cli.load_engine(path, device="cpu")
    assert lcfg == cfg
    _same_tree(built, loaded)
    stored = checkpoint.restore_checkpoint(os.path.join(path, "ep"),
                                           device="cpu")
    assert "w_i8" not in stored["layers"]["q"]
    assert stored["layers"]["q"]["w4_packed"].dtype == torch.uint8
    counts = {k: dict(c) for k, c in (("K1", tk.COUNTS),
                                      ("K4", tk.K4_COUNTS))}
    out = _run(serve_cli.main, _serve_args(family, "--load_engine", path))
    got, summary = _tokens(out)
    assert got == toks and summary["new_tokens"] == 3 * NEW
    k = FAMILIES[family]
    c = tk.COUNTS if k == "K1" else tk.K4_COUNTS
    assert c["plain_calls"] > counts[k]["plain_calls"]


def _greedy(cfg, ep):
    cb = ContinuousBatcher(cfg, ep, batch_slots=2)
    for p in PROMPTS.split(";"):
        cb.submit(Request(prompt=[int(t) for t in p.split(",")],
                          max_new_tokens=NEW))
    return {c.id: c.tokens for c in cb.run()}


def test_jax_built_engine_saved_and_loaded_by_the_port(tmp_path):
    """ROADMAP Queue 1 item 8's cross-check: the reference's engine,
    converted, then saved and loaded by the port, serves the converted
    engine's greedy tokens."""
    _, _, jep = _jax_chain()
    _, cfg, _, _ = _saved("olive")
    conv = convert.from_jax_engine_params(jep, device="cpu")
    serve_cli.save_engine(str(tmp_path), cfg, conv)
    lcfg, loaded = serve_cli.load_engine(str(tmp_path), device="cpu")
    _same_tree(conv, loaded)
    assert _greedy(lcfg, loaded) == _greedy(cfg, conv)


def test_clm_eval_perplexity_matches_the_jax_chain():
    argv = ["--model", _model_dir(), "--dataset", "synthetic", "--device",
            "cpu", "--block_size", "16", "--batch_size", "2",
            "--max_blocks", "5"]
    got = json.loads(_run(clm_eval.main, argv + ["--disable_quant"]))
    model, _, params = jzoo.get_lm(_model_dir(), JQ(enabled=False))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 1000, 64 * 16).astype(np.int32)
    blocks = tokens[:5 * 16].reshape(5, 16)
    want = jev.lm_perplexity(model, {"params": params}, blocks, 2)
    assert got["perplexity"] == pytest.approx(want["perplexity"], rel=1e-5)
    assert got["eval_loss"] == pytest.approx(want["eval_loss"], rel=1e-5)
    q = json.loads(_run(clm_eval.main, argv + ["--max_blocks", "2"]))
    assert np.isfinite(q["perplexity"]) and q["ovp"] is True


@pytest.mark.parametrize("main,argv", [
    (serve_cli.main, ["--model", "opt:125m"]),
    (clm_eval.main, ["--model", "opt:125m", "--dataset", "synthetic"])])
def test_clis_need_a_card_or_the_cpu(main, argv, monkeypatch):
    """Under ``ANT_COORDINATOR`` a CLI joins a world of one rank (gloo on
    the CPU) and serves or evaluates as outside one; without ``--device
    cpu`` and without a card it raises."""
    for k in ("ANT_COORDINATOR", "ANT_DISTRIBUTED"):
        monkeypatch.delenv(k, raising=False)
    tiny = (_serve_args("ant") if main is serve_cli.main else
            ["--model", _model_dir(), "--dataset", "synthetic", "--device",
             "cpu", "--block_size", "16", "--batch_size", "2",
             "--max_blocks", "2"])
    alone = _run(main, tiny)
    monkeypatch.setenv("ANT_COORDINATOR", f"127.0.0.1:{free_port()}")
    monkeypatch.setenv("ANT_NUM_PROCESSES", "1")
    monkeypatch.setenv("ANT_PROCESS_ID", "0")
    try:
        in_world = _run(main, tiny)
        assert torch.distributed.is_initialized()
        assert torch.distributed.get_world_size() == 1
        assert torch.distributed.get_backend() == "gloo"
    finally:
        shutdown()
    monkeypatch.delenv("ANT_COORDINATOR")
    if main is serve_cli.main:
        assert _tokens(in_world)[0] == _tokens(alone)[0]
    else:
        assert json.loads(in_world)["perplexity"] == json.loads(
            alone)["perplexity"]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def test_checkpoint_round_trip(tmp_path):
    """Tensors of every engine dtype, scalars and QuantState leaves come
    back bit-equal; a template restores the dataclass; the latest step
    is found."""
    st = QuantState(
        alpha=torch.tensor([0.5, 2.0]), grid=torch.arange(4.0),
        outliers=torch.zeros(4), bit=torch.tensor(4, dtype=torch.int32),
        mode_idx=torch.tensor(1, dtype=torch.int32),
        is_signed=torch.tensor(True), mse=torch.tensor(1e-3),
        initialized=torch.tensor(True), aux=torch.tensor(0.0))
    tree = {"a": {"w": torch.randint(-8, 8, (3, 4), dtype=torch.int8),
                  "s": torch.rand(3), "b": torch.tensor(1.5).bfloat16()},
            "st": st, "n": 3, "name": "x", "flag": None, "empty": {}}
    checkpoint.save_checkpoint(str(tmp_path), tree, step=2)
    checkpoint.save_checkpoint(str(tmp_path), {"a": {}}, step=1)
    assert checkpoint.latest_step(str(tmp_path)) == 2
    back = checkpoint.restore_checkpoint(str(tmp_path), template=tree,
                                         device="cpu")
    assert isinstance(back["st"], QuantState)
    for f in dataclasses.fields(QuantState):
        assert torch.equal(getattr(back["st"], f.name),
                           getattr(st, f.name)), f.name
    for k in ("w", "s", "b"):
        assert back["a"][k].dtype == tree["a"][k].dtype
        assert torch.equal(back["a"][k], tree["a"][k]), k
    assert (back["n"], back["name"], back["flag"], back["empty"]) == (
        3, "x", None, {})
    raw = checkpoint.restore_checkpoint(str(tmp_path), device="cpu")
    assert isinstance(raw["st"], dict) and set(raw["st"]) == {
        f.name for f in dataclasses.fields(QuantState)}
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_checkpoint(str(tmp_path / "none"), device="cpu")
