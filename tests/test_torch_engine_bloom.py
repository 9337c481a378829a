"""PyTorch port vs the JAX reference: the BLOOM geometry (fused qkv, the
embedding LayerNorm, ALiBi, GELU) on a 2-layer BLOOM-shaped W4A4 + INT8-KV
+ int8-lm_head engine, with a scalar and with a per-sequence pos0, on the
route where attention runs K2 (a short cache), and the port's
build_engine_params and ragged serving. Logits within 5e-3 of the reference, as for
the OPT engine. Two heads of head_dim 128, so the reference keeps its
cache flat; and two heads of 96, BLOOM-1b1's head_dim (d_model 192,
d_ff 768), also flat there."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ant_quantization_tpu.calibrate.spec import QuantState, pad_grid
from ant_quantization_tpu.models.transformer_lm import LMConfig as JLMConfig
from ant_quantization_tpu.serve import engine as jeng
from ant_quantization_tpu_torch import convert
from ant_quantization_tpu_torch.models.transformer_lm import LMConfig
from ant_quantization_tpu_torch.numerics import codebooks as cb
from ant_quantization_tpu_torch.serve import engine as teng

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.torchdep

_D, _FF = 256, 1024
_GEOM = dict(vocab_size=128, d_model=_D, n_layers=2, n_heads=2, d_ff=_FF,
             positions="alibi", activation="gelu", fused_qkv=True,
             embed_ln=True)
_B = 2


def _sites(d, ff):
    return {"qkv": (d, 3 * d), "out": (d, d), "fc_in": (d, ff),
            "fc_out": (ff, d)}


def _state(alpha, grid):
    return QuantState(
        alpha=jnp.asarray(alpha, jnp.float32),
        grid=jnp.asarray(pad_grid(grid)),
        outliers=jnp.zeros((256,), jnp.float32),
        bit=jnp.asarray(4, jnp.int32), mode_idx=jnp.asarray(0, jnp.int32),
        is_signed=jnp.asarray(True), mse=jnp.asarray(0.0, jnp.float32),
        initialized=jnp.asarray(True), aux=jnp.asarray(0.0, jnp.float32))


def bloom_model(seed=0, d=_D, ff=_FF):
    """Random float weights and flint W4A4 states of a BLOOM-shaped model
    of width ``d`` and d_ff ``ff``: a fused qkv site, an embedding
    LayerNorm, no position table."""
    rng = np.random.default_rng(seed)
    wgrid = cb.ant_grid("flint", 4, True)
    agrid = cb.ant_grid("flint", 4, True)       # GELU inputs are signed
    f32 = lambda a: np.asarray(a, np.float32)
    ln = lambda: {"scale": f32(1 + 0.1 * rng.normal(size=d)),
                  "bias": f32(0.1 * rng.normal(size=d))}
    params, quant = {}, {}
    for i in range(_GEOM["n_layers"]):
        p = {"ln_1": ln(), "ln_2": ln(), "attn": {}}
        q = {"attn": {}}
        for site, (K, N) in _sites(d, ff).items():
            w = f32(rng.normal(size=(K, N)) / np.sqrt(K))
            node = {"kernel": w, "bias": f32(0.05 * rng.normal(size=N))}
            st = {"weight_q": _state(0.9 * np.abs(w).max(0), wgrid),
                  "input_q": _state(np.float32(rng.uniform(1.5, 3.0)),
                                    agrid)}
            (p["attn"] if site in ("qkv", "out") else p)[site] = node
            (q["attn"] if site in ("qkv", "out") else q)[site] = st
        params[f"h_{i}"], quant[f"h_{i}"] = p, q
    params["wte"] = {"embedding": f32(rng.normal(size=(128, d)))}
    params["embed_ln"] = ln()
    params["ln_f"] = ln()
    return params, quant


def configs(max_seq, d=_D, ff=_FF):
    kw = dict(weight_mode="w4", act_bits=4, kv_int8=True, lm_head_int8=True,
              max_seq=max_seq)
    geom = dict(_GEOM, max_seq=max_seq, d_model=d, d_ff=ff)
    jcfg = jeng.EngineConfig(lm=JLMConfig(**geom), dtype=jnp.float32,
                             interpret=True, **kw)
    tcfg = teng.EngineConfig(lm=LMConfig(**geom), dtype=torch.float32, **kw)
    return jcfg, tcfg


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def check_route(monkeypatch, max_seq, chunks, decode, per_seq, seed=0,
                d=_D, ff=_FF):
    """Prefill chunks of ``chunks`` positions, then ``decode`` greedy steps,
    through the reference's ``forward`` and the port's on the same engine
    params (width ``d``, d_ff ``ff``); pos0 is a scalar, or per sequence
    (sequence b starts at 3 b). Logits within 5e-3 at every call. Returns
    the route of each of the port's attention calls."""
    jcfg, tcfg = configs(max_seq, d, ff)
    jep = jeng.build_engine_params(jcfg, *bloom_model(seed, d, ff))
    tep = convert.from_jax_engine_params(np_tree(jep), device="cpu")
    jfwd = jax.jit(lambda ep, ids, kv, pos: jeng.forward(jcfg, ep, ids, kv,
                                                         pos))
    seen = []
    real = teng._attention

    def spy(cfg, r, *args):
        seen.append(r)
        return real(cfg, r, *args)

    monkeypatch.setattr(teng, "_attention", spy)
    start = np.arange(_B) * 3 if per_seq else np.zeros(_B, np.int64)
    rng = np.random.default_rng(seed + 1)
    jkv = jeng.init_cache(jcfg, _B)
    tkv = teng.init_cache(tcfg, _B, device="cpu")
    pos = 0
    calls = [(rng.integers(0, 128, (_B, t)), t) for t in chunks]
    calls += [(None, 1)] * decode
    for i, (ids, t) in enumerate(calls):
        if ids is None:
            ids = jl[:, -1:].argmax(-1)  # both take the reference's token
        p = start + pos
        jp = jnp.asarray(p, jnp.int32) if per_seq else pos
        tp = torch.from_numpy(p) if per_seq else pos
        jl, jkv = jfwd(jep, jnp.asarray(ids), jkv, jp)
        tl, tkv = teng.forward(tcfg, tep, torch.from_numpy(ids), tkv, tp)
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=5e-3, atol=5e-3,
                                   err_msg=f"call {i}")
        pos += t
    return seen


@pytest.mark.parametrize("per_seq", [False, True])
def test_bloom_k2_route_matches_reference(monkeypatch, per_seq):
    seen = check_route(monkeypatch, 64, [8], 3, per_seq)
    assert seen == ["K2"] * 2 * 4


def test_bloom_head_dim_96_matches_reference(monkeypatch):
    """BLOOM-1b1's head_dim: a 2-layer engine of 2 heads of 96, a
    20-token prefill and 3 decode steps on K2, per-sequence pos0."""
    seen = check_route(monkeypatch, 64, [20], 3, True, d=192, ff=768)
    assert seen == ["K2"] * 2 * 4


def test_build_engine_params_matches_converted():
    params, quant = bloom_model(seed=2)
    jcfg, tcfg = configs(64)
    got = teng.build_engine_params(tcfg, params, quant, device="cpu")
    want = convert.from_jax_engine_params(
        np_tree(jeng.build_engine_params(jcfg, params, quant)),
        device="cpu")
    gl, wl = dict(teng._flatten(got)), dict(teng._flatten(want))
    assert set(gl) == set(wl)
    assert "qkv" in got["layers"] and "embed_ln" in got["top"]
    assert "wpe" not in got["top"]
    for path, w in wl.items():
        assert gl[path].dtype == w.dtype, path
        np.testing.assert_array_equal(gl[path].numpy(), w.numpy(),
                                      err_msg=str(path))


def test_equal_per_sequence_pos0_is_bit_equal_to_scalar():
    """A (B,) pos0 whose entries are equal gives the scalar pos0's logits
    and cache, bit for bit, at prefill and at decode."""
    _, tcfg = configs(64)
    ep = teng.build_engine_params(tcfg, *bloom_model(seed=3), device="cpu")
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, 128,
                                                             (_B, 9)))
    a = teng.init_cache(tcfg, _B, device="cpu")
    b = teng.init_cache(tcfg, _B, device="cpu")
    for t0, t1 in ((0, 7), (7, 8), (8, 9)):
        la, _ = teng.forward(tcfg, ep, ids[:, t0:t1], a, t0)
        lb, _ = teng.forward(tcfg, ep, ids[:, t0:t1], b,
                             torch.full((_B,), t0))
        assert torch.equal(la, lb)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_ragged_engine_matches_reference():
    """``Engine.prefill`` with per-sequence lengths (a bucket-padded batch)
    in two chunks, then greedy decode at per-sequence positions, against
    the reference's forward with a (B,) ``last_index`` and a (B,) pos0."""
    jcfg, tcfg = configs(64)
    params, quant = bloom_model(seed=5)
    jep = jeng.build_engine_params(jcfg, params, quant)
    tep = convert.from_jax_engine_params(np_tree(jep), device="cpu")
    ids = np.random.default_rng(6).integers(0, 128, (_B, 12))
    lengths = np.int32([12, 5])
    engine = teng.Engine(tcfg, tep, _B)
    tl = engine.prefill(torch.from_numpy(ids), torch.from_numpy(lengths),
                        chunk=8)
    jkv = jeng.init_cache(jcfg, _B)
    jl, jkv = jeng.forward(jcfg, jep, jnp.asarray(ids), jkv, 0,
                           last_index=jnp.asarray(lengths - 1))
    for step in range(3):
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=5e-3, atol=5e-3,
                                   err_msg=f"step {step}")
        tok = jl[:, -1:].argmax(-1)
        tl = engine.decode(torch.from_numpy(tok))
        jl, jkv = jeng.forward(jcfg, jep, jnp.asarray(tok), jkv,
                               jnp.asarray(lengths + step))
    assert torch.equal(engine.pos, torch.from_numpy(lengths + 3).long())
