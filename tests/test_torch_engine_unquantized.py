"""PyTorch port vs the JAX reference: the unquantized engine options.

- ``weight_mode="bf16"``: the dense kernel in ``cfg.dtype`` with an f32
  product, without activation quantization and with the A4 fake-quant;
- "w4" with ``act_bits=0`` (W4A16): x in ``cfg.dtype`` against the int8
  codebook values, then ``oscale``;
- the bf16 KV cache (``kv_int8=False``): raw values, read by the einsum.

Each on the 2-layer OPT engine of ``test_torch_engine.py`` (prefill of
40 tokens, then decode steps) and one on the 2-layer BLOOM engine of
``test_torch_engine_bloom.py`` (fused qkv, ALiBi, GELU), against JAX
``forward``: at f32 within 5e-3 of the logits, as the other engine
tests, and at bf16 within the bf16 noise level of
``test_torch_engine_bf16.py`` (F3) with the same greedy token at every
position. Also the raw cache's append against the reference's, and
``convert`` for a dense tree and a bf16 cache against the port's own
build.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ant_quantization_tpu.kernels import kv_cache as jkv
from ant_quantization_tpu.serve import engine as jeng
from ant_quantization_tpu_torch import convert
from ant_quantization_tpu_torch.kernels import attention as tk2
from ant_quantization_tpu_torch.kernels import kv_cache as tkv
from ant_quantization_tpu_torch.kernels import stacked as tk1
from ant_quantization_tpu_torch.serve import engine as teng

import test_torch_engine as opt
import test_torch_engine_bf16 as bf
import test_torch_engine_bloom as bloom

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.torchdep

# (name, model, config changes): each runs at f32 and at bf16
_CASES = {
    "bf16_int8kv": ("opt", dict(weight_mode="bf16", act_bits=0,
                                lm_head_int8=False)),
    "bf16_bf16kv": ("opt", dict(weight_mode="bf16", act_bits=0,
                                kv_int8=False, lm_head_int8=False)),
    "bf16_a4": ("opt", dict(weight_mode="bf16", act_bits=4)),
    # W4A16 with the int8 head (as it runs on the card) and with the plain
    # head: with no A4 snap upstream the int8 head's per-token rounding
    # sees the f32 sums' order, see _int8_head_close
    "w4a16": ("opt", dict(act_bits=0)),
    "w4a16_plain_head": ("opt", dict(act_bits=0, lm_head_int8=False)),
    "w4a4_bf16kv": ("opt", dict(kv_int8=False)),
    "bloom_bf16_bf16kv": ("bloom", dict(weight_mode="bf16", act_bits=0,
                                        kv_int8=False)),
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _case(name: str, dtype: str):
    model, change = _CASES[name]
    if model == "opt":
        jcfg, tcfg = opt._configs()
        params, quant = opt._model(seed=0)
        ids = np.random.default_rng(1).integers(0, 128, (opt._B, opt._T))
    else:
        jcfg, tcfg = bloom.configs(64)
        params, quant = bloom.bloom_model(seed=0)
        ids = np.random.default_rng(1).integers(0, 128, (bloom._B, 8))
    jcfg = dataclasses.replace(jcfg, **change)
    tcfg = dataclasses.replace(tcfg, **change)
    if dtype == "bf16":
        jcfg, tcfg = bf._bf16(jcfg, tcfg)
    if change.get("weight_mode") == "bf16" and not change.get("act_bits",
                                                              4):
        quant = None                # the dense baseline needs no states
    return jcfg, tcfg, params, quant, ids


@functools.lru_cache(maxsize=None)
def _jax_built(name: str, dtype: str):
    """The reference's engine params of a case (shared by the tests;
    none changes them)."""
    jcfg, _, params, quant, _ = _case(name, dtype)
    return jeng.build_engine_params(jcfg, params, quant)


def _run(jcfg, tcfg, jep, tep, ids, steps, close):
    """Prefill and ``steps`` greedy decode steps of both engines, each
    call's logits held by ``close``; returns both caches and the final
    position."""
    B = ids.shape[0]
    jc = jeng.init_cache(jcfg, B)
    tc = teng.init_cache(tcfg, B, device="cpu")
    pos = 0
    for step in range(1 + steps):
        jl, jc = jeng.forward(jcfg, jep, jnp.asarray(ids), jc, pos)
        tl, tc = teng.forward(tcfg, tep, torch.from_numpy(ids), tc, pos)
        jl = np.asarray(jl)
        assert tl.dtype == torch.float32
        close(tl.numpy(), jl, f"step {step}")
        pos += ids.shape[1]
        ids = jl[:, -1:].argmax(-1)      # both engines take the same token
    return jc, tc, pos


def _close_f32(tl, jl, what):
    np.testing.assert_allclose(tl, jl, rtol=5e-3, atol=5e-3, err_msg=what)


def _int8_head_close(monkeypatch, top):
    """The f32 check of an int8-head engine with no activation snap
    upstream. The head rounds each token's ln_f output x to int8 codes on
    the token's absmax scale s, and the f32 sums before it run in torch's
    order in the port and in XLA's (under jit) in the reference: a code
    at a .5 edge may round one step apart, which moves that token's logit
    v by s * wte_scale[v] * wte_i8[v, j].
    Both heads' inputs are recorded and held to 5e-3 as the logits are;
    every code that differs must be one step apart and at its edge, and
    the logits are held to 5e-3 plus exactly those steps."""
    heads = {"port": [], "ref": []}
    for side, mod in (("port", teng), ("ref", jeng)):
        def recorded(top_, x, _f=mod._lm_logits, _to=heads[side]):
            _to.append(np.asarray(x, np.float64))
            return _f(top_, x)
        monkeypatch.setattr(mod, "_lm_logits", recorded)
    w = top["wte_i8"].double().numpy() * top["wte_scale"].double().numpy(
        )[:, None]                                               # (V, D)

    def codes(x):
        s = np.abs(x).max(-1, keepdims=True) / 127.0
        return np.round(x / s), x / s, s

    def close(tl, jl, what):
        xt, xj = heads["port"].pop(), heads["ref"].pop()
        np.testing.assert_allclose(xt, xj, rtol=5e-3, atol=5e-3,
                                   err_msg=f"{what}: head input")
        qt, ut, s = codes(xt)
        qj, uj, _ = codes(xj)
        flip = qt - qj
        assert np.abs(flip).max() <= 1, what
        at_edge = np.abs(np.abs(ut - np.floor(ut)) - 0.5) < 1e-2
        assert (at_edge | (flip == 0)).all(), what
        step = np.abs(flip) @ np.abs(w).T * s                    # (B, T, V)
        np.testing.assert_array_less(
            np.abs(tl - jl), 5e-3 + 5e-3 * np.abs(jl) + step + 1e-6,
            err_msg=f"{what}: {int(np.abs(flip).sum())} head codes apart")
    return close



@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(_CASES))
def test_unquantized_engine_matches_reference(name, dtype, monkeypatch):
    jcfg, tcfg, params, quant, ids = _case(name, dtype)
    jep = _jax_built(name, dtype)
    tep = convert.from_jax_engine_params(_np_tree(jep), device="cpu")
    k1, k2 = dict(tk1.COUNTS), dict(tk2.COUNTS)
    steps = 2
    close = _close_f32 if dtype == "f32" else bf._engine_close
    if dtype == "f32" and tcfg.lm_head_int8 and not tcfg.act_bits:
        close = _int8_head_close(monkeypatch, tep["top"])
    jc, tc, pos = _run(jcfg, tcfg, jep, tep, ids, steps, close)
    L = tcfg.lm.n_layers
    # K1 serves decode only with int8-exact activation grids ("w4" A4);
    # K2 only the INT8 cache (the bf16 cache takes the einsum)
    want_k1 = 6 * L * steps if (tcfg.weight_mode == "w4"
                                and tcfg.act_bits) else 0
    want_k2 = L * (1 + steps) if tcfg.kv_int8 else 0
    assert tk1.COUNTS["plain_calls"] - k1["plain_calls"] == want_k1
    assert tk2.COUNTS["plain_calls"] - k2["plain_calls"] == want_k2
    if not tcfg.kv_int8:
        want = convert.from_jax_kv(_np_tree(jc), tcfg.lm.head_dim,
                                   device="cpu")
        assert tc.k.dtype == want.k.dtype == tcfg.dtype
        # the raw values written, at f32 within the logits' tolerance (at
        # bf16 one ulp upstream moves W4A4's A4 snaps, which move whole
        # k and v rows: the logits above are the bf16 check)
        for a in ("k", "v"):
            if dtype == "f32":
                np.testing.assert_allclose(
                    getattr(tc, a)[..., :pos, :].numpy(),
                    getattr(want, a)[..., :pos, :].numpy(),
                    rtol=5e-3, atol=5e-3, err_msg=a)


@pytest.mark.parametrize("name", ["bf16_int8kv", "bf16_a4", "w4a16"])
def test_build_engine_params_matches_converted(name):
    """The port's own build of the unquantized options equals the
    converted reference tree leaf for leaf (dense kernels transposed to
    (L, N, K) in ``cfg.dtype``; "bf16" with A4 carries only a_grid,
    a_alpha)."""
    jcfg, tcfg, params, quant, _ = _case(name, "bf16")
    got = teng.build_engine_params(tcfg, params, quant, device="cpu")
    want = convert.from_jax_engine_params(_np_tree(_jax_built(name, "bf16")),
                                          device="cpu")
    gl, wl = dict(teng._flatten(got)), dict(teng._flatten(want))
    assert set(gl) == set(wl)
    for path, w in wl.items():
        assert gl[path].dtype == w.dtype, path
        assert torch.equal(gl[path], w), path
    if tcfg.weight_mode == "bf16":
        site = got["layers"]["fc_in"]
        assert site["kernel"].shape == (2, 512, 256)
        assert "a_q" not in site and "w_i8" not in site
        assert ("a_grid" in site) == bool(tcfg.act_bits)


def test_bf16_needs_no_quant_and_w4_does():
    _, tcfg = opt._configs()
    params, _ = opt._model(seed=0)
    dense = dataclasses.replace(tcfg, weight_mode="bf16", act_bits=4)
    ep = teng.build_engine_params(dense, params, None, device="cpu")
    assert not any("a_grid" in s for s in ep["layers"].values())
    with pytest.raises(ValueError, match="quantizer states"):
        teng.build_engine_params(tcfg, params, None, device="cpu")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_raw_cache_append_matches_reference(dtype):
    """The bf16 (and f32) cache stores the values cast to f32 and then to
    its dtype, per sequence at its own position, bit for bit as the
    reference's; its scales stay untouched."""
    L, B, H, S, D, T = 2, 3, 2, 24, 8, 5
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    rng = np.random.default_rng(0)
    k = rng.normal(size=(B, T, H, D)).astype(np.float32)
    v = rng.normal(size=(B, T, H, D)).astype(np.float32)
    pos = np.array([0, 7, 19], np.int32)
    base = jkv.init_kv(B, S, H, D, fold=1)
    jc = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (L,) + x.shape),
        jkv.QuantKV(jnp.zeros(base.k.shape, jdt), jnp.zeros(base.v.shape,
                                                            jdt),
                    base.k_scale, base.v_scale))
    jc = jkv.append_kv_stacked(jc, jnp.asarray(k), jnp.asarray(v), 1,
                               jnp.asarray(pos))
    tc = tkv.init_kv(L, B, S, H, D, torch.device("cpu"), dtype=tdt)
    tkv.append_kv_stacked(tc, torch.from_numpy(k), torch.from_numpy(v), 1,
                          torch.from_numpy(pos))
    want = convert.from_jax_kv(_np_tree(jc), D, device="cpu")
    for name in ("k", "v"):
        assert getattr(tc, name).dtype == tdt
        assert torch.equal(getattr(tc, name), getattr(want, name)), name
    assert not tc.k_scale.any() and not tc.v_scale.any()
    with pytest.raises(ValueError, match="exceeds the cache length"):
        tkv.append_kv_stacked(tc, torch.from_numpy(k), torch.from_numpy(v),
                              0, [0, 20, 0])


def test_init_cache_bf16_matches_converted():
    """The port's empty bf16 cache has the converted reference cache's
    dtype, shape and values."""
    jcfg, tcfg = bf._bf16(*opt._configs())
    jcfg = dataclasses.replace(jcfg, kv_int8=False)
    tcfg = dataclasses.replace(tcfg, kv_int8=False)
    want = convert.from_jax_kv(_np_tree(jeng.init_cache(jcfg, 2)),
                               tcfg.lm.head_dim, device="cpu")
    got = teng.init_cache(tcfg, 2, device="cpu")
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    assert got.k.dtype == torch.bfloat16
    assert teng.attention_route(tcfg.lm, 1, tcfg.max_seq,
                                kv_int8=False) == "einsum"
    assert teng.attention_route(tcfg.lm, 1, tcfg.max_seq) == "K2"
