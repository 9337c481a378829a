"""PyTorch port vs the JAX reference: the GPT-2 geometry (fused qkv,
learned positions without offset, gelu_new, the tied embedding as head)
with Conv1D sites, quantized per INPUT channel and kept as ``kscale``, on
2-layer GPT-2-shaped engines (d_model 128, 2 heads of head_dim 64, so the
reference folds its INT8 cache two positions to a row; INT8 KV and the
int8 head):

- the per-input-channel quantizers (``axis=0``) bit-equal to the
  reference's, and the port's ``build_engine_params`` equal to the
  reference's tree converted by ``convert.from_jax_engine_params``;
- the ``kscale`` site route (the activation fake-quant, then an f32
  product against ``w_i8`` or its OVP values times ``kscale`` along K)
  within 1e-5 of |x| @ |w| of the reference's ``jnp.dot`` on the same
  inputs, at decode and prefill sizes;
- ANT W4A4 and full OliVe (OVP weights paired along out, OVP
  activations) engines against JAX ``forward``: logits within 5e-3 at
  prefill and at 4 decode steps at f32, caches equal by logical position
  (the reference's folded cache unfolded by ``from_jax_kv``); at bf16
  within the bf16 engine rule of ``test_torch_engine_bf16.py``. No
  stacked product kernel runs: one Conv1D site sends the whole decode
  step to the unfused route, as in the reference;
- a mixed model, Conv1D ``qkv`` and ``out`` with Linear ``fc_in`` and
  ``fc_out``: decode calls no K1, K3 or K4, and with ``stacked_prefill``
  the Linear sites take the stacked kernel and the Conv1D sites keep
  their route.

As in ``test_torch_engine_olive.py``, the f32 engines run at model seed
``_SEED``: the two frameworks sum LayerNorm, the f32 products and the
softmax in other orders, and an ulp can carry an activation across a
quantizer midpoint (and, under OliVe, make it an outlier that zeroes its
pair neighbour); ``_SEED`` keeps clear of those edges, and the site test
holds the arithmetic itself.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ant_quantization_tpu.calibrate.spec import QuantState
from ant_quantization_tpu.kernels import qmatmul as jq
from ant_quantization_tpu.models.transformer_lm import LMConfig as JLMConfig
from ant_quantization_tpu.serve import engine as jeng
from ant_quantization_tpu_torch import convert
from ant_quantization_tpu_torch.kernels import attention as tk2
from ant_quantization_tpu_torch.kernels import qmatmul as tq
from ant_quantization_tpu_torch.kernels import stacked as tk
from ant_quantization_tpu_torch.models.transformer_lm import LMConfig
from ant_quantization_tpu_torch.numerics import codebooks as cb
from ant_quantization_tpu_torch.serve import engine as teng

import test_torch_engine_bf16 as bf

pytestmark = pytest.mark.torchdep

_D, _FF = 128, 512
_GEOM = dict(vocab_size=128, d_model=_D, n_layers=2, n_heads=2, d_ff=_FF,
             max_seq=64, positions="learned", activation="gelu_new",
             fused_qkv=True, conv1d_sites=True)
_SITES = {"qkv": (_D, 3 * _D), "out": (_D, _D), "fc_in": (_D, _FF),
          "fc_out": (_FF, _D)}
_MIXED = ("qkv", "out")
_B, _T, _DECODE = 2, 40, 4          # prefill M = 80 > 64; decode M = 2
_SEED = 0


def _pad(a, size=256):
    return np.pad(np.asarray(a, np.float32), (0, size - len(a)),
                  mode="edge")


def _state(alpha, grid, outliers=None):
    return QuantState(
        alpha=jnp.asarray(alpha, jnp.float32),
        grid=jnp.asarray(_pad(grid)),
        outliers=jnp.asarray(_pad(outliers) if outliers is not None
                             else np.zeros(256, np.float32)),
        bit=jnp.asarray(4, jnp.int32), mode_idx=jnp.asarray(0, jnp.int32),
        is_signed=jnp.asarray(True), mse=jnp.asarray(0.0, jnp.float32),
        initialized=jnp.asarray(True), aux=jnp.asarray(0.0, jnp.float32))


def _model(kind, seed=0, conv1d=True):
    """Random float weights and W4A4 states of a GPT-2-shaped model. A
    Conv1D site's weight state is per input channel (alpha (K,)), a Linear
    site's per output channel (alpha (N,)). "ant": flint weights and
    signed flint activations (gelu_new's output is signed). "olive": OliVe
    int grids at qkv and flint elsewhere, with their outliers, alpha 2.5
    sigma per channel; OliVe flint activations with outliers."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    ln = lambda: {"scale": f32(1 + 0.1 * rng.normal(size=_D)),
                  "bias": f32(0.1 * rng.normal(size=_D))}
    conv = set(_SITES) if conv1d is True else set(conv1d)
    params, quant = {}, {}
    for i in range(_GEOM["n_layers"]):
        p = {"ln_1": ln(), "ln_2": ln(), "attn": {}}
        q = {"attn": {}}
        for site, (K, N) in _SITES.items():
            w = f32(rng.normal(size=(K, N)) / np.sqrt(K))
            node = {"kernel": w, "bias": f32(0.05 * rng.normal(size=N))}
            ax = 1 if site in conv else 0     # reduce over the other axis
            a_alpha = np.float32(rng.uniform(1.5, 2.5))
            if kind == "ant":
                wst = _state(0.9 * np.abs(w).max(ax),
                             cb.ant_grid("flint", 4, True))
                ast = _state(a_alpha, cb.ant_grid("flint", 4, True))
            else:
                mode = "int" if site == "qkv" else "flint"
                wst = _state(2.5 * w.std(ax), cb.olive_grid(mode, 4, True),
                             cb.olive_outlier_values(4, True))
                ast = _state(a_alpha, cb.olive_grid("flint", 4, True),
                             cb.olive_outlier_values(4, True))
            (p["attn"] if site in ("qkv", "out") else p)[site] = node
            (q["attn"] if site in ("qkv", "out") else q)[site] = {
                "weight_q": wst, "input_q": ast}
        params[f"h_{i}"], quant[f"h_{i}"] = p, q
    params["wte"] = {"embedding": f32(rng.normal(size=(128, _D)))}
    params["wpe"] = {"embedding": f32(0.3 * rng.normal(size=(64, _D)))}
    params["ln_f"] = ln()
    return params, quant


def _configs(conv1d=True, **over):
    kw = dict(weight_mode="w4", act_bits=4, kv_int8=True, lm_head_int8=True,
              max_seq=_GEOM["max_seq"], **over)
    geom = dict(_GEOM, conv1d_sites=conv1d)
    jcfg = jeng.EngineConfig(lm=JLMConfig(**geom), dtype=jnp.float32,
                             interpret=True, **kw)
    tcfg = teng.EngineConfig(lm=LMConfig(**geom), dtype=torch.float32, **kw)
    return jcfg, tcfg


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _built(kind, conv1d=True):
    """Model ``_SEED``'s params and states, the reference's engine params
    and the port's own build (shared by the tests; none changes them)."""
    params, quant = _model(kind, _SEED, conv1d)
    jcfg, tcfg = _configs(conv1d)
    return (params, quant, jeng.build_engine_params(jcfg, params, quant),
            teng.build_engine_params(tcfg, params, quant, device="cpu"))


def _counts():
    return {k: dict(c) for k, c in (
        ("K1", tk.COUNTS), ("K3", tk.K3_COUNTS), ("K4", tk.K4_COUNTS),
        ("K5", tk.K5_COUNTS), ("K2", tk2.COUNTS))}


def _calls(before, after, k):
    return after[k]["plain_calls"] - before[k]["plain_calls"]


@pytest.mark.parametrize("ovp", [False, True])
@pytest.mark.parametrize("alpha", ["per_channel", "scalar"])
def test_per_input_channel_quantizers_bit_equal(ovp, alpha):
    """``axis=0``: codes and the (K,) scale equal the reference's bit for
    bit; OVP victims paired along the output axis (``pair_axis=1``)."""
    rng = np.random.default_rng(7)
    K, N = 96, 40
    w = (rng.standard_t(3, size=(K, N)) / np.sqrt(K)).astype(np.float32)
    a = (2.5 * w.std(1) if alpha == "per_channel"
         else np.float32(2.5 * w.std())).astype(np.float32)
    if ovp:
        g = _pad(cb.olive_grid("flint", 4, True))
        o = _pad(cb.olive_outlier_values(4, True))
        want = jq.quantize_weights_ovp_i8(jnp.asarray(w), jnp.asarray(g),
                                          jnp.asarray(o), jnp.asarray(a),
                                          pair_axis=1, axis=0)
        got = tq.quantize_weights_ovp_i8(torch.from_numpy(w), g, o, a,
                                         pair_axis=1, axis=0)
        assert (got[0].abs() > 64).any()        # outliers were exercised
    else:
        g = _pad(cb.ant_grid("flint", 4, True))
        want = jq.quantize_weights_w4_i8(jnp.asarray(w), jnp.asarray(g),
                                         jnp.asarray(a), axis=0)
        got = tq.quantize_weights_w4_i8(torch.from_numpy(w), g, a, axis=0)
    assert got[0].shape == (K, N) and got[1].shape == (K,)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("kind", ["ant", "olive"])
def test_build_engine_params_matches_converted(kind):
    """The port's own build of a Conv1D tree equals the reference's tree
    converted: ``w_i8`` transposed to (L, N, K), ``kscale`` (L, K) and no
    ``oscale``, the activation leaves (``a_q`` under ANT, K4's tables
    under OliVe) as the reference keeps them."""
    _, _, jep, got = _built(kind)
    want = convert.from_jax_engine_params(_np_tree(jep), device="cpu")
    gl, wl = dict(teng._flatten(got)), dict(teng._flatten(want))
    assert set(gl) == set(wl)
    for path, w in wl.items():
        assert gl[path].dtype == w.dtype, path
        np.testing.assert_array_equal(gl[path].numpy(), w.numpy(),
                                      err_msg=str(path))
    for name, (K, N) in _SITES.items():
        s = got["layers"][name]
        assert s["w_i8"].shape == (2, N, K) and s["kscale"].shape == (2, K)
        assert "oscale" not in s
        assert ("a_q" in s) == (kind == "ant")
        assert ("ovp" in s) == (kind == "olive")


@pytest.mark.parametrize("kind", ["ant", "olive"])
@pytest.mark.parametrize("M", [2, 80])
def test_kscale_site_matches_reference(kind, M):
    """Each Conv1D site's product on the same inputs as the reference's
    ``_site_matmul_nobias``: the same fake-quant, then f32 products of the
    same values summed in another order, so within 1e-5 of each output's
    |x| @ |wv| (far inside K 2^-24 at these K)."""
    jcfg, tcfg = _configs()
    _, _, jep, tep = _built(kind)
    rng = np.random.default_rng(4)
    for name, (K, N) in _SITES.items():
        s = tep["layers"][name]
        for l in range(2):
            x = (rng.normal(size=(M, K)) * 1.5).astype(np.float32)
            site = jax.tree_util.tree_map(lambda a: a[l],
                                          jep["layers"][name])
            want = np.asarray(jeng._site_matmul_nobias(jcfg, jnp.asarray(x),
                                                       site))
            xt = torch.from_numpy(x)
            got = teng._site_matmul_nobias(tcfg, tep, name, xt, l, None)
            xf = teng._fake_quant(xt, s, l).double()
            wv = s["w_i8"][l]
            wv = tq.ovp_decode_values(wv) if "ovp" in s else wv
            wv = wv.double() * s["kscale"][l].double()[None, :]
            size = (xf.abs() @ wv.abs().t()).numpy()
            assert got.shape == (M, N) and got.dtype == torch.float32
            err = np.abs(got.numpy().astype(np.float64) - want)
            assert (err <= 1e-5 * size).all(), (name, l, err.max())


def _run_f32(kind, conv1d=True):
    """Prefill + ``_DECODE`` greedy steps of the reference's ``forward``
    and the port's on the same engine params at f32; logits within 5e-3
    at every call; returns both caches and the plain calls per kernel."""
    jcfg, tcfg = _configs(conv1d)
    _, _, jep, tep = _built(kind, conv1d)
    jfwd = jax.jit(lambda ep, ids, kv, pos: jeng.forward(jcfg, ep, ids, kv,
                                                         pos))
    ids = np.random.default_rng(1).integers(0, 128, (_B, _T))
    jkv = jeng.init_cache(jcfg, _B)
    tkv = teng.init_cache(tcfg, _B, device="cpu")
    before = _counts()
    pos = 0
    for step in range(1 + _DECODE):
        jl, jkv = jfwd(jep, jnp.asarray(ids), jkv, pos)
        tl, tkv = teng.forward(tcfg, tep, torch.from_numpy(ids), tkv, pos)
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=5e-3, atol=5e-3,
                                   err_msg=f"step {step}")
        pos += ids.shape[1]
        ids = jl[:, -1:].argmax(-1)      # both engines take the same token
    return jkv, tkv, pos, before, _counts()


@pytest.mark.parametrize("kind", ["ant", "olive"])
def test_gpt2_engine_matches_reference(kind):
    jkv, tkv, pos, before, after = _run_f32(kind)
    # decode: one Conv1D site sends every site to the unfused route; K2
    # (plain on the CPU) serves every layer of every call
    for k in ("K1", "K3", "K4", "K5"):
        assert _calls(before, after, k) == 0, k
    assert _calls(before, after, "K2") == 2 * (1 + _DECODE)
    # the reference folds two positions into a row at head_dim 64
    assert np.asarray(jkv.k).shape[-1] == 128
    want = convert.from_jax_kv(_np_tree(jkv), 64, device="cpu")
    for name in ("k", "v"):
        g = getattr(tkv, name)[:, :, :, :pos]
        w = getattr(want, name)[:, :, :, :pos]
        assert (g == w).float().mean().item() >= 0.999, name
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(getattr(tkv, name)[..., :pos].numpy(),
                                   getattr(want, name)[..., :pos].numpy(),
                                   rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("kind", ["ant", "olive"])
def test_gpt2_engine_bf16_matches_reference(kind):
    """At bf16, the bf16 engine rule (``test_torch_engine_bf16.py``): the
    Conv1D products stay f32 in both, whatever ``cfg.dtype`` is."""
    jcfg, tcfg = bf._bf16(*_configs())
    ids = np.random.default_rng(1).integers(0, 128, (_B, _T))
    bf._run_engines(jcfg, tcfg, *_model(kind, _SEED), ids, steps=1)


def test_mixed_sites_decode_unfused():
    """Conv1D qkv and out, Linear fc_in and fc_out: the whole decode step
    takes the unfused route (no K1), as the reference's all-or-nothing
    rule; logits within 5e-3 of the reference at f32."""
    _, _, _, before, after = _run_f32("ant", _MIXED)
    for k in ("K1", "K3", "K4", "K5"):
        assert _calls(before, after, k) == 0, k


def test_mixed_sites_stacked_prefill():
    """With ``stacked_prefill``, a prefill (M = 80) sends the Linear sites
    to the stacked kernel (K1's plain version on the CPU) and leaves the
    Conv1D sites on their route: logits bit-equal to the unstacked
    prefill, and within 5e-3 of the reference's stacked prefill."""
    jcfg, tcfg = _configs(_MIXED, stacked_prefill=True)
    _, _, jep, tep = _built("ant", _MIXED)
    stk = teng._prepare_stacked(tcfg, tep, _B * _T)
    assert set(stk) == {"fc_in", "fc_out"}
    assert teng._prepare_stacked(tcfg, tep, _B) is None
    ids = np.random.default_rng(1).integers(0, 128, (_B, _T))
    out = {}
    for sp in (True, False):
        cfg = dataclasses.replace(tcfg, stacked_prefill=sp)
        kv = teng.init_cache(cfg, _B, device="cpu")
        before = _counts()
        out[sp], _ = teng.forward(cfg, tep, torch.from_numpy(ids), kv, 0)
        calls = _calls(before, _counts(), "K1")
        assert calls == (2 * 2 if sp else 0), (sp, calls)
    assert torch.equal(out[True], out[False])
    jl, _ = jeng.forward(jcfg, jep, jnp.asarray(ids),
                         jeng.init_cache(jcfg, _B), 0)
    np.testing.assert_allclose(out[True].numpy(), np.asarray(jl),
                               rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("V", [1, 9, 129])
def test_int8_head_at_a_vocab_off_multiples_of_8(monkeypatch, V):
    """F4 (ROADMAP Queue 3): ``int8_matmul`` gave ``torch._int_mm`` the
    whole head, whose N must be a multiple of 8 on CUDA, so the int8 head
    raised at GPT-2's vocabulary of 50,257. Here ``_int_mm`` is held to
    the CUDA rule (K and N multiples of 8), and the int8 head at V rows
    must equal the reference's ``_lm_logits`` bit for bit."""
    real = torch._int_mm

    def cuda_rule(a, b):
        if a.shape[1] % 8 or b.shape[1] % 8:
            raise RuntimeError(f"_int_mm on CUDA refuses {tuple(b.shape)}")
        return real(a, b)

    monkeypatch.setattr(torch, "_int_mm", cuda_rule)
    rng = np.random.default_rng(V)
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    w = rng.normal(size=(V, 64)).astype(np.float32)
    jtop = jeng.quantize_lm_head(jnp.asarray(w))
    ttop = teng.quantize_lm_head(torch.from_numpy(w))
    got = teng._lm_logits(ttop, torch.from_numpy(x))
    assert got.shape == (2, 3, V)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jeng._lm_logits(jtop, jnp.asarray(x))))
