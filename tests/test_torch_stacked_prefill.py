"""PyTorch port vs the JAX reference: ``stacked_prefill`` and K5.

- The port's M > 256 route of ``stacked_quant_matmul`` (K5; its plain
  version is K1's or K3's) against the reference's M-blocked
  ``_prefill_i8`` in interpret mode, int8 values and OVP bytes, bit for
  bit, including OVP sums past 2^24 where the f32 order is the result;
  and M = 80, which both route to the decode kernel (K1/K3).
- A 2-layer OPT-shaped engine (split q/k/v, INT8 KV, int8 head) with
  ``stacked_prefill=True``: prefill logits bit-equal to the port's own
  ``stacked_prefill=False`` run on int8-value weights (same snap, exact
  int32, same scale product), and within 5e-3 of the reference's
  ``stacked_prefill=True`` engine, at M = 80 (K1) and M = 300 (K5), with
  every site stacked or with fc_out lacking ``a_q`` (the per-site
  fallback to the torch route), and on OVP weights (K3 and K5-ovp).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ant_quantization_tpu.calibrate.spec import QuantState, pad_grid
from ant_quantization_tpu.kernels.stacked import stacked_quant_matmul as jk
from ant_quantization_tpu.models.transformer_lm import LMConfig as JLMConfig
from ant_quantization_tpu.serve import engine as jeng
from ant_quantization_tpu_torch import convert
from ant_quantization_tpu_torch.kernels import stacked as tk
from ant_quantization_tpu_torch.models.transformer_lm import LMConfig
from ant_quantization_tpu_torch.numerics import codebooks as cb
from ant_quantization_tpu_torch.serve import engine as teng

pytestmark = pytest.mark.torchdep

_OVP_BYTES = np.array([-127, -100, -70, -65, -64, -33, -8, -2, 0, 2, 8, 33,
                       64, 65, 70, 100, 127], np.int8)


def _counts():
    return {k: dict(c) for k, c in (("K1", tk.COUNTS), ("K3", tk.K3_COUNTS),
                                    ("K5", tk.K5_COUNTS))}


@pytest.mark.parametrize("M,K,ovp,adversarial,block_k", [
    (300, 256, False, False, 1024), (300, 1024, True, False, 512),
    (300, 2048, True, True, 1024), (80, 256, False, False, 1024),
    (80, 1024, True, False, 512)])
def test_prefill_route_bit_equal_to_pallas(M, K, ovp, adversarial, block_k):
    rng = np.random.default_rng(M + K)
    L, N, l = 2, 128, 1
    a_vals = np.round(np.linspace(-96, 127, 16)).astype(np.float32)
    a_q = np.stack([a_vals, a_vals[::-1].copy() * -1])
    a_q = np.sort(a_q, axis=1)
    a_scale = np.float32([0.5, 0.25])     # powers of two keep ties exact
    if adversarial:
        # all-outlier columns against activations at the codebook's top:
        # every 256-row sub-chunk sum passes 2^24
        w = rng.choice(np.array([100, 110, 120, 127], np.int8),
                       size=(L, K, N))
        x = np.full((M, K), 127 * 0.25, np.float32)
        x[:, ::7] *= -0.5
    else:
        w = (rng.choice(_OVP_BYTES, size=(L, K, N)) if ovp
             else rng.integers(-100, 100, (L, K, N)).astype(np.int8))
        x = (rng.normal(size=(M, K)) * 10).astype(np.float32)
        mids = (a_q[l, 1:] + a_q[l, :-1]) * np.float32(0.5)
        x[0, :15] = mids * a_scale[l]                 # exact midpoint ties
    scales = rng.uniform(1e-3, 3e-3, (L, N)).astype(np.float32)
    want = np.asarray(jk(
        jnp.int32(l), jnp.asarray(x), jnp.asarray(w.reshape(L * K, N)),
        jnp.asarray(scales), jnp.asarray(a_q), jnp.asarray(a_scale[:, None]),
        None, mode="i8", n_layers=L, block_k=block_k, ovp=ovp,
        interpret=True))
    before = _counts()
    got = tk.stacked_quant_matmul(
        l, torch.from_numpy(x),
        torch.from_numpy(np.ascontiguousarray(w.transpose(0, 2, 1))),
        torch.from_numpy(scales), torch.from_numpy(a_q),
        torch.from_numpy(a_scale), ovp=ovp, block_k=block_k).numpy()
    np.testing.assert_array_equal(got, want)
    after = _counts()
    route = "K5" if M > tk.PREFILL_M else ("K3" if ovp else "K1")
    for k in after:
        calls = after[k]["plain_calls"] - before[k]["plain_calls"]
        assert calls == (k == route), (k, calls)
        assert after[k]["launches"] == before[k]["launches"]
    if adversarial:
        xq = tk.snap_value(torch.from_numpy(x) / a_scale[l],
                           torch.from_numpy(a_q[l])).numpy().astype(np.int64)
        vals = 16 * w[l].astype(np.int64) - 15 * np.clip(w[l], -64, 64)
        assert np.abs(xq[:, :256] @ vals[:256]).max() > 2 ** 24


_SITES = {"q": (256, 256), "k": (256, 256), "v": (256, 256),
          "out": (256, 256), "fc_in": (256, 512), "fc_out": (512, 256)}


def _geom(max_seq):
    return dict(vocab_size=128, d_model=256, n_layers=2, n_heads=2,
                d_ff=512, max_seq=max_seq, positions="learned_offset2",
                activation="relu", fused_qkv=False)


def _state(alpha, grid, outliers=None):
    pad = lambda a: np.pad(np.asarray(a, np.float32), (0, 256 - len(a)),
                           mode="edge")
    return QuantState(
        alpha=jnp.asarray(alpha, jnp.float32),
        grid=jnp.asarray(pad_grid(grid) if outliers is None else pad(grid)),
        outliers=jnp.asarray(np.zeros(256, np.float32) if outliers is None
                             else pad(outliers)),
        bit=jnp.asarray(4, jnp.int32), mode_idx=jnp.asarray(0, jnp.int32),
        is_signed=jnp.asarray(True), mse=jnp.asarray(0.0, jnp.float32),
        initialized=jnp.asarray(True), aux=jnp.asarray(0.0, jnp.float32))


def _model(ovp_weights, max_seq, seed):
    """Random float weights: signed ANT flint (or, ``ovp_weights``, OliVe
    int/flint grids with their outliers) at alpha = 2.5 sigma per
    channel; unsigned ANT flint A4 inputs (int8-exact)."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    ln = lambda: {"scale": f32(1 + 0.1 * rng.normal(size=256)),
                  "bias": f32(0.1 * rng.normal(size=256))}
    params, quant = {}, {}
    for i in range(2):
        p = {"ln_1": ln(), "ln_2": ln(), "attn": {}}
        q = {"attn": {}}
        for site, (K, N) in _SITES.items():
            w = f32(rng.normal(size=(K, N)) / np.sqrt(K))
            node = {"kernel": w, "bias": f32(0.05 * rng.normal(size=N))}
            if ovp_weights:
                mode = "int" if site in ("q", "k", "v") else "flint"
                wst = _state(2.5 * w.std(0), cb.olive_grid(mode, 4, True),
                             cb.olive_outlier_values(4, True))
            else:
                wst = _state(2.5 * w.std(0), cb.ant_grid("flint", 4, True))
            ast = _state(np.float32(rng.uniform(1.5, 3.0)),
                         cb.ant_grid("flint", 4, False))
            (p["attn"] if site in ("q", "k", "v", "out") else p)[site] = node
            (q["attn"] if site in ("q", "k", "v", "out") else q)[site] = {
                "weight_q": wst, "input_q": ast}
        params[f"h_{i}"], quant[f"h_{i}"] = p, q
    params["wte"] = {"embedding": f32(rng.normal(size=(128, 256)))}
    params["wpe"] = {"embedding": f32(0.3 * rng.normal(size=(max_seq + 2,
                                                             256)))}
    params["ln_f"] = ln()
    return params, quant


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("kind", ["ant", "mixed", "ovp_weights"])
@pytest.mark.parametrize("B,T", [(2, 40), (3, 100)])
def test_stacked_prefill_engine(kind, B, T):
    M, max_seq = B * T, 128
    kw = dict(weight_mode="w4", act_bits=4, kv_int8=True, lm_head_int8=True,
              max_seq=max_seq)
    params, quant = _model(kind == "ovp_weights", max_seq, seed=0)
    ids = np.random.default_rng(1).integers(0, 128, (B, T))
    jcfg = jeng.EngineConfig(lm=JLMConfig(**_geom(max_seq)),
                             dtype=jnp.float32, interpret=True,
                             stacked_prefill=True, **kw)
    jep = jeng.build_engine_params(jcfg, params, quant)
    tep = convert.from_jax_engine_params(_np_tree(jep), device="cpu")
    if kind == "mixed":
        # fc_out as if its grid were not int8-exact: the per-site fallback
        for tree in (jep["layers"]["fc_out"], tep["layers"]["fc_out"]):
            del tree["a_q"], tree["a_scale"]
    logits = {}
    for pref in (False, True):
        tcfg = teng.EngineConfig(lm=LMConfig(**_geom(max_seq)),
                                 dtype=torch.float32, stacked_prefill=pref,
                                 **kw)
        stk = teng._prepare_stacked(tcfg, tep, M)
        assert (stk is not None) == pref
        if pref:
            assert ("fc_out" in stk) == (kind != "mixed") and "q" in stk
        before = _counts()
        logits[pref], _ = teng.forward(tcfg, tep, torch.from_numpy(ids),
                                       teng.init_cache(tcfg, B, device="cpu"),
                                       0)
        after = _counts()
        calls = {k: after[k]["plain_calls"] - before[k]["plain_calls"]
                 for k in after}
        route = "K5" if M > tk.PREFILL_M else (
            "K3" if kind == "ovp_weights" else "K1")
        n_sites = 2 * (5 if kind == "mixed" else 6)
        assert calls == {k: (n_sites if pref and k == route else 0)
                         for k in calls}, calls
    if kind != "ovp_weights":
        assert torch.equal(logits[True], logits[False])
    want, _ = jeng.forward(jcfg, jep, jnp.asarray(ids),
                           jeng.init_cache(jcfg, B), 0)
    np.testing.assert_allclose(logits[True].numpy(), np.asarray(want),
                               rtol=5e-3, atol=5e-3)


def test_prefill_snap_cpu_is_the_plain_snap():
    """``prefill_snap`` (K5's snap pre-kernel alone, for timing) takes the
    plain version's snap on a CPU tensor: the codes whose product with
    W[l] is the plain version's int32 sum, and no K5 launch is counted."""
    rng = np.random.default_rng(3)
    L, M, K, N, l = 2, 300, 256, 64, 1
    a_q = torch.from_numpy(np.sort(rng.integers(-127, 128, (L, 16)),
                                   axis=1).astype(np.float32))
    a_scale = torch.tensor([0.5, 0.25])
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32) * 20)
    w = torch.from_numpy(rng.integers(-127, 128, (L, N, K)).astype(np.int8))
    scales = torch.ones((L, N))
    before = _counts()
    xq = tk.prefill_snap(l, x, a_q, a_scale)
    assert _counts() == before
    assert xq.dtype == torch.int8 and xq.shape == (M, K)
    assert set(xq.unique().tolist()) <= set(a_q[l].tolist())
    want = tk.stacked_quant_matmul_plain(l, x, w, scales, a_q, a_scale)
    got = tk.int8_matmul(xq, w[l]).to(torch.float32)
    assert torch.equal(got, want)
