"""PyTorch port vs the JAX reference: the calibrate-then-serve path
(ROADMAP Queue 1 items 9-10 and their harness: ``nn/config.py``,
``nn/layers.py``, the ``TransformerLM`` modules, ``utils/calibration.py``,
``harness/evaluate.py``), on 2-layer OPT-, GPT-2- (every site Conv1D) and
BLOOM-shaped (ALiBi, fused qkv, embedding LayerNorm) models of d_model
128 with 2 heads of 64:

- the float model within 1e-5 of the reference's logits, and the
  fake-quant model within 5e-3 on the same states (``convert.
  from_jax_lm_params`` and ``from_jax_quant``);
- the port's calibration of its own model (ANT; OliVe's calibration is
  held at the function level in ``test_torch_calibrate.py``) against
  the reference's of its: every weight state bit-equal (its MSE within
  1e-6), every input state of the same type, bit and signedness with
  alpha within 1e-5 (the activations themselves differ by the
  frameworks' f32 sum orders);
- ``QuantDense``'s protocol (frozen after the first batch, sticky type
  and promoted bit, promotion by ``n8`` and ``layer_list``,
  ``recalibrate_each``) and ``lm_perplexity`` as the reference's;
- ``build_engine_params`` from the port's tree of tensors equal in every
  leaf to the reference's build of the same states (converted), and to
  the port's build from the tree's numpy export; the engine then serves
  within 5e-3 of the reference's ``forward`` (the JAX chain);
- F5 (ROADMAP Queue 3): the same at d_ff 196 (fc_out's K = 196, no
  multiple of 8, 16 or 64), under ANT (K1 at decode) and full OliVe (K4).
"""

import functools

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from ant_quantization_tpu.calibrate import promote as jpr
from ant_quantization_tpu.calibrate import spec as jsp
from ant_quantization_tpu.harness import evaluate as jev
from ant_quantization_tpu.models import transformer_lm as jlm
from ant_quantization_tpu.nn.config import QuantConfig as JQ
from ant_quantization_tpu.serve import engine as jeng
from ant_quantization_tpu_torch import convert
from ant_quantization_tpu_torch.calibrate import promote as tpr
from ant_quantization_tpu_torch.calibrate import spec as tsp
from ant_quantization_tpu_torch.harness import evaluate as tev
from ant_quantization_tpu_torch.kernels import stacked as tk
from ant_quantization_tpu_torch.models import transformer_lm as tlm
from ant_quantization_tpu_torch.nn import layers as tl
from ant_quantization_tpu_torch.nn.config import QuantConfig as TQ
from ant_quantization_tpu_torch.serve import engine as teng
from ant_quantization_tpu_torch.utils.calibration import calibrate_model

pytestmark = pytest.mark.torchdep


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tensors are tiny, and the suite's
    workers share the host's cores (many threads each spin on them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# d_ff = d_model keeps the reference's calibration programs (one per
# tensor shape and site config) few; opt_ff196 has its own widths
_BASE = dict(vocab_size=128, d_model=128, n_layers=2, n_heads=2, d_ff=128,
             max_seq=64)
GEOMS = {
    "opt": dict(_BASE, positions="learned_offset2", activation="relu",
                fused_qkv=False),
    "gpt2": dict(_BASE, positions="learned", activation="gelu_new",
                 fused_qkv=True, conv1d_sites=True),
    "bloom": dict(_BASE, positions="alibi", activation="gelu",
                  fused_qkv=True, embed_ln=True),
    "opt_ff196": dict(_BASE, d_ff=196, positions="learned_offset2",
                      activation="relu", fused_qkv=False),
}
ANT = dict(mode="ant-int-pot-flint")
OLIVE = dict(mode="ant-int-flint", family="olive", w_up=250, a_up=250)
_B, _T, _DECODE = 2, 40, 2          # prefill M = 80 > 64; decode M = 2


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, 128, shape)


def _np(tree):
    """Leaves of a nested dict -> numpy (tensors and QuantStates)."""
    if isinstance(tree, tsp.QuantState):
        return tree.numpy()
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _to_jax(tree):
    """The port's quant tree -> the reference's (its QuantState)."""
    if isinstance(tree, tsp.QuantState):
        return jsp.QuantState(**{k: jnp.asarray(v)
                                 for k, v in tree.numpy().items()})
    return {k: _to_jax(v) for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _params(geom, seed):
    fp = jlm.TransformerLM(jlm.LMConfig(**GEOMS[geom]), JQ(enabled=False))
    return jax.tree_util.tree_map(np.asarray, fp.init(
        jax.random.PRNGKey(seed), jnp.asarray(_ids(0, (1, 4))))["params"])


def _models(geom, qkw, seed=0):
    """The reference's and the port's model on the same random params."""
    jm = jlm.TransformerLM(jlm.LMConfig(**GEOMS[geom]), JQ(**qkw))
    # the params of the unquantized model: flax's init of a quantized one
    # runs it with every collection mutable, so it would calibrate
    params = _params(geom, seed)
    v = {"params": params}
    tm = tlm.TransformerLM(tlm.LMConfig(**GEOMS[geom]), TQ(**qkw),
                           device="cpu")
    tm.load_state_dict(convert.from_jax_lm_params(params, device="cpu"))
    return jm, v, params, tm


def _assert_trees_by_rule(jtree, ttree):
    """ANT weight states bit-equal; input states: type, bit, signedness
    equal, alpha within 1e-5."""
    js, ts = jpr.quant_sites(jtree), tpr.quant_sites(ttree)
    assert [p for p, _ in js] == [p for p, _ in ts]
    for (path, j), (_, t) in zip(js, ts):
        for k in ("weight_q", "input_q"):
            a, b = j[k], t[k]
            for f in ("grid", "outliers", "bit", "mode_idx", "is_signed",
                      "initialized"):
                np.testing.assert_array_equal(
                    getattr(b, f).numpy(), np.asarray(getattr(a, f)),
                    err_msg=f"{path} {k} {f}")
            np.testing.assert_allclose(
                b.alpha.numpy(), np.asarray(a.alpha),
                rtol=1e-5 if k == "input_q" else 0,
                err_msg=f"{path} {k} alpha")


def _calibrate_both(geom, qkw, seed=0, **kw):
    jm, v, params, tm = _models(geom, qkw, seed)
    batches = [_ids(10 + i, (_B, 16)) for i in range(kw.pop("n", 1))]
    jq = jev.calibrate_on_batches(jm, v, [(jnp.asarray(b),)
                                         for b in batches], **kw)
    tq = tev.calibrate_on_batches(tm, [(torch.from_numpy(b),)
                                       for b in batches], **kw)
    return jm, params, tm, jq, tq


@functools.lru_cache(maxsize=None)
def _port_calibrated(geom, family):
    """The port's model calibrated on the first batch, shared by the tests
    of this file (none of them changes it)."""
    jm, v, params, tm = _models(geom, ANT if family == "ant" else OLIVE)
    tq = tev.calibrate_on_batches(tm, [(torch.from_numpy(_ids(10,
                                                              (_B, 16))),)])
    return jm, params, tm, tq


@pytest.mark.parametrize("geom", ["opt", "gpt2", "bloom"])
def test_lm_float_and_fake_quant_logits(geom):
    """Float logits within 1e-5 of the reference's; fake-quant logits on
    the same calibrated states within 5e-3 (the port's, carried over to
    the reference and back); decode on the f32 cache equal to the
    prefill's last position."""
    jm, params, _, tq = _port_calibrated(geom, "ant")
    jq = _to_jax(tq)
    ids = _ids(1, (_B, 12))
    jfp = jlm.TransformerLM(jlm.LMConfig(**GEOMS[geom]), JQ(enabled=False))
    tfp = tlm.TransformerLM(tlm.LMConfig(**GEOMS[geom]), TQ(enabled=False),
                            device="cpu")
    state = convert.from_jax_lm_params(params, device="cpu")
    tfp.load_state_dict(state)
    assert tl.quant_tree(tfp) == {}
    want = np.asarray(jfp.apply({"params": params}, jnp.asarray(ids)))
    got = tfp(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    tm = tlm.TransformerLM(tlm.LMConfig(**GEOMS[geom]), TQ(**ANT),
                           device="cpu")
    tm.load_state_dict(state)
    tl.load_quant_tree(tm, convert.from_jax_quant(
        jax.tree_util.tree_map(np.asarray, jq), device="cpu"))
    want = np.asarray(jm.apply({"params": params, "quant": jq},
                               jnp.asarray(ids)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
        assert torch.equal(got, _port_calibrated(geom, "ant")[2](
            torch.from_numpy(ids)))
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-3, atol=5e-3)
    caches = tlm.init_kv_caches(tm.cfg, _B, 16, device="cpu")
    with torch.no_grad():
        for t in range(ids.shape[1]):
            step, caches = tm(torch.from_numpy(ids[:, t:t + 1]), caches, t)
    np.testing.assert_allclose(step[:, 0].numpy(), got[:, -1].numpy(),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("geom,family", [("opt", "ant"), ("gpt2", "ant")])
def test_port_calibration_gives_the_reference_tree(geom, family):
    jm, params, _, tq = _port_calibrated(geom, family)
    jq = jev.calibrate_on_batches(
        jm, {"params": params}, [(jnp.asarray(_ids(10, (_B, 16))),)])
    _assert_trees_by_rule(jq, tq)


def _same_tree(a, b) -> bool:
    return all(torch.equal(x, y) for (_, sa), (_, sb) in zip(
        tpr.quant_sites(a), tpr.quant_sites(b))
        for k in sa for x, y in ((sa[k].alpha, sb[k].alpha),
                                 (sa[k].mode_idx, sb[k].mode_idx)))


def test_first_batch_freezes_and_recalibrate_each():
    """Two batches: the states are those of the first alone (frozen); with
    ``recalibrate_each`` the ladder runs again on the second batch, with
    the types of the first (sticky), as the reference's by the rule."""
    b1, b2 = (torch.from_numpy(_ids(10 + i, (_B, 16))) for i in range(2))
    trees = {"first": _port_calibrated("opt", "ant")[3]}   # on b1 alone
    for name, batches, kw in (("second", [b2], {}),
                              ("frozen", [b1, b2], {}),
                              ("each", [b1, b2],
                               dict(recalibrate_each=True))):
        tm = _models("opt", ANT)[3]
        trees[name] = tev.calibrate_on_batches(tm, [(b,) for b in batches],
                                               **kw)
    assert _same_tree(trees["frozen"], trees["first"])
    assert not _same_tree(trees["each"], trees["first"])
    kinds = lambda t: [int(st[k].mode_idx) for _, st in tpr.quant_sites(t)
                       for k in st]
    assert kinds(trees["each"]) == kinds(trees["first"])
    assert kinds(trees["second"]) != kinds(trees["first"])
    jm, v, _, _ = _models("opt", ANT)
    jq = jev.calibrate_on_batches(
        jm, v, [(jnp.asarray(b.numpy()),) for b in (b1, b2)],
        recalibrate_each=True)
    _assert_trees_by_rule(jq, trees["each"])


@pytest.mark.parametrize("promote", [dict(n8=3), dict(layer_list="0,5")])
def test_promotion_then_recalibration(promote):
    """Promotion resets every state and recalibrates on the first batch:
    promoted sites come back 8-bit int, the others keep their type."""
    _, _, _, jq, tq = _calibrate_both("opt", ANT, **promote)
    _assert_trees_by_rule(jq, tq)
    promoted = tpr.promoted_site_paths(tq)
    assert promoted == jpr.promoted_site_paths(jq)
    assert len(promoted) == (3 if "n8" in promote else 2)
    for path, st in tpr.quant_sites(tq):
        if path in promoted:
            assert int(st["weight_q"].mode_idx) == 0
            assert int(st["input_q"].bit) == 8


class _TMLP(nn.Module):
    def __init__(self, qcfg):
        super().__init__()
        for name, (i, o) in (("fc1", (64, 32)), ("fc2", (32, 32)),
                             ("fc3", (32, 32)), ("head", (32, 10))):
            self.add_module(name, tl.QuantDense(i, o, qcfg, device="cpu"))

    def forward(self, x):
        for name in ("fc1", "fc2", "fc3"):
            x = torch.relu(getattr(self, name)(x))
        return self.head(x)


def test_quant_dense_protocol():
    """The reference's MLP (``tests/test_layers.py``): a frozen forward
    equal to the calibrating one, the states unchanged by a later
    calibrating pass, promotion's 8-bit int sites and the others' kept
    types, and a disabled config that holds no state (the calibration
    itself is held against the reference's at the model level)."""
    x = torch.randn((16, 64), generator=torch.Generator().manual_seed(0))
    tm = _TMLP(TQ())
    y, tq = calibrate_model(tm, x)
    with torch.no_grad():
        assert torch.equal(tm(x), y)
    _, again = calibrate_model(tm, x.flip(0) * 3)
    assert _same_tree(tq, again)
    _, tq8 = calibrate_model(tm, x, quant=tpr.set_8_bit_layer_n(tq, 3))
    promoted = tpr.promoted_site_paths(tq8)
    assert len(promoted) == 3 and promoted[-2:] == [("fc3",), ("head",)]
    for (path, a), (_, b) in zip(tpr.quant_sites(tq), tpr.quant_sites(tq8)):
        for k in a:
            assert bool(b[k].initialized)
            if path in promoted:
                assert int(b[k].bit) == 8 and int(b[k].mode_idx) == 0
            else:
                assert int(b[k].bit) == 4
                assert int(b[k].mode_idx) == int(a[k].mode_idx)
    off = _TMLP(TQ(enabled=False))
    off.load_state_dict(tm.state_dict())
    y, tree = calibrate_model(off, x)
    assert tree == {}
    want = x
    for name in ("fc1", "fc2", "fc3", "head"):
        m = getattr(tm, name)
        want = want @ m.kernel + m.bias
        want = want if name == "head" else torch.relu(want)
    torch.testing.assert_close(y, want.detach(), rtol=1e-6, atol=1e-6)


def test_lm_perplexity_matches_reference():
    jm, params, _, tq = _port_calibrated("opt", "ant")
    jq = _to_jax(tq)
    tm = tlm.TransformerLM(tlm.LMConfig(**GEOMS["opt"]), TQ(**ANT),
                           device="cpu")
    tm.load_state_dict(convert.from_jax_lm_params(params, device="cpu"))
    tl.load_quant_tree(tm, convert.from_jax_quant(
        jax.tree_util.tree_map(np.asarray, jq), device="cpu"))
    blocks = _ids(4, (5, 16))
    want = jev.lm_perplexity(jm, {"params": params, "quant": jq}, blocks, 2)
    got = tev.lm_perplexity(tm, blocks, 2)
    assert got["eval_loss"] == pytest.approx(want["eval_loss"], rel=1e-5)
    assert got["perplexity"] == pytest.approx(want["perplexity"], rel=1e-5)


def _engine_configs(geom, **over):
    kw = dict(weight_mode="w4", act_bits=4, kv_int8=True, lm_head_int8=True,
              max_seq=_BASE["max_seq"], **over)
    return (jeng.EngineConfig(lm=jlm.LMConfig(**GEOMS[geom]),
                              dtype=jnp.float32, interpret=True, **kw),
            teng.EngineConfig(lm=tlm.LMConfig(**GEOMS[geom]),
                              dtype=torch.float32, **kw))


@pytest.mark.parametrize("geom,family", [
    ("gpt2", "ant"), ("bloom", "ant"), ("opt_ff196", "ant"),
    ("opt_ff196", "olive")])
def test_engine_from_the_ports_calibration(geom, family):
    """Calibrate the port's model, build the engine from its tree of
    tensors: every leaf equal to the reference's build of the same states
    and to the port's build from the numpy export; then prefill and
    decode within 5e-3 of the reference's forward. At d_ff 196 decode runs
    fc_out at K = 196 (K1 under ANT, K4 under OliVe)."""
    _, params, tm, tq = _port_calibrated(geom, family)
    jcfg, tcfg = _engine_configs(geom)
    tep = teng.build_engine_params(tcfg, tlm.params_tree(tm), tq,
                                   device="cpu")
    jep = jeng.build_engine_params(jcfg, params, _to_jax(tq))
    want = convert.from_jax_engine_params(
        jax.tree_util.tree_map(np.asarray, jep), device="cpu")
    gl, wl = dict(teng._flatten(tep)), dict(teng._flatten(want))
    assert set(gl) == set(wl)
    for path, w in wl.items():
        assert gl[path].dtype == w.dtype, path
        np.testing.assert_array_equal(gl[path].numpy(), w.numpy(),
                                      err_msg=str(path))
    if geom == "opt_ff196" and family == "ant":
        from_np = teng.build_engine_params(tcfg, _np(tlm.params_tree(tm)),
                                           _np(tq), device="cpu")
        for path, t in teng._flatten(from_np):
            assert torch.equal(t, gl[path]), path
    if family == "olive":
        assert "aovp_enc" in tep["layers"]["fc_out"]
    jfwd = jax.jit(lambda ep, ids, kv, pos: jeng.forward(jcfg, ep, ids, kv,
                                                         pos))
    ids = _ids(1, (_B, _T))
    jkv = jeng.init_cache(jcfg, _B)
    tkv = teng.init_cache(tcfg, _B, device="cpu")
    counts = {k: dict(c) for k, c in (("K1", tk.COUNTS),
                                      ("K4", tk.K4_COUNTS))}
    pos = 0
    for step in range(1 + _DECODE):
        jlog, jkv = jfwd(jep, jnp.asarray(ids), jkv, pos)
        tlog, tkv = teng.forward(tcfg, tep, torch.from_numpy(ids), tkv, pos)
        jlog = np.asarray(jlog)
        np.testing.assert_allclose(tlog.numpy(), jlog, rtol=5e-3,
                                   atol=5e-3, err_msg=f"step {step}")
        pos += ids.shape[1]
        ids = jlog[:, -1:].argmax(-1)
    if geom != "gpt2":      # a Conv1D site sends decode to the unfused route
        k = "K1" if family == "ant" else "K4"
        c = tk.COUNTS if k == "K1" else tk.K4_COUNTS
        assert c["plain_calls"] - counts[k]["plain_calls"] == \
            (4 if geom == "bloom" else 6) * 2 * _DECODE
