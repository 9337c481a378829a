"""PyTorch port vs the JAX reference: the trainer (``harness/train.py``)
and ``harness/resilient.py``.

- the schedules: the lr at every step of ``warmup_linear`` and
  ``multi_step_lr`` equals optax's f32 value (the first BertAdam step
  has lr 0; a milestone switches at ``count >= m``);
- ``bert_adam`` and ``sgd_multistep`` over 5 updates of a random tree
  (every leaf decays): the parameters within OPT_RTOL of optax's after
  each update (the same f32 operations in the same order; XLA may fuse
  a product into the next sum);
- ``make_classification_step`` on a tiny quantized ResNet (layers (1, 1,
  1, 1), 10 classes, 4 x 32 x 32 images), ``grad_accum`` 1 and 2, two
  steps of ``sgd_multistep`` with a milestone after the first (the
  second from the reference's state), the port's calibration carried
  into the reference: the loss within
  LOSS_RTOL, every parameter after the stem's max pool within STEP_ATOL
  of its scale after each step (the stem's updates within a cosine of
  STEM_COS: see STEM), the running statistics within STATS_RTOL;
- ``make_lm_step`` on a 2-layer OPT-shaped LM under ANT, two BertAdam
  steps: the same tolerances;
- ``prime_and_promote`` (``n8`` and ``layers8``) on a small conv net: the
  quant tree by the rule of ``tests/test_torch_bert.py`` (the seeds first
  checked clear of near-ties at the first site);
- ``evaluate_classification`` with a journal: a run cut after three
  batches, then resumed, folds each batch once and gives the reference's
  top-1/top-5 on the same model and data; ``ResumableAccumulator`` and
  ``retry_transient`` as the reference's.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax

from ant_quantization_tpu.harness import resilient as jres
from ant_quantization_tpu.harness import train as JT
from ant_quantization_tpu.models import resnet as jrn
from ant_quantization_tpu.models import transformer_lm as jlm
from ant_quantization_tpu.nn import layers as jl
from ant_quantization_tpu.nn.config import QuantConfig as JQ
from ant_quantization_tpu_torch import convert
from ant_quantization_tpu_torch.calibrate import promote as tpr
from ant_quantization_tpu_torch.harness import resilient as tres
from ant_quantization_tpu_torch.harness import train as TT
from ant_quantization_tpu_torch.models import resnet as trn
from ant_quantization_tpu_torch.models import transformer_lm as tlm
from ant_quantization_tpu_torch.nn import layers as tl
from ant_quantization_tpu_torch.nn.config import QuantConfig as TQ
from ant_quantization_tpu_torch.utils.calibration import calibrate_model

import test_torch_calibrate as tcal
from test_torch_bert import assert_trees_by_rule, to_jax
from test_torch_image_models import jax_variables, nchw, nhwc

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.torchdep

OPT_RTOL = 1e-6
LOSS_RTOL = 1e-5
STATS_RTOL = 1e-5
# A quantized network's gradient holds elements that exact arithmetic
# ties: a convolution of grid values on a grid takes few distinct values,
# so a max-pool window often holds equal maxima, and BatchNorm over a
# microbatch of two maps every channel to +-1; which element takes the
# gradient, or which code a value snaps to, then depends on the rounding
# of sums equal in exact arithmetic (the port's own f32 and f64 runs
# route some 0.2% of the stem BatchNorm's output gradients apart). Each
# parameter's update is therefore held by its direction (cosine) and its
# norm; the stem (conv1, bn1), before the max pool, by a wider cosine.
# Seen: cosines down to 0.9985 and norms 0.7% apart after the pool (the
# QAT tool's one step on the generated weights of
# tests/test_torch_image_tools.py), the stem's down to 0.9986.
UPDATE_COS = 0.998
STEM = ("conv1", "bn1")
STEM_COS = 0.995
UPDATE_NORM_RTOL = 1e-2
# the LM (no pool, no BatchNorm): each parameter within this share of the
# largest value of its tensor after a step
STEP_ATOL = 1e-5
FAST = dict(mode="ant-int-pot-flint", w_low=100, w_up=101, a_low=100,
            a_up=101)


# ---------------------------------------------------------------------------
# Schedules and optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("total,warmup", [(7, 0.1), (100, 0.01),
                                          (250, 0.3)])
def test_warmup_linear_lr_at_every_step(total, warmup):
    want = JT.warmup_linear(2e-5, warmup, total)
    got = TT.warmup_linear(2e-5, warmup, total)
    assert got(0) == 0.0
    for count in range(total + 3):
        assert np.float32(got(count)) == np.float32(want(count)), count


@pytest.mark.parametrize("milestones", [(4, 7, 9), (2,), (3, 3, 5)])
def test_multi_step_lr_at_every_step(milestones):
    steps = 13
    m = [k * steps for k in milestones]
    want = JT.multi_step_lr(0.04, m, 0.1)
    got = TT.multi_step_lr(0.04, m, 0.1)
    for count in range(12 * steps):
        assert np.float32(got(count)) == np.float32(want(count)), count


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(6, 5)).astype(np.float32),
            "b": {"c": rng.normal(size=(7,)).astype(np.float32),
                  "d": rng.normal(size=(2, 3, 4)).astype(np.float32)}}


@pytest.mark.parametrize("opt", ["bert_adam", "sgd_multistep"])
def test_optimizers_match_optax_over_5_updates(opt):
    if opt == "bert_adam":
        jtx, ttx = JT.bert_adam(1e-2, 6, 0.3), TT.bert_adam(1e-2, 6, 0.3)
    else:
        jtx = JT.sgd_multistep(0.1, [2, 4], 0.1, 0.9, 1e-2)
        ttx = TT.sgd_multistep(0.1, [2, 4], 0.1, 0.9, 1e-2)
    params = _tree(0)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    tp = [torch.from_numpy(a.copy()) for a in leaves]
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js, ts = jtx.init(jp), ttx.init(tp)
    for k in range(5):
        grads = _tree(10 + k)
        u, js = jtx.update(jax.tree_util.tree_map(jnp.asarray, grads), js,
                           jp)
        jp = optax.apply_updates(jp, u)
        ttx.step(tp, [torch.from_numpy(g) for g in
                      jax.tree_util.tree_leaves(grads)], ts)
        for a, b in zip(jax.tree_util.tree_leaves(jp), tp):
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       rtol=OPT_RTOL, atol=OPT_RTOL,
                                       err_msg=f"{opt} update {k}")
    if opt == "bert_adam":      # the first update had lr 0: decay too
        assert ts["count"] == 5


# ---------------------------------------------------------------------------
# The classification step on a tiny quantized ResNet
# ---------------------------------------------------------------------------

RESNET = dict(block="basic", layers=(1, 1, 1, 1), num_classes=10)


def _labels(seed, n=4):
    return np.random.default_rng(seed).integers(0, 10, n).astype(np.int32)


@functools.lru_cache(maxsize=None)
def resnet_calibrated():
    """The port's tiny ResNet, calibrated (eval mode) on one batch, and
    its variables as the reference's (quant included)."""
    torch.manual_seed(21)          # the port's init draws from torch's
    tm = trn.ResNet(trn.ResNetConfig(**RESNET), TQ(**FAST), device="cpu")
    g = torch.Generator().manual_seed(21)
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, trn.BatchNorm):
                for t, lo, s in ((m.mean, 0.0, 0.1), (m.bias, 0.0, 0.1),
                                 (m.var, 0.5, 1.0), (m.scale, 0.5, 1.0)):
                    t.copy_(lo + s * (torch.rand(t.shape, generator=g)
                                      if lo else torch.randn(
                                          t.shape, generator=g)))
    _, tq = calibrate_model(tm, nchw(nhwc(20, (4, 32, 32, 3))))
    v = jax_variables(tm)
    v["quant"] = to_jax(tq)
    return v, {k: t.clone() for k, t in tm.state_dict().items()}, tq


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def sync(tm, tstate, jstate):
    """The reference's parameters, running statistics and momentum trace
    into the port's model and SGD state (a quantized network amplifies
    the stem's tie routing, see STEM, so each step starts from one
    state)."""
    np_ = functools.partial(jax.tree_util.tree_map, np.asarray)
    with torch.no_grad():
        tm.load_state_dict(convert.from_jax_image_params(
            np_(jstate.params), np_(jstate.extra["batch_stats"]),
            device="cpu"))
        trace = convert.from_jax_image_params(
            np_(jstate.opt_state[1][0].trace), device="cpu")
        for t, (name, _) in zip(tstate.opt_state["trace"],
                                tm.named_parameters()):
            t.copy_(trace[name])


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_classification_step_on_a_tiny_quantized_resnet(grad_accum):
    v, state0, tq = resnet_calibrated()
    jm = jrn.ResNet(jrn.ResNetConfig(**RESNET), JQ(**FAST))
    jtx = JT.sgd_multistep(0.1, [1], 0.1, 0.9, 1e-4)
    jstate = JT.TrainState(v["params"], v["quant"], jtx.init(v["params"]),
                           {"batch_stats": v["batch_stats"]})
    jstep = JT.make_classification_step(jm, jtx, has_batch_stats=True,
                                        grad_accum=grad_accum)
    tm = trn.ResNet(trn.ResNetConfig(**RESNET), TQ(**FAST), device="cpu")
    tm.load_state_dict(state0)
    tl.load_quant_tree(tm, tq)
    ttx = TT.sgd_multistep(0.1, [1], 0.1, 0.9, 1e-4)
    tstate = TT.TrainState(tm, ttx.init(list(tm.parameters())))
    tstep = TT.make_classification_step(tm, ttx, has_batch_stats=True,
                                        grad_accum=grad_accum)
    for k in range(2):
        if k:       # the second step from the reference's state
            sync(tm, tstate, jstate)
        before = {n: p.detach().numpy().copy()
                  for n, p in tm.named_parameters()}
        x, y = nhwc(30 + k, (4, 32, 32, 3)), _labels(40 + k)
        jstate, jloss = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        tstate, tloss = tstep(tstate, x, y)
        np.testing.assert_allclose(float(tloss), float(jloss),
                                   rtol=LOSS_RTOL, err_msg=f"loss {k}")
        want = convert.from_jax_image_params(
            jax.tree_util.tree_map(np.asarray, jstate.params),
            device="cpu")
        got = dict(tm.named_parameters())
        assert set(got) == set(want)
        for name, w in want.items():
            u = got[name].detach().numpy().ravel() - before[name].ravel()
            v = w.numpy().ravel() - before[name].ravel()
            cos = u @ v / (np.linalg.norm(u) * np.linalg.norm(v))
            ratio = np.linalg.norm(u) / np.linalg.norm(v)
            stem = name.split(".")[0] in STEM
            assert cos >= (STEM_COS if stem else UPDATE_COS), (k, name, cos)
            assert abs(ratio - 1) <= UPDATE_NORM_RTOL, (k, name, ratio)
        stats = _flat(jax.tree_util.tree_map(
            np.asarray, jstate.extra["batch_stats"]))
        tstats = _flat(tstate.extra["batch_stats"])
        assert set(stats) == set(tstats)
        for name in stats:
            np.testing.assert_allclose(tstats[name].numpy() if isinstance(
                tstats[name], torch.Tensor) else tstats[name], stats[name],
                rtol=STATS_RTOL, atol=STATS_RTOL, err_msg=f"{k} {name}")
    # the states stayed frozen: no step recalibrated a site
    for (path, a), (_, b) in zip(tpr.quant_sites(tl.quant_tree(tm)),
                                 tpr.quant_sites(tq)):
        for k in ("weight_q", "input_q"):
            assert torch.equal(a[k].alpha, b[k].alpha), path
    assert tstate.step == 2


# ---------------------------------------------------------------------------
# The LM step
# ---------------------------------------------------------------------------

LM = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=2, d_ff=64,
          max_seq=64, positions="learned_offset2", activation="relu",
          fused_qkv=False)


def test_lm_step_on_a_2_layer_opt():
    ids0 = np.random.default_rng(50).integers(0, 128, (2, 16))
    fp = jlm.TransformerLM(jlm.LMConfig(**LM), JQ(enabled=False))
    params = jax.tree_util.tree_map(np.asarray, jax.jit(fp.init)(
        jax.random.PRNGKey(3), jnp.asarray(ids0))["params"])
    tm = tlm.TransformerLM(tlm.LMConfig(**LM), TQ(**FAST), device="cpu")
    tm.load_state_dict(convert.from_jax_lm_params(params, device="cpu"))
    _, tq = calibrate_model(tm, torch.from_numpy(ids0))
    jm = jlm.TransformerLM(jlm.LMConfig(**LM), JQ(**FAST))
    jtx, ttx = JT.bert_adam(1e-3, 4, 0.25), TT.bert_adam(1e-3, 4, 0.25)
    jstate = JT.TrainState(params, to_jax(tq), jtx.init(params), {})
    tstate = TT.TrainState(tm, ttx.init(list(tm.parameters())))
    jstep, tstep = JT.make_lm_step(jm, jtx), TT.make_lm_step(tm, ttx)
    for k in range(2):
        ids = np.random.default_rng(60 + k).integers(0, 128, (2, 16))
        jstate, jloss = jstep(jstate, jnp.asarray(ids))
        tstate, tloss = tstep(tstate, ids)
        np.testing.assert_allclose(float(tloss), float(jloss),
                                   rtol=LOSS_RTOL, err_msg=f"loss {k}")
        want = convert.from_jax_lm_params(jax.tree_util.tree_map(
            np.asarray, jstate.params), device="cpu")
        for name, p in tm.named_parameters():
            w = want[name].numpy()
            if name.endswith("attn.k.bias"):
                # its gradient is 0 in exact arithmetic (a constant along
                # the keys of each query's scores): both steps are noise
                assert np.abs(p.detach().numpy()).max() <= 1e-2 * 1e-3
                continue
            np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                       atol=STEP_ATOL * np.abs(w).max(),
                                       err_msg=f"{k} {name}")
    # the first BertAdam step has lr 0: only the second moved the weights
    assert tstate.step == 2


# ---------------------------------------------------------------------------
# prime_and_promote
# ---------------------------------------------------------------------------

class JNet(fnn.Module):
    qcfg: JQ

    @fnn.compact
    def __call__(self, x):
        x = fnn.relu(jl.QuantConv(8, (3, 3), self.qcfg, padding=1,
                                  name="conv_a")(x))
        x = fnn.relu(jl.QuantConv(8, (3, 3), self.qcfg, strides=2,
                                  padding=1, name="conv_b")(x))
        return jl.QuantDense(5, self.qcfg, name="fc")(x.mean(axis=(1, 2)))


class TNet(torch.nn.Module):
    def __init__(self, qcfg):
        super().__init__()
        self.conv_a = tl.QuantConv(4, 8, (3, 3), qcfg, padding=1,
                                   device="cpu")
        self.conv_b = tl.QuantConv(8, 8, (3, 3), qcfg, strides=2, padding=1,
                                   device="cpu")
        self.fc = tl.QuantDense(8, 5, qcfg, device="cpu")

    def forward(self, x, train=False):
        x = torch.relu(self.conv_a(x))
        x = torch.relu(self.conv_b(x))
        return self.fc(x.mean(dim=(2, 3)))


NET_X = nhwc(70, (4, 10, 10, 4))


@functools.lru_cache(maxsize=None)
def net_params():
    return jax.tree_util.tree_map(np.asarray, JNet(JQ(enabled=False)).init(
        jax.random.PRNGKey(4), jnp.asarray(NET_X))["params"])


def tnet(qkw):
    tm = TNet(TQ(**qkw))
    tm.load_state_dict(convert.from_jax_image_params(net_params(),
                                                     device="cpu"))
    return tm


@pytest.mark.parametrize("promote", [dict(n8=3), dict(layer_list="0,1")])
def test_prime_and_promote_gives_the_reference_tree(promote):
    q = dict(mode="ant-int-pot-flint")
    params = net_params()
    tcal._assert_clear_of_ties(params["conv_a"]["kernel"],
                               dataclasses.asdict(JQ(**q).weight_site(
                                   channel_axis=-1, pair_axis=2)))
    tcal._assert_clear_of_ties(NET_X, dataclasses.asdict(
        JQ(**q).input_site()))
    jq = JT.prime_and_promote(JNet(JQ(**q)), {"params": params},
                              (jnp.asarray(NET_X),), **promote)
    tm = tnet(q)
    tq = TT.prime_and_promote(tm, (nchw(NET_X),), **promote)
    assert_trees_by_rule(jq, tq, "ant")
    bits = sorted(int(st["weight_q"].bit) for _, st in tpr.quant_sites(tq))
    assert bits == ([8, 8, 8] if "n8" in promote else [4, 8, 8])


# ---------------------------------------------------------------------------
# evaluate_classification with a journal
# ---------------------------------------------------------------------------

def _batches(n=6, seed=80):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(4, 10, 10, 4)).astype(np.float32),
             rng.integers(0, 5, 4).astype(np.int32)) for _ in range(n)]


class _Cut(Exception):
    pass


def test_evaluate_classification_journal_resumes(tmp_path):
    tm = tnet(dict(enabled=False))
    batches = _batches()
    want = JT.evaluate_classification(JNet(JQ(enabled=False)),
                                      {"params": net_params()}, batches)
    journal = str(tmp_path / "eval")
    seen = []

    def stream(cut):
        for i, b in enumerate(batches):
            if i == cut:
                raise _Cut()
            seen.append(i)
            yield b

    with pytest.raises(_Cut):
        TT.evaluate_classification(tm, stream(3), journal=journal,
                                   journal_every=1, journal_fingerprint="f")
    calls = []
    real = tm.forward

    def counted(x, train=False):
        calls.append(x.shape[0])
        return real(x)

    tm.forward = counted
    got = TT.evaluate_classification(tm, stream(None), journal=journal,
                                     journal_every=1,
                                     journal_fingerprint="f")
    assert got == want
    assert len(calls) == 3                  # batches 3-5 only
    fresh = TT.evaluate_classification(tnet(dict(enabled=False)), batches,
                                       journal=journal,
                                       journal_fingerprint="other")
    assert fresh == want


def test_resilient_matches_the_reference(tmp_path):
    for mod, d in ((jres, "j"), (tres, "t")):
        acc = mod.ResumableAccumulator(str(tmp_path / d),
                                       {"n": 0, "v": None}, save_every=2)
        for i in range(3):
            acc.fold(i, {"n": i, "v": np.arange(3) * i})
        acc.save()
    for name in ("j", "t"):
        with np.load(tmp_path / f"{name}.journal.npz") as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            assert meta["next_index"] == 3 and meta["scalars"]["n"] == 3
            np.testing.assert_array_equal(z["v"], np.arange(3) * 3)
    back = tres.ResumableAccumulator(str(tmp_path / "j"),
                                     {"n": 0, "v": None})
    assert back.next_index == 3 and back.already_done(2)
    tries = []

    def flaky():
        tries.append(1)
        if len(tries) < 3:
            raise RuntimeError("UNAVAILABLE: try again")
        return 7

    assert tres.retry_transient(flaky, backoff_s=0.0) == 7
    with pytest.raises(ValueError):
        tres.retry_transient(lambda: (_ for _ in ()).throw(
            ValueError("shape")), backoff_s=0.0)
