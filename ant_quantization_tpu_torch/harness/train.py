"""QAT and fine-tuning: schedules, optimizers, training steps, priming
with promotion, and classification eval.

Counterpart of the reference's ``harness/train.py``. The optimizers are
the reference's optax chains written out as in-place updates over a
model's parameters, in optax's arithmetic and order:

- a schedule is evaluated at the update count *before* the step (so the
  first BertAdam step has lr 0), in f32, switching at ``count >=
  boundary``;
- ``sgd_multistep``: ``add_decayed_weights`` then ``sgd(momentum)``:
  g' = g + wd p, t = g' + momentum t (t starts at 0), p = p + (-lr) t;
- ``bert_adam`` (optax ``adamw``): mu and nu moments, bias corrections
  ``1 - b^count`` in f32, u = mu_hat / (sqrt(nu_hat) + eps) + wd p with
  eps 1e-6 outside the root, p = p + (-lr) u; every parameter decays,
  biases and LayerNorms included (no ``no_decay`` group).

The quantizer states are frozen during steps: they are no parameters,
so no gradient reaches ``alpha``; the straight-through estimator
(``ops/fake_quant.py``) carries the gradient through every snap. The
model holds the parameters, the running statistics (``BatchNorm``
buffers) and the quantizer states that the reference carries in its
``TrainState``; the port's ``TrainState`` holds the model, the optimizer
state and the step, and shows the reference's trees as properties.
Steps and their backward passes run without TF32 (``tf32_off``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
from torch import nn

from ..calibrate.promote import set_8_bit_layer_l, set_8_bit_layer_n
from ..calibrate.spec import QuantState
from ..kernels.qmatmul import tf32_off
from ..models.import_hf import lm_state_dict
from ..models.resnet import batch_stats_tree
from ..models.transformer_lm import params_tree
from ..nn.layers import load_quant_tree, quant_tree
from ..utils.calibration import calibrate_model
from .data import device_images

__all__ = ["multi_step_lr", "warmup_linear", "SGD", "AdamW",
           "sgd_multistep", "bert_adam", "TrainState", "cross_entropy",
           "make_step", "make_classification_step", "make_lm_step",
           "prime_and_promote",
           "evaluate_classification", "checkpoint_tree",
           "load_checkpoint_tree"]

Schedule = Callable[[int], float]
_F = np.float32


# ---------------------------------------------------------------------------
# Schedules (optax's, in its f32 arithmetic)
# ---------------------------------------------------------------------------

def multi_step_lr(base_lr: float, milestones: Sequence[int],
                  gamma: float = 0.1) -> Schedule:
    """torch MultiStepLR as optax's ``piecewise_constant_schedule``: lr *
    gamma^(milestones passed), a milestone passed at ``count >= m``.
    Milestones are steps (the reference converts its epochs)."""
    boundaries = sorted({int(m): gamma for m in milestones}.items())

    def schedule(count: int) -> float:
        v = _F(base_lr)
        for threshold, scale in boundaries:
            ind = _F(max(0.0, float(np.sign(threshold - count))))
            v = v * ind + (_F(1) - ind) * _F(scale) * v
        return float(v)

    return schedule


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax ``linear_schedule`` (a power-1 polynomial)."""
    if steps <= 0:
        return lambda count: float(_F(init))

    def schedule(count: int) -> float:
        c = min(max(count, 0), steps)
        frac = _F(1) - _F(c) / _F(steps)
        return float(_F(init - end) * frac + _F(end))

    return schedule


def warmup_linear(base_lr: float, warmup_proportion: float,
                  total_steps: int) -> Schedule:
    """BertAdam's warmup-linear schedule: a linear ramp to base_lr over
    the warmup steps, then a linear decay to 0 (optax
    ``join_schedules``)."""
    warmup = max(int(total_steps * warmup_proportion), 1)
    up = _linear(0.0, base_lr, warmup)
    down = _linear(base_lr, 0.0, total_steps - warmup)
    return lambda count: up(count) if count < warmup else down(count - warmup)


# ---------------------------------------------------------------------------
# Optimizers: init(params) -> state; step(params, grads, state) in place
# ---------------------------------------------------------------------------

def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """An f32 scalar on ``like``'s device: a division by it stays a true
    division on every device (a CPU scalar divisor becomes a reciprocal
    product on CUDA)."""
    return torch.tensor(v, dtype=like.dtype, device=like.device)


@dataclasses.dataclass(frozen=True)
class SGD:
    """optax ``chain(add_decayed_weights(weight_decay),
    sgd(schedule, momentum))``."""
    schedule: Schedule
    momentum: float = 0.9
    weight_decay: float = 0.0

    def init(self, params: Sequence[torch.Tensor]) -> Dict[str, Any]:
        return {"count": 0, "trace": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def step(self, params, grads, state) -> None:
        neg_lr = -1 * self.schedule(state["count"])
        for p, g, t in zip(params, grads, state["trace"]):
            if self.weight_decay:
                g = g + self.weight_decay * p
            t.copy_(g + self.momentum * t)
            p.copy_(p + t * neg_lr)
        state["count"] += 1


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax ``adamw(schedule, b1, b2, eps, weight_decay=...)``."""
    schedule: Schedule
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-6
    weight_decay: float = 1e-4

    def init(self, params: Sequence[torch.Tensor]) -> Dict[str, Any]:
        return {"count": 0, "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def step(self, params, grads, state) -> None:
        count = state["count"] + 1
        bc1 = float(_F(1) - _F(self.b1) ** _F(count))
        bc2 = float(_F(1) - _F(self.b2) ** _F(count))
        neg_lr = -1 * self.schedule(state["count"])
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            u = (mu / _scalar(bc1, mu)) / (
                torch.sqrt(nu / _scalar(bc2, nu) + 0.0) + self.eps)
            u = u + self.weight_decay * p
            p.copy_(p + u * neg_lr)
        state["count"] = count


def sgd_multistep(base_lr: float, milestones: Sequence[int],
                  gamma: float = 0.1, momentum: float = 0.9,
                  weight_decay: float = 1e-4) -> SGD:
    """The ImageNet QAT optimizer: SGD with momentum and weight decay on a
    MultiStepLR schedule."""
    return SGD(multi_step_lr(base_lr, milestones, gamma), momentum,
               weight_decay)


def bert_adam(base_lr: float, total_steps: int,
              warmup_proportion: float = 0.1,
              weight_decay: float = 0.01) -> AdamW:
    """BertAdam: Adam with decoupled weight decay on the warmup-linear
    schedule (b1 0.9, b2 0.999, eps 1e-6)."""
    return AdamW(warmup_linear(base_lr, warmup_proportion, total_steps),
                 0.9, 0.999, 1e-6, weight_decay)


# ---------------------------------------------------------------------------
# Train state and steps
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    """The model (parameters, running statistics and frozen quantizer
    states), the optimizer's state over ``model.parameters()`` in their
    order, and the step."""
    model: nn.Module
    opt_state: Dict[str, Any]
    step: int = 0

    @property
    def params(self) -> Dict:
        return params_tree(self.model)

    @property
    def quant(self) -> Dict:
        return quant_tree(self.model)

    @property
    def extra(self) -> Dict:
        stats = batch_stats_tree(self.model)
        return {"batch_stats": stats} if stats else {}


def checkpoint_tree(state: TrainState, epoch: int) -> Dict:
    """What the QAT tool saves each epoch, as the reference's does:
    ``params``, ``quant``, ``extra`` (the batch statistics) and
    ``epoch``; no optimizer state."""
    return {"params": state.params, "quant": state.quant,
            "extra": state.extra, "epoch": epoch}


def _states(node):
    """A restored quant tree (field dicts) with QuantState leaves."""
    if isinstance(node, QuantState):
        return node
    if "alpha" in node and "grid" in node:
        return QuantState(**node)
    return {k: _states(v) for k, v in node.items()}


def load_checkpoint_tree(model: nn.Module, tree: Dict) -> None:
    """Load a restored checkpoint tree (``checkpoint_tree``'s keys; or
    ``batch_stats`` beside ``params``) into ``model``: parameters, running
    statistics and, when present, the quantizer states."""
    state = lm_state_dict(tree["params"])
    stats = tree.get("extra", {}).get("batch_stats") or tree.get(
        "batch_stats")
    if stats:
        state.update(lm_state_dict(stats))
    with torch.no_grad():
        model.load_state_dict(state)
    if tree.get("quant"):
        load_quant_tree(model, _states(tree["quant"]))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Per-row softmax cross entropy with integer labels (optax's:
    logsumexp of the row minus the label's logit), in f32."""
    logits = logits.to(torch.float32)
    lab = logits.gather(-1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - lab


def _grads(loss: torch.Tensor, params: List[torch.Tensor]):
    gs = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, gs)]


def make_step(model: nn.Module, tx, loss_fn):
    """(state, *batch) -> (state, loss): the gradient of ``loss_fn(*batch)``
    (a scalar tensor) over every parameter of ``model``, then one ``tx``
    update; forward, backward and update without TF32."""
    params = list(model.parameters())

    def apply(state: TrainState, *batch) -> Tuple[TrainState, torch.Tensor]:
        with tf32_off():
            loss = loss_fn(*batch)
            tx.step(params, _grads(loss, params), state.opt_state)
        state.step += 1
        return state, loss.detach()

    return apply


def make_classification_step(model: nn.Module, tx, has_batch_stats: bool =
                             False, grad_accum: int = 1, preprocess=None):
    """(state, images, labels) -> (state, loss): one softmax-CE step.

    ``images`` are (B, H, W, C) as the image pipelines yield them
    (numpy or a tensor); ``preprocess`` (``data.normalize_images`` for
    uint8 batches) runs on the device inside the step, then the model
    sees (B, C, H, W). ``has_batch_stats``: the forward runs with
    ``train=True`` (batch statistics, running ones updated); else with
    the running ones. ``grad_accum`` > 1 splits the batch into that many
    microbatches in order and averages their gradients (and losses);
    a BN model normalizes per microbatch and updates its running
    statistics once per microbatch, as the reference's scan does. The
    returned loss is a 0-dim tensor on the device."""
    params = list(model.parameters())

    def loss_fn(images, labels):
        logits = model(images, train=True) if has_batch_stats \
            else model(images)
        return cross_entropy(logits, labels).mean()

    def apply(state: TrainState, images, labels) -> Tuple[TrainState,
                                                          torch.Tensor]:
        dev = params[0].device
        x = device_images(images, dev, preprocess)
        y = torch.as_tensor(labels, device=dev).long()
        with tf32_off():
            if grad_accum == 1:
                loss = loss_fn(x, y)
                grads = _grads(loss, params)
            else:
                B = x.shape[0]
                assert B % grad_accum == 0, (B, grad_accum)
                mb = B // grad_accum
                grads, loss = None, 0.0
                for i in range(grad_accum):
                    sl = slice(i * mb, (i + 1) * mb)
                    li = loss_fn(x[sl], y[sl])
                    g = _grads(li, params)
                    grads = g if grads is None else [
                        a + b for a, b in zip(grads, g)]
                    loss = loss + li.detach()
                inv = 1.0 / grad_accum
                grads = [g * inv for g in grads]
                loss = loss * inv
            tx.step(params, grads, state.opt_state)
        state.step += 1
        return state, loss.detach()

    return apply


def make_lm_step(model: nn.Module, tx):
    """(state, ids) -> (state, loss): one causal-LM step, the mean
    next-token cross entropy over the shifted ids."""
    dev = next(model.parameters()).device

    def loss_fn(ids):
        ids = torch.as_tensor(ids, device=dev).long()
        return cross_entropy(model(ids)[:, :-1], ids[:, 1:]).mean()

    return make_step(model, tx, loss_fn)


# ---------------------------------------------------------------------------
# Priming and mixed-precision promotion (the reference's first-batch flow)
# ---------------------------------------------------------------------------

def prime_and_promote(model: nn.Module, batch_args: tuple, n8: int = 0,
                      layer_list: Optional[str] = None,
                      **apply_kwargs) -> Dict:
    """Calibrate on one priming batch (forward arguments ``batch_args``);
    then promote the ``n8`` highest-MSE sites (or ``layer_list``) to 8
    bits and recalibrate. Returns the final quant tree, which the model
    holds."""
    _, quant = calibrate_model(model, *batch_args, **apply_kwargs)
    if layer_list:
        quant = set_8_bit_layer_l(quant, layer_list)
    elif n8 > 0:
        quant = set_8_bit_layer_n(quant, n8)
    else:
        return quant
    _, quant = calibrate_model(model, *batch_args, quant=quant,
                               **apply_kwargs)
    return quant


# ---------------------------------------------------------------------------
# Eval
# ---------------------------------------------------------------------------

def evaluate_classification(model: nn.Module,
                            batches: Iterable[Tuple[np.ndarray, np.ndarray]],
                            topk: Tuple[int, ...] = (1, 5),
                            log_every: int = 0,
                            logger: Optional[Callable[[str], None]] = None,
                            journal: Optional[str] = None,
                            journal_every: int = 50,
                            journal_fingerprint: str = "",
                            preprocess=None) -> Dict[str, float]:
    """Top-k accuracy over a stream of (B, H, W, C) image batches and
    their labels: the model's logits come to the host, where they are
    ranked. ``journal``: a path for crash-resumable accumulation
    (``harness/resilient.py``); a journal written under another
    ``journal_fingerprint`` is discarded, not resumed."""
    from .resilient import ResumableAccumulator

    dev = next(model.parameters()).device
    acc = ResumableAccumulator(
        journal or "", init={f"correct{k}": 0 for k in topk} | {"total": 0},
        save_every=journal_every, fingerprint=journal_fingerprint)
    t0 = time.perf_counter()
    for i, (images, labels) in enumerate(batches):
        if acc.already_done(i):
            continue
        with torch.no_grad():
            logits = model(device_images(images, dev, preprocess))
        logits = logits.to(torch.float32).cpu().numpy()
        labels = np.asarray(labels)
        order = np.argsort(-logits, axis=-1)
        contrib = {f"correct{k}": int(
            (order[:, :k] == labels[:, None]).any(axis=1).sum())
            for k in topk}
        contrib["total"] = len(labels)
        acc.fold(i, contrib)
        if log_every and logger and (i + 1) % log_every == 0:
            s = acc.state
            logger(f"eval batch {i + 1}: top1="
                   f"{s[f'correct{topk[0]}'] / max(s['total'], 1):.4f} "
                   f"n={s['total']} "
                   f"({s['total'] / (time.perf_counter() - t0):.1f} img/s)")
    state = acc.finalize()
    total = max(state["total"], 1)
    return {f"top{k}": state[f"correct{k}"] / total for k in topk}
