"""Evaluation loops: the calibration pre-pass, CLM perplexity and GLUE.

Counterpart of the reference's ``harness/evaluate.py``
(``calibrate_on_batches``, ``lm_perplexity``, ``glue_eval``).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from ..calibrate.promote import set_8_bit_layer_l, set_8_bit_layer_n
from ..calibrate.spec import QuantState
from ..nn.layers import quant_tree
from ..utils.calibration import calibrate_model
from . import metrics as M

__all__ = ["calibrate_on_batches", "lm_perplexity", "glue_eval"]


def _reset_initialized(tree):
    """initialized=False on every state (forces recalibration; promoted
    bits stay sticky)."""
    if isinstance(tree, QuantState):
        return tree.replace(initialized=torch.tensor(
            False, device=tree.initialized.device))
    if isinstance(tree, dict):
        return {k: _reset_initialized(v) for k, v in tree.items()}
    return tree


def calibrate_on_batches(model: nn.Module, batches: Iterable[tuple],
                         quant: Optional[Dict] = None, n8: int = 0,
                         layer_list: Optional[str] = None,
                         recalibrate_each: bool = False,
                         log: Optional[Callable[[str], None]] = None,
                         **apply_kwargs) -> Dict:
    """The calibration pass over a stream of batches (tuples of forward
    arguments); returns the quant tree, which the model also holds.

    As in the reference, every quantizer calibrates on the first batch it
    sees and is frozen afterwards: later batches run forward and change
    no state. ``recalibrate_each=True`` (an opt-in divergence) resets
    every state before each batch, so the last batch's states win.
    Promotion to 8 bits (``n8`` sites by MSE, or ``layer_list``) resets
    the states and recalibrates on the first batch. ``quant``: states to
    start from (default: the model's)."""
    first = None
    for i, batch in enumerate(batches):
        if recalibrate_each:
            quant = _reset_initialized(
                quant_tree(model) if quant is None else quant)
        _, quant = calibrate_model(model, *batch, quant=quant,
                                   **apply_kwargs)
        if first is None:
            first = batch
        if log:
            log(f"calibration batch {i + 1} done")
    if first is None:
        raise ValueError("empty calibration stream")
    if layer_list:
        quant = set_8_bit_layer_l(quant, layer_list)
    elif n8 > 0:
        quant = set_8_bit_layer_n(quant, n8)
    else:
        return quant
    _, quant = calibrate_model(model, *first, quant=quant, **apply_kwargs)
    if log:
        log(f"promoted {n8 or layer_list} sites to 8-bit + recalibrated")
    return quant


def lm_perplexity(model: nn.Module, blocks: np.ndarray, batch_size: int,
                  log: Optional[Callable[[str], None]] = None
                  ) -> Dict[str, float]:
    """Perplexity over (N, block) token blocks: exp of the mean
    shifted-token cross entropy (f32 logits, ``logsumexp - label
    logit``)."""
    dev = next(model.parameters()).device
    total, count = 0.0, 0
    n = (len(blocks) // batch_size) * batch_size
    for i in range(0, n, batch_size):
        ids = torch.as_tensor(np.asarray(blocks[i:i + batch_size]),
                              device=dev).long()
        with torch.no_grad():
            logits = model(ids)[:, :-1].to(torch.float32)
        labels = ids[:, 1:, None]
        ce = torch.logsumexp(logits, dim=-1) - logits.gather(
            -1, labels)[..., 0]
        total += float(ce.sum())
        count += ce.numel()
        if log and (i // batch_size + 1) % 10 == 0:
            log(f"eval {i + batch_size}/{n} blocks, ppl so far "
                f"{M.perplexity(total / count):.3f}")
    loss = total / max(count, 1)
    return {"eval_loss": loss, "perplexity": M.perplexity(loss)}


def glue_eval(model: nn.Module, batches: Iterable[dict], task: str,
              regression: bool = False) -> Dict[str, float]:
    """GLUE metrics over encoded batches (dicts of numpy ``input_ids``,
    ``token_type_ids`` (optional), ``attention_mask`` and ``labels``):
    the model's f32 logits come to the host, where the argmax (or, for
    regression, logit 0) is taken."""
    dev = next(model.parameters()).device
    preds, labels = [], []
    for b in batches:
        ids = np.asarray(b["input_ids"])
        args = [torch.as_tensor(np.asarray(a), device=dev).long() for a in (
            ids, b.get("token_type_ids", np.zeros_like(ids)),
            b["attention_mask"])]
        with torch.no_grad():
            logits = model(*args).to(torch.float32).cpu().numpy()
        if regression:
            preds.extend(logits[:, 0].tolist())
        else:
            preds.extend(np.argmax(logits, axis=-1).tolist())
        labels.extend(np.asarray(b["labels"]).tolist())
    return M.glue_compute_metrics(task, preds, labels)
