"""Task metrics for the harnesses.

Counterpart of the reference's ``harness/metrics.py``, a copy of its
definitions (the port imports nothing of the reference package):
- GLUE: accuracy, Matthews correlation (binary and multiclass, the
  confusion-matrix form of sklearn's), F1, Pearson and Spearman (average
  ranks for ties), per task as the reference's BERT/run_glue.py maps
  them;
- SQuAD: normalized exact match and token-overlap F1 (v2: an empty
  prediction is right on an unanswerable question);
- CLM: perplexity = exp(eval_loss), inf on overflow.

Pure numpy.
"""

from __future__ import annotations

import collections
import math
import re
import string
from typing import Dict, Iterable, List, Sequence

import numpy as np

__all__ = [
    "accuracy", "matthews_corrcoef", "f1_binary", "pearson", "spearman",
    "acc_and_f1", "pearson_and_spearman", "glue_compute_metrics",
    "perplexity", "squad_em", "squad_f1", "squad_metrics",
]


def accuracy(preds: Sequence[int], labels: Sequence[int]) -> float:
    preds = np.asarray(preds)
    labels = np.asarray(labels)
    return float((preds == labels).mean())


def matthews_corrcoef(preds: Sequence[int], labels: Sequence[int]) -> float:
    """Binary/multiclass MCC via the confusion-matrix formulation
    (matches sklearn.metrics.matthews_corrcoef)."""
    preds = np.asarray(preds)
    labels = np.asarray(labels)
    classes = np.unique(np.concatenate([preds, labels]))
    k = len(classes)
    remap = {c: i for i, c in enumerate(classes)}
    C = np.zeros((k, k), dtype=np.float64)
    for p, t in zip(preds, labels):
        C[remap[t], remap[p]] += 1
    t_sum = C.sum(axis=1)
    p_sum = C.sum(axis=0)
    n = C.sum()
    cov_ytyp = C.trace() * n - t_sum @ p_sum
    cov_ypyp = n * n - p_sum @ p_sum
    cov_ytyt = n * n - t_sum @ t_sum
    denom = math.sqrt(cov_ypyp * cov_ytyt)
    return float(cov_ytyp / denom) if denom else 0.0


def f1_binary(preds: Sequence[int], labels: Sequence[int],
              pos_label: int = 1) -> float:
    preds = np.asarray(preds)
    labels = np.asarray(labels)
    tp = float(((preds == pos_label) & (labels == pos_label)).sum())
    fp = float(((preds == pos_label) & (labels != pos_label)).sum())
    fn = float(((preds != pos_label) & (labels == pos_label)).sum())
    if tp == 0.0:
        return 0.0
    precision = tp / (tp + fp)
    recall = tp / (tp + fn)
    return 2 * precision * recall / (precision + recall)


def pearson(x: Sequence[float], y: Sequence[float]) -> float:
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    xc = x - x.mean()
    yc = y - y.mean()
    denom = math.sqrt(float(xc @ xc) * float(yc @ yc))
    return float(xc @ yc / denom) if denom else 0.0


def _rankdata(a: np.ndarray) -> np.ndarray:
    """Average-tie ranks (scipy.stats.rankdata 'average')."""
    sorter = np.argsort(a, kind="stable")
    inv = np.empty_like(sorter)
    inv[sorter] = np.arange(len(a))
    a_sorted = a[sorter]
    obs = np.r_[True, a_sorted[1:] != a_sorted[:-1]]
    dense = obs.cumsum()[inv]
    count = np.r_[np.nonzero(obs)[0], len(obs)]
    return 0.5 * (count[dense] + count[dense - 1] + 1)


def spearman(x: Sequence[float], y: Sequence[float]) -> float:
    return pearson(_rankdata(np.asarray(x, np.float64)),
                   _rankdata(np.asarray(y, np.float64)))


def acc_and_f1(preds, labels) -> Dict[str, float]:
    acc = accuracy(preds, labels)
    f1 = f1_binary(preds, labels)
    return {"acc": acc, "f1": f1, "acc_and_f1": (acc + f1) / 2}


def pearson_and_spearman(preds, labels) -> Dict[str, float]:
    p = pearson(preds, labels)
    s = spearman(preds, labels)
    return {"pearson": p, "spearmanr": s, "corr": (p + s) / 2}


# Task -> metric mapping of the reference (BERT/run_glue.py:52-89)
def glue_compute_metrics(task: str, preds, labels) -> Dict[str, float]:
    task = task.lower().replace("-", "")
    if task == "cola":
        return {"mcc": matthews_corrcoef(preds, labels)}
    if task in ("sst2", "mnli", "mnlimm", "qnli", "rte", "wnli"):
        return {"acc": accuracy(preds, labels)}
    if task in ("mrpc", "qqp"):
        return acc_and_f1(preds, labels)
    if task == "stsb":
        return pearson_and_spearman(preds, labels)
    raise KeyError(task)


def perplexity(mean_loss: float) -> float:
    """exp(eval_loss), inf-safe (run_clm.py:660-663)."""
    try:
        return math.exp(mean_loss)
    except OverflowError:
        return float("inf")


# ---------------------------------------------------------------------------
# SQuAD (the standard evaluate-v1.1 metric the olive harness reports)
# ---------------------------------------------------------------------------

def _normalize_answer(s: str) -> str:
    s = s.lower()
    s = "".join(ch for ch in s if ch not in set(string.punctuation))
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.split())


def squad_em(prediction: str, ground_truths: Iterable[str]) -> float:
    pn = _normalize_answer(prediction)
    return float(any(pn == _normalize_answer(gt) for gt in ground_truths))


def _f1_single(prediction: str, ground_truth: str) -> float:
    pred_tokens = _normalize_answer(prediction).split()
    gt_tokens = _normalize_answer(ground_truth).split()
    if not pred_tokens or not gt_tokens:
        return float(pred_tokens == gt_tokens)
    common = collections.Counter(pred_tokens) & collections.Counter(gt_tokens)
    num_same = sum(common.values())
    if num_same == 0:
        return 0.0
    precision = num_same / len(pred_tokens)
    recall = num_same / len(gt_tokens)
    return 2 * precision * recall / (precision + recall)


def squad_f1(prediction: str, ground_truths: Iterable[str]) -> float:
    return max((_f1_single(prediction, gt) for gt in ground_truths),
               default=0.0)


def squad_metrics(predictions: Dict[str, str],
                  references: Dict[str, List[str]],
                  no_answer_ids: Iterable[str] = ()) -> Dict[str, float]:
    """predictions: id -> text; references: id -> list of gold texts.

    For SQuAD v2 pass ``no_answer_ids`` (ids whose gold is unanswerable);
    an empty prediction counts as correct there.
    """
    no_ans = set(no_answer_ids)
    em, f1 = [], []
    for qid, golds in references.items():
        pred = predictions.get(qid, "")
        if qid in no_ans:
            correct = float(_normalize_answer(pred) == "")
            em.append(correct)
            f1.append(correct)
        else:
            em.append(squad_em(pred, golds))
            f1.append(squad_f1(pred, golds))
    n = max(len(em), 1)
    return {"exact_match": 100.0 * sum(em) / n, "f1": 100.0 * sum(f1) / n}
