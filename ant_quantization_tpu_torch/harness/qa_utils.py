"""SQuAD feature preparation and answer post-processing.

Counterpart of the reference's ``harness/qa_utils.py``, a copy of its
flow (OliVe's utils_qa.py, the standard HF one): sliding-window features
with offset mappings (question offsets nulled), then for each example
the top-n start and end logits over all of its features form candidate
spans, and the best-scoring valid span wins; under SQuAD v2 the null
answer wins when its score beats the best span by the threshold. Reads
the standard SQuAD json layout (v1.1 and v2.0).
"""

from __future__ import annotations

import collections
import json
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["load_squad_json", "prepare_features", "postprocess_predictions",
           "squad_references"]


def load_squad_json(path: str) -> List[dict]:
    """-> [{id, question, context, answers: [text...], is_impossible}]"""
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)["data"]
    out = []
    for article in data:
        for para in article["paragraphs"]:
            ctx = para["context"]
            for qa in para["qas"]:
                out.append({
                    "id": qa["id"],
                    "question": qa["question"],
                    "context": ctx,
                    "answers": [a["text"] for a in qa.get("answers", [])],
                    "is_impossible": qa.get("is_impossible", False),
                })
    return out


def squad_references(examples: List[dict]) -> Tuple[Dict[str, List[str]],
                                                    List[str]]:
    refs = {e["id"]: e["answers"] for e in examples}
    no_ans = [e["id"] for e in examples if e["is_impossible"]]
    return refs, no_ans


def prepare_features(examples: List[dict], tokenizer, max_seq_length: int,
                     doc_stride: int = 128) -> List[dict]:
    """Sliding-window tokenization; each feature carries its example id and
    an offset mapping restricted to context tokens (question offsets are
    nulled, like utils_qa's sequence_ids masking)."""
    feats = []
    for ex in examples:
        enc = tokenizer(
            ex["question"], ex["context"], truncation="only_second",
            max_length=max_seq_length, stride=doc_stride,
            return_overflowing_tokens=True, return_offsets_mapping=True,
            padding="max_length")
        for fi in range(len(enc["input_ids"])):
            seq_ids = enc.sequence_ids(fi)
            offsets = [
                (o if seq_ids[k] == 1 else None)
                for k, o in enumerate(enc["offset_mapping"][fi])]
            feats.append({
                "example_id": ex["id"],
                "input_ids": np.asarray(enc["input_ids"][fi], np.int32),
                "token_type_ids": np.asarray(
                    enc.get("token_type_ids",
                            [[0] * max_seq_length] * len(enc["input_ids"])
                            )[fi], np.int32),
                "attention_mask": np.asarray(enc["attention_mask"][fi],
                                             np.int32),
                "offset_mapping": offsets,
            })
    return feats


def postprocess_predictions(
        examples: List[dict], features: List[dict],
        start_logits: np.ndarray, end_logits: np.ndarray,
        n_best: int = 20, max_answer_length: int = 30,
        version_2: bool = False,
        null_score_diff_threshold: float = 0.0) -> Dict[str, str]:
    """(features, logits) -> example id -> predicted answer text."""
    by_example = collections.defaultdict(list)
    for i, f in enumerate(features):
        by_example[f["example_id"]].append(i)

    predictions = {}
    for ex in examples:
        candidates = []
        min_null = None
        for fi in by_example[ex["id"]]:
            s_log, e_log = start_logits[fi], end_logits[fi]
            offsets = features[fi]["offset_mapping"]
            null_score = float(s_log[0] + e_log[0])
            if min_null is None or null_score < min_null:
                min_null = null_score
            s_idx = np.argsort(s_log)[-n_best:][::-1]
            e_idx = np.argsort(e_log)[-n_best:][::-1]
            for si in s_idx:
                for ei in e_idx:
                    if (si >= len(offsets) or ei >= len(offsets)
                            or offsets[si] is None or offsets[ei] is None
                            or ei < si
                            or ei - si + 1 > max_answer_length):
                        continue
                    candidates.append({
                        "score": float(s_log[si] + e_log[ei]),
                        "text": ex["context"][offsets[si][0]:offsets[ei][1]],
                    })
        best = max(candidates, key=lambda c: c["score"], default=None)
        if best is None:
            predictions[ex["id"]] = ""
        elif version_2 and (min_null - best["score"]
                            > null_score_diff_threshold):
            predictions[ex["id"]] = ""
        else:
            predictions[ex["id"]] = best["text"]
    return predictions
