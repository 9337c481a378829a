"""Data pipelines for the harnesses: the causal-LM and GLUE halves.

Counterpart of the reference's ``harness/data.py``: HF datasets'
``group_texts`` chunking as ``lm_blocks`` (concatenate token streams,
drop the remainder, split into block_size chunks), batching, a tokenized
text corpus, and the GLUE readers (the standard TSV layout with each
task's text_a/text_b/label columns, as the reference's processors read
them, or jsonl) with their batch encoding. Everything yields plain
numpy; the harness moves it to the device. The image pipeline comes with
the image models (ROADMAP Queue 1 items 10-11).
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

__all__ = ["lm_blocks", "batched", "TextDataset", "GLUE_TASKS",
           "GlueExample", "load_glue_split", "glue_num_labels",
           "encode_glue_batch"]


def lm_blocks(token_ids: Sequence[int], block_size: int) -> np.ndarray:
    """Concatenate tokens, drop the tail remainder, reshape to
    (n_blocks, block_size), exactly HF group_texts."""
    ids = np.asarray(token_ids, np.int32)
    n = (len(ids) // block_size) * block_size
    return ids[:n].reshape(-1, block_size)


def batched(array: np.ndarray, batch_size: int,
            drop_remainder: bool = False) -> Iterator[np.ndarray]:
    n = len(array)
    stop = n - (n % batch_size) if drop_remainder else n
    for i in range(0, stop, batch_size):
        yield array[i:i + batch_size]


class TextDataset:
    """Tokenized text corpus -> LM eval blocks.

    Sources: a plain text file (one document, tokenized whole), or a
    local HF dataset directory (``datasets.load_from_disk``; needs the
    ``datasets`` package). Nothing is fetched from the hub."""

    def __init__(self, tokens: np.ndarray, block_size: int):
        self.blocks = lm_blocks(tokens, block_size)

    @classmethod
    def from_text_file(cls, path: str, tokenizer, block_size: int,
                       max_chars: Optional[int] = None) -> "TextDataset":
        with open(path, "r", encoding="utf-8") as f:
            text = f.read(max_chars) if max_chars else f.read()
        return cls(np.asarray(tokenizer(text)["input_ids"], np.int32),
                   block_size)

    @classmethod
    def from_hf(cls, name: str, config: Optional[str], split: str,
                tokenizer, block_size: int,
                text_column: str = "text") -> "TextDataset":
        """A dataset saved with ``save_to_disk`` in the local directory
        ``name`` (``config`` is the hub's and is not used)."""
        if not os.path.isdir(name):
            raise FileNotFoundError(
                f"{name!r} is not a local dataset directory; the port "
                "reads text files and local datasets only, never the hub")
        try:
            import datasets
        except ImportError as e:
            raise RuntimeError(
                f"reading the dataset directory {name!r} needs the "
                "'datasets' package, which is not installed; pass a text "
                "file instead") from e
        ds = datasets.load_from_disk(name)
        if split in getattr(ds, "keys", lambda: [])():
            ds = ds[split]
        ids: List[int] = []
        for rec in ds:
            t = rec[text_column]
            if t:
                ids.extend(tokenizer(t)["input_ids"])
        return cls(np.asarray(ids, np.int32), block_size)


# ---------------------------------------------------------------------------
# GLUE
# ---------------------------------------------------------------------------

class GlueExample:
    __slots__ = ("text_a", "text_b", "label")

    def __init__(self, text_a: str, text_b: Optional[str], label):
        self.text_a = text_a
        self.text_b = text_b
        self.label = label


# task -> (labels, dev filename, columns of (text_a, text_b, label) in the
# TSV, header row). The columns follow the reference's per-task
# processors on the standard GLUE data layout.
GLUE_TASKS: Dict[str, dict] = {
    "cola": {"labels": ["0", "1"], "dev": "dev.tsv",
             "cols": (3, None, 1), "header": False},
    "sst2": {"labels": ["0", "1"], "dev": "dev.tsv",
             "cols": (0, None, 1), "header": True},
    "mrpc": {"labels": ["0", "1"], "dev": "dev.tsv",
             "cols": (3, 4, 0), "header": True},
    "qqp": {"labels": ["0", "1"], "dev": "dev.tsv",
            "cols": (3, 4, 5), "header": True},
    "mnli": {"labels": ["contradiction", "entailment", "neutral"],
             "dev": "dev_matched.tsv", "cols": (8, 9, -1), "header": True},
    "mnli-mm": {"labels": ["contradiction", "entailment", "neutral"],
                "dev": "dev_mismatched.tsv", "cols": (8, 9, -1),
                "header": True},
    "qnli": {"labels": ["entailment", "not_entailment"], "dev": "dev.tsv",
             "cols": (1, 2, -1), "header": True},
    "rte": {"labels": ["entailment", "not_entailment"], "dev": "dev.tsv",
            "cols": (1, 2, -1), "header": True},
    "wnli": {"labels": ["0", "1"], "dev": "dev.tsv",
             "cols": (1, 2, -1), "header": True},
    "stsb": {"labels": None, "dev": "dev.tsv",
             "cols": (7, 8, -1), "header": True},
}


def glue_num_labels(task: str) -> int:
    labels = GLUE_TASKS[task.lower()]["labels"]
    return 1 if labels is None else len(labels)


def _read_tsv(path: str) -> List[List[str]]:
    with open(path, "r", encoding="utf-8") as f:
        return list(csv.reader(f, delimiter="\t", quotechar=None))


def load_glue_split(data_dir: str, task: str,
                    split: str = "dev") -> List[GlueExample]:
    """A GLUE split from the standard TSV layout (rows too short for the
    task's columns are skipped), or from ``{split}.jsonl`` with
    sentence1/sentence (or text_a), sentence2 (or text_b) and label
    records; labels become indices (floats for STS-B)."""
    task = task.lower()
    info = GLUE_TASKS[task]
    jsonl = os.path.join(data_dir, f"{split}.jsonl")
    if os.path.exists(jsonl):
        out = []
        with open(jsonl, "r", encoding="utf-8") as f:
            for line in f:
                r = json.loads(line)
                out.append(GlueExample(
                    r.get("sentence1") or r.get("sentence") or r["text_a"],
                    r.get("sentence2") or r.get("text_b"),
                    r["label"]))
        return _encode_labels(out, info)
    fname = info["dev"] if split == "dev" else f"{split}.tsv"
    rows = _read_tsv(os.path.join(data_dir, fname))
    if info["header"]:
        rows = rows[1:]
    ca, cb, cl = info["cols"]
    out = []
    for row in rows:
        if len(row) <= max(ca, cb or 0, cl if cl >= 0 else 0):
            continue
        out.append(GlueExample(row[ca], row[cb] if cb is not None else None,
                               row[cl]))
    return _encode_labels(out, info)


def _encode_labels(examples: List[GlueExample], info: dict):
    labels = info["labels"]
    for e in examples:
        if labels is None:
            e.label = float(e.label)
        elif not isinstance(e.label, int):
            e.label = labels.index(str(e.label))
    return examples


def encode_glue_batch(tokenizer, examples: Sequence[GlueExample],
                      max_length: int) -> Dict[str, np.ndarray]:
    """Tokenize a batch (pairs when the first example has a text_b),
    padded to ``max_length``: int32 arrays and the labels."""
    enc = tokenizer(
        [e.text_a for e in examples],
        [e.text_b for e in examples] if examples[0].text_b is not None
        else None,
        padding="max_length", truncation=True, max_length=max_length)
    batch = {k: np.asarray(v, np.int32) for k, v in enc.items()}
    batch["labels"] = np.asarray([e.label for e in examples])
    return batch
