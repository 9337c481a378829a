"""Data pipelines for the harnesses, the causal-LM half.

Counterpart of the reference's ``harness/data.py``: HF datasets'
``group_texts`` chunking as ``lm_blocks`` (concatenate token streams,
drop the remainder, split into block_size chunks), batching, and a
tokenized text corpus. Everything yields plain numpy; the harness moves
it to the device. The GLUE and image pipelines come with their models
(ROADMAP Queue 1 items 10-11).
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence

import numpy as np

__all__ = ["lm_blocks", "batched", "TextDataset"]


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
