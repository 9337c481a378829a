"""Data pipelines for the harnesses: the causal-LM and GLUE halves.

Counterpart of the reference's ``harness/data.py``: HF datasets'
``group_texts`` chunking as ``lm_blocks`` (concatenate token streams,
drop the remainder, split into block_size chunks), batching, a tokenized
text corpus, and the GLUE readers (the standard TSV layout with each
task's text_a/text_b/label columns, as the reference's processors read
them, or jsonl) with their batch encoding; the image half: the ImageNet
folder pipeline (a host decode in worker threads, the reference's
replacement of DALI), synthetic image batches and the CIFAR pipeline.
Everything yields plain numpy, images as (B, H, W, C) as the reference's
do; ``device_images`` moves a batch to the device, normalizes uint8
crops there (``normalize_images``, the reference normalizes inside its
jitted step) and hands models their (B, C, H, W) layout.

The decoder is PIL's (``load_image_u8``), imported when an image file is
first read: a host without PIL runs the synthetic and CIFAR pipelines,
and raises, naming PIL, on an image folder.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["lm_blocks", "batched", "TextDataset", "GLUE_TASKS",
           "GlueExample", "load_glue_split", "glue_num_labels",
           "encode_glue_batch", "IMAGENET_MEAN", "IMAGENET_STD",
           "model_input_size", "list_imagefolder", "load_image_u8",
           "normalize_images", "device_images", "load_image", "prefetched",
           "imagefolder_batches", "synthetic_image_batches",
           "CIFAR100_MEAN", "CIFAR100_STD", "CIFAR10_MEAN", "CIFAR10_STD",
           "load_cifar", "cifar_batches"]


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


# ---------------------------------------------------------------------------
# ImageNet folder pipeline
# ---------------------------------------------------------------------------

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def model_input_size(model_name: str) -> Tuple[int, int]:
    """(resize, crop) per model: Inception-v3 342/299, the rest
    256/224."""
    if "inception" in model_name.lower():
        return 342, 299
    return 256, 224


def list_imagefolder(root: str) -> Tuple[List[str], List[int], List[str]]:
    """ImageFolder layout root/<class>/<img>; classes sorted by name (the
    torchvision convention, so labels match torchvision checkpoints)."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    paths, labels = [], []
    for i, c in enumerate(classes):
        cdir = os.path.join(root, c)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith(
                    (".jpg", ".jpeg", ".png", ".bmp", ".webp")):
                paths.append(os.path.join(cdir, fname))
                labels.append(i)
    return paths, labels, classes


def load_image_u8(path: str, resize: int, crop: int) -> np.ndarray:
    """Decode, resize the shorter side to ``resize`` (bilinear), center
    crop ``crop``: (crop, crop, 3) uint8. Needs PIL."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "load_image_u8 decodes image files with PIL (the Pillow "
            "package), which this Python lacks; use synthetic data or "
            "install Pillow") from e
    img = Image.open(path).convert("RGB")
    w, h = img.size
    if w < h:
        nw, nh = resize, int(round(h * resize / w))
    else:
        nw, nh = int(round(w * resize / h)), resize
    img = img.resize((nw, nh), Image.BILINEAR)
    left = (nw - crop) // 2
    top = (nh - crop) // 2
    img = img.crop((left, top, left + crop, top + crop))
    return np.asarray(img, np.uint8)


def normalize_images(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) uint8 -> normalized f32 on x's device: (x / 255 -
    mean) / std, true divisions in f32."""
    def c(v):
        return torch.as_tensor(v, dtype=torch.float32, device=x.device)

    return (x.to(torch.float32) / c(255.0) - c(IMAGENET_MEAN)) \
        / c(IMAGENET_STD)


def device_images(images, device, preprocess=None) -> torch.Tensor:
    """A (B, H, W, C) batch (numpy or a tensor) on ``device``:
    ``preprocess`` applied there (``normalize_images`` for uint8 crops),
    then (B, C, H, W) contiguous, the models' layout."""
    x = torch.as_tensor(images, device=device)
    if preprocess is not None:
        x = preprocess(x)
    return x.permute(0, 3, 1, 2).contiguous()


def load_image(path: str, resize: int, crop: int) -> np.ndarray:
    """Eval transform: resize, center crop, normalize; HWC f32."""
    x = load_image_u8(path, resize, crop).astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def prefetched(iterator: Iterator, depth: int = 2) -> Iterator:
    """Run ``iterator`` in a background thread with a bounded queue, so
    the step loop does not wait on host work that could have run during
    the previous step. Errors reach the consumer; a consumer that stops
    early releases the producer."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    cancelled = threading.Event()

    def put(item) -> bool:
        while not cancelled.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for item in iterator:
                if not put(item):
                    return
            put(end)
        except BaseException as e:          # surface errors to the consumer
            put(e)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        cancelled.set()
        close = getattr(iterator, "close", None)
        if close is not None:
            try:
                t.join(timeout=5.0)
                if not t.is_alive():    # never close a generator mid-next()
                    close()
            except BaseException:
                pass


def imagefolder_batches(root: str, batch_size: int, model_name: str = "",
                        shard: Tuple[int, int] = (0, 1),
                        limit: Optional[int] = None,
                        workers: int = 16, prefetch: int = 2,
                        as_uint8: bool = False):
    """Yield (images (B, H, W, C) f32, labels i32) eval batches, sharded
    ``shard=(index, count)``. Decodes run on ``workers`` threads (PIL
    releases the GIL in its decode and resize) with ``prefetch`` batches
    in flight; ``workers=0`` decodes in the loop. ``as_uint8`` yields the
    raw uint8 crops, to be normalized on the device
    (``normalize_images``)."""
    loader = load_image_u8 if as_uint8 else load_image
    resize, crop = model_input_size(model_name)
    paths, labels, _ = list_imagefolder(root)
    idx = np.arange(len(paths))[shard[0]::shard[1]]
    if limit:
        idx = idx[:limit]
    chunks = [idx[i:i + batch_size] for i in range(0, len(idx), batch_size)]
    if workers <= 0:
        for chunk in chunks:
            yield (np.stack([loader(paths[j], resize, crop) for j in chunk]),
                   np.asarray([labels[j] for j in chunk], np.int32))
        return

    from concurrent.futures import ThreadPoolExecutor

    def produce():
        with ThreadPoolExecutor(max_workers=workers) as pool:
            # one future per image, so decodes span batch boundaries
            per_batch = []
            for chunk in chunks:
                futs = [pool.submit(loader, paths[j], resize, crop)
                        for j in chunk]
                lab = np.asarray([labels[j] for j in chunk], np.int32)
                per_batch.append((futs, lab))
                if len(per_batch) > prefetch:
                    futs0, lab0 = per_batch.pop(0)
                    yield np.stack([f.result() for f in futs0]), lab0
            for futs0, lab0 in per_batch:
                yield np.stack([f.result() for f in futs0]), lab0

    yield from prefetched(produce(), depth=prefetch)


def synthetic_image_batches(batch_size: int, n_batches: int,
                            crop: int = 224, num_classes: int = 1000,
                            seed: int = 0):
    """Seeded normal images (B, crop, crop, 3) f32 and uniform labels,
    the reference's draw for draw."""
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        yield (rng.normal(size=(batch_size, crop, crop, 3)).astype(
            np.float32),
            rng.integers(0, num_classes, batch_size).astype(np.int32))


# ---------------------------------------------------------------------------
# CIFAR-10/100 pipeline
# ---------------------------------------------------------------------------

CIFAR100_MEAN = np.array([0.5070751592371323, 0.48654887331495095,
                          0.4409178433670343], np.float32)
CIFAR100_STD = np.array([0.2673342858792401, 0.2564384629170883,
                         0.27615047132568404], np.float32)
CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)


def load_cifar(root: str, which: str = "cifar100",
               split: str = "train") -> Tuple[np.ndarray, np.ndarray]:
    """The CIFAR python pickle layout in a local directory
    (cifar-10-batches-py/ or cifar-100-python/, or the directory itself)
    -> (uint8 (N, 32, 32, 3), labels)."""
    import pickle

    def read(path):
        with open(path, "rb") as f:
            return pickle.load(f, encoding="latin1")

    if which == "cifar10":
        base = os.path.join(root, "cifar-10-batches-py")
        files = ([f"data_batch_{i}" for i in range(1, 6)]
                 if split == "train" else ["test_batch"])
        label_key = "labels"
    else:
        base = os.path.join(root, "cifar-100-python")
        files = ["train" if split == "train" else "test"]
        label_key = "fine_labels"
    if not os.path.isdir(base):
        base = root
    imgs, labels = [], []
    for name in files:
        d = read(os.path.join(base, name))
        data = np.asarray(d["data"], np.uint8).reshape(-1, 3, 32, 32)
        imgs.append(data.transpose(0, 2, 3, 1))
        labels.extend(d[label_key])
    return np.concatenate(imgs), np.asarray(labels, np.int32)


def _cifar_augment(imgs: np.ndarray, rng) -> np.ndarray:
    """RandomCrop(32, padding=4) with zero fill and RandomHorizontalFlip,
    the reference's draws (its train transform without the rotation)."""
    n = imgs.shape[0]
    padded = np.pad(imgs, ((0, 0), (4, 4), (4, 4), (0, 0)),
                    mode="constant")
    out = np.empty_like(imgs)
    ys = rng.integers(0, 9, n)
    xs = rng.integers(0, 9, n)
    flip = rng.random(n) < 0.5
    for i in range(n):
        crop = padded[i, ys[i]:ys[i] + 32, xs[i]:xs[i] + 32]
        out[i] = crop[:, ::-1] if flip[i] else crop
    return out


def cifar_batches(root: str, which: str = "cifar100",
                  split: str = "test", batch_size: int = 128,
                  augment: bool = False, seed: int = 0,
                  shard: Tuple[int, int] = (0, 1),
                  limit: Optional[int] = None, prefetch: int = 2):
    """Yield normalized ((B, 32, 32, 3) f32, labels) batches; the train
    split is shuffled by ``seed``; ``augment`` crops and flips. The
    work runs ``prefetch`` batches ahead in a thread (0: in the loop)."""
    imgs, labels = load_cifar(root, which, split)
    mean, std = ((CIFAR10_MEAN, CIFAR10_STD) if which == "cifar10"
                 else (CIFAR100_MEAN, CIFAR100_STD))
    rng = np.random.default_rng(seed)
    idx = np.arange(len(imgs))
    if split == "train":
        rng.shuffle(idx)
    idx = idx[shard[0]::shard[1]]
    if limit:
        idx = idx[:limit]

    def produce():
        for i in range(0, len(idx), batch_size):
            chunk = idx[i:i + batch_size]
            x = imgs[chunk]
            if augment:
                x = _cifar_augment(x, rng)
            x = (x.astype(np.float32) / 255.0 - mean) / std
            yield x, labels[chunk]

    if prefetch <= 0:
        yield from produce()
    else:
        yield from prefetched(produce(), depth=prefetch)
