"""Checkpoint save/resume for nested trees of tensors (params, quantizer
state, engine params).

Counterpart of the reference's ``harness/checkpoint.py``, without orbax:
a tree is stored as one ``.safetensors`` file under ``path/step_<n>``
(``harness/safetensors_io.py``). Tensor leaves are stored under their
tree path joined by ``/``; every other leaf (a Python int, float, bool,
str or None) goes into the file's JSON metadata. Dicts and dataclasses
(a :class:`~..calibrate.spec.QuantState`) are walked; without a template
a dataclass comes back as a dict of its fields, with one (the same
structure) as its class, as the reference's template restores typed
leaves. A restored tree is bit-equal in value, dtype and shape.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from .._ext import resolve_device
from .safetensors_io import read_safetensors, write_safetensors

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

_FILE = "tree.safetensors"
_SEP = "/"


def _flatten(node, path, tensors: Dict, scalars: Dict) -> None:
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        node = {f.name: getattr(node, f.name)
                for f in dataclasses.fields(node)}
    if isinstance(node, dict):
        if not node:
            scalars[_SEP.join(path)] = {}
        for k, v in node.items():
            if _SEP in str(k):
                raise ValueError(f"tree key {k!r} holds {_SEP!r}")
            _flatten(v, path + (str(k),), tensors, scalars)
    elif isinstance(node, torch.Tensor):
        tensors[_SEP.join(path)] = node
    elif isinstance(node, np.ndarray):
        tensors[_SEP.join(path)] = torch.from_numpy(np.ascontiguousarray(node))
    elif node is None or isinstance(node, (bool, int, float, str)):
        scalars[_SEP.join(path)] = node
    else:
        raise TypeError(f"checkpoint leaf {_SEP.join(path)!r} of type "
                        f"{type(node).__name__}")


def save_checkpoint(path: str, tree: Dict[str, Any], step: int = 0) -> str:
    """Save a tree (e.g. {'params', 'quant'} or engine params) under
    ``path/step_<n>``. Returns the concrete directory."""
    target = os.path.join(os.path.abspath(path), f"step_{step}")
    os.makedirs(target, exist_ok=True)
    tensors: Dict[str, torch.Tensor] = {}
    scalars: Dict[str, Any] = {}
    _flatten(tree, (), tensors, scalars)
    write_safetensors(os.path.join(target, _FILE), tensors,
                      {"scalars": json.dumps(scalars)})
    return target


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_", 1)[1]) for d in os.listdir(path)
             if d.startswith("step_") and d.split("_", 1)[1].isdigit()]
    return max(steps) if steps else None


def _typed(template, node):
    """``node`` (nested dicts) in the structure of ``template``: its
    dataclasses rebuilt."""
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _typed(getattr(template, f.name), node[f.name])
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: _typed(template[k], node[k]) for k in template}
    return node


def restore_checkpoint(path: str, template: Optional[Dict[str, Any]] = None,
                       step: Optional[int] = None, device=None
                       ) -> Dict[str, Any]:
    """Restore the tree saved by :func:`save_checkpoint` (the latest step
    by default), its tensors on ``device`` (default "cuda").

    ``template`` (the same structure, e.g. a freshly built tree) restores
    typed leaves: its dataclasses (``QuantState``) keep their class.
    Without it, nested dicts are returned."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    target = os.path.join(os.path.abspath(path), f"step_{step}")
    tensors, meta = read_safetensors(os.path.join(target, _FILE), dev)
    leaves = dict(json.loads(meta.get("scalars", "{}")))
    leaves.update(tensors)
    tree: Dict[str, Any] = {}
    for key in sorted(leaves):
        parts = key.split(_SEP) if key else []
        if not parts:
            continue
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaves[key]
    return _typed(template, tree) if template is not None else tree
