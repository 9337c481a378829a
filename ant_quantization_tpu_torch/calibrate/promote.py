"""Mixed-precision promotion: set the highest-MSE quantizer pairs to
8 bits, the reference's ``set_8_bit_layer_n`` / ``set_8_bit_layer_l``.

Counterpart of the reference's ``calibrate/promote.py``, over the port's
quant tree (nested dicts whose sites hold ``weight_q`` and ``input_q``
QuantStates). Promotion is a pure transform of the tree:
- every state gets ``initialized=False`` (forces recalibration);
- the last two sites are always promoted;
- the top (n - 2) of the other sites by summed pair MSE are promoted (a
  stable argsort of -mse).
The caller then runs one calibration pass; a state with ``bit >= 8``
recalibrates at 8 bits (``nn/layers.py``).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .spec import QuantState

__all__ = ["quant_sites", "set_8_bit_layer_n", "set_8_bit_layer_l",
           "promoted_site_paths"]


def _natural_key(path: Tuple[str, ...]):
    return [tuple(int(t) if t.isdigit() else t
                  for t in re.split(r"(\d+)", comp) if t) for comp in path]


def quant_sites(quant_tree: Dict[str, Any]
                ) -> List[Tuple[Tuple[str, ...], Dict[str, QuantState]]]:
    """Ordered (path, {'weight_q', 'input_q'}) sites: a natural sort over
    module paths, the model's definition order for models whose
    submodules are named in that order (all of these are)."""
    sites = []

    def walk(node, path):
        if isinstance(node, dict):
            if isinstance(node.get("weight_q"), QuantState):
                sites.append((path, node))
                return
            for k, v in node.items():
                walk(v, path + (k,))

    walk(dict(quant_tree), ())
    sites.sort(key=lambda s: _natural_key(s[0]))
    return sites


def _rebuild(quant_tree, updates):
    def walk(node, path):
        if isinstance(node, dict):
            if path in updates:
                return {**node, **updates[path]}
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return node

    return walk(dict(quant_tree), ())


def _reset_all(sites):
    return {path: {k: v.replace(initialized=torch.tensor(
        False, device=v.initialized.device))
        for k, v in st.items() if isinstance(v, QuantState)}
        for path, st in sites}


def _promote(updates, path):
    updates[path] = {k: v.replace(bit=torch.tensor(8, dtype=torch.int32,
                                                   device=v.bit.device))
                     for k, v in updates[path].items()}


def set_8_bit_layer_n(quant_tree, n: int):
    """Promote the last 2 sites and the (n - 2) highest-MSE other sites;
    returns the new tree (run a calibration pass afterwards)."""
    if n <= 0:
        raise ValueError(f"n must be positive, got {n}")
    sites = quant_sites(quant_tree)
    updates = _reset_all(sites)
    for path, _ in (sites[-2:] if len(sites) >= 2 else sites):
        _promote(updates, path)
    body = sites[: max(0, len(sites) - 2)]
    pair_mse = np.array([
        sum(float(v.mse) for v in st.values() if isinstance(v, QuantState))
        for _, st in body])
    take = n - 2
    if take > 0 and len(body):
        for i in np.argsort(-pair_mse, kind="stable")[:take]:
            _promote(updates, body[i][0])
    return _rebuild(quant_tree, updates)


def set_8_bit_layer_l(quant_tree, layer_list):
    """Promote an explicit list of site indices (a list, or a
    comma-separated string; "None" promotes nothing)."""
    if isinstance(layer_list, str):
        if layer_list == "None":
            return quant_tree
        layer_list = [int(t) for t in layer_list.split(",")]
    sites = quant_sites(quant_tree)
    updates = _reset_all(sites)
    for i in layer_list:
        _promote(updates, sites[i][0])
    return _rebuild(quant_tree, updates)


def promoted_site_paths(quant_tree) -> List[Tuple[str, ...]]:
    return [path for path, st in quant_sites(quant_tree)
            if any(int(v.bit) >= 8 for v in st.values()
                   if isinstance(v, QuantState))]
