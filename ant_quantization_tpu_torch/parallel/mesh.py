"""Device mesh and sharding rules for the LM family.

Counterpart of the reference's ``parallel/mesh.py``. A (dp, tp) mesh is
a ``torch.distributed.device_mesh.DeviceMesh`` over the world's ranks:
data parallel over "dp", Megatron-style tensor parallel over "tp" (q, k,
v, qkv and fc_in column parallel, out and fc_out row parallel, the
embeddings split along the model dimension). The rules are the
reference's, as data, with the port's own :class:`PartitionSpec`; they
decide what each rank stores. :func:`shard_pytree` gives a rank its
local shard of every leaf. Where the reference leaves the collectives to
GSPMD, the port's forward makes them itself
(``TransformerLM(..., tp_group=)``, the engine's ``forward(...,
tp_group=)``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import distributed

__all__ = ["PartitionSpec", "P", "make_mesh", "LM_PARAM_RULES",
           "LM_QUANT_RULES", "spec_for_path", "shard_pytree",
           "lm_batch_spec", "local_shard", "axis_size", "axis_index",
           "axis_group"]


class PartitionSpec(tuple):
    """One entry per tensor dimension: a mesh axis name, a tuple of them,
    or None (not split). Compares equal to any tuple of the same
    entries."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(tuple(self))


P = PartitionSpec


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              axis_names: Tuple[str, ...] = ("dp", "tp")):
    """A mesh of ``shape`` over the world's ranks, in rank order (default:
    every rank on "tp"); the world must be initialized
    (``parallel.distributed``)."""
    import torch.distributed as dist
    if shape is None:
        shape = (1, dist.get_world_size())
    return distributed.device_mesh(shape, axis_names)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis``."""
    return mesh.get_group(axis)


# (regex over the 'a/b/c' param path, PartitionSpec): first match wins
LM_PARAM_RULES = [
    (r"wte/embedding", P(None, "tp")),
    (r"wpe/embedding", P(None, "tp")),
    (r"attn/(qkv|q|k|v)/kernel", P(None, "tp")),     # column parallel
    (r"attn/(qkv|q|k|v)/bias", P("tp")),
    (r"attn/(out|out_proj)/kernel", P("tp", None)),  # row parallel
    (r"fc_in/kernel", P(None, "tp")),
    (r"fc_in/bias", P("tp")),
    (r"fc_out/kernel", P("tp", None)),
    (r"mlp_1/kernel", P(None, "tp")),
    (r"mlp_1/bias", P("tp")),
    (r"mlp_2/kernel", P("tp", None)),
    (r"lm_head/kernel", P(None, "tp")),
    (r".*", P()),                                     # LN, biases
]

# per-channel alpha follows a column-parallel kernel's output split;
# grids and scalars are replicated
LM_QUANT_RULES = [
    (r"attn/(qkv|q|k|v)/weight_q/alpha", P("tp")),
    (r"fc_in/weight_q/alpha", P("tp")),
    (r"mlp_1/weight_q/alpha", P("tp")),
    (r".*", P()),
]


def spec_for_path(path: str, rules) -> PartitionSpec:
    for pat, spec in rules:
        if re.search(pat, path):
            return spec
    return P()


def _clip_spec(spec: PartitionSpec, ndim: int) -> PartitionSpec:
    if len(spec) > ndim:
        return P(*spec[:ndim]) if ndim else P()
    return spec


def lm_batch_spec() -> PartitionSpec:
    return P("dp", None)


def local_shard(x: torch.Tensor, mesh, spec: Sequence) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec``: each dimension split in
    equal parts over its axes (several axes: row-major over them), the
    part at this rank's coordinates. A contiguous copy."""
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes = axes if isinstance(axes, tuple) else (axes,)
        n, i = 1, 0
        for a in axes:
            s = axis_size(mesh, a)
            n, i = n * s, i * s + axis_index(mesh, a)
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"split in {n} over {axes}")
        x = x.chunk(n, dim=dim)[i]
    return x.clone(memory_format=torch.contiguous_format)


def shard_pytree(tree, mesh, rules, device=None):
    """This rank's local shard of every leaf of a nested-dict tree, by the
    first rule that matches its path, on ``device`` (default: the rank's
    device, else where the leaf is). Leaves that are dataclasses (a
    ``QuantState``) are split field by field, with the field name
    appended to the path."""
    dev = device if device is not None else distributed.rank_device()

    def put(leaf, path):
        t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(
            np.asarray(leaf))
        spec = _clip_spec(spec_for_path(path, rules), t.ndim)
        t = local_shard(t.detach(), mesh, spec)
        return t.to(dev) if dev is not None else t

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, prefix + (k,)) for k, v in node.items()}
        path = "/".join(prefix)
        if dataclasses.is_dataclass(node):
            return dataclasses.replace(node, **{
                f.name: put(getattr(node, f.name), f"{path}/{f.name}")
                for f in dataclasses.fields(node)})
        return put(node, path)

    return walk(tree, ())
