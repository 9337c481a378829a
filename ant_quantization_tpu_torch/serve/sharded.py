"""Tensor-parallel serving: the engine over a (dp, tp) mesh of ranks.

Counterpart of the reference's ``serve/sharded.py``, Megatron-style:

  q, k, v, qkv and fc_in  column parallel: each rank holds the weight
                          rows (the port's stacks are N-major) of its
                          heads or its d_ff slice
  out and fc_out          row parallel: each rank holds its K slice; the
                          partials are summed over "tp" before the bias
  KV cache                split by heads over "tp" (int8 codes and
                          scales), by batch over "dp"
  embeddings, LayerNorms  replicated

Each rank holds plain local tensors (:func:`shard_engine_params`,
:func:`shard_cache`) and runs ``engine.forward`` on them with its tp
group (:func:`make_sharded_forward`); the kernels run unchanged on the
local shapes.

A fused qkv stack concatenates [q | k | v] over all heads, so its rows
are permuted first (:func:`_qkv_permutation`) to give each rank [q_d |
k_d | v_d]. A "w4pack" row site is re-packed per shard: its split-K pack
pairs rows k and k + K/2 in one byte, which would straddle two ranks'
activation slices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..kernels.kv_cache import QuantKV
from ..parallel import distributed
from ..parallel.mesh import P, axis_group, axis_size, local_shard
from . import engine as eng

__all__ = ["tp_engine_config", "engine_param_specs", "shard_engine_params",
           "shard_cache", "cache_spec", "make_sharded_forward"]


def tp_engine_config(cfg: eng.EngineConfig, mesh,
                     tp_axis: str = "tp") -> eng.EngineConfig:
    tp = axis_size(mesh, tp_axis)
    if cfg.lm.n_heads % tp or cfg.lm.d_ff % tp:
        raise ValueError(f"{cfg.lm.n_heads} heads and d_ff {cfg.lm.d_ff} "
                         f"do not split over {tp} tp ranks")
    return dataclasses.replace(cfg, tp_axis=tp_axis, tp_size=tp)


def _qkv_permutation(d_model: int, tp: int) -> np.ndarray:
    """The row order that turns the global [q | k | v] stack into the
    per-shard [q_d | k_d | v_d] concatenation."""
    d_loc = d_model // tp
    rows = []
    for d in range(tp):
        for third in range(3):
            start = third * d_model + d * d_loc
            rows.append(np.arange(start, start + d_loc))
    return np.concatenate(rows)


def _site_specs(col: bool) -> Dict[str, P]:
    """The specs of one stacked (L, ...) site's leaves in the port's
    layouts: weight stacks (L, N, K) (packed (L, N, K/2)), per-channel
    leaves (L, N), Conv1D scales (L, K). Other leaves are replicated."""
    if col:
        return {"kernel": P(None, "tp", None), "w_i8": P(None, "tp", None),
                "packed": P(None, "tp", None), "scale": P(None, "tp"),
                "oscale": P(None, "tp"), "bias": P(None, "tp"),
                "kscale": P(None, None)}
    return {"kernel": P(None, None, "tp"), "w_i8": P(None, None, "tp"),
            "packed": P(None, None, "tp"), "scale": P(None, None),
            "oscale": P(None, None), "bias": P(None, None),
            "kscale": P(None, "tp")}


def engine_param_specs(cfg: eng.EngineConfig) -> Dict:
    """Spec tree of ``build_engine_params``' output (leaves not named are
    replicated)."""
    layers = {site: _site_specs(col=site not in ("out", "fc_out"))
              for site in eng._site_names(cfg.lm)}
    return {"layers": layers, "top": {}}


def _repack_w4_row_shards(packed: torch.Tensor, tp: int) -> torch.Tensor:
    """A split-K packed (L, N, K/2) stack re-packed so that each of the tp
    contiguous byte ranges along the last axis is the split-K pack of its
    own K_loc = K / tp rows: after the split, rank d holds
    pack(codes[..., d K_loc:(d + 1) K_loc])."""
    lo, hi = packed & 0xF, packed >> 4
    codes = torch.cat([lo, hi], dim=-1)                       # (L, N, K)
    k_loc = codes.shape[-1] // tp
    chunks = []
    for d in range(tp):
        c = codes[..., d * k_loc:(d + 1) * k_loc]
        chunks.append(c[..., :k_loc // 2] | (c[..., k_loc // 2:] << 4))
    return torch.cat(chunks, dim=-1).to(torch.uint8)


def shard_engine_params(ep: Dict, cfg: eng.EngineConfig, mesh,
                        device=None) -> Dict:
    """This rank's engine params: fused-qkv rows permuted per shard, the
    "w4pack" row sites re-packed per shard, then every leaf split by
    :func:`engine_param_specs`; on ``device`` (default the rank's
    device, else where the leaves are)."""
    tp = cfg.tp_size
    dev = device if device is not None else distributed.rank_device()
    specs = engine_param_specs(cfg)["layers"]
    perm = None
    if cfg.lm.fused_qkv and tp > 1:
        perm = torch.as_tensor(_qkv_permutation(cfg.lm.d_model, tp))
    layers = {}
    for name, site in ep["layers"].items():
        spec = specs.get(name, {})
        out = {}
        for key, t in site.items():
            if perm is not None and name == "qkv" and key in (
                    "kernel", "w_i8", "packed", "bias", "oscale", "scale"):
                t = t[:, perm.to(t.device)]
            if key == "packed" and tp > 1 and name in ("out", "fc_out"):
                t = _repack_w4_row_shards(t, tp)
            s = spec.get(key, P())
            t = local_shard(t, mesh, tuple(s)[:t.ndim])
            out[key] = t.to(dev) if dev is not None else t
        layers[name] = out
    top = _to(ep["top"], dev)
    return {"layers": layers, "top": top}


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev) if dev is not None else tree


def cache_spec() -> P:
    """The stacked cache's leaves (L, B, H, S[, D]): batch over "dp", heads
    over "tp"."""
    return P(None, "dp", "tp")


def shard_cache(kv: QuantKV, mesh, device=None) -> QuantKV:
    """This rank's (L, B / dp, H / tp, S[, D]) block of a full cache."""
    dev = device if device is not None else distributed.rank_device()
    names = set(mesh.mesh_dim_names)
    spec = tuple(a if a is None or a in names else None
                 for a in cache_spec())
    out = []
    for t in kv:
        t = local_shard(t, mesh, spec)
        out.append(t.to(dev) if dev is not None else t)
    return QuantKV(*out)


def make_sharded_forward(cfg: eng.EngineConfig, mesh):
    """``fwd(ep_local, ids_local, kv_local, pos0, last_index=None) ->
    (logits, kv)``: ``engine.forward`` on this rank's shards with its tp
    group. ``ids_local`` are this rank's batch rows (its "dp" block);
    ``pos0`` and ``last_index`` an int or one value per local row. The
    logits are those rows', the same on every rank of the tp group.
    ``cfg`` must come from :func:`tp_engine_config`."""
    if not cfg.tp_axis:
        raise ValueError("make_sharded_forward takes a tp_engine_config")
    group = axis_group(mesh, cfg.tp_axis)

    def fwd(ep, ids, kv, pos0, last_index=None):
        return eng.forward(cfg, ep, ids, kv, pos0, last_index=last_index,
                           tp_group=group)

    return fwd
