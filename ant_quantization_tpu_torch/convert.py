"""Carry engine, model and quantizer state across from the JAX reference.

``from_jax_quant`` takes the reference's quant collection (its
``QuantState`` leaves fetched with ``np.asarray``) and returns the port's
tree of :class:`~.calibrate.spec.QuantState` (same keys,
``h_{i}/attn/{q,k,v,qkv,out}|{fc_in,fc_out}/{weight_q,input_q}``);
``from_jax_lm_params`` takes a reference model's params tree and
returns the port's state dict for the same model (the flax path joined
by dots; every leaf keeps its layout, the kernels (in, out) as there):
the port's modules carry the flax names, so the one function serves
``TransformerLM`` and the BERT and BART heads alike;
``from_jax_image_params`` does the same for an image model's params and
``batch_stats`` (ResNet, VGG, AlexNet, ViT, Inception-v3), its HWIO
convolution kernels turned OIHW.
``from_jax_engine_params`` takes the reference's engine-params tree (as
its ``serve/engine.py:build_engine_params`` makes it, leaves fetched with
``np.asarray``) and returns the port's tensors and layouts;
``from_jax_kv`` does the same for the reference's stacked cache (INT8,
or the raw bf16 / f32 baseline cache), so both engines can start from
the same state. Only numpy crosses over: this
module imports nothing of the reference package.

Layouts that change:
- weight stacks ``w_i8`` (L, K, N) -> the port's N-major (L, N, K), for
  int8 codebook values and OVP bytes (``ovp``) alike, at every site
  (a fused ``qkv`` too), and so the dense "bf16" ``kernel`` stacks, in
  their dtype;
- "w4pack" stacks ``packed`` (L, K/2, N) -> (L, N, K/2), the same bytes
  (each still holds rows i and i + K/2 of one column); a per-layer
  ``scale`` or ``oscale`` given for the whole row (L, 1) is broadcast to
  (L, N), the same values;
- ``a_q`` int8 -> f32 (the kernel's operand type; same values);
- every other site leaf (``oscale``, a GPT-2 Conv1D site's ``kscale``
  (L, K), ``bias``, ``ovp``, ``a_grid``,
  ``a_alpha``, ``a_out``, the ``aovp_*`` tables of K4, and "w4pack"'s
  ``grid``, ``q16`` and ``affine4``) keeps its values and dtype;
- "w4pack" sites gain K8's term tables ``k8_terms`` and ``k8_unit``,
  made from each layer's ``grid`` as ``build_engine_params`` makes them;
- KV codes (L, B, H, S/f, f*D) lane-folded -> flat (L, B, H, S, D), and
  plane-major scales (L, B, H, f, S/f) -> (L, B, H, S), by position: the
  reference folds f = 128 / head_dim positions into a row at head_dim
  64 (f = 2, GPT-2) and 32, and keeps head_dim 80 and 128 flat (f = 1);
  a raw cache is flat already (f = 1) and keeps its dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch

from ._ext import resolve_device
from .calibrate.spec import QuantState
from .kernels.kv_cache import QuantKV
from .models.transformer_lm import ALL_SITES
from .serve.engine import k8_plan_leaves

__all__ = ["from_jax_engine_params", "from_jax_kv", "from_jax_quant",
           "from_jax_lm_params", "from_jax_image_params"]

def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes arrays: exact via f32
        return torch.tensor(a.astype(np.float32),
                            device=device).to(torch.bfloat16)
    return torch.tensor(a, device=device)


def from_jax_engine_params(tree: Dict, device=None) -> Dict:
    """The reference's engine params (numpy leaves) -> the port's, on
    ``device`` (default "cuda")."""
    dev = resolve_device(device)
    layers = {}
    for name, site in tree["layers"].items():
        if name in ("ln_1", "ln_2"):
            layers[name] = {k: _tensor(v, dev) for k, v in site.items()}
            continue
        if name not in ALL_SITES:
            raise ValueError(f"unknown site {name!r}")
        out = {k: _tensor(v, dev) for k, v in site.items()}
        for key in ("w_i8", "packed", "kernel"):
            if key in site:
                out[key] = _tensor(np.transpose(np.asarray(site[key]),
                                                (0, 2, 1)), dev)
        if "packed" in site:
            n = np.asarray(site["packed"]).shape[2]
            plans = [k8_plan_leaves(g, dev) for g in np.asarray(
                site["grid"], np.float32).reshape(-1, 16)]
            for key in ("k8_terms", "k8_unit"):
                out[key] = torch.stack([p[key] for p in plans])
            for key in ("scale", "oscale"):
                out[key] = _tensor(np.broadcast_to(
                    np.asarray(site[key], np.float32).reshape(
                        out[key].shape[0], -1), (out[key].shape[0], n)), dev)
        if "a_q" in site:
            out["a_q"] = _tensor(np.asarray(site["a_q"], np.float32), dev)
            out["a_scale"] = _tensor(
                np.asarray(site["a_scale"], np.float32).reshape(-1), dev)
        layers[name] = out
    top = {}
    for k, v in tree["top"].items():
        top[k] = ({kk: _tensor(vv, dev) for kk, vv in v.items()}
                  if isinstance(v, dict) else _tensor(v, dev))
    return {"layers": layers, "top": top}


def from_jax_kv(kv: Sequence, head_dim: int, device=None) -> QuantKV:
    """The reference's stacked cache ``(k, v, k_scale, v_scale)`` (numpy)
    -> the port's flat :class:`QuantKV` on ``device`` (default
    "cuda"). A lane-folded cache (f positions per row of f * head_dim
    codes, position p at row p // f, lanes [(p % f) D, (p % f + 1) D);
    its scales plane-major, p at [p % f, p // f]) is unfolded by
    position."""
    dev = resolve_device(device)
    k, v, ks, vs = (np.asarray(a) for a in kv)
    L, B, H = k.shape[:3]
    S = k.shape[3] * k.shape[4] // head_dim
    codes = lambda a: _tensor(a.reshape(L, B, H, S, head_dim), dev)
    # plane-major (.., f, S/f): position p sits at [p % f, p // f]
    scales = lambda a: _tensor(
        np.swapaxes(a, -1, -2).reshape(L, B, H, S).astype(np.float32), dev)
    return QuantKV(codes(k), codes(v), scales(ks), scales(vs))


def from_jax_quant(tree: Dict, device=None) -> Dict:
    """The reference's quant collection (nested dicts whose leaves are its
    QuantState with numpy fields) -> the port's tree of QuantState on
    ``device`` (default "cuda"), same keys, same values and dtypes."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return QuantState(**{f.name: _tensor(getattr(node, f.name), dev)
                             for f in dataclasses.fields(QuantState)})

    return walk(tree)


def from_jax_lm_params(params: Dict, device=None) -> Dict[str, torch.Tensor]:
    """A reference model's params tree (numpy leaves) -> the port's state
    dict of the same model (``TransformerLM``, or a BERT or BART head) on
    ``device`` (default "cuda")."""
    dev = resolve_device(device)
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                out[".".join(path + (k,))] = _tensor(v, dev)

    walk(params, ())
    return out


def from_jax_image_params(params: Dict, batch_stats: Dict = None,
                          device=None) -> Dict[str, torch.Tensor]:
    """A reference image model's params and batch_stats (numpy leaves) ->
    the port's state dict of the same model on ``device`` (default
    "cuda"): every 4-D ``kernel`` (HWIO) as OIHW, every other leaf as it
    is (dense kernels (in, out)); the running ``mean`` and ``var`` under
    their BatchNorm's path."""
    dev = resolve_device(device)
    out = from_jax_lm_params(params, device=dev)
    for k, v in out.items():
        if k.endswith("kernel") and v.ndim == 4:
            out[k] = v.permute(3, 2, 0, 1).contiguous()
    if batch_stats:
        out.update(from_jax_lm_params(batch_stats, device=dev))
    return out
