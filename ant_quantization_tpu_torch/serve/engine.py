"""Quantized serving engine for the decoder LM family, main path.

Counterpart of the reference's ``serve/engine.py`` for the weight modes
"w4" (4-bit weights stored as int8 bytes), "w4pack" (4-bit codes packed
two to a byte) and "bf16" (dense weights in ``cfg.dtype``, the
unquantized baseline), the INT8 and the bf16 KV cache (``kv_int8``) and
the int8 and the plain lm_head: prefill and greedy decode, with a write
position shared by the batch or one per sequence (a bucket-padded batch
of ragged prompts). The OPT geometry (split q/k/v, learned positions),
the BLOOM geometry (fused qkv, the embedding LayerNorm, ALiBi) and the
GPT-2 geometry (fused qkv, learned positions, Conv1D sites quantized per
input channel) are served. Both halves of the system are served:

- ANT: weights as int8 codebook values ("w4") or packed codes
  ("w4pack"), activations snapped onto an int8-exact codebook (``a_q``);
  both also serve without activation quantization (``act_bits=0``,
  W4A16), and "bf16" with the activation fake-quant alone;
- OliVe: outlier-victim pairs (OVP). Under "w4", weights with outliers
  take the sign-offset OVP byte encoding (``ovp``) and activations with
  outliers carry per-layer concat-snap tables (``aovp_*``). "w4pack"
  cannot hold outlier weights (it raises) and fake-quantizes outlier
  activations.

Routing follows the reference (``_prepare_stacked``):
- decode-size matmuls (M = B*T <= ``stacked_max_m``) run a stacked
  kernel (``kernels/stacked.py``): K4 at sites with aovp tables, K3 at
  OVP-weight sites with ``a_q``, K1 at the other "w4" sites, K6 at
  "w4pack" sites with ``a_q``. The rule is all-or-nothing: one site with
  neither ``a_q`` nor aovp tables, or a Conv1D site (``kscale``), sends
  every site of the step to the unfused route;
- prefill-size matmuls under "w4" run plain torch ops: with ``a_q``, a
  midpoint snap of ``x / a_scale`` and int8 x int8 -> int32 library
  products (two for OVP weights, combined as 16 a - 15 b in f32);
  without it (OVP activations, inexact grids), the activation fake-quant
  and an f32 product of the ``mm_dtype``-rounded operands against the
  decoded weight values, as the reference leaves them to XLA. With
  ``stacked_prefill`` the sites with ``a_q`` run the stacked kernel
  instead (K5 above 256 rows, else K1/K3) and the others keep the torch
  route, site by site;
- the unfused "w4pack" route (prefill, and decode when the rule above
  fails) fake-quantizes the activation in ``cfg.dtype`` and runs K8
  (``kernels/qmatmul.py``) on it, an f32-exact product against the grid
  values;
- a Conv1D site under "w4" (``kscale``, GPT-2) takes, at every M, the
  activation fake-quant and an f32 product against its dequantized f32
  weight (``w_i8`` or the OVP values times ``kscale`` along K), as the
  reference leaves it to XLA;
- "bf16" sites (the reference's plain XLA dot, no kernel there either)
  run the activation fake-quant where there is one and a library product
  of ``cfg.dtype`` operands with an f32 result (``f32_out_product``), at
  every M; so does "w4" without ``a_q``, against the int8 values;
- attention takes the reference's route at every shape
  (:func:`attention_route`): on the INT8 cache K2
  (``kernels/attention.py``, one launch per layer for any T) while one
  head's tile fits the reference's budget; past it (a long cache) K7 for
  up to 16 queries on a flat cache, else the reference's dequantizing
  fallback as torch ops. The bf16 cache always takes that einsum, read
  raw.

On a CUDA device the kernels run and nothing else; on the CPU their plain
versions run. Features of the reference engine that this slice does not
port raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .._ext import resolve_device
from ..kernels.attention import (K7_MAX_T, _rel, int8_kv_attention,
                                 stacked_int8_kv_attention)
from ..kernels.kv_cache import (QuantKV, append_kv_stacked, dequant_kv,
                                init_kv)
from ..kernels.qmatmul import (f32_out_product, f32_product,
                               int8_codebook, int8_matmul, ovp_clip,
                               ovp_decode_values, ovp_encode_scalar, ovp_unit,
                               quantize_weights_ovp_i8, quantize_weights_w4,
                               quantize_weights_w4_i8, quantized_matmul_w4,
                               tf32_off, w4_term_plan)
from ..kernels.stacked import (stacked_quant_matmul,
                               stacked_quant_matmul_aovp,
                               stacked_quant_matmul_p4)
from ..models.transformer_lm import (ALL_SITES, LMConfig, alibi_slopes,
                                     conv1d_site_names)
from ..ops.ovp import apply_ovp
from ..ops.snap import snap_concat, snap_value

__all__ = ["EngineConfig", "quantize_lm_head", "quantize_activation",
           "quantize_activation_ovp", "weight_entry", "packed_weight_entry",
           "k8_plan_leaves", "act_entry", "stack_entries",
           "build_engine_params", "forward", "init_cache", "Engine",
           "attention_route", "params_device"]

_ATTN_SITES = ("qkv", "q", "k", "v", "out")
# the reference's VMEM budget for one head's tile of its stacked attention
# kernel (engine.py:_attention_stacked): a TPU rule, kept so that the port
# routes attention exactly as the reference does (ROADMAP Queue 2, K2)
_TILE_BUDGET = 6 * 2 ** 20
_AOVP_KEYS = ("aovp_mids", "aovp_ties", "aovp_enc", "aovp_unit")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The reference's EngineConfig, field for field. ``interpret``,
    ``block_n`` and ``stacked_block_n`` are Pallas settings and have no
    effect here. ``stacked_block_k`` does: it sets the f32 combine
    partition of K3 and K4 (their int32 partial sums are converted and
    added in f32 per block of that many K rows), so it is part of their
    numbers, as in the reference."""
    lm: LMConfig
    weight_mode: str = "w4"        # "w4", "w4pack" or "bf16"
    act_bits: int = 0              # 0 = no activation quant, else 4/8
    kv_int8: bool = True
    lm_head_int8: bool = False
    max_seq: int = 2048
    block_n: int = 512
    dtype: Any = torch.bfloat16
    interpret: bool = False
    # decode-size matmuls (M = B*T <= stacked_max_m) run the stacked
    # kernels (K1, K3, K4; K6 under "w4pack")
    stacked_kernel: bool = True
    stacked_max_m: int = 64
    stacked_block_n: int = 4096
    stacked_block_k: int = 1024
    # "w4" prefill-size sites with a_q run the stacked kernels (K5 above
    # 256 rows, K1/K3 below), the others the torch route
    stacked_prefill: bool = False
    tp_axis: Optional[str] = None
    tp_size: int = 1
    sp_prefill: bool = True


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch engine yet (ROADMAP Queue 1 "
        f"item {item})")


def _check_config(cfg: EngineConfig) -> None:
    c = cfg.lm
    if cfg.weight_mode not in ("w4", "w4pack", "bf16"):
        raise ValueError(f"unknown weight_mode {cfg.weight_mode!r}")
    if cfg.tp_axis is not None or cfg.tp_size != 1:
        raise _not_ported("tensor parallelism", "12")
    if c.activation not in ("relu", "gelu", "gelu_new"):
        raise ValueError(f"unknown activation {c.activation!r}")


def _site_names(c: LMConfig) -> tuple:
    """The matmul sites of one layer, as the reference names them."""
    return (("qkv",) if c.fused_qkv else ("q", "k", "v")) + (
        "out", "fc_in", "fc_out")


def _field(state, name: str) -> np.ndarray:
    """A quantizer state's field, from a mapping or an object, as numpy
    (a tensor on any device is fetched: the fields are small)."""
    v = state[name] if isinstance(state, dict) else getattr(state, name)
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def _f32(v, dev: torch.device) -> torch.Tensor:
    """A float leaf of the params tree as an f32 tensor on ``dev``: a
    tensor is moved (and stays where it is when it is there already),
    numpy is copied over."""
    if isinstance(v, torch.Tensor):
        return v.detach().to(device=dev, dtype=torch.float32)
    return torch.tensor(np.asarray(v, np.float32), device=dev)


def _const(like: torch.Tensor, value: float) -> torch.Tensor:
    # a tensor on the operand's device: CUDA turns a division by a Python
    # scalar into a multiply by its reciprocal
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def quantize_lm_head(wte: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-vocab-row int8 quantization of the tied embedding:
    wte (V, D) f32 -> {"wte_i8": (V, D) int8, "wte_scale": (V,) f32}."""
    wte = wte.to(torch.float32)
    s = torch.clamp(wte.abs().amax(dim=1), min=1e-12) / _const(wte, 127.0)
    w_i8 = torch.clamp(torch.round(wte / s[:, None]), -127, 127)
    return {"wte_i8": w_i8.to(torch.int8), "wte_scale": s}


def quantize_activation(x: torch.Tensor, grid16: torch.Tensor,
                        alpha: torch.Tensor) -> torch.Tensor:
    """Per-tensor activation fake-quant onto a sorted grid, in x's dtype
    (the unfused route of grids without an int8-exact codebook)."""
    scale = (alpha / grid16.max()).to(x.dtype)
    return snap_value(x / scale, grid16) * scale


def quantize_activation_ovp(x: torch.Tensor, grid16: torch.Tensor,
                            out16: torch.Tensor,
                            alpha: torch.Tensor) -> torch.Tensor:
    """OliVe activation fake-quant: snap onto the unsorted grid || outlier
    concat (in f32), zero each outlier's pair neighbour along the feature
    axis, rescale, back to x's dtype."""
    scale = (alpha / grid16.max()).to(torch.float32)
    full = torch.cat([grid16.to(torch.float32), out16.to(torch.float32)])
    q, _ = snap_concat(x.to(torch.float32) / scale, full)
    q = apply_ovp(q, pair_axis=-1)
    return (q * scale).to(x.dtype)


def _aovp_encode_tables(a_grid: np.ndarray, a_out16: np.ndarray, u_a: float,
                        device: torch.device) -> Dict[str, torch.Tensor]:
    """Per-layer tables of K4: the sorted grid || outlier concat's
    midpoints, its tie-to-the-later-entry flags, and the sign-offset byte
    of each sorted entry."""
    av = np.concatenate([np.asarray(a_grid, np.float64),
                         np.asarray(a_out16, np.float64)])
    order = np.argsort(av, kind="stable")
    sg = av[order]
    ties = (order[1:] >= order[:-1]).astype(np.int32)
    mids = ((sg[1:] + sg[:-1]) * 0.5).astype(np.float32)
    thr = float(np.max(np.abs(np.asarray(a_grid))))
    encs = np.asarray([ovp_encode_scalar(v, u_a, thr) for v in sg],
                      np.float32)
    t = lambda a: torch.as_tensor(a, device=device)
    return {"aovp_mids": t(mids), "aovp_ties": t(ties), "aovp_enc": t(encs),
            "aovp_unit": t(np.float32(u_a))}


def _site_node(tree: Dict, site: str):
    return tree["attn"][site] if site in _ATTN_SITES else tree[site]


def weight_entry(kernel: torch.Tensor, wq, ovp: bool,
                 conv1d: bool = False) -> Dict:
    """One site-layer's weight leaves from its (K, N) f32 kernel (on the
    device the leaves go to) and its weight quantizer state: the OVP
    encoding when the site has outliers in any layer (``ovp``), else int8
    codebook values; ``w_i8`` in the port's (N, K) layout. A Linear site
    is scaled per output channel (``oscale`` (N,)); a GPT-2 Conv1D site
    (``conv1d``) per input channel with its OVP pairs along the output
    axis, as the reference quantizes it, and keeps ``kscale`` (K,), which
    runs along the last axis of ``w_i8``."""
    axis, pair_axis, key = (0, 1, "kscale") if conv1d else (1, 0, "oscale")
    e = {}
    if ovp:
        w_i8, scale = quantize_weights_ovp_i8(
            kernel, _field(wq, "grid"), _field(wq, "outliers"),
            _field(wq, "alpha"), pair_axis=pair_axis, axis=axis)
        e["ovp"] = torch.zeros((), dtype=torch.int32, device=kernel.device)
    else:
        w_i8, scale = quantize_weights_w4_i8(kernel, _field(wq, "grid"),
                                             _field(wq, "alpha"), axis=axis)
    e["w_i8"], e[key] = w_i8.t().contiguous(), scale
    return e


def packed_weight_entry(kernel: torch.Tensor, wq) -> Dict:
    """One site-layer's "w4pack" leaves from its (K, N) f32 kernel and its
    weight quantizer state: ``packed`` (N, K/2) uint8 split-K codes,
    ``scale`` = alpha / max(grid), the f32 ``grid`` and its bf16 term
    table ``k8_terms`` with ``k8_unit`` (K8's operands,
    ``kernels/qmatmul.py:w4_term_plan``), ``q16`` its int8 values (int32)
    and ``oscale`` = scale * their unit (K6's operands)."""
    dev = kernel.device
    g16 = np.asarray(_field(wq, "grid"), np.float32).reshape(-1)[:16]
    packed, scale = quantize_weights_w4(kernel, g16, _field(wq, "alpha"))
    q16, w_unit, _ = int8_codebook(g16)
    return {"packed": packed, "scale": scale,
            "grid": torch.as_tensor(g16.copy(), device=dev),
            "q16": torch.as_tensor(q16.astype(np.int32), device=dev),
            "oscale": scale * torch.tensor(np.float32(w_unit), device=dev),
            **k8_plan_leaves(g16, dev)}


def k8_plan_leaves(g16: np.ndarray, device) -> Dict[str, torch.Tensor]:
    """K8's term table of one layer's grid, decided once on the host and
    kept with the stack: ``k8_terms`` (3, 16) f32 and ``k8_unit`` ()."""
    tab, unit, _ = w4_term_plan(g16)
    return {"k8_terms": torch.as_tensor(tab, device=device),
            "k8_unit": torch.tensor(np.float32(unit), device=device)}


def act_entry(cfg: EngineConfig, aq, ovp: bool,
              device: torch.device) -> Dict:
    """One site-layer's activation leaves from its input quantizer state:
    the grid and alpha, plus the outlier grid and, where it has an exact
    sign-offset unit, K4's tables (``ovp``: the site has activation
    outliers in any layer), or else the int8-exact codebook ``a_q`` and
    its scale where the grid has one. K4's tables belong to "w4" only;
    "bf16" takes neither (it serves the fake-quant alone)."""
    t = lambda a: torch.as_tensor(a, device=device)
    a_grid = np.asarray(_field(aq, "grid"), np.float32).reshape(
        -1)[:2 ** cfg.act_bits]
    a_alpha = np.asarray(_field(aq, "alpha"), np.float32).reshape(())
    e = {"a_grid": t(a_grid.copy()), "a_alpha": t(a_alpha.copy())}
    if ovp:
        a_out16 = np.asarray(_field(aq, "outliers"),
                             np.float32).reshape(-1)[:16]
        e["a_out"] = t(a_out16.copy())
        u_a, exact_a = ovp_unit(a_grid, a_out16)
        if exact_a and cfg.weight_mode == "w4":
            e.update(_aovp_encode_tables(a_grid, a_out16, u_a, device))
        return e
    if cfg.weight_mode == "bf16":
        return e
    a_q16, a_unit, a_exact = int8_codebook(a_grid)
    if a_exact:
        # the SIGNED max, as the reference quantizer scales
        a_scale = a_alpha / np.float32(np.max(a_grid)) * np.float32(a_unit)
        e["a_q"] = t(a_q16.astype(np.float32))
        e["a_scale"] = t(np.float32(a_scale))
    return e


def stack_entries(site: str, es: list) -> Dict[str, torch.Tensor]:
    """A site's per-layer entries stacked over layers. K4's tables must be
    there for every layer (the stack shares keys): otherwise they are
    dropped and the site takes the unfused route. A "w4pack" site whose
    q16 is arange(16) - 8 in every layer gets the ``affine4`` marker (K6
    then decodes ``code - 8``)."""
    if not all("aovp_enc" in e for e in es):
        for e in es:
            for k in _AOVP_KEYS:
                e.pop(k, None)
    keys = list(es[0])
    if any(list(e) != keys for e in es):
        raise ValueError(f"site {site!r}: layers quantize differently (an "
                         "int8-exact activation grid in some layers only); "
                         "they cannot be stacked")
    out = {k: torch.stack([e[k] for e in es]) for k in keys}
    if "q16" in out:
        aff16 = torch.arange(16, dtype=torch.int32, device=out["q16"].device)
        if torch.equal(out["q16"], (aff16 - 8).expand(len(es), 16)):
            out["affine4"] = torch.zeros(len(es), dtype=torch.int32,
                                         device=aff16.device)
    return out


def build_engine_params(cfg: EngineConfig, params: Dict,
                        quant: Optional[Dict] = None, device=None) -> Dict:
    """Per-layer float weights + calibrated quantizer states -> stacked
    engine params on ``device`` (default "cuda").

    ``params`` mirrors the reference model's tree
    (``h_{i}/attn/{q,k,v,out}/{kernel,bias}``, or ``h_{i}/attn/qkv`` for
    a fused qkv, ``h_{i}/{fc_in,fc_out}``, ``h_{i}/{ln_1,ln_2}``,
    ``wte/embedding``, ``wpe/embedding`` for learned positions,
    ``embed_ln`` for BLOOM, ``ln_f``); ``quant`` holds, per site,
    ``weight_q`` and ``input_q`` states with ``grid``, ``alpha`` and
    ``outliers``. Leaves are numpy arrays or tensors on any device (the
    port's ``TransformerLM`` gives ``models.transformer_lm.params_tree``,
    its calibration the quant tree): weights on ``device`` stay there,
    others are copied to it; the states' small leaves are read on the
    host. The result's
    site leaves equal the reference's bit for bit (``w_i8`` transposed to
    the port's (L, N, K) layout, ``a_q`` as f32).

    As in the reference, OVP is decided per site: if any layer's weight
    state has outliers, every layer of the site is OVP-encoded
    (``ovp``); if any layer's input state has outliers, every layer
    fake-quantizes with them (``a_out``) and, when each layer's concat
    grid has an exact sign-offset unit, carries K4's tables.

    GPT-2's Conv1D sites (``conv1d_sites``) are quantized per input
    channel under "w4" and keep ``kscale`` (L, K) in place of ``oscale``
    (``weight_entry``); their activation leaves are built as at any site.

    "w4pack" packs every site (``packed_weight_entry``; ``packed`` in the
    port's (L, N, K/2) layout) and marks a site ``affine4`` when every
    layer's q16 is arange(16) - 8. It raises ``ValueError`` on weight
    outliers and on Conv1D sites, as the reference does. With
    ``act_bits=0`` no activation leaves are built.

    "bf16" keeps each site's dense ``kernel`` in ``cfg.dtype``, in the
    port's (L, N, K) layout, and needs ``quant`` only for activation
    quantization (``a_grid``, ``a_alpha`` and ``a_out``; without
    ``quant`` it builds none, as the reference). Its Conv1D sites need no
    per-input-channel scale and are served.
    """
    dev = resolve_device(device)
    _check_config(cfg)
    dense = cfg.weight_mode == "bf16"
    if quant is None and not dense:
        raise ValueError(f"weight_mode {cfg.weight_mode!r} needs the "
                         "quantizer states (quant)")
    c = cfg.lm
    sites = _site_names(c)
    conv1d = conv1d_site_names(c)
    site_ovp = dict.fromkeys(sites, False)
    site_act_ovp = dict.fromkeys(sites, False)
    for i in range(c.n_layers if quant is not None else 0):
        for site in sites:
            qn = _site_node(quant[f"h_{i}"], site)
            site_ovp[site] |= bool(np.any(_field(qn["weight_q"], "outliers")))
            site_act_ovp[site] |= bool(
                np.any(_field(qn["input_q"], "outliers")))
    packed = cfg.weight_mode == "w4pack"
    entries: Dict[str, list] = {s: [] for s in sites}
    lns: Dict[str, Dict[str, list]] = {
        n: {"scale": [], "bias": []} for n in ("ln_1", "ln_2")}
    for i in range(c.n_layers):
        p = params[f"h_{i}"]
        q = None if quant is None else quant[f"h_{i}"]
        for n in lns:
            for k in ("scale", "bias"):
                lns[n][k].append(_f32(p[n][k], dev))
        for site in sites:
            if site in conv1d and packed:
                raise ValueError(
                    "w4pack assumes per-output-channel scales; GPT-2 "
                    "Conv1D sites are per-input-channel and serve under "
                    "weight_mode='w4'")
            if packed and site_ovp[site]:
                raise ValueError(
                    "w4pack cannot represent OliVe outlier grids (abfloat "
                    "values exceed the 16-entry pack); use "
                    "weight_mode='w4', whose OVP encoding serves them")
            node = _site_node(p, site)
            qn = None if q is None else _site_node(q, site)
            kernel = _f32(node["kernel"], dev)
            e = {"bias": (_f32(node["bias"], dev) if "bias" in node else
                          torch.zeros(kernel.shape[1], device=dev))}
            if dense:
                e["kernel"] = kernel.t().contiguous().to(cfg.dtype)
            elif packed:
                e.update(packed_weight_entry(kernel, qn["weight_q"]))
            else:
                e.update(weight_entry(kernel, qn["weight_q"],
                                      site_ovp[site], site in conv1d))
            if cfg.act_bits and qn is not None:
                e.update(act_entry(cfg, qn["input_q"], site_act_ovp[site],
                                   dev))
            entries[site].append(e)
    out_layers = {site: stack_entries(site, es)
                  for site, es in entries.items()}
    for n, d in lns.items():
        out_layers[n] = {k: torch.stack(v) for k, v in d.items()}
    wte = _f32(params["wte"]["embedding"], dev)
    # the engine owns its leaves: copies, never views of the model's
    top = quantize_lm_head(wte) if cfg.lm_head_int8 else {
        "wte": wte.to(cfg.dtype, copy=True)}
    for name in ("ln_f", "embed_ln"):
        if name in params:
            top[name] = {k: _f32(params[name][k], dev).clone()
                         for k in ("scale", "bias")}
    if "wpe" in params:
        top["wpe"] = _f32(params["wpe"]["embedding"], dev).to(cfg.dtype,
                                                               copy=True)
    return {"layers": out_layers, "top": top}


def _embed(top: Dict, ids: torch.Tensor, dtype) -> torch.Tensor:
    if "wte_i8" in top:
        return (top["wte_i8"][ids].to(dtype)
                * top["wte_scale"][ids][..., None].to(dtype))
    return top["wte"][ids]


def _lm_logits(top: Dict, x: torch.Tensor) -> torch.Tensor:
    """Tied-embedding logits: x (B, T, D) -> (B, T, V) f32. The int8 head
    takes a dynamic per-token absmax scale on x, an int8 x int8 product,
    then rescales by (x_scale * row_scale)."""
    if "wte_i8" not in top:
        return f32_out_product(x.reshape(-1, x.shape[-1]),
                               top["wte"]).reshape(*x.shape[:-1], -1)
    xf = x.to(torch.float32)
    x_scale = (torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-12)
               / _const(xf, 127.0))                           # (B, T, 1)
    xq = torch.clamp(torch.round(xf / x_scale), -127, 127).to(torch.int8)
    B, T, D = xq.shape
    acc = int8_matmul(xq.reshape(B * T, D), top["wte_i8"])
    return (acc.to(torch.float32).reshape(B, T, -1)
            * x_scale * top["wte_scale"][None, None, :])


def _take_last(x: torch.Tensor, last_index) -> torch.Tensor:
    """x (B, T, D) -> (B, 1, D) rows at ``last_index`` (scalar or (B,))."""
    B = x.shape[0]
    li = torch.as_tensor(last_index, device=x.device).reshape(-1).expand(B)
    return x[torch.arange(B, device=x.device), li.long()][:, None]


def _ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
        eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    """ReLU, or the tanh GELU with the reference's cast points. Its
    constant sqrt(2/pi) is a strongly typed f32 there, so under a bf16
    ``x`` the inner ``x + 0.044715 x^3`` stays bf16 (the cube rounded
    once from f32, 0.044715 rounded to bf16 first, as JAX takes a Python
    float) and everything from the product with the constant on is f32:
    a bf16 input gives an f32 GELU, which fc_out then snaps."""
    if name == "relu":
        return torch.relu(x)
    cube = torch.pow(x.to(torch.float32), 3.0).to(x.dtype)
    inner = x + torch.tensor(0.044715, device=x.device).to(x.dtype) * cube
    c = torch.tensor(np.sqrt(2.0 / np.pi).astype(np.float32),
                     device=x.device)
    t = torch.tanh(c * inner.to(torch.float32))
    return (0.5 * x).to(torch.float32) * (1.0 + t)


def _prepare_stacked(cfg: EngineConfig, ep: Dict,
                     M: int) -> Optional[Dict[str, Dict[str, Any]]]:
    """Per-site stacked-kernel operands, or None: the routing rule of the
    reference. Decode-size M (<= ``stacked_max_m``) is all-or-nothing: a
    site with neither ``a_q`` nor K4's tables sends the whole step to the
    unfused route. Prefill-size M takes the stacked kernels only with
    ``stacked_prefill`` under "w4", and then site by site: sites with
    K4's tables or without ``a_q`` are left out and keep the torch
    route. None also when the kernels are off, under "bf16" or when there
    is no activation quantization."""
    if not (cfg.stacked_kernel and cfg.act_bits
            and cfg.weight_mode in ("w4", "w4pack")):
        return None
    prefill = M > cfg.stacked_max_m
    if prefill and not (cfg.stacked_prefill and cfg.weight_mode == "w4"):
        return None
    stk = {}
    for name, s in ep["layers"].items():
        if name not in ALL_SITES:
            continue
        if "aovp_enc" in s and "oscale" in s:
            if prefill:
                continue
            # full OliVe: OVP activations (and maybe OVP weights) -> K4
            prescale = s["a_alpha"] / s["a_grid"].amax(dim=1)        # (L,)
            stk[name] = {
                "mode": "aovp", "w": s["w_i8"], "w_ovp": "ovp" in s,
                "scales": (prescale * s["aovp_unit"])[:, None] * s["oscale"],
                "prescale": prescale, "mids": s["aovp_mids"],
                "ties": s["aovp_ties"], "enc": s["aovp_enc"]}
            continue
        if "a_q" not in s or "oscale" not in s:
            if prefill:
                continue
            return None
        common = {"a_q": s["a_q"], "a_scale": s["a_scale"],
                  "scales": s["a_scale"][:, None] * s["oscale"]}
        if "packed" in s:
            stk[name] = {"mode": "p4", "w": s["packed"], "q16": s["q16"],
                         "affine": "affine4" in s, **common}
        else:
            stk[name] = {"mode": "i8", "w": s["w_i8"], "ovp": "ovp" in s,
                         **common}
    return stk or None


def _site_matmul_nobias(cfg: EngineConfig, ep: Dict, name: str,
                        x2d: torch.Tensor, l: int,
                        stk: Optional[Dict]) -> torch.Tensor:
    """Quantized matmul of one site at layer l, WITHOUT the bias (f32).
    ``stk`` is :func:`_prepare_stacked`'s result; a site it leaves out
    takes the unfused route."""
    s = stk.get(name) if stk is not None else None
    if s is not None:
        if s["mode"] == "aovp":
            return stacked_quant_matmul_aovp(
                l, x2d, s["w"], s["scales"], s["prescale"], s["mids"],
                s["ties"], s["enc"], w_ovp=s["w_ovp"],
                block_k=cfg.stacked_block_k)
        if s["mode"] == "p4":
            return stacked_quant_matmul_p4(l, x2d, s["w"], s["scales"],
                                           s["a_q"], s["a_scale"], s["q16"],
                                           affine=s["affine"])
        return stacked_quant_matmul(l, x2d, s["w"], s["scales"], s["a_q"],
                                    s["a_scale"], ovp=s["ovp"],
                                    block_k=cfg.stacked_block_k)
    site = ep["layers"][name]
    if "kernel" in site:
        # "bf16": the dense product of cfg.dtype operands, f32 result
        return f32_out_product(_fake_quant(x2d, site, l).to(cfg.dtype),
                               site["kernel"][l])
    if "packed" in site:
        # "w4pack": fake-quant in cfg.dtype, then K8 on those values
        return quantized_matmul_w4(_fake_quant(x2d, site, l),
                                   site["packed"][l], site["scale"][l],
                                   site["grid"][l], site["k8_terms"][l],
                                   site["k8_unit"][l])
    w = site["w_i8"][l]
    if "kscale" in site:
        # a GPT-2 Conv1D site: its per-input-channel scale runs along K,
        # so the reference serves it as the fake-quant (never the int8
        # snap) and an f32 product against the dequantized f32 weight,
        # whatever cfg.dtype is; int8 x f32 promotes in one pass
        wv = ovp_decode_values(w) if "ovp" in site else w
        return f32_product(_fake_quant(x2d, site, l),
                           wv * site["kscale"][l][None, :])
    if "a_q" in site:
        a_scale = site["a_scale"][l]
        xq = snap_value(x2d.to(torch.float32) / a_scale,
                        site["a_q"][l]).to(torch.int8)
        if "ovp" in site:
            # OVP dual dot: two exact int32 products, combined in f32
            # (16 x the first would overflow int32 at K = 16384)
            acc = (16.0 * int8_matmul(xq, w).to(torch.float32)
                   - 15.0 * int8_matmul(xq, ovp_clip(w)).to(torch.float32))
        else:
            acc = int8_matmul(xq, w).to(torch.float32)
        return acc * (a_scale * site["oscale"][l])[None, :]
    # OliVe activation outliers, a grid without an int8-exact codebook, or
    # no activation quantization (W4A16): the fake-quant where there is
    # one, then the decoded weight values in mm_dtype
    x2d = _fake_quant(x2d, site, l)
    mm_dtype = torch.float32 if cfg.dtype == torch.float32 \
        else torch.bfloat16
    wv = ovp_decode_values(w) if "ovp" in site else w
    y = f32_out_product(x2d.to(mm_dtype), wv.to(mm_dtype))
    return y * site["oscale"][l][None, :]


def _fake_quant(x2d: torch.Tensor, site: Dict, l: int) -> torch.Tensor:
    """The reference's activation fake-quant of the unfused routes, in
    x's dtype: OliVe's where the site has outliers (``a_out``), the plain
    one where it has a grid, none without activation leaves
    (``act_bits=0``)."""
    if "a_out" in site:
        return quantize_activation_ovp(x2d, site["a_grid"][l],
                                       site["a_out"][l], site["a_alpha"][l])
    if "a_grid" in site:
        return quantize_activation(x2d, site["a_grid"][l],
                                   site["a_alpha"][l])
    return x2d


def _site_matmul(cfg: EngineConfig, ep: Dict, name: str,
                 x2d: torch.Tensor, l: int,
                 stk: Optional[Dict]) -> torch.Tensor:
    y = _site_matmul_nobias(cfg, ep, name, x2d, l, stk)
    return (y + ep["layers"][name]["bias"][l]).to(cfg.dtype)


def _kv_fold(head_dim: int) -> int:
    """The reference's lane-fold factor of its int8 cache
    (``kernels/kv_cache.py:kv_fold``): 1 means a flat cache. The port's
    cache is always flat; the fold only decides the route."""
    if head_dim >= 128 or 128 % head_dim or head_dim < 32:
        return 1
    return 128 // head_dim


def attention_route(c: LMConfig, T: int, S: int,
                    kv_int8: bool = True) -> str:
    """The reference's attention route for T queries against a cache of S
    positions (``_attention_stacked`` and ``_attention``). The bf16 cache
    (``kv_int8=False``) always takes "einsum". On the INT8 cache: "K2"
    while one head's tile (k + v codes, q and out, the scores) leaves room
    in the reference's 6 MiB budget for min(T, 8) queries; past that "K7"
    for up to 16 queries on a cache the reference keeps flat (head_dim
    128 and 80; it folds 64 into rows of 128 lanes), else "einsum", the
    dequantizing fallback. At head_dim 128 K2 stops at S = 12,191 (a long
    ALiBi context: learned positions end at 2,050; GPT-2's at 1,024, where
    head_dim 64 stays on K2). Where the reference cuts a prefill into
    query chunks of K2, the port launches K2 once: the chunks are exact,
    so the results are the same."""
    if not kv_int8:
        return "einsum"
    f = _kv_fold(c.head_dim)
    s_tot = -(-S // f) * f
    fixed = 2 * 2 * s_tot * c.head_dim
    per_t = 8 * c.head_dim + 4 * s_tot
    if (_TILE_BUDGET - fixed) // per_t >= min(T, 8):
        return "K2"
    if T <= K7_MAX_T and f == 1:
        return "K7"
    return "einsum"


def _attention_einsum(cfg: EngineConfig, q: torch.Tensor, kv: QuantKV,
                      l: int, pos0: torch.Tensor,
                      slopes: Optional[torch.Tensor]) -> torch.Tensor:
    """The reference's einsum route (``_attention``) on layer l, with its
    cast points: the INT8 cache dequantized in ``cfg.dtype`` (the bf16
    cache read as it is), f32 scores divided by f32(sqrt(D)), the ALiBi
    term, the f32-min mask, an f32 softmax cast to ``cfg.dtype``, the
    product with v in ``cfg.dtype``. TF32 is held off. q (B, T, H, D) ->
    (B, T, H, D)."""
    B, T, H, D = q.shape
    if cfg.kv_int8:
        k, v = dequant_kv(QuantKV(*(a[l] for a in kv)), cfg.dtype)
    else:
        k, v = kv.k[l], kv.v[l]
    S = k.shape[2]
    # the f32 scores are B x H x T x S (4.3 GB at BLOOM-7b1, bs 4, a
    # 512-query chunk of a 16,384-position cache): updated in place, and
    # each transient freed as soon as it is used
    with tf32_off():
        s = torch.matmul(q.transpose(1, 2).to(torch.float32),
                         k.to(torch.float32).transpose(-1, -2))
        del k
        s /= torch.tensor(np.float32(np.sqrt(D)), device=q.device)
        rel = _rel(pos0, T, S)                                   # (B, T, S)
        if slopes is not None:
            s += slopes[None, :, None, None] * rel[:, None].to(torch.float32)
        s.masked_fill_((rel > 0)[:, None], float(np.finfo(np.float32).min))
        attn = torch.softmax(s, dim=-1).to(cfg.dtype)
        del s
        out = torch.matmul(attn, v.to(cfg.dtype))              # (B, H, T, D)
    return out.transpose(1, 2)


def _attention(cfg: EngineConfig, route: str, q: torch.Tensor, kv: QuantKV,
               l: int, pos0: torch.Tensor,
               slopes: Optional[torch.Tensor]) -> torch.Tensor:
    """q (B, T, H, D) against layer l of the cache -> (B, T, H, D), by
    ``route`` (:func:`attention_route`): K2 on the stacked cache, K7 on
    layer l's views, or the einsum fallback."""
    if route == "K2":
        out = stacked_int8_kv_attention(
            l, q.transpose(1, 2), kv.k, kv.v, kv.k_scale, kv.v_scale, pos0,
            slopes, out_dtype=cfg.dtype)
    elif route == "K7":
        out = int8_kv_attention(
            q.transpose(1, 2), kv.k[l], kv.v[l], kv.k_scale[l],
            kv.v_scale[l], pos0, slopes, out_dtype=cfg.dtype)
    else:
        return _attention_einsum(cfg, q, kv, l, pos0, slopes)
    return out.transpose(1, 2)


def forward(cfg: EngineConfig, ep: Dict, ids: torch.Tensor, kv: QuantKV,
            pos0, last_index=None) -> Tuple[torch.Tensor, QuantKV]:
    """Shared prefill/decode forward: writes the new K/V at ``pos0`` (in
    place) and attends over the cache.

    ``pos0``: the write position of the batch (an int), or a (B,) int
    tensor of per-sequence positions (a bucket-padded ragged batch).
    ``last_index``: scalar or (B,) prompt position whose logits a serving
    prefill needs; logits then come back (B, 1, V) and ln_f / lm_head run
    on those rows only (exact: both are per-position).
    """
    _check_config(cfg)
    c = cfg.lm
    top, lay = ep["top"], ep["layers"]
    B, T = ids.shape
    dev = ids.device
    if isinstance(pos0, torch.Tensor) and pos0.ndim:
        write_at = [int(p) for p in pos0.tolist()]      # one host read
        if len(write_at) != B:
            raise ValueError(f"{len(write_at)} positions for a batch of {B}")
        pos_vec = torch.tensor(write_at, dtype=torch.int32, device=dev)
    else:
        write_at = operator.index(pos0)
        pos_vec = torch.full((B,), write_at, dtype=torch.int32, device=dev)
    x = _embed(top, ids, cfg.dtype)
    if c.positions in ("learned", "learned_offset2"):
        positions = pos_vec.to(torch.int64)[:, None] + torch.arange(
            T, device=dev)                                          # (B, T)
        x = x + top["wpe"][positions + (2 if c.positions == "learned_offset2"
                                        else 0)]
    if "embed_ln" in top:
        x = _ln(x, top["embed_ln"]["scale"], top["embed_ln"]["bias"],
                c.ln_eps)
    slopes = (torch.tensor(alibi_slopes(c.n_heads), dtype=torch.float32,
                           device=dev) if c.positions == "alibi" else None)
    heads, hd = c.n_heads, c.head_dim
    d_attn = heads * hd
    M = B * T
    stk = _prepare_stacked(cfg, ep, M)
    route = attention_route(c, T, kv.k.shape[3], cfg.kv_int8)
    for l in range(c.n_layers):
        h = _ln(x, lay["ln_1"]["scale"][l], lay["ln_1"]["bias"][l],
                c.ln_eps)
        x2 = h.reshape(M, c.d_model)
        if c.fused_qkv:
            qkv = _site_matmul(cfg, ep, "qkv", x2, l, stk)
            qh, kh, vh = (t.reshape(B, T, heads, hd)
                          for t in qkv.split(d_attn, dim=-1))
        else:
            qh, kh, vh = (_site_matmul(cfg, ep, n, x2, l, stk).reshape(
                B, T, heads, hd) for n in ("q", "k", "v"))
        append_kv_stacked(kv, kh, vh, l, write_at)
        a = _attention(cfg, route, qh, kv, l, pos_vec, slopes).reshape(
            M, d_attn)
        x = x + _site_matmul(cfg, ep, "out", a, l, stk).reshape(
            B, T, c.d_model)
        h = _ln(x, lay["ln_2"]["scale"][l], lay["ln_2"]["bias"][l],
                c.ln_eps)
        h2 = _act(c.activation, _site_matmul(
            cfg, ep, "fc_in", h.reshape(M, c.d_model), l, stk))
        x = x + _site_matmul(cfg, ep, "fc_out", h2, l, stk).reshape(
            B, T, c.d_model)
    if last_index is not None:
        x = _take_last(x, last_index)
    x = _ln(x, top["ln_f"]["scale"], top["ln_f"]["bias"], c.ln_eps)
    return _lm_logits(top, x), kv


def init_cache(cfg: EngineConfig, batch: int, device=None) -> QuantKV:
    """An empty cache stacked over layers, on ``device`` (default
    "cuda"): INT8 codes, or with ``kv_int8=False`` the raw values in
    ``cfg.dtype`` (the reference's flat baseline cache)."""
    c = cfg.lm
    return init_kv(c.n_layers, batch, cfg.max_seq, c.n_heads, c.head_dim,
                   resolve_device(device),
                   torch.int8 if cfg.kv_int8 else cfg.dtype)


def params_device(ep: Dict) -> torch.device:
    """The device that engine params live on (and their cache goes to)."""
    return ep["top"]["ln_f"]["scale"].device


def _flatten(tree: Dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


class Engine(nn.Module):
    """Greedy serving engine: owns the engine params and the KV cache as
    buffers and serves ``prefill`` / ``decode`` / ``generate``.

    ``ep`` comes from :func:`build_engine_params` or
    ``convert.from_jax_engine_params``; the cache is made on the same
    device."""

    def __init__(self, cfg: EngineConfig, ep: Dict, batch: int):
        super().__init__()
        _check_config(cfg)
        self.cfg = cfg
        self.batch = batch
        self._paths = []
        for path, t in _flatten(ep):
            self.register_buffer("__".join(path), t)
            self._paths.append(path)
        for name, t in zip(QuantKV._fields,
                           init_cache(cfg, batch, params_device(ep))):
            self.register_buffer("kv__" + name, t)
        self.pos = 0

    def engine_params(self) -> Dict:
        ep: Dict = {}
        for path in self._paths:
            node = ep
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = getattr(self, "__".join(path))
        return ep

    def cache(self) -> QuantKV:
        return QuantKV(*(getattr(self, "kv__" + n) for n in QuantKV._fields))

    def _ids(self, ids) -> torch.Tensor:
        dev = self.kv__k.device
        ids = torch.as_tensor(ids, device=dev)
        if ids.ndim != 2 or ids.shape[0] != self.batch:
            raise ValueError(f"ids must be ({self.batch}, T), got "
                             f"{tuple(ids.shape)}")
        return ids.long()

    @torch.no_grad()
    def prefill(self, ids, lengths=None,
                chunk: Optional[int] = None) -> torch.Tensor:
        """Prompt (B, T) at position 0 -> next-token logits (B, 1, V).

        ``lengths``: (B,) real prompt lengths of a bucket-padded batch;
        sequence b's logits come from position lengths[b] - 1 and it
        decodes on from position lengths[b] (the padding's cache rows
        are overwritten or masked). ``chunk``: feed the prompt in forward
        calls of at most ``chunk`` positions, each at its own pos0, as a
        long prompt needs (one call's attention scores are chunk x S per
        head on the fallback route)."""
        ids = self._ids(ids)
        B, T = ids.shape
        if lengths is None:
            last = torch.full((B,), T - 1, device=ids.device)
        else:
            last = torch.as_tensor(lengths, device=ids.device).reshape(
                -1).long() - 1
            if last.shape[0] != B or not bool(
                    ((last >= 0) & (last < T)).all()):
                raise ValueError(f"lengths must be {B} values in 1..{T}")
        step = T if chunk is None else chunk
        ep, kv = self.engine_params(), self.cache()
        logits = None
        for t0 in range(0, T, step):
            n = min(step, T - t0)
            out, _ = forward(self.cfg, ep, ids[:, t0:t0 + n], kv, t0,
                             last_index=(last - t0).clamp(0, n - 1))
            take = ((last >= t0) & (last < t0 + n))[:, None, None]
            logits = out if logits is None else torch.where(take, out,
                                                            logits)
        self.pos = T if lengths is None else last + 1
        return logits

    @torch.no_grad()
    def decode(self, tok) -> torch.Tensor:
        """Tokens (B, 1) at the current position (one per sequence after
        a prefill with ``lengths``) -> logits (B, 1, V)."""
        tok = self._ids(tok)
        logits, _ = forward(self.cfg, self.engine_params(), tok,
                            self.cache(), self.pos)
        self.pos = self.pos + tok.shape[1]
        return logits

    @torch.no_grad()
    def generate(self, ids, max_new_tokens: int,
                 lengths=None) -> torch.Tensor:
        """Greedy decoding: (B, T) prompt -> (B, max_new_tokens) tokens."""
        logits = self.prefill(ids, lengths)
        toks = []
        for i in range(max_new_tokens):
            tok = logits[:, -1].argmax(dim=-1, keepdim=True)
            toks.append(tok)
            if i + 1 < max_new_tokens:
                logits = self.decode(tok)
        return torch.cat(toks, dim=1)
