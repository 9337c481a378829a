"""Quantized serving engine for the decoder LM family, main path.

Counterpart of the reference's ``serve/engine.py`` for weight mode "w4"
(4-bit weights stored as int8 codebook values), int8-exact activation
grids, the INT8 KV cache and the int8 lm_head: prefill and greedy decode
with one scalar write position per call.

Routing follows the reference:
- decode-size matmuls (M = B*T <= ``stacked_max_m``) run K1, the stacked
  snap + int8 matmul kernel (``kernels/stacked.py``);
- prefill-size matmuls run plain torch ops: a midpoint snap of
  ``x / a_scale`` onto ``a_q``, then an int8 x int8 -> int32 library
  product (``int8_matmul``), as the reference leaves them to XLA;
- attention runs K2 (``kernels/attention.py``) for decode and prefill
  alike, one launch per layer.

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
from ..kernels.attention import stacked_int8_kv_attention
from ..kernels.kv_cache import QuantKV, append_kv_stacked, init_kv
from ..kernels.qmatmul import int8_codebook, quantize_weights_w4_i8
from ..kernels.stacked import int8_matmul, stacked_quant_matmul
from ..models.transformer_lm import LMConfig, conv1d_site_names
from ..ops.snap import snap_value

__all__ = ["EngineConfig", "quantize_lm_head", "build_engine_params",
           "forward", "init_cache", "Engine", "SITES"]

SITES = ("q", "k", "v", "out", "fc_in", "fc_out")
_ATTN_SITES = ("q", "k", "v", "out")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The reference's EngineConfig, field for field. ``interpret`` and
    the block sizes are Pallas settings and have no effect here."""
    lm: LMConfig
    weight_mode: str = "w4"        # only "w4" is ported
    act_bits: int = 0              # 0 = no activation quant, else 4/8
    kv_int8: bool = True
    lm_head_int8: bool = False
    max_seq: int = 2048
    block_n: int = 512
    dtype: Any = torch.bfloat16
    interpret: bool = False
    # decode-size matmuls (M = B*T <= stacked_max_m) run the K1 kernel
    stacked_kernel: bool = True
    stacked_max_m: int = 64
    stacked_block_n: int = 4096
    stacked_block_k: int = 1024
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
    if cfg.weight_mode != "w4":
        raise _not_ported(f"weight_mode={cfg.weight_mode!r}",
                          "8.6" if cfg.weight_mode == "w4pack" else "8.7")
    if not cfg.act_bits:
        raise _not_ported("w4 without activation quantization", "8")
    if not cfg.kv_int8:
        raise _not_ported("the bf16 KV cache", "8.7")
    if cfg.stacked_prefill:
        raise _not_ported("stacked_prefill (K5)", "8.8")
    if cfg.tp_axis is not None or cfg.tp_size != 1:
        raise _not_ported("tensor parallelism", "14")
    if c.fused_qkv or c.embed_ln or c.positions == "alibi":
        raise _not_ported("fused qkv, embed_ln and ALiBi", "8.2")
    if c.activation not in ("relu", "gelu", "gelu_new"):
        raise ValueError(f"unknown activation {c.activation!r}")


def _field(state, name: str) -> np.ndarray:
    """A quantizer state's field, from a mapping or an object."""
    v = state[name] if isinstance(state, dict) else getattr(state, name)
    return np.asarray(v)


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


def build_engine_params(cfg: EngineConfig, params: Dict, quant: Dict,
                        device=None) -> Dict:
    """Per-layer float weights + calibrated quantizer states -> stacked
    engine params on ``device`` (default "cuda").

    ``params`` mirrors the reference model's tree with numpy leaves
    (``h_{i}/attn/{q,k,v,out}/{kernel,bias}``, ``h_{i}/{fc_in,fc_out}``,
    ``h_{i}/{ln_1,ln_2}``, ``wte/embedding``, ``wpe/embedding``,
    ``ln_f``); ``quant`` holds, per site, ``weight_q`` and ``input_q``
    states with numpy ``grid``, ``alpha`` and ``outliers``. The result's
    ``w_i8`` / ``oscale`` / ``a_q`` / ``a_scale`` equal the reference's
    bit for bit (``w_i8`` transposed to the port's (L, N, K) layout).
    """
    dev = resolve_device(device)
    _check_config(cfg)
    c = cfg.lm
    conv1d = conv1d_site_names(c)
    layers: Dict[str, Dict[str, list]] = {
        s: {k: [] for k in ("w_i8", "oscale", "bias", "a_q", "a_scale")}
        for s in SITES}
    lns: Dict[str, Dict[str, list]] = {
        n: {"scale": [], "bias": []} for n in ("ln_1", "ln_2")}
    for i in range(c.n_layers):
        p, q = params[f"h_{i}"], quant[f"h_{i}"]
        for n in lns:
            for k in ("scale", "bias"):
                lns[n][k].append(np.asarray(p[n][k], np.float32))
        for site in SITES:
            node = p["attn"][site] if site in _ATTN_SITES else p[site]
            qn = q["attn"][site] if site in _ATTN_SITES else q[site]
            wq, aq = qn["weight_q"], qn["input_q"]
            if site in conv1d:
                raise _not_ported("Conv1D (per-input-channel) sites", "8.3")
            if np.any(_field(wq, "outliers")):
                raise _not_ported("OVP (outlier) weights", "8.4")
            if np.any(_field(aq, "outliers")):
                raise _not_ported("OliVe activation outliers", "8.5")
            kernel = torch.tensor(np.asarray(node["kernel"], np.float32),
                                  device=dev)
            w_i8, oscale = quantize_weights_w4_i8(
                kernel, _field(wq, "grid"), _field(wq, "alpha"))
            a_grid = _field(aq, "grid").reshape(-1)[:2 ** cfg.act_bits]
            a_q16, a_unit, exact = int8_codebook(a_grid)
            if not exact:
                raise _not_ported("activation grids that are not int8-exact",
                                  "8")
            a_alpha = np.float32(_field(aq, "alpha").reshape(()))
            # the SIGNED max, as the reference quantizer scales
            a_scale = (a_alpha / np.float32(np.max(a_grid))
                       * np.float32(a_unit))
            e = layers[site]
            e["w_i8"].append(w_i8.t().contiguous())
            e["oscale"].append(oscale)
            bias = node.get("bias", np.zeros(kernel.shape[1], np.float32))
            e["bias"].append(torch.tensor(np.asarray(bias, np.float32),
                                          device=dev))
            e["a_q"].append(torch.as_tensor(a_q16.astype(np.float32),
                                            device=dev))
            e["a_scale"].append(torch.tensor(a_scale, dtype=torch.float32,
                                             device=dev))
    out_layers: Dict[str, Dict[str, torch.Tensor]] = {
        s: {k: torch.stack(v) for k, v in d.items()}
        for s, d in layers.items()}
    for n, d in lns.items():
        out_layers[n] = {k: torch.as_tensor(np.stack(v), device=dev)
                         for k, v in d.items()}
    wte = torch.tensor(np.asarray(params["wte"]["embedding"], np.float32),
                       device=dev)
    top = quantize_lm_head(wte) if cfg.lm_head_int8 else {
        "wte": wte.to(cfg.dtype)}
    top["ln_f"] = {k: torch.tensor(np.asarray(params["ln_f"][k],
                                              np.float32), device=dev)
                   for k in ("scale", "bias")}
    top["wpe"] = torch.tensor(np.asarray(params["wpe"]["embedding"],
                                         np.float32),
                              device=dev).to(cfg.dtype)
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
        return torch.matmul(x, top["wte"].t()).to(torch.float32)
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
    if name == "relu":
        return torch.relu(x)
    return 0.5 * x * (1.0 + torch.tanh(
        float(np.sqrt(2.0 / np.pi).astype(np.float32))
        * (x + 0.044715 * torch.pow(x, 3.0))))


def _prepare_stacked(cfg: EngineConfig, ep: Dict,
                     M: int) -> Optional[Dict[str, Dict[str, torch.Tensor]]]:
    """Per-site K1 operands for decode-size M, or None (prefill-size M,
    or the kernel switched off): the routing rule of the reference."""
    if not cfg.stacked_kernel or M > cfg.stacked_max_m:
        return None
    return {name: {"w": s["w_i8"], "a_q": s["a_q"], "a_scale": s["a_scale"],
                   "scales": s["a_scale"][:, None] * s["oscale"]}
            for name, s in ep["layers"].items() if name in SITES}


def _site_matmul_nobias(ep: Dict, name: str, x2d: torch.Tensor, l: int,
                        stk: Optional[Dict]) -> torch.Tensor:
    """Quantized matmul of one site at layer l, WITHOUT the bias (f32)."""
    if stk is not None:
        s = stk[name]
        return stacked_quant_matmul(l, x2d, s["w"], s["scales"], s["a_q"],
                                    s["a_scale"])
    site = ep["layers"][name]
    a_scale = site["a_scale"][l]
    xq = snap_value(x2d.to(torch.float32) / a_scale,
                    site["a_q"][l]).to(torch.int8)
    acc = int8_matmul(xq, site["w_i8"][l])
    return acc.to(torch.float32) * (a_scale * site["oscale"][l])[None, :]


def _site_matmul(cfg: EngineConfig, ep: Dict, name: str,
                 x2d: torch.Tensor, l: int,
                 stk: Optional[Dict]) -> torch.Tensor:
    y = _site_matmul_nobias(ep, name, x2d, l, stk)
    return (y + ep["layers"][name]["bias"][l]).to(cfg.dtype)


def _attention_stacked(cfg: EngineConfig, q: torch.Tensor, kv: QuantKV,
                       l: int, pos0: torch.Tensor) -> torch.Tensor:
    """q (B, T, H, D) against layer l of the cache -> (B, T, H, D), one
    K2 launch for any T."""
    out = stacked_int8_kv_attention(
        l, q.transpose(1, 2), kv.k, kv.v, kv.k_scale, kv.v_scale, pos0,
        None, out_dtype=cfg.dtype)
    return out.transpose(1, 2)


def forward(cfg: EngineConfig, ep: Dict, ids: torch.Tensor, kv: QuantKV,
            pos0, last_index=None) -> Tuple[torch.Tensor, QuantKV]:
    """Shared prefill/decode forward: writes the new K/V at ``pos0`` (in
    place) and attends over the cache.

    ``pos0``: the scalar write position shared by the batch.
    ``last_index``: scalar or (B,) prompt position whose logits a serving
    prefill needs; logits then come back (B, 1, V) and ln_f / lm_head run
    on those rows only (exact: both are per-position).
    """
    _check_config(cfg)
    if isinstance(pos0, torch.Tensor) and pos0.ndim:
        raise _not_ported("per-sequence pos0", "8.1")
    pos0 = operator.index(pos0)
    c = cfg.lm
    top, lay = ep["top"], ep["layers"]
    B, T = ids.shape
    dev = ids.device
    positions = pos0 + torch.arange(T, device=dev)
    x = _embed(top, ids, cfg.dtype)
    x = x + top["wpe"][positions + (2 if c.positions == "learned_offset2"
                                    else 0)][None]
    heads, hd = c.n_heads, c.head_dim
    d_attn = heads * hd
    M = B * T
    stk = _prepare_stacked(cfg, ep, M)
    pos_vec = torch.full((B,), pos0, dtype=torch.int32, device=dev)
    for l in range(c.n_layers):
        h = _ln(x, lay["ln_1"]["scale"][l], lay["ln_1"]["bias"][l],
                c.ln_eps)
        x2 = h.reshape(M, c.d_model)
        qh, kh, vh = (_site_matmul(cfg, ep, n, x2, l, stk).reshape(
            B, T, heads, hd) for n in ("q", "k", "v"))
        append_kv_stacked(kv, kh, vh, l, pos0)
        a = _attention_stacked(cfg, qh, kv, l, pos_vec).reshape(M, d_attn)
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
    """An empty INT8 cache stacked over layers, on ``device`` (default
    "cuda")."""
    if not cfg.kv_int8:
        raise _not_ported("the bf16 KV cache", "8.7")
    c = cfg.lm
    return init_kv(c.n_layers, batch, cfg.max_seq, c.n_heads, c.head_dim,
                   resolve_device(device))


def _flatten(tree: Dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


class Engine(nn.Module):
    """Greedy serving engine: owns the engine params and the INT8 cache
    as buffers and serves ``prefill`` / ``decode`` / ``generate``.

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
        dev = ep["top"]["ln_f"]["scale"].device
        for name, t in zip(QuantKV._fields, init_cache(cfg, batch, dev)):
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
    def prefill(self, ids) -> torch.Tensor:
        """Prompt (B, T) at position 0 -> next-token logits (B, 1, V)."""
        ids = self._ids(ids)
        T = ids.shape[1]
        logits, _ = forward(self.cfg, self.engine_params(), ids,
                            self.cache(), 0, last_index=T - 1)
        self.pos = T
        return logits

    @torch.no_grad()
    def decode(self, tok) -> torch.Tensor:
        """Tokens (B, 1) at the current position -> logits (B, 1, V)."""
        tok = self._ids(tok)
        logits, _ = forward(self.cfg, self.engine_params(), tok,
                            self.cache(), self.pos)
        self.pos += tok.shape[1]
        return logits

    @torch.no_grad()
    def generate(self, ids, max_new_tokens: int) -> torch.Tensor:
        """Greedy decoding: (B, T) prompt -> (B, max_new_tokens) tokens."""
        logits = self.prefill(ids)
        toks = []
        for i in range(max_new_tokens):
            tok = logits[:, -1].argmax(dim=-1, keepdim=True)
            toks.append(tok)
            if i + 1 < max_new_tokens:
                logits = self.decode(tok)
        return torch.cat(toks, dim=1)
