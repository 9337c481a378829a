"""The plain decoder that both reference families share, in float32.

It computes what the configuration states: pre-LayerNorm decoder blocks
whose matmul sites take the 4-bit activation snap (the input over
``a_scale`` snapped to the nearest entry of the int8-exact codebook
``a_q``, a midpoint going up) against the 4-bit weight codes times
their per-channel scale; keys and values rounded to INT8 per position
and head (absmax over the head's width, round half to even, +-127);
causal softmax attention; the tied int8 head on a per-token absmax int8
input. Everything else is float32 with TF32 off, over a whole sequence
at once, with no cache, batching or kernel. It reads the engine's
parameter tensors as the harness made them and works out everything it
needs from them itself; it imports nothing of the program.

``precision="lower"`` is the control: the same arithmetic one step
below the precisions the configuration states, as a change that cut
precision to go faster would compute it: float8 (e4m3) wherever the
served model holds bfloat16 (embeddings, LayerNorm outputs, site
outputs, attention outputs, the residual stream), INT4 keys and values,
and an int4 head (its input and its rows requantized to +-7).

A family module (``opt.py``, ``bloom.py``) supplies ``embed``,
``attention_bias``, ``activation`` and ``split_qkv``.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Sequence

import torch

FP8_MAX = 448.0


@contextlib.contextmanager
def tf32_off():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class Numerics:
    """Where the served model rounds: identity (or INT8) at ``"f32"``,
    one step lower at ``"lower"``."""

    def __init__(self, precision: str):
        if precision not in ("f32", "lower"):
            raise ValueError(f"unknown precision {precision!r}")
        self.lower = precision == "lower"
        self.qmax = 7.0 if self.lower else 127.0

    def act(self, x: torch.Tensor) -> torch.Tensor:
        if not self.lower:
            return x
        return x.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).to(
            torch.float32)

    def kv(self, x: torch.Tensor) -> torch.Tensor:
        """(..., D) keys or values as the cache holds them."""
        amax = x.abs().amax(dim=-1, keepdim=True)
        scale = torch.where(amax > 0, amax / self.qmax,
                            torch.ones_like(amax))
        return torch.clamp(torch.round(x / scale), -self.qmax,
                           self.qmax) * scale


def layer_norm(x, scale, bias, eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def snap(x: torch.Tensor, a_q: torch.Tensor, a_scale) -> torch.Tensor:
    """The 4-bit activation: x / a_scale onto the codebook's nearest
    entry (a midpoint goes up), back in x's units."""
    g = a_q.float()
    mids = (g[1:] + g[:-1]) * 0.5
    idx = torch.bucketize((x / a_scale).contiguous(), mids, right=True)
    return g[idx] * a_scale


class Site:
    """One layer's matmul site: its dequantized f32 weight (N, K)."""

    def __init__(self, s: dict, l: int):
        self.w = s["w_i8"][l].float() * s["oscale"][l].float()[:, None]
        self.bias = s["bias"][l].float()
        self.a_q = s["a_q"][l]
        self.a_scale = s["a_scale"][l].float()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return snap(x, self.a_q, self.a_scale) @ self.w.t() + self.bias


def attention(q, k, v, bias) -> torch.Tensor:
    """Causal softmax attention of (T, H, D) q, k, v; ``bias`` is None
    or an (H, T, T) additive term."""
    T, H, D = q.shape
    s = torch.einsum("thd,shd->hts", q, k) / math.sqrt(D)
    if bias is not None:
        s = s + bias
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).triu(1)
    s = s.masked_fill(causal, float("-inf"))
    return torch.einsum("hts,shd->thd", torch.softmax(s, dim=-1), v)


@torch.no_grad()
def final_hidden(fam, config: dict, ep: dict, seqs: Sequence[Sequence[int]],
                 precision: str, device) -> List[torch.Tensor]:
    """The last LayerNorm's output (T, d) of each sequence, a layer at a
    time over all the sequences (one layer's weights in f32 at once)."""
    lm = config["lm"]
    num = Numerics(precision)
    top, lay = ep["top"], ep["layers"]
    eps = lm["ln_eps"]
    H, D = lm["n_heads"], lm["d_model"] // lm["n_heads"]
    with tf32_off():
        hs = []
        for s in seqs:
            ids = torch.as_tensor(list(s), dtype=torch.int64, device=device)
            x = num.act(fam.embed(top, ids, lm))
            if lm["embed_ln"]:
                x = num.act(layer_norm(x, top["embed_ln"]["scale"],
                                       top["embed_ln"]["bias"], eps))
            hs.append(x)
        biases = [fam.attention_bias(lm, h.shape[0], device) for h in hs]
        names = [n for n in ("qkv", "q", "k", "v", "out", "fc_in", "fc_out")
                 if n in lay]
        for l in range(lm["n_layers"]):
            site = {n: Site(lay[n], l) for n in names}
            for i, x in enumerate(hs):
                T = x.shape[0]
                a = num.act(layer_norm(x, lay["ln_1"]["scale"][l],
                                       lay["ln_1"]["bias"][l], eps))
                q, k, v = (num.act(t).reshape(T, H, D)
                           for t in fam.split_qkv(site, a))
                o = num.act(attention(q, num.kv(k), num.kv(v), biases[i]))
                x = num.act(x + num.act(site["out"](o.reshape(T, H * D))))
                m = num.act(layer_norm(x, lay["ln_2"]["scale"][l],
                                       lay["ln_2"]["bias"][l], eps))
                f = fam.activation(num.act(site["fc_in"](m)))
                hs[i] = num.act(x + num.act(site["fc_out"](f)))
            del site
        return [layer_norm(x, top["ln_f"]["scale"], top["ln_f"]["bias"], eps)
                for x in hs]


@torch.no_grad()
def head_logits(ep: dict, h: torch.Tensor, precision: str,
                vocab_block: int = 32768) -> torch.Tensor:
    """The tied int8 head: (rows, d) final hidden states -> (rows, V) f32
    logits. Each row's input is quantized by its own absmax; the head's
    rows are the int8 embedding codes times their scales."""
    num = Numerics(precision)
    top = ep["top"]
    with tf32_off():
        xs = torch.clamp(h.abs().amax(dim=-1, keepdim=True), min=1e-12) \
            / num.qmax
        xq = torch.clamp(torch.round(h / xs), -num.qmax, num.qmax)
        w_i8, w_scale = top["wte_i8"], top["wte_scale"].float()
        out = []
        for v0 in range(0, w_i8.shape[0], vocab_block):
            w = w_i8[v0:v0 + vocab_block].float()
            ws = w_scale[v0:v0 + vocab_block]
            if num.lower:
                rmax = torch.clamp(w.abs().amax(dim=1), min=1.0) / num.qmax
                w = torch.clamp(torch.round(w / rmax[:, None]), -num.qmax,
                                num.qmax)
                ws = ws * rmax
            out.append((xq @ w.t()) * xs * ws[None, :])
        return torch.cat(out, dim=1)
