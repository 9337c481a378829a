"""Decode and prefill throughput benchmark for the LM families.

Counterpart of the reference's ``tools/lm_bench.py``: random engine
params at the EXACT geometry of one of the decoder families the
reference's OliVe CLM harness evaluates (gpt2-xl, facebook/opt-6.7b,
bigscience/bloom-7b1, and a smaller size of each) — fused vs split qkv,
ALiBi vs learned positions, embedding LayerNorm, true vocab size —
served W4A4 + INT8 KV with the int8 lm_head through
``serve/engine.py:forward`` on ``--device`` (default the card), beside
the bf16 dense baseline where the device's free memory holds it. Prints
one JSON line on stdout (progress goes to stderr).

decode: one prefill, then a warm-up and 3 repetitions of ``--decode``
greedy steps on one cache, fenced with ``torch.cuda.synchronize``. The
reference runs a repetition's steps in one dispatch (``lax.scan``); here
each step is a Python call of ``forward`` that launches every kernel from
the host, so ms/step includes the host's dispatch. That is the port's
own number: its decode step is host-bound (at OPT-6.7B the device is
busy about a tenth of it, PERF.md "Where the time goes").

prefill: the compute-bound side, full-forward tokens/s and int8 MFU at
full depth, the serving prefill (lm_head at the last position only), and
the bf16 prefill at the largest depth that fits, for a depth-matched
ratio. MFU is against the H100 SXM's dense peaks.

Usage:
    python -m ant_quantization_tpu_torch.tools.lm_bench --family gpt2-xl
    python -m ant_quantization_tpu_torch.tools.lm_bench --family gpt2-xl \\
        --linear-sites
        # gpt2-* defaults to the reference's per-IN-channel Conv1D
        # quantizer semantics (f32-dequant serving); --linear-sites
        # measures the per-OUT layout (int8 stream)
    python -m ant_quantization_tpu_torch.tools.lm_bench --family bloom-7b1
    python -m ant_quantization_tpu_torch.tools.lm_bench --family opt-6.7b
    python -m ant_quantization_tpu_torch.tools.lm_bench --family opt-6.7b \\
        --mode prefill
    python -m ant_quantization_tpu_torch.tools.lm_bench --family opt-1.3b \\
        --device cpu --decode 4      # the kernels' plain versions

``BENCH_HBM_BUDGET`` (bytes) overrides the memory the bf16 baseline may
take; by default it is the device's free memory.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time
from typing import Dict

import numpy as np
import torch

from .._ext import resolve_device
from ..kernels.qmatmul import int8_codebook
from ..models.transformer_lm import (bloom_config, conv1d_site_names,
                                     gpt2_config, opt_config)
from ..numerics import codebooks as cb
from ..serve import engine as eng
from ..utils.profiling import fence

__all__ = ["FAMILIES", "PEAK_BF16", "PEAK_INT8", "rand_engine_params",
           "site_shapes", "bench_decode", "bench_prefill", "matmul_flops",
           "bf16_bytes", "memory_budget", "main"]

FAMILIES = {
    "gpt2-xl": lambda: gpt2_config("xl"),
    "gpt2-large": lambda: gpt2_config("large"),
    "opt-6.7b": lambda: opt_config("6.7b"),
    "opt-1.3b": lambda: opt_config("1.3b"),
    "bloom-7b1": lambda: bloom_config("7b1"),
    "bloom-3b": lambda: bloom_config("3b"),
}

# H100 SXM dense tensor-core peaks (NVIDIA data sheet, 700 W): bf16 989
# TFLOP/s, int8 1,979 TOP/s — the MFU denominators of the prefill mode
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12


def _note(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def site_shapes(c) -> Dict[str, tuple]:
    """(K, N) of each matmul site of one layer: a fused qkv or separate
    q, k, v."""
    if c.fused_qkv:
        sites = {"qkv": (c.d_model, 3 * c.d_model)}
    else:
        sites = {s: (c.d_model, c.d_model) for s in ("q", "k", "v")}
    sites.update(out=(c.d_model, c.d_model),
                 fc_in=(c.d_model, c.d_ff), fc_out=(c.d_ff, c.d_model))
    return sites


def rand_engine_params(cfg: eng.EngineConfig, seed: int = 0,
                       device=None) -> Dict:
    """Random stacked engine params at cfg.lm's exact geometry, in the
    port's layouts, built on ``device`` (default the card) one site at a
    time from a ``torch.Generator`` seeded with ``seed``, each leaf drawn
    in place (no host copy, no f32 transient of a bf16 stack).

    The reference's construction: "w4" weights are int8 codebook values
    in [-64, 64) (N-major, (L, N, K)) with ``oscale`` — at a GPT-2 Conv1D
    site ``kscale`` (L, K), served through the exact dequantized-weight
    route and not the int8 stream — of 2e-3 times the flint weight grid's
    int8 unit; every site gets the unsigned flint ``a_grid`` and
    ``a_alpha`` 3 (with activation quantization), the int8-stream sites
    also ``a_q`` and ``a_scale``. The int8 head is ``wte_i8`` in [-127,
    128) with ``wte_scale`` 0.02/127. "bf16" sites hold a ``kernel`` in
    ``cfg.dtype`` of std 1/sqrt(K) and the head a plain ``wte`` of std
    0.02. Learned positions get ``wpe`` (std 0.02), BLOOM its
    ``embed_ln``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    c = cfg.lm
    c1d = conv1d_site_names(c)
    wgrid = cb.ant_grid("flint", 4, True)[:16]
    agrid = cb.ant_grid("flint", 4, False)[:16]
    _, w_unit, _ = int8_codebook(wgrid)
    aq16, a_unit, _ = int8_codebook(agrid)
    a_vmax = float(np.max(agrid))
    L = c.n_layers

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    def per_layer(row):
        return torch.tensor(np.broadcast_to(np.asarray(row, np.float32),
                                            (L, 16)).copy(), device=dev)

    def normal(shape, std):
        return torch.empty(shape, dtype=cfg.dtype, device=dev).normal_(
            0.0, std, generator=gen)

    layers = {}
    for name, (K, N) in site_shapes(c).items():
        entry = {"bias": torch.zeros((L, N), device=dev)}
        if cfg.weight_mode == "w4":
            entry["w_i8"] = torch.randint(-64, 64, (L, N, K),
                                          dtype=torch.int8, device=dev,
                                          generator=gen)
            if name in c1d:
                entry["kscale"] = full((L, K), 2e-3 * w_unit)
            else:
                entry["oscale"] = full((L, N), 2e-3 * w_unit)
        else:
            entry["kernel"] = normal((L, N, K), float(1.0 / np.sqrt(K)))
        if cfg.act_bits:
            entry["a_grid"] = per_layer(agrid)
            entry["a_alpha"] = full((L,), 3.0)
            if cfg.weight_mode == "w4" and name not in c1d:
                entry["a_q"] = per_layer(aq16)
                entry["a_scale"] = full((L,), 3.0 / a_vmax * a_unit)
        layers[name] = entry
    for name in ("ln_1", "ln_2"):
        layers[name] = {"scale": torch.ones((L, c.d_model), device=dev),
                        "bias": torch.zeros((L, c.d_model), device=dev)}
    ln = lambda: {"scale": torch.ones((c.d_model,), device=dev),
                  "bias": torch.zeros((c.d_model,), device=dev)}
    top = {"ln_f": ln()}
    if c.positions in ("learned", "learned_offset2"):
        top["wpe"] = normal((cfg.max_seq + 2, c.d_model), 0.02)
    if c.embed_ln:
        top["embed_ln"] = ln()
    if cfg.lm_head_int8:
        top["wte_i8"] = torch.randint(-127, 128, (c.vocab_size, c.d_model),
                                      dtype=torch.int8, device=dev,
                                      generator=gen)
        top["wte_scale"] = full((c.vocab_size,), 0.02 / 127.0)
    else:
        top["wte"] = normal((c.vocab_size, c.d_model), 0.02)
    return {"layers": layers, "top": top}


def _ids(cfg: eng.EngineConfig, batch: int, prefill: int,
         dev: torch.device) -> torch.Tensor:
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    return torch.randint(0, cfg.lm.vocab_size, (batch, prefill),
                         device=dev, generator=gen)


@torch.no_grad()
def bench_decode(cfg: eng.EngineConfig, batch, prefill, decode_steps,
                 label, device=None) -> float:
    """Decode tokens/s: one prefill, a warm-up and 3 fenced repetitions
    of ``decode_steps`` greedy steps at positions prefill.. (each
    repetition rewrites the same cache rows)."""
    dev = resolve_device(device)
    _note(f"{label}: building params")
    ep = rand_engine_params(cfg, 0, dev)
    ids = _ids(cfg, batch, prefill, dev)
    kv = eng.init_cache(cfg, batch, dev)

    def decode_n(tok):
        for i in range(decode_steps):
            logits, _ = eng.forward(cfg, ep, tok, kv, prefill + i)
            tok = torch.argmax(logits[:, -1:], dim=-1)
        return tok

    logits, _ = eng.forward(cfg, ep, ids, kv, 0)
    tok = decode_n(torch.argmax(logits[:, -1:], dim=-1))
    fence(tok)
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        tok = decode_n(tok)
    fence(tok)
    dt = (time.perf_counter() - t0) / reps
    tps = batch * decode_steps / dt
    _note(f"{label}: {dt / decode_steps * 1e3:.2f} ms/step, "
          f"{tps:.0f} tokens/s")
    return tps


def matmul_flops(c, m: int, head_m: int = None) -> float:
    """FLOPs of one forward's matmul sites at M tokens (2*M*K*N each):
    attention projections + MLP + lm_head; the attention score/output
    einsums add <1% at T=512 and are excluded (so MFU is conservative).
    ``head_m``: tokens reaching the lm_head (= batch B for a serving
    prefill via forward's last_index; defaults to all M)."""
    per_layer = 2 * m * (4 * c.d_model ** 2 + 2 * c.d_model * c.d_ff)
    head = 2 * (m if head_m is None else head_m) * c.vocab_size * c.d_model
    return c.n_layers * per_layer + head


@torch.no_grad()
def bench_prefill(cfg: eng.EngineConfig, batch, prefill, label,
                  reps=4, windows=3, last_only=False, device=None) -> float:
    """Prefill latency: seconds per full B x T prefill forward.

    Each window runs ``reps`` prefills of ``(ids + i) % vocab`` back to
    back and fences once; the median of ``windows`` windows, after one
    warm window, is reported.

    ``last_only``: the SERVING prefill (forward's last_index) — the
    lm_head runs only at the last prompt position per sequence, which
    is all a generate loop samples from."""
    dev = resolve_device(device)
    _note(f"{label}: building params")
    ep = rand_engine_params(cfg, 0, dev)
    ids = _ids(cfg, batch, prefill, dev)
    kv = eng.init_cache(cfg, batch, dev)
    li = prefill - 1 if last_only else None

    def prefill_reps():
        for i in range(reps):
            logits, _ = eng.forward(cfg, ep, (ids + i) % cfg.lm.vocab_size,
                                    kv, 0, last_index=li)
        fence(logits)

    prefill_reps()                      # warm
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        prefill_reps()
        times.append((time.perf_counter() - t0) / reps)
    dt = float(np.median(times))
    tps = batch * prefill / dt
    _note(f"{label}: {dt * 1e3:.1f} ms/prefill, {tps:.0f} tokens/s")
    return dt


def bf16_bytes(c, batch: int, prefill: int, max_seq: int) -> int:
    """The port's estimate of the bf16 baseline's peak device memory: the
    dense weights, the plain head and the position table in bf16, the raw
    bf16 cache (k and v at max_seq), and the largest transient of one
    B x prefill forward: the f32 logits of every position, the attention
    einsum's f32 scores with their f32 softmax and its bf16 copy, or
    fc_in's f32 product, its biased copy and their bf16 cast; plus the
    residual stream and its LayerNorm (a few copies of B x prefill x
    d_model). ``rand_engine_params`` draws each leaf in place, so the
    build adds no transient."""
    weights = 2 * c.n_layers * sum(K * N for K, N in site_shapes(c).values())
    head = 2 * c.vocab_size * c.d_model
    wpe = (2 * (max_seq + 2) * c.d_model
           if c.positions in ("learned", "learned_offset2") else 0)
    cache = 2 * 2 * c.n_layers * batch * c.n_heads * max_seq * c.head_dim
    m = batch * prefill
    transient = max(4 * m * c.vocab_size,
                    10 * batch * c.n_heads * prefill * max_seq,
                    10 * m * c.d_ff) + 16 * m * c.d_model
    return weights + head + wpe + cache + transient


def memory_budget(dev: torch.device) -> float:
    """Bytes the bf16 baseline may take: ``BENCH_HBM_BUDGET`` if set,
    else the device's free memory (the card's, after returning the
    allocator's cached blocks; the host's available memory on the
    CPU)."""
    if "BENCH_HBM_BUDGET" in os.environ:
        return float(os.environ["BENCH_HBM_BUDGET"])
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        return float(torch.cuda.mem_get_info(dev)[0])
    return float(os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE"))


def _prefill_mode(args, lm, qcfg, layout, dev) -> Dict:
    m = args.batch * args.prefill
    dt_q = bench_prefill(qcfg, args.batch, args.prefill,
                         f"{args.family} W4A4 prefill {lm.n_layers}L",
                         device=dev)
    # serving prefill: the lm_head runs only at the last position
    # (what a generate loop actually dispatches before decoding)
    dt_s = bench_prefill(
        qcfg, args.batch, args.prefill,
        f"{args.family} W4A4 serve-prefill {lm.n_layers}L",
        last_only=True, device=dev)
    out = {"family": args.family, "mode": "prefill",
           "site_layout": layout,
           "n_layers": lm.n_layers, "batch": args.batch,
           "prefill": args.prefill,
           "tokens_per_s": round(args.batch * args.prefill / dt_q, 1),
           "ms_per_prefill": round(dt_q * 1e3, 1),
           "int8_mfu_pct": round(
               matmul_flops(lm, m) / dt_q / PEAK_INT8 * 100, 1),
           "serve_ms_per_prefill": round(dt_s * 1e3, 1),
           "serve_tokens_per_s": round(
               args.batch * args.prefill / dt_s, 1),
           "serve_int8_mfu_pct": round(
               matmul_flops(lm, m, head_m=args.batch) / dt_s
               / PEAK_INT8 * 100, 1)}
    if args.no_baseline:
        return out
    # depth-matched bf16 comparison at the largest depth that fits
    budget = memory_budget(dev)
    d = lm.n_layers
    while d > 1 and bf16_bytes(dataclasses.replace(lm, n_layers=d),
                               args.batch, args.prefill,
                               qcfg.max_seq) > budget:
        d -= 1
    lm_d = dataclasses.replace(lm, n_layers=d)
    dt_b = bench_prefill(
        eng.EngineConfig(lm=lm_d, weight_mode="bf16", act_bits=0,
                         kv_int8=False, max_seq=qcfg.max_seq),
        args.batch, args.prefill, f"{args.family} bf16 prefill {d}L",
        device=dev)
    if d == lm.n_layers:
        dt_qd = dt_q
    else:
        dt_qd = bench_prefill(
            dataclasses.replace(qcfg, lm=lm_d), args.batch, args.prefill,
            f"{args.family} W4A4 prefill {d}L (depth-matched)", device=dev)
    out.update(
        bf16_layers=d,
        bf16_ms_per_prefill=round(dt_b * 1e3, 1),
        bf16_mfu_pct=round(
            matmul_flops(lm_d, m) / dt_b / PEAK_BF16 * 100, 1),
        vs_bf16_depth_matched=round(dt_b / dt_qd, 2))
    return out


def _decode_mode(args, lm, qcfg, layout, dev) -> Dict:
    tps_q = bench_decode(qcfg, args.batch, args.prefill, args.decode,
                         f"{args.family} W4A4+int8KV {lm.n_layers}L "
                         f"[{layout}]", device=dev)
    out = {"family": args.family, "n_layers": lm.n_layers,
           "d_model": lm.d_model, "vocab": lm.vocab_size,
           "site_layout": layout,
           "batch": args.batch, "prefill": args.prefill,
           "tokens_per_s": round(tps_q, 1),
           "ms_per_step": round(args.batch / tps_q * 1e3, 2)}
    if args.no_baseline:
        return out
    need = bf16_bytes(lm, args.batch, args.prefill, qcfg.max_seq)
    budget = memory_budget(dev)
    if need <= budget:
        bcfg = eng.EngineConfig(lm=lm, weight_mode="bf16", act_bits=0,
                                kv_int8=False, max_seq=qcfg.max_seq)
        tps_b = bench_decode(bcfg, args.batch, args.prefill, args.decode,
                             f"{args.family} bf16 {lm.n_layers}L",
                             device=dev)
        out["bf16_tokens_per_s"] = round(tps_b, 1)
        out["vs_bf16"] = round(tps_q / tps_b, 2)
    else:
        out["bf16_note"] = (f"bf16 needs ~{need / 1e9:.1f} GB > "
                            f"{budget / 1e9:.0f} GB budget; not attempted")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", choices=sorted(FAMILIES), required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prefill", type=int, default=512)
    ap.add_argument("--decode", type=int, default=64)
    ap.add_argument("--no-baseline", action="store_true")
    ap.add_argument("--linear-sites", action="store_true",
                    help="serve GPT-2 families with per-OUT-channel "
                         "(Linear-layout) quantization instead of the "
                         "reference's per-IN-channel Conv1D semantics: "
                         "the layout that keeps every site on the int8 "
                         "stream (set conv1d_sites=False when importing "
                         "to use it in production)")
    ap.add_argument("--mode", choices=("decode", "prefill"),
                    default="decode",
                    help="prefill: compute-bound side — full-forward "
                         "tokens/s and int8 MFU at full depth, plus a "
                         "depth-matched bf16 comparison")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    lm = FAMILIES[args.family]()
    max_seq = args.prefill + args.decode + 32
    over = {"max_seq": max_seq}
    if args.linear_sites:
        over["conv1d_sites"] = False
    lm = dataclasses.replace(lm, **over)
    qcfg = eng.EngineConfig(lm=lm, weight_mode="w4", act_bits=4,
                            kv_int8=True, max_seq=max_seq,
                            lm_head_int8=True)
    layout = "conv1d(kscale,f32-dequant)" if conv1d_site_names(lm) \
        else "linear(int8-stream)"
    mode = _prefill_mode if args.mode == "prefill" else _decode_mode
    print(json.dumps(mode(args, lm, qcfg, layout, dev)), flush=True)


if __name__ == "__main__":
    main()
