#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (numbers unrounded):
1. device: the card's name and power limit (and nvidia-smi's own line);
2. build: compile every CUDA kernel of the port from the sources in this
   checkout (one nvcc per source, all at once) and time it;
3. hbm: the card's copy bandwidth, from a large device-to-device copy;
4. kernel checks: each kernel against its plain PyTorch version on the
   card, at the OPT-6.7B shapes of the main path: K1 bit-equal, K2 within
   atol 2e-2 + rtol 1e-2 (bf16 output) and atol 1e-4 (f32 output);
5. main path: the OPT-6.7B W4A4 + INT8-KV + int8-lm_head engine at full
   width and depth (32 layers), random weights from a seeded generator,
   served through ``Engine.prefill`` (bs 4 x 512 tokens) and 64 greedy
   ``Engine.decode`` steps; the kernels' launch counts are read around
   exactly this run, and the plain versions must not have run;
6. kernel times at the main path's decode shapes (CUDA graphs of many
   launches, layers rotated so weights come from device memory), beside
   the plain versions, one library call for the same work, and the bound
   (the larger of bytes over 3.35 TB/s and operations over the peak rate
   of their type, H100 SXM data sheet);
7. profile: torch.profiler over one prefill and a few decode steps of
   the main-path engine: device time by kernel and the device's busy
   share of the wall time;
8. in situ: the same engine at 2 layers, prefill + 8 greedy steps: every
   kernel call checked against its plain version on the same inputs, and
   a run with K1's plain version that must give identical greedy tokens
   and logits (see ``phase_insitu`` for why the all-plain run is only
   reported).

Then the ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the
last line. Without a CUDA device, or without the package beside this
file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

REPO = os.path.dirname(os.path.abspath(__file__))

# OPT-6.7B geometry, as bench.py serves it
BATCH, PREFILL, DECODE = 4, 512, 64
MAX_SEQ = PREFILL + DECODE + 32
HBM_BPS = 3.35e12          # H100 SXM data sheet
INT8_OPS = 1.979e15        # dense int8 tensor-core peak
F32_FLOPS = 67e12          # f32 outside the tensor cores
# K2 agrees with its plain version within atol + rtol * |plain|: in bf16
# one output step is up to 2^-7 of the value, so a summation-order
# difference may move an output by one step
K2_TOL = {"bf16": (2e-2, 1e-2), "f32": (1e-4, 0.0)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(line, flush=True)
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    emit({"phase": "device", "name": name, "nvidia_smi": line,
          "capability": list(cap), "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    if cap != (9, 0):
        fail(f"the kernels are built for sm_90a, card is sm_{cap[0]}{cap[1]}")
    return name, line


def phase_build(ext):
    t0 = time.perf_counter()
    reports = ext.build_all()
    secs = time.perf_counter() - t0
    ptxas = [ln.strip() for rep in reports.values() for ln in rep.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": secs, "sources": list(ext.SOURCES),
          "ptxas": ptxas})


def cuda_ms(torch, fn, iters: int, graph: bool = True) -> float:
    """Device milliseconds per call of ``fn(i)``: ``iters`` calls captured
    into one CUDA graph (so host launch costs do not hide the device
    time), replayed between CUDA events."""
    for i in range(2):
        fn(i)
    torch.cuda.synchronize()
    if graph:
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=s):
            for i in range(iters):
                fn(i)
        run = g.replay
    else:
        def run():
            for i in range(iters):
                fn(i)
    run()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    run()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def phase_hbm(torch):
    n = 1 << 30
    a = torch.empty(n, dtype=torch.uint8, device="cuda")
    b = torch.empty_like(a)
    ms = cuda_ms(torch, lambda i: b.copy_(a), 10, graph=False)
    rate = 2 * n / (ms * 1e-3)
    emit({"phase": "hbm", "copy_bytes": 2 * n, "ms": ms,
          "bytes_per_s": rate})
    del a, b
    return rate


def k2_close(torch, got, want, tag: str) -> bool:
    atol, rtol = K2_TOL[tag]
    got, want = got.float(), want.float()
    return bool(torch.isfinite(got).all()) and bool(
        ((got - want).abs() <= atol + rtol * want.abs()).all())


def _k1_operands(torch, M, K, N, L, gen):
    import numpy as np
    from ant_quantization_tpu_torch.kernels.qmatmul import int8_codebook
    from ant_quantization_tpu_torch.numerics import codebooks as cb
    aq16, a_unit, _ = int8_codebook(cb.ant_grid("flint", 4, False))
    a_q = torch.tensor(np.stack([aq16] * L).astype(np.float32),
                       device="cuda")
    # a power of two, so the midpoints placed below survive x / a_scale
    a_scale = torch.full((L,), 0.25, device="cuda")
    w = torch.randint(-64, 64, (L, N, K), dtype=torch.int8, device="cuda",
                      generator=gen)
    scales = torch.rand((L, N), device="cuda", generator=gen) * 1e-3
    x = torch.randn((M, K), device="cuda", generator=gen) * 2
    l = L - 1
    mids = (a_q[l, 1:] + a_q[l, :-1]) * 0.5
    x[0, :mids.shape[0]] = mids * a_scale[l]     # exact midpoint ties
    return x, w, scales, a_q, a_scale, l


def phase_checks(torch, gen):
    from ant_quantization_tpu_torch.kernels import attention as k2
    from ant_quantization_tpu_torch.kernels import stacked as k1
    from ant_quantization_tpu_torch.models.transformer_lm import alibi_slopes
    d, ff = 4096, 16384
    k1_err = 0.0
    for (K, N) in ((d, d), (d, ff), (ff, d)):
        for M in (4, 64):
            x, w, sc, aq, asc, l = _k1_operands(torch, M, K, N, 2, gen)
            got = k1.stacked_quant_matmul(l, x, w, sc, aq, asc)
            want = k1.stacked_quant_matmul_plain(l, x, w, sc, aq, asc)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            equal = torch.equal(got, want)
            emit({"phase": "check", "kernel": "K1", "M": M, "K": K, "N": N,
                  "layer": l, "max_abs_err": err, "bit_equal": equal})
            if not equal:
                fail(f"K1 differs from its plain version at M={M} K={K} "
                     f"N={N} (max abs err {err})")
            k1_err = max(k1_err, err)
    B, H, D, S, L = 4, 32, 128, MAX_SEQ, 2
    k = torch.randint(-127, 128, (L, B, H, S, D), dtype=torch.int8,
                      device="cuda", generator=gen)
    v = torch.randint(-127, 128, (L, B, H, S, D), dtype=torch.int8,
                      device="cuda", generator=gen)
    ks = torch.rand((L, B, H, S), device="cuda", generator=gen) * 0.02
    vs = torch.rand((L, B, H, S), device="cuda", generator=gen) * 0.02
    slopes = torch.tensor(alibi_slopes(H), dtype=torch.float32,
                          device="cuda")
    k2_err = {"bf16": 0.0, "f32": 0.0}
    cases = [(1, [0, 0, 0, 0]), (1, [512] * 4), (1, [0, 100, 333, S - 1]),
             (512, [0] * 4), (512, [0, 17, 50, S - 512])]
    for T, p0 in cases:
        q = torch.randn((B, H, T, D), device="cuda", generator=gen)
        pos0 = torch.tensor(p0, dtype=torch.int32, device="cuda")
        for sl in (None, slopes):
            for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
                got = k2.stacked_int8_kv_attention(1, q, k, v, ks, vs, pos0,
                                                   sl, out_dtype=dt)
                want = k2.stacked_int8_kv_attention_plain(
                    1, q, k, v, ks, vs, pos0, sl, out_dtype=dt)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ok = k2_close(torch, got, want, tag)
                emit({"phase": "check", "kernel": "K2", "T": T, "pos0": p0,
                      "alibi": sl is not None, "out": tag,
                      "max_abs_err": err, "atol_rtol": K2_TOL[tag],
                      "pass": ok})
                if not ok:
                    fail(f"K2 differs from its plain version: T={T} "
                         f"pos0={p0} {tag} err {err}")
                k2_err[tag] = max(k2_err[tag], err)
    return k1_err, k2_err


def random_engine_params(torch, cfg, seed: int):
    """Random W4A4 engine params built on the card, one site at a time,
    from a seeded generator (the construction bench.py uses: int8
    codebook values in [-64, 64), flint grids, alpha 3)."""
    import numpy as np
    from ant_quantization_tpu_torch.kernels.qmatmul import int8_codebook
    from ant_quantization_tpu_torch.numerics import codebooks as cb
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    c = cfg.lm
    L, d = c.n_layers, c.d_model
    _, w_unit, _ = int8_codebook(cb.ant_grid("flint", 4, True))
    agrid = cb.ant_grid("flint", 4, False)
    aq16, a_unit, _ = int8_codebook(agrid)
    a_scale = np.float32(3.0) / np.float32(np.max(agrid)) * np.float32(a_unit)
    shapes = {"q": (d, d), "k": (d, d), "v": (d, d), "out": (d, d),
              "fc_in": (d, c.d_ff), "fc_out": (c.d_ff, d)}
    layers = {}
    for name, (K, N) in shapes.items():
        layers[name] = {
            "w_i8": torch.randint(-64, 64, (L, N, K), dtype=torch.int8,
                                  device="cuda", generator=gen),
            "oscale": torch.full((L, N), 2e-3 * w_unit, device="cuda"),
            "bias": torch.zeros((L, N), device="cuda"),
            "a_q": torch.tensor(np.stack([aq16] * L).astype(np.float32),
                                device="cuda"),
            "a_scale": torch.full((L,), float(a_scale), device="cuda"),
        }
    for name in ("ln_1", "ln_2"):
        layers[name] = {"scale": torch.ones((L, d), device="cuda"),
                        "bias": torch.zeros((L, d), device="cuda")}
    top = {
        "wpe": (torch.randn((cfg.max_seq + 2, d), device="cuda",
                            generator=gen) * 0.02).to(cfg.dtype),
        "wte_i8": torch.randint(-127, 128, (c.vocab_size, d),
                                dtype=torch.int8, device="cuda",
                                generator=gen),
        "wte_scale": torch.full((c.vocab_size,), 0.02 / 127.0,
                                device="cuda"),
        "ln_f": {"scale": torch.ones((d,), device="cuda"),
                 "bias": torch.zeros((d,), device="cuda")},
    }
    return {"layers": layers, "top": top}


def opt_engine_config(n_layers: int, dtype):
    import dataclasses
    from ant_quantization_tpu_torch.models.transformer_lm import opt_config
    from ant_quantization_tpu_torch.serve.engine import EngineConfig
    lm = dataclasses.replace(opt_config("6.7b"), n_layers=n_layers,
                             max_seq=MAX_SEQ)
    return EngineConfig(lm=lm,
                        weight_mode="w4", act_bits=4, kv_int8=True,
                        lm_head_int8=True, max_seq=MAX_SEQ, dtype=dtype)


def reset_counts():
    from ant_quantization_tpu_torch.kernels import attention as k2
    from ant_quantization_tpu_torch.kernels import stacked as k1
    for counts in (k1.COUNTS, k2.COUNTS):
        for key in counts:
            counts[key] = 0
    return k1.COUNTS, k2.COUNTS


def phase_main(torch, gen, n_layers: int = 32):
    from ant_quantization_tpu_torch.serve.engine import Engine
    cfg = opt_engine_config(n_layers, torch.bfloat16)
    c = cfg.lm
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = Engine(cfg, random_engine_params(torch, cfg, seed=0), BATCH)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ids = torch.randint(0, c.vocab_size, (BATCH, PREFILL), device="cuda",
                        generator=gen)
    # warm-up (library handles, allocator); its cache writes are
    # overwritten by the measured run
    engine.decode(engine.prefill(ids[:, :32])[:, -1].argmax(-1, True))
    torch.cuda.synchronize()

    k1c, k2c = reset_counts()
    t0 = time.perf_counter()
    logits = engine.prefill(ids)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    tokens = [logits[:, -1].argmax(-1, keepdim=True)]
    block, blocks = 8, DECODE // 8
    block_ms = []
    for _ in range(blocks):
        t0 = time.perf_counter()
        for _ in range(block):
            logits = engine.decode(tokens[-1])
            tokens.append(logits[:, -1].argmax(-1, keepdim=True))
        torch.cuda.synchronize()
        block_ms.append((time.perf_counter() - t0) * 1e3 / block)
    counts = {"K1": dict(k1c), "K2": dict(k2c)}
    reset_counts()

    toks = torch.cat(tokens, 1)
    finite = bool(torch.isfinite(logits).all())
    step_ms = statistics.median(block_ms)
    res = {"phase": "main_path", "model": "OPT-6.7B", "layers": c.n_layers,
           "d_model": c.d_model, "batch": BATCH, "prefill_tokens": PREFILL,
           "decode_steps": DECODE, "param_build_s": build_s,
           "prefill_ms": prefill_ms, "decode_ms_per_step": step_ms,
           "decode_block_ms_per_step": block_ms,
           "decode_tokens_per_s": BATCH / (step_ms * 1e-3),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "logits_shape": list(logits.shape), "logits_finite": finite,
           "launches": counts}
    emit(res)
    want_k1 = 6 * c.n_layers * DECODE
    want_k2 = c.n_layers * (1 + DECODE)
    if not finite or list(logits.shape) != [BATCH, 1, c.vocab_size]:
        fail("main path logits are not finite (B, 1, V)")
    if toks.min() < 0 or toks.max() >= c.vocab_size:
        fail("main path tokens out of range")
    if counts["K1"]["launches"] != want_k1 or \
            counts["K2"]["launches"] != want_k2:
        fail(f"launch counts {counts}, want K1 {want_k1}, K2 {want_k2}")
    if counts["K1"]["plain_calls"] or counts["K2"]["plain_calls"]:
        fail(f"plain versions ran on the main path: {counts}")
    return engine, counts, ids


def k1_bound(M, K, N, G=16):
    byts = K * N + 4 * M * K + 4 * M * N + 4 * N + 4 * G + 4
    ops = 2 * M * K * N
    return byts, ops, max(byts / HBM_BPS, ops / INT8_OPS) * 1e3


def k2_bound(B, H, T, D, S, pos0):
    vis = [min(p + t + 1, S) for p in pos0 for t in range(T)]
    keys = sum(min(p + T, S) for p in pos0)       # each key read once
    byts = keys * H * (2 * D + 8) + B * H * T * D * (4 + 2) + 4 * B + 4 * H
    ops = sum(vis) * H * 4 * D
    t_b, t_o = byts / HBM_BPS, ops / F32_FLOPS
    return byts, ops, max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else \
        "operations"


def phase_times(torch, engine):
    """Kernel, plain and library times at the main path's decode shapes,
    on the engine's own 32-layer stacks and cache."""
    import torch.nn.functional as F
    from ant_quantization_tpu_torch.kernels import attention as k2
    from ant_quantization_tpu_torch.kernels import stacked as k1
    from ant_quantization_tpu_torch.kernels.kv_cache import dequant_kv
    from ant_quantization_tpu_torch.ops.snap import snap_value
    ep, kv = engine.engine_params(), engine.cache()
    L = engine.cfg.lm.n_layers
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    M = BATCH
    sites = []
    for name, s in ep["layers"].items():
        if name not in ("q", "k", "v", "out", "fc_in", "fc_out"):
            continue
        w, aq, asc = s["w_i8"], s["a_q"], s["a_scale"]
        sc = asc[:, None] * s["oscale"]
        N, K = w.shape[1:]
        x = torch.randn((M, K), device="cuda", generator=gen)
        xq = snap_value(x / asc[0], aq[0]).to(torch.int8)
        xq_pad = torch.cat([xq, xq.new_zeros((32 - M, K))])
        iters = 2 * L
        t_k = cuda_ms(torch, lambda i: k1.stacked_quant_matmul(
            i % L, x, w, sc, aq, asc), iters)
        t_p = cuda_ms(torch, lambda i: k1.stacked_quant_matmul_plain(
            i % L, x, w, sc, aq, asc), iters)
        t_l = cuda_ms(torch, lambda i: torch._int_mm(xq_pad, w[i % L].t()),
                      iters)
        byts, ops, bound = k1_bound(M, K, N, aq.shape[1])
        sites.append({"site": name, "M": M, "K": K, "N": N, "ms": t_k,
                      "plain_ms": t_p, "library_ms": t_l, "bound_ms": bound,
                      "bytes": byts, "ops": ops})
    B, H, D = BATCH, engine.cfg.lm.n_heads, engine.cfg.lm.head_dim
    S = kv.k.shape[3]
    k2_rows = []
    for T, p in ((1, PREFILL + DECODE - 1), (PREFILL, 0)):
        pos0 = torch.full((B,), p, dtype=torch.int32, device="cuda")
        q = torch.randn((B, H, T, D), device="cuda", generator=gen)
        n_l = L if T == 1 else 4
        iters = 2 * n_l
        t_k = cuda_ms(torch, lambda i: k2.stacked_int8_kv_attention(
            i % n_l, q, kv.k, kv.v, kv.k_scale, kv.v_scale, pos0), iters)
        t_p = cuda_ms(torch, lambda i: k2.stacked_int8_kv_attention_plain(
            i % n_l, q, kv.k, kv.v, kv.k_scale, kv.v_scale, pos0), iters)
        kd, vd = [], []
        for l in range(n_l):
            kl, vl = dequant_kv(type(kv)(*(a[l] for a in kv)), torch.bfloat16)
            kd.append(kl[:, :, :p + T])
            vd.append(vl[:, :, :p + T])
        qb = q.to(torch.bfloat16)
        if T == 1:
            t_l = cuda_ms(torch, lambda i: F.scaled_dot_product_attention(
                qb, kd[i % n_l], vd[i % n_l]), iters)
        else:
            t_l = cuda_ms(torch, lambda i: F.scaled_dot_product_attention(
                qb, kd[i % n_l], vd[i % n_l], is_causal=True), iters)
        del kd, vd
        byts, ops, bound, by = k2_bound(B, H, T, D, S, [p] * B)
        k2_rows.append({"T": T, "pos0": p, "B": B, "H": H, "S": S,
                        "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                        "bound_ms": bound, "bound_by": by, "bytes": byts,
                        "ops": ops})
    emit({"phase": "kernel_times", "graphed": True, "K1_sites": sites,
          "K2": k2_rows})
    return sites, k2_rows


def _profiled(torch, fn):
    """Run ``fn`` under torch.profiler: wall microseconds and the device
    kernels' (self device microseconds, name, count), largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:          # the name before torch 2.4
            us = ev.self_cuda_time_total
        if ev.device_type == DeviceType.CUDA and us > 0:
            rows.append((us, ev.key, ev.count))
    return wall_us, sorted(rows, reverse=True)


def phase_profile(torch, engine, ids, steps: int = 4):
    """Device time by kernel for one prefill and for ``steps`` decode
    steps of the main-path engine, and the device's busy share of their
    wall time (one stream, so the kernel times add up to busy time)."""
    out = {"phase": "profile"}
    tok = ids[:, :1]

    def decode():
        nonlocal tok
        for _ in range(steps):
            tok = engine.decode(tok)[:, -1].argmax(-1, keepdim=True)

    for tag, fn, n in (("prefill", lambda: engine.prefill(ids), 1),
                       ("decode", decode, steps)):
        wall_us, rows = _profiled(torch, fn)
        busy = sum(r[0] for r in rows)
        out[tag] = {"calls": n, "wall_us_per_call": wall_us / n,
                    "device_us_per_call": busy / n,
                    "device_busy_share": busy / wall_us,
                    "kernels_us_per_call": [
                        {"name": k[:100], "us": us / n, "count": c / n}
                        for us, k, c in rows[:10]]}
    emit(out)


def _greedy(torch, eng, cfg, ep, ids, k1fn, k2fn, steps: int = 8):
    """Prefill + ``steps`` greedy decode steps of a fresh engine, with the
    engine's K1 / K2 entry points replaced by ``k1fn`` / ``k2fn``."""
    with mock.patch.object(eng, "stacked_quant_matmul", k1fn), \
            mock.patch.object(eng, "stacked_int8_kv_attention", k2fn):
        engine = eng.Engine(cfg, ep, BATCH)
        logits = [engine.prefill(ids)]
        toks = [logits[-1][:, -1].argmax(-1, keepdim=True)]
        for _ in range(steps):
            logits.append(engine.decode(toks[-1]))
            toks.append(logits[-1][:, -1].argmax(-1, keepdim=True))
    torch.cuda.synchronize()
    return torch.cat(toks, 1), torch.cat(logits, 1).float()


def phase_insitu(torch, gen):
    """The main-path engine at 2 layers and full width, three runs:

    A: the kernels, each call checked against its plain version on the
       same inputs (the engine's real activations and cache);
    B: K1's plain version with the K2 kernel: K1 is bit-exact, so greedy
       tokens and logits must equal run A's exactly;
    C: both plain versions, reported only: K2's other summation order
       moves an attention output by ~1e-6, which moves some of the
       millions of activations across an A4 snap midpoint at the next
       site, and each such step cascades through the quantized layers,
       so C's logits differ from A's by far more than K2's error.
    """
    from ant_quantization_tpu_torch.kernels import attention as k2
    from ant_quantization_tpu_torch.kernels import stacked as k1
    from ant_quantization_tpu_torch.serve import engine as eng
    cfg = opt_engine_config(2, torch.bfloat16)
    ep = random_engine_params(torch, cfg, seed=1)
    ids = torch.randint(0, cfg.lm.vocab_size, (BATCH, PREFILL),
                        device="cuda", generator=gen)
    stats = {"K1": {"calls": 0, "max_abs_err": 0.0, "unequal": 0},
             "K2": {"calls": 0, "max_abs_err": 0.0, "outside_tol": 0}}

    def k1_checked(*args):
        out = k1.stacked_quant_matmul(*args)
        want = k1.stacked_quant_matmul_plain(*args)
        st = stats["K1"]
        st["calls"] += 1
        st["max_abs_err"] = max(st["max_abs_err"],
                                (out - want).abs().max().item())
        st["unequal"] += int(not torch.equal(out, want))
        return out

    def k2_checked(*args, **kw):
        out = k2.stacked_int8_kv_attention(*args, **kw)
        want = k2.stacked_int8_kv_attention_plain(*args, **kw)
        st = stats["K2"]
        st["calls"] += 1
        st["max_abs_err"] = max(st["max_abs_err"], (
            out.float() - want.float()).abs().max().item())
        st["outside_tol"] += int(not k2_close(torch, out, want, "bf16"))
        return out

    k1c, k2c = reset_counts()
    ta, la = _greedy(torch, eng, cfg, ep, ids, k1_checked, k2_checked)
    launched = (k1c["launches"], k2c["launches"])
    tb, lb = _greedy(torch, eng, cfg, ep, ids,
                     k1.stacked_quant_matmul_plain,
                     k2.stacked_int8_kv_attention)
    tc, lc = _greedy(torch, eng, cfg, ep, ids,
                     k1.stacked_quant_matmul_plain,
                     k2.stacked_int8_kv_attention_plain)
    res = {"phase": "in_situ", "layers": 2, "dtype": "bfloat16",
           "decode_steps": 8, "per_call": stats,
           "k2_atol_rtol": K2_TOL["bf16"],
           "launches": launched,
           "k1_swap_tokens_identical": torch.equal(ta, tb),
           "k1_swap_logits_identical": torch.equal(la, lb),
           "all_plain_tokens_identical": torch.equal(ta, tc),
           "all_plain_logits_max_abs_err": (la - lc).abs().max().item(),
           "logits_finite": bool(torch.isfinite(la).all())}
    res["pass"] = (
        stats["K1"]["calls"] > 0 and stats["K1"]["unequal"] == 0
        and stats["K2"]["calls"] > 0 and stats["K2"]["outside_tol"] == 0
        and all(launched) and res["k1_swap_tokens_identical"]
        and res["k1_swap_logits_identical"] and res["logits_finite"])
    emit(res)
    if not res["pass"]:
        fail(f"in-situ check: {res}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from ant_quantization_tpu_torch import _ext
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    name, smi = phase_device(torch)
    phase_build(_ext)
    hbm = phase_hbm(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    k1_err, k2_err = phase_checks(torch, gen)
    engine, counts, ids = phase_main(torch, gen)
    sites, k2_rows = phase_times(torch, engine)
    phase_profile(torch, engine, ids)
    del engine
    torch.cuda.empty_cache()
    phase_insitu(torch, gen)

    dec, pre = k2_rows
    kernels = [
        {"name": "stacked_quant_matmul (K1)", "route": "cuda",
         "source": "ant_quantization_tpu_torch/csrc/stacked_i8.cu",
         "replaces": "ant_quantization_tpu/kernels/stacked.py:453",
         "launches": counts["K1"]["launches"], "max_abs_err": k1_err,
         "pass": True,
         "ms_per_launch": {x["site"]: x["ms"] for x in sites},
         "at": "one decode layer: the 6 site launches at M=4 "
               "(q, k, v, out 4096x4096; fc_in 4096x16384; "
               "fc_out 16384x4096)",
         "ms": sum(s["ms"] for s in sites),
         "plain_ms": sum(s["plain_ms"] for s in sites),
         "bound_ms": sum(s["bound_ms"] for s in sites), "bound_by": "bytes",
         "library_ms": sum(s["library_ms"] for s in sites)},
        {"name": "stacked_int8_kv_attention (K2)", "route": "cuda",
         "source": "ant_quantization_tpu_torch/csrc/int8_kv_attention.cu",
         "replaces": "ant_quantization_tpu/kernels/attention.py:207",
         "launches": counts["K2"]["launches"],
         "max_abs_err": max(k2_err.values()),
         "max_abs_err_by_out": k2_err, "pass": True,
         "ms_per_launch": {"decode T=1": dec["ms"],
                           f"prefill T={pre['T']}": pre["ms"]},
         "at": f"one decode launch: B={dec['B']} H={dec['H']} T=1 D=128 "
               f"at position {dec['pos0']}, cache S={dec['S']}",
         "ms": dec["ms"], "plain_ms": dec["plain_ms"],
         "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
         "library_ms": dec["library_ms"]},
    ]
    emit({"kernels": kernels, "card": smi, "hbm_copy_bytes_per_s": hbm,
          "seconds": time.perf_counter() - t_start})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
