#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (numbers unrounded):
1. device: the card's name and power limit (and nvidia-smi's own line);
2. build: compile every CUDA kernel of the port from the sources in this
   checkout (one nvcc per source, all at once) and time it;
3. hbm: the card's copy bandwidth, from a large device-to-device copy;
4. kernel checks: each kernel against its plain PyTorch version on the
   card, at the OPT-6.7B shapes of the main path: K1 bit-equal (M 1, 2,
   3, 4, 5, 16, 64, 65, 200 and 256 at the OPT sites, BLOOM's fused qkv
   and an N off its column tile), K2 within
   atol 2e-2 + rtol 1e-2 (bf16 q and output) and atol 1e-4 (f32) at T 1,
   5 and 16 (positions split across blocks) and 17, 100 and 512 (bf16
   tensor cores), pos0 0 and ragged with a last query at S - 1, ALiBi on
   and off;
5. main path: the OPT-6.7B W4A4 + INT8-KV + int8-lm_head engine at full
   width and depth (32 layers), random weights from a seeded generator,
   served through ``Engine.prefill`` (bs 4 x 512 tokens) and 64 greedy
   ``Engine.decode`` steps; the kernels' launch counts are read around
   exactly this run, and the plain versions must not have run;
6. kernel times at the main path's decode shapes (CUDA graphs of many
   launches, layers rotated so weights come from device memory), beside
   the plain versions, one library call for the same work, and the bound
   (the larger of bytes over 3.35 TB/s and operations over the peak rate
   of their type, H100 SXM data sheet: attention's at the bf16 tensor-core
   rate, the int8 products' at the int8 one); K2 also at T = 512;
7. profile: torch.profiler over one prefill and a few decode steps of
   the main-path engine: device time by kernel and the device's busy
   share of the wall time;
8. in situ: the same engine at 2 layers, prefill + 8 greedy steps: every
   kernel call checked against its plain version on the same inputs, and
   a run with K1's plain version that must give identical greedy tokens
   and logits (see ``phase_insitu`` for why the all-plain run is only
   reported);
9. OliVe main path: OPT-6.7B under full OliVe W4A4 (OVP weights packed
   on the card by ``quantize_weights_ovp_i8``, OVP activations at all six
   sites), INT8 KV and the int8 head, DEPTHS["olive"] (6) layers, full
   width, served as in
   5: every decode site matmul runs K4 (launches counted as in 5), then
   the observed share of OVP outliers and victims in the weights and in
   the decode activations, which must be above 0;
10. OVP-weights path: the same OVP weights with int8-exact A4 inputs
   through ``Engine``: decode runs K3;
11. K3 and K4 times at one decode layer's six sites, their launch plans
   and K1 on the same weight stream, with the plain versions, the bound
   and ``torch._int_mm`` on the same int8 weight stream as a reference
   point (not the same function), and profiles of the OliVe and
   OVP-weights engines as in 7;
12. in situ, OliVe: a 2-layer full-OliVe engine with every K4 call
   checked against its plain version, and runs with K4's (and, on the
   OVP-weights route, K3's) plain version that must give identical
   greedy tokens and logits;
13. stacked_prefill (K5): the ANT main path's params, and then the
   OVP-weights params, served by a second ``Engine`` with
   ``stacked_prefill=True``: one prefill whose site matmuls all launch
   K5 (192), logits bit-equal to the unstacked prefill (OVP weights:
   within SP_OVP_RTOL), 8 greedy steps each; K5 times at one prefill
   layer (M = 2048) beside the torch route it replaces, with its snap
   pre-kernel timed alone beside that one's byte bound; K5's OVP mode
   alone on the OVP-weights stacks; a profile of each stacked prefill; and
   in situ at 2 layers, every K5 call checked and a swap for its plain
   version that must give identical tokens and logits;
14. w4pack path: OPT-6.7B with packed 4-bit weights built on the card
   by ``quantize_weights_w4`` (ANT int grid at q/k/v: affine decode;
   flint elsewhere: table decode), DEPTHS["w4pack"] (8) layers, served
   as in 5: decode runs K6 (6 per layer and step), prefill K8 (6 per
   layer); K6 times at one decode layer (with
   each launch's plan, and its fixed cost per launch from the line through
   its two table-decoded sites, out at 4096 x 4096 and fc_in) and K8
   times at one prefill layer beside their bounds,
   plain versions and library calls; a profile; and in situ at 2 layers
   (every K6 call
   bit-equal, every K8 call within K8_RTOL, a K6 swap with identical
   tokens and logits);
15. bloom_main: BLOOM-7b1 at full width (DEPTHS["bloom"], 6 of its 30
   layers, fused qkv at N = 12,288, embed_ln, ALiBi, GELU, vocab 250,880),
   ANT W4A4 + INT8 KV + int8 head, max_seq 2048, served as in 5: decode
   runs K1 (4 per layer and step), attention K2; a profile;
16. bloom_ragged: the same engine on prompts of 512/384/256/128 tokens,
   bucket-padded, ``Engine.prefill(ids, lengths)`` and 16 greedy steps at
   per-sequence positions (K1, K2 counted); each sequence's largest
   logit difference against serving it alone at B = 1; a forward with a
   (B,) pos0 of equal entries bit-equal to the scalar one;
17. bloom_long: the same params at max_seq 16,384 (DEPTHS["bloom_long"],
   4 layers), where the reference
   leaves its stacked attention kernel: a 4 x 15,872-token prompt in 31
   forward calls of 512 (the einsum fallback), then 64 greedy steps with
   attention on K7 (K2 0); a decode profile; K7 times per decode
   layer beside its bound, its plain version and SDPA;
18. K9 times at OPT-6.7B fc_in and fc_out, M 4 and 2048, beside its
   bound, its plain version and ``torch._int_mm``;
19. in situ, BLOOM: 2 layers on the long cache, every K7 call checked
   against its plain version, and K9 run and checked bit for bit at every
   site matmul on the engine's own activations (no engine path calls K9);
20. scheduler: a ``ContinuousBatcher`` over the OPT-6.7B ANT W4A4 engine
   (DEPTHS["serving"], 8 layers; 4 slots, buckets 32/128/512; 10 requests of 20-512
   prompt tokens and 16-64 new tokens, 3 with an eos that fires early),
   run with ticks_per_dispatch 1, 8, 8, 1: completed tokens and ticks per
   second, K1 and K2 launches per tick and prefill, and every completion
   against the same engine serving its prompt alone (identical tokens, or
   a first divergence within ``margin_tol``);
21. speculative: that engine as target with a 6-layer draft, k 4:
   t_plain, t_verify, t_draft, ``generate`` at 1 and 8 rounds per call
   (launches counted), K1 at M = 20 and K2 at T = 5 row-for-row against
   M = 4 and T = 1, and draft = target accepting k in every round with
   the stream of plain greedy decoding;
22. w4a16: "w4" without activation quantization on the same int8 weights
   (INT8 KV, int8 head), served as in 5 (K2 only), with its stream floor,
   one decode step held against the same forward on ``f32_product``
   (``hold_decode_step``) and a profile;
23. bf16_baseline: ``weight_mode="bf16", act_bits=0, kv_int8=False`` and
   the plain head, the baseline of bench.py, OPT-6.7B 32 layers, served
   as in 5 (no kernel of the port launches), with its stream floor, a
   decode step held as in 22 and a profile;
24. gpt2_main: GPT-2 XL at full width (DEPTHS["gpt2"], 6 of its 48
   layers, d_model 1600,
   25 heads of 64, d_ff 6400, vocab 50,257, every site Conv1D, quantized
   per input channel on the card into ``kscale``), ANT W4A4 + INT8 KV +
   int8 head, served as in 5: the reference's all-or-nothing rule sends
   every decode site to the Conv1D route (the fake-quant and an f32
   product against the dequantized f32 weight), so K1 launches 0 times
   and K2 once per layer and forward at head_dim 64; its two stream
   floors; K2 times
   at head_dim 64 on its cache and the Conv1D route's times per layer at
   M 4 and 2048 (the route, its dequantization and its f32 product alone);
   a profile;
25. gpt2_olive: the same geometry at DEPTHS["gpt2_olive"] (2) layers under
   full OliVe (OVP weights paired along the output axis, OVP activations
   at alpha about 2.5 times each input's RMS), served as in 5, then its
   OVP shares, which must be above 0, and a profile;
26. in situ, GPT-2: GPT-2 XL width at 2 layers, every K2 call checked
   against its plain version on the engine's activations and cache, and
   the greedy tokens of a run on K2's plain version reported;
27. K7 times at head_dim 80: one BLOOM-3b decode layer at S 16,384;
28. calibrate_serve (run after the kernel checks): the port calibrates
   its own states on the card and serves them. OPT-6.7B at full width
   (2 layers under ANT "ant-int-pot-flint" W4A4, 1 under OliVe), weights
   normal with std 1/sqrt(K) from a seeded generator;
   ``calibrate_on_batches`` on one 4 x 128-token batch (seconds per
   layer, the chosen types per site); the card's ``calibrate`` held
   against the CPU's on layer 0's q and fc_in weights (their first
   channels) and q's input; ``build_engine_params`` from the port's own
   tree: an f32 engine without INT8 KV or int8 head, each of whose site
   matmuls in a 4 x 512 prefill is held against the fake-quant model's
   on the same input (``hold_sites``), its logits against the model's
   reported by the bf16 engine rule; then the
   main-path engine (bf16, INT8 KV, int8 head, max_seq 608), a 4 x 512
   prefill and 16 greedy steps with decode on K1 (ANT) or K4 (OliVe) at
   every site and K2, no plain version (launches counted); OliVe's OVP
   shares of the calibrated weights and of decode activations.

The kernel checks (4) include K3 and K4 against their plain versions,
bit for bit, at M 1, 2, 3, 4, 5, 16, 64 and 200 on K1's five (K, N), K4
on OVP and int8-value weights and signed and unsigned grids, on exact
concat midpoints, padded duplicates and outlier pairs, on adversarial
inputs at K = 4096 and 16384 whose partial sums pass 2^24, on tables whose thresholds fall out of order (K4's
select chain), at a prescale that is no power of two and at negative
scales (the per-element division), each call one launch and one device
kernel; and K6 (M 1, 4, 16, 64 and
300, affine and table decode, at the OPT sites and at K 4160 by N 4104,
each call one launch and one device kernel) and K5 (M 257, 300, 2048 and
4096, int8 values and OVP bytes, both on wgmma, and K3's adversarial
case; the OVP mode also at block_k 64, 128, 256 and 4096; each call the
snap pre-kernel and one product kernel) bit for bit,
K8 (M 4 and 2048, bf16 and f32 x, flint, int and unsigned float grids) within K8_RTOL of each
output's sum of term magnitudes; K7 (S 2048 and 16,384,
T 1, 4 and 16, ragged pos0, ALiBi on and off) within K2's tolerance; K2
and K7 at head_dim 64 (GPT-2 XL: H 25, K2 at S 608) and 80 (BLOOM-3b: H
32, K2 at S 2048 with ALiBi), K2 at T 1, 4, 16, 17 and 512, K7 at S
16,384, T 1, 4 and 16, within K2's tolerance, each call one launch and
one launch's device kernels (the split pass and its combine, or the
prefill kernel); K9
(fc_in and fc_out, M 1, 4, 64, 65, 257, 300 and 2048; K 4160 by N 4104
at M 65 and 300; exact midpoint ties after the multiply by 1 / a_scale)
bit for bit; and the library product of the plain bf16 products
(``f32_out_product``: the dense sites, W4A16, the plain head) against an
f32 product on the same bf16 operands at OPT-6.7B's sites and head, M 4
and 2048, within K8_RTOL of |x| @ |w|, a bound that the f32 result
rounded to bf16 breaks. F5 (ROADMAP Queue 3): ``int8_matmul`` at (32, 12)
x (8, 12) and K = 196, and K1, K3, K4, K5 and K6 at K = 196 by N = 4096,
bit-equal to their plain versions (``phase_checks_f5``); and
``outlier_thresholds`` at 67M elements bit-equal to the reference's f32
arithmetic on the host and within 1e-5 of ``np.percentile``
(``phase_checks_percentile``).

29. encoders (run after serve_cli): the encoder PTQ path, which no
   kernel of the port serves (its products are the fake-quant model's
   f32 ``torch.matmul``, as the reference's are XLA dots): the port's
   ``glue_run`` on BERT-base at full width and depth on a generated
   SST-2-style TSV and on BART-base (full width, ENC_CUT_LAYERS["bart"]
   + ENC_CUT_LAYERS["bart"] layers) in synthetic-batch mode, and
   ``squad_run`` on BERT-base (full width, ENC_CUT_LAYERS["squad"]
   layers) on a generated SQuAD v1.1 file,
   each with its recipe's flags as the port's ``run_recipe`` builds them
   (OliVe "ant-int-flint" W4A4, bounds 75-250) on a generated HF
   directory (std-0.02 weights) and WordPiece vocabulary: seconds for
   import, calibration and eval, eval sequences/s, the metrics, peak
   memory and the OVP outlier and victim shares of the calibrated
   weights and activations, which must be above 0, with every kernel
   count 0; then the card held to the CPU on 2 layers at BERT-base width
   and one 8 x 128 batch (``enc_hold``): each site's ``calibrate`` on the
   card against the CPU's on the same data, each site's output on the
   card's own input within 1e-5 of |qx| @ |qw| of the CPU's fake-quant,
   and the unquantized logits within 1e-4 of the largest.

30. qat (run after encoders): QAT and the image path, which no kernel
   of the port serves either (f32 ``torch.matmul`` and ``F.conv2d``
   without TF32, forward and backward): ``glue_run --train`` on
   BERT-base at full width and depth (ant_bert_glue.toml sst2_IP-F,
   generated SST-2 TSVs: 2 steps of 64 an epoch, 2 epochs);
   ``imagenet_qat`` on ResNet-18 (resnet18_ANT4-8: batch 256 at 224 px,
   promotion of "0,20" on the card) and ViT-B/16 (vit_IP-F, batch 56),
   synthetic data, 2 steps; ``imagenet_eval`` (PTQ) on ResNet-50,
   VGG16-BN and AlexNet (ant_imagenet_ptq6.toml, W6A6) and Inception-v3
   (299 px, W4A4, its 95 sites); each on generated torchvision-layout
   weights (``image_checkpoint``), with seconds for calibration, ms per
   step, examples/s, the printed metrics and peak memory, every kernel
   count 0; ``qat_bench`` at ResNet-18 (batch 64) and BERT-base (16 x
   128); then ``qat_hold``: a 2-block ResNet and a 2-layer BERT-base,
   the same weights, states and batch on the card and the CPU: every
   site's output and weight gradient within 1e-5 of its magnitude sums
   from the CPU's f32 products of the card's own tensors, moved codes
   counted, the loss within 1e-4 relative and the running statistics
   within 1e-5 relative of the CPU's.

31. bench_clis (run right after 7, on the main path's card state): the
   port's measurement command lines through their ``main(argv)``, each
   JSON line emitted with its seconds, launches and peak memory:
   ``lm_bench`` at OPT-6.7B (decode with the bf16 baseline, 32 layers;
   the prefill mode) and BLOOM-7b1 (decode, 30 layers), and
   ``spec_bench`` at DEPTHS["serving"]; K1 and K2 launched exactly as
   their shapes ask and no plain version; the times held to the main
   path's profile and decode time, the MFU shares in (0, 100],
   spec_bench's model to its own formula; then ``utils/profiling``'s
   trace (it must name its region and K1's and K2's kernels) and
   ``StepTimer`` around decode steps of the main-path engine.

32. perfmodel (run last, after the bf16 baseline): the accelerator
   performance model, which no kernel of the port serves (the tiling
   search is int64/float64 torch passes over the 120 loop orders and a
   network's layers at once), through its command lines on the card: the
   full 48-row ``simulate --batch 64``, its CSV's SHA-256 and its cycle
   geomeans those of the reference's table (PM_TABLE_SHA256,
   PM_TABLE_GEOMEANS), the geomeans within 0.011 of Figure 13's;
   ``arch_sweep --variable-precision`` and a sweep at 64/128 KB, printing
   what the reference prints (PM_ARCH); seconds per run, the card's peak
   memory grown by each, every kernel count 0.

K2 at head_dim 80 and K7 at head_dim 64 are timed on random caches
(``phase_times_headdim``, after 27).

Then the ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the
last line. Without a CUDA device, or without the package beside this
file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
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
BF16_FLOPS = 989e12        # dense bf16 tensor-core peak
F32_FLOPS = 67e12          # f32 outside the tensor cores
# K2 agrees with its plain version within atol + rtol * |plain|: in bf16
# one output step is up to 2^-7 of the value, so a summation-order
# difference may move an output by one step
K2_TOL = {"bf16": (2e-2, 1e-2), "f32": (1e-4, 0.0)}
# K8 and its plain version are f32 dots summed in other orders: they agree
# within this share of each output's sum of term magnitudes |x| @ |W| (a
# random-sign sum of K roundings stays near 2^-24 of it; 1e-5 is far
# inside the worst case K 2^-24, 1e-3 at K = 16384)
K8_RTOL = 1e-5
# the OVP-weights prefill with and without stacked_prefill: two f32 orders
# of the same int32 partial sums (exact while they stay below 2^24)
SP_OVP_RTOL = 1e-3


# The depths of the paths that run at less than their model's depth, to
# keep the script under 600 s: their widths, kernels and checks are the
# full model's. OPT-6.7B (32 layers): "serving" is the ANT engine of the
# scheduler, speculative and W4A16 phases, "olive" full OliVe and the
# OVP-weights path, "w4pack"; BLOOM-7b1 (30): "bloom" bloom_main and
# bloom_ragged, "bloom_long"; GPT-2 XL (48): "gpt2" gpt2_main,
# "gpt2_olive" (its decode is host-bound, about 0.8 s per step at 48
# layers). OPT's ANT main path and the bf16 baseline run all 32.
DEPTHS = {"serving": 8, "olive": 6, "w4pack": 8, "bloom": 6,
          "bloom_long": 4, "gpt2": 6, "gpt2_olive": 2}

_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; ``at_s`` is the script's seconds so far."""
    print(json.dumps({**obj, "at_s": time.perf_counter() - _T0}),
          flush=True)


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


K1_CHECK_M = (1, 2, 3, 4, 5, 16, 64, 65, 200, 256)
# the OPT sites, BLOOM's fused qkv, and an N that is no multiple of K1's
# 128-column tile
K1_CHECK_KN = ((4096, 4096), (4096, 16384), (16384, 4096), (4096, 12288),
               (4096, 4104))


def phase_checks(torch, gen):
    from ant_quantization_tpu_torch.kernels import attention as k2
    from ant_quantization_tpu_torch.kernels import stacked as k1
    from ant_quantization_tpu_torch.models.transformer_lm import alibi_slopes
    k1_err = 0.0
    for (K, N) in K1_CHECK_KN:
        x, w, sc, aq, asc, l = _k1_operands(torch, max(K1_CHECK_M), K, N, 2,
                                            gen)
        for M in K1_CHECK_M:
            plan = k1.k1_plan(M, K, N)
            before = k1.COUNTS["launches"]
            got = k1.stacked_quant_matmul(l, x[:M], w, sc, aq, asc)
            if k1.COUNTS["launches"] != before + 1:
                fail(f"K1 did not launch once at M={M} K={K} N={N}")
            want = k1.stacked_quant_matmul_plain(l, x[:M], w, sc, aq, asc)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            equal = torch.equal(got, want)
            emit({"phase": "check", "kernel": "K1", "M": M, "K": K, "N": N,
                  "layer": l, "splits": plan["splits"],
                  "blocks": plan["blocks"], "max_abs_err": err,
                  "bit_equal": equal})
            if not equal:
                fail(f"K1 differs from its plain version at M={M} K={K} "
                     f"N={N} (max abs err {err})")
            k1_err = max(k1_err, err)
        del x, w
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
    # decode (T <= 16, split positions) and prefill (tensor cores) regimes,
    # ragged pos0 with the last query at S - 1; q in bf16 (as the engine
    # passes it) with bf16 output, in f32 with f32 output
    cases = [(1, [512] * 4)] + [
        (T, p0) for T in (1, 5, 16, 17, 100, 512)
        for p0 in ([0] * 4, [0, 17, 333 if T < 256 else 50, S - T])]
    for T, p0 in cases:
        q32 = torch.randn((B, H, T, D), device="cuda", generator=gen)
        pos0 = torch.tensor(p0, dtype=torch.int32, device="cuda")
        for sl in (None, slopes):
            for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
                q = q32.to(dt)
                before = k2.COUNTS["launches"]
                got = k2.stacked_int8_kv_attention(1, q, k, v, ks, vs, pos0,
                                                   sl, out_dtype=dt)
                if k2.COUNTS["launches"] != before + 1:
                    fail(f"K2 did not launch once at T={T}")
                want = k2.stacked_int8_kv_attention_plain(
                    1, q, k, v, ks, vs, pos0, sl, out_dtype=dt)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ok = k2_close(torch, got, want, tag)
                emit({"phase": "check", "kernel": "K2", "T": T, "pos0": p0,
                      "alibi": sl is not None, "out": tag, "q": tag,
                      "max_abs_err": err, "atol_rtol": K2_TOL[tag],
                      "pass": ok})
                if not ok:
                    fail(f"K2 differs from its plain version: T={T} "
                         f"pos0={p0} {tag} err {err}")
                k2_err[tag] = max(k2_err[tag], err)
    return k1_err, k2_err


def _pad16(a):
    """A grid padded to 16 entries by repeating its last, as calibration
    stores it (so the 32-entry concat holds duplicates)."""
    import numpy as np
    a = np.asarray(a, np.float32)
    return np.pad(a, (0, 16 - a.shape[0]), mode="edge")


def olive_act_state(signed: bool, alpha: float) -> dict:
    """An OliVe A4 input state: the flint grid with its abfloat outliers
    (sign-offset unit 0.5 for both signednesses)."""
    import numpy as np
    from ant_quantization_tpu_torch.numerics import codebooks as cb
    return {"grid": _pad16(cb.olive_grid("flint", 4, signed)),
            "outliers": _pad16(cb.olive_outlier_values(4, signed)),
            "alpha": np.float32(alpha)}


def _aovp_tables(torch, signed: bool, L: int):
    """K4's per-layer tables (mids, ties, enc) for the OliVe flint grid,
    the same for each of L layers, as the engine builds them."""
    from ant_quantization_tpu_torch.serve import engine as eng
    st = olive_act_state(signed, 1.0)
    t = eng._aovp_encode_tables(st["grid"], st["outliers"], 0.5, "cuda")
    return tuple(torch.stack([t[k]] * L) for k in
                 ("aovp_mids", "aovp_ties", "aovp_enc"))


def _k3_operands(torch, M, K, N, L, gen, adversarial: bool):
    """K3's operands: OVP weight bytes (every byte value; all-outlier
    columns when adversarial), an int8 codebook with exact midpoint ties
    in row 0, or activations at its top."""
    import numpy as np
    a_vals = np.round(np.linspace(-96, 127, 16)).astype(np.float32)
    a_q = torch.tensor(np.stack([a_vals] * L), device="cuda")
    a_scale = torch.full((L,), 0.25, device="cuda")     # a power of two
    l = L - 1
    if adversarial:
        pick = torch.randint(0, 4, (L, N, K), device="cuda", generator=gen)
        w = torch.tensor([100, 110, 120, 127], dtype=torch.int8,
                         device="cuda")[pick]
        x = torch.full((M, K), 127 * 0.25, device="cuda")
        x[:, ::7] *= -0.5
    else:
        w = torch.randint(-127, 128, (L, N, K), dtype=torch.int8,
                          device="cuda", generator=gen)
        x = torch.randn((M, K), device="cuda", generator=gen) * 10
        mids = (a_q[l, 1:] + a_q[l, :-1]) * 0.5
        x[0, :mids.shape[0]] = mids * a_scale[l]      # exact midpoint ties
    scales = torch.rand((L, N), device="cuda", generator=gen) * 2e-3 + 1e-3
    return x, w, scales, a_q, a_scale, l


def _k4_operands(torch, M, K, N, L, gen, signed, w_ovp, adversarial,
                 prescale=0.25):
    """K4's operands at ``prescale`` (0.25, a power of two, keeps exact
    concat midpoints exact after x / prescale): row 0 walks every midpoint
    (the tie flags and the padded duplicates), row 1 puts outliers on both
    members of pairs; the rest are normal samples with ~10% outliers.
    Adversarial: every activation at the top outlier against all-outlier
    columns."""
    mids, ties, enc = _aovp_tables(torch, signed, L)
    pre = torch.full((L,), prescale, device="cuda")
    l = L - 1
    if adversarial:
        x = torch.full((M, K), 384 * prescale, device="cuda")
        x[:, 1::4] *= -1
        pick = torch.randint(0, 3, (L, N, K), device="cuda", generator=gen)
        w = torch.tensor([100, 120, 127], dtype=torch.int8,
                         device="cuda")[pick]
    else:
        x = torch.randn((M, K), device="cuda", generator=gen) * 24 * prescale
        x[0] = (mids[l] * prescale).repeat(K // mids.shape[1] + 1)[:K]
        x[1, 0:64:2] = 300 * prescale
        x[1, 1:64:2] = -200 * prescale
        lo = -127 if w_ovp else -64
        w = torch.randint(lo, 128 if w_ovp else 65, (L, N, K),
                          dtype=torch.int8, device="cuda", generator=gen)
    if not signed:
        x = x.abs()
    scales = torch.rand((L, N), device="cuda", generator=gen) * 2e-3 + 1e-3
    return x, w, scales, pre, mids, ties, enc, l


def _skewed(mids, ties, i: int = 14):
    """K4's tables with midpoint i + 1 moved onto midpoint i and their tie
    flags made (0, 1): an x exactly there fails step i and passes step
    i + 1, so the thresholds on x fall out of order and the kernel must
    run the select chain itself, not its binary search."""
    mids, ties = mids.clone(), ties.clone()
    mids[:, i + 1] = mids[:, i]
    ties[:, i], ties[:, i + 1] = 0, 1
    return mids, ties


K34_CHECK_M = (1, 2, 3, 4, 5, 16, 64, 200)


def phase_checks_ovp(torch, gen):
    """K3 and K4 against their plain versions, bit for bit, at M 1, 2, 3,
    4, 5, 16, 64 and 200 (both wrappers send every M up to 256 to their
    decode kernels) on K1's five (K, N), K4 with OVP and int8-value
    weights on signed and unsigned grids; on adversarial inputs whose
    int32 segment sums pass 2^24, where the order of the f32 steps
    decides the result; K4 on tables whose thresholds fall out of order
    (its select chain) and at a prescale that is no power of two; both at
    a negative scale (the per-element division). Each call must be one
    launch, and the profiler must see one device kernel per call."""
    from ant_quantization_tpu_torch.kernels import stacked as ks
    from ant_quantization_tpu_torch.kernels.qmatmul import ovp_decode_values
    from ant_quantization_tpu_torch.ops.snap import snap_value
    errs = {"K3": 0.0, "K4": 0.0}
    n_checks = {"K3": 0, "K4": 0}
    counts = {"K3": ks.K3_COUNTS, "K4": ks.K4_COUNTS}

    def check(kernel, call, plain, plan, **info):
        before = counts[kernel]["launches"]
        got = call()
        if counts[kernel]["launches"] != before + 1:
            fail(f"{kernel} did not launch once: {info}")
        want = plain()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        equal = torch.equal(got, want)
        emit({"phase": "check", "kernel": kernel, **info, "mt": plan["mt"],
              "splits": plan["splits"], "blocks": plan["blocks"],
              "max_abs_err": err, "bit_equal": equal})
        if not equal:
            fail(f"{kernel} differs from its plain version: {info} "
                 f"(max abs err {err})")
        errs[kernel] = max(errs[kernel], err)
        n_checks[kernel] += 1

    kn0 = K1_CHECK_KN[0]                       # 4096 x 4096
    adv_kn = (kn0, K1_CHECK_KN[2])             # and 16384 x 4096
    for (K, N) in K1_CHECK_KN:
        seg = ks.ovp_layout(K, 1024, ks._SUB)[:2]
        for adv in (False, True) if (K, N) in adv_kn else (False,):
            x, w, sc, aq, asc, l = _k3_operands(
                torch, max(K34_CHECK_M), K, N, 2, gen, adv)
            info = {"K": K, "N": N, "adversarial": adv}
            if adv:
                # the f32 steps really round: a 256-row sub-chunk passes
                # 2^24 (reported beside it: whether one rounding of the
                # exact sum gives another result than the reference's)
                xq = snap_value(x[:4] / asc[l], aq[l]).double()
                wv = ovp_decode_values(w[l]).double()
                info["subchunk_max"] = (xq[:, :256] @ wv[:, :256].t()).abs(
                    ).max().item()
                once = (xq @ wv.t()).float() * sc[l]
                want4 = ks.stacked_quant_matmul_plain(l, x[:4], w, sc, aq,
                                                      asc, ovp=True)
                info["differs_from_one_rounding"] = not torch.equal(once,
                                                                    want4)
                if info["subchunk_max"] <= 2 ** 24:
                    fail(f"K3 adversarial case stays exact: {info}")
                del wv
            for M in (4, 64) if adv else K34_CHECK_M:
                xm = x[:M]
                check("K3", lambda: ks.stacked_quant_matmul(
                          l, xm, w, sc, aq, asc, ovp=True),
                      lambda: ks.stacked_quant_matmul_plain(
                          l, xm, w, sc, aq, asc, ovp=True),
                      ks.k34_plan(M, K, N, *seg, aovp=False), M=M, **info)
            del x, w
    # a negative scale: the kernels divide each element, as the plain
    # version does (no thresholds on x for a scale that is not > 0)
    x, w, sc, aq, asc, l = _k3_operands(torch, 64, *kn0, 2, gen, False)
    asc = -asc
    x[0, :15] = (aq[l, 1:] + aq[l, :-1]) * 0.5 * asc[l]
    for M in (1, 4, 64):
        xm = x[:M]
        check("K3", lambda: ks.stacked_quant_matmul(
                  l, xm, w, sc, aq, asc, ovp=True),
              lambda: ks.stacked_quant_matmul_plain(
                  l, xm, w, sc, aq, asc, ovp=True),
              ks.k34_plan(M, *kn0, *ks.ovp_layout(kn0[0], 1024,
                                                       ks._SUB)[:2],
                          aovp=False),
              M=M, K=kn0[0], N=kn0[1], adversarial=False, a_scale=-0.25)
    del x, w
    k4_cases = [(K, N, signed, w_ovp, False, "engine", 0.25)
                for (K, N) in K1_CHECK_KN for signed in (True, False)
                for w_ovp in (True, False)]
    k4_cases += [(K, N, True, True, True, "engine", 0.25)
                 for (K, N) in adv_kn]
    k4_cases += [(*kn0, True, w_ovp, False, "skewed", 0.25)
                 for w_ovp in (True, False)]
    k4_cases += [(*kn0, signed, True, False, "engine", 0.19)
                 for signed in (True, False)]
    k4_cases += [(*kn0, True, w_ovp, False, "engine", -0.25)
                 for w_ovp in (True, False)]
    for K, N, signed, w_ovp, adv, tables, prescale in k4_cases:
        seg = ks.ovp_layout(K, 1024, K)[:2]
        x, w, sc, pre, mids, ties, enc, l = _k4_operands(
            torch, max(K34_CHECK_M), K, N, 2, gen, signed, w_ovp, adv,
            prescale)
        if tables == "skewed":
            mids, ties = _skewed(mids, ties)
            x[0, :mids.shape[1]] = mids[l] * prescale
        info = {"K": K, "N": N, "signed": signed, "w_ovp": w_ovp,
                "adversarial": adv, "tables": tables, "prescale": prescale}
        cx = ks.aovp_encode(x[:4] / pre[l], mids[l], ties[l], enc[l])
        info["outlier_share"] = (cx.abs() > 64).float().mean().item()
        if adv:
            # 256 d1 alone needs more than 24 bits
            d1 = cx[:, :1024].double() @ w[l][:, :1024].double().t()
            info["block_dot_max"] = d1.abs().max().item()
            if 256 * info["block_dot_max"] <= 2 ** 24:
                fail(f"K4 adversarial case stays exact: {info}")
        if tables == "skewed":
            # at the moved midpoint the chain's answer is not the entry
            # that the count of passed steps picks
            xs = (x[0] / pre[l])[:, None]
            passed = (xs > mids[l]) | ((xs == mids[l]) & (ties[l] > 0))
            by_count = enc[l][passed.sum(1)]
            info["chain_not_count"] = not torch.equal(
                ks.aovp_snap_encode(x[:1] / pre[l], mids[l], ties[l],
                                    enc[l])[0], by_count)
            if not info["chain_not_count"]:
                fail(f"K4's skewed tables do not test the chain: {info}")
        for M in (4, 64) if adv else (1, 4, 64) if tables == "skewed" \
                or prescale < 0 else (4,) if prescale != 0.25 \
                else K34_CHECK_M:
            args = (l, x[:M], w, sc, pre, mids, ties, enc)
            check("K4", lambda: ks.stacked_quant_matmul_aovp(
                      *args, w_ovp=w_ovp),
                  lambda: ks.stacked_quant_matmul_aovp_plain(
                      *args, w_ovp=w_ovp),
                  ks.k34_plan(M, K, N, *seg, aovp=True, w_ovp=w_ovp), M=M,
                  **info)
        del x, w
    # one device kernel per call: no encode or snap pre-kernel
    x, w, sc, aq, asc, l = _k3_operands(torch, 4, *kn0, 2, gen, False)
    mids, ties, enc = _aovp_tables(torch, True, 2)
    pre = torch.full((2,), 0.25, device="cuda")
    per_call, attempts = {}, {}
    for tag, fn in (
            ("K3", lambda: ks.stacked_quant_matmul(l, x, w, sc, aq, asc,
                                                   ovp=True)),
            ("K4", lambda: ks.stacked_quant_matmul_aovp(
                l, x, w, sc, pre, mids, ties, enc, w_ovp=True))):
        fn()
        rows, attempts[tag] = traced_kernels(torch, fn, 1)
        per_call[tag] = [{"name": k[:80], "count": c} for _, k, c in rows]
        if sum(c for _, _, c in rows) != 1:
            fail(f"{tag} ran {rows} on the device, not one kernel")
    emit({"phase": "checks_ovp", "checks": n_checks,
          "kernels_per_call": per_call, "profiler_attempts": attempts})
    return errs


def _k8_size(torch, x, packed, scale, grid):
    """The sum of the magnitudes of K8's terms, per output: |x| @ |W|."""
    from ant_quantization_tpu_torch.kernels import qmatmul as kq
    wv = kq.dequant_w4_reference(packed, scale, grid).abs()      # (K, N)
    return kq.f32_product(x.abs().to(torch.float32), wv.t())


def k8_close(torch, got, want, size) -> bool:
    """K8 against its plain version: both f32 dots in other orders."""
    return bool(torch.isfinite(got).all()) and bool(
        ((got - want).abs() <= K8_RTOL * size).all())


K6_CHECK_M = (1, 4, 16, 64, 300)
# block_k beside the engine's 1024 for K5's OVP mode at one site: its
# segments and f32 blocks (at K = 4096: 64 and 4096 give one block of 16
# segments of 256 rows, 128 segments of 128 rows each one block, 256
# segments of 256 rows each one block)
K5_OVP_BLOCK_K = (64, 128, 256, 4096)


def phase_checks_w4pack(torch, gen):
    """K6, K5 and K8 against their plain versions on the card, at the
    three OPT site shapes: K6 bit for bit at M 1, 4, 16, 64 and 300,
    affine and table decode, and at K = 4160 (K/2 no multiple of its
    128-byte stage) by N = 4104, each call one launch and one device
    kernel; K5 (stacked_quant_matmul at M > 256) bit for bit at M 257,
    300, 2048 and 4096, int8 values and OVP bytes (both on wgmma), and on
    K3's adversarial K = 16384 case whose 256-row segment sums pass 2^24;
    its OVP mode also at block_k 64, 128, 256 and 4096 on the 4096 x 4096
    site (adversarial at 128 and 4096 as well), each call the snap
    pre-kernel and one product kernel; K8 at M 4 and 2048, bf16 and f32
    x, on the flint, int and unsigned float grids (the three routes of its
    bf16 weight table), within K8_RTOL of each output's sum of term
    magnitudes."""
    import numpy as np
    from ant_quantization_tpu_torch.kernels import qmatmul as kq
    from ant_quantization_tpu_torch.kernels import stacked as ks
    from ant_quantization_tpu_torch.kernels.qmatmul import (
        int8_codebook, ovp_decode_values)
    from ant_quantization_tpu_torch.numerics import codebooks as cb
    from ant_quantization_tpu_torch.ops.snap import snap_value
    d, ff = 4096, 16384
    shapes = ((d, d), (d, ff), (ff, d))
    errs = {"K5": 0.0, "K6": 0.0, "K8": 0.0}
    n_checks = {"K5": 0, "K6": 0, "K8": 0}

    def record(kernel, got, want, ok, **info):
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        equal = torch.equal(got, want)
        emit({"phase": "check", "kernel": kernel, **info,
              "max_abs_err": err, "bit_equal": equal, "pass": ok(equal)})
        if not ok(equal):
            fail(f"{kernel} differs from its plain version: {info} "
                 f"(max abs err {err})")
        errs[kernel] = max(errs[kernel], err)
        n_checks[kernel] += 1

    def launched(counts, call, info):
        before = counts["launches"]
        got = call()
        if counts["launches"] != before + 1:
            fail(f"did not launch once at {info}")
        return got

    exact = lambda equal: equal
    flint = cb.ant_grid("flint", 4, True).astype(np.float32)
    for K, N in shapes + ((4160, 4104),):
        for affine in (True, False):
            q16v = np.arange(16) - 8 if affine else int8_codebook(flint)[0]
            q16 = torch.tensor(np.stack([q16v] * 2).astype(np.int32),
                               device="cuda")
            w = torch.randint(0, 256, (2, N, K // 2), dtype=torch.uint8,
                              device="cuda", generator=gen)
            sc = torch.rand((2, N), device="cuda", generator=gen) * 1e-3
            x, _, _, aq, asc, l = _k1_operands(torch, max(K6_CHECK_M), K, 8,
                                               2, gen)
            # exact midpoint ties in the high half of K too
            x[0, K // 2:K // 2 + 15] = x[0, :15]
            for M in K6_CHECK_M:
                args = (l, x[:M], w, sc, aq, asc, q16, affine)
                plan = ks.k6_plan(M, K, N)
                info = {"M": M, "K": K, "N": N, "affine": affine,
                        "mt": plan["mt"], "splits": plan["splits"],
                        "blocks": plan["blocks"]}
                got = launched(ks.K6_COUNTS,
                               lambda: ks.stacked_quant_matmul_p4(*args),
                               info)
                want = ks.stacked_quant_matmul_p4_plain(*args)
                record("K6", got, want, exact, **info)
            del w, x
    # K5 cases: (M, K, N, ovp, adversarial, block_k)
    k5_cases = [(M, K, N, ovp, False, 1024) for K, N in shapes
                for ovp in (False, True) for M in (257, 300, 2048, 4096)]
    k5_cases += [(300, ff, d, True, True, 1024)]
    k5_cases += [(M, d, d, True, False, bk) for bk in K5_OVP_BLOCK_K
                 for M in (300, 2048)]
    k5_cases += [(300, d, d, True, True, bk) for bk in (128, 4096)]
    for M, K, N, ovp, adv, bk in k5_cases:
        if ovp:
            x, w, sc, aq, asc, l = _k3_operands(torch, M, K, N, 2, gen, adv)
        else:
            x, w, sc, aq, asc, l = _k1_operands(torch, M, K, N, 2, gen)
        info = {"M": M, "K": K, "N": N, "ovp": ovp, "adversarial": adv,
                "block_k": bk}
        if ovp:
            info["segment_rows"], info["fold"] = ks.ovp_layout(
                K, bk, ks._SUB)[:2]
        got = launched(ks.K5_COUNTS, lambda: ks.stacked_quant_matmul(
            l, x, w, sc, aq, asc, ovp=ovp, block_k=bk), info)
        want = ks.stacked_quant_matmul_plain(l, x, w, sc, aq, asc, ovp=ovp,
                                             block_k=bk)
        if adv:
            xq = snap_value(x / asc[l], aq[l]).double()
            wv = ovp_decode_values(w[l]).double()
            info["subchunk_max"] = (xq[:, :256] @ wv[:, :256].t()).abs(
                ).max().item()
            if info["subchunk_max"] <= 2 ** 24:
                fail(f"K5 adversarial case stays exact: {info}")
            del wv
        record("K5", got, want, exact, **info)
        del x, w, got, want
    # device kernels per call: K6 one (no snap pre-kernel), K5 two (the
    # snap pre-kernel and the product) in both modes
    per_call, attempts = {}, {}
    q16 = torch.tensor(np.stack([np.arange(16) - 8] * 2).astype(np.int32),
                       device="cuda")
    w4 = torch.randint(0, 256, (2, d, d // 2), dtype=torch.uint8,
                       device="cuda", generator=gen)
    x4, _, _, aq, asc, l = _k1_operands(torch, 4, d, 8, 2, gen)
    sc4 = torch.rand((2, d), device="cuda", generator=gen) * 1e-3
    x5, w5, sc5, aq5, asc5, l5 = _k3_operands(torch, 300, d, d, 2, gen,
                                              False)
    for tag, want_n, fn in (
            ("K6", 1, lambda: ks.stacked_quant_matmul_p4(
                l, x4, w4, sc4, aq, asc, q16, True)),
            ("K5 ovp", 2, lambda: ks.stacked_quant_matmul(
                l5, x5, w5, sc5, aq5, asc5, ovp=True)),
            ("K5 int8", 2, lambda: ks.stacked_quant_matmul(
                l5, x5, w5, sc5, aq5, asc5, ovp=False))):
        fn()
        rows, attempts[tag] = traced_kernels(torch, fn, want_n)
        per_call[tag] = [{"name": k[:80], "count": c} for _, k, c in rows]
        if sum(c for _, _, c in rows) != want_n:
            fail(f"{tag} ran {rows} on the device, not {want_n} kernels")
    del w4, x5, w5
    # K8 on the three routes of its weight table: the flint grid (exact
    # in bf16), the int grid (its int8 restatement and unit) and the
    # unsigned float grid (neither: three bf16 terms); bf16 x (one term,
    # as the engine passes it) and f32 x (three)
    for mode, signed in (("flint", True), ("int", True), ("float", False)):
        grid = torch.tensor(cb.ant_grid(mode, 4, signed).astype(np.float32),
                            device="cuda")
        for K, N in shapes:
            packed = torch.randint(0, 256, (N, K // 2), dtype=torch.uint8,
                                   device="cuda", generator=gen)
            scale = torch.rand((N,), device="cuda", generator=gen) * 1e-2
            for M in (4, 2048):
                for dt in (torch.bfloat16, torch.float32):
                    x = torch.randn((M, K), device="cuda",
                                    generator=gen).to(dt)
                    got = kq.quantized_matmul_w4(x, packed, scale, grid)
                    want = kq.quantized_matmul_w4_plain(x, packed, scale,
                                                        grid)
                    size = _k8_size(torch, x, packed, scale, grid)
                    record("K8", got, want,
                           lambda _: k8_close(torch, got, want, size),
                           M=M, K=K, N=N, grid=mode, signed=signed,
                           x=str(dt).split(".")[-1], rtol_of_size=K8_RTOL,
                           max_err_over_size=((got - want).abs() / size
                                              ).max().item())
    emit({"phase": "checks_w4pack", "checks": n_checks,
          "kernels_per_call": per_call, "profiler_attempts": attempts})
    return errs


def engine_layer_shapes(c) -> dict:
    """(K, N) of each matmul site of one layer: a fused qkv (BLOOM) or
    separate q, k, v (OPT)."""
    d = c.d_model
    qkv = ({"qkv": (d, 3 * d)} if c.fused_qkv else
           {"q": (d, d), "k": (d, d), "v": (d, d)})
    return {**qkv, "out": (d, d), "fc_in": (d, c.d_ff),
            "fc_out": (c.d_ff, d)}


# alpha of each site's OliVe A4 input state, about 2.5 times the input's
# RMS, so that a few values in a thousand are outliers: q/k/v/fc_in read
# a LayerNorm output and fc_out a ReLU of unit-variance values; out reads
# the attention output, which is smaller (at alpha 0.2, 46% of its
# values were outliers). The olive_ovp_shares phase reports each site's
# input RMS beside its shares.
OLIVE_A_ALPHA = {"q": 2.5, "k": 2.5, "v": 2.5, "out": 1.5, "fc_in": 2.5,
                 "fc_out": 2.5}


def olive_engine_params(torch, cfg, seed: int):
    """Full-OliVe engine params built on the card from a seeded generator,
    one site-layer at a time, through the functions that
    ``build_engine_params`` runs for each site-layer
    (``serve/engine.py``: weight_entry, act_entry, stack_entries).
    Weights: normal samples with std 1/sqrt(K), OliVe int grids at q/k/v
    and flint elsewhere with their outliers, alpha = 2.5 std, packed by
    ``quantize_weights_ovp_i8``. Activations: ``olive_act_state``, signed
    except at fc_out (after the ReLU)."""
    import numpy as np
    from ant_quantization_tpu_torch.numerics import codebooks as cb
    from ant_quantization_tpu_torch.serve import engine as eng
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    c = cfg.lm
    L, d = c.n_layers, c.d_model
    dev = torch.device("cuda")
    layers = {}
    for name, (K, N) in engine_layer_shapes(c).items():
        mode = "int" if name in ("q", "k", "v") else "flint"
        wq = {"grid": _pad16(cb.olive_grid(mode, 4, True)),
              "outliers": _pad16(cb.olive_outlier_values(4, True)),
              "alpha": np.float32(2.5 / np.sqrt(K))}
        aq = olive_act_state(name != "fc_out", OLIVE_A_ALPHA[name])
        es = []
        for _ in range(L):
            w = torch.randn((K, N), device=dev, generator=gen) / float(
                np.sqrt(K))
            e = {"bias": torch.zeros((N,), device=dev)}
            e.update(eng.weight_entry(w, wq, ovp=True))
            e.update(eng.act_entry(cfg, aq, ovp=True, device=dev))
            es.append(e)
            del w
        layers[name] = eng.stack_entries(name, es)
        del es
    rest = random_engine_params(torch, cfg, seed, sites=False)
    layers.update(rest["layers"])
    return {"layers": layers, "top": rest["top"]}


def ovp_weight_params(torch, cfg, olive_ep):
    """The OVP-weights route's params: the full-OliVe engine's OVP weight
    stacks (shared, not copied) with int8-exact A4 inputs instead (ANT
    flint, unsigned, alpha 3, as the ANT main path), so decode runs K3."""
    import numpy as np
    from ant_quantization_tpu_torch.numerics import codebooks as cb
    from ant_quantization_tpu_torch.serve import engine as eng
    L = cfg.lm.n_layers
    aq = {"grid": cb.ant_grid("flint", 4, False), "alpha": np.float32(3.0)}
    layers = {}
    for name, s in olive_ep["layers"].items():
        if name not in engine_layer_shapes(cfg.lm):
            layers[name] = s
            continue
        acts = eng.stack_entries(name, [
            eng.act_entry(cfg, aq, ovp=False, device=torch.device("cuda"))
            for _ in range(L)])
        layers[name] = {k: s[k] for k in ("bias", "ovp", "w_i8", "oscale")}
        layers[name].update(acts)
    return {"layers": layers, "top": olive_ep["top"]}


def random_engine_params(torch, cfg, seed: int, sites: bool = True):
    """Random W4A4 engine params built on the card, one site at a time,
    from a seeded generator (the construction bench.py uses: int8
    codebook values in [-64, 64), flint grids, alpha 3), for the sites of
    ``cfg``'s geometry; the top has a position table for learned
    positions and an embedding LayerNorm where the model has one.
    ``sites=False`` leaves out the matmul sites (LayerNorms and the top
    only)."""
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
    layers = {}
    for name, (K, N) in (engine_layer_shapes(c).items() if sites else ()):
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
    ln = lambda: {"scale": torch.ones((d,), device="cuda"),
                  "bias": torch.zeros((d,), device="cuda")}
    top = {}
    if c.positions != "alibi":
        top["wpe"] = (torch.randn((cfg.max_seq + 2, d), device="cuda",
                                  generator=gen) * 0.02).to(cfg.dtype)
    top["wte_i8"] = torch.randint(-127, 128, (c.vocab_size, d),
                                  dtype=torch.int8, device="cuda",
                                  generator=gen)
    top["wte_scale"] = torch.full((c.vocab_size,), 0.02 / 127.0,
                                  device="cuda")
    top["ln_f"] = ln()
    if c.embed_ln:
        top["embed_ln"] = ln()
    return {"layers": layers, "top": top}


def opt_engine_config(n_layers: int, dtype, **kw):
    import dataclasses
    from ant_quantization_tpu_torch.models.transformer_lm import opt_config
    from ant_quantization_tpu_torch.serve.engine import EngineConfig
    lm = dataclasses.replace(opt_config("6.7b"), n_layers=n_layers,
                             max_seq=MAX_SEQ)
    return EngineConfig(lm=lm, **{
        "weight_mode": "w4", "act_bits": 4, "kv_int8": True,
        "lm_head_int8": True, "max_seq": MAX_SEQ, "dtype": dtype, **kw})


def all_counts():
    """Each kernel's launch and plain-call counts, by kernel."""
    from ant_quantization_tpu_torch.kernels import attention as k2
    from ant_quantization_tpu_torch.kernels import qmatmul as kq
    from ant_quantization_tpu_torch.kernels import stacked as ks
    return {"K1": ks.COUNTS, "K2": k2.COUNTS, "K3": ks.K3_COUNTS,
            "K4": ks.K4_COUNTS, "K5": ks.K5_COUNTS, "K6": ks.K6_COUNTS,
            "K7": k2.K7_COUNTS, "K8": kq.K8_COUNTS, "K9": kq.K9_COUNTS}


def reset_counts():
    for counts in all_counts().values():
        for key in counts:
            counts[key] = 0


def read_counts() -> dict:
    return {k: dict(v) for k, v in all_counts().items()}


def serve_path(torch, engine, ids, phase: str, want: dict, extra=None,
               model: str = "OPT-6.7B", chunk=None):
    """The measured run of one serving path: a short warm-up (library
    handles, allocator; its cache writes are overwritten), then every
    count set to 0, one fenced ``Engine.prefill`` of ``ids`` (in forward
    calls of ``chunk`` positions if given) and DECODE greedy
    ``Engine.decode`` steps in fenced blocks of 8, and the counts read.
    Fails unless the logits are finite (B, 1, V), the tokens in range,
    each kernel's launches equal ``want`` (0 for a kernel it does not
    name) and no plain version ran. Emits and returns the phase's line."""
    c = engine.cfg.lm
    want = {k: want.get(k, 0) for k in all_counts()}
    engine.decode(engine.prefill(ids[:, :32])[:, -1].argmax(-1, True))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logits = engine.prefill(ids, chunk=chunk)
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
    counts = read_counts()
    reset_counts()
    toks = torch.cat(tokens, 1)
    finite = bool(torch.isfinite(logits).all())
    step_ms = statistics.median(block_ms)
    res = {"phase": phase, "model": model, "layers": c.n_layers,
           "d_model": c.d_model, "batch": BATCH,
           "prefill_tokens": ids.shape[1], "max_seq": engine.cfg.max_seq,
           "decode_steps": DECODE, **(extra or {}),
           "prefill_ms": prefill_ms, "decode_ms_per_step": step_ms,
           "decode_block_ms_per_step": block_ms,
           "decode_tokens_per_s": BATCH / (step_ms * 1e-3),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "logits_shape": list(logits.shape), "logits_finite": finite,
           "launches": counts, "want_launches": want}
    emit(res)
    if not finite or list(logits.shape) != [BATCH, 1, c.vocab_size]:
        fail(f"{phase}: logits are not finite (B, 1, V)")
    if toks.min() < 0 or toks.max() >= c.vocab_size:
        fail(f"{phase}: tokens out of range")
    got = {k: v["launches"] for k, v in counts.items()}
    if got != want:
        fail(f"{phase}: launch counts {got}, want {want}")
    if any(v["plain_calls"] for v in counts.values()):
        fail(f"{phase}: plain versions ran: {counts}")
    return res


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
    want = {"K1": 6 * c.n_layers * DECODE, "K2": c.n_layers * (1 + DECODE)}
    res = serve_path(torch, engine, ids, "main_path", want,
                     {"param_build_s": build_s})
    return engine, res, ids


def ovp_shares(torch, engine, tok, steps: int = 8):
    """The share of OVP outliers and victims: in the weight bytes of each
    site (|byte| > 64; victims are the zeroed partners along K), and in
    the activations K4 encodes over ``steps`` further decode steps (its
    plain snap on the same inputs, before and after the victims).
    Reported by site; the launches of these steps are not counted."""
    from ant_quantization_tpu_torch.kernels import stacked as ks
    from ant_quantization_tpu_torch.ops.ovp import victim_mask
    from ant_quantization_tpu_torch.serve import engine as eng
    ep = engine.engine_params()
    sites = engine_layer_shapes(engine.cfg.lm)
    out = {"weights": {}, "decode_activations": {}}
    names = {}
    for name in sites:
        w = ep["layers"][name]["w_i8"]
        names[w.data_ptr()] = name
        m = w.abs() > 64
        v = victim_mask(m, pair_axis=-1)
        n = w.numel()
        out["weights"][name] = {
            "outliers": torch.count_nonzero(m & ~v).item() / n,
            "victims": torch.count_nonzero(v).item() / n, "values": n}
        del m, v
    tally = {name: [0, 0, 0, 0.0] for name in sites}
    k4 = eng.stacked_quant_matmul_aovp

    def k4_watch(l, x, w, scales, prescale, mids, ties, enc, **kw):
        c = ks.aovp_snap_encode(x.float() / prescale[l], mids[l], ties[l],
                                enc[l])
        m = c.abs() > 64
        v = victim_mask(m, pair_axis=-1)
        t = tally[names[w.data_ptr()]]
        t[0] += int((m & ~v).sum())
        t[1] += int(v.sum())
        t[2] += c.numel()
        t[3] += x.float().pow(2).sum().item()
        return k4(l, x, w, scales, prescale, mids, ties, enc, **kw)

    with mock.patch.object(eng, "stacked_quant_matmul_aovp", k4_watch):
        for _ in range(steps):
            tok = engine.decode(tok)[:, -1].argmax(-1, keepdim=True)
    reset_counts()
    for name, (o, v, n, sq) in tally.items():
        out["decode_activations"][name] = {"outliers": o / n,
                                           "victims": v / n, "values": n,
                                           "rms": (sq / n) ** 0.5}
    for kind in ("weights", "decode_activations"):
        d = out[kind]
        n = sum(x["values"] for x in d.values())
        out[kind + "_total"] = {
            k: sum(x[k] * x["values"] for x in d.values()) / n
            for k in ("outliers", "victims")}
    return out


def phase_olive(torch, gen, n_layers: int = 32):
    """The OliVe main path: OPT-6.7B under full OliVe W4A4 (OVP weights
    and OVP activations at all six sites) with INT8 KV and the int8 head,
    at full width and depth: every decode site matmul runs K4, the
    prefill the unfused fake-quant route. Then the observed OVP shares,
    which must be above 0 (or the path did not test OVP)."""
    from ant_quantization_tpu_torch.serve.engine import Engine
    cfg = opt_engine_config(n_layers, torch.bfloat16)
    c = cfg.lm
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ep = olive_engine_params(torch, cfg, seed=2)
    engine = Engine(cfg, ep, BATCH)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ids = torch.randint(0, c.vocab_size, (BATCH, PREFILL), device="cuda",
                        generator=gen)
    want = {"K2": c.n_layers * (1 + DECODE), "K4": 6 * c.n_layers * DECODE}
    res = serve_path(torch, engine, ids, "olive_main_path", want,
                     {"param_build_s": build_s,
                      "act_alpha": OLIVE_A_ALPHA})
    shares = ovp_shares(torch, engine, ids[:, :1])
    emit({"phase": "olive_ovp_shares", **shares})
    if not (shares["weights_total"]["outliers"] > 0
            and shares["weights_total"]["victims"] > 0
            and shares["decode_activations_total"]["outliers"] > 0
            and shares["decode_activations_total"]["victims"] > 0):
        fail(f"the OliVe path saw no outliers or victims: {shares}")
    return engine, ep, res["launches"], ids


def phase_ovp_weights(torch, olive_ep, ids, n_layers: int = 32):
    """The OVP-weights route: the OliVe path's OVP weight stacks with
    int8-exact ANT A4 activations, through ``Engine``: every decode site
    matmul runs K3, the prefill the dual int8 product."""
    from ant_quantization_tpu_torch.serve.engine import Engine
    cfg = opt_engine_config(n_layers, torch.bfloat16)
    c = cfg.lm
    # the peak counts both engines: this one shares the OliVe engine's
    # weight stacks and adds its own cache
    torch.cuda.reset_peak_memory_stats()
    engine = Engine(cfg, ovp_weight_params(torch, cfg, olive_ep), BATCH)
    want = {"K2": c.n_layers * (1 + DECODE), "K3": 6 * c.n_layers * DECODE}
    res = serve_path(torch, engine, ids, "ovp_weights_path", want)
    return engine, res["launches"]


def w4pack_engine_params(torch, cfg, seed: int):
    """"w4pack" engine params built on the card from a seeded generator,
    one site-layer at a time, through the functions that
    ``build_engine_params`` runs for each site-layer (packed_weight_entry,
    act_entry, stack_entries). Weights: normal samples with std 1/sqrt(K),
    the ANT int grid at q/k/v (affine: K6 decodes code - 8) and flint
    elsewhere (table decode), alpha = 2.5 std, packed by the port's
    ``quantize_weights_w4``. A4 inputs: the unsigned ANT flint grid with
    alpha 3, as the ANT main path."""
    import numpy as np
    from ant_quantization_tpu_torch.numerics import codebooks as cb
    from ant_quantization_tpu_torch.serve import engine as eng
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    dev = torch.device("cuda")
    aq = {"grid": cb.ant_grid("flint", 4, False), "alpha": np.float32(3.0)}
    layers = {}
    for name, (K, N) in engine_layer_shapes(cfg.lm).items():
        mode = "int" if name in ("q", "k", "v") else "flint"
        wq = {"grid": cb.ant_grid(mode, 4, True),
              "alpha": np.float32(2.5 / np.sqrt(K))}
        es = []
        for _ in range(cfg.lm.n_layers):
            w = torch.randn((K, N), device=dev, generator=gen) / float(
                np.sqrt(K))
            e = {"bias": torch.zeros((N,), device=dev)}
            e.update(eng.packed_weight_entry(w, wq))
            e.update(eng.act_entry(cfg, aq, ovp=False, device=dev))
            es.append(e)
            del w
        layers[name] = eng.stack_entries(name, es)
        if ("affine4" in layers[name]) != (mode == "int"):
            fail(f"w4pack site {name}: affine4 marker is wrong")
        del es
    rest = random_engine_params(torch, cfg, seed, sites=False)
    layers.update(rest["layers"])
    return {"layers": layers, "top": rest["top"]}


def phase_w4pack(torch, gen, n_layers: int = 32):
    """The "w4pack" path: OPT-6.7B with packed 4-bit weights built on the
    card, at full width and depth, through ``Engine``: every decode site
    matmul runs K6, every prefill site matmul K8 (M = 2048)."""
    from ant_quantization_tpu_torch.serve.engine import Engine
    cfg = opt_engine_config(n_layers, torch.bfloat16, weight_mode="w4pack")
    c = cfg.lm
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = Engine(cfg, w4pack_engine_params(torch, cfg, seed=4), BATCH)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    packed_bytes = sum(s["packed"].numel() for n, s in
                       engine.engine_params()["layers"].items()
                       if "packed" in s)
    ids = torch.randint(0, c.vocab_size, (BATCH, PREFILL), device="cuda",
                        generator=gen)
    want = {"K2": c.n_layers * (1 + DECODE), "K6": 6 * c.n_layers * DECODE,
            "K8": 6 * c.n_layers}
    res = serve_path(torch, engine, ids, "w4pack_path", want,
                     {"param_build_s": build_s,
                      "packed_weight_bytes": packed_bytes})
    return engine, res["launches"], ids


def phase_stacked_prefill(torch, engine, ids, phase: str):
    """``engine``'s params (shared, not copied) served by a second Engine
    with ``stacked_prefill=True`` (its own cache): one fenced prefill,
    whose launches must be K5 at every site (6 per layer) and K2 once per
    layer; its logits against ``engine``'s own prefill of the same ids,
    then 8 greedy decode steps on each engine. On int8-value weights the
    logits must be bit-equal (same snap, exact int32, same scale
    product). On OVP weights (K5's OVP mode against the dual ``_int_mm``
    route) they must agree within SP_OVP_RTOL of the largest logit, and
    the greedy tokens are reported. Returns (the new engine, its
    launches)."""
    import dataclasses
    from ant_quantization_tpu_torch.serve.engine import Engine
    cfg = dataclasses.replace(engine.cfg, stacked_prefill=True)
    L = cfg.lm.n_layers
    ovp = "ovp" in engine.engine_params()["layers"]["q"]
    sp = Engine(cfg, engine.engine_params(), BATCH)
    sp.prefill(ids[:, :300])                        # warm-up, M = 1200
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    got = sp.prefill(ids)
    torch.cuda.synchronize()
    sp_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    reset_counts()
    t0 = time.perf_counter()
    want = engine.prefill(ids)
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t0) * 1e3
    toks = []
    for e, logits in ((sp, got), (engine, want)):
        t = [logits[:, -1].argmax(-1, keepdim=True)]
        for _ in range(8):
            t.append(e.decode(t[-1])[:, -1].argmax(-1, keepdim=True))
        toks.append(torch.cat(t, 1))
    torch.cuda.synchronize()
    reset_counts()
    launches = {k: v["launches"] for k, v in counts.items()}
    want_l = {k: {"K5": 6 * L, "K2": L}.get(k, 0) for k in launches}
    err = (got - want).abs().max().item()
    res = {"phase": phase, "layers": L, "ovp_weights": ovp,
           "prefill_ms_stacked": sp_ms, "prefill_ms_unstacked": ref_ms,
           "launches": launches, "want_launches": want_l,
           "plain_calls": {k: v["plain_calls"] for k, v in counts.items()},
           "logits_bit_equal": torch.equal(got, want),
           "logits_max_abs_err": err,
           "logits_max_abs": want.abs().max().item(),
           "greedy_tokens_identical_8_steps": torch.equal(*toks)}
    ok = (launches == want_l and bool(torch.isfinite(got).all())
          and not any(res["plain_calls"].values()))
    if ovp:
        res["rtol_of_max_logit"] = SP_OVP_RTOL
        ok = ok and err <= SP_OVP_RTOL * res["logits_max_abs"]
        if not res["greedy_tokens_identical_8_steps"]:
            res["tokens_note"] = (
                "the two f32 orders moved an activation across an A4 "
                "midpoint, which cascades (ROADMAP Queue 3)")
    else:
        ok = ok and res["logits_bit_equal"]
    res["pass"] = ok
    emit(res)
    if not ok:
        fail(f"{phase}: {res}")
    return sp, counts


def _bound(byts, ops, peak):
    """(ms, what binds): the larger of the bytes over the HBM rate and the
    operations over ``peak``."""
    t_b, t_o = byts / HBM_BPS, ops / peak
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def k1_bound(M, K, N, G=16):
    byts = K * N + 4 * M * K + 4 * M * N + 4 * N + 4 * G + 4
    ops = 2 * M * K * N
    return byts, ops, _bound(byts, ops, INT8_OPS)[0]


def k2_bound(B, H, T, D, S, pos0, q_bytes=4, out_bytes=2):
    """K2's (and K7's) bound: the visible cache read once, q read at the
    element size of the timed call, the output written once, against the
    score and PV operations at the bf16 tensor-core rate (the least the
    card could take for them)."""
    vis = [min(p + t + 1, S) for p in pos0 for t in range(T)]
    keys = sum(min(p + T, S) for p in pos0)       # each key read once
    byts = (keys * H * (2 * D + 8) + B * H * T * D * (q_bytes + out_bytes)
            + 4 * B + 4 * H)
    ops = sum(vis) * H * 4 * D
    return (byts, ops, *_bound(byts, ops, BF16_FLOPS))


def phase_times(torch, engine):
    """Kernel, plain and library times at the main path's decode shapes,
    on the engine's own 32-layer stacks and cache."""
    from ant_quantization_tpu_torch.kernels import stacked as k1
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
    k2_rows = k2_time_rows(torch, kv, L, gen)
    emit({"phase": "kernel_times", "graphed": True, "K1_sites": sites,
          "K2": k2_rows})
    return sites, k2_rows


def k2_time_rows(torch, kv, L: int, gen) -> list:
    """K2 per launch on an engine's own L-layer cache (B, H, S, D from its
    shape; no ALiBi), layers rotated: decode (T = 1 at position PREFILL +
    DECODE - 1) and prefill (T = PREFILL at 0), q in bf16 as the engine
    passes it, beside its plain version, ``k2_bound`` and SDPA on the
    layer's dequantized bf16 cache (causal at prefill)."""
    import torch.nn.functional as F
    from ant_quantization_tpu_torch.kernels import attention as k2
    from ant_quantization_tpu_torch.kernels.kv_cache import dequant_kv
    _, B, H, S, D = kv.k.shape
    rows = []
    for T, p in ((1, PREFILL + DECODE - 1), (PREFILL, 0)):
        pos0 = torch.full((B,), p, dtype=torch.int32, device="cuda")
        # q in bf16, as the engine passes it
        q = torch.randn((B, H, T, D), device="cuda", generator=gen).to(
            torch.bfloat16)
        n_l = L if T == 1 else min(4, L)
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
        t_l = cuda_ms(torch, lambda i: F.scaled_dot_product_attention(
            q, kd[i % n_l], vd[i % n_l], is_causal=T > 1), iters)
        del kd, vd
        byts, ops, bound, by = k2_bound(B, H, T, D, S, [p] * B, q_bytes=2)
        rows.append({"T": T, "pos0": p, "B": B, "H": H, "S": S, "D": D,
                     "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                     "bound_ms": bound, "bound_by": by, "bytes": byts,
                     "ops": ops})
    return rows


def ovp_bound(M, K, N, dots: int, table_bytes: int):
    """K3's or K4's bound: each input read once (weights K*N int8, x f32,
    scales, tables) and the f32 output written once, against ``dots``
    int8 dots of 2*M*K*N operations each."""
    byts = K * N + 4 * M * K + 4 * M * N + 4 * N + table_bytes + 4
    ops = dots * 2 * M * K * N
    return (byts, ops, *_bound(byts, ops, INT8_OPS))


def phase_times_ovp(torch, olive_engine, ovpw_engine):
    """K3 and K4 times at one decode layer's six sites (M = 4), on the
    OVP weight stacks of the two OliVe engines (DEPTHS["olive"] layers)
    and their own
    tables, layers rotated so the weights come from device memory: the
    kernel, its launch plan, its plain version, the bound, K1 on the same
    weight stream (K3 and K4 run on its stream: the difference is their
    encode, extra dots and f32 order), and torch._int_mm on the same
    int8 weight stream and M as a reference point. _int_mm is one int8
    dot, not the same function: no single PyTorch call computes K3's dual
    or K4's quad dot with the encode."""
    from ant_quantization_tpu_torch.kernels import stacked as ks
    from ant_quantization_tpu_torch.serve.engine import _prepare_stacked
    stk4 = _prepare_stacked(olive_engine.cfg, olive_engine.engine_params(),
                            BATCH)
    stk3 = _prepare_stacked(ovpw_engine.cfg, ovpw_engine.engine_params(),
                            BATCH)
    L = olive_engine.cfg.lm.n_layers
    block_k = olive_engine.cfg.stacked_block_k
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    M, iters = BATCH, 2 * L
    rows = {"K3": [], "K4": []}
    for name in engine_layer_shapes(olive_engine.cfg.lm):
        s3, s4 = stk3[name], stk4[name]
        w = s4["w"]
        N, K = w.shape[1:]
        x = torch.randn((M, K), device="cuda", generator=gen)
        if name == "fc_out":
            x = x.relu()
        a4 = (s4["scales"], s4["prescale"], s4["mids"], s4["ties"],
              s4["enc"])
        a3 = (s3["scales"], s3["a_q"], s3["a_scale"])
        xq_pad = torch.randint(-64, 65, (32, K), dtype=torch.int8,
                               device="cuda", generator=gen)
        t_l = cuda_ms(torch, lambda i: torch._int_mm(xq_pad, w[i % L].t()),
                      iters)
        t_1 = cuda_ms(torch, lambda i: ks.stacked_quant_matmul(
            i % L, x, w, *a3), iters)
        for kern, fn, plain, args, kw, dots, tb, seg in (
                ("K4", ks.stacked_quant_matmul_aovp,
                 ks.stacked_quant_matmul_aovp_plain, a4, {"w_ovp": True}, 4,
                 4 * (31 + 31 + 32 + 1), ks.ovp_layout(K, block_k, K)[:2]),
                ("K3", ks.stacked_quant_matmul,
                 ks.stacked_quant_matmul_plain, a3, {"ovp": True}, 2,
                 4 * (s3["a_q"].shape[1] + 1),
                 ks.ovp_layout(K, block_k, ks._SUB)[:2])):
            t_k = cuda_ms(torch, lambda i: fn(i % L, x, w, *args, **kw),
                          iters)
            t_p = cuda_ms(torch, lambda i: plain(i % L, x, w, *args, **kw),
                          iters)
            plan = ks.k34_plan(M, K, N, *seg, aovp=kern == "K4")
            byts, ops, bound, by = ovp_bound(M, K, N, dots, tb)
            rows[kern].append({
                "site": name, "M": M, "K": K, "N": N, "ms": t_k,
                "mt": plan["mt"], "splits": plan["splits"],
                "blocks": plan["blocks"], "segment_rows": seg[0],
                "plain_ms": t_p, "bound_ms": bound, "bound_by": by,
                "bytes": byts, "ops": ops, "k1_ms": t_1, "int_mm_ms": t_l})
    emit({"phase": "kernel_times_ovp", "graphed": True,
          "k1_note": "K1 (stacked_quant_matmul, ovp=False) on the same "
                     "weight stream, M and stream design",
          "int_mm_note": "torch._int_mm (M padded to 32) on the same int8 "
                         "weight stream: one int8 dot, not the same "
                         "function", **rows})
    return rows


def phase_times_w4pack(torch, engine):
    """K6 and K8 times on the "w4pack" engine's own stacks:
    K6 at one decode layer's six sites (M = 4, layers rotated so the
    weights come from device memory) beside its byte bound, its plain
    version and torch._int_mm on the unpacked int8 weights (the same
    weight values at twice the bytes, one int8 dot without the snap: a
    reference point, not the same function); K8 at one prefill layer's six
    sites (M = 2048) on the engine's x (the site's fake-quant in bf16: one
    term, one bf16 product) and on f32 randn x (three terms and products),
    each beside its operation bound at the bf16 tensor-core rate (and, for
    history, the f32 bound of PR 3-5's design), its plain version, cuBLAS
    SGEMM (TF32 off) on the f32 operands, which is the same function, and
    torch.mm in bf16 on the bf16 operands, which rounds its output (a
    reference point only)."""
    from ant_quantization_tpu_torch.kernels import qmatmul as kq
    from ant_quantization_tpu_torch.kernels import stacked as ks
    from ant_quantization_tpu_torch.serve import engine as eng
    ep = engine.engine_params()
    stk = eng._prepare_stacked(engine.cfg, ep, BATCH)
    L = engine.cfg.lm.n_layers
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    rows = {"K6": [], "K8": []}
    for name in engine_layer_shapes(engine.cfg.lm):
        s = stk[name]
        w = s["w"]
        N, K = w.shape[1], 2 * w.shape[2]
        M, iters = BATCH, 2 * L
        x = torch.randn((M, K), device="cuda", generator=gen)
        args = (s["scales"], s["a_q"], s["a_scale"], s["q16"], s["affine"])
        t_k = cuda_ms(torch, lambda i: ks.stacked_quant_matmul_p4(
            i % L, x, w, *args), iters)
        t_p = cuda_ms(torch, lambda i: ks.stacked_quant_matmul_p4_plain(
            i % L, x, w, *args), iters)
        n_l = min(8, L)                      # 8 unpacked layers exceed L2
        codes = kq.unpack_w4(w[:n_l])
        w8 = ((codes - 8) if s["affine"] else s["q16"][:n_l].long().gather(
            1, codes.reshape(n_l, -1)).reshape(codes.shape)).to(torch.int8)
        del codes
        xq_pad = torch.randint(-64, 65, (32, K), dtype=torch.int8,
                               device="cuda", generator=gen)
        t_l = cuda_ms(torch, lambda i: torch._int_mm(xq_pad, w8[i % n_l].t()),
                      iters)
        del w8
        byts = K * N // 2 + 4 * M * K + 4 * M * N + 4 * N + 64 + 4 * 17
        bound, by = _bound(byts, 2 * M * K * N, INT8_OPS)
        plan = ks.k6_plan(M, K, N)
        rows["K6"].append({"site": name, "M": M, "K": K, "N": N,
                           "affine": s["affine"], "ms": t_k, "plain_ms": t_p,
                           "bound_ms": bound, "bound_by": by, "bytes": byts,
                           "int_mm_ms": t_l, "mt": plan["mt"],
                           "splits": plan["splits"],
                           "blocks": plan["blocks"]})
        site = ep["layers"][name]
        M, n_l = BATCH * PREFILL, 4
        k8 = [(site["packed"][l], site["scale"][l], site["grid"][l],
               site["k8_terms"][l], site["k8_unit"][l]) for l in range(n_l)]
        xf = torch.randn((M, K), device="cuda", generator=gen)
        # the engine's x: the site's fake-quant in cfg.dtype (bf16)
        xb = eng.quantize_activation(xf.to(torch.bfloat16),
                                     site["a_grid"][0], site["a_alpha"][0])
        row = {"site": name, "M": M, "K": K, "N": N}
        wdq = [kq.dequant_w4_reference(*a[:3]) for a in k8]       # (K, N)
        for tag, x in (("bf16", xb), ("f32", xf)):
            row[f"ms_{tag}_x"] = cuda_ms(
                torch, lambda i: kq.quantized_matmul_w4(x, *k8[i % n_l]),
                n_l)
        row["plain_ms"] = cuda_ms(torch, lambda i: kq.quantized_matmul_w4_plain(
            xb, *k8[i % n_l]), n_l)
        # cuBLAS SGEMM (TF32 off) on the f32 operands computes K8's
        # function; torch.mm in bf16 rounds its output (a reference point)
        xb32 = xb.to(torch.float32)
        row["library_ms"] = cuda_ms(torch, lambda i: torch.mm(
            xb32, wdq[i % n_l]), n_l)
        wbf = [w.to(torch.bfloat16) for w in wdq]
        row["bf16_mm_ms"] = cuda_ms(torch, lambda i: torch.mm(
            xb, wbf[i % n_l]), n_l)
        del wdq, wbf
        ops = 2 * M * K * N
        for tag, xbytes, prods in (("bf16", 2, 1), ("f32", 4, 3)):
            byts = xbytes * M * K + K * N // 2 + 4 * M * N + 4 * N + 64
            row[f"bound_ms_{tag}_x"], row[f"bound_by_{tag}_x"] = _bound(
                byts, ops * prods, BF16_FLOPS)
        row["bound_ms_f32_rate"] = _bound(4 * M * K + K * N // 2
                                          + 4 * M * N + 4 * N + 64, ops,
                                          F32_FLOPS)[0]
        row["ms"], row["bound_ms"] = row["ms_bf16_x"], row["bound_ms_bf16_x"]
        row["bound_by"] = row["bound_by_bf16_x"]
        rows["K8"].append(row)
    # K6's time per launch at a 4096 x 4096 site and at fc_in beside
    # their byte bounds, and the line through the two sites of one decode
    # (out and fc_in: the table): its value at zero bytes is the fixed
    # cost of a launch, its slope the stream's time per byte (the share of
    # a launch that a graphed decode could not hide); q, affine, beside
    at = {x["site"]: x for x in rows["K6"]}
    sq, fc = at["out"], at["fc_in"]
    slope = (fc["ms"] - sq["ms"]) / (fc["bytes"] - sq["bytes"])
    fixed = {f"{x['site']}_{k}": x[k] for x in (at["q"], sq, fc)
             for k in ("ms", "bound_ms", "bytes", "affine")}
    fixed.update(fit_sites=["out", "fc_in"],
                 fixed_us=(sq["ms"] - slope * sq["bytes"]) * 1e3,
                 stream_bytes_per_s=1e3 / slope if slope > 0 else None)
    emit({"phase": "kernel_times_w4pack", "graphed": True,
          "int_mm_note": "K6 beside torch._int_mm (M padded to 32) on the "
                         "unpacked int8 weights: one int8 dot, not the "
                         "same function", "k6_fixed_cost": fixed, **rows})
    rows["k6_fixed_cost"] = fixed
    return rows


def phase_times_k5(torch, engine):
    """K5 times at one prefill layer's six sites (M = 2048) on the ANT
    engine's 32-layer int8 stacks, layers rotated: beside its operation
    bound, its plain version, which is the torch route it replaces (the
    snap's where-chain, torch._int_mm, the scale), and torch._int_mm alone
    on the snapped codes (the product without the snap)."""
    from ant_quantization_tpu_torch.kernels import stacked as ks
    from ant_quantization_tpu_torch.ops.snap import snap_value
    ep = engine.engine_params()
    L = engine.cfg.lm.n_layers
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    M, iters = BATCH * PREFILL, 2 * L
    rows = []
    for name in engine_layer_shapes(engine.cfg.lm):
        s = ep["layers"][name]
        w, aq, asc = s["w_i8"], s["a_q"], s["a_scale"]
        sc = asc[:, None] * s["oscale"]
        N, K = w.shape[1:]
        x = torch.randn((M, K), device="cuda", generator=gen)
        t_k = cuda_ms(torch, lambda i: ks.stacked_quant_matmul(
            i % L, x, w, sc, aq, asc), iters)
        t_p = cuda_ms(torch, lambda i: ks.stacked_quant_matmul_plain(
            i % L, x, w, sc, aq, asc), iters)
        xq = snap_value(x / asc[0], aq[0]).to(torch.int8)
        t_l = cuda_ms(torch, lambda i: torch._int_mm(xq, w[i % L].t()),
                      iters)
        # the snap pre-kernel alone: x read once, the int8 codes written
        t_s = cuda_ms(torch, lambda i: ks.prefill_snap(i % L, x, aq, asc),
                      iters)
        snap_bytes = 4 * M * K + M * K + 4 * 17
        byts = 4 * M * K + K * N + 4 * M * N + 4 * N + 4 * 17
        ops = 2 * M * K * N
        bound, by = _bound(byts, ops, INT8_OPS)
        rows.append({"site": name, "M": M, "K": K, "N": N, "ms": t_k,
                     "plain_ms": t_p, "library_ms": t_l, "bound_ms": bound,
                     "bound_by": by, "bytes": byts, "ops": ops,
                     "snap_ms": t_s, "snap_bound_ms": _bound(
                         snap_bytes, 0, INT8_OPS)[0]})
    emit({"phase": "kernel_times_k5", "graphed": True,
          "plain_note": "K5's plain version is the torch route it replaces",
          "library_note": "torch._int_mm on the snapped codes: the product "
                          "without the snap",
          "snap_note": "the snap pre-kernel alone (part of every K5 launch), "
                       "beside its byte bound: x f32 read, int8 written",
          "K5": rows})
    return rows


def phase_times_k5_ovp(torch, ovpw_engine):
    """K5's OVP mode alone at one prefill layer's six sites (M = 2048) on
    the OVP-weights engine's stacks of OVP bytes, layers rotated:
    beside its bound (two int8 dots), its plain version (the torch route
    with two _int_mm and K3's f32 order) and torch._int_mm for one of its
    two dots on the same bytes (no single call computes the pair)."""
    from ant_quantization_tpu_torch.kernels import stacked as ks
    from ant_quantization_tpu_torch.serve.engine import _prepare_stacked
    stk = _prepare_stacked(ovpw_engine.cfg, ovpw_engine.engine_params(),
                           BATCH)
    L = ovpw_engine.cfg.lm.n_layers
    bk = ovpw_engine.cfg.stacked_block_k
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    M, iters = BATCH * PREFILL, 2 * L
    rows = []
    for name in engine_layer_shapes(ovpw_engine.cfg.lm):
        s = stk[name]
        w, sc, aq, asc = s["w"], s["scales"], s["a_q"], s["a_scale"]
        N, K = w.shape[1:]
        x = torch.randn((M, K), device="cuda", generator=gen)
        t_k = cuda_ms(torch, lambda i: ks.stacked_quant_matmul(
            i % L, x, w, sc, aq, asc, ovp=True, block_k=bk), iters)
        t_p = cuda_ms(torch, lambda i: ks.stacked_quant_matmul_plain(
            i % L, x, w, sc, aq, asc, ovp=True, block_k=bk), iters)
        xq = torch.randint(-64, 65, (M, K), dtype=torch.int8, device="cuda",
                           generator=gen)
        t_l = cuda_ms(torch, lambda i: torch._int_mm(xq, w[i % L].t()),
                      iters)
        byts, ops, bound, by = ovp_bound(M, K, N, 2, 4 * (aq.shape[1] + 1))
        rows.append({"site": name, "M": M, "K": K, "N": N, "ms": t_k,
                     "plain_ms": t_p, "bound_ms": bound, "bound_by": by,
                     "bytes": byts, "ops": ops, "int_mm_ms": t_l})
    emit({"phase": "kernel_times_k5_ovp", "graphed": True,
          "int_mm_note": "torch._int_mm on the same OVP bytes as int8: one "
                         "of K5's two dots, not the same function",
          "K5_ovp": rows})
    return rows


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


def traced_kernels(torch, fn, want: int):
    """The device kernels of one call of ``fn`` (``_profiled``'s rows)
    and the number of traces taken. The profiler now and then drops one
    of a call's kernels from its trace, a lost event and not a call that
    ran fewer kernels (the same call's other traces show them all), and
    never adds one: a trace with fewer than ``want`` kernels is taken
    again, at most three times in all; one with ``want`` or more ends
    the search, and the caller holds its count to ``want``."""
    for n in range(1, 4):
        _, rows = _profiled(torch, fn)
        if sum(c for _, _, c in rows) >= want:
            break
    return rows, n


def phase_profile(torch, engine, ids, steps: int = 4, path: str = "ANT",
                  prefill=None):
    """Device time by kernel for one prefill (``prefill``: a (name, call)
    pair in place of ``engine.prefill(ids)``) and for ``steps`` decode
    steps of a main-path engine, and the device's busy share of their
    wall time (one stream, so the kernel times add up to busy time)."""
    out = {"phase": "profile", "path": path}
    tok = ids[:, :1]

    def decode():
        nonlocal tok
        for _ in range(steps):
            tok = engine.decode(tok)[:, -1].argmax(-1, keepdim=True)

    name, call = prefill or ("prefill", lambda: engine.prefill(ids))
    for tag, fn, n in ((name, call, 1), ("decode", decode, steps)):
        wall_us, rows = _profiled(torch, fn)
        busy = sum(r[0] for r in rows)
        out[tag] = {"calls": n, "wall_us_per_call": wall_us / n,
                    "device_us_per_call": busy / n,
                    "device_busy_share": busy / wall_us,
                    "kernels_us_per_call": [
                        {"name": k[:100], "us": us / n, "count": c / n}
                        for us, k, c in rows[:10]]}
    emit(out)
    return out


def _greedy(torch, eng, cfg, ep, ids, k1fn, k2fn, steps: int = 8,
            k4fn=None, k6fn=None, k8fn=None):
    """Prefill + ``steps`` greedy decode steps of a fresh engine, with the
    engine's K1 (and K3, K5) / K2 / K4 / K6 / K8 entry points replaced by
    ``k1fn`` / ``k2fn`` / ``k4fn`` / ``k6fn`` / ``k8fn`` (None keeps the
    kernel)."""
    k4fn = k4fn or eng.stacked_quant_matmul_aovp
    k6fn = k6fn or eng.stacked_quant_matmul_p4
    k8fn = k8fn or eng.quantized_matmul_w4
    with mock.patch.object(eng, "stacked_quant_matmul", k1fn), \
            mock.patch.object(eng, "stacked_int8_kv_attention", k2fn), \
            mock.patch.object(eng, "stacked_quant_matmul_aovp", k4fn), \
            mock.patch.object(eng, "stacked_quant_matmul_p4", k6fn), \
            mock.patch.object(eng, "quantized_matmul_w4", k8fn):
        engine = eng.Engine(cfg, ep, BATCH)
        logits = [engine.prefill(ids)]
        toks = [logits[-1][:, -1].argmax(-1, keepdim=True)]
        for _ in range(steps):
            logits.append(engine.decode(toks[-1]))
            toks.append(logits[-1][:, -1].argmax(-1, keepdim=True))
    torch.cuda.synchronize()
    return torch.cat(toks, 1), torch.cat(logits, 1).float()


def _checked(torch, stats, tag, fn, plain, close=None, when=None):
    """``fn`` that also runs ``plain`` on the same inputs and tallies, in
    stats[tag], the calls, the largest difference and the calls that
    differ (bit for bit, or beyond ``close(out, want, args)``). Calls for
    which ``when(args)`` is false are passed through untallied."""
    st = stats.setdefault(tag, {"calls": 0, "max_abs_err": 0.0,
                                "failed": 0})

    def call(*args, **kw):
        out = fn(*args, **kw)
        if when is not None and not when(args):
            return out
        want = plain(*args, **kw)
        st["calls"] += 1
        st["max_abs_err"] = max(st["max_abs_err"], (
            out.float() - want.float()).abs().max().item())
        ok = (torch.equal(out, want) if close is None
              else close(out, want, args))
        st["failed"] += int(not ok)
        return out
    return call


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
    stats = {}
    k1_checked = _checked(torch, stats, "K1", k1.stacked_quant_matmul,
                          k1.stacked_quant_matmul_plain)
    k2_checked = _checked(torch, stats, "K2", k2.stacked_int8_kv_attention,
                          k2.stacked_int8_kv_attention_plain,
                          lambda out, want, a: k2_close(torch, out, want,
                                                        "bf16"))
    reset_counts()
    ta, la = _greedy(torch, eng, cfg, ep, ids, k1_checked, k2_checked)
    launched = tuple(read_counts()[k]["launches"] for k in ("K1", "K2"))
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
        stats["K1"]["calls"] > 0 and stats["K1"]["failed"] == 0
        and stats["K2"]["calls"] > 0 and stats["K2"]["failed"] == 0
        and all(launched) and res["k1_swap_tokens_identical"]
        and res["k1_swap_logits_identical"] and res["logits_finite"])
    emit(res)
    if not res["pass"]:
        fail(f"in-situ check: {res}")


def phase_insitu_olive(torch, gen):
    """The full-OliVe engine at 2 layers and full width, prefill + 8
    greedy steps: every K4 call checked against its plain version on the
    same inputs, then a run with K4's plain version, which must give
    identical greedy tokens and logits (K4 is bit-exact). The same for K3
    on the OVP-weights route over the same weights."""
    from ant_quantization_tpu_torch.kernels import attention as k2
    from ant_quantization_tpu_torch.kernels import stacked as ks
    from ant_quantization_tpu_torch.serve import engine as eng
    cfg = opt_engine_config(2, torch.bfloat16)
    ep = olive_engine_params(torch, cfg, seed=3)
    ep3 = ovp_weight_params(torch, cfg, ep)
    ids = torch.randint(0, cfg.lm.vocab_size, (BATCH, PREFILL),
                        device="cuda", generator=gen)
    stats = {}
    checked = lambda tag, fn, plain: _checked(torch, stats, tag, fn, plain)
    k2fn = k2.stacked_int8_kv_attention
    reset_counts()
    ta, la = _greedy(torch, eng, cfg, ep, ids, ks.stacked_quant_matmul,
                     k2fn, k4fn=checked("K4", ks.stacked_quant_matmul_aovp,
                                        ks.stacked_quant_matmul_aovp_plain))
    tb, lb = _greedy(torch, eng, cfg, ep, ids, ks.stacked_quant_matmul,
                     k2fn, k4fn=ks.stacked_quant_matmul_aovp_plain)
    tc, lc = _greedy(torch, eng, cfg, ep3, ids,
                     checked("K3", ks.stacked_quant_matmul,
                             ks.stacked_quant_matmul_plain), k2fn)
    td, ld = _greedy(torch, eng, cfg, ep3, ids,
                     ks.stacked_quant_matmul_plain, k2fn)
    launched = {k: v["launches"] for k, v in read_counts().items()}
    reset_counts()
    res = {"phase": "in_situ_olive", "layers": 2, "dtype": "bfloat16",
           "decode_steps": 8, "per_call": stats, "launches": launched,
           "k4_swap_tokens_identical": torch.equal(ta, tb),
           "k4_swap_logits_identical": torch.equal(la, lb),
           "k3_swap_tokens_identical": torch.equal(tc, td),
           "k3_swap_logits_identical": torch.equal(lc, ld),
           "logits_finite": bool(torch.isfinite(la).all()
                                 and torch.isfinite(lc).all())}
    res["pass"] = (
        all(st["calls"] == 6 * 2 * 8 and st["failed"] == 0
            for st in stats.values())
        and res["k4_swap_tokens_identical"]
        and res["k4_swap_logits_identical"]
        and res["k3_swap_tokens_identical"]
        and res["k3_swap_logits_identical"] and res["logits_finite"])
    emit(res)
    if not res["pass"]:
        fail(f"OliVe in-situ check: {res}")


def phase_insitu_w4pack(torch, gen):
    """The "w4pack" engine at 2 layers and full width, prefill + 8 greedy
    steps: every K6 call checked against its plain version (bit for bit)
    and every K8 call against its plain version (within K8_RTOL of the
    sum of term magnitudes), on the engine's own inputs; then a run with
    K6's plain version, which must give identical greedy tokens and
    logits."""
    from ant_quantization_tpu_torch.kernels import attention as k2
    from ant_quantization_tpu_torch.kernels import qmatmul as kq
    from ant_quantization_tpu_torch.kernels import stacked as ks
    from ant_quantization_tpu_torch.serve import engine as eng
    cfg = opt_engine_config(2, torch.bfloat16, weight_mode="w4pack")
    ep = w4pack_engine_params(torch, cfg, seed=5)
    ids = torch.randint(0, cfg.lm.vocab_size, (BATCH, PREFILL),
                        device="cuda", generator=gen)
    stats = {}
    k8_ok = lambda out, want, a: k8_close(torch, out, want,
                                          _k8_size(torch, *a[:4]))
    reset_counts()
    ta, la = _greedy(torch, eng, cfg, ep, ids, ks.stacked_quant_matmul,
                     k2.stacked_int8_kv_attention,
                     k6fn=_checked(torch, stats, "K6",
                                   ks.stacked_quant_matmul_p4,
                                   ks.stacked_quant_matmul_p4_plain),
                     k8fn=_checked(torch, stats, "K8", kq.quantized_matmul_w4,
                                   kq.quantized_matmul_w4_plain, k8_ok))
    tb, lb = _greedy(torch, eng, cfg, ep, ids, ks.stacked_quant_matmul,
                     k2.stacked_int8_kv_attention,
                     k6fn=ks.stacked_quant_matmul_p4_plain)
    launched = {k: v["launches"] for k, v in read_counts().items()}
    reset_counts()
    res = {"phase": "in_situ_w4pack", "layers": 2, "dtype": "bfloat16",
           "decode_steps": 8, "per_call": stats, "k8_rtol": K8_RTOL,
           "launches": launched,
           "k6_swap_tokens_identical": torch.equal(ta, tb),
           "k6_swap_logits_identical": torch.equal(la, lb),
           "logits_finite": bool(torch.isfinite(la).all())}
    res["pass"] = (
        stats["K6"]["calls"] == 6 * 2 * 8 and stats["K8"]["calls"] == 6 * 2
        and not stats["K6"]["failed"] and not stats["K8"]["failed"]
        and res["k6_swap_tokens_identical"]
        and res["k6_swap_logits_identical"] and res["logits_finite"])
    emit(res)
    if not res["pass"]:
        fail(f"w4pack in-situ check: {res}")


def phase_insitu_stacked_prefill(torch, gen):
    """The ANT main-path engine at 2 layers and full width with
    ``stacked_prefill=True``, prefill + 8 greedy steps: every K5 call (the
    prefill's, M = 2048) checked bit for bit against its plain version on
    the engine's own inputs, then a run with the plain version of
    ``stacked_quant_matmul`` (K5 and K1), which must give identical greedy
    tokens and logits."""
    from ant_quantization_tpu_torch.kernels import attention as k2
    from ant_quantization_tpu_torch.kernels import stacked as ks
    from ant_quantization_tpu_torch.serve import engine as eng
    cfg = opt_engine_config(2, torch.bfloat16, stacked_prefill=True)
    ep = random_engine_params(torch, cfg, seed=6)
    ids = torch.randint(0, cfg.lm.vocab_size, (BATCH, PREFILL),
                        device="cuda", generator=gen)
    stats = {}
    reset_counts()
    ta, la = _greedy(torch, eng, cfg, ep, ids,
                     _checked(torch, stats, "K5", ks.stacked_quant_matmul,
                              ks.stacked_quant_matmul_plain,
                              when=lambda a: a[1].shape[0] > ks.PREFILL_M),
                     k2.stacked_int8_kv_attention)
    tb, lb = _greedy(torch, eng, cfg, ep, ids, ks.stacked_quant_matmul_plain,
                     k2.stacked_int8_kv_attention)
    launched = {k: v["launches"] for k, v in read_counts().items()}
    reset_counts()
    res = {"phase": "in_situ_stacked_prefill", "layers": 2,
           "dtype": "bfloat16", "decode_steps": 8, "per_call": stats,
           "launches": launched,
           "k5_swap_tokens_identical": torch.equal(ta, tb),
           "k5_swap_logits_identical": torch.equal(la, lb),
           "logits_finite": bool(torch.isfinite(la).all())}
    res["pass"] = (
        stats["K5"]["calls"] == 6 * 2 and not stats["K5"]["failed"]
        and res["k5_swap_tokens_identical"]
        and res["k5_swap_logits_identical"] and res["logits_finite"])
    emit(res)
    if not res["pass"]:
        fail(f"stacked_prefill in-situ check: {res}")


# BLOOM-7b1 (bloom_config("7b1")): vocab 250,880, d_model 4096, 30 layers,
# 32 heads of 128, d_ff 16384, fused qkv, embed_ln, ALiBi, GELU
BLOOM_MAX_SEQ = 2048
BLOOM_LONG_SEQ = 16384
BLOOM_LONG_PROMPT = 31 * PREFILL        # 15,872 positions in 512-chunks
RAGGED_LENGTHS = (512, 384, 256, 128)
RAGGED_STEPS = 16
K9_A_SCALE = 0.19      # not a power of two: x * (1 / a) and x / a differ


def bloom_engine_config(n_layers: int, max_seq: int, dtype):
    import dataclasses
    from ant_quantization_tpu_torch.models.transformer_lm import bloom_config
    from ant_quantization_tpu_torch.serve.engine import EngineConfig
    lm = dataclasses.replace(bloom_config("7b1"), n_layers=n_layers,
                             max_seq=max_seq)
    return EngineConfig(lm=lm, weight_mode="w4", act_bits=4, kv_int8=True,
                        lm_head_int8=True, max_seq=max_seq, dtype=dtype)


def phase_checks_k7(torch, gen):
    """K7 against its plain version on the card: one layer's cache at
    S 2048 and 16384 (B 4, H 32, D 128), T 1, 4 and 16, ragged pos0, with
    and without ALiBi, bf16 and f32 output; K2's tolerance."""
    from ant_quantization_tpu_torch.kernels import attention as k2
    from ant_quantization_tpu_torch.models.transformer_lm import alibi_slopes
    B, H, D = BATCH, 32, 128
    slopes = torch.tensor(alibi_slopes(H), dtype=torch.float32,
                          device="cuda")
    errs = {"bf16": 0.0, "f32": 0.0}
    for S in (BLOOM_MAX_SEQ, BLOOM_LONG_SEQ):
        k = torch.randint(-127, 128, (B, H, S, D), dtype=torch.int8,
                          device="cuda", generator=gen)
        v = torch.randint(-127, 128, (B, H, S, D), dtype=torch.int8,
                          device="cuda", generator=gen)
        ks = torch.rand((B, H, S), device="cuda", generator=gen) * 0.02
        vs = torch.rand((B, H, S), device="cuda", generator=gen) * 0.02
        p0 = [0, 77, S // 2 + 5, S - 16][:B]
        pos0 = torch.tensor(p0, dtype=torch.int32, device="cuda")
        for T in (1, 4, 16):
            q = torch.randn((B, H, T, D), device="cuda", generator=gen)
            for sl in (None, slopes):
                for tag, dt in (("bf16", torch.bfloat16),
                                ("f32", torch.float32)):
                    got = k2.int8_kv_attention(q, k, v, ks, vs, pos0, sl,
                                               out_dtype=dt)
                    want = k2.int8_kv_attention_plain(q, k, v, ks, vs, pos0,
                                                      sl, out_dtype=dt)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    ok = k2_close(torch, got, want, tag)
                    emit({"phase": "check", "kernel": "K7", "S": S, "T": T,
                          "pos0": p0, "alibi": sl is not None, "out": tag,
                          "max_abs_err": err, "atol_rtol": K2_TOL[tag],
                          "pass": ok})
                    if not ok:
                        fail(f"K7 differs from its plain version: S={S} "
                             f"T={T} {tag} err {err}")
                    errs[tag] = max(errs[tag], err)
        del k, v, ks, vs
    return errs


def k9_ties(a_q, a_scale: float):
    """One f32 input per midpoint m of the sorted codebook ``a_q`` (numpy)
    with f32(x * f32(1 / a_scale)) == m where such an x exists, preferring
    one whose division x / a_scale misses m (K1's rule would snap it the
    other way)."""
    import numpy as np
    a = np.float32(a_scale)
    inv = np.float32(1) / a
    xs = []
    for m in (a_q[1:] + a_q[:-1]) * np.float32(0.5):
        x0 = np.float32(m * a)
        cands, lo, hi = [x0], x0, x0
        for _ in range(16):
            lo = np.nextafter(lo, np.float32(-np.inf))
            hi = np.nextafter(hi, np.float32(np.inf))
            cands += [lo, hi]
        hits = [x for x in cands if np.float32(x * inv) == m]
        off = [x for x in hits if np.float32(x / a) != m]
        xs.append((off or hits or [x0])[0])
    return np.float32(xs)


def _k9_operands(torch):
    """K9's codebook (the signed ANT flint grid as int8 values, sorted),
    its a_scale, and a row of exact midpoint ties after x * (1 / a)."""
    import numpy as np
    from ant_quantization_tpu_torch.kernels.qmatmul import int8_codebook
    from ant_quantization_tpu_torch.numerics import codebooks as cb
    aq = int8_codebook(cb.ant_grid("flint", 4, True))[0].astype(np.float32)
    ties = torch.tensor(k9_ties(aq, K9_A_SCALE), device="cuda")
    return (torch.tensor(aq, device="cuda"),
            torch.tensor([K9_A_SCALE], dtype=torch.float32, device="cuda"),
            ties)


def phase_checks_k9(torch, gen):
    """K9 against its plain version on the card, bit for bit, at OPT-6.7B's
    fc_in (4096 -> 16384) and fc_out (16384 -> 4096), M 1, 4, 64 (the
    __dp4a route), 65, 257, 300 and 2048 (the wgmma route), and at K 4160
    and N 4104, neither a multiple of the wgmma tiles (TMA's zero fill at
    the K and N tails); row 0 starts with an exact midpoint tie per
    codebook gap."""
    from ant_quantization_tpu_torch.kernels import qmatmul as kq
    a_q, a_scale, ties = _k9_operands(torch)
    err = 0.0
    for K, N, Ms in ((4096, 16384, (1, 4, 64, 65, 257, 300, 2048)),
                     (16384, 4096, (1, 4, 64, 65, 257, 300, 2048)),
                     (4160, 4104, (65, 300))):
        w = torch.randint(-64, 64, (N, K), dtype=torch.int8, device="cuda",
                          generator=gen)
        osc = torch.rand((N,), device="cuda", generator=gen) * 2e-3 + 1e-3
        for M in Ms:
            x = torch.randn((M, K), device="cuda", generator=gen) * 8 * \
                K9_A_SCALE
            x[0, :ties.shape[0]] = ties
            before = kq.K9_COUNTS["launches"]
            got = kq.fused_w8a8_matmul(x, w, a_q, a_scale, osc)
            if kq.K9_COUNTS["launches"] != before + 1:
                fail(f"K9 did not launch at M={M}")
            want = kq.fused_w8a8_matmul_plain(x, w, a_q, a_scale, osc)
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            equal = torch.equal(got, want)
            emit({"phase": "check", "kernel": "K9", "M": M, "K": K, "N": N,
                  "a_scale": K9_A_SCALE, "max_abs_err": e,
                  "bit_equal": equal})
            if not equal:
                fail(f"K9 differs from its plain version at M={M} K={K} "
                     f"N={N} (max abs err {e})")
            err = max(err, e)
        del w
    return err


def phase_checks_f32_out(torch, gen):
    """The library product behind every plain product of bf16 operands
    (``kernels/qmatmul.py:f32_out_product``: the dense "bf16" sites, the
    W4A16 branch, the plain head) against ``f32_product`` (an f32 product
    with TF32 off) on the same bf16 operands, at OPT-6.7B's site and head
    shapes at decode (M = 4) and prefill (M = 2048): within K8_RTOL of
    each output's |x| @ |w|. The bound must see a reduced-precision
    result: ``f32_product``'s own result rounded to bf16 has to break it
    at every shape. Both products timed at M = 2048."""
    from ant_quantization_tpu_torch.kernels import qmatmul as kq
    c = opt_engine_config(1, torch.bfloat16).lm
    shapes = {**engine_layer_shapes(c), "head": (c.d_model, c.vocab_size)}
    worst = 0.0
    for M in (BATCH, BATCH * PREFILL):
        for site, (K, N) in shapes.items():
            x = torch.randn((M, K), device="cuda", generator=gen).to(
                torch.bfloat16)
            w = (torch.randn((N, K), device="cuda", generator=gen)
                 / K ** 0.5).to(torch.bfloat16)
            got = kq.f32_out_product(x, w)
            want = kq.f32_product(x, w)
            size = kq.f32_product(x.abs(), w.abs())
            err = float(((got - want).abs() / size).max())
            rounded = float(((want.to(torch.bfloat16).float() - want).abs()
                             / size).max())
            row = {"phase": "check", "kernel": "f32_out_product",
                   "site": site, "M": M, "K": K, "N": N,
                   "out_dtype": str(got.dtype).split(".")[-1],
                   "max_err_over_size": err,
                   "bf16_rounded_err_over_size": rounded,
                   "pass": (got.dtype == torch.float32 and err <= K8_RTOL
                            and rounded > K8_RTOL)}
            if M > BATCH:
                row["ms"] = cuda_ms(
                    torch, lambda i: kq.f32_out_product(x, w), 5,
                    graph=False)
                row["f32_product_ms"] = cuda_ms(
                    torch, lambda i: kq.f32_product(x, w), 5, graph=False)
            emit(row)
            if not row["pass"]:
                fail(f"f32_out_product at {site} M={M}: {err} of |x|@|w| "
                     f"(bf16 rounding {rounded}), bound {K8_RTOL}")
            worst = max(worst, err)
            del x, w, got, want, size
    torch.cuda.empty_cache()
    return worst


# whole engines of bf16 activations: the median and largest |logit
# difference| over the largest |logit| (the bf16 engine rule of the CPU
# tests, tests/test_torch_engine_bf16.py)
ENGINE_BF16_TOL = (0.02, 0.1)


def hold_decode_step(torch, engine, phase: str) -> dict:
    """One decode step of a served engine against the same forward with
    every plain product of bf16 operands on ``f32_product`` (the same
    function, its f32 sums in another order): within ENGINE_BF16_TOL of
    the largest logit. Both calls write the step's K/V at the same
    position, each its own, and leave ``engine.pos`` as it was."""
    from ant_quantization_tpu_torch.kernels import qmatmul as kq
    from ant_quantization_tpu_torch.serve import engine as teng
    ep, kv = engine.engine_params(), engine.cache()
    tok = torch.zeros((engine.batch, 1), dtype=torch.long,
                      device=kv.k.device)
    with torch.no_grad():
        got, _ = teng.forward(engine.cfg, ep, tok, kv, engine.pos)
        with mock.patch.object(teng, "f32_out_product", kq.f32_product):
            want, _ = teng.forward(engine.cfg, ep, tok, kv, engine.pos)
    d = (got - want).abs()
    top = float(want.abs().max())
    med, big = ENGINE_BF16_TOL
    res = {"phase": "decode_step_hold", "path": phase, "pos": engine.pos,
           "top_logit": top, "median_diff_over_top": float(d.median()) / top,
           "max_diff_over_top": float(d.max()) / top,
           "same_argmax": bool(torch.equal(got.argmax(-1),
                                           want.argmax(-1))),
           "tol": ENGINE_BF16_TOL}
    res["pass"] = (bool(torch.isfinite(got).all())
                   and res["median_diff_over_top"] <= med
                   and res["max_diff_over_top"] <= big)
    emit(res)
    if not res["pass"]:
        fail(f"{phase}: a decode step off the f32_product forward: {res}")
    return res


def phase_bloom_main(torch, gen, n_layers: int = 30):
    """BLOOM-7b1 at full width (fused qkv at N = 12,288, embed_ln,
    ALiBi, GELU), ANT W4A4 + INT8 KV + int8 head, max_seq 2048, random
    weights from a seeded generator: ``Engine.prefill`` of bs 4 x 512 and
    64 greedy decode steps. Attention runs K2 at this cache length (the
    reference's route)."""
    from ant_quantization_tpu_torch.serve.engine import Engine, attention_route
    cfg = bloom_engine_config(n_layers, BLOOM_MAX_SEQ, torch.bfloat16)
    c = cfg.lm
    routes = {T: attention_route(c, T, cfg.max_seq) for T in (1, PREFILL)}
    if set(routes.values()) != {"K2"}:
        fail(f"bloom_main: attention routes {routes}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ep = random_engine_params(torch, cfg, seed=8)
    engine = Engine(cfg, ep, BATCH)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ids = torch.randint(0, c.vocab_size, (BATCH, PREFILL), device="cuda",
                        generator=gen)
    L = c.n_layers
    want = {"K1": 4 * L * DECODE, "K2": L * (1 + DECODE)}
    serve_path(torch, engine, ids, "bloom_main", want,
               {"param_build_s": build_s}, model="BLOOM-7b1")
    return engine, ep, ids


def phase_bloom_ragged(torch, engine, gen):
    """Ragged prompts on the bloom_main engine: lengths 512/384/256/128,
    bucket-padded to 512, through ``Engine.prefill(ids, lengths)`` (logits
    at lengths - 1), then RAGGED_STEPS greedy steps at pos0 = length +
    step. Launches counted around exactly that run. Then each sequence
    served alone at B = 1 on the batched run's tokens (its largest logit
    difference is reported), and a forward with a (B,) pos0 of equal
    entries, which must be bit-equal to the same forward with the scalar
    pos0 (a decode step and a 64-position chunk)."""
    from ant_quantization_tpu_torch.serve import engine as eng
    cfg, ep = engine.cfg, engine.engine_params()
    L, V = cfg.lm.n_layers, cfg.lm.vocab_size
    lengths = torch.tensor(RAGGED_LENGTHS, device="cuda")
    ids = torch.randint(0, V, (BATCH, max(RAGGED_LENGTHS)), device="cuda",
                        generator=gen)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logits = [engine.prefill(ids, lengths=lengths)]
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    toks = [logits[0][:, -1].argmax(-1, keepdim=True)]
    t0 = time.perf_counter()
    for _ in range(RAGGED_STEPS):
        logits.append(engine.decode(toks[-1]))
        toks.append(logits[-1][:, -1].argmax(-1, keepdim=True))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / RAGGED_STEPS
    counts = read_counts()
    reset_counts()
    pos_after = engine.pos.tolist()
    lg = torch.cat(logits, 1).float()                      # (B, 17, V)
    toks = torch.cat(toks, 1)
    alone_err, alone_same = [], []
    for b, n in enumerate(RAGGED_LENGTHS):
        one = eng.Engine(cfg, ep, 1)
        la = [one.prefill(ids[b:b + 1, :n])]
        for i in range(RAGGED_STEPS):
            la.append(one.decode(toks[b:b + 1, i:i + 1]))
        la = torch.cat(la, 1).float()
        alone_err.append((la - lg[b:b + 1]).abs().max().item())
        alone_same.append(torch.equal(la[0].argmax(-1), toks[b]))
        del one, la
    kv = engine.cache()
    bit_equal = {}
    top = cfg.max_seq - 64               # positions the run did not reach
    for tag, T, p in (("decode", 1, top - 1), ("chunk_64", 64, top)):
        x = torch.randint(0, V, (BATCH, T), device="cuda", generator=gen)
        a, _ = eng.forward(cfg, ep, x, kv, p)
        b_, _ = eng.forward(cfg, ep, x, kv, torch.full(
            (BATCH,), p, dtype=torch.int32, device="cuda"))
        bit_equal[tag] = torch.equal(a, b_)
    torch.cuda.synchronize()
    reset_counts()
    launches = {k: v["launches"] for k, v in counts.items()}
    want = {k: {"K1": 4 * L * RAGGED_STEPS,
                "K2": L * (1 + RAGGED_STEPS)}.get(k, 0) for k in launches}
    res = {"phase": "bloom_ragged", "model": "BLOOM-7b1", "layers": L,
           "lengths": list(RAGGED_LENGTHS), "bucket": ids.shape[1],
           "decode_steps": RAGGED_STEPS, "prefill_ms": prefill_ms,
           "decode_ms_per_step": step_ms,
           "positions_after": pos_after,
           "alone_b1_max_abs_logit_diff": alone_err,
           "alone_b1_greedy_tokens_identical": alone_same,
           "logits_max_abs": lg.abs().max().item(),
           "equal_entries_pos0_bit_equal_to_scalar": bit_equal,
           "launches": launches, "want_launches": want,
           "plain_calls": {k: v["plain_calls"] for k, v in counts.items()},
           "logits_finite": bool(torch.isfinite(lg).all())}
    res["pass"] = (launches == want and not any(res["plain_calls"].values())
                   and res["logits_finite"] and all(bit_equal.values())
                   and pos_after == [n + RAGGED_STEPS
                                     for n in RAGGED_LENGTHS])
    emit(res)
    if not res["pass"]:
        fail(f"bloom_ragged: {res}")
    return res


def phase_bloom_long(torch, ep, gen, n_layers: int = 30):
    """The long-context path: the bloom_main params (shared, not copied)
    served at max_seq 16,384, where one head's cache passes the
    reference's tile budget: a 4 x 15,872-token prompt fed by
    ``Engine.prefill(ids, chunk=512)`` as 31 forward calls at pos0 = 512 i
    (the einsum route: T > 16), then 64 greedy decode steps on K7."""
    from ant_quantization_tpu_torch.serve.engine import Engine, attention_route
    cfg = bloom_engine_config(n_layers, BLOOM_LONG_SEQ, torch.bfloat16)
    c = cfg.lm
    routes = {"prefill_chunk": attention_route(c, PREFILL, cfg.max_seq),
              "decode": attention_route(c, 1, cfg.max_seq)}
    if routes != {"prefill_chunk": "einsum", "decode": "K7"}:
        fail(f"bloom_long: attention routes {routes}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine = Engine(cfg, ep, BATCH)
    ids = torch.randint(0, c.vocab_size, (BATCH, BLOOM_LONG_PROMPT),
                        device="cuda", generator=gen)
    L = c.n_layers
    want = {"K1": 4 * L * DECODE, "K7": L * DECODE}
    res = serve_path(torch, engine, ids, "bloom_long", want,
                     {"routes": routes, "prefill_chunk": PREFILL,
                      "kv_cache_bytes": sum(t.numel() * t.element_size()
                                            for t in engine.cache())},
                     model="BLOOM-7b1", chunk=PREFILL)
    return engine, res["launches"], ids


def long_chunk(engine, ids):
    """The long prompt's last 512-position chunk once more, at its own
    pos0 (it rewrites the same cache rows with the same values): one
    forward call of the long prefill, for the profile."""
    from ant_quantization_tpu_torch.serve.engine import forward
    t0 = ids.shape[1] - PREFILL
    return forward(engine.cfg, engine.engine_params(), ids[:, t0:],
                   engine.cache(), t0, last_index=PREFILL - 1)


def phase_times_k7(torch, engine):
    """K7 per decode layer (one launch, T = 1) on the bloom_long engine's
    own cache at S = 16,384, layers rotated, pos0 at its last
    written position: beside its byte bound, its plain version, and SDPA
    on the layer's dequantized bf16 cache with the ALiBi bias as its mask
    (the same function)."""
    from ant_quantization_tpu_torch.models.transformer_lm import alibi_slopes
    kv = engine.cache()
    slopes = torch.tensor(alibi_slopes(kv.k.shape[2]), dtype=torch.float32,
                          device="cuda")
    row = k7_time_row(torch, kv, int(engine.pos) - 1, slopes)
    emit({"phase": "kernel_times_k7", "graphed": True,
          "library_note": "SDPA on the layer's dequantized bf16 cache, the "
                          "ALiBi bias as attn_mask", "K7": row})
    return row


def k7_time_row(torch, kv, p: int, slopes) -> dict:
    """K7 at T = 1 and pos0 ``p`` on the layers of a stacked cache ``kv``
    (L, B, H, S, D), rotated, beside ``k2_bound``, its plain version and
    SDPA on the dequantized bf16 cache with the ALiBi bias as its mask
    (``slopes`` None: no ALiBi, no mask)."""
    import torch.nn.functional as F
    from ant_quantization_tpu_torch.kernels import attention as k2
    from ant_quantization_tpu_torch.kernels.kv_cache import dequant_kv
    L, B, H, S, D = kv.k.shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    pos0 = torch.full((B,), p, dtype=torch.int32, device="cuda")
    q = torch.randn((B, H, 1, D), device="cuda", generator=gen)
    lay = lambda i: (kv.k[i % L], kv.v[i % L], kv.k_scale[i % L],
                     kv.v_scale[i % L])
    t_k = cuda_ms(torch, lambda i: k2.int8_kv_attention(
        q, *lay(i), pos0, slopes), 2 * L)
    t_p = cuda_ms(torch, lambda i: k2.int8_kv_attention_plain(
        q, *lay(i), pos0, slopes), 8)
    n_l = min(4, L)
    kd, vd = [], []
    for l in range(n_l):
        kl, vl = dequant_kv(type(kv)(*(a[l] for a in kv)), torch.bfloat16)
        kd.append(kl[:, :, :p + 1])
        vd.append(vl[:, :, :p + 1])
    rel = (torch.arange(p + 1, device="cuda") - p).to(torch.float32)
    bias = (None if slopes is None else (slopes[:, None] * rel[None, :]).to(
        torch.bfloat16)[None, :, None])
    qb = q.to(torch.bfloat16)
    t_l = cuda_ms(torch, lambda i: F.scaled_dot_product_attention(
        qb, kd[i % n_l], vd[i % n_l], attn_mask=bias), 2 * n_l)
    del kd, vd
    byts, ops, bound, by = k2_bound(B, H, 1, D, S, [p] * B)
    return {"T": 1, "pos0": p, "B": B, "H": H, "S": S, "D": D, "ms": t_k,
            "plain_ms": t_p, "library_ms": t_l, "bound_ms": bound,
            "bound_by": by, "bytes": byts, "ops": ops}


def phase_times_k9(torch, gen):
    """K9 at OPT-6.7B's fc_in and fc_out, M = 4 and M = 2048, on four
    weight copies rotated (each 67 MB, beyond L2): beside its bound, its
    plain version, and torch._int_mm on the snapped codes (M padded to
    32), the product without the snap."""
    from ant_quantization_tpu_torch.kernels import qmatmul as kq
    a_q, a_scale, _ = _k9_operands(torch)
    rows = []
    for site, (K, N) in (("fc_in", (4096, 16384)), ("fc_out", (16384, 4096))):
        ws = [torch.randint(-64, 64, (N, K), dtype=torch.int8, device="cuda",
                            generator=gen) for _ in range(4)]
        osc = torch.rand((N,), device="cuda", generator=gen) * 2e-3 + 1e-3
        for M in (BATCH, BATCH * PREFILL):
            x = torch.randn((M, K), device="cuda", generator=gen) * 8 * \
                K9_A_SCALE
            t_k = cuda_ms(torch, lambda i: kq.fused_w8a8_matmul(
                x, ws[i % 4], a_q, a_scale, osc), 8)
            t_p = cuda_ms(torch, lambda i: kq.fused_w8a8_matmul_plain(
                x, ws[i % 4], a_q, a_scale, osc), 8)
            xq = kq.w8a8_snap(x, a_q, a_scale)
            if M < 32:
                xq = torch.cat([xq, xq.new_zeros((32 - M, K))])
            t_l = cuda_ms(torch, lambda i: torch._int_mm(xq, ws[i % 4].t()),
                          8)
            byts = 4 * M * K + K * N + 4 * M * N + 4 * N + 4 * 17
            ops = 2 * M * K * N
            bound, by = _bound(byts, ops, INT8_OPS)
            rows.append({"site": site, "M": M, "K": K, "N": N, "ms": t_k,
                         "plain_ms": t_p, "library_ms": t_l,
                         "bound_ms": bound, "bound_by": by, "bytes": byts,
                         "ops": ops})
        del ws
    emit({"phase": "kernel_times_k9", "graphed": True,
          "library_note": "torch._int_mm on the snapped codes: the product "
                          "without the snap", "K9": rows})
    return rows


def phase_insitu_bloom(torch, gen):
    """The BLOOM engine at 2 layers and full width on the long cache
    (max_seq 16,384): a 1,024-token prompt in two 512-chunks (einsum
    route), then 8 greedy steps (K7). Every K7 call checked against its
    plain version (K2's bf16 tolerance), and at every site matmul of the
    run (the prefill's M = 2048 and the decode's M = 4) K9 is called on
    the engine's own activations with the site's weights and checked bit
    for bit against its plain version (no engine path calls K9). Then a
    run with K7's plain version, whose tokens are reported (not required
    equal: K7's other summation order can move an A4 snap downstream)."""
    from ant_quantization_tpu_torch.kernels import attention as k2
    from ant_quantization_tpu_torch.kernels import qmatmul as kq
    from ant_quantization_tpu_torch.serve import engine as eng
    cfg = bloom_engine_config(2, BLOOM_LONG_SEQ, torch.bfloat16)
    ep = random_engine_params(torch, cfg, seed=9)
    ids = torch.randint(0, cfg.lm.vocab_size, (BATCH, 2 * PREFILL),
                        device="cuda", generator=gen)
    stats = {}
    k7_checked = _checked(torch, stats, "K7", k2.int8_kv_attention,
                          k2.int8_kv_attention_plain,
                          lambda out, want, a: k2_close(torch, out, want,
                                                        "bf16"))
    k9 = _checked(torch, stats, "K9", kq.fused_w8a8_matmul,
                  kq.fused_w8a8_matmul_plain)
    real = eng._site_matmul_nobias

    def with_k9(cfg_, ep_, name, x2d, l, stk):
        s = ep_["layers"][name]
        k9(x2d, s["w_i8"][l], s["a_q"][l], s["a_scale"][l],
           s["a_scale"][l] * s["oscale"][l])
        return real(cfg_, ep_, name, x2d, l, stk)

    def run(k7fn, site_fn):
        with mock.patch.object(eng, "int8_kv_attention", k7fn), \
                mock.patch.object(eng, "_site_matmul_nobias", site_fn):
            engine = eng.Engine(cfg, ep, BATCH)
            logits = [engine.prefill(ids, chunk=PREFILL)]
            toks = [logits[-1][:, -1].argmax(-1, keepdim=True)]
            for _ in range(8):
                logits.append(engine.decode(toks[-1]))
                toks.append(logits[-1][:, -1].argmax(-1, keepdim=True))
        torch.cuda.synchronize()
        return torch.cat(toks, 1), torch.cat(logits, 1).float()

    reset_counts()
    ta, la = run(k7_checked, with_k9)
    launched = {k: v["launches"] for k, v in read_counts().items()}
    reset_counts()
    tb, lb = run(k2.int8_kv_attention_plain, real)
    reset_counts()
    res = {"phase": "in_situ_bloom", "layers": 2, "dtype": "bfloat16",
           "max_seq": BLOOM_LONG_SEQ, "prompt": 2 * PREFILL,
           "decode_steps": 8, "per_call": stats,
           "k7_atol_rtol": K2_TOL["bf16"], "launches": launched,
           "k7_plain_tokens_identical": torch.equal(ta, tb),
           "k7_plain_logits_max_abs_err": (la - lb).abs().max().item(),
           "logits_finite": bool(torch.isfinite(la).all())}
    res["pass"] = (
        stats["K7"]["calls"] == 2 * 8 and not stats["K7"]["failed"]
        and stats["K9"]["calls"] == 4 * 2 * (2 + 8)
        and not stats["K9"]["failed"]
        and launched["K7"] == 2 * 8 and launched["K9"] == 4 * 2 * (2 + 8)
        and res["logits_finite"])
    emit(res)
    if not res["pass"]:
        fail(f"BLOOM in-situ check: {res}")
    return res


# ---- slice 9: the unquantized engine options and the serving layer ----

# the scheduler phase's requests: prompt lengths over 20-512 (buckets 32,
# 128 and 512; 20 takes K1 at its batch-1 prefill) and new tokens 16-64
SCHED_PROMPTS = (20, 47, 100, 128, 200, 300, 384, 450, 512, 64)
SCHED_NEW = (16, 64, 32, 48, 24, 64, 16, 40, 56, 32)
SCHED_SLOTS, SCHED_BUCKETS = 4, (32, 128, 512)
SCHED_EOS = 3            # requests given an eos that fires early
SCHED_ORDER = (1, 8, 8, 1)   # ticks per dispatch of the runs, in turns
SPEC_K, SPEC_DRAFT_LAYERS = 4, 6


def dense_engine_params(torch, cfg, seed: int):
    """Random "bf16" engine params built on the card one layer at a time
    from a seeded generator: each site's dense kernel N(0, 1/K) in
    ``cfg.dtype`` in the port's (L, N, K) layout, zero biases; the
    LayerNorms and position table of ``random_engine_params``; a plain
    head in ``cfg.dtype``, uniform in +-0.02 (the int8 head's range)."""
    import numpy as np
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    c = cfg.lm
    L = c.n_layers
    layers = {}
    for name, (K, N) in engine_layer_shapes(c).items():
        w = torch.empty((L, N, K), dtype=cfg.dtype, device="cuda")
        for l in range(L):
            w[l] = (torch.randn((N, K), device="cuda", generator=gen)
                    / float(np.sqrt(K))).to(cfg.dtype)
        layers[name] = {"kernel": w,
                        "bias": torch.zeros((L, N), device="cuda")}
    rest = random_engine_params(torch, cfg, seed, sites=False)
    layers.update(rest["layers"])
    top = {k: v for k, v in rest["top"].items()
           if k not in ("wte_i8", "wte_scale")}
    top["wte"] = ((torch.rand((c.vocab_size, c.d_model), device="cuda",
                              generator=gen) * 2 - 1) * 0.02).to(cfg.dtype)
    return {"layers": layers, "top": top}


def stream_floor(cfg, weight_bytes: int, head_bytes: int) -> dict:
    """The least time of one decode step at bs BATCH: the weights, the
    head and the KV of the positions attended, each read once, over
    3.35 TB/s, at the mean context of the DECODE steps after a PREFILL
    prompt (ctx = PREFILL + DECODE / 2)."""
    c = cfg.lm
    ctx = PREFILL + DECODE // 2
    per_pos = (2 * c.head_dim * (2 if not cfg.kv_int8 else 1)
               + (0 if not cfg.kv_int8 else 8))        # k + v (+ scales)
    kv = c.n_layers * BATCH * c.n_heads * ctx * per_pos
    total = weight_bytes + head_bytes + kv
    return {"ctx": ctx, "weight_bytes": weight_bytes, "head_bytes": head_bytes,
            "kv_bytes": kv, "bytes": total, "floor_ms": total / HBM_BPS * 1e3}


def _site_bytes(c, per_weight: int) -> int:
    return c.n_layers * per_weight * sum(
        K * N for K, N in engine_layer_shapes(c).values())


def phase_bf16_baseline(torch, gen, n_layers: int = 32):
    """The unquantized baseline that Queue 1 item 2 divides by, bench.py's
    ``weight_mode="bf16", act_bits=0, kv_int8=False`` (and the plain
    head) at OPT-6.7B full width and depth, served as the main path: the
    dense sites run the library's bf16 product with an f32 result and
    attention the einsum on the raw bf16 cache, so no kernel of the port
    launches. Its stream floor beside the readings; then a profile."""
    from ant_quantization_tpu_torch.serve.engine import Engine
    cfg = opt_engine_config(n_layers, torch.bfloat16, weight_mode="bf16",
                            act_bits=0, kv_int8=False, lm_head_int8=False)
    c = cfg.lm
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = Engine(cfg, dense_engine_params(torch, cfg, seed=20), BATCH)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ids = torch.randint(0, c.vocab_size, (BATCH, PREFILL), device="cuda",
                        generator=gen)
    floor = stream_floor(cfg, _site_bytes(c, 2), 2 * c.vocab_size * c.d_model)
    res = serve_path(torch, engine, ids, "bf16_baseline", {},
                     {"param_build_s": build_s, "weight_mode": "bf16",
                      "act_bits": 0, "kv_int8": False,
                      "lm_head_int8": False, "stream_floor": floor})
    hold_decode_step(torch, engine, "bf16_baseline")
    phase_profile(torch, engine, ids, path="bf16 baseline")
    del engine
    torch.cuda.empty_cache()
    return res


def phase_w4a16(torch, gen, ant_ep):
    """"w4" without activation quantization (W4A16): the ANT main path's
    int8 weight stacks (shared, not copied) without their activation
    leaves, INT8 KV and the int8 head, at their depth. Every site runs the
    reference's unfused branch (x in bf16 against the int8 values, the
    library's bf16 product with an f32 result, then oscale), so K1 does
    not launch; attention runs K2. Then a profile."""
    from ant_quantization_tpu_torch.serve.engine import Engine
    cfg = opt_engine_config(len(ant_ep["layers"]["q"]["w_i8"]),
                            torch.bfloat16, act_bits=0)
    c = cfg.lm
    layers = {name: ({k: s[k] for k in ("w_i8", "oscale", "bias")}
                     if "w_i8" in s else s)
              for name, s in ant_ep["layers"].items()}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine = Engine(cfg, {"layers": layers, "top": ant_ep["top"]}, BATCH)
    ids = torch.randint(0, c.vocab_size, (BATCH, PREFILL), device="cuda",
                        generator=gen)
    floor = stream_floor(cfg, _site_bytes(c, 1),
                         c.vocab_size * (c.d_model + 4))
    res = serve_path(torch, engine, ids, "w4a16",
                     {"K2": c.n_layers * (1 + DECODE)},
                     {"weight_mode": "w4", "act_bits": 0,
                      "stream_floor": floor})
    hold_decode_step(torch, engine, "w4a16")
    phase_profile(torch, engine, ids, path="W4A16")
    del engine
    torch.cuda.empty_cache()
    return res


def margin_tol(top1: float) -> float:
    """The logit margin below which two runs whose K2 sums differ in
    order may pick different tokens: K2's bf16 tolerance at the top
    logit."""
    atol, rtol = K2_TOL["bf16"]
    return atol + rtol * abs(top1)


def _step_margin(torch, logits_row) -> tuple:
    top2 = logits_row.float().topk(2).values.tolist()
    return top2[0] - top2[1], margin_tol(top2[0])


def first_divergence(got, want, margins):
    """None when ``got`` equals ``want``; else (j, margin, tol) at the
    first position that differs (the rest of the streams then differ
    legitimately), the reference run's top-2 margin there and the
    tolerance it is held to."""
    for j, (a, b) in enumerate(zip(got, want)):
        if a != b:
            m, tol = margins[j]
            return {"at": j, "got": a, "want": b, "margin": m, "tol": tol,
                    "allowed": m <= tol}
    if len(got) != len(want):
        return {"at": min(len(got), len(want)), "length": [len(got),
                                                           len(want)],
                "allowed": False}
    return None


def phase_scheduler(torch, gen, cfg, ep):
    """A ContinuousBatcher over the OPT-6.7B ANT W4A4 engine:
    SCHED_SLOTS slots, buckets SCHED_BUCKETS, the requests SCHED_PROMPTS
    x SCHED_NEW, SCHED_EOS of them with an eos that fires early (the
    first token of the request's own stream that it did not emit before,
    from position 2 on). Runs with ticks_per_dispatch 1, 8, 8 and 1 (in
    turns, so that drift shows). Each
    completion is held against the same engine generating its prompt
    alone (B = 1, no padding): identical tokens, or a first divergence
    where that run's top-2 margin is within ``margin_tol`` (K2's split
    span depends on B; at this cache length it is the same at B = 1 and
    4, so none is expected). The launches of each run: K1 6 L per tick
    and per prefill of M <= 64, K2 L per tick and per prefill."""
    from ant_quantization_tpu_torch.serve import engine as eng
    from ant_quantization_tpu_torch.serve.scheduler import (
        ContinuousBatcher, Request)
    c = cfg.lm
    L, V = c.n_layers, c.vocab_size
    prompts = [torch.randint(0, V, (n,), device="cuda",
                             generator=gen).tolist() for n in SCHED_PROMPTS]
    one = eng.Engine(cfg, ep, 1)
    alone, margins = [], []
    t0 = time.perf_counter()
    for p, n in zip(prompts, SCHED_NEW):
        logits = one.prefill(torch.tensor([p], device="cuda"))
        toks, mg = [], []
        for i in range(n):
            toks.append(int(logits[0, -1].argmax()))
            mg.append(_step_margin(torch, logits[0, -1]))
            if i + 1 < n:
                logits = one.decode(torch.tensor([[toks[-1]]],
                                                 device="cuda"))
        alone.append(toks)
        margins.append(mg)
    alone_s = time.perf_counter() - t0
    del one
    eos = [None] * len(prompts)
    for i, toks in enumerate(alone):
        if sum(e is not None for e in eos) == SCHED_EOS:
            break
        j = next((j for j in range(2, len(toks) - 1)
                  if toks[j] not in toks[:j]), None)
        if j is not None:
            eos[i] = toks[j]
    want = [toks[:toks.index(e) + 1] if e is not None else toks
            for toks, e in zip(alone, eos)]
    if not any(e is not None for e in eos):
        fail("scheduler: no request's stream has a token to stop at")
    runs = {}
    for run, tpd in enumerate(SCHED_ORDER):
        calls = {"ticks": 0, "prefills": 0, "k1_prefills": 0}

        def fwd(ep_, ids_, kv_, pos0_, last_index=None):
            T = ids_.shape[1]
            if T == 1:
                calls["ticks"] += 1
            else:
                calls["prefills"] += 1
                calls["k1_prefills"] += int(
                    ids_.shape[0] * T <= cfg.stacked_max_m)
            return eng.forward(cfg, ep_, ids_, kv_, pos0_,
                               last_index=last_index)

        cb = ContinuousBatcher(cfg, ep, SCHED_SLOTS, SCHED_BUCKETS,
                               forward_fn=fwd)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        rids = [cb.submit(Request(prompt=p, max_new_tokens=n, eos_id=e))
                for p, n, e in zip(prompts, SCHED_NEW, eos)]
        done = cb.run(ticks_per_dispatch=tpd)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        reset_counts()
        by_id = {d.id: d for d in done}
        divs = {}
        for i, rid in enumerate(rids):
            d = first_divergence(by_id[rid].tokens, want[i], margins[i])
            reason = "eos" if eos[i] is not None else "length"
            if d is None and by_id[rid].finish_reason != reason:
                d = {"finish_reason": by_id[rid].finish_reason,
                     "allowed": False}
            if d is not None:
                divs[i] = d
        n_tok = sum(len(d.tokens) for d in done)
        launches = {k: v["launches"] for k, v in counts.items()}
        want_l = {k: 0 for k in launches}
        want_l["K1"] = 6 * L * (calls["ticks"] + calls["k1_prefills"])
        want_l["K2"] = L * (calls["ticks"] + calls["prefills"])
        runs[run] = {
            "ticks_per_dispatch": tpd, "wall_s": wall,
            "completed": len(done), "tokens": n_tok,
            "completed_tokens_per_s": n_tok / wall,
            "ticks": calls["ticks"], "ticks_per_s": calls["ticks"] / wall,
            "prefills": calls["prefills"],
            "slot_occupancy": (n_tok - len(done)) / max(
                1, calls["ticks"] * SCHED_SLOTS),
            "finish_reasons": [by_id[r].finish_reason for r in rids],
            "divergences": divs, "launches": launches,
            "want_launches": want_l,
            "plain_calls": {k: v["plain_calls"] for k, v in counts.items()},
            "tokens_by_request": [by_id[r].tokens for r in rids]}
    same = all(r["tokens_by_request"] == runs[0]["tokens_by_request"]
               for r in runs.values())
    res = {"phase": "scheduler", "model": "OPT-6.7B", "layers": L,
           "slots": SCHED_SLOTS, "buckets": list(SCHED_BUCKETS),
           "prompts": list(SCHED_PROMPTS), "max_new_tokens": list(SCHED_NEW),
           "eos": eos, "alone_s": alone_s,
           "margin_rule": "identical tokens, or a first divergence at a "
                          "top-2 margin <= K2 atol + rtol * |top logit|",
           "chunked_equals_per_tick": same,
           "runs": {str(k): {kk: vv for kk, vv in v.items()
                             if kk != "tokens_by_request"}
                    for k, v in runs.items()}}
    res["pass"] = all(
        r["completed"] == len(prompts) and r["launches"] == r["want_launches"]
        and not any(r["plain_calls"].values())
        and all(d["allowed"] for d in r["divergences"].values())
        for r in runs.values())
    emit(res)
    if not res["pass"]:
        fail(f"scheduler: {res}")
    return res


def _fwd_ms(torch, eng, cfg, ep, kv, T: int, pos: int, blocks: int = 4,
            block: int = 8) -> list:
    """Host ms per ``forward`` of (BATCH, T) tokens at position ``pos``
    (the same rows rewritten each call): ``blocks`` fenced blocks."""
    tok = torch.zeros((BATCH, T), dtype=torch.int64, device="cuda")
    for _ in range(2):
        eng.forward(cfg, ep, tok, kv, pos)
    out = []
    for _ in range(blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(block):
            eng.forward(cfg, ep, tok, kv, pos)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3 / block)
    return out


def plain_greedy(torch, eng, cfg, ep, ids, n: int):
    """The target decoding alone, one token a step: tokens (B, n) and,
    per sequence and step, the top-2 margin with its tolerance."""
    B, T = ids.shape
    kv = eng.init_cache(cfg, B, device="cuda")
    logits, _ = eng.forward(cfg, ep, ids, kv, 0, last_index=T - 1)
    toks, margins = [], [[] for _ in range(B)]
    for i in range(n):
        tok = logits[:, -1:].argmax(-1)
        toks.append(tok)
        for b in range(B):
            margins[b].append(_step_margin(torch, logits[b, -1]))
        if i + 1 < n:
            logits, _ = eng.forward(cfg, ep, tok, kv, T + i)
    return torch.cat(toks, 1).tolist(), margins


def phase_speculative(torch, gen, cfg, ep):
    """Speculative decoding: the OPT-6.7B ANT W4A4 target
    with a draft of the same geometry at SPEC_DRAFT_LAYERS layers (random
    weights, seed 1), k = SPEC_K, bs BATCH, a PREFILL-token prompt:
    - t_plain, t_verify and t_draft: host ms per target forward at T = 1
      and T = k + 1 and per draft forward at T = 1, at a fixed position;
    - generate of DECODE tokens at rounds per call 1 and 8: wall, tokens
      per second, accepted drafts per round; launches K1 6 L_t per verify
      and 6 L_d per draft step, K2 L per forward;
    - rows: K1 at M = B (k + 1) against the same rows at M = B, and K2's
      split route at T = k + 1 against T = 1 at each position, bit for
      bit;
    - draft = target (one params tree, two caches): every round accepts
      k for every sequence and the stream equals plain greedy decoding.
      Where a kernel's rows are not bit-equal, the check falls back to
      the margin rule of the scheduler phase and names the kernel."""
    from ant_quantization_tpu_torch.kernels import attention as k2
    from ant_quantization_tpu_torch.kernels import stacked as k1
    from ant_quantization_tpu_torch.serve import engine as eng
    from ant_quantization_tpu_torch.serve.speculative import (
        SpeculativeDecoder)
    c = cfg.lm
    K, Lt = SPEC_K, c.n_layers
    dcfg = opt_engine_config(SPEC_DRAFT_LAYERS, torch.bfloat16)
    dep = random_engine_params(torch, dcfg, seed=1)
    Ld = dcfg.lm.n_layers
    ids = torch.randint(0, c.vocab_size, (BATCH, PREFILL), device="cuda",
                        generator=gen)
    kv = eng.init_cache(cfg, BATCH, device="cuda")
    eng.forward(cfg, ep, ids, kv, 0, last_index=PREFILL - 1)
    kvd = eng.init_cache(dcfg, BATCH, device="cuda")
    eng.forward(dcfg, dep, ids, kvd, 0, last_index=PREFILL - 1)
    times = {"t_plain": _fwd_ms(torch, eng, cfg, ep, kv, 1, PREFILL),
             "t_verify": _fwd_ms(torch, eng, cfg, ep, kv, K + 1, PREFILL),
             "t_draft": _fwd_ms(torch, eng, dcfg, dep, kvd, 1, PREFILL)}
    # rows of K1 at M = B (k + 1) and of K2 at T = k + 1 (the cache now
    # holds rows PREFILL .. PREFILL + k from the t_verify calls)
    s = eng._prepare_stacked(cfg, ep, BATCH)["fc_in"]
    x = torch.randn((BATCH * (K + 1), c.d_model), device="cuda",
                    generator=gen).to(torch.bfloat16)
    y = k1.stacked_quant_matmul(0, x, s["w"], s["scales"], s["a_q"],
                                s["a_scale"])
    ys = torch.cat([k1.stacked_quant_matmul(
        0, x[i:i + BATCH], s["w"], s["scales"], s["a_q"], s["a_scale"])
        for i in range(0, x.shape[0], BATCH)])
    k1_rows_equal = torch.equal(y, ys)
    q = torch.randn((BATCH, c.n_heads, K + 1, c.head_dim), device="cuda",
                    generator=gen).to(torch.bfloat16)
    p0 = torch.full((BATCH,), PREFILL, dtype=torch.int32, device="cuda")
    o = k2.stacked_int8_kv_attention(Lt - 1, q, kv.k, kv.v, kv.k_scale,
                                     kv.v_scale, p0, None)
    o1 = torch.cat([k2.stacked_int8_kv_attention(
        Lt - 1, q[:, :, t:t + 1].contiguous(), kv.k, kv.v, kv.k_scale,
        kv.v_scale, p0 + t, None) for t in range(K + 1)], dim=2)
    k2_rows_equal = torch.equal(o, o1)
    del kv, kvd
    gens = {}
    for rpd in (1, 8):
        spec = SpeculativeDecoder(cfg, ep, dcfg, dep, k=K)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = spec.generate(ids, DECODE, rounds_per_dispatch=rpd)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        reset_counts()
        R = len(spec.accepted_hist)
        launches = {k: v["launches"] for k, v in counts.items()}
        want = {k: 0 for k in launches}
        want["K1"] = 6 * (Lt + Ld * (K + 1)) * R
        want["K2"] = Lt * (1 + R) + Ld * (1 + (K + 1) * R)
        n_tok = sum(len(o_) for o_ in out)
        gens[rpd] = {"rounds_per_dispatch": rpd, "wall_s": wall,
                     "tokens": n_tok, "tokens_per_s": n_tok / wall,
                     "rounds": R,
                     "accepted_per_round_and_sequence":
                         sum(spec.accepted_hist) / (R * BATCH),
                     "launches": launches, "want_launches": want,
                     "plain_calls": {k: v["plain_calls"]
                                     for k, v in counts.items()},
                     "streams": out}
    same_rpd = gens[1]["streams"] == gens[8]["streams"]
    # draft = target
    want_toks, margins = plain_greedy(torch, eng, cfg, ep, ids, DECODE)
    spec = SpeculativeDecoder(cfg, ep, cfg, ep, k=K)
    got = spec.generate(ids, DECODE, rounds_per_dispatch=8)
    divs = {}
    for b in range(BATCH):
        d = first_divergence(got[b], want_toks[b], margins[b])
        if d is not None:
            divs[b] = d
    all_k = all(a == K * BATCH for a in spec.accepted_hist)
    exact = k1_rows_equal and k2_rows_equal
    lossless = (not divs and all_k) if exact else all(
        d["allowed"] for d in divs.values())
    res = {"phase": "speculative", "model": "OPT-6.7B", "target_layers": Lt,
           "draft_layers": Ld, "k": K, "batch": BATCH,
           "prefill_tokens": PREFILL, "new_tokens": DECODE,
           **{k: statistics.median(v) for k, v in times.items()},
           "block_ms": times,
           "generate": {str(k): {kk: vv for kk, vv in v.items()
                                 if kk != "streams"}
                        for k, v in gens.items()},
           "rounds_per_dispatch_invariant": same_rpd,
           "k1_rows_m20_equal_m4": k1_rows_equal,
           "k2_rows_t5_equal_t1": k2_rows_equal,
           "draft_equals_target": {
               "accepted_hist": spec.accepted_hist,
               "accepts_k_every_round": all_k,
               "stream_equals_plain_greedy": not divs,
               "divergences": divs,
               "rule": "exact" if exact else "margin (a kernel's rows "
                                              "are not bit-equal)"}}
    res["pass"] = (lossless and same_rpd and all(
        g["launches"] == g["want_launches"]
        and not any(g["plain_calls"].values()) for g in gens.values()))
    emit(res)
    if not res["pass"]:
        fail(f"speculative: {res}")
    del dep
    torch.cuda.empty_cache()
    return res


# head_dims beside 128 that K2 and K7 serve, at their models' shapes:
# (head_dim, heads, K2's cache length, ALiBi) for GPT-2 XL at the main
# path's max_seq and BLOOM-3b at bloom_main's
HEADDIM_CASES = ((64, 25, MAX_SEQ, False), (80, 32, BLOOM_MAX_SEQ, True))


def phase_checks_headdim(torch, gen):
    """K2 and K7 against their plain versions at head_dim 64 (GPT-2 XL: B
    4, H 25, S 608) and 80 (BLOOM-3b: B 4, H 32, S 2048, ALiBi): K2 at T 1,
    4 and 16 (positions split across blocks) and 17 and 512 (bf16 tensor
    cores), pos0 0 and ragged with a last query at S - 1, bf16 q with bf16
    output and f32 with f32; K7 on one layer at S 16,384, T 1, 4 and 16,
    ragged pos0, ALiBi on and off. Within K2_TOL, each call one launch;
    the profiler sees one launch's kernels per call (the split pass and
    its combine up to 16 queries, one kernel above)."""
    from ant_quantization_tpu_torch.kernels import attention as k2
    from ant_quantization_tpu_torch.models.transformer_lm import alibi_slopes
    errs = {"K2": {}, "K7": {}}
    per_call, attempts = {}, {}
    n_checks = 0

    def check(kernel, D, fn, plain, counts, tag, **info):
        nonlocal n_checks
        before = counts["launches"]
        got = fn()
        if counts["launches"] != before + 1:
            fail(f"{kernel} did not launch once at head_dim {D}: {info}")
        want = plain()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = k2_close(torch, got, want, tag)
        emit({"phase": "check", "kernel": kernel, "head_dim": D, **info,
              "out": tag, "max_abs_err": err, "atol_rtol": K2_TOL[tag],
              "pass": ok})
        if not ok:
            fail(f"{kernel} differs from its plain version at head_dim {D}: "
                 f"{info} {tag} err {err}")
        e = errs[kernel].setdefault(D, {"bf16": 0.0, "f32": 0.0})
        e[tag] = max(e[tag], err)
        n_checks += 1

    def per_call_kernels(key, fn, want_n):
        fn()
        rows, attempts[key] = traced_kernels(torch, fn, want_n)
        per_call[key] = [{"name": k[:80], "count": c} for _, k, c in rows]
        if sum(c for _, _, c in rows) != want_n:
            fail(f"{key} ran {rows} on the device, not {want_n} kernels")

    B, L = BATCH, 2
    dts = (("bf16", torch.bfloat16), ("f32", torch.float32))
    for D, H, S, alibi in HEADDIM_CASES:
        slopes = torch.tensor(alibi_slopes(H), dtype=torch.float32,
                              device="cuda")
        sl = slopes if alibi else None
        k, v = (torch.randint(-127, 128, (L, B, H, S, D), dtype=torch.int8,
                              device="cuda", generator=gen)
                for _ in range(2))
        ks, vs = (torch.rand((L, B, H, S), device="cuda", generator=gen)
                  * 0.02 for _ in range(2))
        for T in (1, 4, 16, 17, 512):
            q32 = torch.randn((B, H, T, D), device="cuda", generator=gen)
            for p0 in ([0] * B, [0, 17, S // 2 if T < 256 else 50, S - T]):
                pos0 = torch.tensor(p0, dtype=torch.int32, device="cuda")
                for tag, dt in dts:
                    args = (1, q32.to(dt), k, v, ks, vs, pos0, sl)
                    check("K2", D,
                          lambda: k2.stacked_int8_kv_attention(
                              *args, out_dtype=dt),
                          lambda: k2.stacked_int8_kv_attention_plain(
                              *args, out_dtype=dt),
                          k2.COUNTS, tag, H=H, S=S, T=T, pos0=p0,
                          alibi=alibi)
            args = (1, q32.to(torch.bfloat16), k, v, ks, vs, pos0, sl)
            per_call_kernels(f"K2 D={D} T={T}",
                             lambda: k2.stacked_int8_kv_attention(*args),
                             2 if T <= k2.K7_MAX_T else 1)
        del k, v, ks, vs
        S = BLOOM_LONG_SEQ
        k, v = (torch.randint(-127, 128, (B, H, S, D), dtype=torch.int8,
                              device="cuda", generator=gen)
                for _ in range(2))
        ks, vs = (torch.rand((B, H, S), device="cuda", generator=gen) * 0.02
                  for _ in range(2))
        p0 = [0, 77, S // 2 + 5, S - 16][:B]
        pos0 = torch.tensor(p0, dtype=torch.int32, device="cuda")
        for T in (1, 4, 16):
            q32 = torch.randn((B, H, T, D), device="cuda", generator=gen)
            for sl in (None, slopes):
                for tag, dt in dts:
                    args = (q32.to(dt), k, v, ks, vs, pos0, sl)
                    check("K7", D,
                          lambda: k2.int8_kv_attention(*args, out_dtype=dt),
                          lambda: k2.int8_kv_attention_plain(
                              *args, out_dtype=dt),
                          k2.K7_COUNTS, tag, H=H, S=S, T=T, pos0=p0,
                          alibi=sl is not None)
        args = (q32[:, :, :1].to(torch.bfloat16), k, v, ks, vs, pos0, slopes)
        per_call_kernels(f"K7 D={D} T=1",
                         lambda: k2.int8_kv_attention(*args), 2)
        del k, v, ks, vs
    emit({"phase": "checks_headdim", "checks": n_checks,
          "kernels_per_call": per_call, "profiler_attempts": attempts})
    return errs


# GPT-2 XL (models/transformer_lm.py:gpt2_config("xl"): 48 layers, d_model
# 1600, 25 heads of 64, d_ff 6400, vocab 50,257, fused qkv, learned
# positions, gelu_new, every site Conv1D) under "w4" at the main path's
# batch, prompt, steps and max_seq
GPT2_MODEL = "GPT-2 XL"


def gpt2_engine_config(n_layers: int, dtype):
    import dataclasses
    from ant_quantization_tpu_torch.models.transformer_lm import gpt2_config
    from ant_quantization_tpu_torch.serve.engine import EngineConfig
    lm = dataclasses.replace(gpt2_config("xl"), n_layers=n_layers,
                             max_seq=MAX_SEQ)
    return EngineConfig(lm=lm, weight_mode="w4", act_bits=4, kv_int8=True,
                        lm_head_int8=True, max_seq=MAX_SEQ, dtype=dtype)


def gpt2_engine_params(torch, cfg, seed: int, olive: bool):
    """GPT-2 engine params built on the card from a seeded generator, one
    site-layer at a time, through the functions that
    ``build_engine_params`` runs for each Conv1D site-layer (weight_entry
    with ``conv1d``, act_entry, stack_entries): normal weights with std
    1/sqrt(K), quantized per INPUT channel at alpha = 2.5 times each input
    row's std, kept as ``kscale`` (K,). ANT (``olive`` False): the signed
    flint weight grid; signed flint A4 inputs at alpha 3. Full OliVe: OliVe
    int grids at qkv and flint elsewhere with their outliers, OVP pairs
    along the output axis; OVP activations (``olive_act_state``, signed:
    gelu_new's output is) at OLIVE_A_ALPHA."""
    import numpy as np
    from ant_quantization_tpu_torch.numerics import codebooks as cb
    from ant_quantization_tpu_torch.serve import engine as eng
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    c = cfg.lm
    dev = torch.device("cuda")
    layers = {}
    for name, (K, N) in engine_layer_shapes(c).items():
        if olive:
            mode = "int" if name == "qkv" else "flint"
            wq = {"grid": _pad16(cb.olive_grid(mode, 4, True)),
                  "outliers": _pad16(cb.olive_outlier_values(4, True))}
            aq = olive_act_state(True, OLIVE_A_ALPHA.get(name, 2.5))
        else:
            wq = {"grid": cb.ant_grid("flint", 4, True)}
            aq = {"grid": cb.ant_grid("flint", 4, True),
                  "alpha": np.float32(3.0)}
        es = []
        for _ in range(c.n_layers):
            w = torch.randn((K, N), device=dev, generator=gen) / float(
                np.sqrt(K))
            wq["alpha"] = (2.5 * w.std(dim=1)).cpu().numpy()      # (K,)
            e = {"bias": torch.zeros((N,), device=dev)}
            e.update(eng.weight_entry(w, wq, ovp=olive, conv1d=True))
            e.update(eng.act_entry(cfg, aq, ovp=olive, device=dev))
            es.append(e)
            del w
        layers[name] = eng.stack_entries(name, es)
        del es
    rest = random_engine_params(torch, cfg, seed, sites=False)
    layers.update(rest["layers"])
    return {"layers": layers, "top": rest["top"]}


def gpt2_stream_floor(cfg) -> dict:
    """GPT-2 XL's decode stream floor in two forms, over 3.35 TB/s: the
    reference's route (the int8 codes read, the f32 dequantized weight
    written and read again at every Conv1D site, the INT8 KV at S =
    MAX_SEQ with its scales, the int8 head) and what a fused route would
    read (the codes, the KV, the head)."""
    c = cfg.lm
    w = c.n_layers * sum(K * N for K, N in engine_layer_shapes(c).values())
    kv = 2 * c.n_layers * BATCH * c.n_heads * MAX_SEQ * (c.head_dim + 4)
    head = c.vocab_size * (c.d_model + 4)
    ref = w + 2 * 4 * w + kv + head
    fused = w + kv + head
    return {"weight_codes_bytes": w, "f32_weight_bytes": 4 * w,
            "kv_bytes": kv, "head_bytes": head,
            "reference_route_bytes": ref,
            "reference_route_ms": ref / HBM_BPS * 1e3,
            "fused_route_bytes": fused,
            "fused_route_ms": fused / HBM_BPS * 1e3}


def phase_gpt2_main(torch, gen, n_layers: int = 48):
    """GPT-2 XL at full width under ANT W4A4 (every site Conv1D,
    per-input-channel ``kscale``), INT8 KV and the int8 head: served as in
    5. Decode follows the reference's all-or-nothing rule, so no stacked
    product kernel runs (K1 0); every site takes the fake-quant and an f32
    product against its dequantized weight; attention runs K2 at head_dim
    64 (one launch per layer and forward)."""
    from ant_quantization_tpu_torch.serve.engine import Engine, attention_route
    cfg = gpt2_engine_config(n_layers, torch.bfloat16)
    c = cfg.lm
    routes = {T: attention_route(c, T, cfg.max_seq) for T in (1, PREFILL)}
    if set(routes.values()) != {"K2"} or c.head_dim != 64:
        fail(f"gpt2_main: attention routes {routes} at head_dim "
             f"{c.head_dim}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ep = gpt2_engine_params(torch, cfg, seed=11, olive=False)
    engine = Engine(cfg, ep, BATCH)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ids = torch.randint(0, c.vocab_size, (BATCH, PREFILL), device="cuda",
                        generator=gen)
    want = {"K2": c.n_layers * (1 + DECODE)}
    res = serve_path(torch, engine, ids, "gpt2_main", want,
                     {"param_build_s": build_s, "head_dim": c.head_dim,
                      "conv1d_sites": "all",
                      "stream_floor": gpt2_stream_floor(cfg)},
                     model=GPT2_MODEL)
    return engine, res["launches"], ids


def gpt2_ovp_shares(torch, engine, tok, steps: int = 8) -> dict:
    """The share of OVP outliers and victims of a full-OliVe GPT-2 engine:
    in each site's weight bytes (|byte| > 64; the victims are the zeroed
    partners along the OUTPUT axis, axis 0 of the port's (N, K) stack),
    and in the activations that the Conv1D route's fake-quant snaps over
    ``steps`` further decode steps (snapped values beyond 32, and their
    zeroed partners along the feature axis), with their RMS."""
    from ant_quantization_tpu_torch.ops.ovp import victim_mask
    from ant_quantization_tpu_torch.ops.snap import snap_concat
    from ant_quantization_tpu_torch.serve import engine as eng
    ep = engine.engine_params()
    out = {"weights": {}}
    for name in engine_layer_shapes(engine.cfg.lm):
        w = ep["layers"][name]["w_i8"]
        m = w.abs() > 64
        v = victim_mask(m, pair_axis=1)
        n = w.numel()
        out["weights"][name] = {
            "outliers": torch.count_nonzero(m & ~v).item() / n,
            "victims": torch.count_nonzero(v).item() / n, "values": n}
        del m, v
    tally = [0, 0, 0, 0.0]
    fq = eng.quantize_activation_ovp

    def fq_watch(x, grid16, out16, alpha):
        scale = (alpha / grid16.max()).to(torch.float32)
        full = torch.cat([grid16.float(), out16.float()])
        q, _ = snap_concat(x.float() / scale, full)
        m = q.abs() > 32
        v = victim_mask(m, pair_axis=-1)
        tally[0] += int((m & ~v).sum())
        tally[1] += int(v.sum())
        tally[2] += q.numel()
        tally[3] += x.float().pow(2).sum().item()
        return fq(x, grid16, out16, alpha)

    with mock.patch.object(eng, "quantize_activation_ovp", fq_watch):
        for _ in range(steps):
            tok = engine.decode(tok)[:, -1].argmax(-1, keepdim=True)
    reset_counts()
    o, v, n, sq = tally
    out["decode_activations_total"] = {"outliers": o / n, "victims": v / n,
                                       "values": n, "rms": (sq / n) ** 0.5}
    d = out["weights"]
    n = sum(x["values"] for x in d.values())
    out["weights_total"] = {k: sum(x[k] * x["values"] for x in d.values())
                            / n for k in ("outliers", "victims")}
    return out


def phase_gpt2_olive(torch, gen, n_layers: int = DEPTHS["gpt2_olive"]):
    """GPT-2 XL under full OliVe W4A4 (OVP weights paired along out at
    every Conv1D site, OVP activations), INT8 KV and the int8 head, served
    as in 5 (K2 only; no stacked kernel at a Conv1D site); then the
    observed OVP shares, which must be above 0."""
    from ant_quantization_tpu_torch.serve.engine import Engine
    cfg = gpt2_engine_config(n_layers, torch.bfloat16)
    c = cfg.lm
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = Engine(cfg, gpt2_engine_params(torch, cfg, seed=12, olive=True),
                    BATCH)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ids = torch.randint(0, c.vocab_size, (BATCH, PREFILL), device="cuda",
                        generator=gen)
    want = {"K2": c.n_layers * (1 + DECODE)}
    res = serve_path(torch, engine, ids, "gpt2_olive", want,
                     {"param_build_s": build_s,
                      "act_alpha": {n: OLIVE_A_ALPHA.get(n, 2.5)
                                    for n in engine_layer_shapes(c)}},
                     model=GPT2_MODEL)
    shares = gpt2_ovp_shares(torch, engine, ids[:, :1])
    emit({"phase": "gpt2_olive_ovp_shares", **shares})
    if not (shares["weights_total"]["outliers"] > 0
            and shares["weights_total"]["victims"] > 0
            and shares["decode_activations_total"]["outliers"] > 0
            and shares["decode_activations_total"]["victims"] > 0):
        fail(f"the GPT-2 OliVe path saw no outliers or victims: {shares}")
    return engine, res["launches"], ids


def phase_times_gpt2(torch, engine):
    """On the gpt2_main engine: K2 at head_dim 64 on its own 48-layer
    cache (decode and prefill, ``k2_time_rows``); and the Conv1D site
    route of one GPT-2 XL layer at M = 4 and 2048 on bf16 x, as the engine
    passes it: the whole route (``_site_matmul_nobias``: fake-quant, the
    dequantization, the f32 product), the dequantization alone (int8 x the
    f32 ``kscale``, one f32 weight written) and the f32 product alone on
    dequantized weights, layers rotated. Its bytes: the int8 codes read and
    the f32 weight written and read again."""
    from ant_quantization_tpu_torch.kernels.qmatmul import f32_product
    from ant_quantization_tpu_torch.serve import engine as eng
    ep, cfg = engine.engine_params(), engine.cfg
    L = cfg.lm.n_layers
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    k2_rows = k2_time_rows(torch, engine.cache(), L, gen)
    site_rows = []
    for M in (BATCH, BATCH * PREFILL):
        for name, (K, N) in engine_layer_shapes(cfg.lm).items():
            s = ep["layers"][name]
            x = torch.randn((M, K), device="cuda", generator=gen).to(
                cfg.dtype)
            n_l = L if M == BATCH else min(4, L)
            iters = 2 * n_l
            t_route = cuda_ms(torch, lambda i: eng._site_matmul_nobias(
                cfg, ep, name, x, i % n_l, None), iters)
            t_deq = cuda_ms(torch, lambda i: s["w_i8"][i % n_l]
                            * s["kscale"][i % n_l][None, :], iters)
            wv = [s["w_i8"][l] * s["kscale"][l][None, :]
                  for l in range(min(4, L))]
            t_mm = cuda_ms(torch, lambda i: f32_product(x, wv[i % len(wv)]),
                           iters)
            del wv
            site_rows.append({
                "site": name, "M": M, "K": K, "N": N, "route_ms": t_route,
                "dequant_ms": t_deq, "f32_product_ms": t_mm,
                "route_bytes": K * N * 9,
                "fused_bytes": K * N + 4 * K + M * K * 2 + 4 * M * N,
                "f32_product_bound_ms": 2 * M * K * N / F32_FLOPS * 1e3})
    per_layer = {M: {k: sum(r[k] for r in site_rows if r["M"] == M)
                     for k in ("route_ms", "dequant_ms", "f32_product_ms",
                               "route_bytes", "fused_bytes",
                               "f32_product_bound_ms")}
                 for M in (BATCH, BATCH * PREFILL)}
    emit({"phase": "kernel_times_gpt2", "graphed": True, "K2_head_dim_64":
          k2_rows, "kscale_sites": site_rows, "kscale_per_layer": per_layer,
          "library_note": "K2: SDPA on the layer's dequantized bf16 cache"})
    return k2_rows, per_layer


def phase_times_k7_bloom3b(torch, gen):
    """K7 at head_dim 80: one BLOOM-3b decode layer (B 4, H 32, D 80) at S
    = 16,384 with ALiBi, pos0 at the bloom_long path's last decode
    position, on a random two-layer cache (``k7_time_row``)."""
    from ant_quantization_tpu_torch.kernels.kv_cache import QuantKV
    from ant_quantization_tpu_torch.models.transformer_lm import (
        alibi_slopes, bloom_config)
    c = bloom_config("3b")
    shape = (2, BATCH, c.n_heads, BLOOM_LONG_SEQ)
    kv = QuantKV(*(torch.randint(-127, 128, shape + (c.head_dim,),
                                 dtype=torch.int8, device="cuda",
                                 generator=gen) for _ in range(2)),
                 *(torch.rand(shape, device="cuda", generator=gen) * 0.02
                   for _ in range(2)))
    slopes = torch.tensor(alibi_slopes(c.n_heads), dtype=torch.float32,
                          device="cuda")
    row = k7_time_row(torch, kv, BLOOM_LONG_PROMPT + DECODE - 1, slopes)
    emit({"phase": "kernel_times_k7_bloom3b", "graphed": True,
          "model": "BLOOM-3b", "K7": row})
    del kv
    return row


def phase_times_headdim(torch, gen) -> dict:
    """The head_dim rows that the engine paths leave untimed, on random
    INT8 caches: K2 at head_dim 80 (BLOOM-3b: B 4, H 32, S 2048, 8 layers
    rotated; decode at position 575 and a 512-query prefill, no ALiBi, as
    ``k2_time_rows`` times D 128 and 64) and K7 at head_dim 64 (GPT-2 XL:
    B 4, H 25, S 16,384, 2 layers; T = 1 at the bloom_long path's last
    decode position, no ALiBi; ``k7_time_row``)."""
    from ant_quantization_tpu_torch.kernels.kv_cache import QuantKV
    from ant_quantization_tpu_torch.models.transformer_lm import (
        bloom_config, gpt2_config)

    def cache(L, H, S, D):
        shape = (L, BATCH, H, S)
        return QuantKV(*(torch.randint(-127, 128, shape + (D,),
                                       dtype=torch.int8, device="cuda",
                                       generator=gen) for _ in range(2)),
                       *(torch.rand(shape, device="cuda", generator=gen)
                         * 0.02 for _ in range(2)))

    c = bloom_config("3b")
    kv = cache(8, c.n_heads, BLOOM_MAX_SEQ, c.head_dim)
    k2_rows = k2_time_rows(torch, kv, 8, gen)
    del kv
    c = gpt2_config("xl")
    kv = cache(2, c.n_heads, BLOOM_LONG_SEQ, c.head_dim)
    k7_row = k7_time_row(torch, kv, BLOOM_LONG_PROMPT + DECODE - 1, None)
    del kv
    torch.cuda.empty_cache()
    emit({"phase": "kernel_times_headdim", "graphed": True,
          "K2_head_dim_80": k2_rows, "K7_head_dim_64": k7_row})
    return {"K2": k2_rows, "K7": k7_row}


def phase_insitu_gpt2(torch, gen):
    """GPT-2 XL width at 2 layers (ANT, Conv1D sites), prefill + 8 greedy
    steps: every K2 call checked against its plain version on the
    engine's real activations and cache (K2_TOL), then a run on K2's plain
    version, whose greedy tokens and logits are reported beside it (K2 is
    not bit-exact, so a difference of its sums may move a quantized value
    downstream, as ``phase_insitu`` explains)."""
    from ant_quantization_tpu_torch.kernels import attention as k2
    from ant_quantization_tpu_torch.kernels import stacked as k1
    from ant_quantization_tpu_torch.serve import engine as eng
    cfg = gpt2_engine_config(2, torch.bfloat16)
    ep = gpt2_engine_params(torch, cfg, seed=13, olive=False)
    ids = torch.randint(0, cfg.lm.vocab_size, (BATCH, PREFILL),
                        device="cuda", generator=gen)
    stats = {}
    k2_checked = _checked(torch, stats, "K2", k2.stacked_int8_kv_attention,
                          k2.stacked_int8_kv_attention_plain,
                          lambda out, want, a: k2_close(torch, out, want,
                                                        "bf16"))
    reset_counts()
    ta, la = _greedy(torch, eng, cfg, ep, ids, k1.stacked_quant_matmul,
                     k2_checked)
    counts = read_counts()
    tb, lb = _greedy(torch, eng, cfg, ep, ids, k1.stacked_quant_matmul,
                     k2.stacked_int8_kv_attention_plain)
    reset_counts()
    res = {"phase": "in_situ_gpt2", "model": GPT2_MODEL, "layers": 2,
           "dtype": "bfloat16", "decode_steps": 8, "per_call": stats,
           "k2_atol_rtol": K2_TOL["bf16"],
           "launches": {k: v["launches"] for k, v in counts.items()},
           "k2_plain_tokens_identical": torch.equal(ta, tb),
           "k2_plain_logits_max_abs_err": (la - lb).abs().max().item(),
           "logits_finite": bool(torch.isfinite(la).all())}
    res["pass"] = (stats["K2"]["calls"] == 2 * 9
                   and stats["K2"]["failed"] == 0
                   and res["launches"]["K2"] == 2 * 9
                   and res["launches"]["K1"] == 0 and res["logits_finite"])
    emit(res)
    if not res["pass"]:
        fail(f"in-situ GPT-2 check: {res}")
    return res


# F5 (ROADMAP Queue 3): the product kernels at a K that is no multiple of
# 8, 16 or 64 (an OPT-shaped fc_out at d_ff 196)
F5_K = 196


def phase_checks_f5(torch, gen):
    """F5: ``int8_matmul`` at its smallest failing input ((32, 12) x (8,
    12)) and at K = 196 (a prefill product and the int8 head's shape), and
    K1 (M 1, 4, 64), K3 (M 4, also adversarial), K4 (M 4, int8-value and
    OVP weights), K6 (M 4 and 64, affine and table decode) and K5 (M 300
    and 2048, int8 values and OVP bytes) at K = 196 by N = 4096, each
    bit-equal to its plain version on the same card tensors (int8_matmul:
    to the CPU's exact product), each kernel call one launch. The
    wrappers pad K with zeros (x per call, the weight stack once per
    layout; ``kernels/stacked.py``), which adds nothing to the sums."""
    import numpy as np
    from ant_quantization_tpu_torch.kernels import qmatmul as kq
    from ant_quantization_tpu_torch.kernels import stacked as ks
    from ant_quantization_tpu_torch.kernels.qmatmul import (int8_codebook,
                                                            pack_w4)
    from ant_quantization_tpu_torch.numerics import codebooks as cb
    K, N, L = F5_K, 4096, 2
    worst = {}

    def check(kernel, counts, call, plain, **info):
        before = counts["launches"] if counts is not None else 0
        got = call()
        if counts is not None and counts["launches"] != before + 1:
            fail(f"F5: {kernel} did not launch once at {info}")
        want = plain()
        torch.cuda.synchronize()
        equal = torch.equal(got.cpu(), want.cpu())
        err = (got.double().cpu() - want.double().cpu()).abs().max().item()
        emit({"phase": "check_f5", "kernel": kernel, **info,
              "max_abs_err": err, "bit_equal": equal})
        if not equal:
            fail(f"F5: {kernel} differs from its plain version at {info} "
                 f"(max abs err {err})")
        worst[kernel] = max(worst.get(kernel, 0.0), err)

    for M, Kc, Nc in ((32, 12, 8), (2048, K, N), (4, K, 50272)):
        a = torch.randint(-127, 128, (M, Kc), dtype=torch.int8,
                          device="cuda", generator=gen)
        w = torch.randint(-127, 128, (Nc, Kc), dtype=torch.int8,
                          device="cuda", generator=gen)
        check("int8_matmul", None, lambda: kq.int8_matmul(a, w),
              lambda: kq.int8_matmul(a.cpu(), w.cpu()), M=M, K=Kc, N=Nc)
    x, w, sc, aq, asc, l = _k1_operands(torch, 2048, K, N, L, gen)
    for M in (1, 4, 64, 300, 2048):
        kern, counts = (("K1", ks.COUNTS) if M <= ks.PREFILL_M
                        else ("K5", ks.K5_COUNTS))
        check(kern, counts,
              lambda: ks.stacked_quant_matmul(l, x[:M], w, sc, aq, asc),
              lambda: ks.stacked_quant_matmul_plain(l, x[:M], w, sc, aq,
                                                    asc),
              M=M, K=K, N=N, mode="int8 values")
    for adversarial in (False, True):
        x, w, sc, aq, asc, l = _k3_operands(torch, 300, K, N, L, gen,
                                            adversarial)
        for M in (4, 300):
            kern, counts = (("K3", ks.K3_COUNTS) if M <= ks.PREFILL_M
                            else ("K5", ks.K5_COUNTS))
            check(kern, counts,
                  lambda: ks.stacked_quant_matmul(l, x[:M], w, sc, aq, asc,
                                                  ovp=True),
                  lambda: ks.stacked_quant_matmul_plain(
                      l, x[:M], w, sc, aq, asc, ovp=True),
                  M=M, K=K, N=N, mode="OVP bytes", adversarial=adversarial)
    for w_ovp in (False, True):
        x, w, sc, pre, mids, ties, enc, l = _k4_operands(
            torch, 4, K, N, L, gen, True, w_ovp, False)
        check("K4", ks.K4_COUNTS,
              lambda: ks.stacked_quant_matmul_aovp(l, x, w, sc, pre, mids,
                                                   ties, enc, w_ovp=w_ovp),
              lambda: ks.stacked_quant_matmul_aovp_plain(
                  l, x, w, sc, pre, mids, ties, enc, w_ovp=w_ovp),
              M=4, K=K, N=N, w_ovp=w_ovp)
    x, _, sc, aq, asc, l = _k1_operands(torch, 64, K, N, L, gen)
    for affine in (True, False):
        grid = cb.ant_grid("int" if affine else "flint", 4, True)
        q16 = torch.tensor(np.stack([int8_codebook(grid)[0]] * L).astype(
            np.int32), device="cuda")
        codes = torch.randint(0, 16, (L, K, N), device="cuda",
                              generator=gen)
        wp = torch.stack([pack_w4(codes[i]) for i in range(L)])
        for M in (4, 64):
            check("K6", ks.K6_COUNTS,
                  lambda: ks.stacked_quant_matmul_p4(l, x[:M], wp, sc, aq,
                                                     asc, q16, affine),
                  lambda: ks.stacked_quant_matmul_p4_plain(
                      l, x[:M], wp, sc, aq, asc, q16, affine),
                  M=M, K=K, N=N, affine=affine)
    reset_counts()
    torch.cuda.empty_cache()
    return worst


def percentile_f32(data, percent: float) -> float:
    """The reference's jitted percentile, in numpy, on host data (f32
    position, the order statistics by ``np.partition``, the contracted
    combine ``fma(low, 1 - w, high w)`` in f64): what
    ``ops/outlier.py:percentile_linear`` must give bit for bit."""
    import numpy as np
    f = np.float32
    n = data.size
    pos = f(f(percent * 100.0) / f(100.0)) * f(f(n) - f(1.0))
    lo = int(min(max(np.floor(pos), 0), n - 1))
    hi = int(min(max(np.ceil(pos), 0), n - 1))
    part = np.partition(data, (lo, hi))
    hw = f(pos - np.floor(pos))
    lw = f(f(1.0) - hw)
    return float(f(np.float64(part[lo]) * np.float64(lw)
                   + np.float64(f(part[hi] * hw))))


def phase_checks_percentile(torch, gen):
    """``outlier_thresholds`` (the GOBO mode's percentile of |x|) on the
    card at 67,108,864 elements (OPT-6.7B fc_in's weight), past the 2^24
    elements that ``torch.quantile`` takes: bit-equal to the same f32
    arithmetic in numpy on the same data (``percentile_f32``), and within
    1e-5 relative of numpy's ``np.percentile`` (f64 positions)."""
    import numpy as np
    from ant_quantization_tpu_torch.ops.outlier import outlier_thresholds
    x = torch.randn((4096, 16384), device="cuda", generator=gen) / 64
    host = np.abs(x.cpu().numpy()).reshape(-1)
    rows = []
    for percent in (0.9, 0.99, 0.999):
        t0 = time.perf_counter()
        t4, t16 = outlier_thresholds(x, percent)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        want = percentile_f32(host, percent)
        ref = float(np.percentile(host, percent * 100.0))
        row = {"percent": percent, "elements": host.size, "card": t4.item(),
               "f32_arith": want, "np_percentile": ref,
               "rel_to_np": abs(t4.item() - ref) / ref,
               "absmax_equal": t16.item() == float(host.max()),
               "seconds": secs}
        row["pass"] = (row["card"] == want and row["rel_to_np"] <= 1e-5
                       and row["absmax_equal"])
        rows.append(row)
        emit({"phase": "check_percentile", **row})
        if not row["pass"]:
            fail(f"outlier_thresholds at 67M elements: {row}")
    del x, host
    torch.cuda.empty_cache()
    return rows


CAL_TOKENS = 128           # one calibration batch of 4 x 128 random ids
CAL_STEPS = 16             # greedy decode steps of the calibrated engine
CAL_LAYERS = {"ant": 2, "olive": 1}
# the channels of layer 0's q and fc_in weights that the CPU calibrates
# beside the card (the whole tensor takes minutes on the host's cores)
CAL_CPU_CHANNELS = {"ant": 256, "olive": 128}
# scores within this relative gap are a near-tie, which the two devices'
# f32 sums may resolve either way (the CPU tests' rule)
CAL_TIE = 1e-5


def calibration_model(torch, family: str, n_layers: int, seed: int):
    """The port's fake-quant OPT-6.7B (``models/transformer_lm.py``) at
    full width and ``n_layers`` layers on the card, every weight (kernels
    and embeddings) normal with std 1/sqrt(its product's K) from a seeded
    generator, LayerNorms at 1 and 0, biases 0. ANT:
    QuantConfig(mode="ant-int-pot-flint", wbit=4, abit=4); OliVe:
    QuantConfig(family="olive", mode="ant-int-flint", w_up=250,
    a_up=250), the reference serve CLI's defaults."""
    import dataclasses
    from ant_quantization_tpu_torch.models.transformer_lm import (
        TransformerLM, opt_config)
    from ant_quantization_tpu_torch.nn.config import QuantConfig
    lm = dataclasses.replace(opt_config("6.7b"), n_layers=n_layers,
                             max_seq=MAX_SEQ)
    qcfg = (QuantConfig(mode="ant-int-pot-flint", wbit=4, abit=4)
            if family == "ant" else
            QuantConfig(family="olive", mode="ant-int-flint", w_up=250,
                        a_up=250))
    model = TransformerLM(lm, qcfg, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("kernel") or name.endswith("embedding"):
                k = p.shape[0] if name.endswith("kernel") else p.shape[1]
                p.copy_(torch.randn(p.shape, device="cuda", generator=g)
                        / float(k) ** 0.5)
    return model


def hold_calibrate_on_cpu(torch, x, cfg, tag: str) -> dict:
    """The card's ``calibrate`` of ``x`` against the same function on the
    CPU: type, bit and signedness equal; alpha bit-equal per channel, or
    the two devices' ratios a near-tie (their CPU scores within CAL_TIE),
    which is printed; OliVe's 3-sigma base within 2 ulps."""
    import numpy as np
    from ant_quantization_tpu_torch.calibrate import search as cs
    t0 = time.perf_counter()
    card = cs.calibrate(x, cfg)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    xc = x.cpu()
    t0 = time.perf_counter()
    cpu = cs.calibrate(xc, cfg)
    cpu_s = time.perf_counter() - t0
    pc = cfg.per_channel
    flat = lambda t: (torch.movedim(t, cfg.channel_axis, 0).reshape(
        t.shape[cfg.channel_axis], -1) if pc else t.reshape(-1))
    x2 = flat(xc)
    base_cpu = cs._x_max(x2, cfg, pc).reshape(-1)
    base_card = cs._x_max(flat(x), cfg, pc).cpu().reshape(-1)
    a_cpu, a_card = cpu.alpha.reshape(-1), card.alpha.cpu().reshape(-1)
    same = {f: bool(torch.equal(getattr(card, f).cpu(), getattr(cpu, f)))
            for f in ("mode_idx", "bit", "is_signed")}
    base_ok = bool(((base_card - base_cpu).abs() <= 2 * torch.from_numpy(
        np.spacing(base_cpu.abs().numpy()))).all())
    ratios = torch.tensor(cs._ratio_ladder(cfg.low, cfg.up, cfg.scan_step),
                          dtype=torch.float32)
    r_cpu = (a_cpu[:, None] - base_cpu[:, None] * ratios).abs().argmin(1)
    r_card = (a_card[:, None] - base_card[:, None] * ratios).abs().argmin(1)
    diff = (r_cpu != r_card) | ((a_cpu != a_card) & (base_cpu == base_card))
    ties = []
    if bool(diff.any()) and same["mode_idx"]:
        mode = cb_mode(int(cpu.mode_idx))
        grid = torch.as_tensor(cs._grid_pair(cfg, mode, int(cpu.bit), True)[
            int(bool(cpu.is_signed))])
        out = (torch.as_tensor(cs._outlier_pair(int(cpu.bit))[
            int(bool(cpu.is_signed))]) if cfg.use_ovp else None)
        rows = torch.nonzero(diff).reshape(-1)[:64]
        for i in rows.tolist():
            xi = x2[i:i + 1] if pc else x2
            s = [float(cs._mse(cs._fq(xi, grid, out, base_cpu[i:i + 1] * r
                                       if pc else base_cpu[0] * r, cfg, pc),
                               xi, pc).reshape(-1)[0])
                 for r in (ratios[r_cpu[i]], ratios[r_card[i]])]
            ties.append({"channel": i, "ratios": [float(ratios[r_cpu[i]]),
                                                  float(ratios[r_card[i]])],
                         "cpu_scores": s,
                         "gap": abs(s[0] - s[1]) / min(s)})
    n_diff = int(diff.sum())
    res = {"phase": "calibrate_cpu_hold", "tensor": tag,
           "shape": list(x.shape), "per_channel": pc, "card_s": card_s,
           "cpu_s": cpu_s, "same": same, "base_within_2ulp": base_ok,
           "channels": int(a_cpu.numel()), "alpha_bit_equal":
           int(a_cpu.numel()) - n_diff, "near_ties": ties,
           "mode": cb_mode(int(card.mode_idx))}
    res["pass"] = (all(same.values()) and base_ok and len(ties) == n_diff
                   and all(t["gap"] <= CAL_TIE for t in ties))
    emit(res)
    if not res["pass"]:
        fail(f"calibrate on the card against the CPU, {tag}: {res}")
    return res


def cb_mode(i: int) -> str:
    from ant_quantization_tpu_torch.numerics.codebooks import ANT_MODES
    return ANT_MODES[i]


def hold_logits(torch, got, want, tag: str) -> dict:
    """The bf16 engine rule (ENGINE_BF16_TOL): median |d| and largest |d|
    over the largest |logit| of ``want``, and the same greedy token;
    reported, and required of finite logits only: at A4 an ulp between
    the two routes moves an activation across a midpoint, and the move
    spreads through the layers (``hold_sites`` holds each site alone)."""
    d = (got.float() - want.float()).abs()
    top = float(want.abs().max())
    med, big = ENGINE_BF16_TOL
    res = {"phase": "calibrated_logits_hold", "path": tag, "top_logit": top,
           "median_diff_over_top": float(d.median()) / top,
           "max_diff_over_top": float(d.max()) / top,
           "same_argmax": bool(torch.equal(got.argmax(-1),
                                           want.argmax(-1))),
           "tol": ENGINE_BF16_TOL}
    res["within_rule"] = (res["same_argmax"]
                          and res["median_diff_over_top"] <= med
                          and res["max_diff_over_top"] <= big)
    res["pass"] = (bool(torch.isfinite(got).all())
                   and got.shape == want.shape)
    emit(res)
    if not res["pass"]:
        fail(f"{tag}: the engine's logits are not finite: {res}")
    return res


# the share of a site's activation values whose A4 code moved between the
# engine's route and the fake-quant one on the same input (an ulp apart
# across a midpoint); each such row is held only to its finite values
CAL_MOVED_MAX = 1e-5


def hold_sites(torch, cfg, ep, model, prompt, tag: str) -> dict:
    """One prefill of the engine built from the calibrated tree, every
    site matmul held against the fake-quant model's ``QuantDense`` on the
    same input (the engine's own, so that no earlier difference carries
    over): within K8_RTOL of |qx| @ |qw| + |bias| per output, where qx and
    qw are the fake-quant values, except in rows where the engine's
    activation code moved from the fake-quant's (``x / a_scale`` against
    ``x / scale`` an ulp apart across a midpoint), which are counted and
    must stay below CAL_MOVED_MAX of the values."""
    from ant_quantization_tpu_torch.ops.snap import snap_value
    from ant_quantization_tpu_torch.serve import engine as teng
    real = teng._site_matmul
    stats = {"calls": 0, "values": 0, "moved": 0, "moved_rows": 0,
             "max_err_over_size": 0.0}

    def watch(cfg_, ep_, name, x2d, l, stk):
        y = real(cfg_, ep_, name, x2d, l, stk)
        block = getattr(model, f"h_{l}")
        qd = getattr(block.attn if name in ("q", "k", "v", "out")
                     else block, name)
        with torch.no_grad():
            x = x2d.to(torch.float32)
            want = qd(x)
            qx = qd.input_q(x, False)
            qw = qd.weight_q(qd.kernel, False)
            size = qx.abs() @ qw.abs() + qd.bias.abs()
            site = ep_["layers"][name]
            if "a_q" in site:
                xe = snap_value(x / site["a_scale"][l], site["a_q"][l]) \
                    * site["a_scale"][l]
            else:
                xe = teng._fake_quant(x, site, l)
            moved = (xe - qx).abs() > 1e-5 * qx.abs().amax()
            rows = moved.any(dim=1)
            err = ((y.float() - want).abs() / size)[~rows]
        stats["calls"] += 1
        stats["values"] += x.numel()
        stats["moved"] += int(moved.sum())
        stats["moved_rows"] += int(rows.sum())
        if err.numel():
            stats["max_err_over_size"] = max(stats["max_err_over_size"],
                                             float(err.max()))
        return y

    kv = teng.init_cache(cfg, prompt.shape[0], device=prompt.device)
    with mock.patch.object(teng, "_site_matmul", watch), torch.no_grad():
        teng.forward(cfg, ep, prompt, kv, 0)
    res = {"phase": "calibrated_sites_hold", "path": tag, **stats,
           "rtol_of_size": K8_RTOL, "moved_share": stats["moved"]
           / stats["values"], "moved_max": CAL_MOVED_MAX}
    res["pass"] = (stats["calls"] == 6 * model.cfg.n_layers
                   and res["max_err_over_size"] <= K8_RTOL
                   and res["moved_share"] <= CAL_MOVED_MAX)
    emit(res)
    if not res["pass"]:
        fail(f"{tag}: a site of the engine off the fake-quant model: {res}")
    return res


def calibrate_serve(torch, gen, family: str) -> dict:
    """One family of the calibrate_serve phase (see phase_calibrate_serve):
    calibrate, hold against the CPU, build, hold the logits, serve."""
    import collections
    from ant_quantization_tpu_torch.calibrate.promote import quant_sites
    from ant_quantization_tpu_torch.harness.evaluate import (
        calibrate_on_batches)
    from ant_quantization_tpu_torch.models.transformer_lm import params_tree
    from ant_quantization_tpu_torch.serve.engine import (
        Engine, build_engine_params)
    n_layers = CAL_LAYERS[family]
    torch.cuda.reset_peak_memory_stats()
    model = calibration_model(torch, family, n_layers, seed=11)
    c = model.cfg
    ids = torch.randint(0, c.vocab_size, (BATCH, CAL_TOKENS), device="cuda",
                        generator=gen)
    layer_s, captured = [], {}

    def pre(m, args):
        torch.cuda.synchronize()
        m.t0 = time.perf_counter()

    def post(m, args, out):
        torch.cuda.synchronize()
        layer_s.append(time.perf_counter() - m.t0)

    hooks = [getattr(model, f"h_{i}").register_forward_pre_hook(pre)
             for i in range(n_layers)]
    hooks += [getattr(model, f"h_{i}").register_forward_hook(post)
              for i in range(n_layers)]
    def keep_q_input(m, args):
        captured.setdefault("q_input", args[0].detach())

    hooks.append(model.h_0.attn.q.register_forward_pre_hook(keep_q_input))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quant = calibrate_on_batches(model, [(ids,)])
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    kinds = collections.defaultdict(collections.Counter)
    for path, st in quant_sites(quant):
        for k, s in st.items():
            kinds[f"{path[-1]}.{k}"][cb_mode(int(s.mode_idx))] += 1
    res = {"family": family, "layers": n_layers, "d_model": c.d_model,
           "calibration_tokens": BATCH * CAL_TOKENS,
           "calibration_s": cal_s, "seconds_per_layer": layer_s,
           "types_by_site": {k: dict(v) for k, v in sorted(kinds.items())}}
    emit({"phase": "calibrate", **res})
    ch = CAL_CPU_CHANNELS[family]
    holds = [hold_calibrate_on_cpu(
        torch, getattr(model.h_0.attn.q if s == "q" else model.h_0.fc_in,
                       "kernel").detach()[:, :ch],
        (model.h_0.attn.q if s == "q" else model.h_0.fc_in).weight_q.cfg,
        f"h_0.{s}.kernel[:, :{ch}]") for s in ("q", "fc_in")]
    holds.append(hold_calibrate_on_cpu(
        torch, captured["q_input"].float(), model.h_0.attn.q.input_q.cfg,
        "h_0.attn.q input"))
    params = params_tree(model)
    # the engine against the fake-quant model: f32, the raw cache and the
    # plain head, so that only the int8 products (or, with OVP
    # activations, the unfused route) differ from the model
    check_cfg = opt_engine_config(n_layers, torch.float32, kv_int8=False,
                                  lm_head_int8=False)
    eng = Engine(check_cfg, build_engine_params(check_cfg, params, quant,
                                                device="cuda"), BATCH)
    prompt = torch.randint(0, c.vocab_size, (BATCH, PREFILL), device="cuda",
                           generator=gen)
    res["sites_hold"] = hold_sites(torch, check_cfg, eng.engine_params(),
                                   model, prompt, f"{family} prefill")
    got = eng.prefill(prompt)
    with torch.no_grad():
        want = model(prompt)[:, -1:]
    res["logits_hold"] = hold_logits(torch, got, want, f"{family} prefill")
    del eng, got, want
    cfg = opt_engine_config(n_layers, torch.bfloat16)
    t0 = time.perf_counter()
    ep = build_engine_params(cfg, params, quant, device="cuda")
    torch.cuda.synchronize()
    res["engine_build_s"] = time.perf_counter() - t0
    engine = Engine(cfg, ep, BATCH)
    del ep, params
    reset_counts()
    t0 = time.perf_counter()
    logits = engine.prefill(prompt)
    torch.cuda.synchronize()
    res["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    tok = logits[:, -1].argmax(-1, keepdim=True)
    toks = [tok]
    t0 = time.perf_counter()
    for _ in range(CAL_STEPS):
        logits = engine.decode(toks[-1])
        toks.append(logits[:, -1].argmax(-1, keepdim=True))
    torch.cuda.synchronize()
    res["decode_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / CAL_STEPS
    counts = read_counts()
    reset_counts()
    prod = "K1" if family == "ant" else "K4"
    want = {k: 0 for k in counts}
    want[prod] = 6 * n_layers * CAL_STEPS
    want["K2"] = n_layers * (1 + CAL_STEPS)
    got_l = {k: v["launches"] for k, v in counts.items()}
    res.update(launches=got_l, want_launches=want,
               logits_finite=bool(torch.isfinite(logits).all()),
               tokens_in_range=bool(0 <= int(torch.cat(toks).min())
                                    and int(torch.cat(toks).max())
                                    < c.vocab_size))
    if family == "olive":
        res["ovp_shares"] = ovp_shares(torch, engine, toks[-1], steps=4)
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    res["pass"] = (got_l == want and res["logits_finite"]
                   and res["tokens_in_range"]
                   and not any(v["plain_calls"] for v in counts.values()))
    emit({"phase": "calibrate_serve", **res})
    if not res["pass"]:
        fail(f"calibrate_serve {family}: {res}")
    del engine, model, quant
    torch.cuda.empty_cache()
    return res


def phase_calibrate_serve(torch, gen) -> dict:
    """The port calibrates its own states on the card and serves them
    (the path of the reference's tools/serve_cli.py): OPT-6.7B at full
    width (2 layers under ANT, 1 under OliVe), ``calibrate_on_batches`` on
    one 4 x 128-token batch of random ids (seconds per layer and the
    chosen types per site printed), ``calibrate`` on the card held against
    the CPU on layer 0's q and fc_in weights (their first 256 channels
    under ANT, 128 under OliVe) and q's input; then ``build_engine_params``
    from the port's own tree: an f32 engine without INT8 KV or int8 head
    whose site matmuls in a 4 x 512 prefill must each hold the fake-quant
    model's on the same input (``hold_sites``; its logits against the
    model's are reported by the bf16 engine rule), and the main-path
    engine (bf16, INT8 KV, int8 head,
    max_seq 608) served for a 4 x 512 prefill and 16 greedy steps: decode
    on K1 (ANT) or K4 (OliVe) at every site and K2, no plain version."""
    t0 = time.perf_counter()
    out = {f: calibrate_serve(torch, gen, f) for f in ("ant", "olive")}
    out["seconds"] = time.perf_counter() - t0
    emit({"phase": "calibrate_serve_total", "seconds": out["seconds"]})
    return out


SERVE_LAYERS = 2           # OPT-6.7B width, cut in depth as calibrate_serve
SERVE_PROMPTS = (512, 384, 256, 128)
SERVE_NEW = 32
SERVE_MAX_SEQ = 608
SERVE_MERGES = 300         # byte-level BPE merges learned for the phase
SERVE_WORDS = 6000         # words of the generated corpus (clm_eval's text)


def generated_corpus(seed: int) -> str:
    """A seeded text of SERVE_WORDS words of 1-4 syllables, with
    punctuation and line breaks."""
    import random
    rng = random.Random(seed)
    onsets = ["", "b", "c", "d", "f", "g", "h", "k", "l", "m", "n", "p",
              "r", "s", "t", "v", "w", "st", "tr", "ch", "sh", "th"]
    vowels = ["a", "e", "i", "o", "u", "ea", "ou", "ai"]
    codas = ["", "", "n", "r", "s", "t", "l", "nd", "ng"]
    lexicon = ["".join(rng.choice(onsets) + rng.choice(vowels)
                       + rng.choice(codas)
                       for _ in range(rng.randint(1, 4)))
               for _ in range(800)]
    words = []
    for i in range(SERVE_WORDS):
        w = lexicon[min(int(rng.paretovariate(1.1)) - 1, len(lexicon) - 1)
                    if rng.random() < 0.5 else rng.randrange(len(lexicon))]
        words.append(w.capitalize() if i % 13 == 0 else w)
        if i % 13 == 12:
            words[-1] += rng.choice([".", ",", ";", "!", "?"])
        if i % 97 == 96:
            words[-1] += "\n"
    return " ".join(words)


def train_bpe(text: str, n_merges: int):
    """GPT-2 byte-level BPE learned on ``text``: the 256 byte symbols, then
    the most frequent adjacent pair within a pre-token merged, n_merges
    times. Returns (vocab {symbol: id}, merges [(a, b)])."""
    import collections
    from ant_quantization_tpu_torch.harness.bpe import (bytes_to_unicode,
                                                        pretokenize)
    enc = bytes_to_unicode()
    freq = collections.Counter("".join(enc[b] for b in w.encode("utf-8"))
                               for w in pretokenize(text))
    seqs = {w: list(w) for w in freq}
    vocab = {ch: i for i, ch in enumerate(enc.values())}
    merges = []
    for _ in range(n_merges):
        pairs = collections.Counter()
        for w, n in freq.items():
            s = seqs[w]
            for a, b in zip(s, s[1:]):
                pairs[a, b] += n
        if not pairs:
            break
        (a, b), _ = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        merges.append((a, b))
        vocab.setdefault(a + b, len(vocab))
        for w, s in seqs.items():
            out, i = [], 0
            while i < len(s):
                if i + 1 < len(s) and s[i] == a and s[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(s[i])
                    i += 1
            seqs[w] = out
    vocab["<|endoftext|>"] = len(vocab)
    return vocab, merges


def write_opt_hf_dir(torch, path: str, n_layers: int, seed: int) -> dict:
    """A local HF-format OPT-6.7B directory cut to ``n_layers``:
    config.json, fp16 weights from a seeded generator on the card (every
    kernel and embedding normal with std 1/sqrt(K), LayerNorm scales near
    1, biases and shifts near 0) written by the port's safetensors writer
    in two shards, and a byte-level BPE vocab.json and merges.txt learned
    on the phase's corpus. Returns its sizes."""
    from ant_quantization_tpu_torch.harness.safetensors_io import (
        write_safetensors)
    from ant_quantization_tpu_torch.models.transformer_lm import opt_config
    c = opt_config("6.7b")
    config = {"model_type": "opt", "architectures": ["OPTForCausalLM"],
              "vocab_size": c.vocab_size, "hidden_size": c.d_model,
              "num_hidden_layers": n_layers,
              "num_attention_heads": c.n_heads, "ffn_dim": c.d_ff,
              "max_position_embeddings": c.max_seq,
              "word_embed_proj_dim": c.d_model, "do_layer_norm_before": True,
              "activation_function": "relu", "torch_dtype": "float16"}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def normal(shape, std, mean=0.0):
        return (torch.randn(shape, device="cuda", generator=g) * std
                + mean).to(torch.float16)

    d, ff = c.d_model, c.d_ff
    pre = "model.decoder"
    shards = [{f"{pre}.embed_tokens.weight":
               normal((c.vocab_size, d), d ** -0.5),
               f"{pre}.embed_positions.weight":
               normal((c.max_seq + 2, d), d ** -0.5)}, {}]
    for i in range(n_layers):
        sd = shards[0 if i < n_layers // 2 else 1]
        b = f"{pre}.layers.{i}"
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            sd[f"{b}.{ln}.weight"] = normal((d,), 0.05, 1.0)
            sd[f"{b}.{ln}.bias"] = normal((d,), 0.05)
        for name, (k, n) in (("self_attn.q_proj", (d, d)),
                             ("self_attn.k_proj", (d, d)),
                             ("self_attn.v_proj", (d, d)),
                             ("self_attn.out_proj", (d, d)),
                             ("fc1", (d, ff)), ("fc2", (ff, d))):
            sd[f"{b}.{name}.weight"] = normal((n, k), k ** -0.5)
            sd[f"{b}.{name}.bias"] = normal((n,), 0.02)
    shards[1][f"{pre}.final_layer_norm.weight"] = normal((d,), 0.05, 1.0)
    shards[1][f"{pre}.final_layer_norm.bias"] = normal((d,), 0.05)
    n_bytes = 0
    for i, sd in enumerate(shards):
        write_safetensors(
            os.path.join(path, f"model-0000{i + 1}-of-00002.safetensors"),
            sd, {"format": "pt"})
        n_bytes += sum(t.numel() * t.element_size() for t in sd.values())
    text = generated_corpus(seed)
    vocab, merges = train_bpe(text, SERVE_MERGES)
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n"
                + "\n".join(f"{a} {b}" for a, b in merges) + "\n")
    with open(os.path.join(path, "corpus.txt"), "w", encoding="utf-8") as f:
        f.write(text)
    return {"weight_bytes": n_bytes, "vocab": len(vocab),
            "merges": len(merges), "corpus_chars": len(text)}


class StageClock:
    """Wraps functions so that each call is timed between two
    ``torch.cuda.synchronize()`` and its result kept, by stage name."""

    def __init__(self, torch):
        self.torch = torch
        self.seconds: dict = {}
        self.results: dict = {}

    def wrap(self, stage: str, fn):
        def timed(*args, **kwargs):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.torch.cuda.synchronize()
            self.seconds[stage] = (self.seconds.get(stage, 0.0)
                                   + time.perf_counter() - t0)
            self.results[stage] = out
            return out
        return timed

    def patch(self, stages):
        """A context manager patching each (stage, module, name)."""
        import contextlib
        stack = contextlib.ExitStack()
        for stage, module, name in stages:
            stack.enter_context(mock.patch.object(
                module, name, self.wrap(stage, getattr(module, name))))
        return stack


def run_cli(main_fn, argv) -> str:
    """A CLI's ``main(argv)`` in process; its standard output."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main_fn(argv)
    return buf.getvalue()


def phase_serve_cli(torch, gen, smi: str, n_layers: int = SERVE_LAYERS
                    ) -> dict:
    """The LM command lines on the card, in process, as a user runs them:
    a local HF OPT-6.7B directory at full width and ``n_layers`` layers
    (``write_opt_hf_dir``), then ``tools.serve_cli.main`` with the CLI's
    defaults (OliVe "ant-int-flint" W4A4, "w4", INT8 KV) plus
    ``--lm_head_int8``: 4 prompts of 512/384/256/128 ids, 32 new tokens,
    4 slots, max_seq 608, ``--save_engine``; again with
    ``--load_engine`` on the same prompts (every count set to 0 just
    before it): the tokens must be identical, the restored engine equal
    leaf for leaf to the built one (on the card), the packed w4 bytes
    below 0.66 of the int8 bytes, decode on K4 at every site and K2 for
    attention with no plain version; then ``tools.clm_eval.main`` on the
    same directory and a generated text tokenized by the port's BPE
    (block 512, batch 4, 4 blocks), whose perplexity must be finite.
    Prints each stage's seconds, the serve tokens/s, the w4 bytes, peak
    memory and the perplexity beside the card."""
    import tempfile
    from ant_quantization_tpu_torch.harness import zoo
    from ant_quantization_tpu_torch.serve import engine as eng
    from ant_quantization_tpu_torch.tools import clm_eval, serve_cli
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    res = {"layers": n_layers, "prompts": list(SERVE_PROMPTS),
           "new_tokens": SERVE_NEW, "max_seq": SERVE_MAX_SEQ}
    with tempfile.TemporaryDirectory(prefix="serve_cli_") as tmp:
        model_dir = os.path.join(tmp, "opt-6.7b")
        engine_dir = os.path.join(tmp, "engine")
        os.makedirs(model_dir)
        t0 = time.perf_counter()
        res["model_dir"] = write_opt_hf_dir(torch, model_dir, n_layers,
                                            seed=12)
        res["write_s"] = time.perf_counter() - t0
        vocab = res["model_dir"]["vocab"]
        prompts = ";".join(",".join(str(int(t)) for t in torch.randint(
            0, vocab, (n,), device="cuda", generator=gen).tolist())
            for n in SERVE_PROMPTS)
        argv = ["--model", model_dir, "--prompt-ids", prompts,
                "--max_new_tokens", str(SERVE_NEW), "--slots", "4",
                "--max_seq", str(SERVE_MAX_SEQ), "--lm_head_int8"]
        clock = StageClock(torch)
        with clock.patch([("import", zoo, "get_lm"),
                          ("calibrate", serve_cli, "calibrate_on_batches"),
                          ("build", eng, "build_engine_params"),
                          ("pack_and_save", serve_cli, "save_engine")]):
            out_save = run_cli(serve_cli.main,
                               argv + ["--save_engine", engine_dir])
        built = clock.results["build"]
        with open(os.path.join(engine_dir, "engine.json")) as f:
            meta = json.load(f)
        reset_counts()
        with clock.patch([("load_and_unpack", serve_cli, "load_engine")]):
            out_load = run_cli(serve_cli.main,
                               argv + ["--load_engine", engine_dir])
        counts = read_counts()
        reset_counts()
        _, loaded = clock.results["load_and_unpack"]
        lines = {k: [json.loads(l) for l in o.splitlines()]
                 for k, o in (("save", out_save), ("load", out_load))}
        toks = {k: [l["tokens"] for l in v[:-1]] for k, v in lines.items()}
        flat_b, flat_l = (dict(eng._flatten(t)) for t in (built, loaded))
        same = (set(flat_b) == set(flat_l) and all(
            flat_l[p].device == v.device and flat_l[p].dtype == v.dtype
            and torch.equal(flat_l[p], v) for p, v in flat_b.items()))
        w4_stacks = [p for p in flat_b if p[-1] == "w_i8"]
        ticks = SERVE_NEW - 1
        sites = 6 * n_layers
        want = {k: 0 for k in counts}
        want["K4"] = sites * ticks
        want["K2"] = n_layers * (ticks + len(SERVE_PROMPTS))
        got = {k: v["launches"] for k, v in counts.items()}
        res.update(
            seconds={"write": res.pop("write_s"), **clock.seconds},
            serve={k: v[-1] for k, v in lines.items()},
            tokens_identical=toks["save"] == toks["load"]
            and len(toks["save"]) == len(SERVE_PROMPTS)
            and all(len(t) == SERVE_NEW for t in toks["save"]),
            restored_equal=same, w4_stacks=len(w4_stacks),
            w4_bytes_i8=meta["w4_bytes_i8"],
            w4_bytes_packed=meta["w4_bytes_packed"],
            w4_packed_share=meta["w4_bytes_packed"] / meta["w4_bytes_i8"],
            launches=got, want_launches=want,
            plain_calls={k: v["plain_calls"] for k, v in counts.items()})
        del built, loaded, flat_b, flat_l
        clock = StageClock(torch)
        with clock.patch([("import", zoo, "get_lm"),
                          ("calibrate", clm_eval, "calibrate_on_batches"),
                          ("perplexity", clm_eval, "lm_perplexity")]):
            out_eval = run_cli(clm_eval.main, [
                "--model", model_dir, "--dataset",
                os.path.join(model_dir, "corpus.txt"), "--block_size", "512",
                "--batch_size", "4", "--max_blocks", "4"])
        ppl = json.loads(out_eval)
        res["clm_eval"] = {"seconds": clock.seconds, **ppl}
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    res["phase_s"] = time.perf_counter() - t_phase
    res["pass"] = bool(
        res["tokens_identical"] and res["restored_equal"]
        and res["w4_stacks"] == 6
        and res["w4_packed_share"] < 0.66 and got == want
        and not any(res["plain_calls"].values())
        and math.isfinite(ppl["perplexity"]))
    emit({"phase": "serve_cli", **res})
    emit({"phase": "serve_cli_perplexity", "perplexity": ppl["perplexity"],
          "eval_loss": ppl["eval_loss"], "card": smi})
    if not res["pass"]:
        fail(f"serve_cli: {res}")
    torch.cuda.empty_cache()
    return res


# The measurement command lines, on the main path's card after its
# profile: lm_bench at OPT-6.7B (decode with the bf16 baseline, and the
# prefill mode) and BLOOM-7b1 (decode, no baseline), at full depth;
# spec_bench at the serving depth with a 2-layer draft; profiling's trace
# and StepTimer on the main-path engine
BENCH_OPT_DECODE, BENCH_BLOOM_DECODE = 16, 8
BENCH_SPEC_DRAFT, BENCH_SPEC_ROUNDS = 2, 8
BENCH_TRACE_STEPS, BENCH_TIMER_STEPS = 2, 8
BENCH_REGION = "bench_clis_decode"
# lm_bench decides whether the bf16 baseline fits by its own estimate of
# the engine's peak memory (``bf16_bytes``): an upper bound on the peak
# the card measures, and at most this many times that peak, so that its
# margin stays honest
BENCH_BF16_EST_SLACK = 1.15


def json_numbers(obj) -> list:
    """Every number in a JSON tree."""
    if isinstance(obj, bool):
        return []
    if isinstance(obj, (int, float)):
        return [obj]
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, list):
        return [x for v in obj for x in json_numbers(v)]
    return []


def spec_formula(t_plain, t_verify, t_draft, k, batch) -> tuple:
    """spec_bench's model, written out here: tokens/s at accept rates
    0-1 and the break-even rate, rounded as its JSON line prints them."""
    rc = k * t_draft + t_verify
    return ({f"a={a:.1f}": round(batch * (1 + a * k) / rc, 1)
             for a in (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)},
            round(max(0.0, (rc / t_plain - 1) / k), 3))


def phase_bench_clis(torch, engine, ids, main_res: dict, profile: dict,
                     smi: str) -> None:
    """The port's measurement command lines on the card, each through its
    ``main(argv)`` with every count set to 0 around it, its JSON line
    emitted beside its seconds, launches and peak memory:
    - ``lm_bench --family opt-6.7b --decode 16`` (32 layers, the bf16
      baseline): K1 at M = 4 (6 per layer and step) and K2, ms_per_step
      at least the ANT profile's decode device time per step and at most
      twice main_path's decode ms/step; the bf16 run's peak memory at
      most lm_bench's own estimate (``bf16_bytes``), and the estimate at
      most BENCH_BF16_EST_SLACK times the peak;
    - ``lm_bench --family opt-6.7b --mode prefill``: K2 at T = 512 once
      per layer and prefill, no K1 or K5 (the "w4" prefill's torch route,
      ``stacked_prefill`` off), ms_per_prefill at least the ANT prefill
      profile's device time, both MFU shares in (0, 100], bf16_layers 32;
    - ``lm_bench --family bloom-7b1 --no-baseline --decode 8`` (30
      layers: ALiBi, fused qkv, embed_ln): K1 4 per layer and step, K2;
    - ``spec_bench`` at DEPTHS["serving"] layers, a BENCH_SPEC_DRAFT-layer
      draft, k 4: K1 at M = 4 and at M = B (k + 1) = 20, K2 at T = 1 and
      k + 1 (counted from each ``generate`` call's rounds); its modeled
      curve and break-even equal ``spec_formula`` on its own unrounded
      times (``spec_model``'s arguments);
    - ``profiling.trace`` with ``annotate`` around BENCH_TRACE_STEPS
      decode steps of the main-path engine: the trace names the region,
      K1's and K2's kernels; a ``StepTimer`` over BENCH_TIMER_STEPS
      fenced steps, whose p50 is at least the profile's device time per
      step.
    Every number finite and no plain version in any run."""
    import glob
    import tempfile
    from ant_quantization_tpu_torch.serve import speculative
    from ant_quantization_tpu_torch.tools import lm_bench, spec_bench
    from ant_quantization_tpu_torch.utils import profiling
    t_phase = time.perf_counter()
    errs, runs = [], {}

    def check(ok, msg):
        if not ok:
            errs.append(msg)

    def cli(name, main_fn, argv, want):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out = run_cli(main_fn, argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        reset_counts()
        line = json.loads(out.splitlines()[-1])
        want = want() if callable(want) else want
        want = {k: want.get(k, 0) for k in counts}
        got = {k: v["launches"] for k, v in counts.items()}
        plain = {k: v["plain_calls"] for k, v in counts.items()}
        runs[name] = {"argv": argv, "json": line, "seconds": seconds,
                      "launches": got, "want_launches": want,
                      "plain_calls": plain,
                      "peak_bytes_over_before":
                          torch.cuda.max_memory_allocated() - before}
        emit({"phase": "bench_clis", "run": name, **runs[name],
              "card": smi})
        check(got == want, f"{name}: launches {got}, want {want}")
        check(not any(plain.values()), f"{name}: plain versions ran")
        check(all(math.isfinite(x) for x in json_numbers(line)),
              f"{name}: a number is not finite")
        return line

    dev_step_ms = profile["decode"]["device_us_per_call"] / 1e3
    opt = lm_bench.FAMILIES["opt-6.7b"]()
    L, S = opt.n_layers, len(lm_bench.site_shapes(opt))
    name = "lm_bench opt-6.7b decode"
    dec = cli(name, lm_bench.main,
              ["--family", "opt-6.7b", "--decode", str(BENCH_OPT_DECODE)],
              {"K1": S * L * 4 * BENCH_OPT_DECODE,
               "K2": L * (1 + 4 * BENCH_OPT_DECODE)})
    seq = PREFILL + BENCH_OPT_DECODE + 32
    bf16_est = lm_bench.bf16_bytes(opt, BATCH, PREFILL, seq)
    runs[name]["bf16_bytes_estimate"] = bf16_est
    check(dev_step_ms <= dec["ms_per_step"]
          <= 2 * main_res["decode_ms_per_step"],
          f"{name}: ms_per_step {dec['ms_per_step']} outside "
          f"[{dev_step_ms}, 2 x {main_res['decode_ms_per_step']}]")
    check("vs_bf16" in dec and "bf16_note" not in dec,
          f"{name}: the bf16 baseline did not run")
    peak = runs[name]["peak_bytes_over_before"]
    check(peak <= bf16_est <= BENCH_BF16_EST_SLACK * peak,
          f"{name}: the bf16 run's peak {peak} B against lm_bench's "
          f"estimate {bf16_est} B (want peak <= estimate <= "
          f"{BENCH_BF16_EST_SLACK} x peak)")

    name = "lm_bench opt-6.7b prefill"
    pre = cli(name, lm_bench.main, ["--family", "opt-6.7b", "--mode",
                                    "prefill"],
              {"K2": L * 2 * 4 * (1 + 3)})
    dev_prefill_ms = profile["prefill"]["device_us_per_call"] / 1e3
    check(pre["ms_per_prefill"] >= dev_prefill_ms,
          f"{name}: ms_per_prefill {pre['ms_per_prefill']} below the "
          f"profile's device time {dev_prefill_ms}")
    check(all(0 < pre.get(k, 0) <= 100
              for k in ("int8_mfu_pct", "bf16_mfu_pct")),
          f"{name}: an MFU share outside (0, 100]")
    check(pre.get("bf16_layers") == L, f"{name}: bf16_layers "
          f"{pre.get('bf16_layers')}, want {L}")

    bloom = lm_bench.FAMILIES["bloom-7b1"]()
    Lb, Sb = bloom.n_layers, len(lm_bench.site_shapes(bloom))
    cli("lm_bench bloom-7b1 decode", lm_bench.main,
        ["--family", "bloom-7b1", "--no-baseline", "--decode",
         str(BENCH_BLOOM_DECODE)],
        {"K1": Sb * Lb * 4 * BENCH_BLOOM_DECODE,
         "K2": Lb * (1 + 4 * BENCH_BLOOM_DECODE)})

    Lt, Ld, k, reps = DEPTHS["serving"], BENCH_SPEC_DRAFT, 4, 48
    calls, model_args = [], []
    generate, spec_model = (speculative.SpeculativeDecoder.generate,
                            spec_bench.spec_model)

    def recorded_generate(self, prompt_ids, *a, **kw):
        out = generate(self, prompt_ids, *a, **kw)
        calls.append((tuple(prompt_ids.shape), len(self.accepted_hist)))
        return out

    def recorded_model(*a):
        out = spec_model(*a)
        model_args.append(a)
        return out

    def spec_want():
        # the three fenced step loops (a 512-token prefill, then twice
        # `reps` forwards at T = 1, k + 1 and 1), then each generate: its
        # prompt (decode-size at 8 tokens) and R rounds of k + 1 draft
        # steps and one verify
        k1, k2 = 6 * 2 * reps * (2 * Lt + Ld), (1 + 2 * reps) * (2 * Lt + Ld)
        for (b, t), r in calls:
            k1 += 6 * (Lt + Ld) * (b * t <= 64) + 6 * (Lt + Ld * (k + 1)) * r
            k2 += Lt * (1 + r) + Ld * (1 + (k + 1) * r)
        return {"K1": k1, "K2": k2}

    with mock.patch.object(speculative.SpeculativeDecoder, "generate",
                           recorded_generate), \
            mock.patch.object(spec_bench, "spec_model", recorded_model):
        spec = cli("spec_bench", spec_bench.main,
                   ["--layers", str(Lt), "--draft-layers", str(Ld),
                    "--k", str(k), "--rounds", str(BENCH_SPEC_ROUNDS)],
                   spec_want)
    (tp, tv, td, kk, b), = model_args
    model, be = spec_formula(tp, tv, td, kk, b)
    check(spec["modeled_spec_tok_s"] == model
          and spec["break_even_accept"] == be
          and [spec[f"t_{n}_ms"] for n in ("plain", "verify", "draft")]
          == [round(t * 1e3, 2) for t in (tp, tv, td)],
          f"spec_bench: its model {spec['modeled_spec_tok_s']}, "
          f"{spec['break_even_accept']}; the formula on its times "
          f"{model}, {be}")

    Lm = engine.cfg.lm.n_layers
    engine.prefill(ids)
    tok = ids[:, -1:]
    torch.cuda.synchronize()
    reset_counts()
    with tempfile.TemporaryDirectory(prefix="trace_") as tdir:
        t0 = time.perf_counter()
        with profiling.trace(tdir):
            with profiling.annotate(BENCH_REGION):
                for _ in range(BENCH_TRACE_STEPS):
                    tok = engine.decode(tok)[:, -1].argmax(-1, keepdim=True)
        trace_s = time.perf_counter() - t0
        files = glob.glob(os.path.join(tdir, "*.pt.trace.json"))
        text = "".join(open(f).read() for f in files)
    names = {n: n in text for n in (BENCH_REGION, "i8_stream_kernel",
                                    "split_kernel", "combine_kernel")}
    timer = profiling.StepTimer()
    for _ in range(BENCH_TIMER_STEPS):
        with timer.step():
            logits = engine.decode(tok)
        timer.fence(logits)
        tok = logits[:, -1].argmax(-1, keepdim=True)
    summary = timer.summary()
    counts = read_counts()
    reset_counts()
    steps = BENCH_TRACE_STEPS + BENCH_TIMER_STEPS
    want = {k: 0 for k in counts}
    want.update(K1=6 * Lm * steps, K2=Lm * steps)
    got = {k: v["launches"] for k, v in counts.items()}
    runs["profiling"] = {
        "trace_files": len(files), "trace_bytes": len(text),
        "trace_s": trace_s, "trace_names": names,
        "step_timer": summary, "launches": got, "want_launches": want,
        "device_ms_per_step_profile": dev_step_ms}
    check(len(files) == 1 and all(names.values()),
          f"profiling: trace files {len(files)}, names {names}")
    check(summary.get("steps") == BENCH_TIMER_STEPS - 1
          and summary["p50_s"] * 1e3 >= dev_step_ms,
          f"profiling: StepTimer {summary} against {dev_step_ms} ms")
    check(got == want and not any(v["plain_calls"]
                                  for v in counts.values()),
          f"profiling: launches {got}, want {want}")
    res = {"phase": "bench_clis_summary", "card": smi,
           "phase_s": time.perf_counter() - t_phase,
           "profiling": runs["profiling"],
           "spec_bench_generate_calls": calls,
           "checked_against": {
               "profile_decode_device_ms_per_step": dev_step_ms,
               "profile_prefill_device_ms": dev_prefill_ms,
               "main_path_decode_ms_per_step":
                   main_res["decode_ms_per_step"],
               "bf16_bytes_estimate": bf16_est,
               "bf16_peak_bytes_over_before":
                   runs["lm_bench opt-6.7b decode"]
                   ["peak_bytes_over_before"]},
           "errors": errs, "pass": not errs}
    emit(res)
    if errs:
        fail(f"bench_clis: {errs}")
    torch.cuda.empty_cache()


# The accelerator performance model (perfmodel/) through its command
# lines, its tiling search on the card. The full table at batch 64 is held
# to the reference's: the SHA-256 of the CSV that the reference's
# tools/simulate.py writes (its native optimizer, csrc/tileopt.cc) and its
# exact cycle geomeans, both checked against the reference on the CPU in
# tests/test_torch_perfmodel_tools.py
PM_BATCH = 64
PM_TABLE_SHA256 = \
    "6a6e644fbe0cf1f908b8a70a1c006922fb9f0a7065fe8840e3dc0e014979d489"
PM_TABLE_GEOMEANS = {
    "ant_os": 0.24389428525609602, "ant_ws": 0.2455051480977606,
    "bitfusion": 0.689608472972763, "olaccel": 0.8047580258300638,
    "adafloat": 1.0, "biscaled": 0.37742345539261735}
# Figure 13's cycle geomeans, as tests/test_perfmodel_results.py:174 holds
# them: over the 8 nets, BiScaled over vgg16 and resnet50
PM_FIG13 = {"ant_os": 0.25, "ant_ws": 0.25, "bitfusion": 0.70,
            "olaccel": 0.81, "adafloat": 1.00}
PM_FIG13_BISCALED, PM_FIG13_TOL = 0.37, 0.011
# arch_sweep's arguments and what the reference's tools/arch_sweep.py
# prints for them
PM_ARCH = {
    ("--variable-precision", "--nets", "vgg16"):
        "variable-precision speedup: 3.87x (area overhead 1.03x)\n"
        "  variable: 62964034 cycles, 10.47 mm^2\n"
        "  fixed   : 243658636 cycles, 10.18 mm^2\n",
    ("--nets", "vgg16", "--sram-kb", "64", "128"):
        "2 configurations within 3.5 mm^2; top 2 by cycles:\n"
        "   array   act/wgt/out KB    area   Mcycles  energy uJ\n"
        "  8x8       64/64/64       2.83    983.92   665871.0\n"
        "  8x8       64/128/64       3.50    983.92   720275.3\n",
}


def fig13_geomeans(rows) -> dict:
    """Geometric means of the normalized cycles, by accelerator."""
    def geomean(accel, nets):
        vals = [float(r["norm_cycles"]) for r in rows
                if r["accel"] == accel and r["network"] in nets]
        return math.exp(sum(math.log(v) for v in vals) / len(vals))
    nets = {r["network"] for r in rows}
    out = {a: geomean(a, nets) for a in PM_FIG13}
    out["biscaled"] = geomean("biscaled", {"vgg16", "resnet50"})
    return out


def phase_perfmodel(torch, smi: str) -> dict:
    """The performance model's command lines on the card, counts set to 0
    around them:
    - the full 48-row ``simulate --batch 64``: its CSV's SHA-256 is
      PM_TABLE_SHA256 and its cycle geomeans are PM_TABLE_GEOMEANS
      exactly, and within PM_FIG13_TOL of Figure 13's;
    - ``arch_sweep`` with each argument list of PM_ARCH: it prints what
      the reference prints;
    - the card's peak memory grows during each run (the search ran on
      it); K1-K9 launch 0 times and no plain version runs."""
    import csv
    import hashlib
    import io
    import tempfile
    from ant_quantization_tpu_torch.tools import arch_sweep, simulate
    t_phase = time.perf_counter()
    errs, runs = [], {}

    def check(ok, msg):
        if not ok:
            errs.append(msg)

    reset_counts()

    def run(name, main_fn, argv):
        """One CLI run on the card: its output."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = run_cli(main_fn, list(argv))
        torch.cuda.synchronize()
        growth = torch.cuda.max_memory_allocated() - base
        runs[name] = {"argv": list(argv),
                      "seconds": time.perf_counter() - t0,
                      "peak_bytes_over_before": growth}
        check(growth > 0, f"{name}: the card's peak grew by {growth} B")
        return out

    with tempfile.TemporaryDirectory(prefix="perfmodel_") as tdir:
        path = os.path.join(tdir, "ant_res.csv")
        full_out = run("simulate", simulate.main,
                       ["--batch", str(PM_BATCH), "--out", path])
        with open(path, "rb") as f:
            full_csv = f.read()
    digest = hashlib.sha256(full_csv).hexdigest()
    rows = list(csv.DictReader(io.StringIO(full_csv.decode())))
    geo = fig13_geomeans(rows)
    check(len(rows) == 48 and digest == PM_TABLE_SHA256
          and geo == PM_TABLE_GEOMEANS,
          f"simulate: {len(rows)} rows, SHA-256 {digest}, geomeans {geo}; "
          f"want 48 rows, {PM_TABLE_SHA256}, {PM_TABLE_GEOMEANS}")
    want = {**PM_FIG13, "biscaled": PM_FIG13_BISCALED}
    check(all(abs(geo[k] - v) < PM_FIG13_TOL for k, v in want.items()),
          f"simulate: geomeans {geo}, Figure 13's {want} within "
          f"{PM_FIG13_TOL}")
    arch = {}
    for argv, want_out in PM_ARCH.items():
        tag = " ".join(argv)
        got = run(f"arch_sweep {tag}", arch_sweep.main, argv)
        arch[tag] = got.splitlines()
        check(got == want_out, f"arch_sweep {tag}: {got!r}, the "
              f"reference's {want_out!r}")
    counts = read_counts()
    reset_counts()
    got = {k: (v["launches"], v["plain_calls"]) for k, v in counts.items()}
    check(not any(a or b for a, b in got.values()),
          f"perfmodel: kernel launches or plain calls {got}")
    res = {"phase": "perfmodel", "card": smi, "runs": runs,
           "simulate_summary": full_out.splitlines()[:7],
           "table_sha256": digest, "fig13_geomeans": geo,
           "arch_sweep": arch, "launches": got,
           "phase_s": time.perf_counter() - t_phase,
           "errors": errs, "pass": not errs}
    emit(res)
    if errs:
        fail(f"perfmodel: {errs}")
    return res


# The encoder PTQ path: BERT-base and BART-base at full width and depth,
# through the port's glue_run and squad_run with the flags of
# recipes/olive_glue.toml and olive_squad.toml (read by the port's
# run_recipe), on generated checkpoints, vocabulary and data
ENC_SEED = 13
ENC_WORDS = 3000           # WordPiece words taken from the generated corpus
ENC_GLUE_ROWS = {"train": 128, "dev": 512}   # one calibration batch, 4 eval
# layers of the encoder runs cut for the qat phase (full width; PERF.md
# section 4): BART-base encoder and decoder each, BERT-base under SQuAD
ENC_CUT_LAYERS = {"bart": 2, "squad": 4}
ENC_SQUAD_EXAMPLES = 32    # 2-3 features each at max_seq 384, stride 128
ENC_HOLD_LAYERS = 2        # the card held to the CPU: BERT-base width
ENC_HOLD_ROWS = 8          # one 8 x 128 batch
# the CPU recalibrates each site's weight on its first ENC_HOLD_CHANNELS
# output channels and its input on the batch's first row (the whole
# 2-layer tree takes the host's cores minutes)
ENC_HOLD_CHANNELS = 32
ENC_FLOAT_RTOL = 1e-4      # --disable_quant logits, of the largest |logit|


def enc_sentences(seed: int) -> list:
    """The generated corpus (``generated_corpus``) cut into sentences of
    at least four words, each on one line."""
    import re
    text = generated_corpus(seed)
    return [" ".join(s.split()) for s in re.split(r"(?<=[.;!?])\s+", text)
            if len(s.split()) >= 4]


def wordpiece_vocab(sentences, n_words: int) -> list:
    """A BERT vocabulary: the special tokens, the punctuation, the
    n_words most frequent lower-cased words, then every letter alone and
    as a "##" continuation (so that every word tokenizes)."""
    import collections
    import re
    counts = collections.Counter(
        w for s in sentences for w in re.findall(r"[a-z]+", s.lower()))
    letters = sorted({ch for w in counts for ch in w})
    toks = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + list(".,;!?")
            + [w for w, _ in counts.most_common(n_words)] + letters
            + ["##" + ch for ch in letters])
    return list(dict.fromkeys(toks))


def glue_rows(task: str, sentences, n: int, rng) -> list:
    """n (text_a, text_b or None, label) rows of ``task``: sentences drawn
    from ``sentences``, labels uniform over the task's (STS-B a score in
    [0, 5])."""
    from ant_quantization_tpu_torch.harness.data import GLUE_TASKS
    info = GLUE_TASKS[task]
    pick = lambda: sentences[int(rng.integers(len(sentences)))]
    labels = info["labels"]
    return [(pick(), pick() if info["cols"][1] is not None else None,
             f"{rng.uniform(0, 5):.3f}" if labels is None
             else labels[int(rng.integers(len(labels)))])
            for _ in range(n)]


def write_glue_tsv(path: str, task: str, rows) -> None:
    """``rows`` as a GLUE TSV in ``task``'s column layout (its header row,
    text_a, text_b and label at the task's columns, a label column of -1
    last, the other columns filled)."""
    from ant_quantization_tpu_torch.harness.data import GLUE_TASKS
    info = GLUE_TASKS[task]
    ca, cb, cl = info["cols"]
    width = max(ca, cb or 0, cl) + 1 if cl >= 0 else max(ca, cb or 0) + 2
    lab = cl if cl >= 0 else width - 1
    lines = (["\t".join(f"column_{i}" for i in range(width))]
             if info["header"] else [])
    for a, b, label in rows:
        row = [f"f{i}" for i in range(width)]
        row[ca], row[lab] = a, label
        if cb is not None:
            row[cb] = b
        lines.append("\t".join(row))
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")


def squad_doc(sentences, n_examples: int, rng, version_2: bool,
              context_sentences: int = 40) -> dict:
    """A SQuAD v1.1 (or v2.0) document: one paragraph of
    ``context_sentences`` sentences per example, its question some words of
    one sentence and a "?", its answer 1-3 words of that sentence (v2.0:
    every third question unanswerable)."""
    data = []
    for i in range(n_examples):
        sents = [sentences[int(rng.integers(len(sentences)))]
                 for _ in range(context_sentences)]
        ctx = " ".join(sents)
        j = int(rng.integers(len(sents)))
        words = sents[j].split()
        k = int(rng.integers(len(words) - 3))
        answer = " ".join(words[k:k + int(rng.integers(1, 4))])
        start = len(" ".join(sents[:j])) + (1 if j else 0)
        start = ctx.index(answer, start)
        impossible = version_2 and i % 3 == 2
        qa = {"id": f"q{i}", "question": " ".join(words[:4]) + "?",
              "answers": [] if impossible else
              [{"text": answer, "answer_start": start}]}
        if version_2:
            qa["is_impossible"] = impossible
        data.append({"title": f"t{i}", "paragraphs": [
            {"context": ctx, "qas": [qa]}]})
    return {"version": "v2.0" if version_2 else "1.1", "data": data}


def hf_encoder_state(torch, family: str, c, head: str, seed: int,
                     device: str = "cpu") -> dict:
    """An HF BERT or BART checkpoint's state dict for config ``c`` and
    ``head`` ("classification" with c.num_labels outputs, or "qa"), as HF
    initializes one: every linear and embedding normal with std 0.02 from
    a seeded generator on ``device``, biases 0, LayerNorms at 1 and 0
    (f32 tensors)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    sd = {}

    def normal(name, shape):
        sd[name] = 0.02 * torch.randn(shape, generator=g, device=device)

    def lin(name, n_in, n_out):
        normal(f"{name}.weight", (n_out, n_in))
        sd[f"{name}.bias"] = torch.zeros(n_out, device=device)

    def ln(name):
        sd[f"{name}.weight"] = torch.ones(c.d_model, device=device)
        sd[f"{name}.bias"] = torch.zeros(c.d_model, device=device)

    d, ff = c.d_model, c.d_ff
    if family == "bert":
        p = "bert.embeddings"
        normal(f"{p}.word_embeddings.weight", (c.vocab_size, d))
        normal(f"{p}.position_embeddings.weight", (c.max_seq, d))
        normal(f"{p}.token_type_embeddings.weight", (c.type_vocab_size, d))
        ln(f"{p}.LayerNorm")
        for i in range(c.n_layers):
            b = f"bert.encoder.layer.{i}"
            for s in ("query", "key", "value"):
                lin(f"{b}.attention.self.{s}", d, d)
            lin(f"{b}.attention.output.dense", d, d)
            ln(f"{b}.attention.output.LayerNorm")
            lin(f"{b}.intermediate.dense", d, ff)
            lin(f"{b}.output.dense", ff, d)
            ln(f"{b}.output.LayerNorm")
        if head == "qa":
            lin("qa_outputs", d, 2)
        else:
            lin("bert.pooler.dense", d, d)
            lin("classifier", d, c.num_labels)
        return sd
    normal("model.shared.weight", (c.vocab_size, d))
    for part, n in (("encoder", c.enc_layers), ("decoder", c.dec_layers)):
        normal(f"model.{part}.embed_positions.weight", (c.max_seq + 2, d))
        ln(f"model.{part}.layernorm_embedding")
        for i in range(n):
            b = f"model.{part}.layers.{i}"
            for a in (("self_attn", "encoder_attn") if part == "decoder"
                      else ("self_attn",)):
                for s in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    lin(f"{b}.{a}.{s}", d, d)
                ln(f"{b}.{a}_layer_norm")
            lin(f"{b}.fc1", d, ff)
            lin(f"{b}.fc2", ff, d)
            ln(f"{b}.final_layer_norm")
    if head == "qa":
        lin("qa_outputs", d, 2)
    else:
        lin("classification_head.dense", d, d)
        lin("classification_head.out_proj", d, c.num_labels)
    return sd


def write_encoder_dir(torch, path: str, family: str, c, head: str,
                      seed: int, vocab=None, device: str = "cpu") -> dict:
    """A local HF-format directory: config.json, ``hf_encoder_state``
    (made on ``device``) in fp16 written by the port's safetensors writer,
    and ``vocab`` as vocab.txt. Returns its sizes."""
    from ant_quantization_tpu_torch.harness.safetensors_io import (
        write_safetensors)
    os.makedirs(path, exist_ok=True)
    sd = hf_encoder_state(torch, family, c, head, seed, device)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": family, "torch_dtype": "float16"}, f)
    write_safetensors(os.path.join(path, "model.safetensors"),
                      {k: v.to(torch.float16) for k, v in sd.items()},
                      {"format": "pt"})
    if vocab:
        with open(os.path.join(path, "vocab.txt"), "w",
                  encoding="utf-8") as f:
            f.write("\n".join(vocab) + "\n")
    return {"tensors": len(sd), "parameters": sum(v.numel()
                                                  for v in sd.values())}


def encoder_ovp_shares(torch, model, args) -> dict:
    """The share of OVP outliers and victims among the codes of every
    OliVe site of the calibrated fake-quant ``model``: its weights, and
    its inputs in one forward of ``args`` (the codes of
    ``ops/fake_quant.py:olive_fake_quant`` before the victims are
    zeroed: an outlier is a code beyond the normal grid, |code| > 32, a
    victim its zeroed partner), by site kind and in total."""
    from ant_quantization_tpu_torch.nn.layers import QuantDense
    from ant_quantization_tpu_torch.ops.fake_quant import expand_alpha
    from ant_quantization_tpu_torch.ops.ovp import (OUTLIER_THRESHOLD,
                                                    victim_mask)
    from ant_quantization_tpu_torch.ops.snap import snap_concat_value_search
    tally = {"weights": {}, "activations": {}}

    def count(kind, name, x, site):
        st, cfg = site.state, site.cfg
        ca = cfg.channel_axis if cfg.per_channel else None
        grid = st.grid.to(x.device)
        xs = x.float() / (expand_alpha(st.alpha, x.ndim, ca, x.device)
                          / grid.max())
        n = 2 ** cfg.bit
        full = torch.cat([grid[:n], st.outliers.to(x.device, grid.dtype)[:n]])
        m = snap_concat_value_search(xs, full).abs() > OUTLIER_THRESHOLD
        v = victim_mask(m, cfg.pair_axis)
        t = tally[kind].setdefault(name.split(".")[-1], [0, 0, 0])
        t[0] += int((m & ~v).sum())
        t[1] += int(v.sum())
        t[2] += m.numel()

    sites = [(n, m) for n, m in model.named_modules()
             if isinstance(m, QuantDense) and m.weight_q.cfg.use_ovp]
    hooks = []
    with torch.no_grad():
        for name, m in sites:
            count("weights", name, m.kernel, m.weight_q)
            hooks.append(m.register_forward_pre_hook(
                lambda mod, a, name=name: count("activations", name, a[0],
                                                mod.input_q)))
        model(*args)
    for h in hooks:
        h.remove()
    out = {}
    for kind, by in tally.items():
        n = sum(t[2] for t in by.values())
        out[kind] = {"outliers": sum(t[0] for t in by.values()) / n,
                     "victims": sum(t[1] for t in by.values()) / n,
                     "values": n,
                     "by_site": {k: {"outliers": t[0] / t[2],
                                     "victims": t[1] / t[2]}
                                 for k, t in by.items()}}
    return out


def recipe_argv(recipe: str, run_name: str, extra) -> list:
    """A recipe run's arguments as the port's run_recipe builds them (the
    command without ``python -m <tool>``), and its tool."""
    from ant_quantization_tpu_torch.tools import run_recipe
    doc = run_recipe.load_recipe(os.path.join(REPO, "recipes", recipe))
    run = next(r for r in doc["run"] if r["name"] == run_name)
    cmd = run_recipe.build_command(run, doc.get("defaults", {}), extra)
    return cmd[3:], cmd[2].rsplit(".", 1)[-1]


def enc_stage(torch, recipe: str, run_name: str, extra, smi: str) -> dict:
    """One encoder run as ``run_recipe`` launches it, in process on the
    card: seconds for import, calibration and eval (the model's forwards
    outside calibration, between two synchronizes), eval sequences/s, the
    printed metrics, peak memory and the OVP shares of the calibrated
    model (weights, and its inputs on the calibration batch); every
    kernel count is 0 around the run (no kernel of the port is on this
    path, as in the reference)."""
    import importlib
    from ant_quantization_tpu_torch.harness import zoo
    argv, tool = recipe_argv(recipe, run_name, extra)
    mod = importlib.import_module(f"ant_quantization_tpu_torch.tools.{tool}")
    torch.cuda.reset_peak_memory_stats()
    seen, ev = {}, {"s": 0.0, "sequences": 0}
    real_get, real_cal = zoo.get_encoder_model, mod.calibrate_on_batches

    def get(*a, **kw):
        out = real_get(*a, **kw)
        model = out[0]
        first = next(m for m in model.modules()
                     if hasattr(m, "calibrating"))

        def pre(m, args):
            torch.cuda.synchronize()
            m.t0 = time.perf_counter()

        def post(m, args, out):
            torch.cuda.synchronize()
            if not first.calibrating:
                ev["s"] += time.perf_counter() - m.t0
                ev["sequences"] += args[0].shape[0]

        seen["hooks"] = [model.register_forward_pre_hook(pre),
                         model.register_forward_hook(post)]
        seen["model"] = model
        return out

    def cal(model, batches, **kw):
        seen["args"] = batches[0]
        return real_cal(model, batches, **kw)

    clock = StageClock(torch)
    reset_counts()
    t0 = time.perf_counter()
    with mock.patch.object(zoo, "get_encoder_model", get), \
            mock.patch.object(mod, "calibrate_on_batches", cal), \
            clock.patch([("import", zoo, "get_encoder_model"),
                         ("calibrate", mod, "calibrate_on_batches")]):
        out = json.loads(run_cli(mod.main, argv))
    total = time.perf_counter() - t0
    counts = read_counts()
    model = seen.pop("model")
    for h in seen.pop("hooks"):
        h.remove()
    shares = encoder_ovp_shares(torch, model, seen.pop("args"))
    c = model.cfg
    res = {"run": run_name, "tool": tool, "argv": argv,
           "layers": getattr(c, "n_layers", None) or
           [getattr(c, "enc_layers", 0), getattr(c, "dec_layers", 0)],
           "d_model": c.d_model, "seconds": {**clock.seconds,
                                             "eval": ev["s"],
                                             "total": total},
           "eval_sequences": ev["sequences"],
           "eval_sequences_per_s": ev["sequences"] / ev["s"],
           "result": out, "max_memory_allocated":
           torch.cuda.max_memory_allocated(), "ovp_shares": shares,
           "launches": {k: v["launches"] for k, v in counts.items()},
           "plain_calls": {k: v["plain_calls"] for k, v in counts.items()},
           "card": smi}
    metrics = [v for k, v in out.items() if isinstance(v, float)]
    res["pass"] = bool(
        metrics and all(math.isfinite(v) for v in metrics)
        and all(shares[k][f] > 0 for k in shares
                for f in ("outliers", "victims"))
        and not any(res["launches"].values())
        and not any(res["plain_calls"].values()))
    emit({"phase": "encoder", **res})
    if not res["pass"]:
        fail(f"encoder run {run_name}: {res}")
    del model
    torch.cuda.empty_cache()
    return res


def enc_hold(torch, bert_dir: str, ids, tt, am) -> dict:
    """The card held to the CPU on BERT-base width at ENC_HOLD_LAYERS
    layers (layers 0-1 of the generated checkpoint), olive_glue's OliVe
    config, one batch: (a) ``calibrate_on_batches`` on the card, every
    site's ``calibrate`` then held against the CPU's on the same data
    (``hold_calibrate_on_cpu``: its weight's first ENC_HOLD_CHANNELS
    channels, its card input's first row; near-ties printed); (b) every
    site's card output, on the card's own input, within K8_RTOL of |qx| @
    |qw| + |bias| of the CPU's fake-quant ``QuantDense`` on the same input
    and states, rows whose activation code moved counted and left out
    (at most CAL_MOVED_MAX of the values); (c) the ``--disable_quant``
    model's logits within ENC_FLOAT_RTOL of the largest |logit|."""
    from ant_quantization_tpu_torch.harness import zoo
    from ant_quantization_tpu_torch.harness.evaluate import (
        calibrate_on_batches)
    from ant_quantization_tpu_torch.models import bert as tb
    from ant_quantization_tpu_torch.nn.config import QuantConfig
    from ant_quantization_tpu_torch.nn.layers import (QuantDense,
                                                      load_quant_tree)
    t_all = time.perf_counter()
    cfg = tb.bert_base_config(n_layers=ENC_HOLD_LAYERS)
    params = tb.import_hf_bert(zoo._load_sd(bert_dir), cfg)
    qcfg = QuantConfig(family="olive", mode="ant-int-flint", w_low=75,
                       w_up=250, a_low=75, a_up=250)
    models = {}
    for dev in ("cuda", "cpu"):
        for q in (qcfg, QuantConfig(enabled=False)):
            m = tb.BertForSequenceClassification(cfg, q, device=dev)
            zoo._load_params(m, params)
            models[dev, q.enabled] = m
    args = {dev: tuple(torch.as_tensor(a, device=dev).long()
                       for a in (ids, tt, am)) for dev in ("cuda", "cpu")}
    card, cpu = models["cuda", True], models["cpu", True]
    sites = [(n, m) for n, m in card.named_modules()
             if isinstance(m, QuantDense)]
    inputs = {}

    def keep(name):
        def hook(mod, a):
            inputs.setdefault(name, a[0].detach())
        return hook

    hooks = [m.register_forward_pre_hook(keep(n)) for n, m in sites]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quant = calibrate_on_batches(card, [args["cuda"]])
    torch.cuda.synchronize()
    res = {"layers": ENC_HOLD_LAYERS, "batch": list(ids.shape),
           "calibration_s": time.perf_counter() - t0}
    for h in hooks:
        h.remove()
    holds = []
    for n, m in sites:
        holds.append(hold_calibrate_on_cpu(
            torch, m.kernel.detach()[:, :ENC_HOLD_CHANNELS], m.weight_q.cfg,
            f"{n}.kernel[:, :{ENC_HOLD_CHANNELS}]"))
        holds.append(hold_calibrate_on_cpu(
            torch, inputs[n][:1].float(), m.input_q.cfg, f"{n} input[:1]"))
    res["calibrate_holds"] = len(holds)
    res["near_ties"] = [t for h in holds for t in h["near_ties"]]
    # (b) each site on the card's own input, against the CPU's fake-quant
    load_quant_tree(cpu, quant)
    cpu_sites = dict(cpu.named_modules())
    stats = {"sites": 0, "values": 0, "moved": 0, "moved_rows": 0,
             "max_err_over_size": 0.0}
    outs = {}
    hooks = [m.register_forward_hook(
        lambda mod, a, y, n=n: outs.__setitem__(n, (a[0].detach(), y)))
        for n, m in sites]
    with torch.no_grad():
        card(*args["cuda"])
        for h in hooks:
            h.remove()
        for n, m in sites:
            x, y = outs[n]
            qd = cpu_sites[n]
            xc = x.cpu().float()
            want = qd(xc)
            qx = qd.input_q(xc, False)
            qw = qd.weight_q(qd.kernel, False)
            size = qx.abs() @ qw.abs() + qd.bias.abs()
            moved = (m.input_q(x.float(), False).cpu() - qx).abs() \
                > 1e-5 * qx.abs().amax()
            rows = moved.any(dim=-1)
            err = ((y.cpu().float() - want).abs() / size)[~rows]
            stats["sites"] += 1
            stats["values"] += xc.numel()
            stats["moved"] += int(moved.sum())
            stats["moved_rows"] += int(rows.sum())
            if err.numel():
                stats["max_err_over_size"] = max(stats["max_err_over_size"],
                                                 float(err.max()))
        res["sites_hold"] = {**stats, "rtol_of_size": K8_RTOL,
                             "moved_share": stats["moved"] / stats["values"],
                             "moved_max": CAL_MOVED_MAX}
        got = models["cuda", False](*args["cuda"]).float().cpu()
        want = models["cpu", False](*args["cpu"]).float()
    top = float(want.abs().max())
    res["float_logits"] = {"max_diff_over_top": float(
        (got - want).abs().max()) / top, "top_logit": top,
        "rtol": ENC_FLOAT_RTOL}
    res["seconds"] = time.perf_counter() - t_all
    res["pass"] = (stats["sites"] == len(sites)
                   and stats["max_err_over_size"] <= K8_RTOL
                   and res["sites_hold"]["moved_share"] <= CAL_MOVED_MAX
                   and res["float_logits"]["max_diff_over_top"]
                   <= ENC_FLOAT_RTOL)
    emit({"phase": "encoder_cpu_hold", **res})
    if not res["pass"]:
        fail(f"encoder card-to-CPU hold: {res}")
    del models, card, cpu
    torch.cuda.empty_cache()
    return res


def phase_encoders(torch, smi: str) -> dict:
    """The encoder PTQ path on the card (BERT-base, BART-base), as a user
    runs it: the port's run_recipe builds each run's arguments from the
    unchanged recipes, and the tool's ``main`` runs in process
    (``enc_stage``):
    1. glue_run on BERT-base at full width and depth (12 layers, d_model
       768, 12 heads, d_ff 3072) with olive_glue.toml's flags (OliVe
       "ant-int-flint" W4A4, bounds 75-250, max_seq 128, batch 128, one
       calibration batch) on a generated HF directory (std-0.02 weights,
       fp16 safetensors), a WordPiece vocab.txt learned from a generated
       corpus, and a generated SST-2-style TSV of 128 train and 512 dev
       rows (the MRPC-style pair run, the same route, was cut for the
       qat phase);
    2. glue_run on BART-base at full width and ENC_CUT_LAYERS["bart"]
       encoder and decoder layers (the preset patched) in synthetic-batch
       mode (no tokenizer on the card can encode BART pairs), the same
       flags;
    3. squad_run on BERT-base at full width and ENC_CUT_LAYERS["squad"]
       layers with olive_squad.toml's flags (max_seq 384, doc_stride 128,
       batch 64) on a generated SQuAD v1.1 JSON of ENC_SQUAD_EXAMPLES
       examples (at least 64 features);
    4. the card held to the CPU (``enc_hold``)."""
    import tempfile
    import numpy as np
    from ant_quantization_tpu_torch.harness import data as D
    from ant_quantization_tpu_torch.harness.tokenization import (
        load_tokenizer)
    from ant_quantization_tpu_torch.models import bart as bart_mod
    from ant_quantization_tpu_torch.models import bert as bert_mod
    bart_cut = functools.partial(
        bart_mod.bart_base_config, enc_layers=ENC_CUT_LAYERS["bart"],
        dec_layers=ENC_CUT_LAYERS["bart"])
    squad_cut = functools.partial(bert_mod.bert_base_config,
                                  n_layers=ENC_CUT_LAYERS["squad"])
    t_phase = time.perf_counter()
    res = {}
    with tempfile.TemporaryDirectory(prefix="encoders_") as tmp:
        t0 = time.perf_counter()
        sents = enc_sentences(ENC_SEED)
        vocab = wordpiece_vocab(sents, ENC_WORDS)
        rng = np.random.default_rng(ENC_SEED)
        dirs = {}
        for name, fam, c, head in (
                ("bert", "bert", bert_mod.bert_base_config(),
                 "classification"),
                ("bert_qa", "bert", squad_cut(), "qa"),
                ("bart", "bart", bart_cut(), "classification")):
            dirs[name] = os.path.join(tmp, name)
            res[f"{name}_dir"] = write_encoder_dir(
                torch, dirs[name], fam, c, head, ENC_SEED,
                vocab if fam == "bert" else None, device="cuda")
        for task in ("sst2",):
            dirs[task] = os.path.join(tmp, task)
            os.makedirs(dirs[task])
            for split, n in ENC_GLUE_ROWS.items():
                fname = D.GLUE_TASKS[task]["dev"] if split == "dev" \
                    else f"{split}.tsv"
                write_glue_tsv(os.path.join(dirs[task], fname), task,
                               glue_rows(task, sents, n, rng))
        squad = os.path.join(tmp, "squad-v1.1.json")
        with open(squad, "w") as f:
            json.dump(squad_doc(sents, ENC_SQUAD_EXAMPLES, rng, False), f)
        res["write_s"] = time.perf_counter() - t0
        res["vocab"] = len(vocab)
        res["bert_sst2"] = enc_stage(
            torch, "olive_glue.toml", "bert_base_sst2",
            ["--data_dir", dirs["sst2"], "--weights", dirs["bert"]], smi)
        with mock.patch.object(bart_mod, "bart_base_config", bart_cut):
            res["bart_sst2"] = enc_stage(torch, "olive_glue.toml",
                                         "bart_base_sst2",
                                         ["--weights", dirs["bart"]], smi)
        with mock.patch.object(bert_mod, "bert_base_config", squad_cut):
            res["bert_squad"] = enc_stage(
                torch, "olive_squad.toml", "bert_base_squad",
                ["--data", squad, "--weights", dirs["bert_qa"]], smi)
        if res["bert_squad"]["eval_sequences"] < 64:
            fail(f"squad_run evaluated {res['bert_squad']['eval_sequences']}"
                 " features, fewer than 64")
        tok = load_tokenizer(dirs["bert"])
        ex = D.load_glue_split(dirs["sst2"], "sst2", "dev")[:ENC_HOLD_ROWS]
        b = D.encode_glue_batch(tok, ex, 128)
        res["hold"] = enc_hold(torch, dirs["bert"], b["input_ids"],
                               b["token_type_ids"], b["attention_mask"])
    res["phase_s"] = time.perf_counter() - t_phase
    emit({"phase": "encoders_total", "seconds": res["phase_s"],
          "write_s": res["write_s"], "card": smi})
    return res


# ---------------------------------------------------------------------------
# QAT and the image path: torchvision-layout checkpoints
# ---------------------------------------------------------------------------

_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}


def _vgg_index(conv_i: int, with_bn: bool) -> int:
    """torchvision vgg16(.features) index of the conv_i-th convolution."""
    from ant_quantization_tpu_torch.models.cnn import _vgg_feature_indices
    return _vgg_feature_indices(with_bn)[conv_i]


def _tv_module(name: str, path: list) -> str:
    """torchvision's module path of the port's module ``path`` (a list of
    names) in image model ``name``."""
    head = path[0]
    if name.startswith("resnet"):
        if head.startswith("layer"):
            stage, block = head[len("layer"):].split("_")
            sub = {"downsample_conv": "downsample.0",
                   "downsample_bn": "downsample.1"}.get(path[1], path[1])
            return f"layer{stage}.{block}.{sub}"
        return head
    if name.startswith("vgg"):
        kind, i = head.rsplit("_", 1) if "_" in head else (head, "")
        if head.startswith("fc"):
            return f"classifier.{(0, 3, 6)[int(head[2:])]}"
        idx = _vgg_index(int(i), name.endswith("_bn"))
        return f"features.{idx + 1 if kind == 'bn' else idx}"
    if name == "alexnet":
        if head.startswith("fc"):
            return f"classifier.{(1, 4, 6)[int(head[2:])]}"
        return f"features.{(0, 3, 6, 8, 10)[int(head.split('_')[1])]}"
    if name.startswith("vit"):
        if head.startswith("encoder_"):
            b = f"encoder.layers.encoder_layer_{head.split('_')[1]}"
            sub = {"attn": "self_attention", "mlp_1": "mlp.0",
                   "mlp_2": "mlp.3"}.get(path[1], path[1])
            return ".".join([b, sub] + path[2:])
        return {"ln": "encoder.ln", "head": "heads.head"}.get(head, head)
    return ".".join(path)                     # inception_v3


def torchvision_state_dict(name: str, state: dict) -> dict:
    """The port's state dict of image model ``name`` under torchvision's
    keys and layouts (the inverse of the port's importers): linear
    kernels back to (out, in), BatchNorm leaves renamed, ViT's fused
    in-projection under ``in_proj_weight``/``in_proj_bias``."""
    out = {}
    for key, v in state.items():
        *path, leaf = key.split(".")
        if not path:                          # ViT's class token / pos
            out[{"pos_embedding": "encoder.pos_embedding"}.get(
                leaf, leaf)] = v
            continue
        mod = _tv_module(name, path)
        if name.startswith("vit") and path[-1] == "in_proj":
            mod = mod.rsplit(".", 1)[0]
            out[f"{mod}.in_proj_{'weight' if leaf == 'kernel' else 'bias'}"
                ] = v.T if leaf == "kernel" else v
            continue
        if leaf == "kernel":
            out[f"{mod}.weight"] = v.T if v.ndim == 2 else v
        else:
            out[f"{mod}.{_BN_LEAF[leaf]}"] = v
    return out


def image_checkpoint(torch, name: str, seed: int, device: str = "cuda",
                     model=None) -> dict:
    """A torchvision-layout state dict for image model ``name`` made from
    ``seed`` on ``device``: every convolution kernel normal with std
    sqrt(2 / fan_out) (torchvision's kaiming_normal_), every linear
    kernel and ViT's embeddings normal with std 0.02, biases 0,
    BatchNorm at scale 1, bias 0, mean 0, var 1 (f32). ``model``: the
    port's model whose shapes it takes (built unquantized when None)."""
    from ant_quantization_tpu_torch.harness import zoo
    from ant_quantization_tpu_torch.nn.config import QuantConfig
    if model is None:
        model = zoo.get_image_model(name, QuantConfig(enabled=False),
                                    device=device)[0]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    state = {}
    for key, v in model.state_dict().items():
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "kernel" and v.ndim == 4:
            std = math.sqrt(2.0 / (v.shape[0] * v.shape[2] * v.shape[3]))
        elif leaf in ("kernel", "pos_embedding"):
            std = 0.02
        else:
            state[key] = (torch.ones_like(v) if leaf in ("scale", "var")
                          else torch.zeros_like(v))
            continue
        state[key] = std * torch.randn(v.shape, generator=g, device=device)
    return torchvision_state_dict(name, state)


QAT_SEED = 17
QAT_STEPS = 2              # steps an epoch of the image QAT runs, 1 epoch
QAT_HOLD_ROWS = {"resnet": 16, "bert": 8}   # the card-vs-CPU batch
QAT_HOLD_SIZE = 224
QAT_HOLD_TOL = 1e-5        # a site's output or weight gradient, of its size
QAT_LOSS_RTOL = 1e-4
QAT_BN_RTOL = 1e-5


def qat_stage(torch, tool: str, argv, smi: str, batch: int) -> dict:
    """One run of an image or GLUE tool, in process on the card: seconds
    for import, calibration (``calibrate_on_batches``) and the whole run,
    each training step timed between two synchronizes (ms per step, the
    median and all, examples/s at the median), the printed JSON, peak
    memory and every kernel count (0: no kernel of the port is on this
    path). ms per step is the median of the steps after the first.
    Fails unless every printed number is finite and the steps' losses
    are."""
    import importlib
    from ant_quantization_tpu_torch.harness import train as T
    from ant_quantization_tpu_torch.harness import zoo
    mod = importlib.import_module(f"ant_quantization_tpu_torch.tools.{tool}")
    torch.cuda.reset_peak_memory_stats()
    steps, losses, seen = [], [], {}

    def timed(make):
        def build(*a, **kw):
            step = make(*a, **kw)

            def run(*sa, **skw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, loss = step(*sa, **skw)
                torch.cuda.synchronize()
                steps.append(time.perf_counter() - t0)
                losses.append(float(loss))
                return state, loss
            return run
        return build

    real_cal = mod.calibrate_on_batches

    def cal(model, batches, **kw):
        seen["model"] = model
        return real_cal(model, batches, **kw)

    clock = StageClock(torch)
    reset_counts()
    t0 = time.perf_counter()
    patches = [mock.patch.object(mod, "calibrate_on_batches", cal)]
    for name in ("make_classification_step", "make_step"):
        patches.append(mock.patch.object(T, name, timed(getattr(T, name))))
    with contextlib.ExitStack() as stack:
        for pt in patches:
            stack.enter_context(pt)
        stack.enter_context(clock.patch(
            [("calibrate", mod, "calibrate_on_batches"),
             ("import", zoo, "get_image_model" if tool != "glue_run"
              else "get_encoder_model")]))
        out = json.loads(run_cli(mod.main, argv))
    total = time.perf_counter() - t0
    counts = read_counts()
    from ant_quantization_tpu_torch.calibrate.promote import (
        promoted_site_paths, quant_sites)
    from ant_quantization_tpu_torch.nn.layers import quant_tree
    tree = quant_tree(seen.pop("model"))
    steady = steps[1:] or steps          # the first step warms cuDNN up
    med = statistics.median(steady) if steady else None
    res = {"tool": tool, "argv": argv, "seconds": {**clock.seconds,
                                                   "total": total},
           "steps": len(steps), "step_ms": [x * 1e3 for x in steps],
           "ms_per_step": med * 1e3 if med else None,
           "examples_per_s": batch / med if med else None,
           "losses": losses, "result": out,
           "sites": len(quant_sites(tree)),
           "promoted": ["/".join(p) for p in promoted_site_paths(tree)],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": {k: v["launches"] for k, v in counts.items()},
           "plain_calls": {k: v["plain_calls"] for k, v in counts.items()},
           "card": smi}
    nums = [v for v in out.values() if isinstance(v, float)]
    res["pass"] = bool(nums and all(math.isfinite(v) for v in nums)
                       and all(math.isfinite(v) for v in losses)
                       and not any(res["launches"].values()))
    return res


def qat_hold(torch, smi: str, bert_dir: str) -> dict:
    """The card held to the CPU on one training forward and backward with
    the same weights, states and batch on both: a 2-block ResNet (layers
    (1, 1), generated torchvision-style weights, ANT W4A4 calibrated on
    the card, QAT_HOLD_ROWS x 224 px, BatchNorm in training mode) and a
    2-layer BERT-base (the generated checkpoint's layers 0-1, ANT bounds
    80-150). Per site, on the card's own tensors: the output within
    QAT_HOLD_TOL of |qx| * |qw| (the convolution or product of
    magnitudes) from the CPU's f32 product of the card's qx and qw; the
    weight gradient within QAT_HOLD_TOL of |qx|^T * |g| from the CPU's f32
    product of the card's qx and output gradient g; the codes that the
    CPU's fake-quant of the card's input moves counted ("moved"), and
    those where the CPU's own forward chain quantized otherwise than the
    card's ("chain_moved"). A quantized network's loss moves about 1%
    when its input moves 2e-6 relative (a 2-layer BERT-base on the CPU):
    an ulp between the CPU and the card moves A4 codes, and moved codes
    spread. So the loss within QAT_LOSS_RTOL, and ResNet's running
    statistics within QAT_BN_RTOL of each tensor's largest value, are
    held against the CPU's forward with each site fed the card's input
    ("forced"); the free-running CPU loss is reported beside the chain's
    moved codes."""
    import numpy as np
    from torch.nn import functional as F
    from ant_quantization_tpu_torch.harness import train as T
    from ant_quantization_tpu_torch.harness import zoo
    from ant_quantization_tpu_torch.harness.data import device_images
    from ant_quantization_tpu_torch.models import bert as tb
    from ant_quantization_tpu_torch.models import resnet as trn
    from ant_quantization_tpu_torch.models.import_hf import lm_state_dict
    from ant_quantization_tpu_torch.nn.config import QuantConfig
    from ant_quantization_tpu_torch.nn.layers import (
        QuantConv, QuantDense, calibrating, conv_padding, load_quant_tree,
        quant_tree)
    t_all = time.perf_counter()
    rng = np.random.default_rng(QAT_SEED)
    res = {"phase": "qat_hold", "tol_of_size": QAT_HOLD_TOL, "card": smi}

    def sites(model):
        return [(n, m) for n, m in model.named_modules()
                if isinstance(m, (QuantConv, QuantDense))]

    def record(model):
        """Forward hooks keeping each site's input, its fake-quants, its
        output and (on the backward) its output gradient."""
        rec = {}

        def hook(name):
            def fwd(m, args, out):
                x = args[0].detach()
                with torch.no_grad():
                    qx = m.input_q(x, False)
                    qw = m.weight_q(m.kernel, False)
                rec[name] = {"m": m, "x": x, "qx": qx, "qw": qw,
                             "y": out.detach()}
                if out.requires_grad:
                    out.register_hook(lambda g: rec[name].__setitem__(
                        "g", g.detach()))
            return fwd

        return rec, [m.register_forward_hook(hook(n))
                     for n, m in sites(model)]

    def moved(a, b) -> int:
        return int(((a - b).abs() > 1e-5 * b.abs().amax()).sum())

    def check_sites(rec, rec_cpu, cpu_model) -> dict:
        cpu_sites = dict(sites(cpu_model))
        st = {"sites": 0, "values": 0, "moved": 0, "chain_moved": 0,
              "max_out_err": 0.0, "max_grad_err": 0.0}
        tiny = torch.finfo(torch.float32).tiny
        for name, r in rec.items():
            m, cm = r["m"], cpu_sites[name]
            x, qx, qw = r["x"].cpu(), r["qx"].cpu(), r["qw"].cpu()
            g = r["g"].cpu().to(torch.float32)
            with torch.no_grad():
                st["moved"] += moved(cm.input_q(x, False), qx)
                st["chain_moved"] += moved(rec_cpu[name]["qx"], qx)
                if isinstance(m, QuantConv):
                    (t, b), (l, rr) = conv_padding(
                        m.padding, x.shape[2:], m.kernel_size, m.strides)
                    xp = F.pad(qx, (l, rr, t, b))
                    axp = F.pad(qx.abs(), (l, rr, t, b))

                    def conv(a, w):
                        return F.conv2d(a, w, None, m.strides, 0, 1,
                                        m.groups)

                    want, size = conv(xp, qw), conv(axp, qw.abs())
                    gw = torch.nn.grad.conv2d_weight(
                        xp, qw.shape, g, m.strides, 0, 1, m.groups)
                    gsize = torch.nn.grad.conv2d_weight(
                        axp, qw.shape, g.abs(), m.strides, 0, 1, m.groups)
                else:
                    x2 = qx.reshape(-1, qx.shape[-1])
                    g2 = g.reshape(-1, g.shape[-1])
                    want = (x2 @ qw).reshape(r["y"].shape)
                    size = (x2.abs() @ qw.abs()).reshape(r["y"].shape)
                    gw, gsize = x2.t() @ g2, x2.abs().t() @ g2.abs()
                if m.bias is not None:
                    b_ = m.bias.detach().cpu()
                    b_ = b_[:, None, None] if isinstance(m, QuantConv) else b_
                    want, size = want + b_, size + b_.abs()
                st["max_out_err"] = max(st["max_out_err"], float(
                    ((r["y"].cpu() - want).abs() / (size + tiny)).max()))
                st["max_grad_err"] = max(st["max_grad_err"], float(
                    ((m.kernel.grad.cpu() - gw).abs() / (gsize + tiny))
                    .max()))
            st["sites"] += 1
            st["values"] += x.numel()
        return st

    def run_both(models, loss_fn):
        """Forward and backward on the card and the CPU, sites recorded;
        then the CPU's forward again from its starting buffers with each
        site fed the card's input ("forced"), which leaves the CPU's
        running statistics those of the forced chain. Returns (card
        record, CPU record, losses by device and "forced")."""
        recs, losses = {}, {}
        start = {k: v.clone() for k, v in models["cpu"].named_buffers()}
        for dev, m in models.items():
            rec, hs = record(m)
            with T.tf32_off():
                loss = loss_fn(m, dev)
                loss.backward()
            for h in hs:
                h.remove()
            recs[dev], losses[dev] = rec, float(loss.detach())
        cpu = models["cpu"]
        with torch.no_grad():
            for k, v in cpu.named_buffers():
                v.copy_(start[k])
        hs = [m.register_forward_pre_hook(
            lambda mod, args, name=name: (recs["cuda"][name]["x"].cpu(),)
            + args[1:]) for name, m in sites(cpu)]
        with torch.no_grad(), T.tf32_off():
            losses["forced"] = float(loss_fn(cpu, "cpu"))
        for h in hs:
            h.remove()
        return recs["cuda"], recs["cpu"], losses

    def rel(a, b) -> float:
        return abs(a - b) / abs(b)

    # -- ResNet, 2 blocks ----------------------------------------------------
    cfg = trn.ResNetConfig("basic", (1, 1))
    qcfg = QuantConfig(mode="ant-int-pot-flint")
    models = {d: trn.ResNet(cfg, qcfg, device=d) for d in ("cuda", "cpu")}
    sd = image_checkpoint(torch, "resnet18", QAT_SEED, "cuda",
                          model=models["cuda"])
    params, stats = trn.import_torchvision_resnet(sd, cfg)
    state = {**lm_state_dict(params), **lm_state_dict(stats)}
    for m in models.values():
        m.load_state_dict(state)
    n = QAT_HOLD_ROWS["resnet"]
    images = rng.normal(size=(n, QAT_HOLD_SIZE, QAT_HOLD_SIZE, 3)).astype(
        np.float32)
    labels = torch.as_tensor(rng.integers(0, 1000, n))
    with torch.no_grad(), calibrating(models["cuda"]):
        models["cuda"](device_images(images, "cuda"))
    load_quant_tree(models["cpu"], quant_tree(models["cuda"]))
    rec, rec_cpu, losses = run_both(models, lambda m, dev: T.cross_entropy(
        m(device_images(images, dev), train=True), labels.to(dev)).mean())
    bn = 0.0
    for (_, a), (_, b) in zip(models["cuda"].named_buffers(),
                              models["cpu"].named_buffers()):
        bn = max(bn, float((a.cpu() - b).abs().max() / b.abs().max()))
    res["resnet"] = {**check_sites(rec, rec_cpu, models["cpu"]),
                     "loss_card": losses["cuda"], "loss_cpu": losses["cpu"],
                     "loss_cpu_forced": losses["forced"],
                     "loss_rel": rel(losses["cuda"], losses["forced"]),
                     "loss_rel_free": rel(losses["cuda"], losses["cpu"]),
                     "bn_rel_of_max": bn}
    del models, rec, rec_cpu
    torch.cuda.empty_cache()

    # -- BERT-base width, 2 layers -------------------------------------------
    bcfg = tb.bert_base_config(n_layers=2)
    bparams = tb.import_hf_bert(zoo._load_sd(bert_dir), bcfg)
    bq = QuantConfig(mode="ant-int-pot-flint", w_low=80, w_up=150, a_low=80,
                     a_up=150)
    bm = {}
    for dev in ("cuda", "cpu"):
        bm[dev] = tb.BertForSequenceClassification(bcfg, bq, device=dev)
        zoo._load_params(bm[dev], bparams)
    n = QAT_HOLD_ROWS["bert"]
    ids = torch.as_tensor(rng.integers(0, bcfg.vocab_size, (n, 128)))
    labels = torch.as_tensor(rng.integers(0, 2, n))
    with torch.no_grad(), calibrating(bm["cuda"]):
        bm["cuda"](ids.to("cuda"))
    load_quant_tree(bm["cpu"], quant_tree(bm["cuda"]))

    def bert_loss(m, dev):
        return T.cross_entropy(m(ids.to(dev)), labels.to(dev)).mean()

    rec, rec_cpu, losses = run_both(bm, bert_loss)
    res["bert"] = {**check_sites(rec, rec_cpu, bm["cpu"]),
                   "loss_card": losses["cuda"], "loss_cpu": losses["cpu"],
                   "loss_cpu_forced": losses["forced"],
                   "loss_rel": rel(losses["cuda"], losses["forced"]),
                   "loss_rel_free": rel(losses["cuda"], losses["cpu"])}
    res["seconds"] = time.perf_counter() - t_all
    res["pass"] = all(
        r["max_out_err"] <= QAT_HOLD_TOL and r["max_grad_err"] <= QAT_HOLD_TOL
        and r["loss_rel"] <= QAT_LOSS_RTOL for r in (res["resnet"],
                                                     res["bert"])) and \
        res["resnet"]["bn_rel_of_max"] <= QAT_BN_RTOL
    emit(res)
    if not res["pass"]:
        fail(f"qat_hold: the card off the CPU: {res}")
    del bm, rec, rec_cpu
    torch.cuda.empty_cache()
    return res


def phase_qat(torch, smi: str) -> dict:
    """QAT and the image path on the card, as a user runs them: each run's
    arguments built by the port's run_recipe from the unchanged recipes,
    the tool's ``main`` in process (``qat_stage``), on generated weights
    (BERT-base: the encoders phase's directory and SST-2 TSVs, written
    again by the same writers from ENC_SEED; the image models:
    torchvision-layout state dicts from QAT_SEED, ``image_checkpoint``)
    and generated or synthetic data:
    1. glue_run --train, ant_bert_glue.toml sst2_IP-F: BERT-base at full
       width and depth on generated SST-2 TSVs (128 train rows: 2 steps
       of 64 an epoch, 2 epochs, dev each epoch);
    2. imagenet_qat, ant_imagenet_qat.toml resnet18_ANT4-8 (batch 256,
       layers8 "0,20": promotion on the card) and vit_IP-F (ViT-B/16,
       batch 56), synthetic data, QAT_STEPS steps, 1 epoch;
    3. imagenet_eval (PTQ): ant_imagenet_ptq6.toml resnet50_ptq6,
       vgg16_ptq6 and alexnet_ptq6 (W6A6), and Inception-v3 at 299 px
       with inceptionv3_IP-F's W4A4 flags (its 95 sites);
    4. qat_bench at ResNet-18 (batch 64) and BERT-base (16 x 128);
    5. the card held to the CPU (``qat_hold``)."""
    import tempfile
    import numpy as np
    from ant_quantization_tpu_torch.harness import data as D
    from ant_quantization_tpu_torch.harness.safetensors_io import (
        write_safetensors)
    from ant_quantization_tpu_torch.models.bert import bert_base_config
    from ant_quantization_tpu_torch.tools import qat_bench
    t_phase = time.perf_counter()
    res = {}
    with tempfile.TemporaryDirectory(prefix="qat_") as tmp:
        t0 = time.perf_counter()
        sents = enc_sentences(ENC_SEED)
        vocab = wordpiece_vocab(sents, ENC_WORDS)
        bert = os.path.join(tmp, "bert")
        write_encoder_dir(torch, bert, "bert", bert_base_config(),
                          "classification", ENC_SEED, vocab, device="cuda")
        sst2 = os.path.join(tmp, "sst2")
        os.makedirs(sst2)
        rng = np.random.default_rng(ENC_SEED)
        for split, n in ENC_GLUE_ROWS.items():
            fname = D.GLUE_TASKS["sst2"]["dev"] if split == "dev" \
                else f"{split}.tsv"
            write_glue_tsv(os.path.join(sst2, fname), "sst2",
                           glue_rows("sst2", sents, n, rng))
        weights = {}
        for name in ("resnet18", "vit_b_16", "resnet50", "vgg16_bn",
                     "alexnet", "inception_v3"):
            weights[name] = os.path.join(tmp, f"{name}.safetensors")
            write_safetensors(weights[name], image_checkpoint(
                torch, name, QAT_SEED, "cuda"), {"format": "pt"})
            torch.cuda.empty_cache()
        res["write_s"] = time.perf_counter() - t0

        argv, tool = recipe_argv("ant_bert_glue.toml", "sst2_IP-F", [
            "--data_dir", sst2, "--weights", bert])
        res["bert_sst2_qat"] = qat_stage(torch, tool, argv, smi, 64)
        image = ["--train_dir", "synthetic", "--val_dir", "synthetic",
                 "--epochs", "1", "--steps_per_epoch", str(QAT_STEPS),
                 "--ckpt_dir", os.path.join(tmp, "ckpt")]
        for run, model, batch in (("resnet18_ANT4-8", "resnet18", 256),
                                  ("vit_IP-F", "vit_b_16", 56)):
            argv, tool = recipe_argv("ant_imagenet_qat.toml", run, [
                *image, "--weights", weights[model]])
            res[run] = qat_stage(torch, tool, argv, smi, batch)
        for run, model, batch in (("resnet50_ptq6", "resnet50", 128),
                                  ("vgg16_ptq6", "vgg16_bn", 128),
                                  ("alexnet_ptq6", "alexnet", 128)):
            argv, tool = recipe_argv("ant_imagenet_ptq6.toml", run, [
                "--data_dir", "synthetic", "--weights", weights[model]])
            res[run] = qat_stage(torch, tool, argv, smi, batch)
        res["inception_v3_w4a4"] = qat_stage(torch, "imagenet_eval", [
            "--model", "inception_v3", "--data_dir", "synthetic",
            "--batch_size", "64", "--mode", "ant-int-pot-flint", "--wbit",
            "4", "--abit", "4", "--a_low", "50", "--weights",
            weights["inception_v3"]], smi, 64)
        if res["inception_v3_w4a4"]["sites"] != 95:
            fail(f"inception_v3: {res['inception_v3_w4a4']['sites']} "
                 "quantized sites, not 95")
        if res["resnet18_ANT4-8"]["promoted"] != ["conv1", "layer4_1/conv2"]:
            fail(f"resnet18 promotion: {res['resnet18_ANT4-8']['promoted']}")
        for key, r in res.items():
            if isinstance(r, dict) and "pass" in r:
                emit({"phase": "qat_run", "run": key, **r})
                if not r["pass"]:
                    fail(f"qat run {key}: {r}")
        res["qat_bench"] = {}
        for args in (["--model", "resnet18", "--batch", "64"],
                     ["--model", "bert_base", "--batch", "16", "--seq",
                      "128"]):
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(sys.stdout):
                out = json.loads(run_cli(qat_bench.main, args + ["--json"])
                                 .strip().splitlines()[-1])
            out["seconds"] = time.perf_counter() - t0
            res["qat_bench"][args[1]] = out
            emit({"phase": "qat_bench", **out, "card": smi})
        res["hold"] = qat_hold(torch, smi, bert)
    res["phase_s"] = time.perf_counter() - t_phase
    emit({"phase": "qat_total", "seconds": res["phase_s"],
          "write_s": res["write_s"], "card": smi})
    return res


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
    k34_err = phase_checks_ovp(torch, gen)
    k568_err = phase_checks_w4pack(torch, gen)
    k7_err = phase_checks_k7(torch, gen)
    hd_err = phase_checks_headdim(torch, gen)
    k9_err = phase_checks_k9(torch, gen)
    phase_checks_f32_out(torch, gen)
    f5_err = phase_checks_f5(torch, gen)
    pct_rows = phase_checks_percentile(torch, gen)
    cal = phase_calibrate_serve(torch, gen)
    serve = phase_serve_cli(torch, gen, smi)
    enc = phase_encoders(torch, smi)
    qat = phase_qat(torch, smi)
    engine, main_res, ids = phase_main(torch, gen)
    counts = main_res["launches"]
    sites, k2_rows = phase_times(torch, engine)
    profile = phase_profile(torch, engine, ids)
    phase_bench_clis(torch, engine, ids, main_res, profile, smi)
    sp, sp_counts = phase_stacked_prefill(torch, engine, ids,
                                          "stacked_prefill_ant")
    phase_profile(torch, sp, ids, path="ANT stacked_prefill")
    k5_rows = phase_times_k5(torch, engine)
    del engine, sp
    torch.cuda.empty_cache()
    phase_insitu(torch, gen)
    phase_insitu_stacked_prefill(torch, gen)
    olive, olive_ep, olive_counts, olive_ids = phase_olive(
        torch, gen, DEPTHS["olive"])
    ovpw, ovpw_counts = phase_ovp_weights(torch, olive_ep, olive_ids,
                                          DEPTHS["olive"])
    ovp_rows = phase_times_ovp(torch, olive, ovpw)
    k5_ovp_rows = phase_times_k5_ovp(torch, ovpw)
    phase_profile(torch, olive, olive_ids, path="OliVe")
    phase_profile(torch, ovpw, olive_ids, path="OVP weights")
    del olive, olive_ep
    sp, _ = phase_stacked_prefill(torch, ovpw, olive_ids,
                                  "stacked_prefill_ovp_weights")
    phase_profile(torch, sp, olive_ids, path="OVP weights stacked_prefill")
    del ovpw, sp
    torch.cuda.empty_cache()
    phase_insitu_olive(torch, gen)
    w4, w4_counts, w4_ids = phase_w4pack(torch, gen, DEPTHS["w4pack"])
    w4_rows = phase_times_w4pack(torch, w4)
    phase_profile(torch, w4, w4_ids, path="w4pack")
    del w4
    torch.cuda.empty_cache()
    phase_insitu_w4pack(torch, gen)
    bloom, bloom_ep, bloom_ids = phase_bloom_main(torch, gen,
                                                  DEPTHS["bloom"])
    phase_profile(torch, bloom, bloom_ids, path="BLOOM")
    phase_bloom_ragged(torch, bloom, gen)
    del bloom
    torch.cuda.empty_cache()
    long_engine, long_counts, long_ids = phase_bloom_long(
        torch, bloom_ep, gen, DEPTHS["bloom_long"])
    phase_profile(torch, long_engine, long_ids, path="BLOOM long context",
                  prefill=("prefill_last_chunk",
                           lambda: long_chunk(long_engine, long_ids)))
    k7_row = phase_times_k7(torch, long_engine)
    del long_engine, bloom_ep
    torch.cuda.empty_cache()
    k9_rows = phase_times_k9(torch, gen)
    insitu_bloom = phase_insitu_bloom(torch, gen)
    torch.cuda.empty_cache()
    gpt2, gpt2_counts, gpt2_ids = phase_gpt2_main(torch, gen,
                                                  DEPTHS["gpt2"])
    gpt2_k2_rows, kscale_per_layer = phase_times_gpt2(torch, gpt2)
    phase_profile(torch, gpt2, gpt2_ids, path="GPT-2 XL")
    del gpt2
    torch.cuda.empty_cache()
    gpt2o, gpt2o_counts, gpt2o_ids = phase_gpt2_olive(torch, gen)
    phase_profile(torch, gpt2o, gpt2o_ids, path="GPT-2 XL OliVe")
    del gpt2o
    torch.cuda.empty_cache()
    phase_insitu_gpt2(torch, gen)
    k7_3b_row = phase_times_k7_bloom3b(torch, gen)
    hd_times = phase_times_headdim(torch, gen)
    ant_cfg = opt_engine_config(DEPTHS["serving"], torch.bfloat16)
    ant_ep = random_engine_params(torch, ant_cfg, seed=0)
    sched = phase_scheduler(torch, gen, ant_cfg, ant_ep)
    spec = phase_speculative(torch, gen, ant_cfg, ant_ep)
    w4a16 = phase_w4a16(torch, gen, ant_ep)
    del ant_ep
    torch.cuda.empty_cache()
    phase_bf16_baseline(torch, gen)
    perfmodel = phase_perfmodel(torch, smi)
    new_paths = {
        **{f"scheduler run {k} (tpd {r['ticks_per_dispatch']})":
           r["launches"] for k, r in sched["runs"].items()},
        **{f"speculative rounds/call {k}": g["launches"]
           for k, g in spec["generate"].items()},
        "w4a16": {k: v["launches"] for k, v in w4a16["launches"].items()}}

    dec, pre = k2_rows
    kernels = [
        {"name": "stacked_quant_matmul (K1)", "route": "cuda",
         "source": "ant_quantization_tpu_torch/csrc/stacked_i8.cu",
         "design": "redesigned PR 6: staged split-K weight stream, the snap "
                   "fused into each block (csrc/i8_stream.cuh)",
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
         "library_ms": sum(s["library_ms"] for s in sites),
         "launches_serving_paths": {k: v["K1"] for k, v in new_paths.items()}},
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
         "library_ms": dec["library_ms"],
         "prefill": {k: pre[k] for k in ("T", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
         "library_note": "SDPA on the dequantized bf16 cache (causal at "
                         "prefill)",
         "launches_serving_paths": {k: v["K2"] for k, v in new_paths.items()},
         "launches_gpt2": {"gpt2_main": gpt2_counts["K2"]["launches"],
                           "gpt2_olive": gpt2o_counts["K2"]["launches"]},
         "head_dims": [128, 64, 80],
         "max_abs_err_by_head_dim": {128: k2_err, **hd_err["K2"]},
         "head_dim_64": {
             "at": "GPT-2 XL: B=4 H=25 D=64, cache S=608 (gpt2_main's)",
             **{("decode" if r["T"] == 1 else "prefill"): {
                 k: r[k] for k in ("T", "pos0", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}
                for r in gpt2_k2_rows}},
         "head_dim_80": {
             "at": "BLOOM-3b: B=4 H=32 D=80, a random cache S=2048",
             **{("decode" if r["T"] == 1 else "prefill"): {
                 k: r[k] for k in ("T", "pos0", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}
                for r in hd_times["K2"]}}},
    ]
    for tag, fname, src, line, launches in (
            ("K3", "stacked_quant_matmul ovp=True (K3)", "stacked_i8.cu",
             "ant_quantization_tpu/kernels/stacked.py:74",
             ovpw_counts["K3"]["launches"]),
            ("K4", "stacked_quant_matmul_aovp (K4)", "stacked_aovp.cu",
             "ant_quantization_tpu/kernels/stacked.py:322",
             olive_counts["K4"]["launches"])):
        rows = ovp_rows[tag]
        kernels.append({
            "name": fname, "route": "cuda",
            "source": f"ant_quantization_tpu_torch/csrc/{src}",
            "design": "redesigned: one launch on K1's staged split-K "
                      "weight stream, the snap or encode fused into each "
                      "block, the dots on int8 mma.sync, K split only "
                      "between f32 blocks (csrc/ovp_stream.cuh)",
            "replaces": line, "launches": launches,
            "plans": {x["site"]: {"mt": x["mt"], "splits": x["splits"]}
                      for x in rows},
            "k1_ms_same_stream": sum(x["k1_ms"] for x in rows),
            "max_abs_err": k34_err[tag], "pass": True,
            "ms_per_launch": {x["site"]: x["ms"] for x in rows},
            "at": "one decode layer: the 6 site launches at M=4 on OVP "
                  "weights (q, k, v, out 4096x4096; fc_in 4096x16384; "
                  "fc_out 16384x4096)",
            "ms": sum(x["ms"] for x in rows),
            "plain_ms": sum(x["plain_ms"] for x in rows),
            "bound_ms": sum(x["bound_ms"] for x in rows),
            "bound_by": "bytes" if all(x["bound_by"] == "bytes"
                                       for x in rows) else "operations",
            "library_ms": None,
            "int_mm_reference_ms": sum(x["int_mm_ms"] for x in rows),
            "int_mm_note": "torch._int_mm on the same weights and M: one "
                           "int8 dot, not the same function"})
    decode_at = ("one decode layer: the 6 site launches at M=4 (q, k, v, out "
                 "4096x4096; fc_in 4096x16384; fc_out 16384x4096)")
    prefill_at = decode_at.replace("decode", "prefill").replace("M=4",
                                                                "M=2048")
    for tag, fname, src, line, launches, rows, at, lib in (
            ("K5", "stacked_quant_matmul M>256 (K5)", "stacked_prefill.cu",
             "ant_quantization_tpu/kernels/stacked.py:386",
             sp_counts["K5"]["launches"], k5_rows, prefill_at,
             "torch._int_mm on the snapped codes: the product without the "
             "snap; plain_ms is the torch route K5 replaces"),
            ("K6", "stacked_quant_matmul_p4 (K6)", "stacked_p4.cu",
             "ant_quantization_tpu/kernels/stacked.py:136",
             w4_counts["K6"]["launches"], w4_rows["K6"], decode_at,
             "torch._int_mm (M padded to 32) on the unpacked int8 weights: "
             "one int8 dot at twice the bytes, not the same function"),
            ("K8", "quantized_matmul_w4 (K8)", "qmatmul_w4.cu",
             "ant_quantization_tpu/kernels/qmatmul.py:116",
             w4_counts["K8"]["launches"], w4_rows["K8"], prefill_at,
             "cuBLAS SGEMM (torch.mm, TF32 off) on the f32 x and the "
             "dequantized f32 weight: the same function")):
        kernels.append({
            "name": fname, "route": "cuda",
            "source": f"ant_quantization_tpu_torch/csrc/{src}",
            "replaces": line, "launches": launches,
            "max_abs_err": k568_err[tag], "pass": True,
            "ms_per_launch": {x["site"]: x["ms"] for x in rows}, "at": at,
            "ms": sum(x["ms"] for x in rows),
            "plain_ms": sum(x["plain_ms"] for x in rows),
            "bound_ms": sum(x["bound_ms"] for x in rows),
            "bound_by": "bytes" if all(x["bound_by"] == "bytes"
                                       for x in rows) else "operations",
            "library_ms": sum(x.get("library_ms", x.get("int_mm_ms"))
                              for x in rows),
            "library_note": lib})
    k8 = next(x for x in kernels if x["name"].endswith("(K8)"))
    k8_rows = w4_rows["K8"]
    k8["design"] = ("redesigned PR 6: bf16 wgmma on exact bf16 terms (the "
                    "engine's bf16 x against an exact table: one product)")
    k8["x"] = "the engine's fake-quantized bf16 x"
    k8["f32_x"] = {k: sum(x[f"{k}_f32_x"] for x in k8_rows)
                   for k in ("ms", "bound_ms")}
    k8["f32_x"]["bound_by"] = "operations"
    k8["bound_ms_f32_rate"] = sum(x["bound_ms_f32_rate"] for x in k8_rows)
    k8["bf16_mm_ms"] = sum(x["bf16_mm_ms"] for x in k8_rows)
    k8["bf16_mm_note"] = ("torch.mm in bf16 on the bf16 operands: rounds "
                          "its output, a reference point only")
    k6 = next(x for x in kernels if x["name"].endswith("(K6)"))
    k6["design"] = ("one launch on K1's staged split-K weight stream with "
                    "a nibble-decode policy, the snap fused a stage ahead "
                    "for both x ranges of a stage, the dots on int8 "
                    "mma.sync (csrc/i8_stream.cuh)")
    k6["plans"] = {x["site"]: {"mt": x["mt"], "splits": x["splits"]}
                   for x in w4_rows["K6"]}
    k6["fixed_cost"] = w4_rows["k6_fixed_cost"]
    k5 = next(x for x in kernels if x["name"].endswith("(K5)"))
    k5["design"] = ("the snap pre-kernel (csrc/snap_i8.cuh), then wgmma: "
                    "int8 values with the codes as A (csrc/i8_wgmma.cuh); "
                    "OVP bytes with the weight tile as wgmma's "
                    "register-held A, clamped in registers for the second "
                    "dot, the codes as B (csrc/ovp_wgmma.cuh)")
    k5["snap"] = {"ms": sum(x["snap_ms"] for x in k5_rows),
                  "bound_ms": sum(x["snap_bound_ms"] for x in k5_rows),
                  "bound_by": "bytes",
                  "note": "the snap pre-kernel alone, part of ms"}
    k5["ovp_mode"] = {
        "ms": sum(x["ms"] for x in k5_ovp_rows),
        "plain_ms": sum(x["plain_ms"] for x in k5_ovp_rows),
        "bound_ms": sum(x["bound_ms"] for x in k5_ovp_rows),
        "bound_by": "operations", "library_ms": None,
        "int_mm_reference_ms": sum(x["int_mm_ms"] for x in k5_ovp_rows),
        "at": prefill_at + " on OVP bytes"}
    kernels.append({
        "name": "int8_kv_attention (K7)", "route": "cuda",
        "source": "ant_quantization_tpu_torch/csrc/int8_kv_attention_split.cu",
        "replaces": "ant_quantization_tpu/kernels/attention.py:102",
        "launches": long_counts["K7"]["launches"],
        "max_abs_err": max(k7_err.values()), "max_abs_err_by_out": k7_err,
        "pass": True,
        "at": f"one decode layer of bloom_long: B={k7_row['B']} "
              f"H={k7_row['H']} T=1 D=128 at position {k7_row['pos0']}, "
              f"cache S={k7_row['S']}, ALiBi",
        "ms": k7_row["ms"], "plain_ms": k7_row["plain_ms"],
        "bound_ms": k7_row["bound_ms"], "bound_by": k7_row["bound_by"],
        "library_ms": k7_row["library_ms"],
        "library_note": "SDPA on the dequantized bf16 cache, ALiBi as its "
                        "mask",
        "head_dims": [128, 64, 80],
        "max_abs_err_by_head_dim": {128: k7_err, **hd_err["K7"]},
        "head_dim_80": {
            "at": f"one BLOOM-3b decode layer: B={k7_3b_row['B']} "
                  f"H={k7_3b_row['H']} T=1 D=80 at position "
                  f"{k7_3b_row['pos0']}, cache S={k7_3b_row['S']}, ALiBi",
            **{k: k7_3b_row[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")}},
        "head_dim_64": {
            "at": f"GPT-2 XL: B={BATCH} H=25 T=1 D=64 at position "
                  f"{hd_times['K7']['pos0']}, a random cache "
                  f"S={BLOOM_LONG_SEQ}, no ALiBi",
            **{k: hd_times["K7"][k] for k in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")}}})
    k9_at = {f"{x['site']} M={x['M']}": x for x in k9_rows}
    k9_main = k9_at["fc_in M=4"]
    kernels.append({
        "name": "fused_w8a8_matmul (K9)", "route": "cuda",
        "source": "ant_quantization_tpu_torch/csrc/w8a8_matmul.cu",
        "design": "M <= 64 on K1's stream since PR 6 (csrc/i8_stream.cuh); "
                  "M > 64 on K5's wgmma product since PR 5",
        "replaces": "ant_quantization_tpu/kernels/qmatmul.py:199",
        "launches": insitu_bloom["launches"]["K9"],
        "launches_note": "no engine path calls K9 (as in the reference): "
                         "the count is in_situ_bloom's, where K9 ran at "
                         "every site matmul on the engine's activations",
        "max_abs_err": k9_err, "pass": True,
        "ms_per_launch": {k: x["ms"] for k, x in k9_at.items()},
        "at": "one launch at OPT-6.7B fc_in (4096 x 16384), M=4",
        "ms": k9_main["ms"], "plain_ms": k9_main["plain_ms"],
        "bound_ms": k9_main["bound_ms"], "bound_by": k9_main["bound_by"],
        "library_ms": k9_main["library_ms"],
        "library_note": "torch._int_mm (M padded to 32) on the snapped "
                        "codes: the product without the snap"})
    for k in kernels:
        tag = k["name"][k["name"].rfind("(") + 1:-1]
        if tag in f5_err:
            k["max_abs_err_k196"] = f5_err[tag]
        if tag in ("K1", "K2", "K4"):
            k["launches_calibrate_serve"] = {
                f: cal[f]["launches"][tag] for f in ("ant", "olive")}
        if tag in ("K2", "K4"):
            k["launches_serve_cli"] = serve["launches"][tag]
    emit({"kernels": kernels, "card": smi, "hbm_copy_bytes_per_s": hbm,
          "int8_matmul_k196_max_abs_err": f5_err["int8_matmul"],
          "outlier_percentile_67m": pct_rows,
          "calibrate_serve": {
              f: {k: cal[f][k] for k in ("calibration_s",
                                         "seconds_per_layer",
                                         "prefill_ms",
                                         "decode_ms_per_step")}
              for f in ("ant", "olive")},
          "gpt2_kscale_route_per_layer": kscale_per_layer,
          "serve_cli": {k: serve[k] for k in ("seconds", "serve",
                                              "w4_bytes_i8",
                                              "w4_bytes_packed",
                                              "max_memory_allocated",
                                              "phase_s")},
          "serve_cli_perplexity": serve["clm_eval"]["perplexity"],
          "encoders": {
              k: {"seconds": r["seconds"],
                  "eval_sequences_per_s": r["eval_sequences_per_s"],
                  "result": r["result"],
                  "max_memory_allocated": r["max_memory_allocated"],
                  "ovp_shares": {kind: {f: r["ovp_shares"][kind][f]
                                        for f in ("outliers", "victims")}
                                 for kind in r["ovp_shares"]}}
              for k, r in enc.items() if isinstance(r, dict)
              and "eval_sequences_per_s" in r},
          "encoders_phase_s": enc["phase_s"],
          "qat": {k: {f: r[f] for f in ("seconds", "ms_per_step",
                                        "examples_per_s", "result",
                                        "sites", "max_memory_allocated")}
                  for k, r in qat.items() if isinstance(r, dict)
                  and "ms_per_step" in r},
          "qat_bench": qat["qat_bench"],
          "qat_phase_s": qat["phase_s"],
          "perfmodel": {k: perfmodel[k] for k in ("runs", "fig13_geomeans",
                                                  "phase_s")},
          "seconds": time.perf_counter() - t_start})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
