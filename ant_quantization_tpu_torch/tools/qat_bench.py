"""QAT step overhead: the fake-quant training step against the identical
dense step.

Counterpart of the reference's ``tools/qat_bench.py``, with the same
flags and output: it times the training step of a model with ANT
fake-quant (states calibrated on two examples, by default with the fast
one-ratio scan 100-101, since the steady-state step is what is measured)
against the same model unquantized, SGD with momentum (lr 1e-3, 0.9) in
both, and reports ms per step, examples/s and the overhead ratio. Where
the reference runs ``--inner`` steps in one jitted ``lax.scan``, the
port times each block of ``--inner`` steps with CUDA events (on the CPU,
with the host clock), ``--reps`` blocks after one warm-up block.

    python -m ant_quantization_tpu_torch.tools.qat_bench --model resnet18 \\
        --batch 64
    python -m ant_quantization_tpu_torch.tools.qat_bench \\
        --model bert_base --batch 16 --seq 128 --json
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .._ext import resolve_device
from ..harness import train as T
from ..harness import zoo
from ..harness.data import device_images
from ..models.resnet import batch_stats_tree
from ..nn.config import QuantConfig
from ..utils.calibration import calibrate_model

__all__ = ["build", "time_steps", "main"]


def _quant_cfg(args, enabled: bool) -> QuantConfig:
    if not enabled:
        return QuantConfig(enabled=False)
    lb, ub = (100, 101) if args.fast_calib else (args.low, args.up)
    return QuantConfig(mode=args.mode, family="ant",
                       wbit=args.wbit, abit=args.abit,
                       w_low=lb, w_up=ub, a_low=lb, a_up=ub,
                       quantize_input=not args.weights_only)


def build(args, enabled: bool, device):
    """(step, state, batch): one training step of the model (quantized or
    dense) on a seeded batch, its TrainState and the batch."""
    qcfg = _quant_cfg(args, enabled)
    rng = np.random.default_rng(0)
    tx = T.SGD(lambda count: float(np.float32(1e-3)), momentum=0.9)
    if args.model in zoo.IMAGE_MODELS:
        model, _, _ = zoo.get_image_model(args.model, qcfg, device=device)
        size = args.size or (299 if args.model == "inception_v3" else 224)
        images = torch.as_tensor(rng.normal(
            size=(args.batch, size, size, 3)).astype(np.float32),
            device=device)
        labels = torch.as_tensor(rng.integers(0, 1000, (args.batch,)),
                                 device=device)
        if enabled:
            calibrate_model(model, device_images(images[:2], device))
        has_bs = bool(batch_stats_tree(model))
        step = T.make_classification_step(model, tx, has_batch_stats=has_bs)
        batch = (images, labels)
    elif args.model in ("bert_base", "bert_large"):
        model, _, _ = zoo.get_bert(args.model.split("_")[1], qcfg,
                                   device=device)
        ids = torch.as_tensor(rng.integers(0, 30000, (args.batch, args.seq)),
                              device=device)
        labels = torch.as_tensor(rng.integers(0, 2, (args.batch,)),
                                 device=device)
        if enabled:
            calibrate_model(model, ids[:2])
        step = T.make_step(model, tx, lambda ids, labels: T.cross_entropy(
            model(ids), labels).mean())
        batch = (ids, labels)
    else:
        raise SystemExit(f"unknown model {args.model!r}")
    state = T.TrainState(model, tx.init(list(model.parameters())))
    return step, state, batch


def time_steps(args, enabled: bool, label: str, device) -> float:
    """Seconds per step: the mean over ``args.reps`` blocks of
    ``args.inner`` steps, after one warm-up block."""
    step, state, batch = build(args, enabled, device)
    cuda = device.type == "cuda"

    def block():
        nonlocal state
        for _ in range(args.inner):
            state, loss = step(state, *batch)
        return loss

    float(block())                                   # warm-up
    if cuda:
        torch.cuda.synchronize(device)
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
    else:
        start = time.perf_counter()
    for _ in range(args.reps):
        loss = block()
    if cuda:
        t1.record()
        t1.synchronize()
        total = t0.elapsed_time(t1) / 1e3
    else:
        float(loss)
        total = time.perf_counter() - start
    dt = total / (args.reps * args.inner)
    print(f"# {label}: {dt * 1e3:.2f} ms/step "
          f"({args.batch / dt:.0f} ex/s)", file=sys.stderr)
    del state
    if cuda:
        torch.cuda.empty_cache()
    return dt


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="resnet18")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--size", type=int, default=None,
                   help="image side (default: model's eval size)")
    p.add_argument("--seq", type=int, default=128, help="BERT seq length")
    p.add_argument("--mode", default="ant-int-pot-flint")
    p.add_argument("--wbit", type=int, default=4)
    p.add_argument("--abit", type=int, default=4)
    p.add_argument("--low", type=int, default=75)
    p.add_argument("--up", type=int, default=150)
    p.add_argument("--no-fast-calib", dest="fast_calib",
                   action="store_false",
                   help="full MSE alpha scan during setup (slow, identical "
                        "steady-state step)")
    p.add_argument("--weights-only", action="store_true",
                   help="quantize weights only (disable_input_quantization"
                        " analog) - splits the overhead attribution")
    p.add_argument("--inner", type=int, default=8,
                   help="train steps per timed block")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    dt_q = time_steps(args, True, f"{args.model} QAT ({args.mode} "
                                  f"w{args.wbit}a{args.abit})", dev)
    dt_d = time_steps(args, False, f"{args.model} dense", dev)
    out = {
        "model": args.model, "batch": args.batch,
        "qat_ms_per_step": round(dt_q * 1e3, 3),
        "dense_ms_per_step": round(dt_d * 1e3, 3),
        "qat_examples_per_s": round(args.batch / dt_q, 1),
        "overhead": round(dt_q / dt_d, 3),
    }
    if args.json:
        print(json.dumps(out))
    else:
        print(f"QAT overhead: {out['overhead']:.2f}x "
              f"({out['qat_ms_per_step']} ms vs {out['dense_ms_per_step']} "
              f"ms/step; {out['qat_examples_per_s']} ex/s quantized)")
    return out


if __name__ == "__main__":
    main()
