"""ImageNet QAT with ANT quantization.

Counterpart of the reference's ``tools/imagenet_qat.py``, with the same
flags (plus ``--device``) and the same printed JSON: SGD with momentum
and weight decay on a MultiStepLR schedule (epoch milestones converted
to steps), first-batch calibration with optional promotion
(``--n8`` or the ``--layers8`` list), straight-through training steps,
per-epoch top-1/top-5 eval and a checkpoint per epoch under
``--ckpt_dir`` (``step_<epoch>``, the port's safetensors format).

A checkpoint holds ``params``, ``quant``, ``extra`` (the batch
statistics) and ``epoch``, as the reference's code saves it: no
optimizer state, so ``--resume`` restarts the momentum at zero (the
reference's docstring promises the optimizer; its code does not save
it).

Data: ImageFolder directories (uint8 crops decoded by PIL in worker
threads, normalized on the device) or ``synthetic`` (seeded normal
images; ``--steps_per_epoch`` batches an epoch, 8 by default; 2 eval
batches).

Example (the resnet18_qat.sh recipe):
  python -m ant_quantization_tpu_torch.tools.imagenet_qat \\
      --model resnet18 --weights resnet18.pth --train_dir /data/train \\
      --val_dir /data/val --mode ant-int-pot-flint -wb 4 -ab 4 --lr 0.04 \\
      --epochs 10 --milestones 4,7,9
Smoke test:  --train_dir synthetic --val_dir synthetic --epochs 1
"""

from __future__ import annotations

import argparse
import json
import os

from .._ext import resolve_device
from ..harness import checkpoint as C
from ..harness import data as D
from ..harness import train as T
from ..harness import zoo
from ..harness.evaluate import calibrate_on_batches
from ..models.resnet import batch_stats_tree
from ..nn.config import QuantConfig
from ..utils.logging import setup_logger

__all__ = ["parse_args", "main"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", required=True)
    p.add_argument("--weights", default=None)
    p.add_argument("--train_dir", required=True)
    p.add_argument("--val_dir", required=True)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=0.04)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--milestones", default="4,7,9",
                   help="LR decay epochs (MultiStepLR)")
    p.add_argument("--gamma", type=float, default=0.1)
    p.add_argument("--steps_per_epoch", type=int, default=0,
                   help="override (needed for synthetic data)")
    # quantization
    p.add_argument("--mode", default="ant-int-pot-flint")
    p.add_argument("--wbit", "-wb", type=int, default=4)
    p.add_argument("--abit", "-ab", type=int, default=4)
    p.add_argument("--w_low", "-wl", type=int, default=75)
    p.add_argument("--w_up", "-wu", type=int, default=150)
    p.add_argument("--a_low", "-al", type=int, default=75)
    p.add_argument("--a_up", "-au", type=int, default=150)
    p.add_argument("--n8", type=int, default=0)
    p.add_argument("--grad_accum", type=int, default=1,
                   help="microbatches per step (memory saver; numerics "
                        "identical for BN-free models; BN stats become "
                        "per-microbatch when > 1)")
    p.add_argument("--layers8", "-l8", default=None)
    p.add_argument("--workers", type=int, default=16,
                   help="decode threads for the input pipeline")
    p.add_argument("--ckpt_dir", default="checkpoints/qat")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the QAT; prints the final JSON result and returns it."""
    if os.environ.get("ANT_COORDINATOR") or os.environ.get("ANT_DISTRIBUTED"):
        raise NotImplementedError(
            "multi-host training (ANT_COORDINATOR / ANT_DISTRIBUTED) is "
            "not ported to PyTorch yet (ROADMAP Queue 1 item 12)")
    args = parse_args(argv)
    dev = resolve_device(args.device)
    log = setup_logger("imagenet_qat")
    qcfg = QuantConfig(mode=args.mode, wbit=args.wbit, abit=args.abit,
                       family="ant", w_low=args.w_low, w_up=args.w_up,
                       a_low=args.a_low, a_up=args.a_up)
    model, _, variables = zoo.get_image_model(args.model, qcfg,
                                              args.weights, device=dev)
    _, crop = D.model_input_size(args.model)
    synth = args.train_dir == "synthetic"
    val_synth = args.val_dir == "synthetic"

    def train_batches(seed):
        if synth:
            return D.synthetic_image_batches(
                args.batch_size, args.steps_per_epoch or 8, crop, seed=seed)
        return D.imagefolder_batches(args.train_dir, args.batch_size,
                                     args.model, workers=args.workers,
                                     as_uint8=True)

    def val_batches():
        if val_synth:
            return D.synthetic_image_batches(args.batch_size, 2, crop,
                                             seed=10_000)
        return D.imagefolder_batches(args.val_dir, args.batch_size,
                                     args.model, workers=args.workers,
                                     as_uint8=True)

    if variables is None:
        log.warning("no weights: the port's random init")
    has_bn = bool(batch_stats_tree(model))
    preprocess = None if synth else D.normalize_images

    # first-batch calibration and promotion (main.py:190-195)
    images0, _ = next(iter(train_batches(0)))
    calibrate_on_batches(model, [(D.device_images(images0, dev,
                                                  preprocess),)],
                         n8=args.n8, layer_list=args.layers8, log=log.info)

    if synth and not args.steps_per_epoch:
        args.steps_per_epoch = 8
    steps = args.steps_per_epoch or max(
        sum(1 for _ in train_batches(0)), 1)
    milestones = [int(m) * steps for m in args.milestones.split(",") if m]
    tx = T.sgd_multistep(args.lr, milestones, args.gamma, args.momentum,
                         args.weight_decay)
    state = T.TrainState(model, tx.init(list(model.parameters())))

    start_epoch = 0
    if args.resume and C.latest_step(args.ckpt_dir) is not None:
        tree = C.restore_checkpoint(args.ckpt_dir, device=dev)
        T.load_checkpoint_tree(model, tree)
        start_epoch = int(tree.get("epoch", 0)) + 1
        log.info("resumed from epoch %d", start_epoch - 1)

    step_fn = T.make_classification_step(
        model, tx, has_batch_stats=has_bn, grad_accum=args.grad_accum,
        preprocess=preprocess)
    val_pre = None if val_synth else D.normalize_images
    for epoch in range(start_epoch, args.epochs):
        for i, (images, labels) in enumerate(train_batches(epoch)):
            state, loss = step_fn(state, images, labels)
            if i % 50 == 0:
                log.info("epoch %d step %d loss %.4f", epoch, i,
                         float(loss))
        m = T.evaluate_classification(model, val_batches(),
                                      preprocess=val_pre)
        log.info("epoch %d: %s", epoch, m)
        C.save_checkpoint(args.ckpt_dir, T.checkpoint_tree(state, epoch),
                          step=epoch)

    results = T.evaluate_classification(model, val_batches(),
                                        preprocess=val_pre)
    log.info("Final accuracy: %s", results)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
