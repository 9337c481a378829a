"""ImageNet classification eval with ANT quantization (PTQ).

Counterpart of the reference's ``tools/imagenet_eval.py``, with the same
flags (plus ``--device``) and the same JSON output: build a model from
the zoo, import torchvision weights, calibrate on one batch (ptq_init,
with optional 8-bit promotion by ``--n8`` or ``--layers8``), then top-1
and top-5 over the eval stream, optionally journaled (``--journal``) so
a restarted eval resumes. ``--resume`` loads a checkpoint written by
``imagenet_qat`` (params, quant states and batch statistics) instead of
calibrating.

Data: an ImageFolder directory (decoded with PIL) or ``synthetic``
(seeded normal images, 4 batches). Without ``--weights`` the model keeps
the port's random init (smoke-test mode).

Example (6-bit PTQ, Table V of the paper):
  python -m ant_quantization_tpu_torch.tools.imagenet_eval \\
      --model resnet50 --weights resnet50.pth --data_dir /data/val \\
      --mode ant-int-pot-float-flint --wbit 6 --abit 6
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
from ..nn.config import QuantConfig
from ..utils.logging import setup_logger

__all__ = ["parse_args", "main"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", required=True, help=str(zoo.IMAGE_MODELS))
    p.add_argument("--weights", default=None,
                   help=".pth/.npz/.safetensors state dict")
    p.add_argument("--data_dir", required=True,
                   help="ImageFolder val dir, or 'synthetic'")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--limit", type=int, default=0,
                   help="cap on eval images (0 = all)")
    # quantization (ImageNet/main.py:20-73)
    p.add_argument("--mode", default="ant-int-pot-flint")
    p.add_argument("--wbit", "-wb", type=int, default=4)
    p.add_argument("--abit", "-ab", type=int, default=4)
    p.add_argument("--w_low", "-wl", type=int, default=75)
    p.add_argument("--w_up", "-wu", type=int, default=150)
    p.add_argument("--a_low", "-al", type=int, default=75)
    p.add_argument("--a_up", "-au", type=int, default=150)
    p.add_argument("--percent", type=float, default=1.0,
                   help="GOBO outlier-mode percentile (mode=outlier)")
    p.add_argument("--n8", type=int, default=0)
    p.add_argument("--layers8", "-l8", default=None)
    p.add_argument("--disable_quant", action="store_true")
    p.add_argument("--resume", default=None,
                   help="checkpoint dir with calibrated quant state")
    p.add_argument("--output", default=None)
    p.add_argument("--journal", default=None,
                   help="crash-resume journal path: a restarted eval "
                        "skips batches already accumulated")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the evaluation; prints the JSON result and returns it."""
    if os.environ.get("ANT_COORDINATOR") or os.environ.get("ANT_DISTRIBUTED"):
        raise NotImplementedError(
            "multi-host evaluation (ANT_COORDINATOR / ANT_DISTRIBUTED) is "
            "not ported to PyTorch yet (ROADMAP Queue 1 item 12)")
    args = parse_args(argv)
    dev = resolve_device(args.device)
    log = setup_logger("imagenet_eval")
    qcfg = QuantConfig(mode=args.mode, wbit=args.wbit, abit=args.abit,
                       family="ant", w_low=args.w_low, w_up=args.w_up,
                       a_low=args.a_low, a_up=args.a_up,
                       percent=args.percent,
                       enabled=not args.disable_quant)
    model, _, variables = zoo.get_image_model(args.model, qcfg,
                                              args.weights, device=dev)
    _, crop = D.model_input_size(args.model)

    def batches():
        if args.data_dir == "synthetic":
            return D.synthetic_image_batches(args.batch_size, 4, crop)
        return D.imagefolder_batches(args.data_dir, args.batch_size,
                                     args.model, limit=args.limit or None)

    if variables is None:
        log.warning("no weights: the port's random init (smoke-test mode)")

    if args.resume:
        T.load_checkpoint_tree(model, C.restore_checkpoint(args.resume,
                                                           device=dev))
        log.info("restored checkpoint from %s", args.resume)
    elif not args.disable_quant:
        images, _ = next(iter(batches()))
        log.info("ptq_init: calibrating on one %d-image batch", len(images))
        calibrate_on_batches(model, [(D.device_images(images, dev),)],
                             n8=args.n8, layer_list=args.layers8,
                             log=log.info)

    fp = (f"{args.model}|{args.mode}|w{args.wbit}a{args.abit}|"
          f"{args.weights or 'random'}|{args.data_dir}")
    results = T.evaluate_classification(model, batches(), log_every=10,
                                        logger=log.info,
                                        journal=args.journal,
                                        journal_fingerprint=fp)
    results.update(model=args.model, mode=args.mode, wbit=args.wbit,
                   abit=args.abit)
    print(json.dumps(results, indent=2))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
