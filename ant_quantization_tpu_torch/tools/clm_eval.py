"""Causal-LM perplexity evaluation with OliVe/ANT quantization.

Counterpart of the reference's ``tools/clm_eval.py``: load GPT-2 / OPT /
BLOOM weights from a local HF model dir, quantize every matmul site
(lm_head excluded), calibrate on the first eval batches, then report
perplexity = exp(eval_loss) as one JSON object. Runs on ``--device``
(default the card).

Examples:
  python -m ant_quantization_tpu_torch.tools.clm_eval \\
      --model /data/gpt2-xl --dataset /data/wiki.txt \\
      --mode ant-int-flint --wbit 4 --abit 4
  python -m ant_quantization_tpu_torch.tools.clm_eval --device cpu \\
      --model gpt2:small --dataset synthetic --block_size 64   # smoke
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .._ext import resolve_device
from ..harness import data as D
from ..harness import zoo
from ..harness.evaluate import calibrate_on_batches, lm_perplexity
from ..nn.config import QuantConfig
from ..parallel.distributed import initialize_from_env
from ..utils.logging import setup_logger

__all__ = ["parse_args", "load_tokens", "main"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", required=True,
                   help="local HF model dir, or preset family[:size]")
    p.add_argument("--dataset", required=True,
                   help="text file | local HF dataset dir | 'synthetic'")
    p.add_argument("--dataset_config", default=None)
    p.add_argument("--split", default="validation")
    p.add_argument("--tokenizer", default=None,
                   help="tokenizer dir (defaults to --model)")
    p.add_argument("--block_size", type=int, default=1024)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_blocks", type=int, default=0)
    # quantization args (olive run_clm.py QuantizeArguments)
    p.add_argument("--mode", default="ant-int-flint")
    p.add_argument("--wbit", "-wb", type=int, default=4)
    p.add_argument("--abit", "-ab", type=int, default=4)
    p.add_argument("--w_low", "-wl", type=int, default=75)
    p.add_argument("--w_up", "-wu", type=int, default=250)
    p.add_argument("--a_low", "-al", type=int, default=75)
    p.add_argument("--a_up", "-au", type=int, default=250)
    p.add_argument("--no_outlier", action="store_true")
    p.add_argument("--n8", type=int, default=0,
                   help="promote N highest-MSE sites to 8-bit")
    p.add_argument("--disable_quant", action="store_true")
    p.add_argument("--calib_batches", type=int, default=1)
    p.add_argument("--output", default=None, help="json results path")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions")
    return p.parse_args(argv)


def load_tokens(args, log) -> np.ndarray:
    if args.dataset == "synthetic":
        rng = np.random.default_rng(0)
        return rng.integers(0, 1000, 64 * args.block_size).astype(np.int32)
    from ..harness.tokenization import load_tokenizer
    tokenizer = load_tokenizer(args.tokenizer or args.model)
    if os.path.isfile(args.dataset):
        log.info("tokenizing text file %s", args.dataset)
        ds = D.TextDataset.from_text_file(args.dataset, tokenizer,
                                          args.block_size)
    else:
        log.info("loading dataset %s", args.dataset)
        ds = D.TextDataset.from_hf(args.dataset, args.dataset_config,
                                   args.split, tokenizer, args.block_size)
    return ds.blocks.reshape(-1)


def main(argv=None) -> dict:
    """Run the evaluation; prints the JSON result and returns it."""
    args = parse_args(argv)
    # a no-op unless the environment asks for a world of ranks
    initialize_from_env(device=args.device)
    dev = resolve_device(args.device)
    log = setup_logger("clm_eval")

    qcfg = QuantConfig(mode=args.mode, wbit=args.wbit, abit=args.abit,
                       family="olive", w_low=args.w_low, w_up=args.w_up,
                       a_low=args.a_low, a_up=args.a_up,
                       no_outlier=args.no_outlier,
                       enabled=not args.disable_quant)
    log.info("building model %s (mode=%s W%dA%d ovp=%s)", args.model,
             args.mode, args.wbit, args.abit, not args.no_outlier)
    model, cfg, params = zoo.get_lm(args.model, qcfg, device=dev)
    if params is None:
        log.warning("no weights: random init (smoke-test mode)")
    del params                       # the model holds the same values
    blocks = D.lm_blocks(load_tokens(args, log), args.block_size)
    if args.max_blocks:
        blocks = blocks[: args.max_blocks]
    log.info("%d eval blocks of %d tokens", len(blocks), args.block_size)

    if not args.disable_quant:
        calib = [(torch.as_tensor(blocks[i * args.batch_size:
                                         (i + 1) * args.batch_size],
                                  device=dev).long(),)
                 for i in range(args.calib_batches)]
        log.info("calibrating on %d batches", len(calib))
        calibrate_on_batches(model, calib, n8=args.n8, log=log.info)

    results = lm_perplexity(model, blocks, args.batch_size, log=log.info)
    results.update(model=args.model, mode=args.mode, wbit=args.wbit,
                   abit=args.abit, ovp=not args.no_outlier)
    print(json.dumps(results, indent=2))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
