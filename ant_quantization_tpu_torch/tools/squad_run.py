"""SQuAD v1.1 / v2.0 QA evaluation with OliVe (or ANT) quantization.

Counterpart of the reference's ``tools/squad_run.py``, with the same
flags (plus ``--device``) and the same JSON output: OliVe's run_qa.py
flow, a calibration pre-pass over the features of the first 64 examples
of ``--train_data`` (default ``--data``), evaluation over sliding-window
features, answers by the utils_qa post-processing, then EM and F1.
Without ``--weights`` the model keeps the port's own random init
(smoke-test mode).

Example:
  python -m ant_quantization_tpu_torch.tools.squad_run \\
      --data /data/squad/dev-v1.1.json \\
      --train_data /data/squad/train-v1.1.json \\
      --weights /data/bert-base-squad --tokenizer /data/bert-base-uncased
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .._ext import resolve_device
from ..harness import metrics as M
from ..harness import qa_utils as Q
from ..harness import zoo
from ..harness.evaluate import calibrate_on_batches
from ..harness.tokenization import load_tokenizer
from ..nn.config import QuantConfig
from ..parallel.distributed import initialize_from_env
from ..utils.logging import setup_logger

__all__ = ["parse_args", "main"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", required=True, help="dev json (v1.1/v2.0)")
    p.add_argument("--train_data", default=None,
                   help="train json for the calibration pre-pass "
                        "(defaults to --data)")
    p.add_argument("--weights", default=None)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--model_family", default="bert",
                   choices=("bert", "bart"))
    p.add_argument("--bert_size", default="base", choices=("base", "large"))
    p.add_argument("--version_2", action="store_true")
    p.add_argument("--max_seq_length", type=int, default=384)
    p.add_argument("--doc_stride", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--max_examples", type=int, default=0)
    p.add_argument("--mode", default="ant-int-flint")
    p.add_argument("--family", default="olive", choices=("ant", "olive"))
    p.add_argument("--wbit", "-wb", type=int, default=4)
    p.add_argument("--abit", "-ab", type=int, default=4)
    p.add_argument("--w_low", "-wl", type=int, default=75)
    p.add_argument("--w_up", "-wu", type=int, default=250)
    p.add_argument("--a_low", "-al", type=int, default=75)
    p.add_argument("--a_up", "-au", type=int, default=250)
    p.add_argument("--no_outlier", action="store_true")
    p.add_argument("--n8", type=int, default=0)
    p.add_argument("--disable_quant", action="store_true")
    p.add_argument("--calib_batches", type=int, default=4)
    p.add_argument("--output", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the evaluation; prints the JSON result and returns it."""
    args = parse_args(argv)
    # a no-op unless the environment asks for a world of ranks
    initialize_from_env(device=args.device)
    dev = resolve_device(args.device)
    log = setup_logger("squad_run")

    qcfg = QuantConfig(mode=args.mode, wbit=args.wbit, abit=args.abit,
                       family=args.family, w_low=args.w_low, w_up=args.w_up,
                       a_low=args.a_low, a_up=args.a_up,
                       no_outlier=args.no_outlier,
                       enabled=not args.disable_quant)
    model, _, params = zoo.get_encoder_model(
        args.model_family, args.bert_size, qcfg, head="qa",
        weights_path=args.weights, device=dev)
    if params is None:
        log.warning("no weights: the port's random init (smoke-test mode)")
    del params

    tokenizer = load_tokenizer(args.tokenizer or args.weights)
    examples = Q.load_squad_json(args.data)
    if args.max_examples:
        examples = examples[: args.max_examples]
    features = Q.prepare_features(examples, tokenizer, args.max_seq_length,
                                  args.doc_stride)
    log.info("%d examples -> %d features", len(examples), len(features))

    def feat_args(batch):
        return tuple(torch.as_tensor(np.stack([f[k] for f in batch]),
                                     device=dev).long()
                     for k in ("input_ids", "token_type_ids",
                               "attention_mask"))

    if not args.disable_quant:
        cal_ex = (Q.load_squad_json(args.train_data) if args.train_data
                  else examples)
        cal_feats = Q.prepare_features(cal_ex[:64], tokenizer,
                                       args.max_seq_length, args.doc_stride)
        calib = [feat_args(cal_feats[i:i + args.batch_size])
                 for i in range(0, min(len(cal_feats),
                                       args.calib_batches * args.batch_size),
                                args.batch_size)]
        log.info("calibrating on %d batches", len(calib))
        calibrate_on_batches(model, calib, n8=args.n8, log=log.info)

    start_all, end_all = [], []
    for i in range(0, len(features), args.batch_size):
        batch = features[i:i + args.batch_size]
        with torch.no_grad():
            s, e = model(*feat_args(batch))
        start_all.append(s.to(torch.float32).cpu().numpy())
        end_all.append(e.to(torch.float32).cpu().numpy())
        if (i // args.batch_size + 1) % 20 == 0:
            log.info("eval %d/%d features", i + len(batch), len(features))

    preds = Q.postprocess_predictions(
        examples, features, np.concatenate(start_all),
        np.concatenate(end_all), version_2=args.version_2)
    refs, no_ans = Q.squad_references(examples)
    results = M.squad_metrics(preds, refs,
                              no_ans if args.version_2 else ())
    results.update(mode=args.mode, wbit=args.wbit, abit=args.abit)
    print(json.dumps(results, indent=2))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
