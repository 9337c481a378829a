"""BERT/BART GLUE evaluation and fine-tuning with ANT or OliVe
quantization.

Counterpart of the reference's ``tools/glue_run.py``, with the same flags
(plus ``--device``) and the same JSON output: the OliVe GLUE flow
(olive bert/run_glue.py), a calibration pre-pass over ``--calib_batches``
train-split batches, optional 8-bit promotion (``--n8`` or
``--layers8``), then the task's metrics on the dev split. ``--train``
(the ANT BERT flow) fine-tunes between the calibration and the final
eval: BertAdam over steps_per_epoch x ``--epochs`` steps (warmup
``--warmup``), the train split shuffled each epoch by
``np.random.default_rng(epoch)``, MSE on logit 0 for STS-B and softmax
cross entropy otherwise, the quantizer states frozen, and the dev
metrics after each epoch.

Data: a GLUE task directory in the standard TSV layout (``--data_dir``)
or jsonl, tokenized by ``--tokenizer`` (an HF dir or a vocab.txt);
without ``--data_dir``, seeded synthetic batches (random ids in [0,
30522), full attention masks) at ``--max_seq_length``. Without
``--weights`` the model keeps the port's own random init (normal with std
1/sqrt(fan in)), not flax's (smoke-test mode).

Under ``ANT_COORDINATOR`` or ``ANT_DISTRIBUTED=1`` the process first joins
its world of ranks (``parallel/distributed.py``).

Examples:
  python -m ant_quantization_tpu_torch.tools.glue_run --task sst2 \\
      --data_dir /data/glue/SST-2 --weights /data/bert-base-sst2 \\
      --mode ant-int-flint --family olive --w_up 250 --a_up 250
  python -m ant_quantization_tpu_torch.tools.glue_run --device cpu \\
      --task mrpc --model_family bart --max_seq_length 32 \\
      --batch_size 4 --calib_batches 1          # synthetic smoke run
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .._ext import resolve_device
from ..harness import data as D
from ..harness import train as T
from ..harness import zoo
from ..harness.evaluate import calibrate_on_batches, glue_eval
from ..nn.config import QuantConfig
from ..parallel.distributed import initialize_from_env
from ..utils.logging import setup_logger

__all__ = ["parse_args", "main"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--task", required=True, choices=sorted(D.GLUE_TASKS))
    p.add_argument("--data_dir", default=None,
                   help="GLUE task dir (TSV layout); omit for synthetic")
    p.add_argument("--weights", default=None,
                   help="finetuned HF checkpoint (dir or file)")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--model_family", default="bert",
                   choices=("bert", "bart"))
    p.add_argument("--bert_size", default="base", choices=("base", "large"))
    p.add_argument("--max_seq_length", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=32)
    # quantization
    p.add_argument("--mode", default="ant-int-pot-flint")
    p.add_argument("--family", default="ant", choices=("ant", "olive"))
    p.add_argument("--wbit", "-wb", type=int, default=4)
    p.add_argument("--abit", "-ab", type=int, default=4)
    p.add_argument("--w_low", "-wl", type=int, default=75)
    p.add_argument("--w_up", "-wu", type=int, default=150)
    p.add_argument("--a_low", "-al", type=int, default=75)
    p.add_argument("--a_up", "-au", type=int, default=150)
    p.add_argument("--no_outlier", action="store_true")
    p.add_argument("--n8", type=int, default=0)
    p.add_argument("--layers8", "-l8", default=None,
                   help="explicit comma list of sites to promote")
    p.add_argument("--disable_quant", action="store_true")
    p.add_argument("--calib_batches", type=int, default=4,
                   help="quantize_batch_size/bs pre-pass batches "
                        "(olive run_glue.py:539-546)")
    # finetune (QAT)
    p.add_argument("--train", action="store_true")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--warmup", type=float, default=0.1)
    p.add_argument("--output", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions")
    return p.parse_args(argv)


def synthetic_batches(n, bs, seq, num_labels, vocab=30522, seed=0):
    """The reference's seeded synthetic batches, draw for draw."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield {
            "input_ids": rng.integers(0, vocab, (bs, seq)).astype(np.int32),
            "token_type_ids": np.zeros((bs, seq), np.int32),
            "attention_mask": np.ones((bs, seq), np.int32),
            "labels": rng.integers(0, num_labels, bs).astype(np.int32),
        }


def encoded_batches(args, split, tokenizer, shuffle_seed=None):
    """A split's examples encoded in batches of ``--batch_size`` (a last
    batch of fewer than two examples is dropped, as in the reference),
    shuffled first by ``np.random.default_rng(shuffle_seed)`` when
    given."""
    examples = D.load_glue_split(args.data_dir, args.task, split)
    if shuffle_seed is not None:
        rng = np.random.default_rng(shuffle_seed)
        examples = [examples[i] for i in rng.permutation(len(examples))]
    for i in range(0, len(examples), args.batch_size):
        chunk = examples[i:i + args.batch_size]
        if len(chunk) < 2:
            continue
        yield D.encode_glue_batch(tokenizer, chunk, args.max_seq_length)


def main(argv=None) -> dict:
    """Run the evaluation; prints the JSON result and returns it."""
    args = parse_args(argv)
    # a no-op unless the environment asks for a world of ranks
    initialize_from_env(device=args.device)
    dev = resolve_device(args.device)
    log = setup_logger("glue_run")
    num_labels = D.glue_num_labels(args.task)
    regression = args.task == "stsb"

    qcfg = QuantConfig(mode=args.mode, wbit=args.wbit, abit=args.abit,
                       family=args.family, w_low=args.w_low, w_up=args.w_up,
                       a_low=args.a_low, a_up=args.a_up,
                       no_outlier=args.no_outlier,
                       enabled=not args.disable_quant)
    model, _, params = zoo.get_encoder_model(
        args.model_family, args.bert_size, qcfg, num_labels=num_labels,
        weights_path=args.weights, device=dev)
    if params is None:
        log.warning("no weights: the port's random init (smoke-test mode)")
    del params                       # the model holds the same values

    tokenizer = None
    if args.data_dir:
        from ..harness.tokenization import load_tokenizer
        tokenizer = load_tokenizer(args.tokenizer or args.weights)

    def train_batches(seed=None):
        if args.data_dir:
            return encoded_batches(args, "train", tokenizer, seed)
        return synthetic_batches(args.calib_batches + 8, args.batch_size,
                                 args.max_seq_length, num_labels)

    def dev_batches():
        if args.data_dir:
            return encoded_batches(args, "dev", tokenizer)
        return synthetic_batches(4, args.batch_size, args.max_seq_length,
                                 num_labels, seed=1)

    def to_args(b):
        ids = np.asarray(b["input_ids"])
        return tuple(torch.as_tensor(np.asarray(a), device=dev).long()
                     for a in (ids,
                               b.get("token_type_ids", np.zeros_like(ids)),
                               b["attention_mask"]))

    if not args.disable_quant:
        calib = []
        for i, b in enumerate(train_batches()):
            if i >= args.calib_batches:
                break
            calib.append(to_args(b))
        log.info("calibrating on %d train batches", len(calib))
        calibrate_on_batches(model, calib, n8=args.n8,
                             layer_list=args.layers8, log=log.info)

    if args.train:
        steps_per_epoch = max(sum(1 for _ in train_batches()), 1)
        tx = T.bert_adam(args.lr, steps_per_epoch * args.epochs,
                         args.warmup)

        def loss_fn(ids, tt, am, labels):
            logits = model(ids, tt, am)
            if regression:
                return torch.mean((logits[:, 0] - labels) ** 2)
            return T.cross_entropy(logits, labels).mean()

        step = T.make_step(model, tx, loss_fn)
        state = T.TrainState(model, tx.init(list(model.parameters())))
        for epoch in range(args.epochs):
            for i, b in enumerate(train_batches(seed=epoch)):
                labels = torch.as_tensor(
                    np.asarray(b["labels"]), device=dev,
                    dtype=torch.float32 if regression else torch.int64)
                state, loss = step(state, *to_args(b), labels)
                if i % 50 == 0:
                    log.info("epoch %d step %d loss %.4f", epoch, i,
                             float(loss))
            m = glue_eval(model, dev_batches(), args.task, regression)
            log.info("epoch %d: %s", epoch, m)

    results = glue_eval(model, dev_batches(), args.task, regression)
    results.update(task=args.task, mode=args.mode, family=args.family,
                   wbit=args.wbit, abit=args.abit)
    print(json.dumps(results, indent=2))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
