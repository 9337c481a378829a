"""Quantized LLM serving CLI: continuous batching over the W4/INT8-KV
engine, with pre-quantized engine checkpoints.

Counterpart of the reference's ``tools/serve_cli.py``, with the same
flags (plus ``--device``) and the same JSON output lines. After
calibration the engine state (int8 weight values, scales, grids) is
saved with ``--save_engine`` and later restored with ``--load_engine``,
which skips both weight import and calibration. The "w4" weight stacks
are stored at true 4-bit density (``numerics/bitcodec.py``), the rest as
safetensors (``harness/checkpoint.py``).

Examples:
  # random-weight smoke run on the CPU, token-id prompts
  python -m ant_quantization_tpu_torch.tools.serve_cli --device cpu \\
      --model opt:125m --prompt-ids "12,51,8" --max_new_tokens 16

  # a local HF model dir + its tokenizer on the card; save the engine
  python -m ant_quantization_tpu_torch.tools.serve_cli \\
      --model /data/opt-6.7b --prompts prompts.txt \\
      --save_engine /ckpt/opt67b_w4a4

  # serve from the saved engine
  python -m ant_quantization_tpu_torch.tools.serve_cli \\
      --model /data/opt-6.7b --load_engine /ckpt/opt67b_w4a4 \\
      --prompts prompts.txt
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from .._ext import resolve_device
from ..harness import checkpoint, zoo
from ..harness.evaluate import calibrate_on_batches
from ..models.transformer_lm import LMConfig, conv1d_site_names, params_tree
from ..nn.config import QuantConfig
from ..numerics.bitcodec import W4_KEYS, pack_w4_stack, unpack_w4_stack
from ..parallel.distributed import initialize_from_env
from ..serve import engine as eng
from ..serve.sampling import SamplingConfig
from ..serve.scheduler import ContinuousBatcher, Request
from ..utils.logging import setup_logger

__all__ = ["parse_args", "save_engine", "load_engine", "read_prompts",
           "main"]

log = setup_logger("serve")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", required=True,
                   help="HF model dir, or preset family[:size] "
                        "(gpt2:small, opt:125m, bloom:560m, ...)")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--prompts", default=None,
                   help="text file, one prompt per line (needs tokenizer)")
    p.add_argument("--prompt-ids", default=None,
                   help="semicolon-separated prompts of comma-separated "
                        "token ids, e.g. '1,2,3;4,5'")
    p.add_argument("--max_new_tokens", type=int, default=32)
    p.add_argument("--eos_id", type=int, default=None)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max_seq", type=int, default=1024)
    p.add_argument("--mode", default="ant-int-flint")
    p.add_argument("--family", default="olive", choices=("ant", "olive"))
    p.add_argument("--wbit", type=int, default=4)
    p.add_argument("--abit", type=int, default=4)
    p.add_argument("--w_low", type=int, default=75)
    p.add_argument("--w_up", type=int, default=250)
    p.add_argument("--a_low", type=int, default=75)
    p.add_argument("--a_up", type=int, default=250)
    p.add_argument("--weight_mode", default="w4",
                   choices=("w4", "w4pack", "bf16"))
    p.add_argument("--no_kv_int8", action="store_true")
    p.add_argument("--lm_head_int8", action="store_true",
                   help="store the tied lm_head/embedding int8 (W8A8 "
                        "logits matmul; beyond-reference serving option)")
    p.add_argument("--save_engine", default=None,
                   help="directory: save the calibrated+packed engine")
    p.add_argument("--load_engine", default=None,
                   help="directory: restore a saved engine (skips "
                        "calibration and weight import)")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="sampling temperature (0 = greedy)")
    p.add_argument("--top_k", type=int, default=0)
    p.add_argument("--top_p", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "versions")
    return p.parse_args(argv)


def _codec_axes(cfg: eng.EngineConfig, site: str) -> int:
    return 1 if site in conv1d_site_names(cfg.lm) else 0


def save_engine(path: str, cfg: eng.EngineConfig, ep) -> None:
    """Save the engine config as ``engine.json`` (the reference's keys)
    and its params under ``path/ep``; "w4" stacks packed two codes per
    byte."""
    os.makedirs(path, exist_ok=True)
    lm = dataclasses.asdict(cfg.lm)
    lm["dtype"] = str(lm["dtype"]).replace("torch.", "")   # "float32"
    if isinstance(lm["conv1d_sites"], tuple):
        lm["conv1d_sites"] = list(lm["conv1d_sites"])
    meta = {"lm": lm,
            "weight_mode": cfg.weight_mode, "act_bits": cfg.act_bits,
            "kv_int8": cfg.kv_int8, "max_seq": cfg.max_seq,
            "lm_head_int8": cfg.lm_head_int8}
    if cfg.weight_mode == "w4":
        meta["w4_codec"] = 1
        i8_bytes = packed_bytes = 0
        layers = {}
        for name, site in ep["layers"].items():
            if isinstance(site, dict) and "w_i8" in site:
                site = dict(site)
                w = site.pop("w_i8")
                packed = pack_w4_stack(w, ovp="ovp" in site,
                                       pair_axis=_codec_axes(cfg, name))
                site.update(packed)
                i8_bytes += w.numel()
                packed_bytes += sum(v.numel() * v.element_size()
                                    for v in packed.values())
            layers[name] = site
        ep = dict(ep, layers=layers)
        meta["w4_bytes_i8"] = i8_bytes
        meta["w4_bytes_packed"] = packed_bytes
    with open(os.path.join(path, "engine.json"), "w") as f:
        json.dump(meta, f)
    checkpoint.save_checkpoint(os.path.join(path, "ep"), ep)
    log.info("saved engine to %s", path)


def load_engine(path: str, device=None):
    """-> (EngineConfig, engine params on ``device``, default "cuda"): the
    engine :func:`save_engine` saved, "w4" stacks unpacked to the exact
    int8 stores."""
    dev = resolve_device(device)
    with open(os.path.join(path, "engine.json")) as f:
        meta = json.load(f)
    lm_kw = dict(meta["lm"])
    lm_kw["dtype"] = getattr(torch, lm_kw["dtype"])
    if isinstance(lm_kw["conv1d_sites"], list):
        lm_kw["conv1d_sites"] = tuple(lm_kw["conv1d_sites"])
    cfg = eng.EngineConfig(lm=LMConfig(**lm_kw),
                           weight_mode=meta["weight_mode"],
                           act_bits=meta["act_bits"],
                           kv_int8=meta["kv_int8"],
                           max_seq=meta["max_seq"],
                           lm_head_int8=meta.get("lm_head_int8", False))
    ep = checkpoint.restore_checkpoint(os.path.join(path, "ep"), device=dev)
    if meta.get("w4_codec"):
        layers = {}
        for name, site in ep["layers"].items():
            if isinstance(site, dict) and "w4_packed" in site:
                site = dict(site)
                packed = {k: site.pop(k) for k in W4_KEYS if k in site}
                site["w_i8"] = unpack_w4_stack(packed)
            layers[name] = site
        ep["layers"] = layers
    return cfg, ep


def read_prompts(args, tokenizer):
    if args.prompt_ids:
        return [[int(t) for t in p.split(",") if t.strip()]
                for p in args.prompt_ids.split(";")], None
    if args.prompts:
        if tokenizer is None:
            raise ValueError("--prompts needs --tokenizer or a model dir")
        with open(args.prompts) as f:
            texts = [l.rstrip("\n") for l in f if l.strip()]
        return [tokenizer(t)["input_ids"] for t in texts], texts
    # default smoke prompts
    rng = np.random.default_rng(0)
    return [rng.integers(1, 100, n).tolist() for n in (5, 9, 3, 12)], None


def main(argv=None):
    args = parse_args(argv)
    # a no-op unless the environment asks for a world of ranks
    initialize_from_env(device=args.device)
    dev = resolve_device(args.device)
    qcfg = QuantConfig(mode=args.mode, family=args.family, wbit=args.wbit,
                       abit=args.abit, w_low=args.w_low, w_up=args.w_up,
                       a_low=args.a_low, a_up=args.a_up)

    tokenizer = None
    if args.tokenizer or (args.prompts and os.path.isdir(args.model)):
        from ..harness.tokenization import load_tokenizer
        tokenizer = load_tokenizer(args.tokenizer or args.model)
    prompts, texts = read_prompts(args, tokenizer)

    if args.load_engine:
        ecfg, ep = load_engine(args.load_engine, device=dev)
    else:
        model, cfg, params = zoo.get_lm(args.model, qcfg, device=dev)
        if params is None:
            log.warning("no weights: random init (smoke-test mode)")
        del params                   # the model holds the same values
        ids = torch.tensor(
            [p[:8] + [0] * max(0, 8 - len(p)) for p in prompts[:4]],
            dtype=torch.int64, device=dev)
        quant = None
        if args.weight_mode != "bf16" or args.abit:
            quant = calibrate_on_batches(model, [(ids,)], log=log.info)
        ecfg = eng.EngineConfig(
            lm=cfg, weight_mode=args.weight_mode, act_bits=args.abit,
            kv_int8=not args.no_kv_int8, max_seq=args.max_seq,
            lm_head_int8=args.lm_head_int8)
        ep = eng.build_engine_params(ecfg, params_tree(model), quant,
                                     device=dev)
        del model, quant
        if args.save_engine:
            save_engine(args.save_engine, ecfg, ep)

    cb = ContinuousBatcher(
        ecfg, ep, batch_slots=args.slots,
        sampling=SamplingConfig(temperature=args.temperature,
                                top_k=args.top_k, top_p=args.top_p),
        seed=args.seed)
    t0 = time.perf_counter()
    for prompt in prompts:
        cb.submit(Request(prompt=prompt,
                          max_new_tokens=args.max_new_tokens,
                          eos_id=args.eos_id))
    done = cb.run()
    dt = time.perf_counter() - t0
    n_tokens = sum(len(c.tokens) for c in done)

    results = {"n_requests": len(done), "new_tokens": n_tokens,
               "wall_s": round(dt, 3),
               "tokens_per_s": round(n_tokens / dt, 2)}
    by_id = {c.id: c for c in done}
    for i, prompt in enumerate(prompts):
        c = by_id.get(i)
        if c is None:
            continue
        line = {"prompt": texts[i] if texts else prompt,
                "tokens": c.tokens, "finish": c.finish_reason}
        if tokenizer is not None and hasattr(tokenizer, "decode"):
            line["text"] = tokenizer.decode(c.tokens)
        print(json.dumps(line))
    print(json.dumps(results))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
