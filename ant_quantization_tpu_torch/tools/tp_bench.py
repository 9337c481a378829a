"""Tensor-parallel serving benchmark: decode tokens/s over a (dp, tp) mesh
of ranks.

Counterpart of the reference's ``tools/tp_bench.py``: the W4A4 + INT8-KV
engine (or the bf16 one) at OPT geometry with random weights from a
seed, sharded over dp x tp ranks; one timed prefill on a fresh cache
(sequence parallel with ``--sp on``), then ``--decode`` greedy steps.
Rank 0 prints one JSON line.

  # 2 ranks on one card (gloo; collectives staged through the host)
  python -m ant_quantization_tpu_torch.tools.tp_bench --tp 2 \\
      --device cuda:0 --backend gloo --layers 2
  # one card per rank (NCCL)
  python -m ant_quantization_tpu_torch.tools.tp_bench --tp 8 --layers 32
  # CPU ranks (the plain versions of the kernels)
  python -m ant_quantization_tpu_torch.tools.tp_bench --dp 2 --tp 2 \\
      --device cpu --layers 2 --d_model 256 --n_heads 4 --vocab 512

Without ``ANT_COORDINATOR`` / ``ANT_DISTRIBUTED`` it starts its own dp x
tp ranks on this machine; with them it is one rank of that world.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..parallel import distributed as dist_rt

__all__ = ["parse_args", "build_engine_params", "bench", "main"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--tp", type=int, default=0,
                   help="0 = all remaining devices")
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--d_model", type=int, default=4096)
    p.add_argument("--n_heads", type=int, default=32)
    p.add_argument("--d_ff", type=int, default=0, help="0 = 4*d_model")
    p.add_argument("--vocab", type=int, default=50272)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prefill", type=int, default=128)
    p.add_argument("--decode", type=int, default=32)
    p.add_argument("--weight_mode", default="w4", choices=("w4", "bf16"))
    p.add_argument("--sp", default="on", choices=("on", "off"),
                   help="sequence-parallel prefill with the quantized "
                        "collective-matmul rings (engine sp_prefill)")
    p.add_argument("--output", default=None)
    p.add_argument("--device", default="cuda",
                   help="each rank's device: 'cuda' (card LOCAL_RANK), "
                        "'cuda:N' (every rank on card N) or 'cpu'")
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="default: nccl on cards, gloo on the CPU")
    return p.parse_args(argv)


def _config(args):
    from ..models.transformer_lm import LMConfig
    from ..serve.engine import EngineConfig
    max_seq = args.prefill + args.decode + 16
    lm = LMConfig(vocab_size=args.vocab, d_model=args.d_model,
                  n_layers=args.layers, n_heads=args.n_heads,
                  d_ff=args.d_ff or 4 * args.d_model, max_seq=max_seq,
                  positions="learned_offset2", activation="relu",
                  fused_qkv=False)
    w4 = args.weight_mode == "w4"
    return EngineConfig(lm=lm, weight_mode=args.weight_mode,
                        act_bits=4 if w4 else 0, kv_int8=w4,
                        sp_prefill=args.sp == "on", max_seq=max_seq)


def build_engine_params(cfg, device, seed: int = 0, shard=None) -> dict:
    """The reference's random engine params, built on ``device`` from an
    explicit generator (so every rank builds the same values), one site
    at a time, each passed through ``shard`` (a rank's
    ``shard_engine_params`` of one site) if given."""
    lm = cfg.lm
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    L, d = lm.n_layers, lm.d_model
    sites = {"q": (d, d), "k": (d, d), "v": (d, d), "out": (d, d),
             "fc_in": (d, lm.d_ff), "fc_out": (lm.d_ff, d)}
    a_q = np.linspace(-100, 100, 16).astype(np.float32).astype(
        np.int8).astype(np.float32)
    layers = {}
    for name, (K, N) in sites.items():
        e = {"bias": torch.zeros((L, N), device=device)}
        if cfg.weight_mode == "w4":
            e["w_i8"] = torch.randint(-64, 64, (L, N, K), dtype=torch.int8,
                                      device=device, generator=gen)
            e["oscale"] = torch.full((L, N), 2e-3, device=device)
            e["a_q"] = torch.tensor(np.stack([a_q] * L), device=device)
            e["a_scale"] = torch.full((L,), 0.03, device=device)
            e["a_grid"] = torch.linspace(-3.0, 3.0, 16,
                                         device=device).expand(L, 16).clone()
            e["a_alpha"] = torch.full((L,), 3.0, device=device)
        else:
            e["kernel"] = (torch.randn((L, N, K), device=device,
                                       generator=gen, dtype=torch.bfloat16)
                           * np.float32(1 / np.sqrt(K))).to(cfg.dtype)
        layers[name] = shard(name, e) if shard else e
    for name in ("ln_1", "ln_2"):
        layers[name] = {"scale": torch.ones((L, d), device=device),
                        "bias": torch.zeros((L, d), device=device)}
    top = {"wte": (torch.randn((lm.vocab_size, d), device=device,
                               generator=gen, dtype=torch.bfloat16)
                   * 0.02).to(cfg.dtype),
           "wpe": (torch.randn((cfg.max_seq + 2, d), device=device,
                               generator=gen, dtype=torch.bfloat16)
                   * 0.02).to(cfg.dtype),
           "ln_f": {"scale": torch.ones((d,), device=device),
                    "bias": torch.zeros((d,), device=device)}}
    return {"layers": layers, "top": top}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench(args) -> dict:
    """One rank's run (the world is initialized): shard, prefill, decode;
    returns the result line."""
    import torch.distributed as dist
    from ..parallel.mesh import P, axis_index, local_shard, make_mesh
    from ..serve import engine as eng
    from ..serve import sharded as sh
    world = dist.get_world_size()
    tp = args.tp or world // args.dp
    if args.dp * tp != world:
        raise ValueError(f"mesh ({args.dp}, {tp}) != {world} ranks")
    dev = dist_rt.rank_device()
    mesh = make_mesh((args.dp, tp))
    cfg = _config(args)
    tcfg = sh.tp_engine_config(cfg, mesh)
    shard = lambda name, site: sh.shard_engine_params(
        {"layers": {name: site}, "top": {}}, tcfg, mesh)["layers"][name]
    ep = build_engine_params(tcfg, dev, shard=shard)
    fwd = sh.make_sharded_forward(tcfg, mesh)
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, cfg.lm.vocab_size,
                                       (args.batch, args.prefill)))
    ids = local_shard(ids, mesh, P("dp", None)).to(dev)
    fresh = lambda: sh.shard_cache(eng.init_cache(cfg, args.batch,
                                                  device=dev), mesh)
    with torch.no_grad():
        logits, kv = fwd(ep, ids, fresh(), 0)       # warm-up
        tok = logits[:, -1:].argmax(-1)
        del kv
        kv = fresh()
        _sync(dev)
        t0 = time.perf_counter()
        logits, kv = fwd(ep, ids, kv, 0)
        tok = logits[:, -1:].argmax(-1)
        _sync(dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for step in range(args.decode):
            logits, kv = fwd(ep, tok, kv, args.prefill + step)
            tok = logits[:, -1:].argmax(-1)
        _sync(dev)
        dt = time.perf_counter() - t0
    return {"mesh": {"dp": args.dp, "tp": tp}, "devices": args.dp * tp,
            "weight_mode": args.weight_mode, "sp_prefill": args.sp == "on",
            "prefill_ms": prefill_ms,
            "decode_tokens_per_s": args.batch * args.decode / dt,
            "ms_per_step": dt / args.decode * 1e3,
            "backend": dist.get_backend(), "device": str(dev),
            "rank": dist.get_rank(),
            "dp_index": axis_index(mesh, "dp")}


def _rank(argv) -> dict:
    return bench(parse_args(argv))


def _emit(result: dict, args) -> None:
    print(json.dumps(result), flush=True)
    if args.output:
        with open(args.output, "w") as f:
            json.dump(result, f, indent=2)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    backend = args.backend or dist_rt.default_backend(args.device)
    if os.environ.get("ANT_COORDINATOR") or os.environ.get(
            "ANT_DISTRIBUTED"):
        dist_rt.initialize_from_env(backend, args.device)
        result = bench(args)
        if result["rank"] == 0:
            _emit(result, args)
        return 0
    tp = args.tp
    if not tp:
        if torch.device(args.device).type == "cpu":
            raise SystemExit("--tp 0 takes the cards' count; on the CPU "
                             "give --tp")
        tp = torch.cuda.device_count() // args.dp
    world = args.dp * tp
    if torch.device(args.device).type == "cuda":
        from .. import _ext
        _ext.build_all()        # here, so that no two ranks build at once
    results = dist_rt.run_ranks(_rank, world, (argv,), backend=backend,
                                device=args.device)
    _emit(results[0], args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
