"""Speculative decoding benchmark on the card.

Counterpart of the reference's ``tools/spec_bench.py``. Without trained
weights a random-weight draft accepts ~nothing, so the meaningful
measurements are the speculative MECHANICS, end-to-end on the card:

  t_plain   one full-depth target decode step (T=1)
  t_verify  one target verify step over T=k+1 positions (the amortized
            weight read — near t_plain on a memory-bound engine)
  t_draft   one draft decode step
  e2e       a real SpeculativeDecoder.generate run (random draft, so
            accept ~ 0: the measured WORST case incl. host loop)

and the modeled net curve  tok/s(a) = B (1 + a*k) / (k*t_draft + t_verify)
with its break-even accept rate vs plain decode (:func:`spec_model`).
Each step time is a fenced loop of forwards at a fixed position, each
forward a Python call that launches its kernels from the host; the e2e
loop also reads each round's accepted counts on the host, whatever the
number of rounds per call. ``accept_rate`` is the reference's: the mean
over rounds of the drafts accepted in the batch, over k (the
per-sequence rate times the batch).

The params are ``lm_bench``'s random W4A4 + INT8-KV + int8-head engine
at OPT-6.7B's geometry (bench.py's ``_lm``), target and draft of the
same width, seeds 0 and 1.

Usage: python -m ant_quantization_tpu_torch.tools.spec_bench \\
    [--layers 32 --k 4] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Tuple

import numpy as np
import torch

from .._ext import resolve_device
from ..models.transformer_lm import LMConfig
from ..serve import engine as eng
from ..serve.speculative import SpeculativeDecoder
from ..utils.profiling import fence
from .lm_bench import rand_engine_params

__all__ = ["DECODE_STEPS", "ACCEPT_RATES", "spec_model", "main"]

# bench.py's decode steps: its engines' max_seq is prefill + 64 + 32
DECODE_STEPS = 64
ACCEPT_RATES = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)


def _lm(n_layers: int, max_seq: int) -> LMConfig:
    """bench.py's OPT-6.7B geometry at ``n_layers``."""
    return LMConfig(vocab_size=50272, d_model=4096, n_layers=n_layers,
                    n_heads=32, d_ff=16384, max_seq=max_seq,
                    positions="learned_offset2", activation="relu",
                    fused_qkv=False)


def spec_model(t_plain: float, t_verify: float, t_draft: float, k: int,
               batch: int) -> Tuple[Dict[str, float], float]:
    """The modeled speculative tokens/s at each accept rate a of
    ACCEPT_RATES, batch (1 + a k) / (k t_draft + t_verify), keyed
    "a=0.0".., and the break-even accept rate against plain decode
    (batch / t_plain), clipped at 0; unrounded."""
    round_cost = k * t_draft + t_verify
    model = {f"a={a:.1f}": batch * (1 + a * k) / round_cost
             for a in ACCEPT_RATES}
    return model, max(0.0, (round_cost / t_plain - 1) / k)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--draft-layers", type=int, default=6)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prefill", type=int, default=512)
    ap.add_argument("--rounds", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    max_seq = args.prefill + DECODE_STEPS + 32

    def mkcfg(n_layers):
        return eng.EngineConfig(
            lm=_lm(n_layers, max_seq), weight_mode="w4", act_bits=4,
            kv_int8=True, max_seq=max_seq, lm_head_int8=True)

    tcfg, dcfg = mkcfg(args.layers), mkcfg(args.draft_layers)
    tep = rand_engine_params(tcfg, 0, dev)
    dep = rand_engine_params(dcfg, 1, dev)
    B, T0 = args.batch, args.prefill
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    ids = torch.randint(0, tcfg.lm.vocab_size, (B, T0), device=dev,
                        generator=gen)

    @torch.no_grad()
    def step_time(cfg, ep, T, reps=48):
        """One decode/verify step of width T: a fenced loop of ``reps``
        forwards at a FIXED position (no cache growth effects), after a
        warm loop."""
        kv = eng.init_cache(cfg, B, dev)
        logits, _ = eng.forward(cfg, ep, ids, kv, 0)
        tok = torch.argmax(logits[:, -T:], dim=-1)

        def loop(tok):
            for _ in range(reps):
                lg, _ = eng.forward(cfg, ep, tok, kv, T0)
                tok = torch.argmax(lg, dim=-1)
            return tok

        tok = loop(tok)
        fence(tok)
        t0 = time.perf_counter()
        fence(loop(tok))
        return (time.perf_counter() - t0) / reps

    t_plain = step_time(tcfg, tep, 1)
    t_verify = step_time(tcfg, tep, args.k + 1)
    t_draft = step_time(dcfg, dep, 1)

    # end-to-end generate (random draft: accept ~ 0, worst case), at one
    # round per call and at 8 rounds per call
    e2e = {}
    for rpd in (1, 8):
        sd = SpeculativeDecoder(tcfg, tep, dcfg, dep, k=args.k)
        # the warm-up emits enough tokens to run a group of rpd rounds
        # (generate takes one only when `need >= rpd`)
        sd.generate(ids[:, :8], rpd + 2, rounds_per_dispatch=rpd)
        t0 = time.perf_counter()
        out = sd.generate(ids, args.rounds, rounds_per_dispatch=rpd)
        dt = time.perf_counter() - t0
        n_tok = sum(len(o) for o in out)
        e2e[rpd] = (n_tok / dt,
                    (np.mean(sd.accepted_hist) / args.k)
                    if sd.accepted_hist else 0.0)
    (r1_tok_s, acc), (r8_tok_s, _) = e2e[1], e2e[8]

    k = args.k
    model, break_even = spec_model(t_plain, t_verify, t_draft, k, B)
    print(json.dumps({
        "t_plain_ms": round(t_plain * 1e3, 2),
        "t_verify_ms": round(t_verify * 1e3, 2),
        "t_draft_ms": round(t_draft * 1e3, 2),
        "plain_tok_s": round(B / t_plain, 1),
        "modeled_spec_tok_s": {a: round(v, 1) for a, v in model.items()},
        "break_even_accept": round(break_even, 3),
        "e2e_random_draft": {
            "tok_s_dispatch_per_round": round(r1_tok_s, 1),
            "tok_s_8_rounds_per_dispatch": round(r8_tok_s, 1),
            "accept_rate": round(float(acc), 3),
            "note": "random draft: accept ~0 (worst case); every round "
                    "launches each forward's kernels from the host and "
                    "reads its accepted counts there, at 1 and at 8 "
                    "rounds per call alike (a Python loop), so both "
                    "rates pay the host's dispatch"},
        "k": k, "layers": args.layers,
        "draft_layers": args.draft_layers}), flush=True)


if __name__ == "__main__":
    main()
