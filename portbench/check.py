"""How ``correct`` is decided: the served tokens against the plain
reference.

Once the window has closed and the program's state is freed, a sample
of the requests finished in the window, drawn from the seed, is run
through the configuration's plain reference (``reference/<family>.py``,
float32), each over its prompt and the tokens it was served. At each
served position the gap is the reference's best logit minus the
reference's logit of the token served (0 where the two agree). The
number compared is the mean gap over the sample's served tokens
(``mean_gap``), held to the cell's limit (``limits/<cell>.json``); the
widest gap is reported beside it. The widest is not compared: served
with bf16 activations, a sound program's 4-bit activation codes flip
where float32 rounds otherwise, and its widest gap lay within 1.5 to 2
times of the control's on every seed read, so no limit between them
could hold; the mean over a sample of some thousands of tokens
separates them. The sample holds the request with the longest context,
one request of each prefill bucket the window served, then requests
drawn at random until it holds the mix's ``check_tokens`` served
tokens.

The control (``control_gaps``) reads the same positions with the
reference computed one step below the configuration's precisions in the
program's place: at each position the token the lower precision puts
first, and its gap under the float32 reference.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .spec import Cell

Completion = Tuple[List[int], List[int]]         # (prompt, served tokens)
ROW_BLOCK = 128


def bucket_of(n: int, buckets: Sequence[int]) -> int:
    return next((b for b in sorted(buckets) if n <= b), -1)


def sample(done: Sequence[Completion], seed: int, mix: dict
           ) -> List[Completion]:
    if not done:
        return []
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 0x636865636B])
    order = rng.permutation(len(done)).tolist()
    longest = max(range(len(done)),
                  key=lambda i: (len(done[i][0]) + len(done[i][1]), -i))
    picked = [longest]
    for b in sorted(mix["buckets"]):
        for i in order:
            if i not in picked and bucket_of(len(done[i][0]),
                                             mix["buckets"]) == b:
                picked.append(i)
                break
    served = lambda: sum(len(done[i][1]) for i in picked)
    for i in order:
        if served() >= int(mix["check_tokens"]):
            break
        if i not in picked:
            picked.append(i)
    return [done[i] for i in picked]


def _rows(c: Completion) -> Tuple[List[int], int, List[int]]:
    """The sequence the reference reads, the first served position and
    the served tokens."""
    prompt, toks = c
    return list(prompt) + list(toks[:-1]), len(prompt) - 1, list(toks)


@torch.no_grad()
def gaps(cell: Cell, ep: dict, comps: Sequence[Completion], device,
         pick: str = "served") -> List[torch.Tensor]:
    """Per completion, the gap at each served position: of the served
    token (``pick="served"``), or of the token that the lower-precision
    reference puts first (``pick="lower"``, the control)."""
    fam = cell.reference()
    seqs = [_rows(c) for c in comps]
    h32 = fam.final_hidden(cell.config, ep, [s for s, _, _ in seqs], "f32",
                           device)
    hlo = (fam.final_hidden(cell.config, ep, [s for s, _, _ in seqs],
                            "lower", device) if pick == "lower" else None)
    out = []
    for i, (_, first, toks) in enumerate(seqs):
        g = []
        for r0 in range(0, len(toks), ROW_BLOCK):
            rows = slice(first + r0, first + min(r0 + ROW_BLOCK, len(toks)))
            ref = fam.head_logits(ep, h32[i][rows], "f32")
            if pick == "lower":
                want = fam.head_logits(ep, hlo[i][rows], "lower").argmax(-1)
            else:
                want = torch.as_tensor(toks[r0:r0 + ROW_BLOCK],
                                       device=ref.device)
            g.append(ref.amax(-1) - ref.gather(1, want[:, None])[:, 0])
            del ref
        out.append(torch.cat(g).cpu())
    return out


def gap_stats(g: List[torch.Tensor]) -> Dict[str, float]:
    """The sample's gaps summarised: their widest, quantiles, mean, and
    the share of positions that agree with the reference's best."""
    x = torch.cat(g).double()
    q = torch.quantile(x, torch.tensor([0.5, 0.9, 0.95, 0.99],
                                       dtype=torch.float64))
    return {"max": float(x.max()), "p99": float(q[3]), "p95": float(q[2]),
            "p90": float(q[1]), "p50": float(q[0]), "mean": float(x.mean()),
            "agree": float((x == 0).double().mean())}


def judge(cell: Cell, ep: dict, done: Sequence[Completion], seed: int,
          device, control: bool = False) -> Dict:
    """The verdict of one run: the sample's mean gap beside the cell's
    limit. ``control`` also reads the control's mean gap on the same
    sample (``control_gap``); the benchmark's runs never do."""
    picked = sample(done, seed, cell.mix)
    limit = cell.limits.get("mean_gap", {}).get("limit")
    if not picked:
        return {"correct": False, "mean_gap": None, "max_gap": None,
                "limit": limit, "tokens": 0, "requests": 0, "buckets": []}
    g = gaps(cell, ep, picked, device)
    stats = gap_stats(g)
    extra = {"stats": stats}
    if control:
        gc = gaps(cell, ep, picked, device, pick="lower")
        extra["control_stats"] = gap_stats(gc)
        extra["control_gap"] = extra["control_stats"]["mean"]
    return {**extra, "correct": limit is not None
            and stats["mean"] <= float(limit),
            "mean_gap": stats["mean"], "max_gap": stats["max"],
            "limit": limit,
            "tokens": int(sum(x.numel() for x in g)),
            "requests": len(picked),
            "buckets": sorted({bucket_of(len(p), cell.mix["buckets"])
                               for p, _ in picked})}
