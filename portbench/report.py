"""The result line of a run, and its lines on standard error."""

from __future__ import annotations

from typing import Dict, List

import torch


def metrics(rec, entries: List[dict]) -> Dict[str, dict]:
    """Each metric its reader finds something to read, with its unit;
    a reader that finds nothing is left out."""
    out = {}
    for m in entries:
        v = rec.cell.reader(m["name"])(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def device(rec, traced: bool) -> dict:
    d = {"platform": "gpu",
         "kind": torch.cuda.get_device_name(0) if torch.cuda.is_available()
         else "cpu",
         "count": rec.cell.chips,
         "memory_peak_bytes": rec.memory_peak_bytes}
    if traced and rec.slice is not None:
        d["busy_s"] = rec.slice.busy_s
        d["window_s"] = rec.slice.window_s
    return d


def line(rec, verdict: dict, traced: bool) -> dict:
    out = {"correct": bool(verdict["correct"]),
           "attempted": rec.window.attempted + rec.traced.attempted,
           "failed": 0,
           "metrics": metrics(rec, rec.cell.per_layer if traced
                              else rec.cell.end_to_end),
           "device": device(rec, traced)}
    if traced and rec.slice is not None:
        out["breakdown"] = {"device_ops": rec.slice.top_ops(10),
                            "idle_gaps": rec.slice.gaps(10)}
    out["check"] = {"mean_gap": {"value": verdict["mean_gap"],
                                 "limit": verdict["limit"]}}
    return out


def notes(rec, verdict: dict) -> List[str]:
    parts = ", ".join(f"{k} {v:.3f} s" for k, v in rec.setup_parts.items())
    w = rec.window
    out = [f"setup {rec.setup_s:.3f} s: {parts}",
           f"window {rec.window_s:.3f} s: {len(w.dispatches)} dispatches, "
           f"{len(w.submits)} submits, {w.tokens} tokens, "
           f"{w.attempted} requests"]
    ticks = sum(d.ticks for d in w.dispatches)
    slice_ticks = sum(d.ticks for d in rec.traced.dispatches)
    if rec.slice is not None and ticks and slice_ticks:
        # what the profiler costs the host: the slice's wall time a tick
        # against the unprofiled window's
        out.append(f"traced slice {rec.slice.window_s:.3f} s over "
                   f"{slice_ticks} ticks: "
                   f"{rec.slice.window_s * 1e3 / slice_ticks:.1f} ms a tick "
                   f"profiled, {rec.window_s * 1e3 / ticks:.1f} ms in the "
                   f"window, device busy "
                   f"{rec.slice.busy_s * 1e3 / slice_ticks:.1f} ms a tick")
    out.append(f"check {verdict.get('seconds', 0.0):.3f} s over "
               f"{verdict['requests']} requests, {verdict['tokens']} served "
               f"tokens, buckets {verdict['buckets']}, widest gap "
               f"{verdict['max_gap']} (not compared)")
    return out


def check_lines(verdict: dict) -> List[str]:
    return [f"check: mean_gap {verdict['mean_gap']} limit {verdict['limit']}"
            f" -> {'correct' if verdict['correct'] else 'NOT correct'}"]
