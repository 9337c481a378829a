"""Pipeline parallelism: GPipe-style microbatched stages over the ranks of
a "pp" mesh axis.

Counterpart of the reference's ``parallel/pipeline.py``. Layer stacks are
(L, ...) tensors, so a stage is a shard of the layer axis: each stage
rank holds L/P contiguous layers (:func:`shard_stage_params`). With M
microbatches and P stages the schedule runs M + P - 1 ticks; at tick t
stage p works on microbatch t - p, and each tick's activations go to the
next stage by a send and a receive around the ring (stage P - 1 to stage
0 wraps, and stage 0 ignores it: it reads fresh input). At the end every
stage receives the last stage's outputs (the reference's one-hot psum,
here a broadcast from the last stage).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from . import comm
from .mesh import P, axis_group, local_shard

__all__ = ["gpipe", "stack_spec", "shard_stage_params"]


def stack_spec():
    """The spec of (L, ...) stacked layer params: stage = layer shard."""
    return P("pp")


def shard_stage_params(params, mesh, axis: str = "pp"):
    """This stage's layers of a nested dict of (L, ...) tensors."""
    if isinstance(params, dict):
        return {k: shard_stage_params(v, mesh, axis)
                for k, v in params.items()}
    t = params if isinstance(params, torch.Tensor) else torch.as_tensor(
        params)
    return local_shard(t, mesh, (axis,))


def gpipe(stage_fn: Callable, mesh, axis: str = "pp"):
    """A pipelined apply ``(stage_params, x_mb) -> y``.

    ``stage_fn(stage_params, x)`` applies this stage's layer shard to one
    microbatch, keeping its shape. ``x_mb`` (M, ...) holds M microbatches
    (every stage passes the same; stage 0 reads it); the result (M, ...)
    has passed through every stage in order and is on every stage."""
    group = axis_group(mesh, axis)

    def apply(params_local, x_mb: torch.Tensor) -> torch.Tensor:
        n, stage = dist.get_world_size(group), dist.get_rank(group)
        M = x_mb.shape[0]
        buf = torch.zeros_like(x_mb[0])
        out = torch.zeros_like(x_mb)
        for t in range(M + n - 1):
            cur = x_mb[min(max(t, 0), M - 1)] if stage == 0 else buf
            mb = t - stage
            active = 0 <= mb < M
            y = stage_fn(params_local, cur) if active else cur
            if active and stage == n - 1:
                out[mb] = y
            if n > 1:
                nxt = torch.empty_like(y)
                buf = comm.start_exchange([(y, (stage + 1) % n)],
                                          [(nxt, (stage - 1) % n)],
                                          group).wait()[0]
        if n > 1:
            comm.broadcast(out, n - 1, group)
        return out

    return apply
