"""The collectives the parallel paths make, over a ``torch.distributed``
process group.

Each helper takes the group explicitly and works on the tensors of the
rank's own device. Under the ``gloo`` backend a CUDA tensor is copied to
the host, the collective runs on the host copy, and the result is copied
back: gloo's transports move host memory (its own CUDA paths stage
through pinned host buffers as well), so this is the contract of the
backend the caller chose, and it is the same for every operation. Under
``nccl`` the device tensors go to NCCL as they are. No helper picks
another backend or device.

The autograd functions at the end are the tensor-parallel pair of
Megatron-LM (``copy_to_group`` / ``reduce_from_group``) and the gather
and scatter that go with them: every rank of the group computes the same
loss, so a replicated tensor's gradient must come out whole on every
rank, not summed once more over the ranks (as the backward of
``torch.distributed.nn.functional.all_reduce`` would sum it).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["all_reduce", "all_gather", "broadcast", "start_exchange",
           "Exchange", "copy_to_group", "reduce_from_group",
           "gather_from_group", "scatter_to_group"]


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over the group, in place; returns ``t``. Under gloo a
    CUDA tensor goes through a host copy."""
    if _staged(t, group):
        h = t.detach().cpu()
        dist.all_reduce(h, group=group)
        t.copy_(h)
        return t
    dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in rank order (a new
    tensor on ``t``'s device). Under gloo a CUDA tensor goes through a
    host copy."""
    src = t.detach().contiguous()
    if _staged(src, group):
        src = src.cpu()
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def broadcast(t: torch.Tensor, src_index: int, group) -> torch.Tensor:
    """``t`` of the group's ``src_index``-th rank, on every rank, in
    place; returns ``t``."""
    src = dist.get_global_rank(group, src_index)
    if _staged(t, group):
        h = t.detach().cpu()
        dist.broadcast(h, src, group=group)
        t.copy_(h)
        return t
    dist.broadcast(t, src, group=group)
    return t


class Exchange:
    """Point-to-point sends and receives in flight (``start_exchange``);
    ``wait()`` returns the received tensors on the rank's device."""

    def __init__(self, works, recvs: List[torch.Tensor],
                 targets: List[torch.Tensor]):
        self._works, self._recvs, self._targets = works, recvs, targets

    def wait(self) -> List[torch.Tensor]:
        for w in self._works:
            w.wait()
        return [r if r is t else t.copy_(r)
                for r, t in zip(self._recvs, self._targets)]


def start_exchange(sends: Sequence[Tuple[torch.Tensor, int]],
                   recvs: Sequence[Tuple[torch.Tensor, int]],
                   group) -> Exchange:
    """Post sends of ``(tensor, peer index)`` and receives into
    ``(buffer, peer index)`` in one ``batch_isend_irecv``; peers are
    indices in ``group``. Under gloo CUDA tensors are sent from host
    copies and received into host buffers, copied to the device by
    ``wait()``."""
    ops, bufs, targets = [], [], []
    for t, peer in sends:
        src = t.detach().contiguous()
        if _staged(src, group):
            src = src.cpu()
        ops.append(dist.P2POp(dist.isend, src,
                              dist.get_global_rank(group, peer), group))
    for t, peer in recvs:
        buf = torch.empty(t.shape, dtype=t.dtype) if _staged(t, group) \
            else t
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(group, peer), group))
        bufs.append(buf)
        targets.append(t)
    works = dist.batch_isend_irecv(ops) if ops else []
    return Exchange(works, bufs, targets)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        n, i = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(n, dim=ctx.dim)[i].contiguous(), None, None


class _ScatterToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n, i = dist.get_world_size(group), dist.get_rank(group)
        return x.chunk(n, dim=dim)[i].contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over the group (the
    input of a column-parallel product)."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group forward; identity backward (the output of a
    row-parallel product)."""
    return _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group, dim: int = -1
                      ) -> torch.Tensor:
    """All-gather along ``dim`` forward; the backward keeps this rank's
    slice of the gradient."""
    return _GatherFromGroup.apply(x, group, dim % x.ndim)


def scatter_to_group(x: torch.Tensor, group, dim: int = -1
                     ) -> torch.Tensor:
    """This rank's slice along ``dim`` forward; the backward all-gathers
    the gradient."""
    return _ScatterToGroup.apply(x, group, dim % x.ndim)
