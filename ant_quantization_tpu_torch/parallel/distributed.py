"""Multi-process runtime on ``torch.distributed``.

Counterpart of the reference's ``parallel/distributed.py``. There one
process per host sees every device of the host; here one process drives
one device, a rank, as ``torch.distributed`` has it, so the reference's
process counts are rank counts and its hosts are groups of
``LOCAL_WORLD_SIZE`` consecutive ranks.

The backend is named by the caller, ``"nccl"`` or ``"gloo"``:

- NCCL needs one card per rank. Two ranks on one card are refused up
  front, before NCCL is touched: the ranks publish their (host, card)
  through the rendezvous store and compare.
- gloo runs anywhere, the CPU or CUDA tensors; its collectives move host
  memory, so the helpers of ``parallel/comm.py`` stage CUDA tensors
  through the host. Two gloo ranks may share one card.

Usage (every CLI calls :func:`initialize_from_env` after parsing its
arguments)::

  # explicit rendezvous, one line per rank
  ANT_COORDINATOR=10.0.0.2:8476 ANT_NUM_PROCESSES=4 ANT_PROCESS_ID=$i \\
      python -m ant_quantization_tpu_torch.tools.clm_eval ...
  # under a launcher that sets RANK, WORLD_SIZE, LOCAL_WORLD_SIZE,
  # MASTER_ADDR and MASTER_PORT (torchrun)
  ANT_DISTRIBUTED=1 torchrun --nproc-per-node 4 -m \\
      ant_quantization_tpu_torch.tools.clm_eval ...

Where the caller names none, :func:`default_backend` takes NCCL for a
CUDA device and gloo for the CPU; ranks that share a card name gloo.

:func:`run_ranks` starts a world of ranks on this machine (the ``spawn``
start method: the parent may hold a CUDA context) and returns what each
rank's function returned.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["initialize", "initialize_from_env", "default_backend",
           "shutdown",
           "is_multiprocess", "process_shard", "rank_device",
           "device_mesh", "make_hybrid_mesh", "host_batch_to_global",
           "sync_global_devices", "free_port", "run_ranks"]

_STATE = {"backend": None, "device": None, "local_world_size": 1}
BACKENDS = ("nccl", "gloo")


def _parse_device(device, backend: str, local_rank: int) -> torch.device:
    """The rank's device, read without touching CUDA: a bare "cuda" is
    card ``local_rank``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device per rank; "
                         "CPU ranks take backend='gloo'")
    return dev


def _check_one_rank_per_card(store, world: int, rank: int,
                             dev: torch.device) -> None:
    """Refuse NCCL with two ranks on one card: each rank publishes its
    (host, visible devices, card index); every rank reads them all before
    any of them raises."""
    tag = "|".join((socket.gethostname(),
                    os.environ.get("CUDA_VISIBLE_DEVICES", ""),
                    str(dev.index)))
    store.set(f"ant/card/{rank}", tag)
    tags = [store.get(f"ant/card/{r}").decode() for r in range(world)]
    store.set(f"ant/read/{rank}", "1")
    store.wait([f"ant/read/{r}" for r in range(world)])
    same = [r for r in range(world) if r != rank and tags[r] == tag]
    if same:
        raise ValueError(
            f"NCCL needs one card per rank, but ranks {[rank] + same} all "
            f"drive {dev} on host {socket.gethostname()}; ranks that share "
            "a card take backend='gloo'")


def initialize(coordinator: str, num_processes, process_id, backend: str,
               device=None, local_world_size=None,
               timeout_s: float = 600.0) -> bool:
    """Join this process to a world of ``num_processes`` ranks as rank
    ``process_id``, through a TCP rendezvous at ``coordinator``
    ("host:port"; rank 0 serves it), on ``backend``. ``device`` is the
    rank's device (default "cuda": card ``LOCAL_RANK``); the ranks of a
    host are ``local_world_size`` consecutive ranks (default the
    ``LOCAL_WORLD_SIZE`` variable, else the whole world). Returns True if
    it initialized, False if this process already had joined a world."""
    if dist.is_initialized():
        return False
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    world, rank = int(num_processes), int(process_id)
    lws = int(local_world_size or os.environ.get("LOCAL_WORLD_SIZE")
              or world)
    if world % lws or not 0 <= rank < world:
        raise ValueError(f"rank {rank} of a world of {world} in hosts of "
                         f"{lws} ranks")
    dev = _parse_device(device, backend, rank % lws)
    host, _, port = coordinator.rpartition(":")
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host or "localhost", int(port), world, rank == 0,
                          timeout)
    if backend == "nccl":
        _check_one_rank_per_card(store, world, rank, dev)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' (with backend='gloo')")
        if dev.index >= torch.cuda.device_count():
            raise ValueError(f"rank {rank} asks for {dev}, but the host "
                             f"has {torch.cuda.device_count()} card(s)")
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, world_size=world,
                            rank=rank, timeout=timeout)
    _STATE.update(backend=backend, device=dev, local_world_size=lws)
    return True


def default_backend(device=None) -> str:
    """NCCL for a CUDA device (the default "cuda"), gloo for the CPU."""
    return "gloo" if torch.device(device or "cuda").type == "cpu" \
        else "nccl"


def initialize_from_env(backend: Optional[str] = None, device=None) -> bool:
    """The CLIs' entry: a no-op unless the environment asks for a world.

    ``ANT_COORDINATOR`` (host:port) with ``ANT_NUM_PROCESSES`` and
    ``ANT_PROCESS_ID``: an explicit rendezvous. ``ANT_DISTRIBUTED=1``: a
    launcher's ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT`` (and ``LOCAL_WORLD_SIZE``), which must all be set.
    ``backend`` defaults to :func:`default_backend` of the device."""
    env = os.environ
    backend = backend or default_backend(device)
    if env.get("ANT_COORDINATOR"):
        return initialize(env["ANT_COORDINATOR"], env["ANT_NUM_PROCESSES"],
                          env["ANT_PROCESS_ID"], backend, device)
    if env.get("ANT_DISTRIBUTED") == "1":
        need = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
        missing = [k for k in need if k not in env]
        if missing:
            raise RuntimeError(
                "ANT_DISTRIBUTED=1 reads a launcher's RANK, WORLD_SIZE, "
                "MASTER_ADDR and MASTER_PORT (torchrun sets them); missing: "
                + ", ".join(missing))
        return initialize(f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                          env["WORLD_SIZE"], env["RANK"], backend, device,
                          env.get("LOCAL_WORLD_SIZE"))
    return False


def shutdown() -> None:
    """Leave the world (a no-op outside one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(backend=None, device=None, local_world_size=1)


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def process_shard() -> Tuple[int, int]:
    """(host index, host count): the data shard of this rank's host, so
    that the ranks of one host read the same rows (the harness readers'
    ``shard=``). (0, 1) outside a world."""
    if not dist.is_initialized():
        return 0, 1
    lws = _STATE["local_world_size"]
    return dist.get_rank() // lws, dist.get_world_size() // lws


def rank_device() -> Optional[torch.device]:
    """The device this rank drives (None outside a world)."""
    return _STATE["device"]


def device_mesh(shape: Sequence[int], axis_names: Sequence[str]):
    """A ``DeviceMesh`` of the world's ranks in row-major order. Its
    device type is the backend's: "cuda" under NCCL, "cpu" under gloo
    (whose groups also carry the CUDA tensors of ranks on cards)."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("no world: call parallel.distributed.initialize "
                           "first (one process per rank)")
    world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh {tuple(shape)} != {world} ranks")
    kind = "cuda" if _STATE["backend"] == "nccl" else "cpu"
    ranks = torch.arange(world).reshape(tuple(shape))
    return DeviceMesh(kind, ranks, mesh_dim_names=tuple(axis_names))


def make_hybrid_mesh(ici_shape: Optional[Tuple[int, ...]] = None,
                     dcn_axis: str = "dp",
                     ici_axes: Tuple[str, ...] = ("tp",),
                     local_world_size: Optional[int] = None):
    """A (hosts, *ici_shape) mesh: the first axis spans hosts, the others
    stay among one host's ranks (tensor-parallel collectives every step
    ride the host's links; the data axis crosses hosts once a step).
    ``ici_shape`` defaults to all of a host's ranks on the first ici
    axis; hosts are ``local_world_size`` (default: as initialized)
    consecutive ranks."""
    lws = int(local_world_size or _STATE["local_world_size"])
    world = dist.get_world_size()
    if world % lws:
        raise ValueError(f"{world} ranks in hosts of {lws}")
    if ici_shape is None:
        ici_shape = (lws,) + (1,) * (len(ici_axes) - 1)
    if int(np.prod(ici_shape)) != lws:
        raise ValueError(f"ici shape {ici_shape} != {lws} ranks a host")
    return device_mesh((world // lws,) + tuple(ici_shape),
                       (dcn_axis,) + tuple(ici_axes))


def host_batch_to_global(batch, mesh, spec, dcn_axis: str = "dp"):
    """This rank's rows of a host's batch, on the rank's device.

    ``batch`` (a tensor, an array or a dict of them) is this host's piece
    of the global batch, split by ``spec`` (``mesh.PartitionSpec``) over
    the host axis ``dcn_axis``; it is split further by ``spec``'s other,
    host-local axes to give this rank's piece."""
    from .mesh import local_shard
    dev = rank_device()

    def one(x):
        x = torch.as_tensor(np.asarray(x)) if not isinstance(
            x, torch.Tensor) else x
        parts = tuple(tuple(a for a in (p if isinstance(p, tuple) else (p,))
                            if a not in (None, dcn_axis)) or None
                      for p in spec)
        local = local_shard(x, mesh, parts)
        return local.to(dev) if dev is not None else local

    if isinstance(batch, dict):
        return {k: host_batch_to_global(v, mesh, spec, dcn_axis)
                for k, v in batch.items()}
    return one(batch)


def sync_global_devices(tag: str = "barrier") -> None:
    """A barrier of the whole world (a no-op at one rank). ``tag`` names
    it, as in the reference; torch's barrier takes no name."""
    if is_multiprocess():
        if _STATE["backend"] == "nccl":
            dist.barrier(device_ids=[rank_device().index])
        else:
            dist.barrier()


def free_port() -> int:
    """A TCP port that is free on this host now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _numpy(obj):
    """Tensors in ``obj`` as numpy arrays (results cross the process
    boundary by pickle)."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return t.numpy() if t.dtype != torch.bfloat16 else \
            t.to(torch.float32).numpy()
    if isinstance(obj, dict):
        return {k: _numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_numpy(v) for v in obj)
    return obj


def _rank_main(rank: int, world: int, port: int, backend: str, device,
               lws: int, threads: Optional[int], fn: Callable, args: tuple,
               results) -> None:
    try:
        if threads:
            torch.set_num_threads(threads)
        initialize(f"127.0.0.1:{port}", world, rank, backend, device, lws)
        out = fn(*args)
        results.put((rank, True, _numpy(out)))
    except Exception:               # reported to the parent, then exit
        results.put((rank, False, traceback.format_exc()))
    finally:
        shutdown()


def run_ranks(fn: Callable, world: int, args: tuple = (), *,
              backend: str = "gloo", device="cpu",
              local_world_size: Optional[int] = None,
              threads: Optional[int] = None,
              timeout_s: float = 600.0) -> List[Any]:
    """Start ``world`` ranks on this machine (``spawn``), each joining one
    world on ``backend`` with ``device`` (a bare "cuda" is card
    ``LOCAL_RANK``) and calling ``fn(*args)``; returns the results by
    rank (tensors as numpy). ``fn`` must be importable by name (a
    module's top-level function). Raises with the first failing rank's
    traceback (the others may be waiting on it); stops every rank it
    started."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    lws = local_world_size or world
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, backend, device, lws,
                               threads, fn, args, results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got: dict = {}
    errors: List[str] = []
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) + len(errors) < world:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead and results.empty():
                    errors.append(f"rank(s) {dead} died (exit codes "
                                  f"{[procs[r].exitcode for r in dead]})")
                    break
                if time.monotonic() > deadline:
                    errors.append(f"timed out after {timeout_s} s")
                    break
                continue
            if not ok:
                # the others may wait on it in a collective: stop them
                errors.append(f"rank {rank}:\n{out}")
                break
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 5)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    if errors:
        raise RuntimeError("ranks failed:\n" + "\n".join(errors))
    return [got[r] for r in range(world)]
