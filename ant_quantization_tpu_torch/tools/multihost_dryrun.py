"""Multi-host dryrun: the torch.distributed runtime end to end.

Counterpart of the reference's ``tools/multihost_dryrun.py``. Run without
``--worker`` it starts ``--num-processes`` "hosts" of
``--devices-per-process`` ranks each on this machine (one process per
rank; a host is ``LOCAL_WORLD_SIZE`` consecutive ranks), gloo on the CPU
by default. Every rank

  1. initializes from the environment (``ANT_COORDINATOR`` and friends),
  2. builds the hybrid (dp over hosts, tp within a host) mesh,
  3. loads its host's data shard (``process_shard``) and takes its rows
     (``host_batch_to_global``),
  4. takes one SGD(1e-3) cross-entropy step of the tensor-parallel
     flagship LM (OliVe W4A4 fake-quant) with the data-parallel gradients
     averaged over dp, and checks it against the same step of the whole
     model in one process (the loss, and every shard's update),
  5. checks that the loss is the same on every rank (rank 0's, broadcast),
  6. serves one prefill and one decode step through the tensor-parallel
     engine and holds the logits to the one-process engine (2e-4; on a
     card the flagship's heads of 16 run on the card's attention
     kernels),

and prints ``SERVING OK`` and ``MULTIHOST OK``; the launcher prints
``MULTIHOST DRYRUN PASSED`` when every rank did.

  python -m ant_quantization_tpu_torch.tools.multihost_dryrun \\
      --num-processes 2 --devices-per-process 2          # 4 CPU ranks
  python -m ant_quantization_tpu_torch.tools.multihost_dryrun \\
      --device cuda --num-processes 2 --devices-per-process 1
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

__all__ = ["flagship", "worker", "launch", "main"]

LR = 1e-3
SERVE_TOL = 2e-4
LOSS_RTOL = 1e-4
# each shard's SGD update against the one-process update, as a share of
# the latter's norm (f32 sums in other orders give about 1e-6; a gradient
# off by the group's size would miss by 1 or more)
UPDATE_RTOL = 1e-4


def flagship(n_layers: int = 2, d_model: int = 128, vocab: int = 512):
    """The reference's flagship LM (``__graft_entry__.py:_flagship``): a
    GPT-2-style ``TransformerLM`` (learned positions, fused qkv,
    gelu_new, 8 heads, d_ff 4 d_model, max_seq 256) with OliVe
    ant-int-flint W4A4 at the fast-init bounds."""
    from ..models.transformer_lm import LMConfig
    from ..nn.config import QuantConfig
    cfg = LMConfig(vocab_size=vocab, d_model=d_model, n_layers=n_layers,
                   n_heads=8, d_ff=4 * d_model, max_seq=256,
                   positions="learned", activation="gelu_new",
                   fused_qkv=True)
    qcfg = QuantConfig(mode="ant-int-flint", family="olive",
                       w_low=100, w_up=101, a_low=100, a_up=101)
    return cfg, qcfg


def _model(cfg, qcfg, calib_ids):
    """The flagship on the CPU from seed 0, calibrated on ``calib_ids``
    (every rank builds the same one)."""
    from ..models.transformer_lm import TransformerLM
    from ..nn.layers import calibrating
    torch.manual_seed(0)
    model = TransformerLM(cfg, qcfg, device="cpu")
    with torch.no_grad(), calibrating(model):
        model(torch.as_tensor(calib_ids))
    return model


def _lm_loss(logits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    from ..harness.train import cross_entropy
    return cross_entropy(logits[:, :-1], ids[:, 1:]).mean()


def worker(args) -> None:
    import torch.distributed as dist
    from ..models.transformer_lm import TransformerLM, params_tree, tp_logits
    from ..nn.layers import quant_tree
    from ..parallel import comm
    from ..parallel import distributed as rt
    from ..parallel.mesh import (LM_PARAM_RULES, LM_QUANT_RULES, P,
                                 axis_group, axis_index, axis_size,
                                 local_shard, shard_pytree)

    rt.initialize_from_env(args.backend, args.device)
    dev = rt.rank_device()
    rank = dist.get_rank()
    host, n_hosts = rt.process_shard()
    mesh = rt.make_hybrid_mesh(dcn_axis="dp", ici_axes=("tp",))
    dp, tp = axis_size(mesh, "dp"), axis_size(mesh, "tp")
    _check(dp == n_hosts, f"dp {dp} != {n_hosts} hosts")
    print(f"[{rank}] mesh=(dp={dp}, tp={tp}) host={host}/{n_hosts} "
          f"device={dev} backend={dist.get_backend()}", flush=True)

    cfg, qcfg = flagship()
    B_global, T = 4 * n_hosts, 16
    all_ids = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                (B_global, T))
    per_host = B_global // n_hosts
    host_rows = all_ids[host * per_host:(host + 1) * per_host]
    ids = rt.host_batch_to_global(host_rows, mesh, P("dp", None))
    model = _model(cfg, qcfg, all_ids[:2])
    full_params = params_tree(model)
    params = shard_pytree(full_params, mesh, LM_PARAM_RULES)
    quant = shard_pytree(quant_tree(model), mesh,
                         LM_QUANT_RULES + LM_PARAM_RULES)

    # one SGD step: the dp-average of the ranks' gradients
    leaves = _leaves(params)
    for t in leaves.values():
        t.requires_grad_(True)
    tp_model = TransformerLM(cfg, qcfg, device=dev)
    loss = _lm_loss(tp_logits(tp_model, params, quant, ids,
                              axis_group(mesh, "tp")), ids)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    dp_group = axis_group(mesh, "dp")
    upd, new = {}, {}
    for (path, p), g in zip(leaves.items(), grads):
        upd[path] = -LR * (comm.all_reduce(g.clone(), dp_group) / dp)
        new[path] = (p + upd[path]).detach()
    gloss = comm.all_reduce(loss.detach().clone(), dp_group) / dp
    loss_v = float(gloss)
    _check(np.isfinite(loss_v), f"loss {loss_v}")
    loss0 = float(comm.broadcast(gloss.clone(), 0, dist.group.WORLD))
    _check(abs(loss_v - loss0) < 1e-6, f"loss {loss_v} != rank 0's {loss0}")

    # the same step of the whole model in one process, on the CPU
    ref_loss = _lm_loss(model(torch.as_tensor(all_ids)),
                        torch.as_tensor(all_ids))
    named = dict(model.named_parameters())
    ref_grads = torch.autograd.grad(ref_loss, list(named.values()))
    worst = 0.0
    for name, g in zip(named, ref_grads):
        path = name.replace(".", "/")
        mine = upd[path].cpu()
        want = local_shard(-LR * g, mesh, _spec(path, g.ndim,
                                                LM_PARAM_RULES))
        err = float((mine - want).norm() / want.norm().clamp_min(1e-30))
        worst = max(worst, err)
    ref_v = float(ref_loss.detach())
    _check(abs(loss_v - ref_v) <= LOSS_RTOL * abs(ref_v),
           f"loss {loss_v} against one process's {ref_v}")
    _check(worst <= UPDATE_RTOL, f"a shard's update off one process's by "
           f"{worst} of its norm")

    _serve_check(cfg, qcfg, model, mesh, dev, host, n_hosts, rank)
    rt.sync_global_devices("dryrun_done")
    print(f"[{rank}] MULTIHOST OK loss={loss_v:.6f} "
          f"update_rel_err={worst:.3e} tp_index={axis_index(mesh, 'tp')}",
          flush=True)
    rt.shutdown()


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


def _spec(path: str, ndim: int, rules):
    from ..parallel.mesh import _clip_spec, spec_for_path
    return tuple(_clip_spec(spec_for_path(path, rules), ndim))


def _serve_check(cfg, qcfg, model, mesh, dev, host, n_hosts, rank) -> None:
    """One prefill and one decode step of the tensor-parallel engine over
    the same mesh (batch over the hosts, heads over a host's ranks),
    against the one-process engine on the full batch (the flagship's
    eight heads of 16 on the card as on the CPU)."""
    from ..models.transformer_lm import params_tree
    from ..nn.layers import quant_tree
    from ..serve import engine as E
    from ..serve import sharded as shd
    ecfg = E.EngineConfig(lm=cfg, weight_mode="w4", act_bits=4,
                          kv_int8=True, max_seq=32, dtype=torch.float32)
    ep = E.build_engine_params(ecfg, params_tree(model), quant_tree(model),
                               device=dev)
    B_loc, T = 2, 8
    sids = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B_loc * n_hosts, T)), device=dev)
    with torch.no_grad():
        kv_ref = E.init_cache(ecfg, B_loc * n_hosts, device=dev)
        ref1, _ = E.forward(ecfg, ep, sids, kv_ref, 0)
        tok = ref1[:, -1:].argmax(-1)
        ref2, _ = E.forward(ecfg, ep, tok, kv_ref, T)
        tcfg = shd.tp_engine_config(ecfg, mesh)
        eps = shd.shard_engine_params(ep, tcfg, mesh)
        kv = shd.shard_cache(E.init_cache(ecfg, B_loc * n_hosts,
                                          device=dev), mesh)
        rows = slice(host * B_loc, (host + 1) * B_loc)
        fwd = shd.make_sharded_forward(tcfg, mesh)
        log1, kv = fwd(eps, sids[rows], kv, 0)
        log2, kv = fwd(eps, log1[:, -1:].argmax(-1), kv, T)
    err = float((log2 - ref2[rows]).abs().max())
    np.testing.assert_allclose(log2.cpu().numpy(),
                               ref2[rows].cpu().numpy(),
                               rtol=SERVE_TOL, atol=SERVE_TOL)
    print(f"[{rank}] SERVING OK decode logits match single-process "
          f"(max abs err {err:.3e})", flush=True)


def launch(args) -> int:
    from ..parallel.distributed import free_port
    world = args.num_processes * args.devices_per_process
    port = args.port or free_port()
    if torch.device(args.device).type == "cuda":
        from .. import _ext
        _ext.build_all()        # here, so that no two ranks build at once
    env_base = dict(os.environ)
    procs = []
    for rank in range(world):
        env = dict(env_base)
        env.update(ANT_COORDINATOR=f"127.0.0.1:{port}",
                   ANT_NUM_PROCESSES=str(world),
                   ANT_PROCESS_ID=str(rank),
                   LOCAL_WORLD_SIZE=str(args.devices_per_process),
                   LOCAL_RANK=str(rank % args.devices_per_process),
                   PYTHONPATH=REPO + os.pathsep + env_base.get(
                       "PYTHONPATH", ""))
        cmd = [sys.executable, "-m",
               "ant_quantization_tpu_torch.tools.multihost_dryrun",
               "--worker", "--device", args.device]
        if args.backend:
            cmd += ["--backend", args.backend]
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    rc = 0
    try:
        for rank, p in enumerate(procs):
            out, _ = p.communicate(timeout=args.timeout)
            ok = p.returncode == 0 and "MULTIHOST OK" in out
            print(f"--- rank {rank} rc={p.returncode} ---")
            print("\n".join(out.splitlines()[-8:]), flush=True)
            if not ok:
                rc = 1
    except subprocess.TimeoutExpired:
        rc = 1
        print(f"timed out after {args.timeout} s", flush=True)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print("MULTIHOST DRYRUN " + ("PASSED" if rc == 0 else "FAILED"),
          flush=True)
    return rc


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", action="store_true",
                    help="run as one rank (started by the launcher)")
    ap.add_argument("--num-processes", type=int, default=2,
                    help="hosts to emulate")
    ap.add_argument("--devices-per-process", type=int, default=4,
                    help="ranks per host (the tp axis)")
    ap.add_argument("--port", type=int, default=0,
                    help="rendezvous port (0: a free one)")
    ap.add_argument("--timeout", type=int, default=600)
    ap.add_argument("--device", default="cpu",
                    help="each rank's device: 'cpu', 'cuda' (card "
                         "LOCAL_RANK) or 'cuda:N'")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="default gloo (ranks may share a card)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    args.backend = args.backend or "gloo"
    if args.worker:
        torch.set_num_threads(1)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        worker(args)
        return 0
    return launch(args)


if __name__ == "__main__":
    raise SystemExit(main())
