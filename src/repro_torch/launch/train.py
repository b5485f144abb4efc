"""End-to-end training driver (port of src/repro/launch/train.py): data ->
microbatched train step -> checkpoints, with fault containment, straggler
monitoring and elastic data-parallel re-sharding, on the card unless
``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b --reduced \\
        --steps 50 --device cpu --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b --reduced \\
        --steps 20 --device cpu --mesh single --dp-size 2 [--grad-compression int8_ag]
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --mesh single \\
        --dp-size 2 --model-size 2 --device cpu

``--mesh single|multi`` runs W ranks of a mesh
(`launch.mesh.make_driver_mesh`: ``single`` (data W / M, model M),
``multi`` (pod 2, data W / 2M, model M), the port's stand-ins for the
reference's 16 x 16 and 2 x 16 x 16 TPU pods, ``--model-size`` M standing
in for their model axis of 16 as ``--dp-size`` does for their dp ranks):
under ``torchrun`` every rank runs `main` (W is the world size); otherwise
`main` spawns ``--dp-size`` x ``--model-size`` ranks (`launch.mesh.spawn`)
and returns rank 0's losses. The params are drawn at the model axis's
padded dims (``init_params(0, cfg, tp=M)``). Every rank draws the whole batch (``shard=0,
num_shards=1``, as the reference) and keeps its rows
(`launch.steps.build_train_step`); rank 0 logs and writes the checkpoints
(whole arrays, `checkpoint.CheckpointManager`); a failed step restores every
rank from the newest complete checkpoint (the failure injector's
``REPRO_INJECT_FAIL_AT`` is in every rank's environment, so it fires on all
of them at the same step).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.data import DataConfig, SyntheticLM, prefix_embeds_stub
from repro_torch.launch.fault_tolerance import (
    FailureInjector,
    RunGuard,
    StragglerMonitor,
    heartbeat_file,
)
from repro_torch.core.tree import tree_map
from repro_torch.launch.mesh import dp_axes, driver_shape, make_driver_mesh, spawn
from repro_torch.launch.steps import build_train_step
from repro_torch.models import init_params
from repro_torch.models.parallel import ParallelCtx
from repro_torch.optim import init_state


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--mesh", default="none", choices=["none", "single", "multi"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--dp-size", type=int, default=1,
                    help="data-parallel ranks to spawn for --mesh single|multi outside torchrun")
    ap.add_argument("--model-size", type=int, default=1,
                    help="the mesh's model axis (tensor-parallel ranks) for --mesh single|multi")
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8_ag"])
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None, *, params=None):
    """Train and return the list of step losses (rank 0's). ``params``: the
    initial parameter tree (whole f32 masters; on one rank written in
    place; drawn at ``--model-size``'s padded dims), else ``init_params(0,
    cfg, tp=--model-size)`` on the device."""
    import torch.distributed as dist

    args = _parser().parse_args(argv)
    if args.mesh != "none" and not dist.is_initialized() and "WORLD_SIZE" not in os.environ:
        world = args.dp_size * args.model_size
        shape = driver_shape(args.mesh, world, args.model_size)
        if params is not None:
            params = tree_map(lambda t: t.detach().to("cpu"), params)
        argv = list(sys.argv[1:] if argv is None else argv)
        return spawn(_rank_main, shape, args.device, argv, params)[0]
    if args.mesh == "none" and args.model_size != 1:
        raise ValueError("--model-size needs --mesh single or multi")
    return _train(args, make_driver_mesh(args.mesh, args.device, args.model_size), params)


def _rank_main(mesh, argv, params):
    return _train(_parser().parse_args(argv), mesh, params)


def _train(args, mesh, params):
    ctx = ParallelCtx(mesh=mesh, dp_axes=dp_axes(mesh), tp_axis="model")
    root = mesh.rank == 0
    device = mesh.device
    if device.type == "cpu" and mesh.world > 1:     # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // mesh.world))
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    rcfg = RunConfig(model=cfg, seq_len=args.seq_len,
                     global_batch=args.global_batch, mode="train",
                     microbatch=args.microbatch, learning_rate=args.lr,
                     warmup_steps=max(5, args.steps // 10),
                     grad_compression=args.grad_compression)
    step_fn = build_train_step(cfg, rcfg, device, ctx)
    if params is None:
        params = init_params(0, cfg, tp=mesh.tp, device=device)
    else:
        params = tree_map(lambda t: t.to(device), params)
    params = step_fn.shard(params)
    dims, mdims = step_fn.layout("data"), step_fn.layout("model")
    opt_state = init_state(params)

    def both(d):
        return None if d is None else {"params": d, "opt": {"m": d, "v": d, "step": None}}

    prefix_n = cfg.num_prefix_embeds
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq_len - prefix_n,
                                  global_batch=args.global_batch))

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    layout = dict(dims=both(dims), model_dims=both(mdims), ctx=ctx)

    def restore() -> Optional[int]:
        nonlocal params, opt_state
        restored, rstep = mgr.restore({"params": params, "opt": opt_state}, **layout)
        if restored is None:
            return None
        params, opt_state = restored["params"], restored["opt"]
        return rstep

    start = 0
    if mgr is not None:
        rstep = restore()
        if rstep is not None:
            start = rstep
            if root:
                print(f"[restore] resumed from step {start}", flush=True)

    def restore_fn() -> int:
        if mgr is None:
            return 0
        mgr.wait()
        ctx.barrier()               # rank 0's pending writes are complete for every rank
        rstep = restore()
        return 0 if rstep is None else rstep

    injector = FailureInjector()
    monitor = StragglerMonitor()
    guard = RunGuard(restore_fn)
    losses = []

    step = start
    while step < args.steps:
        t0 = time.time()
        captured = {}

        def one_step(step=step):
            nonlocal params, opt_state
            injector.maybe_fail(step)
            toks, tgts = data.batch(step, shard=0, num_shards=1)
            pre = prefix_embeds_stub(cfg, args.global_batch, seed=step)
            if pre is None:
                pre = np.zeros((args.global_batch, 0, cfg.d_model), np.float32)
            params, opt_state, metrics = step_fn(
                params, opt_state, torch.from_numpy(toks).to(device),
                torch.from_numpy(tgts).to(device), torch.from_numpy(pre).to(device), step)
            captured.update({k: float(v) for k, v in metrics.items()})

        nxt = guard.run(step, one_step)
        if nxt <= step:  # restored backwards
            step = nxt
            continue
        dt = time.time() - t0
        monitor.observe(step, dt)
        losses.append(captured.get("loss", float("nan")))
        if root and step % args.log_every == 0:
            print(f"step {step:5d}  loss {captured.get('loss', -1):.4f}  "
                  f"gnorm {captured.get('grad_norm', -1):.3f}  "
                  f"lr {captured.get('lr', -1):.2e}  {dt:.2f}s", flush=True)
        if mgr is not None and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, {"params": params, "opt": opt_state}, **layout)
        if args.ckpt_dir and root:
            heartbeat_file(f"{args.ckpt_dir}/heartbeat", step)
        step = nxt

    if mgr is not None:
        mgr.save(args.steps, {"params": params, "opt": opt_state}, blocking=True, **layout)
        mgr.wait()
        ctx.barrier()
    if root and monitor.straggles:
        print(f"[straggler] slow steps: {monitor.straggles}")
    if root and losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}); "
              f"median step {monitor.median:.2f}s")
    return losses


if __name__ == "__main__":
    main()
