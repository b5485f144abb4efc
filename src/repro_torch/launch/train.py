"""End-to-end training driver (port of src/repro/launch/train.py): data ->
microbatched train step -> checkpoints, with fault containment and
straggler monitoring, on one device (the card unless ``--device cpu``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b --reduced \\
        --steps 50 --device cpu --ckpt-dir /tmp/ckpt

Meshes (``--mesh single|multi``) and the int8 all-gather of data-parallel
gradients (``--grad-compression int8_ag``) are not ported yet and raise.
"""

from __future__ import annotations

import argparse
import time

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
from repro_torch.launch.mesh import make_driver_mesh
from repro_torch.launch.steps import build_train_step
from repro_torch.models import init_params
from repro_torch.optim import init_state


def main(argv=None, *, params=None):
    """Train and return the list of step losses. ``params``: the initial
    parameter tree (f32 masters on the device; written in place), else
    ``init_params(0, cfg)`` on the device."""
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
                    help="data shards for the (elastic) host pipeline")
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8_ag"])
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.grad_compression != "none":
        raise NotImplementedError(f"--grad-compression {args.grad_compression}: the "
                                  "compressed data-parallel all-reduce is not ported yet "
                                  "(ROADMAP.md, Modules to port)")

    device = make_driver_mesh(args.mesh, args.device).device
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    rcfg = RunConfig(model=cfg, seq_len=args.seq_len,
                     global_batch=args.global_batch, mode="train",
                     microbatch=args.microbatch, learning_rate=args.lr,
                     warmup_steps=max(5, args.steps // 10),
                     grad_compression=args.grad_compression)
    step_fn = build_train_step(cfg, rcfg, device)
    if params is None:
        params = init_params(0, cfg, device=device)
    opt_state = init_state(params)

    prefix_n = cfg.num_prefix_embeds
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq_len - prefix_n,
                                  global_batch=args.global_batch))

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if mgr is not None:
        restored, rstep = mgr.restore({"params": params, "opt": opt_state})
        if restored is not None:
            params, opt_state = restored["params"], restored["opt"]
            start = rstep
            print(f"[restore] resumed from step {start}", flush=True)

    def restore_fn() -> int:
        nonlocal params, opt_state
        if mgr is None:
            return 0
        mgr.wait()
        restored, rstep = mgr.restore({"params": params, "opt": opt_state})
        if restored is None:
            return 0
        params, opt_state = restored["params"], restored["opt"]
        return rstep

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
        if step % args.log_every == 0:
            print(f"step {step:5d}  loss {captured.get('loss', -1):.4f}  "
                  f"gnorm {captured.get('grad_norm', -1):.3f}  "
                  f"lr {captured.get('lr', -1):.2e}  {dt:.2f}s", flush=True)
        if mgr is not None and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, {"params": params, "opt": opt_state})
        if args.ckpt_dir:
            heartbeat_file(f"{args.ckpt_dir}/heartbeat", step)
        step = nxt

    if mgr is not None:
        mgr.save(args.steps, {"params": params, "opt": opt_state},
                 blocking=True)
        mgr.wait()
    if monitor.straggles:
        print(f"[straggler] slow steps: {monitor.straggles}")
    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}); "
              f"median step {monitor.median:.2f}s")
    return losses


if __name__ == "__main__":
    main()
