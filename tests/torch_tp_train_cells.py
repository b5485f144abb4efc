"""Spawn targets of tests/test_torch_tp_train.py: what each rank of a CPU
world (gloo, `repro_torch.launch.mesh.spawn`) of tensor-parallel training
runs. Spawn pickles a target by name, so they live in this importable
module, which imports the port only (no JAX).

One world of four ranks, (pod 2, data 1, model 2), serves the whole file,
through views of its groups:

  * each pod's two ranks, a (data 1, model 2) view: pod 0 trains reduced
    qwen2-7b, then the padded variant (`PADDED`: 3 q heads over one kv
    head, an odd vocab) and runs `moe_tp` on reduced dbrx-132b; pod 1
    trains reduced llama4-scout-17b-16e at its own capacity factor and at
    one that drops nothing (`NO_DROP`), and runs `moe_tp` on it;
  * all four as (data 2, model 2): both archs; then qwen2-7b with FSDP's
    width threshold lowered to `FSDP_TEST_MIN_DIM`, so leaves are sliced
    over both axes, which saves a checkpoint and restores it into its
    slices;
  * all four as (pod 2, model 2): both archs with ``int8_ag``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.core.tree import tree_items
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import Mesh
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.parallel import ParallelCtx
from repro_torch.optim import init_state

ARCHS = ("qwen2-7b", "llama4-scout-17b-16e")
S, B, MICRO, STEPS, LR = 32, 8, 4, 2, 1e-3
FSDP_TEST_MIN_DIM = 64
# a reduced qwen2-7b that tp = 2 pads: q heads 3 -> 4 (one kv head, which
# does not split over two ranks), vocab 509 -> 510
PADDED = {"num_heads": 3, "num_kv_heads": 1, "vocab_size": 509}
NO_DROP = {"moe_capacity_factor": 8.0}
MOE_ARCHS = ("dbrx-132b", "llama4-scout-17b-16e")
MOE_SHAPE = (2, 16)                     # x [B, S] rows of tokens


def config(arch, overrides=None):
    cfg = get_config(arch).reduced()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def run_config(cfg, compression="none"):
    return RunConfig(model=cfg, seq_len=S, global_batch=B, microbatch=MICRO, learning_rate=LR,
                     warmup_steps=2, grad_compression=compression)


def view(mesh, shape, groups):
    """A mesh of ``shape`` over the world's ranks, with the world's groups
    ``groups`` ({view axis: world axis}) and this rank at its place there
    (model innermost)."""
    rank = 0
    for a in ("pod", "data", "model"):
        if a in shape:
            src = groups.get(a)
            rank = rank * shape[a] + (mesh.coord(src) if src else 0)
    return Mesh(dict(shape), rank=rank, device=mesh.device, backend=mesh.backend,
                groups={a: mesh.groups[w] for a, w in groups.items()})


def _whole(tree, ddims, mdims, ctx):
    """The whole leaves of a tree of (model, data) slices: gathered over
    ``data``, then over ``model`` as the checkpoint's save gathers them."""
    by_model = dict(tree_items(mdims))
    return {"/".join(p): (t if by_model[p] is None
                          else ctx.all_gather_dim(t, by_model[p], "model")).detach().clone()
            for p, t in tree_items(SH.unshard_tree(tree, ddims, ctx))}


def _own(tree):
    return {"/".join(p): t.detach().clone() for p, t in tree_items(tree)}


def train(mesh, np_params, arch, overrides=None, compression="none", fsdp_min=None,
          ckpt=None):
    """STEPS steps of the port's train step on ``mesh`` (None: one rank)
    from the reference's params: per step (loss, grad norm, lr), m after
    the first step gathered whole and the rank's own slices of it, the
    rank's own params and m after the last step, the layout, the
    collectives' bytes and (``int8_ag``) step 0's int8 errors by leaf.
    ``ckpt``: a directory to save the last step in (whole arrays) and
    restore from into the rank's slices."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import DataConfig, SyntheticLM

    real_min, real_psum = SH.FSDP_MIN_DIM, steps_mod.compressed_psum
    if fsdp_min is not None:
        SH.FSDP_MIN_DIM = fsdp_min
    try:
        cfg = config(arch, overrides)
        ctx = ParallelCtx(mesh=mesh, tp_axis="model") if mesh is not None else ParallelCtx()
        step = steps_mod.build_train_step(cfg, run_config(cfg, compression), "cpu", ctx)
        params = step.shard(params_from_numpy(np_params))
        ddims, mdims = step.layout("data"), step.layout("model")
        opt = init_state(params)
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B))
        mets, m0, own_m0, stats = [], None, None, []
        for s in range(STEPS):
            if s == 0 and compression == "int8_ag":
                steps_mod.compressed_psum = lambda g, c, a: real_psum(g, c, a, stats)
            toks, tgts = data.batch(s)
            try:
                params, opt, met = step(params, opt, torch.from_numpy(toks),
                                        torch.from_numpy(tgts), None, s)
            finally:
                steps_mod.compressed_psum = real_psum
            mets.append({k: float(v) for k, v in met.items()})
            if s == 0:
                m0, own_m0 = _whole(opt["m"], ddims, mdims, ctx), _own(opt["m"])
        out = dict(coords=mesh.coords if mesh is not None else {}, metrics=mets, m0=m0,
                   own_m0=own_m0, own=_own(params), own_m=_own(opt["m"]),
                   params=_whole(params, ddims, mdims, ctx),
                   data_dims={"/".join(p): d for p, d in tree_items(ddims)},
                   model_dims={"/".join(p): d for p, d in tree_items(mdims)},
                   stats=dict(zip(own_m0, stats)),
                   bytes=dict(mesh.collective_bytes) if mesh is not None else {})
        if ckpt is not None:
            def both(d):
                return {"params": d, "opt": {"m": d, "v": d, "step": None}}

            layout = dict(dims=both(ddims), model_dims=both(mdims), ctx=ctx)
            CheckpointManager(ckpt, async_save=False).save(STEPS, {"params": params, "opt": opt},
                                                           **layout)
            ctx.barrier()
            back, at = CheckpointManager(ckpt).restore({"params": params, "opt": opt}, **layout)
            out["restored"] = (at, _own(back), _own({"params": params, "opt": opt}))
        return out
    finally:
        SH.FSDP_MIN_DIM = real_min


def moe(mesh, np_moe, arch, overrides, x_np, r_np):
    """`moe_tp` of x on this rank's training-layout shards of the MoE
    params (``mesh`` None: one rank), and the grads of sum(y * r) + aux:
    (y, aux, the router's grad, x's grad)."""
    from repro_torch.models.moe import moe_tp

    cfg = config(arch, overrides)
    ctx = (ParallelCtx(mesh=mesh, tp_axis="model", train_layout=True) if mesh is not None
           else ParallelCtx())
    whole = params_from_numpy(np_moe)
    p = SH.shard_tree(whole, ctx.rank, ctx.tp, dims=SH.params_shardings(whole, axis="model"))
    leaves = [t.requires_grad_(True) for _, t in tree_items(p)]
    x = torch.from_numpy(x_np).requires_grad_(True)
    y, aux = moe_tp(p, x, cfg, ctx)
    g = torch.autograd.grad((y * torch.from_numpy(r_np)).sum() + aux, leaves + [x])
    router = dict(zip(["/".join(k) for k, _ in tree_items(p)], g))["router/w"]
    return dict(y=y.detach(), aux=float(aux.detach()), router_grad=router, x_grad=g[-1])


def tp_world(mesh, np_params, moe_inputs, ckpt):
    """One rank of the file's world (see the module docstring)."""
    torch.set_num_threads(1)
    pod = mesh.coord("pod")
    out = dict(rank=mesh.rank, coords=mesh.coords)
    pair = view(mesh, {"data": 1, "model": 2}, {"model": "model"})
    if pod == 0:
        out["pair"] = {"qwen2-7b": train(pair, np_params["qwen2-7b"], "qwen2-7b"),
                       "padded": train(pair, np_params["padded"], "qwen2-7b", PADDED)}
    else:
        arch = "llama4-scout-17b-16e"
        out["pair"] = {arch: train(pair, np_params[arch], arch),
                       "no_drop": train(pair, np_params[arch], arch, NO_DROP)}
    arch = MOE_ARCHS[pod]
    out["moe"] = {cf: moe(pair, moe_inputs[arch]["params"], arch, over, *moe_inputs[arch]["xr"])
                  for cf, over in (("own", None), ("no_drop", NO_DROP))}
    quad = view(mesh, {"data": 2, "model": 2}, {"data": "pod", "model": "model"})
    out["quad"] = {a: train(quad, np_params[a], a) for a in ARCHS}
    out["fsdp"] = train(quad, np_params["qwen2-7b"], "qwen2-7b", fsdp_min=FSDP_TEST_MIN_DIM,
                        ckpt=ckpt)
    out["int8"] = {a: train(mesh, np_params[a], a, compression="int8_ag") for a in ARCHS}
    return out


def one_rank(np_params, moe_inputs):
    """The port's tp = 1 runs (in the caller's process): each arch's steps
    (scout's MoE at the no-drop factor too, which `moe_dense` equals), and
    `moe_tp` on one rank."""
    out = {a: train(None, np_params[a], a) for a in ARCHS}
    out["no_drop"] = train(None, np_params["llama4-scout-17b-16e"], "llama4-scout-17b-16e",
                           NO_DROP)
    out["moe"] = {a: moe(None, moe_inputs[a]["params"], a, NO_DROP, *moe_inputs[a]["xr"])
                  for a in MOE_ARCHS}
    return out
