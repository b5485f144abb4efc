"""Spawn targets of tests/test_torch_dp.py: what each rank of a CPU world
(gloo, `repro_torch.launch.mesh.spawn`) of data-parallel training runs.
Spawn pickles a target by name, so they live in this importable module,
which imports the port only (no JAX).

One world of four ranks, (pod 2, data 2, model 1), serves the whole file:

  * the collectives over ``data`` (`reduce_scatter_ranks` in small chunks
    against `sum_ranks`) and `compressed_psum` over ``pod`` (w = 2) and
    over the four ranks (a (pod 4) view of the same world, w = 4);
  * each pod's two ranks, a (data 2) view, train one arch at dp = 2: pod 0
    reduced qwen2-7b, pod 1 reduced llama4-scout-17b-16e; once in the
    reference's layout (no leaf of a reduced config is wide enough to be
    FSDP-sliced) and once with FSDP's width threshold lowered to 64, so
    the slicing, the gathers, the reduce-scatter and the checkpoint of
    slices run; that run saves a checkpoint and restores one written at
    dp = 1;
  * all four ranks train each arch on the (pod 2, data 2) mesh with
    ``grad_compression="int8_ag"``.
"""

from __future__ import annotations

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.core.tree import tree_items
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.steps import build_train_step
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.parallel import ParallelCtx
from repro_torch.optim import compressed_allreduce, compressed_psum, init_state

ARCHS = ("qwen2-7b", "llama4-scout-17b-16e")
S, B, MICRO, STEPS, LR = 32, 8, 4, 2, 1e-3
FSDP_TEST_MIN_DIM = 64


def run_config(arch, compression="none"):
    cfg = get_config(arch).reduced()
    return cfg, RunConfig(model=cfg, seq_len=S, global_batch=B, microbatch=MICRO,
                          learning_rate=LR, warmup_steps=2, grad_compression=compression)


def grad_inputs(rank: int):
    """Rank r's grads: a leaf of 4096 values of magnitudes 1e-3 .. 1e1, a
    [24, 40] leaf, and two that fall back to the plain sum: 7 values (not a
    multiple of w) and 12 (fewer than 8 w at w = 2 and 4, but a multiple)."""
    gen = torch.Generator().manual_seed(500 + rank)
    big = torch.randn(4096, generator=gen) * 10.0 ** torch.randint(-3, 2, (4096,), generator=gen)
    return {"big": big, "mat": torch.randn((24, 40), generator=gen),
            "odd": torch.arange(7, dtype=torch.float32) * (rank + 1),
            "small": torch.full((12,), 0.25) * (rank + 1)}


def _view(mesh, shape, axis):
    """A mesh of ``shape`` over the ranks of ``mesh``'s group along
    ``axis`` (the whole world for ``axis`` None), this rank at its index
    there."""
    import torch.distributed as dist

    group = dist.group.WORLD if axis is None else mesh.groups[axis]
    rank = mesh.rank if axis is None else mesh.coord(axis)
    name = [a for a, n in shape.items() if n > 1][0]
    return Mesh(dict(shape), rank=rank, device=mesh.device, backend=mesh.backend,
                groups={name: group})


def collectives(mesh):
    from repro_torch.models import parallel

    ctx = ParallelCtx(mesh=mesh)
    x = grad_inputs(mesh.rank)["mat"].reshape(-1)
    real = parallel._CPU_CHUNK
    parallel._CPU_CHUNK = 256                     # several chunks of 64 elements
    try:
        rs = ctx.reduce_scatter_ranks(x, "data")
        gathered = ctx.all_gather_dim(x.reshape(24, 40), 0, "data")
    finally:
        parallel._CPU_CHUNK = real
    whole = ctx.sum_ranks(x, "data")
    n = x.numel() // 2
    r = mesh.coord("data")
    stats2 = []
    psum2 = compressed_psum(grad_inputs(mesh.rank), ctx, ("pod",), stats2)
    pod4 = ParallelCtx(mesh=_view(mesh, {"pod": 4, "data": 1, "model": 1}, None))
    stats4 = []
    psum4 = compressed_psum(grad_inputs(mesh.rank), pod4, ("pod",), stats4)
    allreduce4 = compressed_allreduce(grad_inputs(mesh.rank), pod4.mesh, ("pod",))
    return dict(reduce_scatter_equal=torch.equal(rs, whole[r * n:(r + 1) * n]),
                gather=gathered, psum2=psum2, stats2=stats2, psum4=psum4, stats4=stats4,
                allreduce4=allreduce4,
                bytes=dict(mesh.collective_bytes))


def _whole(tree, dims, ctx):
    """The whole leaves of a tree of slices, on the host."""
    full = SH.unshard_tree(tree, dims, ctx) if dims is not None else tree
    return {"/".join(p): t.detach().clone() for p, t in tree_items(full)}


def train(mesh, np_params, arch, compression="none", fsdp_min=None, ckpt=None):
    """STEPS steps of the port's train step on this rank's mesh from the
    reference's params: per step (loss, grad norm, lr) as f32 bits, m after
    the first step and the params after the last gathered whole, and the
    rank's own leaves (slices) after the last step. ``ckpt``: (directory
    to save the last step in, directory of a dp = 1 checkpoint to restore
    into this rank's slices)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import DataConfig, SyntheticLM

    real = SH.FSDP_MIN_DIM
    if fsdp_min is not None:
        SH.FSDP_MIN_DIM = fsdp_min
    try:
        cfg, rcfg = run_config(arch, compression)
        ctx = ParallelCtx(mesh=mesh, tp_axis="model") if mesh is not None else ParallelCtx()
        step = build_train_step(cfg, rcfg, "cpu", ctx)
        params = step.shard(params_from_numpy(np_params))
        dims = step.layout()
        opt = init_state(params)
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B))
        mets, m0 = [], None
        for s in range(STEPS):
            toks, tgts = data.batch(s)
            params, opt, met = step(params, opt, torch.from_numpy(toks), torch.from_numpy(tgts),
                                    None, s)
            mets.append({k: float(v) for k, v in met.items()})
            if s == 0:
                m0 = _whole(opt["m"], dims, ctx)
        out = dict(metrics=mets, m0=m0, params=_whole(params, dims, ctx),
                   own={"/".join(p): t.clone() for p, t in tree_items(params)},
                   own_m={"/".join(p): t.clone() for p, t in tree_items(opt["m"])},
                   dims={"/".join(p): d for p, d in tree_items(dims)},
                   bytes=dict(mesh.collective_bytes) if mesh is not None else {})
        if ckpt is not None:
            save_dir, dp1_dir = ckpt
            layout = dict(dims={"params": dims, "opt": {"m": dims, "v": dims, "step": None}},
                          ctx=ctx)
            mgr = CheckpointManager(save_dir, async_save=False)
            mgr.save(STEPS, {"params": params, "opt": opt}, **layout)
            ctx.barrier()
            back, at = CheckpointManager(dp1_dir).restore({"params": params, "opt": opt},
                                                          **layout)
            out["restored"] = (at, {"/".join(p): t for p, t in tree_items(back)})
        return out
    finally:
        SH.FSDP_MIN_DIM = real


def dp_world(mesh, np_params, dirs):
    """One rank of the file's world (see the module docstring)."""
    torch.set_num_threads(1)
    out = dict(rank=mesh.rank, coords=mesh.coords, collectives=collectives(mesh))
    pod = mesh.coord("pod")
    arch = ARCHS[pod]
    single = _view(mesh, {"data": 2, "model": 1}, "data")
    out["single"] = train(single, np_params[arch], arch)
    out["fsdp"] = train(single, np_params[arch], arch, fsdp_min=FSDP_TEST_MIN_DIM,
                        ckpt=dirs[arch])
    out["multi"] = {a: train(mesh, np_params[a], a, "int8_ag") for a in ARCHS}
    return out


def one_rank(np_params):
    """The port's dp = 1 runs of each arch (in the caller's process)."""
    return {a: train(None, np_params[a], a) for a in ARCHS}
