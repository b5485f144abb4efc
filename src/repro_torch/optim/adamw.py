"""AdamW with decoupled weight decay + global-norm clipping (port of
src/repro/optim/adamw.py).

State layout mirrors the param tree: {m, v} in f32 plus an int32 step.
Master params are f32; the train step computes grads in bf16 compute /
f32 accumulate and applies updates to the f32 masters. Leaves are walked
in the reference's flatten order (sorted dict keys, `core.tree.tree_items`).

`apply_updates` writes the params, m and v in place and returns them (the
reference's compiled step donates their buffers): on the card that keeps
one copy of each in memory. One sequence of f32 tensor operations serves
both devices:

    g' = g * scale;  m' = m b1 + g' (1 - b1);  v' = v b2 + g' g' (1 - b2)
    delta = m' / ((sqrt(v' / c2) + eps) c1)          (c = 1 - b^t)
    delta = delta + wd p                             (leaves named ``w``)
    p' = p - lr delta

XLA's compiled CPU step contracts some of these multiply-adds into one
rounding and sums the grad norm in its own order, so the CPU result is
within a few ulp of the reference's, not bit-equal
(`tests/test_torch_train.py` states the bound); the card's is held to the
CPU's (`tests/test_torch_gpu.py`, `chip_smoke.py`'s ``train`` phase).

Under data and tensor parallelism (a ``ctx`` of a training mesh and the
layout's ``dims`` over ``data`` and ``model_dims`` over ``model``,
`launch.sharding.params_shardings`) a rank holds its slices of the
sharded leaves, whole replicated ones, and their grads alike. The global
norm's sum of squares then adds the slices' sums in rank order, over
``data`` and then over ``model``, and each replicated leaf once, so every
rank clips by the same bits; the update runs on each rank's slices.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.tree import tree_items, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init_state(params):
    """Zero f32 m and v shaped as ``params``, and a zero int32 step, on the
    params' device."""
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                     params)
    device = tree_items(params)[0][1].device
    return {"m": zeros, "v": tree_map(torch.zeros_like, zeros),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree, ctx=None, dims=None, model_dims=None) -> torch.Tensor:
    """sqrt of the sum over leaves (in flatten order) of each leaf's sum of
    squares in f32, as a 0-d f32 tensor. With ``ctx`` and the layout
    (``dims`` over ``data``, ``model_dims`` over ``model``; either None
    where nothing is sliced along it) the leaves whose dim is set are this
    rank's slices: the sums of the leaves sliced over ``data`` are added
    over ``data`` in rank order, then those of the leaves sliced over
    ``model`` (the first group's totals among them) over ``model``, then
    the groups' totals and the whole leaves' sum."""
    items = tree_items(tree)
    sums = [torch.square(g.to(torch.float32)).sum() for _, g in items]
    n_data = ctx.size("data") if ctx is not None and dims is not None else 1
    n_model = ctx.size("model") if ctx is not None and model_dims is not None else 1
    if n_data == 1 and n_model == 1:
        return torch.sqrt(torch.stack(sums).sum())
    by_data = dict(tree_items(dims)) if n_data > 1 else {}
    by_model = dict(tree_items(model_dims)) if n_model > 1 else {}
    zero = torch.zeros((), device=sums[0].device)

    def group(on_data: bool, on_model: bool) -> torch.Tensor:
        return torch.stack([s for (path, _), s in zip(items, sums)
                            if (by_data.get(path) is not None) == on_data
                            and (by_model.get(path) is not None) == on_model] or [zero]).sum()

    both, data_only, model_only = group(True, True), group(True, False), group(False, True)
    whole = [s for (path, _), s in zip(items, sums)
             if by_data.get(path) is None and by_model.get(path) is None]
    both, data_only = ctx.sum_ranks(torch.stack([both, data_only]), "data")
    both, model_only = ctx.sum_ranks(torch.stack([both, model_only]), "model")
    total = (both + model_only) + data_only
    if whole:
        total = total + torch.stack(whole).sum()
    return torch.sqrt(total)


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp_max(float(np.float32(max_norm)) / torch.clamp_min(gn, 1e-9), 1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, in f32, the
    global norm before clipping)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), gn


def _decayable(path) -> bool:
    """Decay 2D+ matrices; skip norms/biases/scalars (standard practice):
    the leaves named ``w``."""
    return path[-1] == "w"


def _update(p, g, m, v, scale, c1, c2, lr, decay, cfg: AdamWConfig):
    """One leaf in f32 in-place operations (``g`` is consumed)."""
    g = g.to(torch.float32).mul_(scale)
    m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
    v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
    delta = torch.div(v, c2).sqrt_().add_(cfg.eps).mul_(c1)
    torch.div(m, delta, out=delta)
    if decay:
        delta.add_(p, alpha=cfg.weight_decay)
    p.addcmul_(delta, lr, value=-1.0)


def apply_updates(params, grads, state, lr, cfg: AdamWConfig, ctx=None, dims=None,
                  model_dims=None):
    """Returns (params, state, metrics): the params, m and v updated in
    place, the step advanced, and ``{"grad_norm": the norm before
    clipping}``. ``lr`` is a 0-d f32 tensor (or a float) on the params'
    device. The f32 grads are consumed (scaled in place). ``ctx``,
    ``dims`` and ``model_dims``: a rank's slices (`global_norm`)."""
    gn = global_norm(grads, ctx, dims, model_dims)
    scale = _clip_scale(gn, cfg.grad_clip)
    step = state["step"] + 1
    t = step.to(torch.float32)
    c1 = 1.0 - torch.pow(float(np.float32(cfg.b1)), t)
    c2 = 1.0 - torch.pow(float(np.float32(cfg.b2)), t)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=gn.device)
    g_items = dict(tree_items(grads))
    m_items = dict(tree_items(state["m"]))
    v_items = dict(tree_items(state["v"]))
    for path, p in tree_items(params):
        _update(p, g_items[path], m_items[path], v_items[path], scale, c1, c2, lr,
                _decayable(path), cfg)
    new_state = {"m": state["m"], "v": state["v"], "step": step}
    return params, new_state, {"grad_norm": gn}

