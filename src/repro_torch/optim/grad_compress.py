"""Gradient compression for the data-parallel all-reduce (port of
src/repro/optim/grad_compress.py).

An all-reduce is a reduce-scatter and an all-gather. The reduce-scatter
half stays f32 (it sums partial gradients); the all-gather half broadcasts
an already-reduced value, so it travels as int8 codes with one f32 scale
per shard, about a quarter of that half's bytes:

    g -> reduce_scatter (f32, rank order) -> int8 + scale -> all_gather -> dequantize

Quantization comes after the sum, so no error accumulates across ranks:
each element is within half a step of the int8 grid, amax / 254, of the
rank-order f32 sum, amax the largest |value| of its shard.

``compressed_psum`` runs inside a train step on a rank's grads (the
cross-pod reduction of `launch.steps.build_train_step`): on a mesh with
data or model axes > 1 those are the grads of the rank's (model, data)
slice of each leaf, so a leaf's int8 shards are the pod shards of that
slice;
``compressed_allreduce`` wraps it for standalone use.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.tree import tree_map

# the compiled reference divides by the constant 127 as a multiply by its
# f32 reciprocal (XLA's rewrite), which can round a scale one ulp apart
_INV_127 = float(np.float32(1.0 / 127.0))


def _axis(ctx, axes: Sequence[str]) -> Optional[str]:
    """The one axis of ``axes`` with more than one rank (None: none)."""
    live = [a for a in axes if ctx.size(a) > 1]
    if len(live) > 1:
        raise NotImplementedError(f"compressed_psum over several axes {live} at once; the "
                                  "train step compresses over 'pod' alone")
    return live[0] if live else None


def compressed_psum(grads, ctx, axes: Sequence[str], stats: Optional[List[dict]] = None):
    """The sum over the ranks of ``axes`` of each leaf of the grad tree,
    with an int8 all-gather half; every rank gets the same result (f32).

    Per leaf, as the reference: in f32; a leaf of n elements with n % w or
    n < 8 w (w ranks) is the plain rank-order sum (`ParallelCtx.sum_ranks`);
    otherwise its flat n split in w shards, rank r's shard summed in rank
    order (`ParallelCtx.reduce_scatter_ranks`), its amax, scale =
    max(amax, 1e-30) / 127 (times the f32 reciprocal, as compiled), codes
    round-half-to-even(shard / scale) clipped to +-127 as int8, the codes
    and the w scales all-gathered, each shard
    dequantized by its own scale. ``stats``: a list that gets one dict per
    leaf (``numel``, ``fallback``, this rank's shard ``amax``, and of
    |dequantized - rank-order sum| over that shard the max ``max_err`` and
    the sum of squares ``err_sq``)."""
    axis = _axis(ctx, axes)
    w = 1 if axis is None else ctx.size(axis)

    def one(g):
        gf = g.to(torch.float32)
        if w == 1:
            return gf
        flat = gf.reshape(-1)
        n = flat.numel()
        if n % w or n < 8 * w:
            if stats is not None:
                stats.append(dict(numel=n, fallback=True))
            return ctx.sum_ranks(gf, axis)
        red = ctx.reduce_scatter_ranks(flat, axis)
        amax = red.abs().max()
        scale = torch.clamp_min(amax, 1e-30) * _INV_127
        q = torch.clamp(torch.round(red / scale), -127, 127).to(torch.int8)
        codes = ctx.gather_ranks(q, axis, "all_gather_int8")
        scales = ctx.gather_ranks(scale.reshape(1), axis, "all_gather_scale")
        out = (torch.stack(codes).to(torch.float32) * torch.stack(scales)).reshape(g.shape)
        if stats is not None:
            mine = out.reshape(-1)[ctx.coord(axis) * red.numel():][:red.numel()]
            err = (mine - red).abs()
            stats.append(dict(numel=n, fallback=False, amax=float(amax),
                              max_err=float(err.max()),
                              err_sq=float(err.double().square().sum())))
        return out

    return tree_map(one, grads)


def compressed_allreduce(grads, mesh, dp_axes: Sequence[str]):
    """Standalone wrapper: the all-reduce over ``dp_axes`` of the grads this
    rank holds (whole leaves, as the reference's replicated view)."""
    from repro_torch.models.parallel import ParallelCtx

    return compressed_psum(grads, ParallelCtx(mesh=mesh), dp_axes)

