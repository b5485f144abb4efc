"""Dense FFN variants (port of src/repro/models/ffn.py): SwiGLU, GeGLU and
the plain GELU MLP, on one device or on a rank's d_ff / tp columns: in the
serving layout every linear N-sharded and the hiddens gathered
(`down_proj`), in the training layout (``ctx.col_row``) ``w_gate`` /
``w_up`` column-parallel and ``w_down`` row-parallel, its partial products
summed over ``model``."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.rtn import device_table

from .common import apply_linear, apply_row_parallel, make_linear
from .parallel import NO_CTX

ACTIVATIONS = ("silu_glu", "gelu_glu", "gelu")


def init_ffn(gen, d_model: int, d_ff: int, activation: str, *, dtype=torch.float32,
             device="cpu"):
    """``{w_gate, w_up, w_down}`` for a gated activation (``*_glu``), else
    ``{w_up, w_down}``, drawn in that order."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown FFN activation {activation!r}; one of {ACTIVATIONS}")
    kw = dict(dtype=dtype, device=device)
    names = ("w_gate", "w_up") if activation.endswith("_glu") else ("w_up",)
    p = {n: make_linear(gen, d_model, d_ff, **kw) for n in names}
    p["w_down"] = make_linear(gen, d_ff, d_model, **kw)
    return p


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * (1 / (1 + exp(-x))), each op rounded in x.dtype: the op sequence
    jax.nn.silu lowers to, so bf16 activations round alike."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's tanh approximation, x * 0.5 * (1 + tanh(sqrt(2/pi) *
    (x + 0.044715 x^3))), with each op rounded in x.dtype and both constants
    taken in x.dtype first: the op sequence the reference's compiled step
    rounds bf16 activations through (x^3 as (x * x) * x). The constants are
    a device table made once (no copy from the host inside a graph)."""
    c3, c = device_table((0.044715, float(np.sqrt(2 / np.pi))), x.dtype, str(x.device))
    t = torch.tanh((x + (x * x * x) * c3) * c)
    return x * ((t + 1) * 0.5)


def _act(name: str):
    return silu if name.startswith("silu") else gelu


def down_proj(p, h, policy=None, ctx=NO_CTX):
    """``w_down`` of the FFN's hidden h. Under a tp > 1 ``ctx`` h holds this
    rank's d_ff / tp columns (the N-shards of ``w_gate`` / ``w_up``): the
    ranks' hiddens are gathered, ``w_down``'s N-shard contracts all of d_ff,
    and its output columns are gathered into the replicated residual."""
    tp = ctx.tp
    if tp == 1:
        return apply_linear(p["w_down"], h, policy)
    return ctx.all_gather_last(apply_linear(p["w_down"], ctx.all_gather_last(h), policy, tp))


def ffn_apply(p, x, activation: str, policy=None, ctx=NO_CTX):
    """The FFN of x; under a tp > 1 ``ctx`` on the rank's d_ff / tp
    columns: the serving layout's `down_proj`, or, in the training layout
    (``ctx.col_row``), x through `ParallelCtx.copy_ranks` into the column
    shards of ``w_gate`` / ``w_up`` and the hidden into ``w_down``'s K rows
    (`common.apply_row_parallel`)."""
    act = _act(activation)
    tp = ctx.tp
    if ctx.col_row:
        x = ctx.copy_ranks(x)
        if "w_gate" in p:
            h = act(apply_linear(p["w_gate"], x, policy)) * apply_linear(p["w_up"], x, policy)
        else:
            h = act(apply_linear(p["w_up"], x, policy))
        return apply_row_parallel(p["w_down"], h, ctx)
    if "w_gate" in p:
        g = act(apply_linear(p["w_gate"], x, policy, tp))
        u = apply_linear(p["w_up"], x, policy, tp)
        return down_proj(p, g * u, policy, ctx)
    return down_proj(p, act(apply_linear(p["w_up"], x, policy, tp)), policy, ctx)
