"""Mixture-of-Experts FFN on one device (port of the single-device part of
src/repro/models/moe.py): a top-k softmax router over E experts, every
expert computed on every token and combined through the dense [T, E] gate
matrix (`moe_dense`), plus the shared expert where the config has one.

The router is a linear of its own (``router``: ``{'w': [D, E]}``), drawn in
f32 and never quantized (`QuantPolicy.wants` skips it by name); the serving
engine casts it to bf16 as the reference's does, and it is applied to the
activations taken to f32. Experts are stacked ``[E, ...]`` leaf by leaf
(packed planes too), and expert e is the view ``leaf[e]``: on
``impl="kernel"`` each of its three projections is one K1 / K1b launch on
that slice, as the reference's ``vmap`` batches its Pallas call over the
experts.

Numerics follow the reference's compiled CPU step: the softmax is XLA's
(its exp polynomial on CPU tensors, `core.xla_math.exp_f32`, and the sum in
expert order), ties in the top-k go to the lower expert index (a stable
sort), and the combine multiplies each expert's bf16 output by its weight
rounded to bf16 and sums over the experts in f32 before one rounding to
bf16; the shared expert's output is added in bf16. Under a tensor-parallel
mesh the decode step runs the expert-parallel path (`moe_ep`: a rank's
E / tp experts, each serving its top ``cap`` tokens), and the sequence
forward of training the reference's tensor-parallel path (`moe_tp`: every
expert in turn on its top ``cap`` tokens, its FFN sharded over the ranks
as a dense FFN in the training layout).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tree import tree_map, tree_stack
from repro_torch.core.xla_math import exp_f32, fma_f32, sum_in_order

from .common import apply_linear, make_linear
from .ffn import _act, ffn_apply, init_ffn
from .parallel import NO_CTX


def init_moe(gen, cfg, *, dtype=torch.float32, device="cpu",
             expert_fn: Optional[Callable] = None):
    """``{experts, router[, shared]}`` from ``gen``. Draw order: the experts
    in index order (each its FFN's linears), the router (f32 whatever
    ``dtype``), the shared expert. ``expert_fn`` maps each expert's tree
    before the experts are stacked (the serving init quantizes each one
    there, so no more than one expert's FFN exists in f32 at a time); an
    expert it maps to None is drawn and left out (a rank of expert
    parallelism keeps its own)."""
    kw = dict(dtype=dtype, device=device)
    fn = expert_fn or (lambda ep: ep)
    experts = [fn(init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.ffn_activation, **kw))
               for _ in range(cfg.num_experts)]
    experts = tree_stack([e for e in experts if e is not None])
    p = {"experts": experts,
         "router": make_linear(gen, cfg.d_model, cfg.num_experts, dtype=torch.float32,
                               device=device)}
    if cfg.moe_shared_expert_ff:
        p["shared"] = init_ffn(gen, cfg.d_model, cfg.moe_shared_expert_ff,
                               cfg.ffn_activation, **kw)
    return p


def router_logits(p, x: torch.Tensor) -> torch.Tensor:
    """f32 logits [T, E] of x [T, D] (taken to f32) through the router's
    weight (taken to f32). On CPU tensors of two or more rows the product
    is summed as the reference's compiled dot sums it: 4 lanes, lane j
    accumulating d = j, j + 4, ... by fused multiply-adds, then
    ((0 + 1) + (2 + 3)). One row, CUDA tensors and widths that 4 does not
    divide take torch's product (no reference asks for those bits)."""
    x = x.to(torch.float32)
    w = p["w"].to(torch.float32)
    T, D = x.shape
    if x.is_cuda or T < 2 or D % 4:
        return x @ w
    acc = x[:, 0:4, None] * w[0:4]
    for d in range(4, D, 4):
        acc = fma_f32(x[:, d:d + 4, None], w[d:d + 4], acc)
    return (acc[:, 0] + acc[:, 1]) + (acc[:, 2] + acc[:, 3])


def softmax(logits: torch.Tensor) -> torch.Tensor:
    """jax.nn.softmax over the last axis of f32 logits: exp(l - max) over
    its sum. On CPU tensors XLA's exp polynomial and the sum in index
    order, as the reference's compiled step; on CUDA torch's softmax (a row
    alone, whatever the other rows)."""
    if logits.is_cuda:
        return torch.softmax(logits, dim=-1)
    e = exp_f32(logits - logits.max(dim=-1, keepdim=True).values)
    return e / sum_in_order(e, -1)[..., None]


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row and their indices, ties to the lower index
    (jax.lax.top_k's order; torch.topk leaves it unspecified)."""
    v, i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


_ROUTES: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None


@contextlib.contextmanager
def record_routes():
    """Collect, while open, every router call's (top-k expert indices
    [T, k], probabilities [T, E]) in call order (model order over the
    layers of a step): the comparisons of routing between two lowerings
    read them. Eager steps only; nothing is kept otherwise."""
    global _ROUTES
    prev, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = prev


def gates(p, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router over x [T, D]: (dense combine weights [T, E] f32 — the top-k
    probabilities renormalised by max(sum, 1e-9), zeros elsewhere —,
    probabilities [T, E] f32)."""
    probs = softmax(router_logits(p["router"], x))
    top_v, top_i = top_k(probs, cfg.experts_per_token)
    top_v = top_v / torch.clamp(sum_in_order(top_v, -1)[..., None], min=1e-9)
    combine = torch.zeros_like(probs).scatter(1, top_i, top_v)
    if _ROUTES is not None:
        _ROUTES.append((top_i, probs))
    return combine, probs


def load_balance_loss(combine: torch.Tensor, probs: torch.Tensor, E: int,
                      ctx=NO_CTX) -> torch.Tensor:
    """Switch-style auxiliary loss: E * <f_e> . <p_e> (f_e: the share of
    tokens routed to expert e, p_e: its mean probability). On CPU tensors
    as the reference's compiled step computes it: the sums in index order,
    a mean as the sum times the f32 reciprocal of the count.

    Under a ``ctx`` whose ``dp_axes`` hold the forward's other rows (data-
    parallel training), the means run over every rank's tokens, as the
    reference's sharded program takes them: each rank's per-expert sums of
    f and p are added over those axes (`ParallelCtx.sum_ranks_grad`, whose
    backward hands each rank the gradient of its own tokens' share)."""
    frac = (combine > 0).to(torch.float32)
    n = 1
    for a in ctx.dp_axes:
        n *= ctx.size(a)
    if n > 1:
        both = ctx.sum_ranks_grad(torch.stack([frac.sum(dim=0), probs.sum(dim=0)]), ctx.dp_axes)
        inv = np.float32(1.0 / (probs.shape[0] * n))
        return (both[0] * inv * (both[1] * inv)).sum() * E
    if probs.is_cuda:
        return (frac.mean(dim=0) * probs.mean(dim=0)).sum() * E
    inv = np.float32(1.0 / probs.shape[0])
    imp = sum_in_order(probs, 0) * inv
    return sum_in_order(sum_in_order(frac, 0) * inv * imp, 0) * E


def expert_ffn(p, x: torch.Tensor, activation: str, policy=None) -> torch.Tensor:
    """`ffn_apply` of one expert, or of the shared expert, on x [T, D].
    Under ``impl="fused_ref"`` a gated FFN's product g * u enters w_down's
    K-blocked f32 product unrounded, as in the reference's compiled step:
    its 2-D x leaves nothing between the bf16 product and the blocked
    product's f32 convert, so XLA drops the rounding (a dense block's 3-D
    input keeps a reshape there, and its rounding). The output rounds to
    x.dtype as ever."""
    if (policy is None or policy.impl != "fused_ref" or "w_gate" not in p
            or "w" in p["w_down"]):
        return ffn_apply(p, x, activation, policy)
    act = _act(activation)
    g = act(apply_linear(p["w_gate"], x, policy)).to(torch.float32)
    u = apply_linear(p["w_up"], x, policy).to(torch.float32)
    return apply_linear(p["w_down"], g * u, policy).to(x.dtype)


def moe_dense(p, x: torch.Tensor, cfg, policy=None, ctx=NO_CTX):
    """Every expert on every token, combined with the gates. x [B, S, D] ->
    (y [B, S, D] in x.dtype, the auxiliary loss; over ``ctx.dp_axes``'
    tokens, `load_balance_loss`)."""
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    combine, probs = gates(p, xf, cfg)
    ys = torch.stack([expert_ffn(tree_map(lambda t: t[e], p["experts"]), xf,
                                 cfg.ffn_activation, policy)
                      for e in range(cfg.num_experts)])                     # [E, T, D]
    c = combine.to(ys.dtype).to(torch.float32)
    y = torch.einsum("te,etd->td", c, ys.to(torch.float32)).to(ys.dtype)
    aux = load_balance_loss(combine, probs, cfg.num_experts, ctx)
    if "shared" in p:
        y = y + expert_ffn(p["shared"], xf, cfg.ffn_activation, policy)
    return y.reshape(B, S, D).to(x.dtype), aux


def expert_capacity(T: int, cfg) -> int:
    """Tokens an expert serves in `moe_ep`: min(T, max(1, ceil(T * topk / E
    * moe_capacity_factor)))."""
    return min(T, max(1, math.ceil(T * cfg.experts_per_token / cfg.num_experts
                                   * cfg.moe_capacity_factor)))


def moe_ep(p, x: torch.Tensor, cfg, ctx, policy=None):
    """Expert-parallel MoE over the model axis of ``ctx`` (the reference's
    `moe_ep`). x [B, S, D], replicated on every rank; ``p["experts"]``
    holds this rank's E / tp experts (`launch.sharding`), the router and
    the shared expert's N-shards the rest. Each rank routes every token
    (the router replicated), serves each of its experts the top ``cap``
    tokens by that expert's gate (`expert_capacity`; a stable descending
    sort, so ties go to the lower token index, as ``jax.lax.top_k``: a
    token past an expert's capacity gets nothing from it), scatters
    ``he * w_e`` into an f32 [T, D] sum over its experts in index order,
    and the ranks' sums are added in rank order (`ParallelCtx.sum_ranks`).
    Returns (y [B, S, D] in x.dtype, the auxiliary loss)."""
    B, S, D = x.shape
    E, tp = cfg.num_experts, ctx.tp
    if E % tp:
        raise ValueError(f"num_experts={E} must divide over tp={tp}")
    e_loc = E // tp
    xf = x.reshape(B * S, D)
    T = xf.shape[0]
    cap = expert_capacity(T, cfg)
    combine, probs = gates(p, xf, cfg)
    y = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    for j in range(e_loc):
        w_e = combine[:, ctx.rank * e_loc + j]
        order = torch.sort(w_e, descending=True, stable=True).indices[:cap]
        he = expert_ffn(tree_map(lambda t: t[j], p["experts"]), xf[order], cfg.ffn_activation,
                        policy)
        part = torch.zeros((T, D), dtype=torch.float32, device=x.device)
        part[order] = he.to(torch.float32) * w_e[order, None]
        y = y + part
    y = ctx.sum_ranks(y).reshape(B, S, D).to(x.dtype)
    aux = load_balance_loss(combine, probs, E)
    if "shared" in p:
        y = y + ffn_apply(p["shared"], x, cfg.ffn_activation, policy, ctx)
    return y, aux


def moe_tp(p, x: torch.Tensor, cfg, ctx, policy=None):
    """Expert-sequential tensor-parallel MoE (the reference's `moe_tp`, its
    training path). x [B, S, D], the same on every model rank; the router and
    the expert dim are whole, each expert's FFN holds the training
    layout's shards (``w_gate`` / ``w_up`` column-parallel, ``w_down``
    row-parallel). Every rank routes every token; each expert e in index
    order takes its top ``cap`` tokens by its combine weight
    (`expert_capacity`; ties to the lower token index, as
    ``jax.lax.top_k``), runs its FFN on them, whose output is summed over
    the ranks inside the FFN (`ffn.ffn_apply` under ``ctx.col_row``) before
    it meets the gate, and sets ``he * bf16(w_e)`` (bf16) at those rows of
    a zero [T, D], which is added to an f32 sum over the experts. Summing
    before the gate keeps the combine weights' and so the router's grad
    whole and the same on every rank. The auxiliary loss runs over the
    tokens of ``ctx.dp_axes`` (`load_balance_loss`); the shared expert is
    added after, in bf16. Returns (y [B, S, D] in x.dtype, aux).

    Under data parallelism (``ctx.dp_axes``) the reference's program sees
    the whole batch: the capacity counts every dp rank's tokens and an
    expert's top ``cap`` are taken among all of them. Each rank gathers the
    ranks' combine weights (detached; token order pod-major, then data, as
    the rows lie) to pick them, and serves the picked tokens that are its
    own rows; the model ranks of one data index hold the same rows, so
    they take the same experts (an expert none of whose picked tokens is a
    rank's own is skipped there, sum and all)."""
    B, S, D = x.shape
    E = cfg.num_experts
    xf = x.reshape(B * S, D)
    T = xf.shape[0]
    combine, probs = gates(p, xf, cfg)
    w_all, lo = combine.detach(), 0
    for a in ctx.dp_axes:
        lo = lo * ctx.size(a) + ctx.coord(a)
    for a in reversed(ctx.dp_axes):
        w_all = ctx.all_gather_dim(w_all, 0, a)
    lo *= T
    cap = expert_capacity(w_all.shape[0], cfg)
    y = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    for e in range(E):
        w_e = combine[:, e]
        order = torch.sort(w_all[:, e], descending=True, stable=True).indices[:cap]
        order = order[(order >= lo) & (order < lo + T)] - lo
        if not order.numel():
            continue
        he = ffn_apply(tree_map(lambda t: t[e], p["experts"]), xf[order], cfg.ffn_activation,
                       policy, ctx)
        part = he.new_zeros((T, D)).index_put((order,), he * w_e[order, None].to(he.dtype))
        y = y + part.to(torch.float32)
    aux = load_balance_loss(combine, probs, E, ctx)
    y = y.reshape(B, S, D).to(x.dtype)
    if "shared" in p:
        y = y + ffn_apply(p["shared"], x, cfg.ffn_activation, policy, ctx)
    return y, aux


def moe_apply(p, x: torch.Tensor, cfg, policy=None, *, ctx=NO_CTX, phase: str = "seq",
              devices: int = 1):
    """The MoE FFN of one block: `moe_dense` on one device; under a ``ctx``
    of tp > 1 `moe_ep` at decode (the engine step, ``phase="decode"``) and
    `moe_tp` over a sequence in the training layout (``ctx.col_row``). MoE
    over devices without a mesh (``devices`` > 1) is not ported, nor is a
    sequence over the serving layout's expert shards."""
    tp = ctx.tp
    if devices != 1 or (tp > 1 and phase != "decode" and not ctx.col_row):
        raise NotImplementedError(
            f"MoE over {max(devices, tp)} devices outside the decode step and the training "
            "layout is not ported yet (ROADMAP.md, Modules to port)")
    if tp > 1:
        return moe_ep(p, x, cfg, ctx, policy) if phase == "decode" else moe_tp(p, x, cfg, ctx,
                                                                                 policy)
    return moe_dense(p, x, cfg, policy, ctx)
