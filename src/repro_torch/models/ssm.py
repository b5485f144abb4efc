"""State-space blocks: Mamba-1 (falcon-mamba) and RG-LRU (recurrentgemma)
(port of src/repro/models/ssm.py).

Both are linear recurrences h_t = a_t * h_{t-1} + b_t, over a state of
[d_inner, n] per sequence for Mamba and of [lru_width] for the RG-LRU. The
full-sequence forwards (`mamba_train`, `rglru_train`: prefill,
`models.forward_seq`) run `chunked_linear_scan`, a loop over chunks
carrying the boundary state with a scan inside each chunk; decode
(`mamba_decode`, `rglru_decode`) is the one-step recurrence, O(1) in the
sequence length. Every projection goes through `apply_linear` (K1 for
packed fp5.33 weights with ``impl="kernel"``); the scan and the gates are
plain torch, as the reference computes them in plain XLA.

The decode steps round as the reference's compiled step does, op by op
(their outputs and states are bit-equal to the jitted reference on the
CPU); XLA's CPU math (exp, log1p, logistic, fused multiply-adds) comes from
`core.xla_math`, the device's on CUDA tensors. Mamba:
  * the depthwise conv rounds every product and every add in the
    activations' dtype, in tap order, then adds the bias;
  * the dt projection's bias joins the bf16 product unrounded in f32, and
    softplus is ``logaddexp(x, 0)`` (jax.nn.softplus), not torch's
    thresholded softplus;
  * the state update ``da * h + db`` is one fused multiply-add, as XLA
    contracts it (`fma_f32`), and the read-out ``h . C + D * xc`` sums n
    as XLA's gemv does (`readout`). CUDA tensors take one f32 addcmul for
    each of these multiply-adds instead of the exact f64 product;
  * under ``impl="fused_ref"`` out_proj's input ``bf16(y) * silu(z)``
    enters the K-blocked product unrounded in f32 (XLA drops the bf16
    rounding of the product ahead of the product's f32 convert).
RG-LRU (`_rglru_elems`):
  * the conv output joins the gates' products as the f32 sum of its
    bf16 taps and its bias, unrounded (the projections read it rounded);
  * ``sigmoid`` is ``1 / (1 + exp(-x))``; of a bf16 Λ (a stacked layer's,
    cast by the engine) every op rounds to bf16 but the divide;
  * ``a * a`` is ``exp(log_a + log_a)`` (XLA rewrites the product of two
    exps), and ``a * h + b`` one fused multiply-add.
Tensor parallelism (a `models.parallel.ParallelCtx` of tp > 1, the
reference's serving layout): a rank holds d_inner / tp (lru_width / tp)
channels of the inner width: its slices of the conv, A_log, D, Λ, the
states, and the N-shards of every projection (``in_proj``'s slices of both
its x and z halves). The conv, exp(dt A), the state update and the
read-out act per channel, so they run on the rank's channels as they run
on all of them; a projection whose K is the inner width (``x_proj``,
``out_proj``, the RG-LRU's gates) gets its input gathered whole first, so
every contraction keeps its K whole and tp > 1 gives tp = 1's bits.
The served engine casts every stacked leaf of ndim >= 2 to bf16
(`launch.engine.prepare_params`), so A_log, D, Λ, the conv bias and the dt
bias are bf16 there and ``A = -exp(A_log)`` is rounded to bf16, as in the
reference's engine; a hybrid model's unstacked tail keeps its 1-D leaves
f32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.xla_math import (  # noqa: F401  (also imported from here)
    exp_f32,
    fma_f32,
    log1p_f32,
    sigmoid_f32,
    softplus,
    sqrt_f32,
)

from .common import apply_linear, make_linear
from .ffn import gelu, silu
from .parallel import NO_CTX


# ---------------------------------------------------------------- scan core
def chunked_linear_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                        chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + b_t along axis 1. a, b: [B, S, ...]; h0: [B, ...].

    Returns (h over all t [B, S, ...], final state [B, ...]). Inside a chunk
    the prefix products and sums come from a doubling scan (log2(chunk)
    vectorised steps); the association differs from the reference's
    ``lax.associative_scan``, so results agree to f32 rounding, not bit for
    bit."""
    S = a.shape[1]
    ch = min(chunk, S)
    hs, h = [], h0
    for s0 in range(0, S, ch):
        pa, pb = a[:, s0:s0 + ch], b[:, s0:s0 + ch]
        step = 1
        while step < pa.shape[1]:
            # element t combines with t - step: (a', b') = (a_s a_t, a_t b_s + b_t)
            pa, pb = (torch.cat([pa[:, :step], pa[:, step:] * pa[:, :-step]], dim=1),
                      torch.cat([pb[:, :step], pa[:, step:] * pb[:, :-step] + pb[:, step:]],
                                dim=1))
            step *= 2
        hj = pb + pa * h[:, None]
        hs.append(hj)
        h = hj[:, -1]
    return torch.cat(hs, dim=1), h


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                  state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: [B, S, C]; w: [width, C]; state: [B, width-1, C].

    Returns (y [B, S, C], new_state [B, width-1, C]); every product and add
    rounds in x.dtype, taps in order."""
    width, S = w.shape[0], x.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xe = torch.cat([state.to(x.dtype), x], dim=1)          # [B, S + w - 1, C]
    wx = w.to(x.dtype)
    y = xe[:, 0:S] * wx[0]
    for i in range(1, width):
        y = y + xe[:, i:i + S] * wx[i]
    if b is not None:
        y = y + b.to(y.dtype)
    new_state = xe[:, S:] if width > 1 else state
    return y, new_state


def readout(h: torch.Tensor, c: torch.Tensor, d: torch.Tensor, xc: torch.Tensor):
    """y = sum_n h[..., n] c[..., n] + d * xc in f32 (h [..., di, n], c
    [..., 1, n], d [di], xc [..., di]), summed as the reference's compiled
    step sums it on the CPU: over several rows XLA's gemv keeps 8 lanes,
    lane j accumulating n = j, j + 8, ... by fused multiply-adds, then adds
    the lanes pairwise, ((0+1)+(2+3))+((4+5)+(6+7)); a single row becomes a
    loop of fused multiply-adds in n order. On CUDA every row takes the
    lanes, so a row's bits never depend on the batch. The skip term is
    fused last."""
    n = h.shape[-1]
    if h[..., 0, 0].numel() == 1 and not h.is_cuda:
        y = h[..., 0] * c[..., 0]
        for j in range(1, n):
            y = fma_f32(h[..., j], c[..., j], y)
    else:
        if n % 8:
            raise NotImplementedError(f"the read-out sums ssm_state in lanes of 8; got {n}")
        v = h[..., 0:8] * c[..., 0:8]
        for j in range(8, n, 8):
            v = fma_f32(h[..., j:j + 8], c[..., j:j + 8], v)
        v = v[..., 0::2] + v[..., 1::2]
        v = v[..., 0::2] + v[..., 1::2]
        y = v[..., 0] + v[..., 1]
    return fma_f32(d.to(torch.float32), xc, y)


# -------------------------------------------------------------------- Mamba1
def _row_parallel(p, x, policy, ctx):
    """A projection whose K is the inner width, of a rank's channels x: at
    tp > 1 x is gathered whole, the rank's N-shard contracts it, and the
    N-shards are gathered (the reference's serving layout N-shards these
    row-parallel linears)."""
    if ctx.tp == 1:
        return apply_linear(p, x, policy)
    return ctx.all_gather_last(apply_linear(p, ctx.all_gather_last(x), policy, ctx.tp))


def _gated_out(p, y, z, policy, ctx=NO_CTX):
    """out_proj(bf16(y) * silu(z)) for Mamba (y f32, z in the activations'
    dtype). Under ``impl="fused_ref"`` with packed weights the product
    enters the K-blocked f32 product unrounded, as in the reference's
    compiled step (XLA drops the rounding of the bf16 product ahead of the
    f32 convert that `ams_matmul_blocked` starts with); the output rounds
    to the activations' dtype as ever. ``ctx``: `_row_parallel`."""
    if policy is not None and policy.impl == "fused_ref" and "w" not in p:
        g = y.to(z.dtype).to(torch.float32) * silu(z).to(torch.float32)
        return _row_parallel(p, g, policy, ctx).to(z.dtype)
    return _row_parallel(p, y.to(z.dtype) * silu(z), policy, ctx)


def init_mamba(gen: torch.Generator, cfg, *, dtype=torch.float32, device="cpu"):
    """Mamba-1 mixer params from ``gen`` (draw order: in_proj, conv_w,
    x_proj, dt_proj, out_proj); A_log and D are f32 as in the reference."""
    D, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dt_rank = cfg.dt_rank or max(1, D // 16)
    kw = dict(dtype=dtype, device=device)
    A = torch.arange(1, n + 1, dtype=torch.float32, device=device)[None, :].repeat(di, 1)
    return {
        "in_proj": make_linear(gen, D, 2 * di, **kw),
        "conv_w": (torch.randn((cfg.ssm_conv, di), generator=gen, dtype=torch.float32,
                               device=device) * np.float32(1.0 / np.sqrt(cfg.ssm_conv))).to(dtype),
        "conv_b": torch.zeros((di,), **kw),
        "x_proj": make_linear(gen, di, dt_rank + 2 * n, **kw),
        "dt_proj": make_linear(gen, dt_rank, di, bias=True, **kw),
        "A_log": torch.log(A),
        "D": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": make_linear(gen, di, D, **kw),
    }


def _mamba_core(p, xc, cfg, policy, ctx=NO_CTX):
    """xc: [B, S, di] post-conv activations -> (da, db, C) scan elements.
    Under a tp > 1 ``ctx`` xc holds the rank's channels: ``x_proj`` reads
    it gathered and its output is gathered whole (`_row_parallel`), so
    dt_proj's K (dt_rank) is whole, and its N-shard gives the rank's
    channels of dt."""
    n = cfg.ssm_state
    dt_rank = cfg.dt_rank or max(1, cfg.d_model // 16)
    xdb = _row_parallel(p["x_proj"], xc, policy, ctx)
    dt_r = xdb[..., :dt_rank]
    Bc = xdb[..., dt_rank: dt_rank + n]
    Cc = xdb[..., dt_rank + n:]
    # the bias joins the bf16 product unrounded in f32 (XLA keeps the
    # excess precision of ``y + b`` into the f32 softplus)
    w = {k: v for k, v in p["dt_proj"].items() if k != "b"}
    dt = (apply_linear(w, dt_r, policy, ctx.tp).to(torch.float32)
          + p["dt_proj"]["b"].to(torch.float32))
    dt = softplus(dt)
    A = -exp_f32(p["A_log"].to(torch.float32)).to(p["A_log"].dtype)    # [di, n]
    da = exp_f32(dt[..., None] * A.to(torch.float32))                   # [B, S, di, n]
    db = (dt[..., None] * Bc[:, :, None, :].to(torch.float32)) * xc[..., None].to(torch.float32)
    return da, db, Cc


def mamba_train(p, x, cfg, *, policy=None, chunk=256):
    """x: [B, S, D] -> (y [B, S, D], (conv_state, ssm_state) final)."""
    di, n = cfg.d_inner, cfg.ssm_state
    xz = apply_linear(p["in_proj"], x, policy)
    x_in, z = xz[..., :di], xz[..., di:]
    xc, conv_state = causal_conv1d(x_in, p["conv_w"], p["conv_b"])
    xc = silu(xc)
    da, db, Cc = _mamba_core(p, xc, cfg, policy)
    h0 = torch.zeros((x.shape[0], di, n), dtype=torch.float32, device=x.device)
    hs, hN = chunked_linear_scan(da, db, h0, chunk)           # [B, S, di, n]
    y = readout(hs, Cc.to(torch.float32)[:, :, None, :], p["D"], xc.to(torch.float32))
    return _gated_out(p["out_proj"], y, z, policy), (conv_state, hN)


def mamba_decode(p, x, conv_state, ssm_state, cfg, *, policy=None,
                 live: Optional[torch.Tensor] = None, ctx=NO_CTX):
    """x: [B, 1, D]; conv_state [B, w-1, di]; ssm_state [B, di, n] f32.

    Returns (y [B, 1, D], (conv_state, ssm_state)). With ``live`` [B]
    (bool), the states of rows that are not live come back exactly as they
    were (the reference advances every row; an idle slot's garbage is
    harmless there because admission zeroes it, but the port's graph
    warm-up runs a step with every slot idle over live states). Under a
    tp > 1 ``ctx`` the params and states are the rank's d_inner / tp
    channels (``in_proj``'s N-shard is [x slice | z slice])."""
    di = cfg.d_inner // ctx.tp
    xz = apply_linear(p["in_proj"], x, policy, ctx.tp)
    x_in, z = xz[..., :di], xz[..., di:]
    xc, new_conv = causal_conv1d(x_in, p["conv_w"], p["conv_b"], conv_state)
    xc = silu(xc)
    da, db, Cc = _mamba_core(p, xc, cfg, policy, ctx)
    h = fma_f32(da[:, 0], ssm_state, db[:, 0])                # [B, di, n]
    y = readout(h, Cc[:, 0].to(torch.float32)[:, None, :], p["D"], xc[:, 0].to(torch.float32))
    if live is not None:
        new_conv = torch.where(live[:, None, None], new_conv, conv_state)
        h = torch.where(live[:, None, None], h, ssm_state)
    tp_kw = {"ctx": ctx} if ctx.tp > 1 else {}     # one device: the four-argument call
    return _gated_out(p["out_proj"], y[:, None], z, policy, **tp_kw), (new_conv, h)


# -------------------------------------------------------------------- RG-LRU
def init_rglru(gen: torch.Generator, cfg, *, dtype=torch.float32, device="cpu"):
    """RG-LRU mixer params from ``gen`` (draw order: in_x, in_gate, conv_w,
    w_rec_gate, w_in_gate, out_proj); Λ is f32 as in the reference."""
    D, W = cfg.d_model, cfg.lru_width
    kw = dict(dtype=dtype, device=device)
    return {
        "in_x": make_linear(gen, D, W, **kw),
        "in_gate": make_linear(gen, D, W, **kw),
        "conv_w": (torch.randn((4, W), generator=gen, dtype=torch.float32, device=device)
                   * 0.5).to(dtype),
        "conv_b": torch.zeros((W,), **kw),
        "w_rec_gate": make_linear(gen, W, W, **kw),     # r_t
        "w_in_gate": make_linear(gen, W, W, **kw),      # i_t
        "lam": torch.full((W,), 2.0, dtype=torch.float32, device=device),   # Λ
        "out_proj": make_linear(gen, W, D, **kw),
    }


def _neg8_sigmoid(lam: torch.Tensor) -> torch.Tensor:
    """-8 sigmoid(Λ) in f32. Of an f32 Λ, `sigmoid_f32`; of a bf16 one the
    compiled step rounds exp(-Λ) and 1 + exp(-Λ) to bf16, divides in f32
    and rounds the quotient (times -8, exact) to bf16."""
    if lam.dtype == torch.float32:
        return sigmoid_f32(lam) * -8.0
    e = exp_f32(-lam.to(torch.float32)).to(lam.dtype).to(torch.float32)
    d = (e + 1.0).to(lam.dtype).to(torch.float32)
    return (1.0 / d).to(lam.dtype).to(torch.float32) * -8.0


def _rglru_elems(p, u, u32, policy, ctx=NO_CTX):
    """u [B, S, W] (the conv output rounded, the projections' input) and
    u32 (unrounded, f32) -> (a, b) recurrence elements, f32:
    r, i = sigmoid(W_r u), sigmoid(W_i u); log a = -8 sigmoid(Λ) r;
    b = sqrt(max(1 - a^2, 1e-12)) (i u). Under a tp > 1 ``ctx`` u holds
    the rank's channels: it is gathered whole once, and the gates'
    N-shards give the rank's channels of r and i."""
    tp = ctx.tp
    uw = ctx.all_gather_last(u)
    r = sigmoid_f32(apply_linear(p["w_rec_gate"], uw, policy, tp).to(torch.float32))
    i = sigmoid_f32(apply_linear(p["w_in_gate"], uw, policy, tp).to(torch.float32))
    log_a = _neg8_sigmoid(p["lam"]) * r
    a = exp_f32(log_a)
    b = sqrt_f32(torch.clamp_min(1.0 - exp_f32(log_a + log_a), 1e-12)) * (i * u32)
    return a, b


def _rglru_in(p, x, conv_state, policy, shards: int = 1):
    """The block's two branches up to the recurrence: (gate, u, u32,
    new_conv_state), u32 the f32 sum of the conv's rounded taps and its
    bias (in x.dtype), u that sum rounded. ``shards`` > 1: the rank's
    channels (N-shards of ``in_gate`` and ``in_x``)."""
    gate = gelu(apply_linear(p["in_gate"], x, policy, shards))
    taps, new_conv = causal_conv1d(apply_linear(p["in_x"], x, policy, shards), p["conv_w"],
                                   None, conv_state)
    u32 = taps.to(torch.float32) + p["conv_b"].to(x.dtype).to(torch.float32)
    return gate, u32.to(x.dtype), u32, new_conv


def rglru_train(p, x, cfg, *, policy=None, chunk=256):
    """x: [B, S, D] -> (y [B, S, D], (conv_state, rec_state) final)."""
    gate, u, u32, conv_state = _rglru_in(p, x, None, policy)
    a, b = _rglru_elems(p, u, u32, policy)
    h0 = torch.zeros((x.shape[0], cfg.lru_width), dtype=torch.float32, device=x.device)
    hs, hN = chunked_linear_scan(a, b, h0, chunk)               # [B, S, W]
    return apply_linear(p["out_proj"], hs.to(x.dtype) * gate, policy), (conv_state, hN)


def rglru_decode(p, x, conv_state, rec_state, cfg, *, policy=None,
                 live: Optional[torch.Tensor] = None, ctx=NO_CTX):
    """x: [B, 1, D]; conv_state [B, 3, W]; rec_state [B, W] f32.

    Returns (y [B, 1, D], (conv_state, rec_state)); with ``live`` [B]
    (bool) the states of rows that are not live come back exactly as they
    were (as `mamba_decode`). Under a tp > 1 ``ctx`` the params and states
    are the rank's W / tp channels."""
    gate, u, u32, new_conv = _rglru_in(p, x, conv_state, policy, ctx.tp)
    a, b = _rglru_elems(p, u, u32, policy, ctx)
    h = fma_f32(a[:, 0], rec_state, b[:, 0])                      # [B, W]
    y = h[:, None].to(x.dtype) * gate
    if live is not None:
        new_conv = torch.where(live[:, None, None], new_conv, conv_state)
        h = torch.where(live[:, None], h, rec_state)
    return _row_parallel(p["out_proj"], y, policy, ctx), (new_conv, h)
