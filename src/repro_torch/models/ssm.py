"""Mamba-1 state-space blocks (falcon-mamba; port of the Mamba half of
src/repro/models/ssm.py).

The block is a linear recurrence h_t = a_t * h_{t-1} + b_t over a state of
[d_inner, n] per sequence. The full-sequence forward (`mamba_train`:
prefill, `models.forward_seq`) runs `chunked_linear_scan`, a loop over
chunks carrying the boundary state with a scan inside each chunk; decode
(`mamba_decode`) is the one-step recurrence, O(1) in the sequence length.
All four projections go through `apply_linear` (K1 for packed fp5.33
weights with ``impl="kernel"``); the scan itself is plain torch, as the
reference computes it in plain XLA.

The decode step rounds as the reference's compiled step does, op by op
(`mamba_decode`'s output and states are bit-equal to the jitted reference
on the CPU):
  * the depthwise conv rounds every product and every add in the
    activations' dtype, in tap order, then adds the bias;
  * the dt projection's bias joins the bf16 product unrounded in f32, and
    softplus is ``logaddexp(x, 0)`` (jax.nn.softplus), not torch's
    thresholded softplus;
  * exp and log1p are XLA's CPU polynomials on CPU tensors (`exp_f32`,
    `log1p_f32`), the device's on CUDA;
  * the state update ``da * h + db`` is one fused multiply-add, as XLA
    contracts it (`fma_f32`), and the read-out ``h . C + D * xc`` sums n
    as XLA's gemv does (`readout`). CUDA tensors take one f32 addcmul for
    each of these multiply-adds instead of the exact f64 product.
The served engine casts every stacked leaf of ndim >= 2 to bf16
(`launch.engine.prepare_params`), so A_log, D, the conv bias and the dt
bias are bf16 there and ``A = -exp(A_log)`` is rounded to bf16, as in the
reference's engine.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np
import torch

from .common import apply_linear, make_linear
from .ffn import silu


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


def fma_f32(a: torch.Tensor, s, b) -> torch.Tensor:
    """a * s + b rounded once to f32, for f32 operands (tensors, or Python
    floats that are f32 values): the product is exact in f64, so only the
    f64 sum rounds before the f32 rounding (a fused multiply-add but for a
    double rounding, which needs the f64 sum to land on an f32 tie: not met
    in practice). CPU tensors take one addcmul computed in f64, for the
    reference's bits; CUDA tensors one f32 addcmul (no f64 copies on the
    decode tick; no reference asks for the card's bits, and the product may
    round there before the add)."""
    if torch.is_tensor(s) and torch.is_tensor(b):
        if a.is_cuda:
            return torch.addcmul(b, a, s)
        return torch.addcmul(b.to(torch.float64), a, s).to(torch.float32)

    def f64(t):
        return t.to(torch.float64) if torch.is_tensor(t) else t
    return (f64(a) * f64(s) + f64(b)).to(torch.float32)


def _k(hex_double: str) -> float:
    """An f32 constant of XLA's CPU math, given as LLVM prints it."""
    return float(np.float32(struct.unpack(">d", bytes.fromhex(hex_double))[0]))


def _ftz(t: torch.Tensor) -> torch.Tensor:
    """Flush f32 denormals to zero, as the reference's CPU step runs."""
    return torch.where(t.abs() < 2.0 ** -126, torch.zeros_like(t), t)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """exp of an f32 tensor. On CUDA the device's expf; on the CPU the
    polynomial XLA's CPU backend emits for ``exponential`` (Cephes expf,
    its multiply-adds fused, denormals flushed), so CPU results are the
    reference's compiled bits."""
    if x.is_cuda:
        return torch.exp(x)
    x = torch.clamp(_ftz(x), _k("C055F33340000000"), _k("4056333340000000"))
    fx = torch.floor(fma_f32(x, _k("3FF7154760000000"), 0.5)).clamp(-127.0, 127.0)
    r = fma_f32(-fx, _k("3FE6300000000000"), x)
    r = fma_f32(-fx, _k("BF2BD01060000000"), r)
    p = fma_f32(r, _k("3F2A0D2CE0000000"), _k("3F56E879C0000000"))
    for c in ("3F81112100000000", "3FA5553820000000", "3FC5555540000000"):
        p = fma_f32(p, r, _k(c))
    p = fma_f32(p, r, 0.5)
    y = fma_f32(p, r * r, r) + 1.0
    return _ftz(y * ((fx.to(torch.int32) + 127) << 23).view(torch.float32))


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """log1p of an f32 tensor: the device's on CUDA, XLA's CPU expansion on
    the CPU (a rational approximation below |x| 0.4142, else Cephes logf of
    1 + x; multiply-adds fused as LLVM contracts them)."""
    if x.is_cuda:
        return torch.log1p(x)
    x = _ftz(x)
    # |x| >= 0.4142: log(u), u = 1 + x = m 2^e with m in [sqrt(1/2), sqrt(2))
    u = x + 1.0
    bits = torch.clamp_min(u, 2.0 ** -126).view(torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    low = m < _k("3FE6A09E60000000")
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0 - low.to(torch.float32)
    t = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    t2 = t * t
    t3 = t2 * t
    a = fma_f32(fma_f32(t, _k("3FB2043760000000"), _k("BFBD7A3700000000")), t,
                _k("3FBDE4A340000000"))
    b = fma_f32(fma_f32(t, _k("BFBFCBA9E0000000"), _k("3FC23D37E0000000")), t,
                _k("BFC555CA00000000"))
    c = fma_f32(fma_f32(t, _k("3FC999D580000000"), _k("BFCFFFFF80000000")), t,
                _k("3FD5555540000000"))
    q = fma_f32(fma_f32(a, t3, b), t3, c)
    s = fma_f32(q, t3, e * _k("BF2BD01060000000"))
    big = fma_f32(e, _k("3FE6300000000000"), (t - t2 * 0.5) + s)
    big = torch.where(u == float("inf"), u, big)
    big = torch.where(u == 0, torch.full_like(u, -float("inf")), big)
    big = torch.where(u < 0, torch.full_like(u, float("nan")), big)
    # |x| < 0.4142: x - x^2 / 2 + x^3 Q(x) / P(x)
    p = fma_f32(torch.ones_like(x), x, _k("402E2035A0000000"))
    for k in ("4054C30B60000000", "406BB865A0000000", "4073519460000000",
              "406B0DB140000000", "404E0F3040000000"):
        p = fma_f32(p, x, _k(k))
    qn = fma_f32(torch.full_like(x, _k("3F07BC0960000000")), x, _k("3FDFE818A0000000"))
    for k in ("401A509F40000000", "403DE97380000000", "404E798EC0000000",
              "404C8E75A0000000", "40340A2020000000"):
        qn = fma_f32(qn, x, _k(k))
    x2 = x * x
    small = x + (x2 * -0.5 + (x * x2) * (qn / p))
    return _ftz(torch.where(x.abs() < _k("3FDA8279A0000000"), small, big))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus, ``logaddexp(x, 0)`` = max(x, 0) + log1p(exp(-|x|)),
    not torch's thresholded softplus."""
    return torch.clamp_min(x, 0.0) + log1p_f32(exp_f32(-x.abs()))


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


def _mamba_core(p, xc, cfg, policy):
    """xc: [B, S, di] post-conv activations -> (da, db, C) scan elements."""
    n = cfg.ssm_state
    dt_rank = cfg.dt_rank or max(1, cfg.d_model // 16)
    xdb = apply_linear(p["x_proj"], xc, policy)
    dt_r = xdb[..., :dt_rank]
    Bc = xdb[..., dt_rank: dt_rank + n]
    Cc = xdb[..., dt_rank + n:]
    # the bias joins the bf16 product unrounded in f32 (XLA keeps the
    # excess precision of ``y + b`` into the f32 softplus)
    w = {k: v for k, v in p["dt_proj"].items() if k != "b"}
    dt = apply_linear(w, dt_r, policy).to(torch.float32) + p["dt_proj"]["b"].to(torch.float32)
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
    y = y.to(x.dtype) * silu(z)
    return apply_linear(p["out_proj"], y, policy), (conv_state, hN)


def mamba_decode(p, x, conv_state, ssm_state, cfg, *, policy=None,
                 live: Optional[torch.Tensor] = None):
    """x: [B, 1, D]; conv_state [B, w-1, di]; ssm_state [B, di, n] f32.

    Returns (y [B, 1, D], (conv_state, ssm_state)). With ``live`` [B]
    (bool), the states of rows that are not live come back exactly as they
    were (the reference advances every row; an idle slot's garbage is
    harmless there because admission zeroes it, but the port's graph
    warm-up runs a step with every slot idle over live states)."""
    di = cfg.d_inner
    xz = apply_linear(p["in_proj"], x, policy)
    x_in, z = xz[..., :di], xz[..., di:]
    xc, new_conv = causal_conv1d(x_in, p["conv_w"], p["conv_b"], conv_state)
    xc = silu(xc)
    da, db, Cc = _mamba_core(p, xc, cfg, policy)
    h = fma_f32(da[:, 0], ssm_state, db[:, 0])                # [B, di, n]
    y = readout(h, Cc[:, 0].to(torch.float32)[:, None, :], p["D"], xc[:, 0].to(torch.float32))
    y = (y.to(x.dtype) * silu(z[:, 0]))[:, None]
    if live is not None:
        new_conv = torch.where(live[:, None, None], new_conv, conv_state)
        h = torch.where(live[:, None, None], h, ssm_state)
    return apply_linear(p["out_proj"], y, policy), (new_conv, h)
