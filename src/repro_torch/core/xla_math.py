"""XLA's CPU float math, copied for CPU tensors (the reference's compiled
step runs it; the port's CPU parity tests compare against that step bit
for bit).

The reference runs jitted on XLA's CPU backend, which evaluates exp, log
and log1p by its own polynomials (LLVM IR it emits, with the multiply-adds
contracted into fused multiply-adds by the backend), lowers ``logistic``
(``jax.nn.sigmoid``) to ``1 / (1 + exp(-x))`` and runs with f32 denormals
flushed to zero. The functions here evaluate the same expansions on CPU
tensors (constants given as LLVM prints them, `_k`) and take the device's
own math on CUDA tensors, for which no reference asks for bits:

  * `fma_f32` — a * s + b rounded once to f32;
  * `exp_f32`, `log_f32`, `log1p_f32` — the polynomials;
  * `softplus` — ``jax.nn.softplus``, ``logaddexp(x, 0)``;
  * `sigmoid_f32` — ``jax.nn.sigmoid`` of an f32 tensor;
  * `sqrt_f32` — the correctly rounded square root (torch's vectorised CPU
    sqrt is not: it can land one ulp off).
"""

from __future__ import annotations

import struct

import numpy as np
import torch


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


def _logf(u: torch.Tensor) -> torch.Tensor:
    """XLA's CPU ``log`` of a denormal-free f32 tensor (Cephes logf, its
    multiply-adds contracted as the backend contracts them): u = m 2^e with
    m in [sqrt(1/2), sqrt(2)), a degree-9 polynomial in t = m - 1; log(0) =
    -inf, log(inf) = inf, and below 0 or for NaN the NaN of all ones bits."""
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
    y = fma_f32(e, _k("3FE6300000000000"), (t - t2 * 0.5) + s)
    y = torch.where(u == float("inf"), u, y)
    y = torch.where(u == 0, torch.full_like(u, -float("inf")), y)
    nan = torch.full(u.shape, -1, dtype=torch.int32, device=u.device).view(torch.float32)
    return torch.where((u < 0) | u.isnan(), nan, y)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """log of an f32 tensor: the device's on CUDA, XLA's CPU expansion
    (`_logf`) on the CPU, with denormal inputs read as 0."""
    if x.is_cuda:
        return torch.log(x)
    return _logf(_ftz(x))


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """log1p of an f32 tensor: the device's on CUDA, XLA's CPU expansion
    on the CPU (a rational approximation below |x| 0.4142, else `_logf` of
    1 + x)."""
    if x.is_cuda:
        return torch.log1p(x)
    x = _ftz(x)
    big = _logf(x + 1.0)
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


def sigmoid_f32(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.sigmoid of an f32 tensor: the device's on CUDA; on the CPU
    ``1 / (1 + exp(-x))`` with `exp_f32`, as XLA's CPU backend expands
    ``logistic``, denormal quotients flushed to zero."""
    if x.is_cuda:
        return torch.sigmoid(x)
    return _ftz(1.0 / (exp_f32(-x) + 1.0))


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """sqrt of an f32 tensor, correctly rounded as XLA's CPU ``sqrt`` is:
    the device's on CUDA; on the CPU through f64 (a square root rounded to
    f64 and then to f32 is the correctly rounded f32 one), denormal inputs
    read as 0, and below 0 the x86 default NaN (sign bit set)."""
    if x.is_cuda:
        return torch.sqrt(x)
    x = _ftz(x)
    y = torch.sqrt(x.to(torch.float64)).to(torch.float32)
    nan = torch.full(x.shape, -4194304, dtype=torch.int32, device=x.device).view(torch.float32)
    return torch.where(x < 0, nan, y)
