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
    sqrt is not: it can land one ulp off);
  * `rsqrt_f32` — the hardware estimate refined by two Newton steps, as
    XLA's CPU backend emits ``rsqrt`` (a small C++ helper on the same
    instruction, `csrc/xla_cpu.cpp`, built with ``g++`` at first use,
    `cpu_library`);
  * `row_sum_f32`, `sum_squares_f32` — a row's sum (of squares) in the
    order XLA's CPU backend reduces it (windows of 32 in index order,
    repeated, then the partials; a row of 32 or fewer squares as a chain
    of fused multiply-adds);
  * `bf16_dot` — a product of bf16 operands summed into f32 as XLA's CPU
    dot sums it on a CPU with AVX512-BF16 (`pairs_bf16_dot` says where);
  * `cos_f32` — the C library's ``cosf``, which XLA's CPU backend calls.

On CPU tensors that require grad, exp, log, log1p, sigmoid, sqrt and
rsqrt differentiate as JAX defines their derivatives, from the primal
output (exp: g y; log: g / x; log1p: g / (1 + x); sigmoid: g y (1 - y);
sqrt: g 0.5 / y; rsqrt: g (-0.5 y / x)), not through the expansions'
bit operations, which carry no gradient.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import hashlib
import os
import subprocess
import struct
from pathlib import Path

import numpy as np
import torch


class _Primal(torch.autograd.Function):
    """y = fwd(x) with the derivative dfn(g, x, y): the expansions below
    compute their bits with integer and select operations that carry no
    gradient, so on the CPU they differentiate as JAX defines the op."""

    @staticmethod
    def forward(ctx, x, fwd, dfn):
        y = fwd(x)
        ctx.save_for_backward(x, y)
        ctx.dfn = dfn
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return ctx.dfn(g, x, y), None, None


def _differentiable(fwd, dfn):
    """``fwd`` on CPU tensors, through `_Primal` where a gradient is asked."""
    def f(x):
        if torch.is_grad_enabled() and x.requires_grad:
            return _Primal.apply(x, fwd, dfn)
        return fwd(x)
    f.__name__, f.__doc__ = fwd.__name__, fwd.__doc__
    return f


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
    return _exp_grad(x)


def _exp_cpu(x: torch.Tensor) -> torch.Tensor:
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


_exp_grad = _differentiable(_exp_cpu, lambda g, x, y: g * y)


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
    return _log_grad(x)


_log_grad = _differentiable(lambda x: _logf(_ftz(x)), lambda g, x, y: g / x)


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """log1p of an f32 tensor: the device's on CUDA, XLA's CPU expansion
    on the CPU (a rational approximation below |x| 0.4142, else `_logf` of
    1 + x)."""
    if x.is_cuda:
        return torch.log1p(x)
    return _log1p_grad(x)


def _log1p_cpu(x: torch.Tensor) -> torch.Tensor:
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


_log1p_grad = _differentiable(_log1p_cpu, lambda g, x, y: g / (x + 1.0))


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
    return _sigmoid_grad(x)


_sigmoid_grad = _differentiable(lambda x: _ftz(1.0 / (_exp_cpu(-x) + 1.0)),
                                lambda g, x, y: g * (y * (1.0 - y)))


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """sqrt of an f32 tensor, correctly rounded as XLA's CPU ``sqrt`` is:
    the device's on CUDA; on the CPU through f64 (a square root rounded to
    f64 and then to f32 is the correctly rounded f32 one), denormal inputs
    read as 0, and below 0 the x86 default NaN (sign bit set)."""
    if x.is_cuda:
        return torch.sqrt(x)
    return _sqrt_grad(x)


def _sqrt_cpu(x: torch.Tensor) -> torch.Tensor:
    x = _ftz(x)
    y = torch.sqrt(x.to(torch.float64)).to(torch.float32)
    nan = torch.full(x.shape, -4194304, dtype=torch.int32, device=x.device).view(torch.float32)
    return torch.where(x < 0, nan, y)


_sqrt_grad = _differentiable(_sqrt_cpu, lambda g, x, y: g * (0.5 / y))


_CSRC = Path(__file__).resolve().parent / "csrc" / "xla_cpu.cpp"
_BUILD = Path(__file__).resolve().parents[1] / "kernels" / "_build"
_GXX_FLAGS = ("-O2", "-mavx", "-mfma", "-ffp-contract=off", "-shared", "-fPIC")
_CPU_LIB = None


def cpu_library() -> ctypes.CDLL:
    """`csrc/xla_cpu.cpp` (XLA's CPU rsqrt) built
    with ``g++`` at first use into the kernels' git-ignored build directory
    (named by a hash of the source and the flags) and loaded with ctypes.
    Raises when it cannot be built."""
    global _CPU_LIB
    if _CPU_LIB is None:
        text = _CSRC.read_bytes() + " ".join(_GXX_FLAGS).encode()
        out = _BUILD / f"xla_cpu-{hashlib.sha1(text).hexdigest()[:12]}.so"
        if not out.exists():
            _BUILD.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(["g++", *_GXX_FLAGS, "-o", str(tmp), str(_CSRC)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ could not build {_CSRC.name}:\n{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        lib.xla_rsqrt_f32.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64)
        lib.xla_rsqrt_f32.restype = None
        _CPU_LIB = lib
    return _CPU_LIB


def _rsqrt_cpu(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.float32:
        raise TypeError(f"rsqrt_f32 takes f32 tensors, got {x.dtype}")
    x = x.contiguous()
    y = torch.empty_like(x)
    cpu_library().xla_rsqrt_f32(x.data_ptr(), y.data_ptr(), x.numel())
    return y


_rsqrt_grad = _differentiable(_rsqrt_cpu, lambda g, x, y: g * (-0.5 * (y / x)))


def rsqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """1 / sqrt of an f32 tensor: the device's on CUDA; on the CPU as XLA's
    CPU backend emits ``rsqrt`` (`csrc/xla_cpu.cpp`: the hardware
    estimate, two Newton steps of two fused multiply-adds each, the estimate
    kept for zeros, infinities, denormals and negative inputs)."""
    if x.is_cuda:
        return torch.rsqrt(x)
    return _rsqrt_grad(x)


def row_sum_f32(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis (kept) of an f32 CPU tensor in XLA's CPU
    order: while a row is wider than 32, it is padded with zeros to a
    multiple of 32 (half the pad ahead, the rest behind) and each window of
    32 summed in index order; the last 32 or fewer partials are then
    summed in index order."""
    n = x.shape[-1]
    while n > 32:
        m = -(-n // 32) * 32
        lo = (m - n) // 2
        parts = torch.nn.functional.pad(x, (lo, m - n - lo)).reshape(*x.shape[:-1], m // 32, 32)
        x = sum_in_order(parts)
        n = m // 32
    return sum_in_order(x)[..., None]


def sum_squares_f32(x: torch.Tensor) -> torch.Tensor:
    """The sum of squares over the last axis (kept) of an f32 CPU tensor, as
    XLA's CPU backend computes ``sum(x * x)``: over more than 32 values the
    squares are rounded and summed by `row_sum_f32`; over 32 or fewer the
    square is fused into the reduce loop, which the code generator
    contracts into a chain of fused multiply-adds in index order."""
    n = x.shape[-1]
    if n > 32:
        return row_sum_f32(x * x)
    s = x[..., 0:1] * x[..., 0:1]
    for j in range(1, n):
        s = fma_f32(x[..., j:j + 1], x[..., j:j + 1], s)
    return s


def _cpu_has_bf16_dot() -> bool:
    """Whether this CPU has AVX512-BF16, whose ``vdpbf16ps`` XLA's CPU
    runtime uses for bf16 x bf16 dots (read from /proc/cpuinfo; False where
    that cannot be read)."""
    try:
        with open("/proc/cpuinfo") as f:
            return any(line.startswith("flags") and " avx512_bf16" in line for line in f)
    except OSError:
        return False


_BF16_DOT = _cpu_has_bf16_dot()


def pairs_bf16_dot(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether `bf16_dot` copies XLA's order for these operands: two bf16
    CPU tensors on a CPU with AVX512-BF16."""
    return (_BF16_DOT and not a.is_cuda and a.dtype == torch.bfloat16
            and b.dtype == torch.bfloat16)


def bf16_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_d a[..., d] b[..., d] in f32 over the last axis of two bf16
    tensors whose other axes broadcast, in the order XLA's CPU dot sums bf16
    operands into f32 on a CPU with AVX512-BF16 (`vdpbf16ps`): the pairs
    (2i, 2i + 1) in index order, each pair's odd product added first, every
    add rounded (a product of two bf16 values is exact in f32). An odd
    length ends with a pair of a zero and the last product. Differentiable."""
    af, bf = a.to(torch.float32), b.to(torch.float32)
    K = a.shape[-1]
    s = None
    for i in range(0, K, 2):
        for j in (i + 1, i):
            if j < K:
                t = af[..., j] * bf[..., j]
                s = t if s is None else s + t
    return s


_LIBM = None


def _libm() -> ctypes.CDLL:
    """The C library's math, with ``cosf`` typed for f32."""
    global _LIBM
    if _LIBM is None:
        lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
        lib.cosf.argtypes, lib.cosf.restype = (ctypes.c_float,), ctypes.c_float
        _LIBM = lib
    return _LIBM


def cos_f32(x: torch.Tensor) -> torch.Tensor:
    """cos of an f32 tensor: the device's on CUDA; on the CPU the C
    library's ``cosf``, which XLA's CPU backend calls for ``cosine``
    (element by element through ctypes: meant for small tensors, such as a
    learning-rate schedule's)."""
    if x.is_cuda:
        return torch.cos(x)
    lib = _libm()
    flat = x.detach().to(torch.float32).reshape(-1).tolist()
    return torch.tensor([lib.cosf(v) for v in flat], dtype=torch.float32).reshape(x.shape)


def sum_in_order(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` in index order, as XLA's CPU loop reduces."""
    x = x.movedim(dim, 0)
    s = x[0]
    for j in range(1, x.shape[0]):
        s = s + x[j]
    return s
