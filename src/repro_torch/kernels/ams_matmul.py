"""K1 and K1b: fused AMS dequantize + matmul (port of
src/repro/kernels/ams_matmul.py: ams_matmul_padded -> _kernel_fp533 for the
fp533 container, _kernel_planes for the planes container).

`ams_matmul_fp533` (K1) and `ams_matmul_planes` (K1b) are the wrappers: on
CUDA tensors they launch the CUDA kernel in ``csrc/ams_matmul.cu`` (what
bounds it and how its design answers that are noted there), on CPU
tensors they run `ams_matmul_fp533_plain` / `ams_matmul_planes_plain`, the
kernels' plain torch versions. K1 and K1b run one tensor-core kernel
behind a decode hook per container (fp533; the planes of every hi width
from 4 to 8 bits, i.e. per_word 8, 6, 5 and 4), planned by
`tuning.plan_ams_matmul`. All compute

    y[b, n] = (bf16(x)[b, :] @ DeQ(W)[:, n]) * scale[n]

with f32 accumulation and the per-channel scale applied once at the end.
Every base format has at most 3 mantissa bits, so decoded weights are exact
in bf16 and bf16 x weight products are exact in f32: kernel and plain
version differ only by summation order.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.formats import code_to_value, get_format
from repro_torch.core.packing import PackLayout

from .build import KernelCount, check_device, library, stream_ptr
from .tuning import plan_ams_matmul

E2M3 = get_format("e2m3")
COUNT = KernelCount("ams_matmul_fp533")
COUNT_PLANES = KernelCount("ams_matmul_planes")


def unpack_fp533(hi: torch.Tensor) -> torch.Tensor:
    """fp533 words [Kp/6, N] -> full e2m3 codes [Kp, N] in position order:
    each 16-bit half holds three 5-bit high parts and a shared LSB (bit 15)."""
    w = hi.to(torch.int64) & 0xFFFFFFFF
    out = []
    for h in range(2):
        half = (w >> (16 * h)) & 0xFFFF
        shared = (half >> 15) & 1
        for j in range(3):
            out.append((((half >> (5 * j)) & 0x1F) << 1) | shared)
    return torch.stack(out, dim=1).reshape(-1, hi.shape[1]).to(torch.int32)


def ams_matmul_fp533_plain(x: torch.Tensor, hi: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K1 on padded operands: x [B, Kp] (any float
    type; rounded to bf16 like the kernel), hi [Kp/6, N] int32, scale [N]
    f32 -> f32 [B, N]."""
    if x.is_cuda:
        COUNT.plain_on_cuda += 1
    w = code_to_value(E2M3, unpack_fp533(hi))
    xb = x.to(torch.bfloat16).to(torch.float32)
    return (xb @ w) * scale.to(torch.float32)


def _check(x, hi, scale):
    if x.dim() != 2 or hi.dim() != 2 or scale.dim() != 1:
        raise ValueError(f"expected x [B, Kp], hi [Kp/6, N], scale [N]; got "
                         f"{tuple(x.shape)}, {tuple(hi.shape)}, {tuple(scale.shape)}")
    if x.shape[1] != 6 * hi.shape[0] or scale.shape[0] != hi.shape[1]:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, hi {tuple(hi.shape)}, "
                         f"scale {tuple(scale.shape)}")
    if hi.dtype != torch.int32 or scale.dtype != torch.float32:
        raise TypeError(f"hi must be int32 and scale float32, got {hi.dtype}, {scale.dtype}")
    if not x.is_floating_point():
        raise TypeError(f"x must be floating point, got {x.dtype}")
    if not (x.device == hi.device == scale.device):
        raise ValueError(f"operands on different devices: {x.device}, {hi.device}, "
                         f"{scale.device}")


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = library("ams_matmul").ams_matmul_fp533
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ams_matmul_fp533(x: torch.Tensor, hi: torch.Tensor, scale: torch.Tensor,
                     n_split: Optional[int] = None) -> torch.Tensor:
    """K1 wrapper: x [B, Kp], hi [Kp/6, N] int32, scale [N] f32 -> y [B, N]
    f32. CPU tensors take the plain version; CUDA tensors launch the kernel
    (tiles and K split from `tuning.plan_ams_matmul`; ``n_split``: the N of
    the whole linear when hi is one rank's N-shard of it) or raise."""
    _check(x, hi, scale)
    if x.device.type == "cpu":
        return ams_matmul_fp533_plain(x, hi, scale)
    check_device(x)
    if not (hi.is_contiguous() and scale.is_contiguous()):
        raise ValueError("hi and scale must be contiguous")
    fn = _kernel()
    B, N = x.shape[0], hi.shape[1]
    xb = x.to(torch.bfloat16).contiguous()
    y = torch.empty((B, N), dtype=torch.float32, device=x.device)
    if B == 0 or N == 0 or hi.shape[0] == 0:     # nothing to launch: y is 0
        return y.zero_()
    plan = plan_ams_matmul(B, hi.shape[0], N, n_split=n_split)
    rc = fn(xb.data_ptr(), hi.data_ptr(), scale.data_ptr(), y.data_ptr(),
            B, hi.shape[0], N, plan.tn, plan.nt, plan.cluster, plan.split_words,
            stream_ptr(x.device))
    if rc != 0:
        raise RuntimeError(f"ams_matmul_fp533 launch failed: cudaError {rc}")
    COUNT.launches += 1
    return y


# ---------------------------------------------------------------------------
# K1b: planes container
# ---------------------------------------------------------------------------
def unpack_planes(hi: torch.Tensor, lsb: torch.Tensor, lay: PackLayout) -> torch.Tensor:
    """planes words -> full codes [Kp, N] in position order: field j of word
    kw (bits j*hi_bits..) is position kw*per_word + j; with k > 1 it is the
    code's high part and bit (g & 31) of lsb[g >> 5] the shared LSB of
    group g = position // k."""
    k, hb, pw = lay.scheme.k, lay.hi_bits, lay.per_word
    w = hi.to(torch.int64) & 0xFFFFFFFF
    codes = torch.stack([(w >> (hb * j)) & ((1 << hb) - 1) for j in range(pw)], dim=1)
    codes = codes.reshape(-1, hi.shape[1])
    if k == 1:
        return codes.to(torch.int32)
    lw = lsb.to(torch.int64) & 0xFFFFFFFF
    bits = torch.stack([(lw >> j) & 1 for j in range(32)], dim=1).reshape(-1, hi.shape[1])
    return ((codes << 1) | bits.repeat_interleave(k, dim=0)).to(torch.int32)


def ams_matmul_planes_plain(x: torch.Tensor, hi: torch.Tensor, lsb: torch.Tensor,
                            scale: torch.Tensor, lay: PackLayout) -> torch.Tensor:
    """Plain torch version of K1b on padded operands: x [B, Kp] (any float
    type; rounded to bf16 like the kernel), hi [Kp/per_word, N] int32, lsb
    [Kp/(32k), N] int32 (ignored when k == 1), scale [N] f32 -> f32 [B, N]."""
    if x.is_cuda:
        COUNT_PLANES.plain_on_cuda += 1
    w = code_to_value(lay.scheme.base, unpack_planes(hi, lsb, lay))
    xb = x.to(torch.bfloat16).to(torch.float32)
    return (xb @ w) * scale.to(torch.float32)


def _check_planes(x, hi, lsb, scale, lay: PackLayout):
    if lay.container != "planes":
        raise ValueError(f"K1b takes the planes container, got {lay.container!r}")
    if x.dim() != 2 or hi.dim() != 2 or lsb.dim() != 2 or scale.dim() != 1:
        raise ValueError(f"expected x [B, Kp], hi [Kp/{lay.per_word}, N], lsb [r, N], "
                         f"scale [N]; got {tuple(x.shape)}, {tuple(hi.shape)}, "
                         f"{tuple(lsb.shape)}, {tuple(scale.shape)}")
    Kp, N = x.shape[1], hi.shape[1]
    k = lay.scheme.k
    if (Kp != lay.per_word * hi.shape[0] or Kp % lay.k_block or scale.shape[0] != N
            or lsb.shape[1] != N or (k > 1 and lsb.shape[0] != Kp // (32 * k))):
        raise ValueError(f"shape mismatch for {lay.scheme.name}: x {tuple(x.shape)}, hi "
                         f"{tuple(hi.shape)}, lsb {tuple(lsb.shape)}, scale {tuple(scale.shape)}")
    if hi.dtype != torch.int32 or lsb.dtype != torch.int32 or scale.dtype != torch.float32:
        raise TypeError(f"hi and lsb must be int32 and scale float32, got {hi.dtype}, "
                        f"{lsb.dtype}, {scale.dtype}")
    if not x.is_floating_point():
        raise TypeError(f"x must be floating point, got {x.dtype}")
    if not (x.device == hi.device == lsb.device == scale.device):
        raise ValueError(f"operands on different devices: {x.device}, {hi.device}, "
                         f"{lsb.device}, {scale.device}")


@functools.lru_cache(maxsize=None)
def _kernel_planes_mma():
    fn = library("ams_matmul").ams_matmul_planes_mma
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def planes_on_tensor_cores(lay: PackLayout) -> bool:
    """Whether K1b's tensor-core kernel takes ``lay``: a decode hook exists
    for hi fields of 4 to 8 bits (per_word 8, 6, 5, 4) with a shared-LSB
    group k of at most 4, over a base format at its standard bias, i.e.
    every planes layout of a registered scheme (fp5.33-e2m3 packed as planes
    too). Not taken: 3-bit fields (e2m1 with k > 1, per_word 10) and k > 4."""
    fmt = lay.scheme.base
    return (lay.per_word in (4, 5, 6, 8) and 4 <= lay.hi_bits <= 8 and lay.scheme.k <= 4
            and fmt.bias == (1 << (fmt.exp_bits - 1)) - 1)


def ams_matmul_planes(x: torch.Tensor, hi: torch.Tensor, lsb: torch.Tensor,
                      scale: torch.Tensor, lay: PackLayout,
                      n_split: Optional[int] = None) -> torch.Tensor:
    """K1b wrapper: x [B, Kp], hi [Kp/per_word, N], lsb [Kp/(32k), N] (any
    [r, N] when k == 1), scale [N] -> y [B, N] f32. CPU tensors take the
    plain version; CUDA tensors launch the kernel (tiles and K split from
    `tuning.plan_ams_matmul`, ``n_split`` as in K1) or raise. The kernel reads x as bf16 rows at a
    stride of a multiple of 8 (16-byte copies): x is taken as it is when it
    has that layout (a view of wider rows too), else copied into it once."""
    _check_planes(x, hi, lsb, scale, lay)
    if x.device.type == "cpu":
        return ams_matmul_planes_plain(x, hi, lsb, scale, lay)
    check_device(x)
    k, fmt = lay.scheme.k, lay.scheme.base
    if not planes_on_tensor_cores(lay):
        raise NotImplementedError(f"K1b takes per_word in (4, 5, 6, 8) and k <= 4; got "
                                  f"{lay.per_word}, {k}")
    if not (hi.is_contiguous() and lsb.is_contiguous() and scale.is_contiguous()):
        raise ValueError("hi, lsb and scale must be contiguous")
    B, N, Kw = x.shape[0], hi.shape[1], hi.shape[0]
    y = torch.empty((B, N), dtype=torch.float32, device=x.device)
    if B == 0 or N == 0 or Kw == 0:          # nothing to launch: y is 0
        return y.zero_()
    Kp = x.shape[1]
    ldx = x.stride(0) if B > 1 else -(-Kp // 8) * 8
    if not (x.dtype == torch.bfloat16 and x.stride(1) == 1 and ldx % 8 == 0 and ldx >= Kp
            and x.data_ptr() % 16 == 0):
        ldx = -(-Kp // 8) * 8
        xb = torch.empty((B, ldx), dtype=torch.bfloat16, device=x.device)
        xb[:, :Kp].copy_(x)                  # columns past Kp are never read
        x = xb
    plan = plan_ams_matmul(B, Kw, N, container="planes", k=k, per_word=lay.per_word,
                           n_split=n_split)
    rc = _kernel_planes_mma()(x.data_ptr(), hi.data_ptr(), lsb.data_ptr(), scale.data_ptr(),
                              y.data_ptr(), B, Kw, N, lsb.shape[0] if k > 1 else 0, ldx,
                              lay.hi_bits, k, fmt.man_bits, fmt.bias, plan.tn, plan.nt,
                              plan.cluster, plan.split_words, stream_ptr(x.device))
    if rc != 0:
        raise RuntimeError(f"ams_matmul_planes launch failed: cudaError {rc}")
    COUNT_PLANES.launches += 1
    return y
