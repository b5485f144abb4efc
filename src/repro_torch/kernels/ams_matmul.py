"""K1: fused AMS dequantize + matmul, fp533 container (port of
src/repro/kernels/ams_matmul.py: ams_matmul_padded -> _kernel_fp533).

`ams_matmul_fp533` is the wrapper: on CUDA tensors it launches the CUDA
kernel in ``csrc/ams_matmul.cu`` (what bounds it and how its design answers
that are noted there), on CPU tensors it runs `ams_matmul_fp533_plain`, the
kernel's plain torch version. Both compute

    y[b, n] = (bf16(x)[b, :] @ DeQ(W)[:, n]) * scale[n]

with f32 accumulation and the per-channel scale applied once at the end.
Decoded e2m3 weights are exact in bf16 and bf16 x e2m3 products are exact in
f32, so kernel and plain version differ only by summation order.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.formats import code_to_value, get_format

from .build import KernelCount, check_device, library, stream_ptr

E2M3 = get_format("e2m3")
COUNT = KernelCount("ams_matmul_fp533")


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
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ams_matmul_fp533(x: torch.Tensor, hi: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """K1 wrapper: x [B, Kp], hi [Kp/6, N] int32, scale [N] f32 -> y [B, N]
    f32. CPU tensors take the plain version; CUDA tensors launch the kernel
    or raise."""
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
    rc = fn(xb.data_ptr(), hi.data_ptr(), scale.data_ptr(), y.data_ptr(),
            B, hi.shape[0], N, stream_ptr(x.device))
    if rc != 0:
        raise RuntimeError(f"ams_matmul_fp533 launch failed: cudaError {rc}")
    COUNT.launches += 1
    return y
