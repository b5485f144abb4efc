"""AMS-KV: mantissa-bit sharing on the KV cache (port of src/repro/core/kv_quant.py).

Each inserted K/V vector is quantized to e2m2 along head_dim with one f32
scale per (token, head), and each mantissa LSB is shared across k=4
neighbours. Packed planes per vector: ``hi`` int8 [hd_p/2] (two 4-bit codes
per byte, low nibble first), ``lsb`` int32 [gw] (one bit per k-group) and
``scale`` f32 [1], where hd_p = `packed_head_dim(hd)` (zero-padded when hd
is odd or not a multiple of k).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from .ams import share_mantissa
from .formats import AMSFormat, code_to_value, get_scheme
from .packing import wrap_int32
from .rtn import quantize_rtn

KV_SCHEME = get_scheme("fp4.25-e2m2")


def packed_head_dim(hd: int, scheme: AMSFormat = KV_SCHEME) -> int:
    """Padded head dim the packed planes store: a multiple of k and even."""
    m = math.lcm(scheme.k, 2)
    return -(-hd // m) * m


def kv_scales(wt: torch.Tensor, fmt) -> torch.Tensor:
    """Per-vector scales max|x| / max_normal, computed as a multiply by the
    f32 reciprocal of max_normal: the reference inserts K/V inside its
    compiled engine step, where XLA rewrites the division by that constant
    into this multiply, so the pool bytes match the reference engine's."""
    scale = wt.abs().amax(dim=0) * np.float32(1.0 / fmt.max_normal)
    return torch.where(scale == 0, torch.ones_like(scale), scale).to(torch.float32)


def quantize_kv(x: torch.Tensor, scheme: AMSFormat = KV_SCHEME,
                strategy: str = "set_lsb") -> Dict[str, torch.Tensor]:
    """Quantize [..., hd] vectors -> packed planes {hi, lsb, scale}."""
    fmt, k = scheme.base, scheme.k
    hd = x.shape[-1]
    hd_p = packed_head_dim(hd, scheme)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, hd).to(torch.float32)
    if hd_p != hd:
        x2 = torch.nn.functional.pad(x2, (0, hd_p - hd))
    wt = x2.T                                    # [hd_p, M]: vectors as columns
    codes, scale = quantize_rtn(wt, fmt, scale=kv_scales(wt, fmt))
    codes = share_mantissa(codes, wt / scale, fmt, k, strategy).T   # [M, hd_p]

    hi = codes >> 1                              # 4-bit segments
    byte = hi[:, 0::2] | (hi[:, 1::2] << 4)      # 0..255
    hi_packed = torch.where(byte > 127, byte - 256, byte).to(torch.int8)
    g = hd_p // k
    gw = -(-g // 32)
    bits = (codes[:, ::k] & 1).to(torch.int64)   # [M, g]
    bits = torch.nn.functional.pad(bits, (0, gw * 32 - g)).reshape(-1, gw, 32)
    shifts = torch.arange(32, device=x.device, dtype=torch.int64)
    lsb = wrap_int32((bits << shifts).sum(-1))   # disjoint bits: sum == OR
    return {
        "hi": hi_packed.reshape(*lead, hd_p // 2),
        "lsb": lsb.reshape(*lead, gw),
        "scale": scale.reshape(*lead, 1).to(torch.float32),
    }


def codes_from_planes(hi: torch.Tensor, lsb: torch.Tensor, k: int) -> torch.Tensor:
    """Packed planes -> full codes [..., hd_p]: split each byte into nibbles
    (position order) and OR the shared LSB back into every group member."""
    lead = hi.shape[:-1]
    hd_p = hi.shape[-1] * 2
    byte = hi.to(torch.int32) & 0xFF
    codes_hi = torch.stack([byte & 0xF, (byte >> 4) & 0xF], dim=-1).reshape(*lead, hd_p)
    g = hd_p // k
    gw = lsb.shape[-1]
    bits = torch.stack([(lsb >> j) & 1 for j in range(32)], dim=-1)
    bits = bits.reshape(*lead, gw * 32)[..., :g]
    lsb_full = bits.repeat_interleave(k, dim=-1)
    return (codes_hi << 1) | lsb_full


def dequantize_kv(q: Dict[str, torch.Tensor], hd: int, scheme: AMSFormat = KV_SCHEME,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """Packed planes -> [..., hd] values (the pad tail is sliced off)."""
    lead = q["hi"].shape[:-1]
    hd_p = q["hi"].shape[-1] * 2
    codes = codes_from_planes(q["hi"].reshape(-1, hd_p // 2),
                              q["lsb"].reshape(-1, q["lsb"].shape[-1]), scheme.k)
    vals = code_to_value(scheme.base, codes) * q["scale"].reshape(-1, 1)
    return vals.reshape(*lead, hd_p)[..., :hd].to(dtype)


def kv_bytes(hd: int, scheme: AMSFormat = KV_SCHEME) -> Tuple[int, int]:
    """(packed bytes per vector, bf16 bytes per vector)."""
    hd_p = packed_head_dim(hd, scheme)
    gw = -(-(hd_p // scheme.k) // 32)
    return hd_p // 2 + 4 * gw + 4, 2 * hd
