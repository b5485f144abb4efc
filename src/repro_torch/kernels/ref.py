"""Plain torch oracles for the AMS matmul (port of src/repro/kernels/ref.py).

``ams_matmul_ref`` dequantizes the whole weight and multiplies in f32.
``ams_matmul_blocked`` is the ``fused_ref`` path: it walks K in blocks,
decoding one [bK, N] tile at a time with f32 accumulation and the scale
applied at the end, so the dequantized working set stays one tile.
"""

from __future__ import annotations

import torch

from repro_torch.core.formats import code_to_value
from repro_torch.core.packing import PackedWeight, unpack


def dequant_full(pw: PackedWeight, dtype=torch.float32) -> torch.Tensor:
    """[K, N] dequantized weight (scale applied)."""
    codes = unpack(pw)
    return (code_to_value(pw.layout.scheme.base, codes) * pw.scale).to(dtype)


def ams_matmul_ref(x: torch.Tensor, pw: PackedWeight) -> torch.Tensor:
    """y = x @ DeQ(W), f32. x: [B, K]."""
    return x.to(torch.float32) @ dequant_full(pw, torch.float32)


def ams_matmul_blocked(x: torch.Tensor, pw: PackedWeight, block_k: int = 512) -> torch.Tensor:
    """K-blocked product: unpack + decode one K tile at a time, accumulate in
    f32, scale once at the end. x: [B, K] -> f32 [B, N]."""
    lay = pw.layout
    K, N = pw.K, pw.N
    Kp = lay.padded_k(K)
    bK = max(lay.k_block, (block_k // lay.k_block) * lay.k_block)
    nb = -(-Kp // bK)
    Kpp = nb * bK
    xb = torch.nn.functional.pad(x.to(torch.float32), (0, Kpp - K))
    hi = torch.nn.functional.pad(pw.hi, (0, 0, 0, Kpp // lay.per_word - pw.hi.shape[0]))
    planes = lay.container == "planes" and lay.scheme.k > 1
    if planes:
        lr = Kpp // (32 * lay.scheme.k)
        lsb = torch.nn.functional.pad(pw.lsb, (0, 0, 0, lr - pw.lsb.shape[0]))
    ones = torch.ones(N, dtype=torch.float32, device=x.device)
    acc = torch.zeros((x.shape[0], N), dtype=torch.float32, device=x.device)
    hr = bK // lay.per_word
    for i in range(nb):
        sub_lsb = (lsb[i * (bK // (32 * lay.scheme.k)):(i + 1) * (bK // (32 * lay.scheme.k))]
                   if planes else pw.lsb[:0])
        sub = PackedWeight(hi[i * hr:(i + 1) * hr], sub_lsb, ones, lay, bK, N)
        w = code_to_value(lay.scheme.base, unpack(sub))
        acc = acc + xb[:, i * bK:(i + 1) * bK] @ w
    return acc * pw.scale[None, :]
