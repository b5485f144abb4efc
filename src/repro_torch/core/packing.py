"""Ahead-of-time weight packing into int32 planes (port of src/repro/core/packing.py).

Layouts (both ``[K_packed, N]`` int32, identical to the reference's words):

  * ``planes`` — ``hi`` holds the unshared bits (code >> 1 when k > 1),
    ``per_word = 32 // hi_bits`` consecutive K positions per word; ``lsb``
    holds one bit per k-group, 32 groups per word (absent when k == 1);
  * ``fp533`` — FP5.33 (e2m3, k=3): each 16-bit half of a word holds three
    5-bit high segments and the group's shared LSB at bit 15, so one word
    holds 6 weights and the matmul reads one stream.

K is zero-padded to the packing block; code 0 decodes to +0, so padded rows
are exact no-ops in the matmul. Words are assembled in int64 and wrapped to
int32 two's complement, so a set bit 31 matches the reference's bits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .formats import AMSFormat


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 words holding 32 meaningful bits -> int32 with the same bits."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class PackLayout:
    """Static description of how a scheme is packed."""

    scheme: AMSFormat
    container: str  # "planes" | "fp533"
    hi_bits: int
    per_word: int   # hi codes per int32 word
    k_block: int    # K must be padded to a multiple of this

    def padded_k(self, K: int) -> int:
        return _ceil_to(K, self.k_block)


def make_layout(scheme: AMSFormat, container: Optional[str] = None) -> PackLayout:
    k = scheme.k
    if container is None:
        container = "fp533" if (k == 3 and scheme.base.name == "e2m3") else "planes"
    if container == "fp533":
        assert k == 3 and scheme.base.total_bits == 6
        return PackLayout(scheme, "fp533", hi_bits=5, per_word=6, k_block=6)
    hi_bits = scheme.base.total_bits - (1 if k > 1 else 0)
    per_word = 32 // hi_bits
    k_block = per_word if k == 1 else math.lcm(per_word, 32 * k)
    return PackLayout(scheme, container, hi_bits, per_word, k_block)


@dataclasses.dataclass
class PackedWeight:
    """Packed planes + channel scales. hi [hi_rows, N] int32; lsb
    [lsb_rows, N] int32 (shape [0, N] when absent); scale [N] f32."""

    hi: torch.Tensor
    lsb: torch.Tensor
    scale: torch.Tensor
    layout: PackLayout
    K: int
    N: int


def pack(codes: torch.Tensor, scale: torch.Tensor, scheme: AMSFormat,
         container: Optional[str] = None) -> PackedWeight:
    """Pack full codes [K, N] (bit 0 already shared per group) into planes."""
    layout = make_layout(scheme, container)
    K, N = codes.shape
    Kp = layout.padded_k(K)
    codes = torch.nn.functional.pad(codes.to(torch.int64), (0, 0, 0, Kp - K))
    k = scheme.k
    empty = torch.zeros((0, N), dtype=torch.int32, device=codes.device)

    if layout.container == "fp533":
        hi = (codes >> 1).reshape(Kp // 6, 6, N)
        lsb = (codes & 1).reshape(Kp // 3, 3, N)[:, 0, :].reshape(Kp // 6, 2, N)
        word = torch.zeros((Kp // 6, N), dtype=torch.int64, device=codes.device)
        # half h (bits 16h..16h+15): w0 | w1 << 5 | w2 << 10 | lsb << 15
        for h in range(2):
            half = (hi[:, 3 * h] | (hi[:, 3 * h + 1] << 5)
                    | (hi[:, 3 * h + 2] << 10) | (lsb[:, h] << 15))
            word = word | (half << (16 * h))
        return PackedWeight(wrap_int32(word), empty, scale.to(torch.float32),
                            layout, K, N)

    hi_codes = (codes >> 1) if k > 1 else codes
    pw = layout.per_word
    hi_g = hi_codes.reshape(Kp // pw, pw, N)
    word = torch.zeros((Kp // pw, N), dtype=torch.int64, device=codes.device)
    for j in range(pw):
        word = word | (hi_g[:, j] << (j * layout.hi_bits))
    hi = wrap_int32(word)
    if k > 1:
        bits = (codes & 1).reshape(Kp // k, k, N)[:, 0, :]
        bits_g = bits.reshape(Kp // (32 * k), 32, N)
        lw = torch.zeros((Kp // (32 * k), N), dtype=torch.int64, device=codes.device)
        for j in range(32):
            lw = lw | (bits_g[:, j] << j)
        lsb = wrap_int32(lw)
    else:
        lsb = empty
    return PackedWeight(hi, lsb, scale.to(torch.float32), layout, K, N)


def unpack(pw: PackedWeight) -> torch.Tensor:
    """Reverse of pack(): full signed codes [K, N]."""
    layout = pw.layout
    k = layout.scheme.k
    Kp = layout.padded_k(pw.K)
    N = pw.N
    hi = pw.hi.to(torch.int64) & 0xFFFFFFFF

    if layout.container == "fp533":
        halves = torch.stack([(hi >> (16 * h)) & 0xFFFF for h in range(2)], dim=1)
        w_hi = torch.stack([(halves >> (5 * j)) & 0x1F for j in range(3)], dim=2)
        lsb = (halves >> 15) & 1                                  # [Kp/6, 2, N]
        codes = (w_hi << 1) | lsb[:, :, None, :]
        return codes.reshape(Kp, N)[: pw.K].to(torch.int32)

    mask = (1 << layout.hi_bits) - 1
    hic = torch.stack([(hi >> (layout.hi_bits * j)) & mask
                       for j in range(layout.per_word)], dim=1).reshape(Kp, N)
    if k == 1:
        return hic[: pw.K].to(torch.int32)
    lsbw = pw.lsb.to(torch.int64) & 0xFFFFFFFF
    gbits = torch.stack([(lsbw >> j) & 1 for j in range(32)], dim=1).reshape(Kp // k, N)
    lsb_full = gbits.repeat_interleave(k, dim=0)
    return ((hic << 1) | lsb_full)[: pw.K].to(torch.int32)
