"""Mantissa-bit sharing + Adaptive Searching (port of src/repro/core/ams.py).

Given RTN codes for a ``[K, N]`` weight, group ``k`` consecutive codes along
K and force their mantissa LSB (code bit 0) to one shared value ``m0``,
chosen per group to minimize the squared error against the normalized
weights. ``set_lsb`` keeps RTN's high bits and overwrites bit 0;
``requantize`` re-rounds each weight onto the LSB==m0 sub-lattice first.

The group error sums its ``k`` members strictly left to right, the order the
reference's reduction uses, so near-tie groups pick the same bit and the
codes are bit-equal to the reference's.
"""

from __future__ import annotations

from typing import Optional

import torch

from .formats import AMSFormat, FPFormat, code_to_value, lsb_subgrid
from .rtn import channel_scales, device_table, quantize_rtn


def _group_err(vals: torch.Tensor, wn: torch.Tensor, k: int) -> torch.Tensor:
    """Sum of squared errors per (group, column): [K/k, N], members summed
    left to right."""
    K, N = wn.shape
    d = vals - wn
    d = (d * d).reshape(K // k, k, N)
    err = d[:, 0]
    for j in range(1, k):
        err = err + d[:, j]
    return err


def _subgrid_codes(wn: torch.Tensor, fmt: FPFormat, lsb: int) -> torch.Tensor:
    """Nearest code to each normalized weight on the LSB==lsb sub-lattice."""
    sel, _, mids = lsb_subgrid(fmt, lsb)
    dev = str(wn.device)
    mids_t = device_table(tuple(mids.tolist()), torch.float32, dev)
    idx = torch.searchsorted(mids_t, wn.abs().to(torch.float32).contiguous(), right=True)
    mag = device_table(tuple(sel.tolist()), torch.int32, dev)[idx]
    sign = (wn < 0).to(torch.int32)
    return mag | (sign << fmt.code_bits)


def share_mantissa(codes: torch.Tensor, wn: torch.Tensor, fmt: FPFormat, k: int,
                   strategy: str = "set_lsb") -> torch.Tensor:
    """Return codes whose bit 0 is constant within each k-group along axis 0.

    ``wn`` is the normalized original weight (w / s_q), same shape as codes.
    """
    if k == 1:
        return codes
    K, N = codes.shape
    if K % k != 0:
        raise ValueError(f"K={K} not divisible by group size k={k}")
    if strategy == "set_lsb":
        cand0 = codes & ~1
        cand1 = codes | 1
    elif strategy == "requantize":
        cand0 = _subgrid_codes(wn, fmt, 0)
        cand1 = _subgrid_codes(wn, fmt, 1)
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    err0 = _group_err(code_to_value(fmt, cand0), wn, k)
    err1 = _group_err(code_to_value(fmt, cand1), wn, k)
    pick1 = (err1 < err0).repeat_interleave(k, dim=0)          # [K, N]
    return torch.where(pick1, cand1, cand0).to(torch.int32)


def ams_quantize(w: torch.Tensor, scheme: AMSFormat, strategy: str = "set_lsb",
                 scale: Optional[torch.Tensor] = None):
    """Full AMS-Quant: channel-wise RTN -> grouped LSB sharing.

    Returns (codes int32 [K, N], scale f32 [N]).
    """
    w = w.to(torch.float32)
    fmt = scheme.base
    if scale is None:
        scale = channel_scales(w, fmt)
    codes, _ = quantize_rtn(w, fmt, scale=scale)
    if scheme.k > 1:
        codes = share_mantissa(codes, w / scale, fmt, scheme.k, strategy)
    return codes, scale
