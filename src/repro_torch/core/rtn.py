"""Channel-wise Round-To-Nearest FP quantization (port of src/repro/core/rtn.py).

Weights are stored ``[K, N]`` (in_features, out_features). Quantization is
per output channel n: ``s_q[n] = max_k |W[k, n]| / max_normal(fmt)``.
Rounding is round-to-nearest with ties away from zero, found by a
``searchsorted(right=True)`` over the format's magnitude midpoints.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from .formats import FPFormat, mag_midpoints


def channel_scales(w: torch.Tensor, fmt: FPFormat) -> torch.Tensor:
    """Per-output-channel scales s_q[n] = max|W[:, n]| / max_normal."""
    amax = w.abs().amax(dim=0)
    scale = amax / np.float32(fmt.max_normal)
    return torch.where(scale == 0, torch.ones_like(scale), scale).to(torch.float32)


@functools.lru_cache(maxsize=None)
def device_table(table: tuple, dtype: torch.dtype, device: str) -> torch.Tensor:
    """A small constant table as a tensor on ``device``, made once (a copy
    from host memory per call would stall the host on the card's queue)."""
    return torch.tensor(table, dtype=dtype, device=device)


def nearest_mag_codes(x_abs: torch.Tensor, fmt: FPFormat) -> torch.Tensor:
    """Nearest unsigned-magnitude code for |normalized| values (clipped)."""
    mids = device_table(tuple(mag_midpoints(fmt).tolist()), torch.float32, str(x_abs.device))
    idx = torch.searchsorted(mids, x_abs.to(torch.float32).contiguous(), right=True)
    return idx.to(torch.int32)


def quantize_rtn(w: torch.Tensor, fmt: FPFormat, scale: Optional[torch.Tensor] = None):
    """RTN-quantize ``w`` -> (codes int32, scale f32[N]).

    codes layout: sign << (e+m) | magnitude_code.
    """
    w = w.to(torch.float32)
    if scale is None:
        scale = channel_scales(w, fmt)
    wn = w / scale
    mag = nearest_mag_codes(wn.abs(), fmt)
    sign = (wn < 0).to(torch.int32)
    return mag | (sign << fmt.code_bits), scale


