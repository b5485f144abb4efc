"""Public wrapper around K1 and K1b (port of src/repro/kernels/ops.py).

Dispatches on the layout's container (fp533 -> K1, planes -> K1b),
flattens leading dims and zero-pads K up to the packed rows, so the kernels
only ever see [B, Kp] activations with hi (and lsb) planes of exactly Kp
positions; B and N may be ragged (the kernels mask their edges), and the
result is reshaped back. The tiles and K split of K1 and K1b come from the
Hopper planner `kernels/tuning.plan_ams_matmul` (the TPU tile planner has
no counterpart).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.packing import PackedWeight

from .ams_matmul import ams_matmul_fp533, ams_matmul_planes


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    return t if t.shape[0] == rows else torch.nn.functional.pad(t, (0, 0, 0, rows - t.shape[0]))


def ams_matmul(x: torch.Tensor, pw: PackedWeight, n_split: Optional[int] = None) -> torch.Tensor:
    """y[..., N] = x[..., K] @ DeQ(W) in f32 through K1 (fp533) or K1b
    (planes): the kernel on CUDA tensors, its plain version on CPU tensors.
    ``n_split``: the N of the whole linear when W is one rank's N-shard of
    it (the kernel's K split is then the whole linear's)."""
    lay = pw.layout
    lead = x.shape[:-1]
    B = math.prod(lead) if lead else 1
    Kp = lay.padded_k(pw.K)
    x2 = x.reshape(B, x.shape[-1])
    if x2.shape[1] != Kp:
        x2 = torch.nn.functional.pad(x2, (0, Kp - x2.shape[1]))
    hi = _pad_rows(pw.hi, Kp // lay.per_word)
    if lay.container == "fp533":
        y = ams_matmul_fp533(x2, hi, pw.scale, n_split=n_split)
    else:
        k = lay.scheme.k
        lsb = _pad_rows(pw.lsb, Kp // (32 * k)) if k > 1 else pw.lsb
        y = ams_matmul_planes(x2, hi, lsb, pw.scale, lay, n_split=n_split)
    return y.reshape(*lead, pw.N)
