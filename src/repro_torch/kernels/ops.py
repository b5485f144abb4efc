"""Public wrapper around K1 (port of src/repro/kernels/ops.py).

Flattens leading dims and zero-pads K up to the packed rows, so the kernel
only ever sees [B, Kp] activations; B and N may be ragged (the kernel masks
its edges), and the result is reshaped back. The TPU tile planner
(`kernels/tuning.py`) has no counterpart: K1 uses one fixed tile.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.packing import PackedWeight

from .ams_matmul import ams_matmul_fp533


def ams_matmul(x: torch.Tensor, pw: PackedWeight) -> torch.Tensor:
    """y[..., N] = x[..., K] @ DeQ(W) in f32 through K1 (the kernel on CUDA
    tensors, its plain version on CPU tensors)."""
    lay = pw.layout
    if lay.container != "fp533":
        raise NotImplementedError(
            f"ams_matmul for the {lay.container!r} container is kernel K1b, not "
            "ported yet (ROADMAP queue 2)")
    lead = x.shape[:-1]
    B = math.prod(lead) if lead else 1
    Kp = 6 * pw.hi.shape[0]
    x2 = x.reshape(B, x.shape[-1])
    if x2.shape[1] != Kp:
        x2 = torch.nn.functional.pad(x2, (0, Kp - x2.shape[1]))
    y = ams_matmul_fp533(x2, pw.hi, pw.scale)
    return y.reshape(*lead, pw.N)
