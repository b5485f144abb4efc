"""QuantizedLinear: the deployable AMS-Quant linear layer (port of
src/repro/core/qlinear.py).

Holds packed planes and channel scales. ``apply`` dispatches between:
  * ``ref``       plain torch unpack, bit decode and matmul (the oracle);
  * ``kernel``    the hand-written CUDA kernels through `kernels.ops.ams_matmul`
                  (K1 for the fp533 container, K1b for planes; on CPU tensors
                  their plain versions), the counterpart of the reference's
                  ``pallas``;
  * ``fused_ref`` the K-blocked plain product `kernels.ref.ams_matmul_blocked`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .ams import ams_quantize
from .formats import AMSFormat, code_to_value
from .packing import PackedWeight, make_layout, pack, unpack


@dataclasses.dataclass
class QuantizedLinear:
    """Packed AMS-quantized linear weight (+ optional bias)."""

    packed: PackedWeight
    bias: Optional[torch.Tensor]  # [N] or None

    @property
    def scheme(self) -> AMSFormat:
        return self.packed.layout.scheme

    @property
    def in_features(self) -> int:
        return self.packed.K

    @property
    def out_features(self) -> int:
        return self.packed.N


def quantize_linear(w: torch.Tensor, scheme: AMSFormat, bias: Optional[torch.Tensor] = None,
                    strategy: str = "set_lsb", container: Optional[str] = None) -> QuantizedLinear:
    """Offline PTQ of a [K, N] weight. K is zero-padded up to the packing
    block (padded rows quantize to code 0 and meet zero-padded activations,
    so they are exact no-ops); the true K is kept in the PackedWeight."""
    K = w.shape[0]
    Kp = make_layout(scheme, container).padded_k(K)
    wp = torch.nn.functional.pad(w.to(torch.float32), (0, 0, 0, Kp - K))
    codes, scale = ams_quantize(wp, scheme, strategy)
    packed = dataclasses.replace(pack(codes, scale, scheme, container), K=K)
    return QuantizedLinear(packed, bias)


def dequantize_weight(q: QuantizedLinear, dtype=torch.bfloat16) -> torch.Tensor:
    """The [K, N] dequantized weight (reference / debug)."""
    codes = unpack(q.packed)
    return (code_to_value(q.scheme.base, codes) * q.packed.scale).to(dtype)


def apply(q: QuantizedLinear, x: torch.Tensor, impl: str = "ref") -> torch.Tensor:
    """y = x @ DeQ(W) (+ bias), in x.dtype. x: [..., K]."""
    if impl == "ref":
        y = x @ dequantize_weight(q, dtype=x.dtype)
    elif impl == "kernel":
        from repro_torch.kernels import ops
        y = ops.ams_matmul(x, q.packed).to(x.dtype)
    elif impl == "fused_ref":
        from repro_torch.kernels import ref
        lead = x.shape[:-1]
        y = ref.ams_matmul_blocked(x.reshape(-1, x.shape[-1]), q.packed)
        y = y.reshape(*lead, q.out_features).to(x.dtype)
    else:
        raise ValueError(f"unknown impl {impl!r} (ref | kernel | fused_ref)")
    if q.bias is not None:
        y = y + q.bias.to(y.dtype)
    return y
