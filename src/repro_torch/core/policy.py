# Port of src/repro/core/policy.py: a copy; impl names follow the port ("kernel" for "pallas").
"""Quantization policy: which tensors get AMS-quantized and how.

Mirrors deployment practice (and the paper's evaluation): large projection
matrices are quantized; tiny/accuracy-critical tensors (MoE routers, norms,
SSM recurrence params, biases) stay in high precision.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    scheme: str = "fp5.33-e2m3"      # key into core.formats.SCHEMES
    strategy: str = "set_lsb"        # 'set_lsb' (paper) | 'requantize' (ours)
    impl: str = "ref"                # 'ref' | 'fused_ref' | 'kernel' (CUDA K1)
    quantize_embeddings: bool = False
    quantize_lm_head: bool = False
    min_elements: int = 1 << 16      # skip tensors smaller than this (routers…)

    def wants(self, name: str, shape) -> bool:
        """Should tensor `name` with `shape` be quantized?"""
        if len(shape) != 2:
            return False
        n = shape[0] * shape[1]
        if n < self.min_elements:
            return False
        if "router" in name or "gate_proj_router" in name:
            return False
        if "embed" in name and not self.quantize_embeddings:
            return False
        if "lm_head" in name and not self.quantize_lm_head:
            return False
        return True


FP16_POLICY = QuantPolicy(scheme="fp16")  # sentinel: no quantization


def is_fp16(policy: QuantPolicy) -> bool:
    return policy.scheme == "fp16"
