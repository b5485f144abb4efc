"""Dense FFN (port of src/repro/models/ffn.py): the SiLU-GLU path."""

from __future__ import annotations

import torch

from .common import apply_linear, make_linear


def init_ffn(gen, d_model: int, d_ff: int, activation: str, *, dtype=torch.float32,
             device="cpu"):
    if activation != "silu_glu":
        raise NotImplementedError(f"FFN activation {activation!r} is not ported yet")
    return {
        "w_gate": make_linear(gen, d_model, d_ff, dtype=dtype, device=device),
        "w_up": make_linear(gen, d_model, d_ff, dtype=dtype, device=device),
        "w_down": make_linear(gen, d_ff, d_model, dtype=dtype, device=device),
    }


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * (1 / (1 + exp(-x))), each op rounded in x.dtype: the op sequence
    jax.nn.silu lowers to, so bf16 activations round alike."""
    return x * (1 / (1 + torch.exp(-x)))


def ffn_apply(p, x, activation: str, policy=None):
    if "w_gate" not in p or activation != "silu_glu":
        raise NotImplementedError(f"FFN activation {activation!r} is not ported yet")
    g = silu(apply_linear(p["w_gate"], x, policy))
    u = apply_linear(p["w_up"], x, policy)
    return apply_linear(p["w_down"], g * u, policy)
