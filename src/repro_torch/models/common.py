"""Shared model building blocks (port of src/repro/models/common.py).

Parameters are nested dicts of tensors. A "linear" is ``{'w': [K, N]}``
(+ optional ``'b': [N]``) in high precision, or, after AMS PTQ, the packed
planes ``{'hi', 'lsb', 'scale'}`` (+ optional ``'b'``); `apply_linear`
dispatches on which keys are present and, for packed planes, on
``QuantPolicy.impl``: ``ref`` (dequantize the whole weight), ``fused_ref``
(K-blocked plain product) or ``kernel`` (K1).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.formats import get_scheme
from repro_torch.core.packing import PackedWeight, make_layout
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.rtn import device_table
from repro_torch.core.xla_math import fma_f32, rsqrt_f32, sum_squares_f32


# --------------------------------------------------------------------- init
def make_linear(gen: torch.Generator, K: int, N: int, bias: bool = False, *,
                dtype=torch.float32, device="cpu", scale: Optional[float] = None):
    s = scale if scale is not None else 1.0 / np.sqrt(K)
    w = torch.randn((K, N), generator=gen, dtype=torch.float32, device=device) * s
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((N,), dtype=dtype, device=device)
    return p


def make_norm(d: int, *, dtype=torch.float32, device="cpu") -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


# -------------------------------------------------------------------- apply
def apply_linear(p: Dict[str, Any], x: torch.Tensor,
                 policy: Optional[QuantPolicy] = None, shards: int = 1) -> torch.Tensor:
    """y = x @ W (+b); dispatches plain vs AMS-packed representation.
    ``shards`` > 1: W is one of that many N-shards of a linear
    (`launch.sharding`); K1 / K1b then split K as they split the whole
    linear (`kernels.tuning.plan_ams_matmul`'s ``n_split``), so the shard's
    columns get the bits they get in the whole product."""
    if "w" in p:
        y = x @ p["w"].to(x.dtype)
    else:
        lay = make_layout(get_scheme(policy.scheme))
        K = x.shape[-1]
        N = p["scale"].shape[-1]
        pw = PackedWeight(p["hi"], p["lsb"], p["scale"], lay, K, N)
        impl = policy.impl
        if impl == "ref":
            from repro_torch.kernels import ref
            y = x @ ref.dequant_full(pw, torch.float32).to(x.dtype)
        elif impl == "fused_ref":
            from repro_torch.kernels import ref
            lead = x.shape[:-1]
            y = ref.ams_matmul_blocked(x.reshape(-1, K), pw).reshape(*lead, N).to(x.dtype)
        elif impl == "kernel":
            from repro_torch.kernels import ops
            y = ops.ams_matmul(x, pw, n_split=N * shards if shards > 1 else None).to(x.dtype)
        else:
            raise ValueError(f"unknown quant impl {impl!r}")
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def apply_row_parallel(p: Dict[str, Any], x: torch.Tensor, ctx) -> torch.Tensor:
    """A row-parallel linear of the training layout (``ctx.col_row``): x
    holds this rank's K / tp input columns and ``p["w"]`` its K rows; the
    ranks' partial products are added in rank order
    (`ParallelCtx.sum_ranks_grad` over ``model``: the identity backward),
    and the bias, whole on every rank, is added once after the sum."""
    y = ctx.sum_ranks_grad(x @ p["w"].to(x.dtype), "model")
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def materialize_weight(p: Dict[str, Any], K: int, dtype,
                       policy: Optional[QuantPolicy] = None) -> torch.Tensor:
    """The [K, N] weight in ``dtype``, dequantizing packed planes if needed
    (the absorbed MLA einsums use the weight outside a matmul; the packed
    planes are still what stays in memory)."""
    if "w" in p:
        return p["w"].to(dtype)
    from repro_torch.kernels import ref
    lay = make_layout(get_scheme(policy.scheme))
    pw = PackedWeight(p["hi"], p["lsb"], p["scale"], lay, K, p["scale"].shape[-1])
    return ref.dequant_full(pw, torch.float32).to(dtype)


def row_sum(x: torch.Tensor, mean: bool = False) -> torch.Tensor:
    """Sum (or mean) over the last axis, kept. On CUDA in two steps, over
    32 parts of each row and then over the parts, which gives a row the same
    bits whatever the other rows: torch's one-step reduction splits a row
    by the number of rows and its place among them (on an H100 a 3584-wide
    f32 row's sum has other bits at 2, 4 or 8 rows than alone), which would
    tie a token's result to what else its tick feeds. On the CPU torch's
    reduction is taken as it is (`rms_norm` sums in XLA's order there,
    `xla_math.sum_squares_f32`)."""
    if not x.is_cuda:
        return torch.mean(x, dim=-1, keepdim=True) if mean else x.sum(dim=-1, keepdim=True)
    n = x.shape[-1]
    if n % 32:
        s = row_sum(torch.nn.functional.pad(x, (0, 32 - n % 32)))
        return s * (1.0 / n) if mean else s
    parts = x.reshape(*x.shape[:-1], 32, n // 32)
    if mean:
        return parts.mean(dim=-1).mean(dim=-1, keepdim=True)
    return parts.sum(dim=-1).sum(dim=-1, keepdim=True)


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x / sqrt(mean(x^2) + eps) * g, in f32, rounded to x.dtype. On CUDA
    the mean square of `row_sum`; on the CPU the compiled reference's bits:
    the squares summed in XLA's order, times the f32 reciprocal of the
    width plus eps as one fused multiply-add (XLA's code generator contracts
    them), and XLA's rsqrt (`core.xla_math`)."""
    xf = x.to(torch.float32)
    if xf.is_cuda:
        var_eps = row_sum(xf * xf, mean=True) + np.float32(eps)
    else:
        var_eps = fma_f32(sum_squares_f32(xf), float(np.float32(1.0 / xf.shape[-1])),
                          float(np.float32(eps)))
    return (xf * rsqrt_f32(var_eps) * g.to(torch.float32)).to(x.dtype)


# --------------------------------------------------------------------- RoPE
def rope_angles(positions: torch.Tensor, dim: int, theta: float) -> torch.Tensor:
    """[..., dim/2] angles for integer positions; the inverse frequencies
    come from numpy in f32, as in the reference."""
    inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    inv = device_table(tuple(np.asarray(inv, np.float32).tolist()), torch.float32,
                       str(positions.device))
    return positions.to(torch.float32)[..., None] * inv


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S]."""
    hd = x.shape[-1]
    ang = rope_angles(positions, hd, theta)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ----------------------------------------------------------- quantize tree
def quantize_params(params, policy: QuantPolicy, strategy: Optional[str] = None,
                    prefix: str = "", policy_of=None):
    """Offline PTQ pass: replace eligible {'w': [.., K, N]} linears by packed
    planes; stacked leading dims (layers) are quantized slice by slice.
    Biases, norms and small tensors stay as they are. ``prefix`` is the path
    of ``params`` inside the full tree (the policy reads names).
    ``policy_of(path, w)``, where given, is the policy that judges the
    linear ``w`` at ``path`` eligible (the scheme and strategy stay ``policy``'s)."""
    from repro_torch.core.ams import ams_quantize
    from repro_torch.core.packing import pack

    scheme = get_scheme(policy.scheme)
    strategy = strategy or policy.strategy
    lay = make_layout(scheme)

    def quant_one(w2d):
        K = w2d.shape[0]
        wp = torch.nn.functional.pad(w2d.to(torch.float32), (0, 0, 0, lay.padded_k(K) - K))
        codes, scale = ams_quantize(wp, scheme, strategy)
        pw = pack(codes, scale, scheme)
        return {"hi": pw.hi, "lsb": pw.lsb, "scale": pw.scale}

    def quant_stacked(w):
        if w.dim() == 2:
            return quant_one(w)
        parts = [quant_stacked(w[i]) for i in range(w.shape[0])]
        return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}

    def visit(path: str, node):
        if isinstance(node, dict) and "w" in node:
            w = node["w"]
            judge = policy if policy_of is None else policy_of(path, w)
            if w.dim() >= 2 and judge.wants(path, tuple(w.shape[-2:])):
                out = quant_stacked(w)
                if "b" in node:
                    out["b"] = node["b"]
                return out
            return node
        if isinstance(node, dict):
            return {k: visit(f"{path}/{k}", v) for k, v in node.items()}
        return node

    return visit(prefix, params)


def ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_heads(h: int, tp: int) -> int:
    """A head count padded so it shards evenly over ``tp`` ranks."""
    return ceil_to(h, tp)


@dataclasses.dataclass(frozen=True)
class Dims:
    """Derived head/vocab dimensions, padded for a model axis of ``tp``
    ranks. Heads are GROUP-MAJOR: q-head slot j belongs to kv group
    j // gp; the first ``gt`` slots of each group are real heads, the rest
    padding (masked after attention)."""

    H: int          # padded q-head count
    H_true: int
    kv: int         # padded kv-head count
    kv_true: int
    hd: int
    V: int          # padded vocab
    V_true: int

    @property
    def gp(self) -> int:
        return self.H // self.kv

    @property
    def gt(self) -> int:
        return self.H_true // self.kv_true

    def head_mask(self, device) -> torch.Tensor:
        j = torch.arange(self.H, device=device)
        return ((j // self.gp < self.kv_true) & (j % self.gp < self.gt)).to(torch.float32)

    def vocab_mask_bias(self, device) -> torch.Tensor:
        """Additive -1e9 bias for padded vocab slots."""
        j = torch.arange(self.V, device=device)
        return torch.where(j < self.V_true, 0.0, -1e9).to(torch.float32)


def model_dims(cfg, tp: int = 1, head_dim: Optional[int] = None) -> Dims:
    """Dims at a model axis of ``tp`` ranks: q heads padded to a multiple
    of tp (kv heads padded alongside where the padded count stops dividing
    by them), the vocab to a multiple of tp; tp = 1 pads nothing."""
    hd = head_dim if head_dim is not None else cfg.head_dim
    H_true = cfg.num_heads
    kv_true = max(1, cfg.num_kv_heads)
    Hp = pad_heads(H_true, tp)
    kv = kv_true if Hp % kv_true == 0 else Hp
    return Dims(H=Hp, H_true=H_true, kv=kv, kv_true=kv_true, hd=hd,
                V=ceil_to(cfg.vocab_size, tp), V_true=cfg.vocab_size)
