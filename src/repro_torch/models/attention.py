"""GQA attention over a paged KV cache (port of the paged paths of
src/repro/models/attention.py).

Each tick's K/V vectors are written into the layer's page pool
(`cache.paged_insert`, in place; AMS pools quantize each vector once), then
every query attends the block table through `cache.paged_attend` (``ref``
oracle, or kernel K2 for AMS pages and K3 for bf16 pages).
Chunked steps carry intra-chunk causality in per-query lengths: query j
of a chunk inserted at ``pos`` sees ``pos + j + 1`` keys.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.cache import paged_attend, paged_insert

from .common import apply_linear, apply_rope, make_linear


def kv_index_map(H_pad: int, H_true: int, kv: int) -> np.ndarray:
    """q-head slot j -> kv head j // (H_pad // kv) (group-major layout)."""
    assert H_pad % kv == 0
    return (np.arange(H_pad) // (H_pad // kv)).astype(np.int32)


def init_gqa(gen, cfg, dims, *, dtype=torch.float32, device="cpu"):
    D, hd = cfg.d_model, dims.hd
    kw = dict(dtype=dtype, device=device)
    return {
        "wq": make_linear(gen, D, dims.H * hd, bias=cfg.qkv_bias, **kw),
        "wk": make_linear(gen, D, dims.kv * hd, bias=cfg.qkv_bias, **kw),
        "wv": make_linear(gen, D, dims.kv * hd, bias=cfg.qkv_bias, **kw),
        "wo": make_linear(gen, dims.H * hd, D, **kw),
    }


def gqa_qkv(p, x, cfg, dims, positions, policy=None):
    """Project + rope. x: [B, S, D] -> q [B,S,H,hd], k/v [B,S,kv,hd]."""
    B, S, _ = x.shape
    hd = dims.hd
    q = apply_linear(p["wq"], x, policy).reshape(B, S, dims.H, hd)
    k = apply_linear(p["wk"], x, policy).reshape(B, S, dims.kv, hd)
    v = apply_linear(p["wv"], x, policy).reshape(B, S, dims.kv, hd)
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta), v


def chunk_lengths(pos, nvalid, c: int) -> torch.Tensor:
    """Per-query valid-key counts [B, c] for a chunk inserted at ``pos``:
    query j sees pos + j + 1 keys; rows past nvalid (or idle slots) get 0."""
    j = torch.arange(c, dtype=torch.int32, device=pos.device)[None, :]
    ok = (pos[:, None] >= 0) & (j < nvalid[:, None])
    return torch.where(ok, pos[:, None] + j + 1, 0).to(torch.int32)


def gqa_paged_core(q, k_new, v_new, pool, pos, block_tables, *, cache_cfg, scale=None):
    """Paged insert + attend. q [B, H, hd]; k/v_new [B, 1, kv, hd]."""
    pool = paged_insert(pool, k_new, v_new, pos, block_tables, cache_cfg)
    kvm = kv_index_map(q.shape[-2], q.shape[-2], k_new.shape[-2])
    lengths = torch.where(pos >= 0, pos + 1, 0).to(torch.int32)
    return paged_attend(q, pool, lengths, block_tables, cache_cfg, kv_map=kvm,
                        scale=scale), pool


def gqa_attn_decode_paged(p, x, pool, pos, block_tables, cfg, dims, *, policy=None,
                          cache_cfg=None):
    """One-token paged decode: x [B, 1, D], pos [B]. Returns (out, pool)."""
    B = x.shape[0]
    q, k, v = gqa_qkv(p, x, cfg, dims, pos[:, None], policy)
    o, pool = gqa_paged_core(q[:, 0], k, v, pool, pos, block_tables, cache_cfg=cache_cfg)
    o = o * dims.head_mask(o.device)[None, :, None].to(o.dtype)
    return apply_linear(p["wo"], o.reshape(B, 1, dims.H * dims.hd), policy), pool


def gqa_paged_core_chunk(q, k_new, v_new, pool, pos, block_tables, nvalid, *, cache_cfg,
                         scale=None):
    """Chunked paged insert + attend. q [B, c, H, hd]; k/v_new [B, c, kv, hd]."""
    pool = paged_insert(pool, k_new, v_new, pos, block_tables, cache_cfg, nvalid=nvalid)
    kvm = kv_index_map(q.shape[-2], q.shape[-2], k_new.shape[-2])
    lengths = chunk_lengths(pos, nvalid, q.shape[1])
    return paged_attend(q, pool, lengths, block_tables, cache_cfg, kv_map=kvm,
                        scale=scale), pool


def gqa_attn_decode_paged_chunk(p, x, pool, pos, nvalid, block_tables, cfg, dims, *,
                                policy=None, cache_cfg=None):
    """Ragged paged decode: x [B, c, D], start positions ``pos`` [B], valid
    counts ``nvalid`` [B]. Returns (out [B, c, D], pool)."""
    B, c, _ = x.shape
    positions = torch.clamp(pos[:, None] + torch.arange(c, dtype=torch.int32,
                                                        device=x.device), min=0)
    q, k, v = gqa_qkv(p, x, cfg, dims, positions, policy)
    o, pool = gqa_paged_core_chunk(q, k, v, pool, pos, block_tables, nvalid,
                                   cache_cfg=cache_cfg)
    o = o * dims.head_mask(o.device)[None, None, :, None].to(o.dtype)
    return apply_linear(p["wo"], o.reshape(B, c, dims.H * dims.hd), policy), pool
