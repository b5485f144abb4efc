"""Lattice-exact paged attention oracle: gather -> dequantize -> attend
(port of src/repro/cache/ref.py).

Pages are gathered into a per-slot [B, max_pages*page, kv, hd] view through
the block table, AMS planes are restored to their exact f32 lattice values
(bf16 pages stay in q.dtype, so p is rounded to the pages' type before the
PV product as in `flash_decode`), and the plain `flash_decode` bodies attend
with per-slot (or per-query) lengths. K2 differs from this only by f32
summation order; K3 rounds p at the running max instead of the global one,
so it agrees to bf16 precision.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.attention_template import flash_decode, flash_decode_chunk

from .config import CacheConfig
from .pool import gather_kv


def paged_attention_ref(q, pool, lengths, block_table, ccfg: CacheConfig, *, kv_map,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q [B, H, hd] with lengths [B], or a ragged chunk q [B, c, H, hd] with
    per-query lengths [B, c]; returns q's shape in q.dtype."""
    hd = q.shape[-1]
    dtype = torch.float32 if ccfg.quantized else q.dtype
    k, v = gather_kv(pool, block_table, hd, ccfg, dtype=dtype)
    if q.dim() == 4:
        return flash_decode_chunk(q, k, v, lengths, kv_map=kv_map, scale=scale)
    return flash_decode(q, k, v, lengths, kv_map=kv_map, scale=scale)
