"""Paged attention through kernel K2 or K3 (port of src/repro/cache/paged_attention.py).

Unpacks a `CacheConfig` into the template's plain parameters (page size,
AMS scheme, or None for bf16 pages) and calls
`kernels.attention_template.fused_paged_attention`, which launches K2 (AMS
pages) or K3 (bf16 pages) on CUDA tensors and runs their plain versions on
CPU ones.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.kernels.attention_template import (  # noqa: F401
    NEG_BIG,
    NEG_CLAMP,
    fused_paged_attention,
    restore_page,
)

from .config import CacheConfig


def paged_attention_kernel(q, pool, lengths, block_table, ccfg: CacheConfig, *,
                           scale: Optional[float] = None):
    """q [B, H, hd] or [B, c, H, hd] (unscaled); returns q's shape in q.dtype."""
    return fused_paged_attention(
        q, pool, lengths, block_table, page_size=ccfg.page_size,
        kv_scheme=ccfg.kv_scheme if ccfg.quantized else None, scale=scale)
