"""Paged KV cache, bf16 or AMS-quantized pages (port of src/repro/cache).

  * `config.CacheConfig`      — cache-mode selection + derived sizes
  * `allocator.PageAllocator` — host-side refcounting free list, block-hash
                                prefix index, block-table rows
  * `pool`                    — bf16 and AMS page pools, in-place insert
                                and truncate, page gather, host spill
                                (extract / restore pages)
  * `ref`                     — lattice-exact gather-dequantize-attend oracle
  * `paged_attention`         — kernels K2 (AMS pages) and K3 (bf16 pages)
                                walking the block table

`paged_attend` dispatches on `CacheConfig.impl` ("ref" | "kernel").
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .allocator import PageAllocator, prefix_page_hashes  # noqa: F401
from .config import CACHE_KINDS, PAGED_KINDS, CacheConfig  # noqa: F401
from .pool import (  # noqa: F401
    compression_vs_bf16,
    extract_pages,
    gather_kv,
    gather_pages,
    host_bytes,
    make_gqa_page_pool,
    paged_insert,
    paged_truncate,
    pool_bytes_per_token,
    restore_pages,
)
from .ref import paged_attention_ref  # noqa: F401


def paged_attend(q, pool, lengths, block_table, ccfg: CacheConfig, *, kv_map: np.ndarray,
                 scale: Optional[float] = None):
    """impl-dispatching paged flash-decode: q [B, H, hd] -> [B, H, hd], or a
    ragged chunk q [B, c, H, hd] with per-query lengths [B, c]."""
    if ccfg.impl == "ref":
        return paged_attention_ref(q, pool, lengths, block_table, ccfg,
                                   kv_map=kv_map, scale=scale)
    from .paged_attention import paged_attention_kernel
    H = q.shape[-2]
    kv_n = int(np.max(kv_map)) + 1 if len(kv_map) else 1
    if H % kv_n != 0 or not np.array_equal(kv_map, np.arange(H) // (H // kv_n)):
        raise NotImplementedError("kernel paged attention requires the group-major GQA layout")
    return paged_attention_kernel(q, pool, lengths, block_table, ccfg, scale=scale)
