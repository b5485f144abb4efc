"""The reference's KV-block plan for contiguous-cache attention (port of the
deterministic default of src/repro/kernels/tuning.py: `attn_vmem_usage` and
`plan_attention_tiles(kind="contiguous")`).

The TPU kernel rounds p to bf16 at the running max of each ``block_kv``
block of keys, so its output depends on the block size: to give the same
numbers, the port's contiguous attention (K4, K5 and their plain versions)
walks the blocks the reference would choose. The reference picks the
largest divisor of the cache length whose working set fits 16 MiB of VMEM;
that choice is reproduced here. Its autotune cache, measured selection and
``REPRO_ATTN_MEASURE`` are not ported: they change block sizes by wall
clock on a TPU and have no meaning for the port's numbers.
"""

from __future__ import annotations

import math
from typing import Optional

VMEM_BYTES = 16 * 2 ** 20  # the reference's VMEM budget (v5e, per core)


def attn_vmem_usage(rows: int, block_kv: int, hd: int, hd_v: Optional[int] = None,
                    buffers: int = 2) -> int:
    """Bytes of VMEM one (rows, block_kv) contiguous attention cell claims in
    the reference (no AMS scheme): double-buffered K/V streams (f32 upper
    bound), q, the f32 accumulator, the (rows, 128) m/l scratch columns and
    the output."""
    hd_v = hd if hd_v is None else hd_v
    streams = buffers * 4 * block_kv * (hd + hd_v)
    q = 4 * rows * hd
    acc = 4 * rows * hd_v
    ml = 2 * 4 * rows * 128
    out = 4 * rows * hd_v
    return streams + q + acc + ml + out


def _divisors_desc(n: int):
    out = {n}
    for i in range(1, math.isqrt(n) + 1):
        if n % i == 0:
            out.update((i, n // i))
    return sorted(out, reverse=True)


def reference_block_kv(*, rows: int, hd: int, hd_v: Optional[int] = None, s_max: int,
                       budget: int = VMEM_BYTES) -> int:
    """The reference's default contiguous block: the largest divisor of
    ``s_max`` whose `attn_vmem_usage` fits ``budget``, else the smallest
    divisor (1). ``rows`` are the folded query rows of one cell (chunk x
    group)."""
    cands = _divisors_desc(s_max)
    for bk in cands:
        if attn_vmem_usage(rows, bk, hd, hd_v) <= budget:
            return bk
    return cands[-1]
