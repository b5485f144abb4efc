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
from dataclasses import dataclass
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


# ---------------------------------------------------------------------------
# Hopper plans for K1 and K4 (no counterpart in the reference, whose tiles
# are planned for a TPU core). Each wrapper passes its plan to the kernel as
# plain ints; the kernels take the plan as given.
# ---------------------------------------------------------------------------
SMS = 132                  # streaming multiprocessors of one H100 SXM
MAX_CLUSTER = 8            # the portable thread-block cluster size

K1_GROUP_WORDS = 8         # fp533 words of one k-group: 48 K positions, 3 k16 steps
K1_ROW_TILES = (1, 2, 4, 8, 16)   # 8-row n-tiles per CTA the kernel is built for
K1_MIN_CTAS = 64           # fewest CTAs K1 accepts before narrowing its tile


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class MatmulPlan:
    """K1's launch: ``col_tiles`` x ``row_tiles`` output tiles of ``tn``
    columns x ``8 * nt`` rows, each reduced over K by a cluster of
    ``cluster`` CTAs; rank r takes packed word rows [r * split_words,
    min((r + 1) * split_words, Kw))."""
    tn: int
    nt: int
    row_tiles: int
    col_tiles: int
    cluster: int
    split_words: int

    @property
    def ctas(self) -> int:
        return self.col_tiles * self.row_tiles * self.cluster

    def splits(self, Kw: int):
        return [(r * self.split_words, min((r + 1) * self.split_words, Kw))
                for r in range(self.cluster)]


def plan_ams_matmul(B: int, Kw: int, N: int, sms: int = SMS) -> MatmulPlan:
    """Tile plan of K1 for x [B, 6 Kw] against fp533 words [Kw, N]: the
    smallest row tile that holds B (16 n-tiles of 8 rows at most, more row
    tiles past 128 rows); 64 columns per CTA, 128 at 16 n-tiles (each x
    tile then feeds twice the columns), 32 where 64 gives fewer than 64
    CTAs even at the largest cluster; K split over a cluster of up to 8
    CTAs, on k-group boundaries (8 words), until every SM holds as many
    CTAs as fit at once (4 at up to 8 n-tiles, 2 at 16: their rings take
    48 and 99 KB of shared memory)."""
    if B < 1 or Kw < 1 or N < 1:
        raise ValueError(f"empty matmul B={B} Kw={Kw} N={N}")
    nt = next((t for t in K1_ROW_TILES if 8 * t >= B), K1_ROW_TILES[-1])
    row_tiles = _cdiv(B, 8 * nt)
    groups = _cdiv(Kw, K1_GROUP_WORDS)
    if nt == K1_ROW_TILES[-1]:
        tn = 128
    else:
        tn = 64 if _cdiv(N, 64) * row_tiles * min(MAX_CLUSTER, groups) >= K1_MIN_CTAS else 32
    resident = 2 if nt == K1_ROW_TILES[-1] else 4
    col_tiles = _cdiv(N, tn)
    cluster = max(1, min(MAX_CLUSTER, groups, _cdiv(resident * sms, col_tiles * row_tiles)))
    per = _cdiv(groups, cluster)               # k-groups per rank
    cluster = _cdiv(groups, per)               # no rank left without words
    return MatmulPlan(tn, nt, row_tiles, col_tiles, cluster, per * K1_GROUP_WORDS)


ATT_ROWS = 16              # folded query rows per CTA: one m16 tile
ATT_TILE_KEYS = 32         # keys per shared-memory tile of K4's ring
ATT_SCORE_BYTES = 64 * 1024    # shared memory K4 gives a block share's f32 scores


@dataclass(frozen=True)
class AttentionPlan:
    """K4's launch: per (slot, kv head, tile of 16 rows) a cluster of
    ``cluster`` CTAs splits each key block (`attention_shares`);
    ``scores_fit`` says whether a CTA keeps its share's scores in shared
    memory (one pass over the keys per block) or recomputes them in a second
    pass, two tiles of 32 keys at a time; ``score_keys`` is the score
    buffer's width in keys."""
    cluster: int
    row_tiles: int
    share_keys: int
    scores_fit: bool
    score_keys: int

    def ctas(self, B: int, kv: int) -> int:
        return B * kv * self.row_tiles * self.cluster


def _share(keys: int, cluster: int) -> int:
    """One rank's share of ``keys``: an equal part rounded up to whole tiles."""
    return _cdiv(_cdiv(keys, cluster), ATT_TILE_KEYS) * ATT_TILE_KEYS


def attention_shares(b0: int, b1: int, cluster: int):
    """The contiguous key ranges [lo, hi) of the ``cluster`` ranks over the
    visible keys [b0, b1) of one block: equal shares rounded up to whole
    tiles of 32 keys; trailing ranks may get an empty range."""
    sh = _share(max(b1 - b0, 0), cluster)
    return [(min(b0 + r * sh, b1), min(b0 + (r + 1) * sh, b1)) for r in range(cluster)]


def plan_contiguous_attention(B: int, kv: int, R: int, block_kv: int,
                              sms: int = SMS) -> AttentionPlan:
    """Cluster and score plan of K4 for B slots x kv heads x R folded rows
    over key blocks of ``block_kv``: enough ranks for about two CTAs per SM
    (at most 8, and no more than the block has tiles of 32 keys); the
    scores of a share fit when 16 rows x its keys in f32 take at most
    64 KiB."""
    if min(B, kv, R, block_kv) < 1:
        raise ValueError(f"empty attention B={B} kv={kv} R={R} block_kv={block_kv}")
    row_tiles = _cdiv(R, ATT_ROWS)
    cluster = max(1, min(MAX_CLUSTER, _cdiv(block_kv, ATT_TILE_KEYS),
                         _cdiv(2 * sms, B * kv * row_tiles)))
    share = _share(block_kv, cluster)
    fit = ATT_ROWS * share * 4 <= ATT_SCORE_BYTES
    return AttentionPlan(cluster, row_tiles, share, fit, share if fit else 2 * ATT_TILE_KEYS)
