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
# Hopper plans for K1, K1b, K2, K3, K4, K5 and K5p (no counterpart in the reference, whose tiles
# are planned for a TPU core). Each wrapper passes its plan to the kernel as
# plain ints; the kernels take the plan as given.
# ---------------------------------------------------------------------------
SMS = 132                  # streaming multiprocessors of one H100 SXM
MAX_CLUSTER = 8            # the portable thread-block cluster size
SM_SMEM_BYTES = 233472     # shared memory of one SM (228 KB)
CTA_SMEM_RESERVED = 1024   # shared memory the hardware reserves per CTA

K1_GROUP_WORDS = 8         # word rows of a k-group (fp533: 48 K); 16 at per_word 5
K1_ROW_TILES = (1, 2, 4, 8, 16)   # 8-row n-tiles per CTA the kernel is built for
K1_MIN_CTAS = 64           # fewest CTAs K1 accepts before narrowing its tile
K1_STAGES = 4              # stages of the kernel's cp.async ring
# x's shared-memory row stride per K positions per word (fp533: 6) of the
# decode hook: (residue, modulus) in bf16 that keeps its fragment loads free
# of bank conflicts (kXMod, kXPeriod in csrc/ams_matmul.cu)
K1_X_STRIDE = {4: (32, 64), 5: (8, 16), 6: (16, 64), 8: (8, 64)}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _per_word(container: str, per_word: Optional[int]) -> int:
    if container not in ("fp533", "planes"):
        raise ValueError(f"unknown container {container!r}")
    if per_word is None:
        return 6 if container == "fp533" else 8
    if (container == "fp533" and per_word != 6) or per_word not in K1_X_STRIDE:
        raise ValueError(f"no K1 decode hook for {container} with per_word {per_word}")
    return per_word


def k1_group_words(per_word: int = 8) -> int:
    """Word rows of one k-group of K1 / K1b: 8, or 16 at per_word 5 (a
    thread's two words hold 10 K, a k-step takes 4 per column, so a thread
    owns four words: 20 K, 5 k-steps)."""
    return 16 if per_word == 5 else K1_GROUP_WORDS


def k1_stage_rows(nt: int, per_word: int = 8) -> int:
    """Word rows per stage of K1's ring at ``nt`` n-tiles (at least one
    k-group)."""
    return max(8 if nt >= 16 else (16 if nt >= 4 else 32), k1_group_words(per_word))


def k1_lsb_rows(rw: int, k: int, per_word: int = 8) -> int:
    """lsb rows a K1b stage copies: the most that ``rw`` word rows of
    ``per_word`` K each, starting on a k-group boundary, can take their LSBs
    from, one lsb row serving 32 k positions."""
    return (rw * per_word + 32 * k - 1) // (32 * k) + 1


def k1_ring_bytes(tn: int, nt: int, container: str = "fp533", k: int = 1,
                  per_word: Optional[int] = None) -> int:
    """Shared memory of one K1 / K1b CTA (`K1Shape` in csrc/ams_matmul.cu):
    the 4-stage ring, each stage holding its word rows (TN + 4 words each),
    for the planes with k > 1 the lsb rows they take their LSBs from, and
    x's K slice (rows padded per `K1_X_STRIDE`), or the partial sums' tile
    when that is larger. ``per_word``: K positions per word (default 6 for
    fp533, 8 for the planes)."""
    pw = _per_word(container, per_word)
    xmod, period = K1_X_STRIDE[pw]
    rw = k1_stage_rows(nt, pw)
    lr = k1_lsb_rows(rw, k, pw) if container == "planes" and k > 1 else 0
    xk = rw * pw
    xs = xk + (xmod - xk) % period
    stage = (rw + lr) * (tn + 4) * 4 + 8 * nt * xs * 2
    return max(K1_STAGES * stage, tn * 8 * nt * 4)


@dataclass(frozen=True)
class MatmulPlan:
    """The launch of K1 and K1b: ``col_tiles`` x ``row_tiles`` output tiles
    of ``tn`` columns x ``8 * nt`` rows, each reduced over K by a cluster of
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


def plan_ams_matmul(B: int, Kw: int, N: int, container: str = "fp533", k: int = 1,
                    per_word: Optional[int] = None, sms: int = SMS,
                    n_split: Optional[int] = None) -> MatmulPlan:
    """Tile plan of K1 for x [B, 6 Kw] against fp533 words [Kw, N], or of
    K1b (``container="planes"``, ``per_word`` K positions per word, 8 by
    default, shared-LSB group ``k``) for x [B, per_word Kw] against planes
    [Kw, N]: the smallest row tile that holds B (16 n-tiles of 8 rows at
    most, more row tiles past 128 rows); 64 columns per CTA, 128 at 16
    n-tiles (each x tile then feeds twice the columns), 32 where 64 gives
    fewer than 64 CTAs even at the largest cluster. K is split on k-group
    boundaries (`k1_group_words`) over the cluster of the decode plan (one
    tile of 8 rows) at every B: up to 8 CTAs, until every SM holds as many
    CTAs as fit at once, 4, fewer where their rings (`k1_ring_bytes`) do
    not fit an SM's shared memory together. A row's sum then has the same
    association at every B (the kernel adds each k-group's part in group
    order), so a row gets the same bits in a tick of any width.

    ``n_split``: the N of the whole linear when [Kw, N] is one rank's
    N-shard of it (tensor-parallel serving): the cluster, and so the K
    split, is then the whole linear's, and a column gets the bits it gets
    at tp = 1; the column tiles still follow the shard's N."""
    if B < 1 or Kw < 1 or N < 1:
        raise ValueError(f"empty matmul B={B} Kw={Kw} N={N}")
    pw = _per_word(container, per_word)
    gw = k1_group_words(pw)
    groups = _cdiv(Kw, gw)

    Nw = N if n_split is None else n_split   # the whole linear's N

    def tile_cols(nt: int, row_tiles: int, n: int) -> int:
        if nt == K1_ROW_TILES[-1]:
            return 128
        return 64 if _cdiv(n, 64) * row_tiles * min(MAX_CLUSTER, groups) >= K1_MIN_CTAS else 32

    tn1 = tile_cols(1, 1, Nw)                  # the decode plan's cluster
    fit = SM_SMEM_BYTES // (k1_ring_bytes(tn1, 1, container, k, pw) + CTA_SMEM_RESERVED)
    cluster = max(1, min(MAX_CLUSTER, groups, _cdiv(max(1, min(4, fit)) * sms, _cdiv(Nw, tn1))))
    per = _cdiv(groups, cluster)               # k-groups per rank
    cluster = _cdiv(groups, per)               # no rank left without words
    nt = next((t for t in K1_ROW_TILES if 8 * t >= B), K1_ROW_TILES[-1])
    row_tiles = _cdiv(B, 8 * nt)
    tn = tile_cols(nt, row_tiles, N)
    return MatmulPlan(tn, nt, row_tiles, _cdiv(N, tn), cluster, per * gw)


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


def plan_contiguous_attention(B: int, kv: int, R: int, block_kv: int) -> AttentionPlan:
    """Cluster and score plan of K4 for B slots x kv heads x R folded rows
    over key blocks of ``block_kv``: 8 ranks (no more than the block has
    tiles of 32 keys), each a share of the whole block
    (`attention_shares`), at every B and R, so a row's keys split and merge
    in the same order whatever else the call holds (8 slots x 4 kv heads
    at decode: 256 CTAs, about two per SM); the scores of a share fit when
    16 rows x its keys in f32 take at most 64 KiB."""
    if min(B, kv, R, block_kv) < 1:
        raise ValueError(f"empty attention B={B} kv={kv} R={R} block_kv={block_kv}")
    row_tiles = _cdiv(R, ATT_ROWS)
    cluster = max(1, min(MAX_CLUSTER, _cdiv(block_kv, ATT_TILE_KEYS)))
    share = _share(block_kv, cluster)
    fit = ATT_ROWS * share * 4 <= ATT_SCORE_BYTES
    return AttentionPlan(cluster, row_tiles, share, fit, share if fit else 2 * ATT_TILE_KEYS)


MLA_ROWS = 48              # folded query rows per K5 CTA: three m16 tiles
MLA_RESIDENT_KEYS = 128    # keys of a share K5's ring holds at once (4 tiles of 32)


@dataclass(frozen=True)
class MlaPlan:
    """K5's launch: per (slot, kv head, group of 48 rows) a cluster of
    ``cluster`` CTAs splits each key block (`attention_shares`); a share of
    ``share_keys`` stays resident in shared memory between the scores and
    the p.v product when ``resident`` (one read of the keys per block),
    else the keys stream through the ring twice and the scores are
    recomputed in the second pass."""
    cluster: int
    row_groups: int
    share_keys: int
    resident: bool

    def ctas(self, B: int, kv: int) -> int:
        return B * kv * self.row_groups * self.cluster


def plan_mla_attention(B: int, kv: int, R: int, block_kv: int) -> MlaPlan:
    """Cluster plan of K5 for B slots x kv heads x R folded rows over key
    blocks of ``block_kv``. A CTA takes ~190 KB of shared memory, so one
    fits an SM. The portable 8 ranks (no more than the block has tiles of
    32 keys), each a share of the whole block, at every B and R, as K4's
    (8 slots at decode: 64 CTAs); a share stays resident up to blocks of
    1024 keys."""
    if min(B, kv, R, block_kv) < 1:
        raise ValueError(f"empty attention B={B} kv={kv} R={R} block_kv={block_kv}")
    row_groups = _cdiv(R, MLA_ROWS)
    cluster = max(1, min(MAX_CLUSTER, _cdiv(block_kv, ATT_TILE_KEYS)))
    share = _share(block_kv, cluster)
    return MlaPlan(cluster, row_groups, share, share <= MLA_RESIDENT_KEYS)


PAGED_SUB_KEYS = 32        # tokens of one K2 sub-tile (restored together)
PAGED_ROW_TILES = (8, 16)  # folded query rows per K2 CTA the kernel is built for


@dataclass(frozen=True)
class PagedPlan:
    """K2's launch: per (slot, kv head, tile of ``rows`` folded rows) a
    cluster of ``cluster`` CTAs; rank r walks share r of each row's visible
    tokens (`paged_row_shares`), and the ranks merge their (m, l, acc) in
    rank order."""
    rows: int
    row_tiles: int
    cluster: int

    def ctas(self, B: int, kv: int) -> int:
        return B * kv * self.row_tiles * self.cluster


def paged_row_shares(ntok: int):
    """The K2_PARTS (8) shares [lo, hi) of a row's ``ntok`` visible tokens:
    equal parts rounded up to whole 32-token sub-tiles (the last cut at
    ntok), a function of ntok alone, so a row's result does not depend on
    its tile, the tick's width or the cluster; trailing shares may be
    empty."""
    return attention_shares(0, ntok, MAX_CLUSTER)


def plan_paged_attention(B: int, kv: int, R: int, max_keys: int) -> PagedPlan:
    """Row tile and cluster of K2 for B slots x kv heads x R folded rows over
    at most ``max_keys`` tokens per slot (block table width x page size):
    8 rows where they hold R (decode, g <= 8), else 16; one rank per share
    of `paged_row_shares` a row can fill, 8 but for slots of fewer than 256
    tokens, at every B and R (8 slots x 4 kv heads at decode: 256 CTAs,
    about two per SM)."""
    if min(B, kv, R, max_keys) < 1:
        raise ValueError(f"empty attention B={B} kv={kv} R={R} max_keys={max_keys}")
    rows = next((r for r in PAGED_ROW_TILES if r >= R), PAGED_ROW_TILES[-1])
    cluster = max(1, min(MAX_CLUSTER, _cdiv(max_keys, PAGED_SUB_KEYS)))
    return PagedPlan(rows, _cdiv(R, rows), cluster)


K3_SCORE_KEYS_MAX = 512    # widest share whose f32 scores a K3 CTA keeps (32 KiB)


@dataclass(frozen=True)
class PagedBf16Plan:
    """K3's launch: per (slot, kv head, tile of 16 rows) a cluster of
    ``cluster`` CTAs walks the tokens the tile's rows can see in segments of
    whole pages (`paged_segments`), each split into the ranks' shares
    (`attention_shares`); a rank keeps its share's f32 scores, at most
    ``score_keys`` of them, so a segment holds at most cluster x
    score_keys tokens."""
    row_tiles: int
    cluster: int
    score_keys: int

    def ctas(self, B: int, kv: int) -> int:
        return B * kv * self.row_tiles * self.cluster


def plan_paged_bf16_attention(B: int, kv: int, R: int, max_keys: int,
                              page: int) -> PagedBf16Plan:
    """Cluster and score buffer of K3 for B slots x kv heads x R folded rows
    over at most ``max_keys`` tokens per slot (block table width x page
    size) in pages of ``page``: 8 ranks (no more than the 32-token tiles a
    slot holds) at every B and R, so a row's tokens split and merge in the
    same order whatever else the call holds (the kernel takes the segments
    and shares of the block table's tokens, cut at the tile's last visible
    one); the score buffer holds a rank's share of all ``max_keys``
    tokens, at most 512 (longer slots take more segments; a page wider than
    a segment is walked in parts, its rest scanned twice)."""
    if min(B, kv, R, max_keys, page) < 1:
        raise ValueError(f"empty attention B={B} kv={kv} R={R} max_keys={max_keys} page={page}")
    row_tiles = _cdiv(R, ATT_ROWS)
    cluster = max(1, min(MAX_CLUSTER, _cdiv(max_keys, ATT_TILE_KEYS)))
    cluster = min(MAX_CLUSTER, max(cluster, _cdiv(page, K3_SCORE_KEYS_MAX)))
    return PagedBf16Plan(row_tiles, cluster, min(K3_SCORE_KEYS_MAX, _share(max_keys, cluster)))


@dataclass(frozen=True)
class PagedMlaPlan:
    """K5p's launch: per (slot, kv head, group of 48 rows) a cluster of
    ``cluster`` CTAs walks the tokens the group's rows can see in segments of
    at most cluster x 128 tokens (`paged_segments`; whole pages on bf16
    pages), each split into the ranks' shares (`attention_shares`), which
    stay resident from the scores to p . v."""
    row_groups: int
    cluster: int

    def ctas(self, B: int, kv: int) -> int:
        return B * kv * self.row_groups * self.cluster


def plan_paged_mla_attention(B: int, kv: int, R: int, max_keys: int,
                             sms: int = SMS) -> PagedMlaPlan:
    """Cluster plan of K5p for B slots x kv heads x R folded rows over at
    most ``max_keys`` tokens per slot: as K5's (`plan_mla_attention`), enough
    ranks for one CTA per SM and at least enough that every share of the
    ``max_keys`` tokens stays resident (128 keys), at most the portable 8
    and no more than the 32-token tiles a slot holds. A bf16 page wider than
    the ranks' shares hold (1024 tokens at 8) is walked in parts of 64 keys
    a rank, two ring slots left to scan the page's rest."""
    if min(B, kv, R, max_keys) < 1:
        raise ValueError(f"empty attention B={B} kv={kv} R={R} max_keys={max_keys}")
    row_groups = _cdiv(R, MLA_ROWS)
    fill = _cdiv(sms, B * kv * row_groups)
    keep = _cdiv(max_keys, MLA_RESIDENT_KEYS)
    cluster = max(1, min(MAX_CLUSTER, _cdiv(max_keys, ATT_TILE_KEYS), max(fill, keep)))
    return PagedMlaPlan(row_groups, cluster)


def paged_segments(ntok: int, page: int, cluster: int, share_keys: int,
                   whole_pages: bool = True):
    """The segments [s0, s1) in which K3 and K5p walk a tile's ``ntok``
    visible tokens: at most cluster x share_keys tokens each, the last cut
    at ``ntok``; with ``whole_pages`` (bf16 pages, whose p is rounded at the
    page max) as many whole pages as fit, or for a page wider than that
    parts of it, the last ending with it. One exchange of maxima between
    the ranks per segment."""
    cap = cluster * share_keys
    segs, s0 = [], 0
    while s0 < ntok:
        if not whole_pages:
            s1 = s0 + cap
        elif page <= cap:
            s1 = s0 + cap // page * page
        else:
            s1 = min(s0 + cap, (s0 // page + 1) * page)
        segs.append((s0, min(s1, ntok)))
        s0 = segs[-1][1]
    return segs
