"""Attention: GQA over paged or contiguous caches and absorbed MLA over a
contiguous compressed stream (port of src/repro/models/attention.py), for
the decode step and for the full-sequence forward.

The sequence forward (`gqa_attn_train`, `mla_attn_train`) runs the
reference's blockwise online softmax in plain torch, as the reference runs
it in plain XLA, with its bidirectional modality prefix and its window
mask; its projections go through `apply_linear`, so with packed weights
and ``impl="kernel"`` K1 / K1b run at B = sequence length.

Each tick's K/V vectors are written into the layer's cache in place: a page
pool (`cache.paged_insert`; AMS pools quantize each vector once) or a
contiguous [B, S, kv, hd] cache (`cache_insert` / `cache_insert_chunk`; a
sliding-window ``attn`` block's ring of the last W positions at slot
position % W).
Then every query attends: paged caches through `cache.paged_attend`
(``ref`` oracle, or kernel K2 for AMS pages and K3 for bf16 pages),
contiguous ones through `kernels.attention_template.attend_contiguous`
(``ref`` flash-decode, or kernel K4 for GQA and K5 for the MLA stream).

Chunked steps carry intra-chunk causality in per-query lengths: query j of
a chunk inserted at ``pos`` sees ``pos + j + 1`` keys.

MLA runs in the absorbed form: q_nope is folded through W_uk into the
compressed space, scores and values are taken directly against the cached
stream [kv_lora | rope] (one kv head shared by all heads; the values are
its first kv_lora columns), and W_uv lifts the result back per head.

Tensor parallelism (a `models.parallel.ParallelCtx` of tp > 1): page
pools hold the rank's kv heads, which attend with the rank's q heads;
contiguous caches (GQA, rings, the MLA stream) are sequence-sharded
(``ctx.seq_shard``): q reaches the core whole (gathered from the
projections' N-shards; MLA's q_eff from each rank's absorbed heads), the
rank that owns a position inserts it, and the ranks' partial softmaxes
merge in `attention_template.flash_decode`. Every projection keeps its K
whole on each rank. The sequence forward in the training layout
(``ctx.col_row``) attends with the rank's heads instead and sums ``wo``'s
partial products over the ranks (`gqa_attn_train`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.cache import paged_attend, paged_insert
from repro_torch.core.xla_math import bf16_dot, exp_f32, pairs_bf16_dot
from repro_torch.kernels.attention_template import attend_contiguous

from .common import (apply_linear, apply_row_parallel, apply_rope, make_linear, make_norm,
                     materialize_weight, rms_norm)
from .parallel import NO_CTX, heads_split


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


def rank_qkv(p, x, cfg, dims, positions, policy, ctx):
    """q / k / v of this rank's heads, and their head mask. At tp = 1 (or
    ``ctx`` None) every head. At tp > 1 the N-sharded projections give the
    rank's H / tp q heads and, where the model axis divides the kv heads
    (`parallel.heads_split`: the page pool holds the rank's kv heads), its
    kv / tp kv heads, which group-major order pairs with them; otherwise,
    and over a sequence-sharded contiguous cache (``ctx.seq_shard``, whose
    core attends with every head over the rank's positions), q, k and v
    are gathered whole."""
    tp = ctx.tp
    hm = dims.head_mask(x.device)
    if tp == 1:
        return (*gqa_qkv(p, x, cfg, dims, positions, policy), hm)
    B, S, _ = x.shape
    q, k, v = (apply_linear(p[n], x, policy, tp) for n in ("wq", "wk", "wv"))
    if heads_split(dims.kv, tp) and not ctx.seq_shard:
        h = dims.H // tp
        hm = hm[ctx.rank * h:(ctx.rank + 1) * h]
    else:
        q, k, v = ctx.all_gather_last_each(q, k, v)
    q, k, v = (t.reshape(B, S, -1, dims.hd) for t in (q, k, v))
    return (apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta),
            v, hm)


def attn_out(p, o, policy, ctx, dims):
    """``wo`` of the attention output o [B, S, heads * hd]: at tp > 1 the
    ranks' heads are gathered first (where they were split) and wo's
    N-shards gathered after, so ``wo`` contracts every head on each rank."""
    tp = ctx.tp
    if tp == 1:
        return apply_linear(p["wo"], o, policy)
    if heads_split(dims.kv, tp) and not ctx.seq_shard:
        o = ctx.all_gather_last(o)
    return ctx.all_gather_last(apply_linear(p["wo"], o, policy, tp))


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
                          cache_cfg=None, ctx=NO_CTX):
    """One-token paged decode: x [B, 1, D], pos [B]. Returns (out, pool).
    Under a tp > 1 ``ctx`` the pool holds this rank's kv heads
    (`rank_qkv`)."""
    B = x.shape[0]
    q, k, v, hm = rank_qkv(p, x, cfg, dims, pos[:, None], policy, ctx)
    o, pool = gqa_paged_core(q[:, 0], k, v, pool, pos, block_tables, cache_cfg=cache_cfg)
    o = o * hm[None, :, None].to(o.dtype)
    return attn_out(p, o.reshape(B, 1, -1), policy, ctx, dims), pool


def gqa_paged_core_chunk(q, k_new, v_new, pool, pos, block_tables, nvalid, *, cache_cfg,
                         scale=None):
    """Chunked paged insert + attend. q [B, c, H, hd]; k/v_new [B, c, kv, hd]."""
    pool = paged_insert(pool, k_new, v_new, pos, block_tables, cache_cfg, nvalid=nvalid)
    kvm = kv_index_map(q.shape[-2], q.shape[-2], k_new.shape[-2])
    lengths = chunk_lengths(pos, nvalid, q.shape[1])
    return paged_attend(q, pool, lengths, block_tables, cache_cfg, kv_map=kvm,
                        scale=scale), pool


def gqa_attn_decode_paged_chunk(p, x, pool, pos, nvalid, block_tables, cfg, dims, *,
                                policy=None, cache_cfg=None, ctx=NO_CTX):
    """Ragged paged decode: x [B, c, D], start positions ``pos`` [B], valid
    counts ``nvalid`` [B]. Returns (out [B, c, D], pool). ``ctx`` as in
    `gqa_attn_decode_paged`."""
    B, c, _ = x.shape
    positions = torch.clamp(pos[:, None] + torch.arange(c, dtype=torch.int32,
                                                        device=x.device), min=0)
    q, k, v, hm = rank_qkv(p, x, cfg, dims, positions, policy, ctx)
    o, pool = gqa_paged_core_chunk(q, k, v, pool, pos, block_tables, nvalid,
                                   cache_cfg=cache_cfg)
    o = o * hm[None, None, :, None].to(o.dtype)
    return attn_out(p, o.reshape(B, c, -1), policy, ctx, dims), pool


# ---------------------------------------------------------------------------
# Full-sequence attention (the sequence forward; plain torch, as the
# reference computes it in plain XLA)
# ---------------------------------------------------------------------------
def blockwise_attention(q, k, v, *, causal: bool = True, window: int = 0, prefix_len: int = 0,
                        block_kv: int = 1024, scale=None) -> torch.Tensor:
    """Online-softmax attention over key blocks of ``block_kv``: q [B, Sq,
    H, hd], k [B, Skv, kv, hd], v [B, Skv, kv, hd_v] -> [B, Sq, H, hd_v] in
    q.dtype. Heads are group-major (q head j reads kv head j // (H // kv)).
    Query i sees key j when j <= i, or j < ``prefix_len`` (a bidirectional
    modality prefix), and, with a ``window``, when i - j < window. The reference's op sequence: q scaled by the
    scale rounded to q.dtype, scores in f32, masked entries at -2e30 under a
    running max clamped at -1e30, p rounded to v.dtype for p . v. On the
    CPU, as the compiled reference: XLA's exp (`xla_math.exp_f32`), and
    q . k and p . v of bf16 operands in XLA's bf16 dot order
    (`xla_math.bf16_dot`)."""
    B, Sq, H, hd = q.shape
    Skv, kv_n = k.shape[1], k.shape[2]
    hd_v = v.shape[-1]
    g = H // kv_n
    assert g * kv_n == H
    scale = scale if scale is not None else 1.0 / np.sqrt(hd)
    bkv = min(block_kv, Skv)
    dev = q.device
    qf = q * torch.tensor(np.float32(scale), dtype=q.dtype, device=dev)
    qg = qf.reshape(B, Sq, kv_n, g, hd).permute(0, 2, 3, 1, 4)                  # [B,n,g,Sq,hd]
    q_pos = torch.arange(Sq, device=dev)
    m = torch.full((B, kv_n, g, Sq), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((B, kv_n, g, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, kv_n, g, Sq, hd_v), dtype=torch.float32, device=dev)
    for j0 in range(0, Skv, bkv):
        kj = k[:, j0:j0 + bkv].permute(0, 2, 1, 3)[:, :, None]                  # [B,n,1,bk,hd]
        vj = v[:, j0:j0 + bkv].permute(0, 2, 1, 3)[:, :, None]                  # [B,n,1,bk,hd_v]
        k_pos = torch.arange(j0, j0 + kj.shape[3], device=dev)
        if pairs_bf16_dot(qg, kj):
            s = bf16_dot(qg[..., None, :], kj[..., None, :, :])
        else:
            s = qg.to(torch.float32) @ kj.to(torch.float32).transpose(-1, -2)  # [B,n,g,Sq,bk]
        valid = torch.ones((Sq, kj.shape[3]), dtype=torch.bool, device=dev)
        if causal:
            vis = k_pos[None, :] <= q_pos[:, None]
            if prefix_len > 0:
                vis = vis | (k_pos[None, :] < prefix_len)
            valid = valid & vis
        if window > 0:
            valid = valid & (q_pos[:, None] - k_pos[None, :] < window)
        s = s + torch.where(valid, 0.0, -2e30).to(torch.float32)
        m_new = torch.clamp_min(torch.maximum(m, s.amax(dim=-1)), -1e30)
        p = exp_f32(s - m_new[..., None])
        corr = exp_f32(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pb = p.to(v.dtype)
        if pairs_bf16_dot(pb, vj):
            pv = bf16_dot(pb[..., None, :], vj.transpose(-1, -2)[..., None, :, :])
        else:
            pv = pb.to(torch.float32) @ vj.to(torch.float32)                    # [B,n,g,Sq,hd_v]
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-20)[..., None]
    return out.reshape(B, H, Sq, hd_v).permute(0, 2, 1, 3).to(q.dtype)


def gqa_attn_train(p, x, cfg, dims, *, policy=None, block_kv=1024, prefix_len=0, window=0,
                   ctx=NO_CTX):
    """GQA over a whole sequence x [B, S, D]. Returns (out [B, S, D], (k, v))
    with k / v [B, S, kv, hd], the contiguous cache the sequence leaves.
    In the training layout (``ctx.col_row``) the rank attends with its
    heads (`train_qkv`; k / v then hold the kv heads it attends with) and
    ``wo`` takes its K rows, the ranks' partial outputs summed
    (`common.apply_row_parallel`)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    if ctx.col_row:
        q, k, v, hm = train_qkv(p, x, cfg, dims, positions, policy, ctx)
    else:
        q, k, v = gqa_qkv(p, x, cfg, dims, positions, policy)
        hm = dims.head_mask(x.device)
    o = blockwise_attention(q, k, v, causal=True, window=window or cfg.sliding_window,
                            prefix_len=prefix_len, block_kv=block_kv)
    o = (o * hm[None, None, :, None].to(o.dtype)).reshape(B, S, -1)
    if ctx.col_row:
        return apply_row_parallel(p["wo"], o, ctx), (k, v)
    return apply_linear(p["wo"], o, policy), (k, v)


def train_qkv(p, x, cfg, dims, positions, policy, ctx):
    """q / k / v of this rank's H / tp q heads in the training layout, and
    their slice of the head mask: x through `ParallelCtx.copy_ranks` into
    the column shards of ``wq`` / ``wk`` / ``wv`` (their biases too). Where
    the model axis divides the kv heads (`parallel.heads_split`) the
    rank's kv / tp heads are the ones its q heads read (group-major);
    otherwise the ranks' k / v columns are gathered whole
    (`ParallelCtx.gather_ranks_grad`, a slice of the summed grads back)
    and each q head of the rank is given its kv head, so k / v hold H / tp
    heads, one per q head."""
    B, S, _ = x.shape
    tp, r, hd = ctx.tp, ctx.rank, dims.hd
    h = dims.H // tp
    x = ctx.copy_ranks(x)
    q, k, v = (apply_linear(p[n], x, policy) for n in ("wq", "wk", "wv"))
    q = q.reshape(B, S, h, hd)
    if heads_split(dims.kv, tp):
        k, v = (t.reshape(B, S, dims.kv // tp, hd) for t in (k, v))
    else:
        idx = torch.div(torch.arange(r * h, (r + 1) * h, device=x.device), dims.gp,
                        rounding_mode="floor")
        k, v = (ctx.gather_ranks_grad(t).reshape(B, S, dims.kv, hd)[:, :, idx] for t in (k, v))
    hm = dims.head_mask(x.device)[r * h:(r + 1) * h]
    return (apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta),
            v, hm)


# ---------------------------------------------------------------------------
# Contiguous caches
# ---------------------------------------------------------------------------
def _owner_rows(pos, count, c: int, S: int, offset: int, device):
    """The rows a shard of S positions from ``offset`` owns of per-slot runs
    pos[b] .. pos[b] + count[b] - 1 (at most ``c`` long): (ok [B, c], the
    local row of each, anchor [B], first [B], the index of the first owned
    entry [B]). ``anchor`` is a row every
    dropped entry can write without changing the result: the first owned
    row where the slot owns one (``first`` True; the run's rows on a shard
    are consecutive, so that row is written once, by its own entry), else
    the clamped start, rewritten with its own value."""
    pos = pos.to(torch.int32)
    j = torch.arange(c, dtype=torch.int32, device=device)[None, :]
    local = pos[:, None] + j - offset                           # [B, c]
    ok = ((pos[:, None] >= 0) & (j < count.to(torch.int32)[:, None])
          & (local >= 0) & (local < S))
    first = ok.any(dim=1)
    j0 = torch.argmax(ok.to(torch.int32), dim=1)                # the first owned entry
    start = torch.gather(local, 1, j0[:, None])[:, 0]
    anchor = torch.where(first, start, torch.clamp(local[:, 0], 0, S - 1)).long()
    return ok, local, anchor, first, j0


def cache_insert_chunk(cache, new, pos, nvalid, ctx=None):
    """Write a ragged chunk ``new`` [B, c, kv, hd] into ``cache`` [B, S, kv,
    hd] in place at per-slot start positions ``pos`` [B]: slot b writes
    positions pos[b] .. pos[b] + nvalid[b] - 1. Rows at index >= nvalid[b],
    rows past S and whole slots with pos < 0 leave the cache bit-unchanged.
    Under a sequence-sharded ``ctx`` the cache holds the rank's positions
    r * S .. (r + 1) * S - 1 and a rank writes only the positions it owns
    (the reference's owner-shard insert). One gather and one scatter, no
    host sync: a dropped row writes, at its slot's anchor row
    (`_owner_rows`), the value that row gets anyway (the slot's first owned
    new row, or the old value when the slot writes nothing), so duplicate
    indices always carry equal values. Returns ``cache``."""
    B, c = new.shape[0], new.shape[1]
    S = cache.shape[1]
    off = S * ctx.seq_rank if ctx is not None else 0
    ok, local, anchor, first, j0 = _owner_rows(pos, nvalid, c, S, off, cache.device)
    b_idx = torch.arange(B, device=cache.device)
    new = new.to(cache.dtype)
    lead = new[b_idx, j0][:, None]                              # the first owned new row
    fill = torch.where(first[:, None, None, None], lead, cache[b_idx, anchor][:, None])
    vals = torch.where(ok[..., None, None], new, fill)
    idx = torch.where(ok, local.long(), anchor[:, None])
    cache[b_idx[:, None], idx] = vals
    return cache


def cache_truncate_chunk(cache, start, count, c_max: int, ctx=None):
    """Zero per-slot positions ``start[b] .. start[b] + count[b] - 1`` of a
    contiguous cache leaf [B, S, ...] in place: the inverse of
    `cache_insert_chunk`, back to the zero-initialized state, so a later
    re-insert equals a straight insert (the speculative step's rollback).
    Slots with count == 0 or start < 0, and rows past S, keep their bytes;
    under a sequence-sharded ``ctx`` a rank zeroes only the positions it
    owns. A dropped row writes at its slot's anchor row (`_owner_rows`): 0
    when that row is zeroed anyway, else the row's own value. ``c_max``
    bounds the per-slot width. Returns ``cache``."""
    B, S = cache.shape[0], cache.shape[1]
    off = S * ctx.seq_rank if ctx is not None else 0
    ok, local, anchor, first, _ = _owner_rows(start, count, c_max, S, off, cache.device)
    b_idx = torch.arange(B, device=cache.device)
    old = cache[b_idx, anchor]                                  # [B, ...]
    fill = torch.where(first.reshape(B, *([1] * (old.dim() - 1))), torch.zeros_like(old), old)
    idx = torch.where(ok, local.long(), anchor[:, None])
    cache[b_idx[:, None], idx] = fill[:, None].expand(B, c_max, *old.shape[1:])
    return cache


def cache_insert(cache, new, pos, ring_window: int = 0, ctx=None):
    """Insert ``new`` [B, 1, kv, hd] at per-slot positions ``pos`` [B] (or
    one scalar position for every slot) into ``cache`` [B, S, kv, hd] in
    place; a negative position (idle slot) writes nothing. A ring cache
    (``ring_window`` = W) takes position p at slot p % W. Under a
    sequence-sharded ``ctx`` only the rank that owns the (ring) slot
    writes. Returns ``cache``."""
    B = cache.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=cache.device).reshape(-1).expand(B)
    if ring_window:
        pos = torch.where(pos >= 0, torch.remainder(pos, ring_window), pos)
    return cache_insert_chunk(cache, new, pos, torch.ones_like(pos), ctx)


def gqa_decode_core(q, k_new, v_new, cache_k, cache_v, pos, *, kv_map, window=0, ring=False,
                    scale=None, impl="ref", ctx=None):
    """Insert + attend. q [B, H, hd]; k/v_new [B, 1, kv, hd]; caches
    [B, S, kv, hd] (written in place; with ``ring`` a ring of the last
    ``window`` positions). Under a sequence-sharded ``ctx`` the caches are
    the rank's shard and q holds every head: the owner inserts and the
    ranks merge their partial softmaxes (`attend_contiguous`)."""
    cache_insert(cache_k, k_new, pos, window if ring else 0, ctx)
    cache_insert(cache_v, v_new, pos, window if ring else 0, ctx)
    o = attend_contiguous(q, cache_k, cache_v, pos + 1, kv_map=kv_map, scale=scale,
                          impl=impl, window=window, ring=ring, ctx=ctx)
    return o, cache_k, cache_v


def gqa_attn_decode(p, x, cache_k, cache_v, pos, cfg, dims, *, policy=None, window=0,
                    ring=False, attn_impl="ref", ctx=NO_CTX):
    """One-token decode over a contiguous cache: x [B, 1, D], pos [B]; a
    query sees the last ``window or cfg.sliding_window`` positions when
    that is set, and ``ring`` caches hold them by position % window.
    Under a tp > 1 ``ctx`` (sequence-sharded) the caches are the rank's
    shard; q / k / v come whole from the N-shards (`rank_qkv`) and ``wo``
    runs on its N-shard (`attn_out`). Returns (out, (cache_k, cache_v))."""
    B = x.shape[0]
    q, k, v, hm = rank_qkv(p, x, cfg, dims, pos[:, None], policy, ctx)
    kvm = kv_index_map(dims.H, dims.H_true, dims.kv)
    o, cache_k, cache_v = gqa_decode_core(q[:, 0], k, v, cache_k, cache_v, pos, kv_map=kvm,
                                          window=window or cfg.sliding_window, ring=ring,
                                          impl=attn_impl, ctx=ctx)
    o = o * hm[None, :, None].to(o.dtype)
    return attn_out(p, o.reshape(B, 1, dims.H * dims.hd), policy, ctx, dims), (cache_k, cache_v)


def gqa_decode_core_chunk(q, k_new, v_new, cache_k, cache_v, pos, nvalid, *, kv_map,
                          scale=None, impl="ref", ctx=None):
    """Chunked insert + attend. q [B, c, H, hd]; k/v_new [B, c, kv, hd]. Keys
    land first, then every query attends with its own length. ``ctx`` as
    in `gqa_decode_core`."""
    cache_insert_chunk(cache_k, k_new, pos, nvalid, ctx)
    cache_insert_chunk(cache_v, v_new, pos, nvalid, ctx)
    lengths = chunk_lengths(pos, nvalid, q.shape[1])
    o = attend_contiguous(q, cache_k, cache_v, lengths, kv_map=kv_map, scale=scale,
                          impl=impl, ctx=ctx)
    return o, cache_k, cache_v


def gqa_attn_decode_chunk(p, x, cache_k, cache_v, pos, nvalid, cfg, dims, *, policy=None,
                          attn_impl="ref", ctx=NO_CTX):
    """Ragged decode over a contiguous cache: x [B, c, D], start positions
    ``pos`` [B], valid counts ``nvalid`` [B]; ``ctx`` as in
    `gqa_attn_decode`. Returns (out [B, c, D], (cache_k, cache_v)); rows
    past a slot's nvalid are exact no-ops."""
    B, c, _ = x.shape
    positions = torch.clamp(pos[:, None] + torch.arange(c, dtype=torch.int32,
                                                        device=x.device), min=0)
    q, k, v, hm = rank_qkv(p, x, cfg, dims, positions, policy, ctx)
    kvm = kv_index_map(dims.H, dims.H_true, dims.kv)
    o, cache_k, cache_v = gqa_decode_core_chunk(q, k, v, cache_k, cache_v, pos, nvalid,
                                                kv_map=kvm, impl=attn_impl, ctx=ctx)
    o = o * hm[None, None, :, None].to(o.dtype)
    return attn_out(p, o.reshape(B, c, dims.H * dims.hd), policy, ctx, dims), (cache_k, cache_v)


# ---------------------------------------------------------------------------
# MLA (absorbed form)
# ---------------------------------------------------------------------------
def init_mla(gen, cfg, dims, *, dtype=torch.float32, device="cpu"):
    D = cfg.d_model
    r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    H = dims.H
    kw = dict(dtype=dtype, device=device)
    return {
        "wq_a": make_linear(gen, D, r_q, **kw),
        "q_a_norm": make_norm(r_q, **kw),
        "wq_b": make_linear(gen, r_q, H * (dn + dr), **kw),
        "wkv_a": make_linear(gen, D, r_kv + dr, **kw),
        "kv_a_norm": make_norm(r_kv, **kw),
        # absorbed decompression factors, stored per head
        "w_uk": make_linear(gen, r_kv, H * dn, **kw),      # key-nope
        "w_uv": make_linear(gen, r_kv, H * dv, **kw),      # value
        "wo": make_linear(gen, H * dv, D, **kw),
    }


def _mla_q_eff(p, x, cfg, dims, positions, policy, ctx=NO_CTX):
    """Absorbed query: q_eff [B, S, H, r_kv + dr]. Under a tp > 1 ``ctx``
    ``wq_a`` is whole on every rank and ``wq_b`` / ``w_uk`` are the rank's
    N-shards (its H / tp heads): the rank absorbs its heads, and the ranks'
    heads are gathered, so q_eff reaches the core whole."""
    B, S, _ = x.shape
    tp = ctx.tp
    H = dims.H // tp
    dn = cfg.qk_nope_dim
    r_kv = cfg.kv_lora_rank
    cq = rms_norm(apply_linear(p["wq_a"], x, policy), p["q_a_norm"], cfg.norm_eps)
    q = apply_linear(p["wq_b"], cq, policy, tp).reshape(B, S, H, -1)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    w_uk = materialize_weight(p["w_uk"], r_kv, q_nope.dtype, policy).reshape(r_kv, H, dn)
    q_c = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)
    q_eff = torch.cat([q_c, q_rope], dim=-1)
    if tp == 1:
        return q_eff
    return ctx.all_gather_last(q_eff.reshape(B, S, -1)).reshape(B, S, dims.H, -1)


def _mla_kv_stream(p, x, cfg, positions, policy):
    """Compressed KV stream [B, S, r_kv + dr] (the decode cache); ``wkv_a``
    is whole on every rank at tp > 1."""
    r_kv = cfg.kv_lora_rank
    ckv = apply_linear(p["wkv_a"], x, policy)
    c, k_rope = ckv[..., :r_kv], ckv[..., r_kv:]
    c = rms_norm(c, p["kv_a_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return torch.cat([c, k_rope], dim=-1)


def _mla_out(p, attn_c, cfg, dims, policy, ctx=NO_CTX):
    """attn_c [B, S, H, r_kv] attention-weighted compressed values. Under a
    tp > 1 ``ctx`` (attn_c whole on every rank) the rank lifts its H / tp
    heads through its N-shard of ``w_uv``, the heads are gathered, and
    ``wo`` runs on its N-shard (`attn_out`)."""
    B, S, H, r_kv = attn_c.shape
    tp = ctx.tp
    dv = cfg.v_head_dim
    hm = dims.head_mask(attn_c.device)
    if tp > 1:
        H //= tp
        attn_c = attn_c[:, :, ctx.rank * H:(ctx.rank + 1) * H]
        hm = hm[ctx.rank * H:(ctx.rank + 1) * H]
    w_uv = materialize_weight(p["w_uv"], r_kv, attn_c.dtype, policy).reshape(r_kv, H, dv)
    o = torch.einsum("bshr,rhd->bshd", attn_c, w_uv)
    o = o * hm[None, None, :, None].to(o.dtype)
    o = ctx.all_gather_last(o.reshape(B, S, H * dv))
    if tp == 1:
        return apply_linear(p["wo"], o, policy)
    return ctx.all_gather_last(apply_linear(p["wo"], o, policy, tp))


def _mla_scale(cfg) -> float:
    return 1.0 / np.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)


def mla_decode_core(q_eff, kv_new, cache_kv, pos, *, r_kv, scale, impl="ref", ctx=None):
    """q_eff [B, H, r_kv+dr]; kv_new [B, 1, 1, r_kv+dr]; cache_kv [B, S, 1,
    r_kv+dr] (written in place). The kernel path reads the values from the
    same stream (``value_slice=r_kv``): V costs no extra read. Under a
    sequence-sharded ``ctx`` the stream is the rank's shard of positions:
    the owner inserts and the ranks merge (`attend_contiguous`)."""
    cache_insert(cache_kv, kv_new, pos, ctx=ctx)
    kvm = np.zeros((q_eff.shape[1],), np.int32)
    o_c = attend_contiguous(q_eff, cache_kv, cache_kv[..., :r_kv], pos + 1, kv_map=kvm,
                            scale=scale, impl=impl, value_slice=r_kv, ctx=ctx)
    return o_c, cache_kv


def mla_attn_decode(p, x, cache_kv, pos, cfg, dims, *, policy=None, attn_impl="ref",
                    ctx=NO_CTX):
    """One-token MLA decode: x [B, 1, D]; cache_kv [B, S, 1, r_kv+dr]; pos
    [B]. Under a tp > 1 ``ctx`` the stream is the rank's sequence shard."""
    positions = pos[:, None]
    q_eff = _mla_q_eff(p, x, cfg, dims, positions, policy, ctx)[:, 0]  # [B, H, r+dr]
    kv = _mla_kv_stream(p, x, cfg, positions, policy)                  # [B, 1, r+dr]
    o_c, cache_kv = mla_decode_core(q_eff, kv[:, :, None, :], cache_kv, pos,
                                    r_kv=cfg.kv_lora_rank, scale=_mla_scale(cfg),
                                    impl=attn_impl, ctx=ctx)
    return _mla_out(p, o_c[:, None], cfg, dims, policy, ctx), cache_kv


def mla_decode_core_chunk(q_eff, kv_new, cache_kv, pos, nvalid, *, r_kv, scale, impl="ref",
                          ctx=None):
    """Chunked absorbed-MLA core. q_eff [B, c, H, r_kv+dr]; kv_new [B, c, 1,
    r_kv+dr]; cache_kv [B, S, 1, r_kv+dr] (written in place); ``ctx`` as
    in `mla_decode_core`."""
    cache_insert_chunk(cache_kv, kv_new, pos, nvalid, ctx)
    kvm = np.zeros((q_eff.shape[2],), np.int32)
    lengths = chunk_lengths(pos, nvalid, q_eff.shape[1])
    o_c = attend_contiguous(q_eff, cache_kv, cache_kv[..., :r_kv], lengths, kv_map=kvm,
                            scale=scale, impl=impl, value_slice=r_kv, ctx=ctx)
    return o_c, cache_kv


def mla_attn_decode_chunk(p, x, cache_kv, pos, nvalid, cfg, dims, *, policy=None,
                          attn_impl="ref", ctx=NO_CTX):
    """Ragged multi-token MLA decode: x [B, c, D]; same contract as
    `gqa_attn_decode_chunk` on the compressed stream."""
    B, c, _ = x.shape
    positions = torch.clamp(pos[:, None] + torch.arange(c, dtype=torch.int32,
                                                        device=x.device), min=0)
    q_eff = _mla_q_eff(p, x, cfg, dims, positions, policy, ctx)         # [B, c, H, r+dr]
    kv = _mla_kv_stream(p, x, cfg, positions, policy)                   # [B, c, r+dr]
    o_c, cache_kv = mla_decode_core_chunk(q_eff, kv[:, :, None, :], cache_kv, pos, nvalid,
                                          r_kv=cfg.kv_lora_rank, scale=_mla_scale(cfg),
                                          impl=attn_impl, ctx=ctx)
    return _mla_out(p, o_c, cfg, dims, policy, ctx), cache_kv


def mla_attn_train(p, x, cfg, dims, *, policy=None, block_kv=1024, prefix_len=0):
    """Absorbed MLA over a whole sequence x [B, S, D]: one kv head of width
    r_kv + dr shared by every head, values its first r_kv columns. Returns
    (out [B, S, D], the compressed stream [B, S, r_kv + dr])."""
    S = x.shape[1]
    r_kv = cfg.kv_lora_rank
    positions = torch.arange(S, device=x.device)[None, :]
    q_eff = _mla_q_eff(p, x, cfg, dims, positions, policy)
    kv = _mla_kv_stream(p, x, cfg, positions, policy)
    o_c = blockwise_attention(q_eff, kv[:, :, None, :], kv[:, :, None, :r_kv], causal=True,
                              prefix_len=prefix_len, block_kv=block_kv, scale=_mla_scale(cfg))
    return _mla_out(p, o_c, cfg, dims, policy), kv
