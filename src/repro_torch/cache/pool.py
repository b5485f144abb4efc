"""Device page pools: layout, insert, page gather (port of src/repro/cache/pool.py).

One attention layer's decode cache is a pool of fixed-size pages:

    bf16 pool : k/v each [P, page, kv, hd]                 bf16
    AMS pool  : k/v each {hi    [P, page, kv, hd_p/2]  int8   (2 codes/byte)
                          lsb   [P, page, kv, gw]      int32  (1 bit/k-group)
                          scale [P, page, kv, 1]       f32}

i.e. the AMS layout is `repro_torch.core.kv_quant`'s packed planes with a
(page, slot-in-page, head) prefix.

A request's logical position i lives at ``page = block_table[slot, i //
page_size], offset = i % page_size``. Inserts take a [B, c] token block;
suppressed writes (idle slot pos < 0, or chunk entries past a slot's valid
count) are dropped without a host sync. Each token is quantized once at
insert.

Unlike the reference's functional scatter, `paged_insert` writes into the
pool tensors in place (the engine's pools hold every layer of a
full-width model, and a copy per insert would double their footprint).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.formats import get_scheme
from repro_torch.core.kv_quant import dequantize_kv, kv_bytes, packed_head_dim, quantize_kv
from repro_torch.core.tree import tree_leaves, tree_map

from .config import CacheConfig

PLANES = ("hi", "lsb", "scale")


def make_gqa_page_pool(ccfg: CacheConfig, kv: int, hd: int, *, device="cpu",
                       lead: Tuple[int, ...] = ()) -> Dict:
    """Zero-initialized k/v page pools for one GQA layer (or, with
    ``lead=(G,)``, for G stacked layers)."""
    P, page = ccfg.num_pages, ccfg.page_size
    if not ccfg.quantized:
        shape = (*lead, P, page, kv, hd)
        return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
                "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}
    scheme = get_scheme(ccfg.kv_scheme)
    hd_p = packed_head_dim(hd, scheme)
    gw = -(-(hd_p // scheme.k) // 32)

    def planes():
        shape = (*lead, P, page, kv)
        return {"hi": torch.zeros((*shape, hd_p // 2), dtype=torch.int8, device=device),
                "lsb": torch.zeros((*shape, gw), dtype=torch.int32, device=device),
                "scale": torch.zeros((*shape, 1), dtype=torch.float32, device=device)}

    return {"k": planes(), "v": planes()}


def _destinations(pos, nvalid, block_table, ccfg: CacheConfig, c: int):
    """Flat pool rows ``page * page_size + offset`` [B*c] of a chunk starting
    at ``pos`` per slot, and the [B*c] mask of writes that happen (not idle,
    index < nvalid)."""
    j = torch.arange(c, dtype=torch.int32, device=pos.device)[None, :]
    p = pos[:, None] + j
    ok = (pos[:, None] >= 0) & (j < nvalid[:, None])
    logical = torch.clamp(torch.div(p, ccfg.page_size, rounding_mode="floor"),
                          0, block_table.shape[1] - 1)
    page = torch.take_along_dim(block_table, logical.long(), dim=1)
    off = torch.clamp(torch.remainder(p, ccfg.page_size), 0, ccfg.page_size - 1)
    return (page.long() * ccfg.page_size + off.long()).reshape(-1), ok.reshape(-1)


def _scatter_rows(leaf: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor,
                  ok: torch.Tensor, first: torch.Tensor, any_ok: torch.Tensor) -> None:
    """leaf [P, page, *] in place: row ``rows[i]`` of its [P*page, *] view
    gets ``vals[i]`` where ``ok[i]``. Every dropped entry writes the tick's
    anchor row instead: the first live write's row and value, or, in a tick
    with none, row 0 with its own value. So duplicate indices always carry
    equal values and the scatter needs no host sync. A per-slot anchor
    would not do: an idle slot's stale block-table row can name a page that
    an active slot writes this tick."""
    flat = leaf.view(-1, *leaf.shape[2:])
    vals = vals.to(leaf.dtype)
    anchor = torch.where(any_ok, rows[first], 0)
    anchor_val = torch.where(any_ok, vals[first], flat[anchor])
    mask = ok.reshape(-1, *([1] * (vals.dim() - 1)))
    flat[torch.where(ok, rows, anchor)] = torch.where(mask, vals, anchor_val)


def paged_insert(pool: Dict, k_new: torch.Tensor, v_new: torch.Tensor, pos, block_table,
                 ccfg: CacheConfig, nvalid=None) -> Dict:
    """Write this tick's K/V block ([B, c, kv, hd]) into the layer pool in
    place and return it. ``pos`` [B] start positions (negative = idle slot,
    nothing written); ``nvalid`` [B] bounds each slot's valid chunk entries
    (default: all c of non-idle slots). Dropped writes leave the pool
    bit-unchanged; nothing here waits on the device (`_scatter_rows`)."""
    B, c = k_new.shape[:2]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=k_new.device)
    if nvalid is None:
        nvalid = torch.where(pos >= 0, c, 0)
    nvalid = torch.as_tensor(nvalid, dtype=torch.int32, device=k_new.device)
    rows, ok = _destinations(pos, nvalid, block_table, ccfg, c)
    first = torch.argmax(ok.to(torch.int32)).reshape(1)     # the first live write, or 0
    any_ok = ok.any()
    for name, new in (("k", k_new), ("v", v_new)):
        if not ccfg.quantized:
            _scatter_rows(pool[name], rows, new.reshape(B * c, *new.shape[2:]), ok, first,
                          any_ok)
            continue
        q = quantize_kv(new, get_scheme(ccfg.kv_scheme), ccfg.kv_strategy)  # [B, c, kv, *]
        for pl in PLANES:
            _scatter_rows(pool[name][pl], rows, q[pl].reshape(B * c, *q[pl].shape[2:]), ok,
                          first, any_ok)
    return pool


def paged_truncate(pool: Dict, start, count, block_table, ccfg: CacheConfig, c_max: int) -> Dict:
    """Un-insert ``count`` positions from ``start`` per slot, in place: the
    addressed (page, offset) rows of every plane go back to the pool's
    initial zeros, so a later re-insert there equals a straight insert (the
    speculative step's rollback of rejected drafts). Slots with count == 0
    or start < 0 write nothing. Leaves may carry leading dims (stacked
    layers): the page axis is ``ndim - 4``. Sync-free like `paged_insert`,
    but every live entry writes 0, so a dropped entry writes 0 at the first
    live entry's row (a row that is zeroed anyway) or, in a call with no
    live entry, row 0's own value back: duplicate indices carry equal
    values, and no other byte moves. ``c_max`` bounds the per-slot width."""
    start = start.to(torch.int32)
    rows, ok = _destinations(start, count.to(torch.int32), block_table, ccfg, c_max)
    any_ok = ok.any()
    anchor = torch.where(any_ok, rows[torch.argmax(ok.to(torch.int32)).reshape(1)], 0)
    idx = torch.where(ok, rows, anchor)
    for leaf in tree_leaves(pool):
        ax = leaf.dim() - 4
        flat = leaf.view(*leaf.shape[:ax], -1, *leaf.shape[ax + 2:])
        old = flat.index_select(ax, anchor)
        vals = torch.where(any_ok, torch.zeros_like(old), old)
        shape = list(flat.shape)
        shape[ax] = idx.shape[0]
        flat.index_copy_(ax, idx, vals.expand(shape))
    return pool


# -------------------------------------------------------------- host spill
# Every pool plane is [..., P, page, kv, last]: 4 trailing dims, after the
# layer dim `models.make_cache` stacks in front. The page axis is therefore
# ``ndim - 4`` in every leaf of an engine cache.

def extract_pages(cache, page_ids):
    """Copy the addressed pool pages of every plane to host memory in the
    pool's storage layout: AMS pages stay packed (hi / lsb / scale), so a
    later `restore_pages` is byte-exact. Returns a tree of CPU tensors
    mirroring ``cache`` with the page axis narrowed to ``len(page_ids)``.
    Runs between engine ticks (it waits for the copy), never in the step."""
    def take(leaf):
        ids = torch.as_tensor(page_ids, dtype=torch.long, device=leaf.device)
        return leaf.index_select(leaf.dim() - 4, ids).cpu()
    return tree_map(take, cache)


def restore_pages(cache, page_ids, host) -> None:
    """Write an `extract_pages` snapshot into the pool at (possibly other)
    ``page_ids``, in place: every plane keeps its storage, so the CUDA
    graphs that hold pointers to the pool see the restored bytes."""
    def put(leaf, val):
        ids = torch.as_tensor(page_ids, dtype=torch.long, device=leaf.device)
        leaf.index_copy_(leaf.dim() - 4, ids, val.to(leaf.device))
    tree_map(put, cache, host)


def host_bytes(host) -> int:
    """Host bytes a spilled-page tree occupies (accounting)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(host))


def gather_pages(leaf: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """[P, page, ...] pool leaf -> [B, max_pages*page, ...] per-slot view."""
    B, mp = block_table.shape
    g = leaf[block_table.reshape(-1).long()]
    return g.reshape(B, mp * leaf.shape[1], *leaf.shape[2:])


def gather_kv(pool: Dict, block_table, hd: int, ccfg: CacheConfig, dtype=torch.bfloat16):
    """(k, v) [B, S_max, kv, hd] views of a layer pool in ``dtype``; AMS
    planes are restored to their exact lattice values."""
    if not ccfg.quantized:
        return (gather_pages(pool["k"], block_table).to(dtype),
                gather_pages(pool["v"], block_table).to(dtype))
    scheme = get_scheme(ccfg.kv_scheme)
    k_pl, v_pl = ({pl: gather_pages(pool[n][pl], block_table) for pl in PLANES}
                  for n in ("k", "v"))
    return dequantize_kv(k_pl, hd, scheme, dtype), dequantize_kv(v_pl, hd, scheme, dtype)


def pool_bytes_per_token(kv: int, hd: int, ccfg: CacheConfig) -> int:
    """Cache bytes one token occupies in one layer (k + v)."""
    if ccfg.quantized:
        packed, _ = kv_bytes(hd, get_scheme(ccfg.kv_scheme))
        return 2 * kv * packed
    return 2 * kv * hd * 2


def compression_vs_bf16(kv: int, hd: int, ccfg: CacheConfig) -> float:
    """bf16 bytes / this cache-mode bytes, per token per layer."""
    return (2 * kv * hd * 2) / pool_bytes_per_token(kv, hd, ccfg)
