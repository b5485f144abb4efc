"""Decode attention: plain flash-decode bodies, the paged kernels K2, K3 and
K5p and the contiguous-cache kernels K4 and K5 (port of
src/repro/kernels/attention_template.py).

  * `flash_decode` / `flash_decode_chunk` — the plain torch reference bodies
    over a [B, S, kv, hd] cache (group-major heads): the ``ref`` lowering of
    contiguous caches and the oracle the paged ``ref`` path attends with.
  * `fused_paged_attention` — paged flash-decode over a page pool: folds q
    chunk-major per kv head (`_fold_q`), runs K2 (`paged_attention_ams`,
    packed AMS pages of e2m2 or e2m1 codes) or K3 (`paged_attention_bf16`,
    bf16 pages), or with ``value_slice`` K5p (`paged_attention_stream_bf16`
    / `paged_attention_stream_ams`: one absorbed-MLA stream pool whose
    values are the first ``value_slice`` columns of the keys), and unfolds
    the result (`_unfold_o`).
  * `fused_contiguous_attention` — the same template over a contiguous
    [B, S, kv, hd] cache: K4 (`contiguous_attention`, separate K and V, the
    GQA cache) or K5 (`contiguous_attention_mla`, one absorbed-MLA stream
    whose values are the first ``hd_v`` columns of the keys), walking the
    keys in the reference's ``block_kv`` blocks (`tuning.reference_block_kv`).
  * `attend_contiguous` — the dispatch the model cores call (``ref`` or
    ``kernel``; a cache sequence-sharded at tp > 1 always takes the plain
    bodies with the cross-rank merge, as the reference routes it).

The wrappers launch the CUDA kernels in ``csrc/`` on CUDA tensors (bound and
design noted there) and run their plain torch versions on CPU tensors. As in
the TPU template, all the kernels share one online-softmax walk
(`_online_softmax`) and differ only in how a block of K and V is loaded,
and in the type p is rounded to before the PV product (f32 lattice values
for AMS pages, the cache's bf16 otherwise).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.formats import code_to_value, get_scheme
from repro_torch.core.kv_quant import codes_from_planes
from repro_torch.core.rtn import device_table
from repro_torch.core.xla_math import bf16_dot, pairs_bf16_dot

from .build import KernelCount, check_device, library, stream_ptr
from .tuning import (
    plan_contiguous_attention,
    plan_mla_attention,
    plan_paged_attention,
    plan_paged_bf16_attention,
    plan_paged_mla_attention,
    reference_block_kv,
)

NEG_BIG = -2e30   # additive mask; exp(NEG_BIG - NEG_CLAMP) == 0 exactly
NEG_CLAMP = -1e30
COUNT = KernelCount("paged_attention_ams")
COUNT_BF16 = KernelCount("paged_attention_bf16")
COUNT_STREAM_BF16 = KernelCount("paged_attention_stream_bf16")
COUNT_STREAM_AMS = KernelCount("paged_attention_stream_ams")
COUNT_CONTIG = KernelCount("contiguous_attention")
COUNT_MLA = KernelCount("contiguous_attention_mla")


def _check_grouped(H: int, kv_n: int, kv_map) -> int:
    if H % kv_n != 0 or not np.array_equal(np.asarray(kv_map), np.arange(H) // (H // kv_n)):
        raise NotImplementedError("only the group-major GQA head layout is ported")
    return H // kv_n


def _scores(qf, k):
    """q . k in f32: qf [B, c, kv, g, hd], k [B, S, kv, hd] -> [B, c, kv,
    g, S]; bf16 operands on the CPU sum in XLA's bf16 dot order."""
    if pairs_bf16_dot(qf, k):
        return bf16_dot(qf[..., None, :], k.permute(0, 2, 1, 3)[:, None, :, None])
    return torch.einsum("bcngd,bknd->bcngk", qf.to(torch.float32), k.to(torch.float32))


def _attend(qf, k, v, valid, g, ctx=None):
    """Shared softmax body: qf [B, c, kv, g, hd] (already scaled), k/v
    [B, S, kv, hd], valid [B, c, S] -> o [B, c, kv*g, hd_v] f32. The
    products q . k and bf16(p) . v of bf16 operands on the CPU sum in XLA's
    bf16 dot order (`xla_math.bf16_dot`). Under a sequence-sharded ``ctx``
    (`models.parallel.ParallelCtx`, ``seq_shard``) k / v are this rank's
    shard of the keys: the row max is the ranks' max (`max_ranks`), and
    ``l`` and ``o`` the ranks' sums in rank order (`sum_ranks`, one
    exchange of both), the reference's pmax / psum merge."""
    B, c, kv_n = qf.shape[:3]
    merge = ctx is not None and ctx.seq_shard and ctx.tp > 1
    s = _scores(qf, k)
    vmask = valid[:, :, None, None, :]
    s = torch.where(vmask, s, -torch.inf)
    m = s.amax(dim=-1)
    if merge:
        m = ctx.max_ranks(m)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(vmask, p, torch.zeros_like(p))
    l = p.sum(dim=-1)
    pb = p.to(v.dtype)
    if pairs_bf16_dot(pb, v):
        o = bf16_dot(pb[..., None, :], v.permute(0, 2, 3, 1)[:, None, :, None])
    else:
        o = torch.einsum("bcngk,bknd->bcngd", pb.to(torch.float32), v.to(torch.float32))
    if merge:
        lo = ctx.sum_ranks(torch.cat([o, l[..., None]], dim=-1))
        o, l = lo[..., :-1], lo[..., -1]
    o = o / torch.clamp(l, min=1e-20)[..., None]
    return o.reshape(B, c, kv_n * g, v.shape[-1])


def _scale_factor(q: torch.Tensor, scale: Optional[float]) -> torch.Tensor:
    """The softmax scale (default 1/sqrt(hd)) as a scalar in q.dtype, made
    once per (scale, dtype, device): a tensor made from host data per call
    would be a copy from pageable memory inside the step."""
    scale = scale if scale is not None else 1.0 / np.sqrt(q.shape[-1])
    return device_table((float(np.float32(scale)),), q.dtype, str(q.device)).reshape(())


def _scaled(q: torch.Tensor, scale: Optional[float]) -> torch.Tensor:
    return q * _scale_factor(q, scale)


def _cache_positions(S: int, pos: torch.Tensor, ring_window: int,
                     offset: int = 0) -> torch.Tensor:
    """Key position held by each cache slot: slot j holds ``offset`` + j
    (``offset``: the first position of a rank's sequence shard), or in a
    ring of width W the largest p <= ``pos`` with p % W == offset + j (older
    entries were overwritten; negative where the slot holds nothing yet).
    ``pos`` [B, 1] -> [B, S]."""
    g = offset + torch.arange(S, dtype=torch.int32, device=pos.device)[None, :]
    if ring_window:
        return pos - torch.remainder(pos - g, ring_window)
    return g.expand(pos.shape[0], S)


def flash_decode(q, k_cache, v_cache, pos, *, kv_map, scale=None, window: int = 0,
                 ring: bool = False, ctx=None):
    """q [B, H, hd]; caches [B, S, kv, hd]; ``pos`` valid keys per slot
    ([B]) or shared (scalar). A query sees the keys at positions below
    ``pos``, with a ``window`` only the last ``window`` of them; a ``ring``
    cache holds position p at slot p % window. The index math is tensor
    ops on the device (no host sync). Under a sequence-sharded ``ctx``
    the caches are rank r's S positions from r * S (of a ring: its slots
    from r * S), masked by their global positions, and the ranks merge
    (`_attend`). Returns [B, H, hd_v] in q.dtype."""
    B, H, hd = q.shape
    S, kv_n = k_cache.shape[1], k_cache.shape[2]
    g = _check_grouped(H, kv_n, kv_map)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    lens = pos.reshape(-1, 1).expand(B, 1)
    off = S * ctx.seq_rank if ctx is not None else 0
    k_pos = _cache_positions(S, lens - 1, window if ring else 0, off)   # [B, S]
    valid = (k_pos >= 0) & (k_pos < lens)          # ring slots may map to pre-history
    if window > 0:
        valid = valid & (lens - 1 - k_pos < window)
    valid = valid[:, None, :]
    qf = _scaled(q, scale).reshape(B, 1, kv_n, g, hd)
    return _attend(qf, k_cache, v_cache, valid, g, ctx)[:, 0].to(q.dtype)


def flash_decode_chunk(q, k_cache, v_cache, lengths, *, kv_map, scale=None, ctx=None):
    """q [B, c, H, hd] ragged query block; ``lengths`` [B, c] valid keys per
    query (0 = masked row -> exact zeros); ``ctx`` as in `flash_decode`.
    Returns [B, c, H, hd_v]."""
    B, c, H, hd = q.shape
    S, kv_n = k_cache.shape[1], k_cache.shape[2]
    g = _check_grouped(H, kv_n, kv_map)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=q.device)
    off = S * ctx.seq_rank if ctx is not None else 0
    k_pos = off + torch.arange(S, device=q.device)
    valid = k_pos[None, None, :] < lengths[:, :, None]
    qf = _scaled(q, scale).reshape(B, c, kv_n, g, hd)
    return _attend(qf, k_cache, v_cache, valid, g, ctx).to(q.dtype)


# ---------------------------------------------------------------------------
# K2: paged AMS attention
# ---------------------------------------------------------------------------
def restore_page(hi, lsb, scale, fmt, k: int, hd: int) -> torch.Tensor:
    """Packed planes [..., hd_p/2] / [..., gw] / [..., 1] -> [..., hd] f32
    lattice values times scale."""
    vals = code_to_value(fmt, codes_from_planes(hi, lsb, k)) * scale
    return vals[..., :hd]


def _online_softmax(qf, load, lens, *, block: int, nblocks: int, hd_v: int, c: int, g: int,
                    pv_dtype) -> torch.Tensor:
    """The kernels' shared walk in plain torch (TPU `online_softmax_step`).
    qf [B, kv, R=c*g, hd] f32 (pre-scaled, chunk-major rows), ``load(i)`` ->
    (k [B, block, kv, hd], v [B, block, kv, hd_v]) f32 for key block i (a
    page, or ``block`` rows of a contiguous cache), lens [B*c] int32 ->
    [B, kv, R, hd_v] f32. Online softmax block by block with the kernels'
    constants; p is rounded to ``pv_dtype`` before the PV product (l sums it
    unrounded). Blocks past every row's length contribute exact zeros, so
    the walk stops there."""
    B, kv_n, R, hd = qf.shape
    row_len = lens.reshape(B, c).repeat_interleave(g, dim=1)[:, None, :, None]  # [B,1,R,1]
    m = torch.full((B, kv_n, R, 1), NEG_CLAMP, dtype=torch.float32, device=qf.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, kv_n, R, hd_v), dtype=torch.float32, device=qf.device)
    max_len = int(lens.max()) if lens.numel() else 0
    for i in range(min(nblocks, -(-max(max_len, 0) // block))):
        kb, vb = load(i)
        s = torch.einsum("bhrd,bthd->bhrt", qf, kb)
        k_pos = i * block + torch.arange(block, device=qf.device)
        s = s + torch.where(k_pos < row_len, 0.0, NEG_BIG)
        m_new = torch.clamp(torch.maximum(m, s.amax(dim=-1, keepdim=True)), min=NEG_CLAMP)
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhrt,bthd->bhrd", p.to(pv_dtype).to(torch.float32),
                                        vb)
        m = m_new
    return acc / torch.clamp(l, min=1e-20)


def _paged_online_softmax(qf, load, lens, block_table, *, page_size: int, c: int, g: int,
                          pv_dtype, hd_v: Optional[int] = None) -> torch.Tensor:
    """`_online_softmax` page by page: ``load(pg)`` -> (k [B, page, kv, hd],
    v [B, page, kv, hd_v]) f32 for the page ids ``pg`` [B] of block_table
    [B, MP]; ``hd_v`` defaults to hd."""
    return _online_softmax(qf, lambda i: load(block_table[:, i].long()), lens,
                           block=page_size, nblocks=block_table.shape[1],
                           hd_v=qf.shape[-1] if hd_v is None else hd_v, c=c, g=g,
                           pv_dtype=pv_dtype)


def paged_attention_ams_plain(qf, pool: Dict, lens, block_table, *, page_size: int,
                              scheme, c: int, g: int) -> torch.Tensor:
    """Plain torch version of K2. qf [B, kv, R=c*g, hd] f32 (pre-scaled,
    chunk-major rows), ``pool`` {k, v: {hi, lsb, scale}} [P, page, kv, *],
    lens [B*c] int32, block_table [B, MP] int32 -> [B, kv, R, hd] f32."""
    if qf.is_cuda:
        COUNT.plain_on_cuda += 1
    hd = qf.shape[-1]
    fmt, k = scheme.base, scheme.k

    def load(pg):
        return tuple(restore_page(pool[n]["hi"][pg], pool[n]["lsb"][pg],
                                  pool[n]["scale"][pg], fmt, k, hd) for n in ("k", "v"))

    return _paged_online_softmax(qf, load, lens, block_table, page_size=page_size, c=c,
                                 g=g, pv_dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _kernel_paged(name: str, n_ptr: int, n_int: int):
    fn = getattr(library("paged_attention"), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_paged(name: str, count: KernelCount, ptrs, ints, device) -> None:
    """Call one C entry point of csrc/paged_attention.cu; raise unless the
    launch succeeded, and count it when it did."""
    rc = _kernel_paged(name, len(ptrs), len(ints))(*ptrs, *ints, stream_ptr(device))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    count.launches += 1


def _check_rows(qf, lens, block_table, c, g):
    B, kv_n, R, hd = qf.shape
    if qf.dtype != torch.float32:
        raise TypeError(f"q must be float32, got {qf.dtype}")
    if R != c * g or lens.shape != (B * c,) or lens.dtype != torch.int32:
        raise ValueError(f"rows {R} != c*g = {c}*{g}, or lengths {tuple(lens.shape)} "
                         f"{lens.dtype} is not [B*c] int32")
    if block_table.dim() != 2 or block_table.shape[0] != B or block_table.dtype != torch.int32:
        raise ValueError(f"block_table must be [B={B}, MP] int32, got "
                         f"{tuple(block_table.shape)} {block_table.dtype}")


def _check_planes(pool, names, kv_n, hd, page_size, scheme):
    """The AMS planes of ``pool[name]`` match q's kv heads and width and the
    page size; the scheme's codes fit the nibble plane (4 hi bits + the
    shared LSB: e2m2 and e2m1, the bases the kernels decode)."""
    for name in names:
        pl = pool[name]
        P, page, kvp, hb = pl["hi"].shape
        if (page != page_size or kvp != kv_n or pl["hi"].dtype != torch.int8
                or pl["lsb"].dtype != torch.int32 or pl["scale"].dtype != torch.float32
                or pl["lsb"].shape[:3] != (P, page, kv_n)
                or pl["scale"].shape != (P, page, kv_n, 1) or 2 * hb < hd):
            raise ValueError(f"pool plane {name!r} does not match q / page size")
    if scheme.base.total_bits > 5:
        raise NotImplementedError(f"AMS pages hold codes of at most 5 bits, got "
                                  f"{scheme.base.name}")


def _check_k2(qf, pool, lens, block_table, page_size, scheme, c, g):
    _check_rows(qf, lens, block_table, c, g)
    _check_planes(pool, ("k", "v"), qf.shape[1], qf.shape[3], page_size, scheme)


def _check_operands(name, qf, ops):
    if not all(t.is_contiguous() and t.device == qf.device for t in ops):
        raise ValueError(f"{name} operands must be contiguous and on one device")


def _check_aligned(name, hd, pages):
    if hd % 8 == 0 and any(t.data_ptr() % 16 for t in pages):
        raise ValueError(f"{name} reads bf16 pages with 16-byte loads: pools must be 16-byte "
                         f"aligned")


def paged_attention_ams(qf, pool: Dict, lens, block_table, *, page_size: int,
                        scheme, c: int, g: int) -> torch.Tensor:
    """K2 wrapper (same contract as `paged_attention_ams_plain`). CPU tensors
    take the plain version; CUDA tensors launch the kernel (row tile and
    cluster from `tuning.plan_paged_attention`) or raise."""
    _check_k2(qf, pool, lens, block_table, page_size, scheme, c, g)
    if qf.device.type == "cpu":
        return paged_attention_ams_plain(qf, pool, lens, block_table, page_size=page_size,
                                         scheme=scheme, c=c, g=g)
    check_device(qf)
    B, kv_n, R, hd = qf.shape
    if hd > 128:
        raise NotImplementedError(f"K2 takes hd <= 128, got {hd}")
    planes = [pool[n][p] for n in ("k", "v") for p in ("hi", "lsb", "scale")]
    ops = [qf, *planes, block_table, lens]
    _check_operands("K2", qf, ops)
    out = torch.empty_like(qf)
    hb, gw = pool["k"]["hi"].shape[-1], pool["k"]["lsb"].shape[-1]
    MP = block_table.shape[1]
    plan = plan_paged_attention(max(B, 1), kv_n, max(R, 1), max(MP * page_size, 1))
    _launch_paged("paged_attention_ams", COUNT, [t.data_ptr() for t in ops + [out]],
                  [B, kv_n, R, hd, hb, gw, scheme.k, scheme.base.man_bits, page_size, MP, c,
                   g, plan.rows, plan.cluster], qf.device)
    return out


# ---------------------------------------------------------------------------
# K3: paged attention over bf16 pages
# ---------------------------------------------------------------------------
def paged_attention_bf16_plain(qf, pool: Dict, lens, block_table, *, page_size: int,
                               c: int, g: int) -> torch.Tensor:
    """Plain torch version of K3: K2's contract over a bf16 pool {k, v}
    [P, page, kv, hd]. Pages widen exactly to f32; p is rounded to bf16 at
    the running max before the PV product (TPU `_load_pair` with
    ``pv_dtype`` = the pool dtype)."""
    if qf.is_cuda:
        COUNT_BF16.plain_on_cuda += 1

    def load(pg):
        return pool["k"][pg].to(torch.float32), pool["v"][pg].to(torch.float32)

    return _paged_online_softmax(qf, load, lens, block_table, page_size=page_size, c=c,
                                 g=g, pv_dtype=pool["v"].dtype)


def _check_bf16_pages(pool, names, kv_n, hd, page_size):
    for name in names:
        t = pool[name]
        if t.dim() != 4 or t.shape[1:] != (page_size, kv_n, hd) or t.dtype != torch.bfloat16:
            raise ValueError(f"pool {name!r} must be bf16 [P, {page_size}, {kv_n}, {hd}], got "
                             f"{t.dtype} {tuple(t.shape)}")


def _check_k3(qf, pool, lens, block_table, page_size, c, g):
    _check_rows(qf, lens, block_table, c, g)
    _check_bf16_pages(pool, ("k", "v"), qf.shape[1], qf.shape[3], page_size)
    if pool["k"].shape != pool["v"].shape:
        raise ValueError("pool k and v differ in shape")


def paged_attention_bf16(qf, pool: Dict, lens, block_table, *, page_size: int,
                         c: int, g: int) -> torch.Tensor:
    """K3 wrapper (same contract as `paged_attention_bf16_plain`). CPU
    tensors take the plain version; CUDA tensors launch the kernel (cluster
    and score buffer from `tuning.plan_paged_bf16_attention`) or raise."""
    _check_k3(qf, pool, lens, block_table, page_size, c, g)
    if qf.device.type == "cpu":
        return paged_attention_bf16_plain(qf, pool, lens, block_table, page_size=page_size,
                                          c=c, g=g)
    check_device(qf)
    B, kv_n, R, hd = qf.shape
    if hd > 128:
        raise NotImplementedError(f"K3 takes hd <= 128, got {hd}")
    ops = [qf, pool["k"], pool["v"], block_table, lens]
    _check_operands("K3", qf, ops)
    _check_aligned("K3", hd, (pool["k"], pool["v"]))
    out = torch.empty_like(qf)
    MP = block_table.shape[1]
    plan = plan_paged_bf16_attention(max(B, 1), kv_n, max(R, 1), max(MP * page_size, 1),
                                     page_size)
    _launch_paged("paged_attention_bf16", COUNT_BF16, [t.data_ptr() for t in ops + [out]],
                  [B, kv_n, R, hd, page_size, MP, c, g, plan.cluster, plan.score_keys],
                  qf.device)
    return out


# ---------------------------------------------------------------------------
# K5p: the paged absorbed-MLA stream (values = the first hd_v key columns)
# ---------------------------------------------------------------------------
def paged_attention_stream_bf16_plain(qf, pool: Dict, lens, block_table, *, page_size: int,
                                      c: int, g: int, hd_v: int) -> torch.Tensor:
    """Plain torch version of K5p on bf16 pages: K3's walk over one stream
    ``pool["k"]`` [P, page, kv, hd] bf16, loaded once per page, whose values
    are its first ``hd_v`` columns; p is rounded to the pool's bf16 at the
    running max (TPU `_make_load_stream`, ``pv_dtype`` = the pool dtype) ->
    [B, kv, R, hd_v] f32. ``pool["v"]`` is never read."""
    if qf.is_cuda:
        COUNT_STREAM_BF16.plain_on_cuda += 1

    def load(pg):
        k = pool["k"][pg].to(torch.float32)
        return k, k[..., :hd_v]

    return _paged_online_softmax(qf, load, lens, block_table, page_size=page_size, c=c,
                                 g=g, pv_dtype=pool["k"].dtype, hd_v=hd_v)


def paged_attention_stream_ams_plain(qf, pool: Dict, lens, block_table, *, page_size: int,
                                     scheme, c: int, g: int, hd_v: int) -> torch.Tensor:
    """Plain torch version of K5p on AMS pages: only the K planes
    ``pool["k"]`` {hi, lsb, scale} are restored, and the first ``hd_v``
    restored columns are the values; p stays f32 (TPU `_make_load_ams` with
    ``hd_v``) -> [B, kv, R, hd_v] f32."""
    if qf.is_cuda:
        COUNT_STREAM_AMS.plain_on_cuda += 1
    hd = qf.shape[-1]
    pl = pool["k"]

    def load(pg):
        k = restore_page(pl["hi"][pg], pl["lsb"][pg], pl["scale"][pg], scheme.base, scheme.k,
                         hd)
        return k, k[..., :hd_v]

    return _paged_online_softmax(qf, load, lens, block_table, page_size=page_size, c=c,
                                 g=g, pv_dtype=torch.float32, hd_v=hd_v)


def _check_stream(qf, lens, block_table, c, g, hd_v):
    _check_rows(qf, lens, block_table, c, g)
    hd = qf.shape[-1]
    if not 1 <= hd_v <= hd:
        raise ValueError(f"need 1 <= value_slice={hd_v} <= hd={hd}")


def _check_stream_widths(hd, hd_v):
    """The widths K5p's one instantiation takes: MiniCPM3-4B's 256 + 32."""
    if hd > 288 or hd_v > 256:
        raise NotImplementedError(f"K5p takes hd <= 288 and value_slice <= 256, got {hd}, "
                                  f"{hd_v}")


def paged_attention_stream_bf16(qf, pool: Dict, lens, block_table, *, page_size: int,
                                c: int, g: int, hd_v: int) -> torch.Tensor:
    """K5p wrapper on bf16 pages (same contract as
    `paged_attention_stream_bf16_plain`). CPU tensors take the plain
    version; CUDA tensors launch the kernel (cluster from
    `tuning.plan_paged_mla_attention`) or raise."""
    B, kv_n, R, hd = qf.shape
    _check_bf16_pages(pool, ("k",), kv_n, hd, page_size)
    _check_stream(qf, lens, block_table, c, g, hd_v)
    if qf.device.type == "cpu":
        return paged_attention_stream_bf16_plain(qf, pool, lens, block_table,
                                                 page_size=page_size, c=c, g=g, hd_v=hd_v)
    check_device(qf)
    _check_stream_widths(hd, hd_v)
    ops = [qf, pool["k"], block_table, lens]
    _check_operands("K5p", qf, ops)
    _check_aligned("K5p", hd, (pool["k"],))
    out = torch.empty((B, kv_n, R, hd_v), dtype=torch.float32, device=qf.device)
    MP = block_table.shape[1]
    plan = plan_paged_mla_attention(max(B, 1), kv_n, max(R, 1), max(MP * page_size, 1))
    _launch_paged("paged_attention_stream_bf16", COUNT_STREAM_BF16,
                  [x.data_ptr() for x in ops + [out]],
                  [B, kv_n, R, hd, hd_v, page_size, MP, c, g, plan.cluster], qf.device)
    return out


def paged_attention_stream_ams(qf, pool: Dict, lens, block_table, *, page_size: int,
                               scheme, c: int, g: int, hd_v: int) -> torch.Tensor:
    """K5p wrapper on AMS pages (same contract as
    `paged_attention_stream_ams_plain`). CPU tensors take the plain
    version; CUDA tensors launch the kernel (cluster from
    `tuning.plan_paged_mla_attention`) or raise."""
    B, kv_n, R, hd = qf.shape
    _check_planes(pool, ("k",), kv_n, hd, page_size, scheme)
    _check_stream(qf, lens, block_table, c, g, hd_v)
    if qf.device.type == "cpu":
        return paged_attention_stream_ams_plain(qf, pool, lens, block_table,
                                                page_size=page_size, scheme=scheme, c=c, g=g,
                                                hd_v=hd_v)
    check_device(qf)
    _check_stream_widths(hd, hd_v)
    pl = pool["k"]
    ops = [qf, pl["hi"], pl["lsb"], pl["scale"], block_table, lens]
    _check_operands("K5p", qf, ops)
    out = torch.empty((B, kv_n, R, hd_v), dtype=torch.float32, device=qf.device)
    MP = block_table.shape[1]
    plan = plan_paged_mla_attention(max(B, 1), kv_n, max(R, 1), max(MP * page_size, 1))
    _launch_paged("paged_attention_stream_ams", COUNT_STREAM_AMS,
                  [x.data_ptr() for x in ops + [out]],
                  [B, kv_n, R, hd, hd_v, pl["hi"].shape[-1], pl["lsb"].shape[-1], scheme.k,
                   scheme.base.man_bits, page_size, MP, c, g, plan.cluster], qf.device)
    return out


def _fold_q(q, lengths, kv_n: int, scale, *, round_scaled: bool = True):
    """Scale q, fold the GQA groups chunk-major into rows ([B, kv, c*g, hd]
    f32) and flatten lengths to [B*c] int32. With ``round_scaled`` the
    scaled q is rounded to q.dtype (the rounding flash_decode applies, and
    the paged path of the compiled reference keeps); without it q is scaled
    in f32 by the scale rounded to q.dtype, as the compiled reference's
    contiguous path does (XLA drops the bf16 rounding between the multiply
    and the kernel's f32 input)."""
    chunked = q.dim() == 4
    if not chunked:
        q = q[:, None]
        lengths = torch.as_tensor(lengths, dtype=torch.int32, device=q.device)
        lengths = lengths.reshape(-1, 1).expand(q.shape[0], 1)
    B, c, H, hd = q.shape
    if H % kv_n != 0:
        raise ValueError(f"H={H} not grouped over kv={kv_n}")
    g = H // kv_n
    factor = _scale_factor(q, scale)
    qf = (q * factor).to(torch.float32) if round_scaled else q.float() * factor.float()
    qf = qf.reshape(B, c, kv_n, g, hd).permute(0, 2, 1, 3, 4).reshape(B, kv_n, c * g, hd)
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=q.device).reshape(-1)
    return qf.contiguous(), lens.contiguous(), chunked, (B, c, H, hd, g)


def _unfold_o(o, dims, chunked: bool, dtype):
    B, c, H, _, g = dims
    hd_v = o.shape[-1]
    o = o.reshape(B, H // g, c, g, hd_v).permute(0, 2, 1, 3, 4).reshape(B, c, H, hd_v)
    o = o.to(dtype)
    return o if chunked else o[:, 0]


def fused_paged_attention(q, pool: Dict, lengths, block_table, *, page_size: int,
                          kv_scheme: Optional[str], value_slice: Optional[int] = None,
                          scale: Optional[float] = None):
    """Paged flash-decode through K2 (``kv_scheme`` names the AMS pool's
    scheme) or K3 (``kv_scheme=None``: bf16 pages), or with ``value_slice``
    through K5p: the pool's ``k`` is one absorbed-MLA stream whose first
    ``value_slice`` columns are the values (``pool["v"]`` is never read).
    q [B, H, hd] or [B, c, H, hd] unscaled, lengths [B] or [B, c] valid
    keys, block_table [B, MP] int32. Returns q's shape (last dim
    ``value_slice`` when given) in q.dtype."""
    bt = block_table.to(torch.int32).contiguous()
    k_leaf = pool["k"] if kv_scheme is None else pool["k"]["hi"]
    qf, lens, chunked, dims = _fold_q(q, lengths, k_leaf.shape[2], scale)
    kw = dict(page_size=page_size, c=dims[1], g=dims[4])
    if kv_scheme is not None:
        kw["scheme"] = get_scheme(kv_scheme)
    if value_slice is not None:
        stream = paged_attention_stream_bf16 if kv_scheme is None else paged_attention_stream_ams
        o = stream(qf, pool, lens, bt, hd_v=value_slice, **kw)
    elif kv_scheme is None:
        o = paged_attention_bf16(qf, pool, lens, bt, **kw)
    else:
        o = paged_attention_ams(qf, pool, lens, bt, **kw)
    return _unfold_o(o, dims, chunked, q.dtype)


# ---------------------------------------------------------------------------
# K4 and K5: contiguous caches
# ---------------------------------------------------------------------------
def _contiguous_walk(qf, k_cache, v_cache, lens, *, c: int, g: int, block_kv: int,
                     hd_v: int) -> torch.Tensor:
    """`_online_softmax` over the ``block_kv`` blocks of a contiguous cache
    [B, S, kv, hd]; ``v_cache`` None: the values are the keys' first
    ``hd_v`` columns (the absorbed-MLA stream). p is rounded to the cache's
    type before the PV product (TPU ``pv_dtype`` = cache dtype)."""
    S = k_cache.shape[1]

    def load(i):
        kb = k_cache[:, i * block_kv:(i + 1) * block_kv].to(torch.float32)
        if v_cache is None:
            return kb, kb[..., :hd_v]
        return kb, v_cache[:, i * block_kv:(i + 1) * block_kv].to(torch.float32)

    pv_dtype = (k_cache if v_cache is None else v_cache).dtype
    return _online_softmax(qf, load, lens, block=block_kv, nblocks=S // block_kv, hd_v=hd_v,
                           c=c, g=g, pv_dtype=pv_dtype)


def contiguous_attention_plain(qf, k_cache, v_cache, lens, *, c: int, g: int,
                               block_kv: int) -> torch.Tensor:
    """Plain torch version of K4. qf [B, kv, R=c*g, hd] f32 (pre-scaled,
    chunk-major rows), k/v caches [B, S, kv, hd], lens [B*c] int32 valid
    keys per query -> [B, kv, R, hd] f32. The keys are walked in blocks of
    ``block_kv`` (a divisor of S); p is rounded to the cache's type at each
    block's running max, as the TPU kernel does."""
    if qf.is_cuda:
        COUNT_CONTIG.plain_on_cuda += 1
    return _contiguous_walk(qf, k_cache, v_cache, lens, c=c, g=g, block_kv=block_kv,
                            hd_v=v_cache.shape[-1])


def contiguous_attention_mla_plain(qf, cache, lens, *, c: int, g: int, block_kv: int,
                                   hd_v: int) -> torch.Tensor:
    """Plain torch version of K5: K4's walk over one absorbed-MLA stream
    ``cache`` [B, S, kv, hd] whose values are its first ``hd_v`` columns ->
    [B, kv, R, hd_v] f32."""
    if qf.is_cuda:
        COUNT_MLA.plain_on_cuda += 1
    return _contiguous_walk(qf, cache, None, lens, c=c, g=g, block_kv=block_kv, hd_v=hd_v)


@functools.lru_cache(maxsize=None)
def _kernel_contig(name: str, n_ptr: int, n_int: int):
    fn = getattr(library("contiguous_attention"), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_contig(qf, caches, lens, c, g, block_kv, hd_v):
    B, kv_n, R, hd = qf.shape
    if qf.dtype != torch.float32:
        raise TypeError(f"q must be float32, got {qf.dtype}")
    if R != c * g or lens.shape != (B * c,) or lens.dtype != torch.int32:
        raise ValueError(f"rows {R} != c*g = {c}*{g}, or lengths {tuple(lens.shape)} "
                         f"{lens.dtype} is not [B*c] int32")
    S = caches[0].shape[1]
    for t, width in zip(caches, (hd, hd_v)):
        if t.dim() != 4 or t.shape[0] != B or t.shape[1] != S or t.shape[2] != kv_n \
                or t.shape[3] != width:
            raise ValueError(f"cache must be [B={B}, S, kv={kv_n}, {width}], got "
                             f"{tuple(t.shape)}")
    if not 1 <= hd_v <= hd or block_kv < 1 or S % block_kv:
        raise ValueError(f"need 1 <= hd_v={hd_v} <= hd={hd} and block_kv={block_kv} dividing "
                         f"S={S}")


def _launch_contig(name, count, qf, caches, lens, hd_v, c, g, block_kv, plan=()):
    """Launch K4 / K5 on CUDA tensors: bf16 caches, contiguous operands;
    ``plan`` are the extra ints of the kernel's launch plan."""
    check_device(qf)
    B, kv_n, R, hd = qf.shape
    if any(t.dtype != torch.bfloat16 for t in caches):
        raise ValueError(f"{name} reads bf16 caches, got {[t.dtype for t in caches]}")
    ops = [qf, *caches, lens]
    if not all(t.is_contiguous() and t.device == qf.device for t in ops):
        raise ValueError(f"{name} operands must be contiguous and on one device")
    out = torch.empty((B, kv_n, R, hd_v), dtype=torch.float32, device=qf.device)
    ints = [B, caches[0].shape[1], kv_n, R, hd, hd_v, block_kv, c, g, *plan]
    rc = _kernel_contig(name, len(ops) + 1, len(ints))(
        *(t.data_ptr() for t in ops), out.data_ptr(), *ints, stream_ptr(qf.device))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    count.launches += 1
    return out


def contiguous_attention(qf, k_cache, v_cache, lens, *, c: int, g: int,
                         block_kv: int) -> torch.Tensor:
    """K4 wrapper (same contract as `contiguous_attention_plain`). CPU
    tensors take the plain version; CUDA tensors launch the kernel (cluster
    and score plan from `tuning.plan_contiguous_attention`) or raise."""
    _check_contig(qf, (k_cache, v_cache), lens, c, g, block_kv, v_cache.shape[-1])
    if qf.device.type == "cpu":
        return contiguous_attention_plain(qf, k_cache, v_cache, lens, c=c, g=g,
                                          block_kv=block_kv)
    B, kv_n, R, _ = qf.shape
    plan = plan_contiguous_attention(max(B, 1), kv_n, max(R, 1), block_kv)
    return _launch_contig("contiguous_attention", COUNT_CONTIG, qf, (k_cache, v_cache), lens,
                          v_cache.shape[-1], c, g, block_kv,
                          (plan.cluster, plan.score_keys, int(not plan.scores_fit)))


def contiguous_attention_mla(qf, cache, lens, *, c: int, g: int, block_kv: int,
                             hd_v: int) -> torch.Tensor:
    """K5 wrapper (same contract as `contiguous_attention_mla_plain`). CPU
    tensors take the plain version; CUDA tensors launch the kernel (cluster
    from `tuning.plan_mla_attention`) or raise."""
    _check_contig(qf, (cache,), lens, c, g, block_kv, hd_v)
    if qf.device.type == "cpu":
        return contiguous_attention_mla_plain(qf, cache, lens, c=c, g=g, block_kv=block_kv,
                                              hd_v=hd_v)
    B, kv_n, R, _ = qf.shape
    plan = plan_mla_attention(max(B, 1), kv_n, max(R, 1), block_kv)
    return _launch_contig("contiguous_attention_mla", COUNT_MLA, qf, (cache,), lens, hd_v, c,
                          g, block_kv, (plan.cluster,))


def fused_contiguous_attention(q, k_cache, lengths, *, v_cache=None,
                               value_slice: Optional[int] = None,
                               block_kv: Optional[int] = None, scale: Optional[float] = None):
    """Contiguous-cache flash-decode through K4 (``v_cache`` given) or K5
    (``value_slice``: values are the first ``value_slice`` columns of the
    keys, the absorbed-MLA stream): q [B, H, hd] or [B, c, H, hd] unscaled,
    k_cache [B, S, kv, hd], lengths [B] or [B, c] valid keys. ``block_kv``
    defaults to the reference's plan (`tuning.reference_block_kv`) and must
    divide S. Returns q's shape (last dim hd_v) in q.dtype."""
    if (v_cache is None) == (value_slice is None):
        raise ValueError("need exactly one of v_cache and value_slice")
    S, kv_n = k_cache.shape[1], k_cache.shape[2]
    qf, lens, chunked, dims = _fold_q(q, lengths, kv_n, scale, round_scaled=False)
    B, c, H, hd, g = dims
    hd_v = v_cache.shape[-1] if v_cache is not None else value_slice
    if block_kv is None:
        block_kv = reference_block_kv(rows=c * g, hd=hd, hd_v=hd_v, s_max=S)
    if v_cache is not None:
        o = contiguous_attention(qf, k_cache, v_cache, lens, c=c, g=g, block_kv=block_kv)
    else:
        o = contiguous_attention_mla(qf, k_cache, lens, c=c, g=g, block_kv=block_kv,
                                     hd_v=hd_v)
    return _unfold_o(o, dims, chunked, q.dtype)


def attend_contiguous(q, k_cache, v_cache, lengths, *, kv_map, scale=None, impl: str = "ref",
                      value_slice: Optional[int] = None, window: int = 0, ring: bool = False,
                      ctx=None):
    """Decode attention over a contiguous cache, routed by ``impl``: ``ref``
    is `flash_decode` / `flash_decode_chunk` (``v_cache`` are the values;
    for MLA the [..., :r_kv] view of the stream), ``kernel`` is
    `fused_contiguous_attention` (K4, or K5 with ``value_slice``). q [B, H,
    hd] with lengths [B], or [B, c, H, hd] with per-query lengths [B, c].
    A sliding ``window`` or a ``ring`` cache (one-token queries only) takes
    `flash_decode` whatever ``impl`` says, as the reference routes them:
    its fused template has no window or ring index math. So does a cache
    sequence-sharded over a tp > 1 ``ctx``: the reference routes every
    sequence-sharded core to its XLA bodies, whose pmax / psum merge the
    ranks' partial softmaxes (its attention_template.py:572-576), and the
    port takes `flash_decode` / `flash_decode_chunk` with the merge; K4 and
    K5 are never launched there (they would have to return their partial
    (m, l, o), which the reference's kernels never do)."""
    if impl not in ("ref", "kernel"):
        raise ValueError(f"unknown contiguous attention impl {impl!r}")
    sharded = ctx is not None and ctx.seq_shard and ctx.tp > 1
    if window or ring:
        if q.dim() != 3:
            raise NotImplementedError("sliding-window and ring caches take one-token "
                                      "queries only")
        return flash_decode(q, k_cache, v_cache, lengths, kv_map=kv_map, scale=scale,
                            window=window, ring=ring, ctx=ctx)
    if impl == "ref" or sharded:
        if q.dim() == 3:
            return flash_decode(q, k_cache, v_cache, lengths, kv_map=kv_map, scale=scale,
                                ctx=ctx)
        return flash_decode_chunk(q, k_cache, v_cache, lengths, kv_map=kv_map, scale=scale,
                                  ctx=ctx)
    _check_grouped(q.shape[-2], k_cache.shape[2], kv_map)
    return fused_contiguous_attention(
        q, k_cache, lengths, v_cache=None if value_slice is not None else v_cache,
        value_slice=value_slice, scale=scale)
