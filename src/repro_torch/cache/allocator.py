# Port of src/repro/cache/allocator.py: a copy with its imports rewired to repro_torch.
"""Host-side refcounted page allocator + content-addressed prefix cache.

The allocator owns the free/evictable state of the device page pool. It is
pure host state (plain ints and hashes), mirroring the scheduler's split:
device tensors never hold allocation metadata, so allocation/free/match is
O(pages) numpy work per request, not a jitted op.

Every page is in exactly ONE of three states:

    free (uncached)   --alloc-->   referenced (refcount >= 1)
    referenced        --free-->    free              (never published)
    referenced        --free-->    cached-evictable  (hash in the index)
    cached-evictable  --alloc-->   referenced        (prefix hit, ref += 1)
    cached-evictable  --evict-->   referenced        (reclaimed, hash dropped)

Prefix caching: completed PROMPT pages are content-addressed by a
prefix-chain block hash (`prefix_page_hashes`) committing to every token of
the page and its predecessors plus the cache scheme. Because the paged-AMS
pool quantizes each inserted K/V vector deterministically per (token, head)
(`core/kv_quant`), equal hashes imply bit-identical page planes — so a
later request with the same prompt prefix references the SAME physical page
(refcount += 1, read-only) and skips prefilling it entirely. Pages whose
refcount drains to zero keep their cached content in an LRU until memory
pressure reclaims them (least-recently-released first).

Pages are reserved for a request's WORST-CASE footprint at admission
(`ceil(kv_need / page_size)` pages), but only the UNCACHED page count
charges the free budget. `free` raises on an unknown request id — a double
free would otherwise silently corrupt the free list.

Host spill tier (PR 10): one layer BELOW eviction. When memory pressure
reclaims a cached-evictable page and a host tier is configured
(`host_spill_pages` > 0 and the engine bound a `spill_fn`), the page's
packed planes move to a host-memory LRU keyed by the same block hash
instead of being dropped. Prefix matching then extends over host-resident
hashes: a later request with that prefix draws a FRESH device page, the
(page, host content) pair is queued on `pending_restores` for the engine to
scatter back before its first step, and the page re-enters the index — so
a host hit still skips prefill, at the cost of one host->device copy
instead of recompute. Preemption (`preempt`/`resume`) releases a victim's
pages past its shared prefix while the engine snapshots their content onto
the request itself; `resume` re-extends with fresh pages for the engine to
restore. AMS planes travel packed in both directions, so every round trip
is bit-exact.

Page index 0 is a valid data page like any other; block-table rows are
padded with 0 for unused entries. That is safe because attention masks
every key position >= the request's current length, so a padded entry is
never read as data — even when page 0 is simultaneously shared by other
requests.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.obs.metrics import NULL_REGISTRY


def prefix_page_hashes(tokens, page_size: int,
                       content_key: str = "") -> Tuple[bytes, ...]:
    """Prefix-chain hash per FULL page of `tokens`.

    Hash j commits to every token of pages 0..j, the page size, and
    `content_key` (the cache scheme — bf16 and AMS pages of the same tokens
    hold different bytes, and different AMS schemes different codes), so
    equal hashes imply bit-identical page content under the deterministic
    per-(token, head) insert quantization. A partial trailing page gets no
    hash: its remaining slots are filled by request-specific tokens.
    """
    toks = np.asarray(tokens, np.int64).reshape(-1)
    h = hashlib.sha256(f"{content_key}|{page_size}".encode()).digest()
    out = []
    for j in range(toks.shape[0] // page_size):
        page = toks[j * page_size:(j + 1) * page_size]
        h = hashlib.sha256(h + page.tobytes()).digest()
        out.append(h)
    return tuple(out)


class PageAllocator:
    """Refcounting allocator over `num_pages` fixed-size pages with a
    block-hash index of cached, evictable prefix pages (module docstring)."""

    def __init__(self, num_pages: int, page_size: int, metrics=None,
                 host_spill_pages: int = 0):
        if num_pages < 1:
            raise ValueError("num_pages must be >= 1")
        self.num_pages = num_pages
        self.page_size = page_size
        # host spill tier: block hash -> host-side page pytree (packed
        # planes), least recently spilled first. Active only when sized AND
        # the engine bound `spill_fn(page) -> host pytree` (the allocator
        # itself never touches device memory).
        self.host_spill_pages = host_spill_pages
        self.spill_fn = None
        self._host: "OrderedDict[bytes, object]" = OrderedDict()
        # (device page, host content) pairs the engine must scatter back
        # into the pool before the owning request's next step
        self.pending_restores: List[Tuple[int, object]] = []
        # telemetry (repro.obs): the engine passes its registry; a bare
        # allocator gets the shared no-op instruments. Occupancy is
        # exported as callback gauges so collection always sees live state.
        m = metrics if metrics is not None else NULL_REGISTRY
        self._m_alloc = m.counter("alloc_pages_total",
                                  "pages reserved, by kind", ("kind",))
        self._m_alloc_shared = self._m_alloc.labels(kind="shared")
        self._m_alloc_private = self._m_alloc.labels(kind="private")
        self._m_freed = m.counter("alloc_pages_freed_total",
                                  "page references released")
        self._m_evicted = m.counter("alloc_pages_evicted_total",
                                    "cached pages reclaimed under pressure")
        self._m_hit = m.counter("alloc_prefix_hit_pages_total",
                                "cacheable pages served from the index")
        self._m_miss = m.counter("alloc_prefix_miss_pages_total",
                                 "cacheable pages allocated private")
        m.gauge("alloc_pages_in_use", "pages referenced by live requests",
                fn=lambda: self.used_pages)
        m.gauge("alloc_pages_cached_evictable",
                "refcount-0 pages kept for prefix hits",
                fn=lambda: self.cached_pages)
        m.gauge("alloc_pages_free", "reclaimable supply (free + evictable)",
                fn=lambda: self.free_pages)
        self._m_spilled = m.counter(
            "alloc_pages_spilled_host_total",
            "evicted pages offloaded to the host spill tier")
        self._m_restored = m.counter(
            "alloc_pages_restored_host_total",
            "host-tier pages restored into fresh device pages")
        m.gauge("alloc_pages_host_tier",
                "pages resident in the host spill tier",
                fn=lambda: len(self._host))
        # LIFO free list: freshly freed pages are reused first (their planes
        # are still warm in cache on real hardware)
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        # refcount-0 pages still holding published content, least recently
        # released first — the eviction order under memory pressure
        self._lru: "OrderedDict[int, bytes]" = OrderedDict()
        self._index: Dict[bytes, int] = {}   # block hash -> resident page
        self._hash: Dict[int, bytes] = {}    # page -> its published hash
        self._ref: Dict[int, int] = {}       # page -> refcount (>0 only)
        self._owned: Dict[int, List[int]] = {}   # rid -> pages
        # monotonic counters (reset via reset_stats)
        self.hits = 0         # cacheable pages served from the index at alloc
        self.misses = 0       # cacheable (hashed) pages allocated private —
        #                       generation-tail/partial pages can never hit,
        #                       so they don't dilute prefix_hit_rate
        self.evictions = 0    # cached pages reclaimed under pressure
        self.host_spills = 0     # evicted pages whose content moved to host
        self.host_restores = 0   # host-tier pages brought back on a hit

    # ------------------------------------------------------------- queries
    @property
    def free_pages(self) -> int:
        """Reclaimable supply: truly-free pages plus evictable cached pages
        (the admission budget — cached pages are given up under pressure)."""
        return len(self._free) + len(self._lru)

    @property
    def used_pages(self) -> int:
        """Pages referenced by at least one in-flight request."""
        return self.num_pages - self.free_pages

    @property
    def cached_pages(self) -> int:
        """Evictable pages kept resident for future prefix hits."""
        return len(self._lru)

    def pages_needed(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 0) // self.page_size)

    def refcount(self, page: int) -> int:
        """Live references to `page` (0 = free or cached-evictable)."""
        return self._ref.get(page, 0)

    def match_prefix(self, hashes: Sequence[bytes]) -> int:
        """Longest resident prefix: how many leading `hashes` the index
        holds. Pure query — pins nothing."""
        n = 0
        for h in hashes:
            if h not in self._index:
                break
            n += 1
        return n

    def _classify_prefix(self, hashes: Sequence[bytes],
                         n_pages: int) -> List[str]:
        """Leading run of `hashes` servable WITHOUT prefill: each entry is
        ``"resident"`` (a shared physical page) or ``"host"`` (content in
        the spill tier — needs a fresh page plus a queued restore); the run
        stops at the first hash in neither tier."""
        kinds: List[str] = []
        for h in list(hashes)[:n_pages]:
            if h in self._index:
                kinds.append("resident")
            elif h in self._host:
                kinds.append("host")
            else:
                break
        return kinds

    def _admission(self, n_pages: int,
                   hashes: Sequence[bytes]) -> Tuple[List[str], bool]:
        """(prefix classification, whether the request fits) — the single
        source of the budget arithmetic `can_alloc` and `alloc` share, so
        can_alloc() == True structurally guarantees alloc() succeeds. Only
        pages drawn fresh (privates + host-tier restores) charge the
        reclaimable supply; resident matched pages sitting in the LRU are
        pinned by the alloc, not spent."""
        kinds = self._classify_prefix(hashes, n_pages)
        hl = list(hashes)
        resident = sum(1 for k in kinds if k == "resident")
        pinned_from_lru = sum(1 for i, k in enumerate(kinds)
                              if k == "resident" and self._index[hl[i]] in self._lru)
        return kinds, n_pages - resident <= self.free_pages - pinned_from_lru

    def can_alloc(self, n_pages: int, hashes: Sequence[bytes] = ()) -> bool:
        """True iff `alloc(rid, n_pages, hashes)` would succeed."""
        return self._admission(n_pages, hashes)[1]

    # ------------------------------------------------------------ mutation
    def _reclaim_coldest(self) -> int:
        """Evict the least-recently-released cached page, spilling its
        content to the host tier first when one is configured (the tier's
        own LRU drops ITS oldest entry past capacity — that is the true end
        of the page lifecycle: device -> host -> gone)."""
        p, h = self._lru.popitem(last=False)
        if self.host_spill_pages > 0 and self.spill_fn is not None:
            self._host[h] = self.spill_fn(p)
            self._host.move_to_end(h)
            self.host_spills += 1
            self._m_spilled.inc()
            while len(self._host) > self.host_spill_pages:
                self._host.popitem(last=False)
        del self._index[h]
        del self._hash[p]
        self.evictions += 1
        self._m_evicted.inc()
        return p

    def alloc(self, rid: int, n_pages: int,
              hashes: Sequence[bytes] = ()) -> Tuple[List[int], int]:
        """Reserve `n_pages` for request `rid`, shared-prefix pages first:
        the longest resident prefix of `hashes` is SHARED (refcount += 1,
        read-only for this request); the remainder is private, drawn from
        the free list or — under pressure — by evicting least-recently-used
        cached pages. Raises if the pool is short (callers gate on
        `can_alloc` — the scheduler's admission check). Returns
        ``(pages, n_shared)`` — the page list and the authoritative count
        of leading shared pages, which callers MUST use (not their own
        `match_prefix` rerun) to place their first insert position."""
        if rid in self._owned:
            raise ValueError(f"request {rid} already holds pages")
        kinds, fits = self._admission(n_pages, hashes)
        if not fits:
            raise RuntimeError(
                f"page pool exhausted: need {n_pages}, free {self.free_pages}")
        matched = len(kinds)
        hl = list(hashes)
        pages: List[int] = [-1] * n_pages
        # pass 1: pin every RESIDENT shared page, and claim every matched
        # host-tier content blob, BEFORE drawing any fresh page — drawing
        # evicts LRU pages (which could be a later resident match) and can
        # overflow the host tier (which could drop a later host match)
        restores: Dict[int, object] = {}
        for i, k in enumerate(kinds):
            if k == "resident":
                p = self._index[hl[i]]
                if p in self._lru:
                    del self._lru[p]
                self._ref[p] = self._ref.get(p, 0) + 1
                pages[i] = p
            else:                               # host-tier hit
                restores[i] = self._host.pop(hl[i])
        # pass 2: fresh pages for host-tier hits (restore queued, hash
        # re-registered as resident) and for plain privates (insert-target)
        for i in range(n_pages):
            if pages[i] >= 0:
                continue
            if self._free:
                p = self._free.pop()
            else:                               # reclaim coldest cached page
                p = self._reclaim_coldest()
            self._ref[p] = 1
            pages[i] = p
            if i in restores:
                self.pending_restores.append((p, restores[i]))
                self._index[hl[i]] = p
                self._hash[p] = hl[i]
                self.host_restores += 1
                self._m_restored.inc()
        n_resident = matched - len(restores)
        self.hits += matched
        self.misses += min(len(hashes), n_pages) - matched
        self._m_hit.inc(matched)
        self._m_miss.inc(min(len(hashes), n_pages) - matched)
        self._m_alloc_shared.inc(n_resident)
        self._m_alloc_private.inc(n_pages - n_resident)
        self._owned[rid] = pages
        return pages, matched

    def publish(self, rid: int, h: bytes, page: int) -> bool:
        """Register a COMPLETED private page under its block hash so later
        requests can share it. No-op (False) when the hash is already
        resident — first writer wins; the duplicate page stays private and
        returns to the free list on release. Published pages stay
        bit-immutable because writers only ever insert past their cached
        prefix (asserted by the engine)."""
        if page not in self._owned.get(rid, ()):
            raise ValueError(f"request {rid} does not own page {page}")
        if h in self._index or page in self._hash:
            return False
        # a re-prefilled copy supersedes any host-tier spill of the same
        # content (equal hashes imply identical bytes) — drop the host copy
        # so each hash lives in exactly one tier
        self._host.pop(h, None)
        self._index[h] = page
        self._hash[page] = h
        return True

    def free(self, rid: int) -> int:
        """Release every page owned by `rid` (refcount -= 1); pages whose
        count drains to zero return to the free list, or to the evictable
        LRU tail when they hold published content. Returns how many pages
        the request held. Raises KeyError on an unknown rid: a double free
        would otherwise push pages onto the free list while other requests
        still reference them."""
        if rid not in self._owned:
            raise KeyError(
                f"free of unknown request {rid} (double free, or never "
                "allocated)")
        pages = self._owned.pop(rid)
        for p in pages:
            self._release_page(p)
        self._m_freed.inc(len(pages))
        return len(pages)

    def _release_page(self, p: int) -> None:
        """Drop one reference: refcount-0 pages return to the free list, or
        to the evictable LRU tail when they hold published content."""
        n = self._ref.get(p, 0)
        if n <= 0:
            raise RuntimeError(
                f"page {p} released with refcount {n}: allocator state "
                "corrupt")
        if n == 1:
            del self._ref[p]
            if p in self._hash:
                self._lru[p] = self._hash[p]   # most recently released
            else:
                self._free.append(p)
        else:
            self._ref[p] = n - 1

    # ---------------------------------------------------------- preemption
    def preempt(self, rid: int, n_keep: int) -> List[int]:
        """Release every page `rid` holds PAST its first `n_keep` (the
        shared prefix stays pinned, keeping its refcounts — the ISSUE's
        'spilled pages keep refcounts' contract): released refcounts drop
        exactly like `free`, so published pages move to the evictable LRU
        and unpublished privates to the free list. The rid keeps its
        (possibly empty) kept-page list so `resume` can extend it. Returns
        the released page ids in position order; the ENGINE must snapshot
        their content (`pool.extract_pages`) BEFORE calling this, because a
        released page may be reused by the very next alloc."""
        if rid not in self._owned:
            raise KeyError(f"preempt of unknown request {rid}")
        pages = self._owned[rid]
        n_keep = max(0, min(n_keep, len(pages)))
        released = pages[n_keep:]
        self._owned[rid] = pages[:n_keep]
        for p in released:
            self._release_page(p)
        self._m_freed.inc(len(released))
        return released

    def can_resume(self, rid: int, n_pages: int) -> bool:
        """True iff `resume(rid, n_pages)` would succeed (kept pages are
        already pinned, so only the extension charges the supply)."""
        held = len(self._owned.get(rid, ()))
        return n_pages - held <= self.free_pages

    def resume(self, rid: int, n_pages: int) -> List[int]:
        """Extend a preempted request back to `n_pages` total with fresh
        private pages appended after its kept shared prefix. Returns the
        NEW page ids in position order; the engine scatters the request's
        spilled content into them before its next step, after which the
        request is bit-indistinguishable from one that was never
        preempted."""
        if rid not in self._owned:
            raise KeyError(f"resume of unknown request {rid}")
        held = self._owned[rid]
        need = n_pages - len(held)
        if need > self.free_pages:
            raise RuntimeError(
                f"page pool exhausted on resume: need {need}, "
                f"free {self.free_pages}")
        new: List[int] = []
        for _ in range(max(need, 0)):
            p = self._free.pop() if self._free else self._reclaim_coldest()
            self._ref[p] = 1
            new.append(p)
        held.extend(new)
        self._m_alloc_private.inc(len(new))
        return new

    def block_table_row(self, rid: int, width: int) -> np.ndarray:
        """[width] int32 row for the device block table (0-padded)."""
        pages = self._owned.get(rid, [])
        if len(pages) > width:
            raise ValueError(
                f"request {rid} holds {len(pages)} pages > table width {width}")
        row = np.zeros(width, np.int32)
        row[: len(pages)] = pages
        return row

    # ---------------------------------------------------------- accounting
    def stats(self) -> Dict[str, float]:
        """Counter snapshot (`ServeEngine.stats()` re-exports these)."""
        looked = self.hits + self.misses
        return {
            "pages_total": self.num_pages,
            "pages_in_use": self.num_pages - self.free_pages,
            "pages_cached_evictable": len(self._lru),
            "pages_free_uncached": len(self._free),
            "prefix_hit_pages": self.hits,
            "prefix_miss_pages": self.misses,
            "prefix_hit_rate": self.hits / looked if looked else 0.0,
            "prefix_evictions": self.evictions,
            "pages_host_tier": len(self._host),
            "host_spill_pages_total": self.host_spills,
            "host_restore_pages_total": self.host_restores,
        }

    def reset_stats(self) -> None:
        self.hits = self.misses = self.evictions = 0
        self.host_spills = self.host_restores = 0

    def check_invariants(self) -> None:
        """Structural invariants, used by the property tests: every page is
        in exactly one of {free, cached-evictable, referenced}; refcounts
        equal owner multiplicity; the hash index is a bijection onto
        resident published pages."""
        free, lru, ref = set(self._free), set(self._lru), set(self._ref)
        assert len(free) == len(self._free), "free list holds duplicates"
        assert not (free & lru) and not (free & ref) and not (lru & ref), \
            "page in two lifecycle states at once"
        assert (free | lru | ref) == set(range(self.num_pages)), \
            "pages leaked or invented"
        counts: Dict[int, int] = {}
        for pages in self._owned.values():
            for p in pages:
                counts[p] = counts.get(p, 0) + 1
        assert counts == self._ref, "refcounts != owner multiplicity"
        assert all(n > 0 for n in self._ref.values())
        assert self._index == {h: p for p, h in self._hash.items()}, \
            "hash index not a bijection"
        assert set(self._hash) <= (lru | ref), "published hash on free page"
        assert not (set(self._host) & set(self._index)), \
            "hash resident on device AND in the host tier"
        assert len(self._host) <= max(self.host_spill_pages, 0), \
            "host spill tier over capacity"
