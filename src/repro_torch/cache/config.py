# Port of src/repro/cache/config.py: a copy with its imports rewired to repro_torch; impl is "ref" or "kernel".
"""Cache-mode configuration for the serving engine.

One `CacheConfig` selects the decode KV-cache representation end to end:

  * ``contiguous``  — PR-1 behaviour: one fixed [slots, capacity] bf16
    tensor per layer, worst-case capacity reserved per slot;
  * ``paged_bf16``  — fixed-size pages (default 16 tokens) drawn from a
    shared pool; per-request block tables; still bf16 values;
  * ``paged_ams``   — pages stored in the packed AMS-e2m2 layout from
    `repro.core.kv_quant` (hi-nibble plane + shared-LSB plane + per-
    (token, head) scales); each inserted K/V vector is quantized ONCE at
    insert and restored on the fly inside the attention loop.

The paged modes require every attention layer to be plain GQA (gqa /
gqa_moe patterns): sliding-window ring caches and MLA's compressed stream
keep their contiguous layouts for now (docs/paged_cache.md §Extensions).
"""

from __future__ import annotations

import dataclasses

PAGED_KINDS = ("paged_bf16", "paged_ams")
CACHE_KINDS = ("contiguous",) + PAGED_KINDS


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """How the engine stores and reads the decode KV cache."""

    kind: str = "contiguous"         # contiguous | paged_bf16 | paged_ams
    page_size: int = 16              # tokens per page
    num_pages: int = 0               # pool size (pages per layer); 0 = derive
    max_pages_per_seq: int = 0       # block-table width; 0 = derive
    kv_scheme: str = "fp4.25-e2m2"   # AMS scheme for paged_ams pages
    kv_strategy: str = "set_lsb"     # mantissa-sharing strategy at insert
    impl: str = "ref"                # ref | kernel (the hand-written CUDA
    #                                  attention kernels K2-K5; their plain
    #                                  torch versions on CPU tensors)
    prefix_cache: bool = True        # share completed prompt pages across
    #                                  requests (paged modes; see
    #                                  docs/paged_cache.md §Prefix caching)
    host_spill_pages: int = 0        # host-memory spill tier capacity, in
    #                                  pages (0 = tier off): evicted LRU
    #                                  pages and preempted requests' private
    #                                  pages spill here in packed form and
    #                                  restore bit-exactly (docs/
    #                                  paged_cache.md §Host spill tier)

    def __post_init__(self):
        kind = self.kind.replace("-", "_")
        object.__setattr__(self, "kind", kind)
        if kind not in CACHE_KINDS:
            raise ValueError(f"unknown cache kind {self.kind!r}; "
                             f"expected one of {CACHE_KINDS}")
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")
        if self.impl not in ("ref", "kernel"):
            raise ValueError(f"unknown attention impl {self.impl!r}")
        if self.host_spill_pages < 0:
            raise ValueError("host_spill_pages must be >= 0")

    @property
    def paged(self) -> bool:
        return self.kind in PAGED_KINDS

    @property
    def quantized(self) -> bool:
        return self.kind == "paged_ams"

    @property
    def content_key(self) -> str:
        """String committed into prefix-cache block hashes: two requests may
        share a physical page only when every byte of the page would be
        identical, which holds exactly when the storage scheme matches (the
        insert quantization is deterministic per (token, head))."""
        if self.quantized:
            return f"{self.kind}/{self.kv_scheme}/{self.kv_strategy}"
        return self.kind

    def sized(self, *, capacity: int, slots: int) -> "CacheConfig":
        """Fill derived sizes from the engine's (slots, capacity) request:
        block tables wide enough for `capacity` tokens, and a pool that can
        hold every slot at worst case unless `num_pages` was given."""
        mp = self.max_pages_per_seq or -(-capacity // self.page_size)
        np_ = self.num_pages or mp * slots
        return dataclasses.replace(self, max_pages_per_seq=mp, num_pages=np_)
