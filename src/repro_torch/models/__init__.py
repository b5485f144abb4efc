"""Dense GQA and MoE-GQA (paged or contiguous caches), absorbed-MLA,
Mamba-1 and RG-LRU hybrid (contiguous caches) decoders (port of
src/repro/models)."""

from .common import model_dims, quantize_params  # noqa: F401
from .transformer import (  # noqa: F401
    check_chunked_support,
    check_serving_support,
    check_support,
    decode_step,
    forward_seq,
    init_params,
    layer_pattern,
    make_cache,
    reset_cache_slot,
)
