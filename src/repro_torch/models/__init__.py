"""Dense GQA decoder over paged caches (port of src/repro/models)."""

from .common import model_dims, quantize_params  # noqa: F401
from .transformer import (  # noqa: F401
    check_paged_support,
    decode_step,
    init_params,
    layer_pattern,
    make_cache,
)
