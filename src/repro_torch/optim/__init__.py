from .adamw import (  # noqa: F401
    AdamWConfig,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    init_state,
)
from .grad_compress import compressed_allreduce, compressed_psum  # noqa: F401
from .schedule import warmup_cosine  # noqa: F401
