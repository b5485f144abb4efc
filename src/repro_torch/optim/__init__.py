from .adamw import (  # noqa: F401
    AdamWConfig,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    init_state,
)
from .schedule import warmup_cosine  # noqa: F401
