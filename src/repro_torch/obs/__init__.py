"""Serving observability (port of src/repro/obs): the metrics registry
`ServeEngine.stats()` is computed from, per-request trace spans, and the
roofline cost model (`obs.cost`, on the H100's peaks)."""

from repro_torch.obs.config import ObsConfig  # noqa: F401
from repro_torch.obs.cost import (  # noqa: F401
    StepCostModel,
    attribution,
    build_cost_model,
    kv_vector_bytes_floor,
    kv_vector_bytes_ideal,
)
from repro_torch.obs.metrics import NULL_REGISTRY, MetricsRegistry  # noqa: F401
from repro_torch.obs.trace import TraceRecorder  # noqa: F401
