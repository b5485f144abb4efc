"""Serving observability (port of src/repro/obs): the metrics registry
`ServeEngine.stats()` is computed from, and per-request trace spans. The
roofline cost model (`obs/cost.py`) is not ported yet."""

from repro_torch.obs.config import ObsConfig  # noqa: F401
from repro_torch.obs.metrics import NULL_REGISTRY, MetricsRegistry  # noqa: F401
from repro_torch.obs.trace import TraceRecorder  # noqa: F401
