"""Observability configuration for the serving engine (port of
src/repro/obs/config.py).

  * ``enabled=True`` (default) — a live `MetricsRegistry`; `stats()` is
    computed from it. ``enabled=False`` swaps in no-op instruments.
  * ``trace=True`` — per-request lifecycle spans and per-tick device-step
    spans (`obs.trace.TraceRecorder`); device spans synchronize the card, so
    tracing is for inspection runs.
  * ``cost=True`` (default) — attach the analytic roofline cost model
    (`obs.cost.StepCostModel`, on the H100's peaks) and accumulate per-tick
    and per-request floor and achieved KV byte accounting, on the host,
    outside the step's CUDA graph.

The reference's ``jax_profile_*`` fields have no counterpart.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """How much telemetry the serving engine records."""

    enabled: bool = True        # master switch: False -> no-op instruments
    trace: bool = False         # record lifecycle + device-step spans
    cost: bool = True           # roofline floor/achieved byte accounting

    @property
    def trace_on(self) -> bool:
        return self.enabled and self.trace

    @property
    def cost_on(self) -> bool:
        return self.enabled and self.cost
