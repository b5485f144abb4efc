"""Fault-tolerance & elasticity utilities for the training driver (port of
src/repro/launch/fault_tolerance.py; pure Python, the port keeps its own
copy).

Designed for thousands of nodes, demonstrated on one:

  * RunGuard      — retry-with-restore loop: any step exception triggers a
                    restore from the last complete checkpoint and resumption;
                    crash-at-any-point safety comes from the checkpoint
                    manager's manifest-last atomic layout.
  * Straggler     — per-step deadline monitor. On a real pod the hook
                    escalates (alert -> re-shard -> evict); offline we log
                    and count. Deadline auto-calibrates to median step time.
  * FailureInjector — deterministic fault injection for tests/drills
                    (REPRO_INJECT_FAIL_AT=<step>[,<step>...]).
  * elastic re-shard — the data pipeline is stateless/seekable, so changing
                    the DP world size only changes (shard, num_shards) in
                    batch(); params/opt state restore is sharding-agnostic
                    (checkpoints store full arrays). See train.py --dp-size.
"""

from __future__ import annotations

import os
import statistics
import time
from typing import Callable, List, Optional


class FailureInjector:
    def __init__(self, env: str = "REPRO_INJECT_FAIL_AT"):
        spec = os.environ.get(env, "")
        self.steps = {int(s) for s in spec.split(",") if s.strip()}
        self.fired = set()

    def maybe_fail(self, step: int):
        if step in self.steps and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected failure at step {step}")


class StragglerMonitor:
    """Deadline-based straggler detection with self-calibrating threshold."""

    def __init__(self, factor: float = 3.0, warmup: int = 5,
                 on_straggle: Optional[Callable[[int, float], None]] = None):
        self.factor = factor
        self.warmup = warmup
        self.times: List[float] = []
        self.straggles: List[int] = []
        self.on_straggle = on_straggle

    def observe(self, step: int, dt: float):
        if len(self.times) >= self.warmup:
            med = statistics.median(self.times[-50:])
            if dt > self.factor * med:
                self.straggles.append(step)
                if self.on_straggle:
                    self.on_straggle(step, dt)
        self.times.append(dt)

    @property
    def median(self) -> float:
        return statistics.median(self.times) if self.times else 0.0


class RunGuard:
    """Retry loop: run step_fn under failure containment + restore."""

    def __init__(self, restore_fn: Callable[[], int], max_restarts: int = 5):
        self.restore_fn = restore_fn
        self.max_restarts = max_restarts
        self.restarts = 0

    def run(self, step: int, fn: Callable[[], None]) -> int:
        """Execute fn(); on failure restore and return the restored step.
        Returns the next step to run."""
        try:
            fn()
            return step + 1
        except Exception as e:  # noqa: BLE001 — containment boundary
            self.restarts += 1
            if self.restarts > self.max_restarts:
                raise
            print(f"[fault] step {step}: {e!r} -> restoring "
                  f"(restart {self.restarts}/{self.max_restarts})", flush=True)
            restored = self.restore_fn()
            return restored


def heartbeat_file(path: str, step: int):
    """Liveness marker for an external watchdog (pod-level restart policy)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(f"{step} {time.time()}\n")
    os.replace(tmp, path)
