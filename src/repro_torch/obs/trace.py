# Port of src/repro/obs/trace.py: a copy with its imports rewired to repro_torch.
"""Per-request lifecycle spans as Chrome trace-event JSON.

The engine records one span tree per request on its own trace "thread"
(tid = rid + 1):

    request
      queued                submit -> admitted
      prefill               admitted -> first generated token
      decode                first token -> finish
      finished  (instant)

plus the engine thread (tid 0), which carries per-tick spans::

    tick
      admit                 host-side admission + page allocation
      device_step           the ragged engine step, timed to completion
                            via torch.cuda.synchronize (tracing therefore
                            serializes dispatch — inspection runs only)

The export (`save` / `chrome`) is the Chrome trace-event format: load the
JSON at https://ui.perfetto.dev or chrome://tracing. ``B``/``E`` events
require strict LIFO nesting per thread — `end` enforces it eagerly (a
mis-nested span raises at the recording site, not at viewing time), and
`validate_events` re-checks a finished event stream structurally, which is
what tests/test_obs.py runs against random traffic.

Timestamps come from one ``time.perf_counter_ns`` clock, exported in
microseconds relative to recorder construction — monotonic by
construction, which `validate_events` also asserts.

A disabled recorder (``TraceRecorder(enabled=False)``) early-returns from
every method: the zero-perturbation guarantee of `ObsConfig` again
reduces to a no-op call per event.
"""

from __future__ import annotations

import json
from time import perf_counter_ns
from typing import Dict, List, Optional, Tuple

PID = 1          # single-process engine: one trace process


class TraceRecorder:
    """Span recorder with eager nesting validation (module docstring)."""

    def __init__(self, enabled: bool = True, clock=perf_counter_ns):
        self.enabled = enabled
        self._clock = clock
        self._t0 = clock() if enabled else 0
        self._events: List[dict] = []
        self._stacks: Dict[int, List[str]] = {}
        self._named: Dict[int, str] = {}

    def _ts(self) -> float:
        return (self._clock() - self._t0) / 1e3    # ns -> us

    # ------------------------------------------------------------ recording
    def thread(self, tid: int, name: str) -> None:
        """Name a trace thread (one per request, plus tid 0 = engine)."""
        if not self.enabled or self._named.get(tid) == name:
            return
        self._named[tid] = name
        self._events.append({"ph": "M", "pid": PID, "tid": tid, "ts": 0,
                             "name": "thread_name", "args": {"name": name}})

    def begin(self, tid: int, name: str, args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        ev = {"ph": "B", "pid": PID, "tid": tid, "name": name,
              "ts": self._ts()}
        if args:
            ev["args"] = args
        self._events.append(ev)
        self._stacks.setdefault(tid, []).append(name)

    def end(self, tid: int, name: str, args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        stack = self._stacks.get(tid, [])
        if not stack or stack[-1] != name:
            raise RuntimeError(
                f"span nesting violated on tid {tid}: end({name!r}) but "
                f"open spans are {stack}")
        stack.pop()
        ev = {"ph": "E", "pid": PID, "tid": tid, "name": name,
              "ts": self._ts()}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def instant(self, tid: int, name: str, args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        ev = {"ph": "i", "s": "t", "pid": PID, "tid": tid, "name": name,
              "ts": self._ts()}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def counter(self, name: str, values: Dict[str, float],
                tid: int = 0) -> None:
        """Counter track (rendered as a stacked area chart in Perfetto)."""
        if not self.enabled:
            return
        self._events.append({"ph": "C", "pid": PID, "tid": tid, "name": name,
                             "ts": self._ts(), "args": dict(values)})

    # -------------------------------------------------------------- queries
    def open_spans(self) -> Dict[int, List[str]]:
        """Still-open spans per tid — empty when every span closed (the
        lifecycle invariant the tests assert after a drained workload)."""
        return {tid: list(s) for tid, s in self._stacks.items() if s}

    def events(self) -> List[dict]:
        return list(self._events)

    # --------------------------------------------------------------- export
    def chrome(self) -> dict:
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome(), f)


def validate_events(events: List[dict]) -> Dict[int, List[Tuple[str, float, float, int]]]:
    """Structural check of a finished trace-event stream: per-tid LIFO
    B/E pairing, no dangling opens, and non-decreasing timestamps per tid.
    Returns the reconstructed spans {tid: [(name, ts_begin, ts_end,
    depth)]}; raises AssertionError on any violation."""
    stacks: Dict[int, List[Tuple[str, float]]] = {}
    last_ts: Dict[int, float] = {}
    spans: Dict[int, List[Tuple[str, float, float, int]]] = {}
    for ev in events:
        tid = ev["tid"]
        ph = ev["ph"]
        if ph == "M":
            continue
        ts = ev["ts"]
        assert ts >= last_ts.get(tid, 0.0), (
            f"tid {tid}: timestamp went backwards ({ts} < {last_ts[tid]})")
        last_ts[tid] = ts
        if ph == "B":
            stacks.setdefault(tid, []).append((ev["name"], ts))
        elif ph == "E":
            stack = stacks.get(tid, [])
            assert stack, f"tid {tid}: E {ev['name']!r} with no open span"
            name, ts_b = stack.pop()
            assert name == ev["name"], (
                f"tid {tid}: E {ev['name']!r} does not match open span "
                f"{name!r} (mis-nesting)")
            spans.setdefault(tid, []).append((name, ts_b, ts, len(stack)))
        elif ph not in ("i", "C"):
            raise AssertionError(f"unexpected phase {ph!r}")
    dangling = {tid: [n for n, _ in s] for tid, s in stacks.items() if s}
    assert not dangling, f"spans never closed: {dangling}"
    return spans
