# Port of src/repro/obs/metrics.py: a copy with its imports rewired to repro_torch.
"""Serving metrics registry: labelled counters / gauges / histograms.

This is the engine's single accounting substrate. Three design constraints
shape it (docs/observability.md):

  * NEAR-ZERO-COST RECORDING — an instrument is resolved once (e.g. in
    ``ServeEngine.__init__``) and recording is a plain float add on a
    ``__slots__`` attribute. No label-dict hashing, no locks, no string
    formatting on the hot path.
  * STATS ARE DERIVED, NOT PARALLEL — ``ServeEngine.stats()`` is computed
    FROM the registry. Histograms therefore retain their raw observations
    in insertion order (``keep_raw``), so the legacy percentile math
    (numpy over the exact same array) stays bit-identical to the
    pre-registry implementation (pinned by tests/test_obs.py).
  * EXPORT IS A SIDE CHANNEL — Prometheus text exposition
    (`exposition` / `write_prom`) and JSONL snapshots (`write_jsonl`) for
    diffable CI artifacts; `parse_prom` round-trips the exposition for
    tests and offline diffing.

A disabled registry (``MetricsRegistry(enabled=False)``, or the module
singleton `NULL_REGISTRY`) hands out one shared no-op instrument, so call
sites never branch on whether observability is on — the ``ObsConfig``
guarantee that telemetry cannot perturb the measured system reduces to
"a no-op method call per event".

Single-threaded by design, like the engine's tick loop: no locks. The
registry is per-engine, not a process global, so two engines (e.g. the
bench's fp16 vs AMS runs) never share counters.
"""

from __future__ import annotations

import json
import re
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

# bucket defaults: engine ticks are ~ms on CPU, ~100us on device
TIME_BUCKETS = (1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5, 1.0, 5.0)
COUNT_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)


class _NullInstrument:
    """Shared no-op stand-in for every instrument of a disabled registry."""

    __slots__ = ()
    value = 0.0
    total = 0.0
    count = 0
    sum = 0.0

    def labels(self, **kv):
        return self

    def inc(self, n: float = 1.0):
        pass

    def dec(self, n: float = 1.0):
        pass

    def set(self, v: float):
        pass

    def observe(self, v: float):
        pass

    def raw_values(self) -> List[float]:
        return []


NULL_INSTRUMENT = _NullInstrument()


class _CounterChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0):
        self.value += n


class _GaugeChild:
    __slots__ = ("_value", "fn")

    def __init__(self, fn: Optional[Callable[[], float]] = None):
        self._value = 0.0
        self.fn = fn

    def set(self, v: float):
        self._value = float(v)

    def inc(self, n: float = 1.0):
        self._value += n

    def dec(self, n: float = 1.0):
        self._value -= n

    @property
    def value(self) -> float:
        return float(self.fn()) if self.fn is not None else self._value


class _HistogramChild:
    __slots__ = ("buckets", "counts", "sum", "count", "raw")

    def __init__(self, buckets: Tuple[float, ...], keep_raw: bool):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)   # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0
        # insertion-order raw observations — the bit-identical stats() path
        self.raw: Optional[List[float]] = [] if keep_raw else None

    def observe(self, v: float):
        v = float(v)
        self.sum += v
        self.count += 1
        if self.raw is not None:
            self.raw.append(v)
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def raw_values(self) -> List[float]:
        return self.raw if self.raw is not None else []


class _Family:
    """One named metric with zero or more labelled children."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", labelnames: Iterable[str] = ()):
        if not re.fullmatch(r"[a-zA-Z_:][a-zA-Z0-9_:]*", name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], object] = {}

    def _make_child(self):
        raise NotImplementedError

    def labels(self, **kv):
        if set(kv) != set(self.labelnames):
            raise ValueError(f"{self.name}: expected labels "
                             f"{self.labelnames}, got {tuple(kv)}")
        key = tuple(str(kv[n]) for n in self.labelnames)
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = self._make_child()
        return child

    def _default(self):
        """The unlabelled child — only valid for label-less families."""
        if self.labelnames:
            raise ValueError(f"{self.name} requires labels {self.labelnames}")
        return self.labels()

    def children(self) -> Iterable[Tuple[Tuple[str, ...], object]]:
        return self._children.items()

    def reset(self):
        for child in self._children.values():
            if isinstance(child, _CounterChild):
                child.value = 0.0
            elif isinstance(child, _GaugeChild):
                child._value = 0.0      # callback gauges keep their fn
            elif isinstance(child, _HistogramChild):
                child.counts = [0] * (len(child.buckets) + 1)
                child.sum = 0.0
                child.count = 0
                if child.raw is not None:
                    child.raw = []


class Counter(_Family):
    kind = "counter"

    def _make_child(self):
        return _CounterChild()

    def inc(self, n: float = 1.0):
        self._default().inc(n)

    @property
    def value(self) -> float:
        return self._default().value

    @property
    def total(self) -> float:
        """Sum across every labelled child."""
        return sum(c.value for c in self._children.values())


class Gauge(_Family):
    kind = "gauge"

    def __init__(self, name, help="", labelnames=(),
                 fn: Optional[Callable[[], float]] = None):
        super().__init__(name, help, labelnames)
        if fn is not None and self.labelnames:
            raise ValueError("callback gauges cannot have labels")
        self._fn = fn

    def _make_child(self):
        return _GaugeChild(self._fn)

    def set(self, v: float):
        self._default().set(v)

    def inc(self, n: float = 1.0):
        self._default().inc(n)

    def dec(self, n: float = 1.0):
        self._default().dec(n)

    @property
    def value(self) -> float:
        return self._default().value


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name, help="", labelnames=(),
                 buckets: Tuple[float, ...] = TIME_BUCKETS,
                 keep_raw: bool = True):
        super().__init__(name, help, labelnames)
        bl = tuple(sorted(float(b) for b in buckets))
        if len(set(bl)) != len(bl) or not bl:
            raise ValueError(f"{name}: buckets must be non-empty and unique")
        self.buckets = bl
        self.keep_raw = keep_raw

    def _make_child(self):
        return _HistogramChild(self.buckets, self.keep_raw)

    def observe(self, v: float):
        self._default().observe(v)

    def raw_values(self) -> List[float]:
        return self._default().raw_values()

    @property
    def count(self) -> int:
        return self._default().count

    @property
    def sum(self) -> float:
        return self._default().sum


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _esc(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labelstr(names: Tuple[str, ...], values: Tuple[str, ...],
              extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = [f'{n}="{_esc(v)}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_esc(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


class MetricsRegistry:
    """Name -> metric family; the factory call sites register through.

    ``counter``/``gauge``/``histogram`` are get-or-create: registering the
    same name twice returns the SAME family (type/labels must match), so
    subsystems sharing one engine registry (scheduler, allocator, drafter)
    can resolve their instruments independently.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._families: Dict[str, _Family] = {}

    def _get(self, cls, name, help, labelnames, **kw):
        if not self.enabled:
            return NULL_INSTRUMENT
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = cls(name, help, labelnames, **kw)
        elif type(fam) is not cls or fam.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind} with "
                f"labels {fam.labelnames}")
        return fam

    def counter(self, name: str, help: str = "",
                labelnames: Iterable[str] = ()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Iterable[str] = (),
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        return self._get(Gauge, name, help, labelnames, fn=fn)

    def histogram(self, name: str, help: str = "",
                  labelnames: Iterable[str] = (),
                  buckets: Tuple[float, ...] = TIME_BUCKETS,
                  keep_raw: bool = True) -> Histogram:
        return self._get(Histogram, name, help, labelnames,
                         buckets=buckets, keep_raw=keep_raw)

    # -------------------------------------------------------------- queries
    def value(self, name: str, **labels) -> float:
        """Current value of a counter/gauge child (0.0 when absent) — the
        lookup API the live ticker and ad-hoc readers use. For histograms
        returns the observation count."""
        fam = self._families.get(name)
        if fam is None:
            return 0.0
        key = tuple(str(labels[n]) for n in fam.labelnames)
        child = fam._children.get(key)
        if child is None:
            return 0.0
        if isinstance(child, _HistogramChild):
            return float(child.count)
        return float(child.value)

    def collect(self) -> List[_Family]:
        return [self._families[n] for n in sorted(self._families)]

    def reset(self) -> None:
        """Zero every child (counters/gauges/histograms); registrations and
        callback gauges survive — `ServeEngine.reset_metrics` uses this
        after jit warmup."""
        for fam in self._families.values():
            fam.reset()

    # --------------------------------------------------------------- export
    def exposition(self) -> str:
        """Prometheus text exposition format, version 0.0.4."""
        lines: List[str] = []
        for fam in self.collect():
            if fam.help:
                lines.append(f"# HELP {fam.name} {_esc(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            if not fam._children and not fam.labelnames:
                fam._default()          # materialize the unlabelled child
            for key, child in sorted(fam.children()):
                if isinstance(child, _HistogramChild):
                    cum = 0
                    for b, c in zip(child.buckets, child.counts):
                        cum += c
                        ls = _labelstr(fam.labelnames, key,
                                       (("le", _fmt(b)),))
                        lines.append(f"{fam.name}_bucket{ls} {cum}")
                    ls = _labelstr(fam.labelnames, key, (("le", "+Inf"),))
                    lines.append(f"{fam.name}_bucket{ls} {child.count}")
                    ls = _labelstr(fam.labelnames, key)
                    lines.append(f"{fam.name}_sum{ls} {_fmt(child.sum)}")
                    lines.append(f"{fam.name}_count{ls} {child.count}")
                else:
                    ls = _labelstr(fam.labelnames, key)
                    lines.append(f"{fam.name}{ls} {_fmt(child.value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, dict]:
        """JSON-friendly dump of every family and child."""
        out: Dict[str, dict] = {}
        for fam in self.collect():
            rows = []
            for key, child in sorted(fam.children()):
                row: Dict[str, object] = {
                    "labels": dict(zip(fam.labelnames, key))}
                if isinstance(child, _HistogramChild):
                    row.update(sum=child.sum, count=child.count,
                               buckets=list(child.buckets),
                               counts=list(child.counts))
                else:
                    row["value"] = child.value
                rows.append(row)
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "values": rows}
        return out

    def write_prom(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.exposition())

    def write_jsonl(self, path: str, extra: Optional[dict] = None) -> None:
        """Append one snapshot line — a time series accumulates across
        runs/ticks of the same file."""
        rec = {"ts": time.time(), **(extra or {}), "metrics": self.snapshot()}
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")


NULL_REGISTRY = MetricsRegistry(enabled=False)

_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})?\s+(\S+)$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prom(text: str) -> Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float]:
    """Parse Prometheus text exposition into {(name, sorted label items):
    value} — the round-trip half of `MetricsRegistry.exposition`, used by
    the tests and for offline snapshot diffing."""
    out: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"unparseable exposition line: {line!r}")
        name, _, labelblob, value = m.groups()
        labels = []
        for lm in _LABEL_RE.finditer(labelblob or ""):
            v = lm.group(2).replace('\\"', '"').replace("\\n", "\n") \
                           .replace("\\\\", "\\")
            labels.append((lm.group(1), v))
        v = float("inf") if value == "+Inf" else float(value)
        out[(name, tuple(sorted(labels)))] = v
    return out


def ticker_line(eng) -> str:
    """One-line live status for demo loops (examples/serve_continuous.py),
    sourced from the engine's registry: active slots / queue, prefix hit
    rate, speculative accept rate, and measured-vs-floor KV bytes."""
    m = eng.metrics
    hits = m.value("alloc_prefix_hit_pages_total")
    looked = hits + m.value("alloc_prefix_miss_pages_total")
    prop = m.value("serve_spec_proposed_total")
    acc = m.value("serve_spec_accepted_total")
    floor_b = m.value("serve_kv_floor_bytes_total")
    ach_b = m.value("serve_kv_achieved_bytes_total")
    return (f"tick {eng.tick:4d} | act {eng.active_count}/{eng.slots} "
            f"q{eng.sched.queue_depth}"
            f" | hit {hits / looked if looked else 0.0:4.0%}"
            f" | acc {acc / prop if prop else 0.0:4.0%}"
            f" | kv {eng.kv_bytes_per_token()} B/tok"
            f" | hbm {ach_b / floor_b if floor_b else 0.0:4.1f}x floor")
