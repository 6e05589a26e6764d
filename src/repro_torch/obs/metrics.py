"""Counters, gauges and fixed-bucket latency histograms.

The paper's evaluation is an accounting story (GFLOP/s, MTEPS, bytes/nnz)
and the ROADMAP's serving SLO item needs p50/p99 — both want the same
substrate: named metrics that concurrent threads can update cheaply and a
scraper can read consistently.  Pure stdlib (no numpy, no torch) so encode
worker processes can import it.

* :class:`Counter` — monotone by convention, but ``add`` accepts negative
  deltas because the service's flush-failure rollback must be able to
  retract a dispatched batch's stats.  Optional labels (e.g. the
  per-ticket-owner ``results_dropped`` accounting).
* :class:`Gauge` — last-written value per label set.
* :class:`Histogram` — fixed upper-bound buckets (Prometheus ``le``
  semantics: a value equal to a bound lands in that bound's bucket) for
  exposition, plus a bounded ring of raw observations so
  :meth:`Histogram.percentile` answers **exact** p50/p95/p99 over the
  retained window (every observation until ``max_samples``, the most
  recent window after).  ``bucket_percentile`` is the classic
  interpolated estimate for when sample retention is off.
* :class:`MetricsRegistry` — name → metric, get-or-create, with
  ``prometheus_text()`` exposition.  ``REGISTRY`` is the process-global
  default; serving components default to a private registry per instance
  so two services never alias each other's counters — pass
  ``metrics=obs.REGISTRY`` to scrape them all from one page.
"""
from __future__ import annotations

import bisect
import math
import threading
from collections import OrderedDict, deque

# Exponential-ish latency bucket bounds in seconds: 10 µs .. 10 s.
DEFAULT_LATENCY_BUCKETS = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0)


def _label_key(labels: dict) -> tuple:
    # Unlabeled is the hot path (every per-dispatch counter add): skip
    # the items()/sorted() allocations.
    return tuple(sorted(labels.items())) if labels else ()


def _label_str(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in key)
    return "{%s}" % inner


class Metric:
    kind = "untyped"

    def __init__(self, name: str, description: str = ""):
        if not name or not name.replace("_", "a").isalnum():
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.description = description
        self._lock = threading.Lock()


class Counter(Metric):
    kind = "counter"

    def __init__(self, name: str, description: str = ""):
        super().__init__(name, description)
        self._values: dict[tuple, float] = {}

    def inc(self, n: float = 1.0, **labels) -> None:
        self.add(n, **labels)

    def add(self, n: float, **labels) -> None:
        """Add ``n`` (may be negative: the flush-rollback path retracts
        already-counted work so snapshots read as if it never ran)."""
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self._values.values())

    def items(self) -> dict:
        """{label dict as tuple-of-pairs: value} snapshot."""
        with self._lock:
            return dict(self._values)


class Gauge(Metric):
    kind = "gauge"

    def __init__(self, name: str, description: str = ""):
        super().__init__(name, description)
        self._values: dict[tuple, float] = {}

    def set(self, v: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(v)

    def add(self, n: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def items(self) -> dict:
        with self._lock:
            return dict(self._values)


class Histogram(Metric):
    """Fixed-bucket histogram + bounded raw-sample ring.

    ``buckets`` are ascending upper bounds (``le``, inclusive); the
    overflow bucket (``+Inf``) is implicit.  ``max_samples`` bounds the
    raw ring that backs exact percentiles; 0 disables retention and
    ``percentile`` falls back to bucket interpolation.
    """

    kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 buckets=DEFAULT_LATENCY_BUCKETS,
                 max_samples: int = 65536):
        super().__init__(name, description)
        b = tuple(float(x) for x in buckets)
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError("buckets must be strictly ascending and "
                             "non-empty")
        self.buckets = b
        self._counts = [0] * (len(b) + 1)   # last = overflow (+Inf)
        self._sum = 0.0
        self._count = 0
        self._samples = (deque(maxlen=int(max_samples))
                         if max_samples > 0 else None)

    def observe(self, v: float) -> None:
        v = float(v)
        # bisect_left: v equal to a bound lands in that bound's bucket
        # (Prometheus `le` is an inclusive upper bound).
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if self._samples is not None:
                self._samples.append(v)

    # -- queries ----------------------------------------------------------
    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def bucket_counts(self) -> list[int]:
        """Per-bucket (non-cumulative) counts incl. the +Inf overflow."""
        with self._lock:
            return list(self._counts)

    def percentile(self, p: float) -> float:
        """Exact p-th percentile (nearest-rank) over the retained samples
        — every observation while ``count <= max_samples``, the most
        recent window after.  Bucket interpolation when retention is off;
        0.0 when empty."""
        if not 0 < p <= 100:
            raise ValueError("p must be in (0, 100]")
        with self._lock:
            samples = (sorted(self._samples)
                       if self._samples is not None else None)
        if samples is None:
            return self.bucket_percentile(p)
        if not samples:
            return 0.0
        rank = max(1, math.ceil(p / 100.0 * len(samples)))
        return samples[rank - 1]

    def bucket_percentile(self, p: float) -> float:
        """Estimated percentile from bucket counts alone: linear
        interpolation inside the target bucket (overflow clamps to the
        last finite bound)."""
        if not 0 < p <= 100:
            raise ValueError("p must be in (0, 100]")
        with self._lock:
            counts = list(self._counts)
            total = self._count
        if total == 0:
            return 0.0
        target = p / 100.0 * total
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= target:
                if i >= len(self.buckets):      # overflow bucket
                    return self.buckets[-1]
                lo = self.buckets[i - 1] if i else 0.0
                hi = self.buckets[i]
                return lo + (hi - lo) * (target - cum) / c
            cum += c
        return self.buckets[-1]


class MetricsRegistry:
    """Name → metric, with get-or-create constructors and exposition."""

    def __init__(self):
        self._metrics: "OrderedDict[str, Metric]" = OrderedDict()
        self._lock = threading.Lock()

    def register(self, metric: Metric) -> Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                if type(existing) is not type(metric):
                    raise ValueError(
                        f"metric {metric.name!r} already registered as "
                        f"{existing.kind}")
                return existing
            self._metrics[metric.name] = metric
            return metric

    def _get_or_create(self, cls, name, description, **kw) -> Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}, wanted {cls.kind}")
                return existing
            metric = cls(name, description, **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, description: str = "") -> Counter:
        return self._get_or_create(Counter, name, description)

    def gauge(self, name: str, description: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, description)

    def histogram(self, name: str, description: str = "",
                  buckets=DEFAULT_LATENCY_BUCKETS,
                  max_samples: int = 65536) -> Histogram:
        return self._get_or_create(Histogram, name, description,
                                   buckets=buckets,
                                   max_samples=max_samples)

    def get(self, name: str) -> Metric:
        with self._lock:
            return self._metrics[name]

    def names(self) -> list[str]:
        with self._lock:
            return list(self._metrics)

    def snapshot(self) -> dict:
        """{name: plain-data summary} — counters/gauges as label→value,
        histograms as count/sum/percentiles."""
        with self._lock:
            metrics = list(self._metrics.values())
        out = {}
        for m in metrics:
            if isinstance(m, (Counter, Gauge)):
                items = m.items()
                out[m.name] = {
                    "kind": m.kind,
                    "total": sum(items.values()),
                    "values": {_label_str(k) or "": v
                               for k, v in items.items()},
                }
            elif isinstance(m, Histogram):
                out[m.name] = {
                    "kind": m.kind, "count": m.count, "sum": m.sum,
                    "p50": m.percentile(50), "p95": m.percentile(95),
                    "p99": m.percentile(99),
                }
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (one scrape page)."""
        with self._lock:
            metrics = list(self._metrics.values())
        lines = []
        for m in metrics:
            if m.description:
                lines.append(f"# HELP {m.name} {m.description}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, (Counter, Gauge)):
                items = m.items() or {(): 0.0}
                for key, v in sorted(items.items()):
                    lines.append(f"{m.name}{_label_str(key)} {_fmt(v)}")
            elif isinstance(m, Histogram):
                counts = m.bucket_counts()
                cum = 0
                for bound, c in zip(m.buckets, counts):
                    cum += c
                    lines.append(
                        f'{m.name}_bucket{{le="{_fmt(bound)}"}} {cum}')
                cum += counts[-1]
                lines.append(f'{m.name}_bucket{{le="+Inf"}} {cum}')
                lines.append(f"{m.name}_sum {_fmt(m.sum)}")
                lines.append(f"{m.name}_count {m.count}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    """Trim floats that are exact integers (Prometheus-style)."""
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


# Process-global default registry (serving components keep private ones by
# default; pass metrics=REGISTRY to aggregate them on one scrape page).
REGISTRY = MetricsRegistry()


def prometheus_text(registry: MetricsRegistry | None = None) -> str:
    return (registry or REGISTRY).prometheus_text()
