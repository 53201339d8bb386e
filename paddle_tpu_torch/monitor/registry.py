"""Metrics registry: counters, gauges, histograms — thread-safe, zero-dep.

The measurement substrate of ``paddle_tpu_torch.monitor``, a copy of
``paddle_tpu/monitor/registry.py`` (same metric types, buckets, quantile
rule and exporters). Metric families carry optional labels,
Prometheus-style; exporters produce JSON and the Prometheus text
exposition format.

Design constraints: no third-party deps, safe to update from any thread
(one registry lock — updates are dict/float ops, contention is irrelevant
next to a device dispatch), and cheap enough to stay on by default
(``FLAGS_monitor``).
"""
from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricFamily",
           "MetricsRegistry", "get_registry", "counter", "gauge",
           "histogram", "metric_value", "reset"]

# default buckets sized for step/compile wall times in seconds
DEFAULT_TIME_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0)



class Counter:
    """Monotonic counter (one labeled child of a family)."""

    kind = "counter"

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a gauge")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self):
        return self.value


class Gauge:
    """Point-in-time value (one labeled child of a family)."""

    kind = "gauge"

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self):
        return self.value


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics) plus min/max."""

    kind = "histogram"

    def __init__(self, lock: threading.RLock,
                 buckets: Sequence[float] = DEFAULT_TIME_BUCKETS):
        self._lock = lock
        self._bounds = tuple(sorted(float(b) for b in buckets))
        self._bucket_counts = [0] * (len(self._bounds) + 1)  # +1: +Inf
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            self._min = v if self._min is None else min(self._min, v)
            self._max = v if self._max is None else max(self._max, v)
            idx = len(self._bounds)
            for i, b in enumerate(self._bounds):
                if v <= b:
                    idx = i
                    break
            self._bucket_counts[idx] += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> Optional[float]:
        """Estimate the ``q``-quantile (0 < q <= 1) from the cumulative
        buckets — Prometheus ``histogram_quantile`` semantics: linear
        interpolation inside the bucket the target rank lands in, with
        two honesty clamps the observed ``min``/``max`` make possible:
        the result never leaves ``[min, max]``, and ranks landing in the
        +Inf bucket report ``max`` instead of inventing an upper bound.
        None until something was observed."""
        if not 0.0 < q <= 1.0:
            raise ValueError(f"quantile must be in (0, 1], got {q}")
        with self._lock:
            if not self._count:
                return None
            target = q * self._count
            cum, lo = 0, 0.0
            for bound, c in zip(self._bounds, self._bucket_counts):
                if cum + c >= target:
                    est = lo + (bound - lo) * (target - cum) / c
                    return min(max(est, self._min), self._max)
                cum += c
                lo = bound
            return self._max

    def snapshot(self) -> dict:
        with self._lock:
            cum, cum_counts = 0, []
            for c in self._bucket_counts:
                cum += c
                cum_counts.append(cum)
            return {
                "count": self._count,
                "sum": self._sum,
                "min": self._min,
                "max": self._max,
                "avg": (self._sum / self._count) if self._count else None,
                # estimated quantiles ride along so every JSON snapshot
                # gets SLO percentiles for free; the registry lock is an
                # RLock, so the nested
                # quantile() calls see the same consistent state
                "p50": self.quantile(0.5),
                "p99": self.quantile(0.99),
                "buckets": {**{repr(b): c for b, c in
                               zip(self._bounds, cum_counts)},
                            "+Inf": self._count},
            }


class MetricFamily:
    """One metric name; children per label-set. The empty-label child is
    the family's own value, so ``registry.counter("x").inc()`` works with
    no labels() dance."""

    def __init__(self, name: str, cls, lock: threading.RLock, help: str = "",
                 **kwargs):
        self.name = name
        self.help = help
        self._cls = cls
        self._kwargs = kwargs
        self._lock = lock
        self._children: Dict[Tuple[Tuple[str, str], ...], object] = {}

    @property
    def kind(self) -> str:
        return self._cls.kind

    def labels(self, **kv):
        key = tuple(sorted((str(k), str(v)) for k, v in kv.items()))
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._cls(self._lock, **self._kwargs)
                self._children[key] = child
            return child

    # convenience: family-level ops act on the empty-label child
    def inc(self, n: float = 1.0):
        return self.labels().inc(n)

    def set(self, v: float):
        return self.labels().set(v)

    def dec(self, n: float = 1.0):
        return self.labels().dec(n)

    def observe(self, v: float):
        return self.labels().observe(v)

    @property
    def value(self):
        return self.labels().value

    def children(self) -> List[Tuple[Dict[str, str], object]]:
        with self._lock:
            return [(dict(k), c) for k, c in self._children.items()]


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.RLock()
        self._families: Dict[str, MetricFamily] = {}

    def _family(self, name: str, cls, help: str, **kwargs) -> MetricFamily:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = MetricFamily(name, cls, self._lock, help=help, **kwargs)
                self._families[name] = fam
            elif fam.kind != cls.kind:
                raise TypeError(
                    f"metric '{name}' already registered as {fam.kind}, "
                    f"cannot re-register as {cls.kind}")
            return fam

    def counter(self, name: str, help: str = "") -> MetricFamily:
        return self._family(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> MetricFamily:
        return self._family(name, Gauge, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS
                  ) -> MetricFamily:
        return self._family(name, Histogram, help, buckets=buckets)

    def get(self, name: str) -> Optional[MetricFamily]:
        with self._lock:
            return self._families.get(name)

    def families(self) -> List[MetricFamily]:
        with self._lock:
            return list(self._families.values())

    def reset(self) -> None:
        with self._lock:
            self._families.clear()

    # -- exporters -------------------------------------------------------
    def to_dict(self) -> dict:
        out = {}
        for fam in self.families():
            out[fam.name] = {
                "kind": fam.kind,
                "help": fam.help,
                "values": [{"labels": labels, "value": child.snapshot()}
                           for labels, child in fam.children()],
            }
        return out

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: List[str] = []
        for fam in self.families():
            if fam.help:
                lines.append(f"# HELP {fam.name} {_esc_help(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for labels, child in fam.children():
                if fam.kind == "histogram":
                    snap = child.snapshot()
                    for le, c in snap["buckets"].items():
                        lines.append(_sample(fam.name + "_bucket",
                                             {**labels, "le": le}, c))
                    lines.append(_sample(fam.name + "_sum", labels,
                                         snap["sum"]))
                    lines.append(_sample(fam.name + "_count", labels,
                                         snap["count"]))
                else:
                    lines.append(_sample(fam.name, labels, child.value))
        return "\n".join(lines) + ("\n" if lines else "")


def _esc_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _esc_label(s: str) -> str:
    return (s.replace("\\", "\\\\").replace('"', '\\"')
             .replace("\n", "\\n"))


def _sample(name: str, labels: Dict[str, str], value) -> str:
    label_str = ",".join(f'{k}="{_esc_label(str(v))}"'
                         for k, v in sorted(labels.items()))
    body = f"{name}{{{label_str}}}" if label_str else name
    if isinstance(value, float) and value == int(value):
        value = int(value)
    return f"{body} {value}"


# -- default registry -----------------------------------------------------

_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _default_registry


def counter(name: str, help: str = "") -> MetricFamily:
    return _default_registry.counter(name, help)


def gauge(name: str, help: str = "") -> MetricFamily:
    return _default_registry.gauge(name, help)


def histogram(name: str, help: str = "",
              buckets: Sequence[float] = DEFAULT_TIME_BUCKETS) -> MetricFamily:
    return _default_registry.histogram(name, help, buckets=buckets)


def metric_value(name: str, default=0.0, **labels):
    """Scalar value of a counter/gauge child (histograms: the snapshot
    dict). ``default`` when the metric or label-set was never touched."""
    fam = _default_registry.get(name)
    if fam is None:
        return default
    key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
    with fam._lock:
        child = fam._children.get(key)
    return default if child is None else child.snapshot()


def reset() -> None:
    _default_registry.reset()
