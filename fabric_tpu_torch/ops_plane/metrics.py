"""Metrics registry with Prometheus text exposition.

Reference parity: common/metrics/provider.go's Counter/Gauge/Histogram
abstraction + the prometheus provider.  Label support follows the same
With("name", value, ...) pairing convention.
"""

from __future__ import annotations

import bisect
import re
import threading
from typing import Dict, List, Optional, Tuple

_DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                    5.0, 10.0, float("inf"))

# prometheus data-model name rules (common/expfmt); metric names may
# carry colons (recording-rule convention), label names may not
_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
# label names validated once, then cached — _label_key sits on the
# dispatch/commit hot paths
_validated_labels: set = set()


def _check_metric_name(name: str) -> str:
    if not _METRIC_NAME_RE.match(name):
        raise ValueError(f"invalid metric name {name!r}")
    return name


def _label_key(pairs) -> Tuple:
    for k in pairs:
        if k not in _validated_labels:
            if not _LABEL_NAME_RE.match(k):
                raise ValueError(f"invalid label name {k!r}")
            _validated_labels.add(k)
    return tuple(sorted(pairs.items()))


def _escape_label_value(v) -> str:
    s = str(v)
    if "\\" in s or '"' in s or "\n" in s:
        s = (s.replace("\\", "\\\\").replace('"', '\\"')
             .replace("\n", "\\n"))
    return s


def _fmt_labels(key: Tuple, extra: str = "") -> str:
    parts = [f'{k}="{_escape_label_value(v)}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class Counter:
    def __init__(self, name: str, help_: str = ""):
        self.name = _check_metric_name(name)
        self.help = help_
        self._lock = threading.Lock()
        self._values: Dict[Tuple, float] = {}

    def add(self, delta: float = 1.0, **labels) -> None:
        k = _label_key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + delta

    def value(self, **labels) -> float:
        k = _label_key(labels)
        with self._lock:
            return self._values.get(k, 0.0)

    def total(self) -> float:
        """Sum across every label set (SLO-window rate source)."""
        with self._lock:
            return sum(self._values.values())

    def total_by(self, label: str) -> Dict[str, float]:
        """Totals grouped by one label's value (per-channel SLO source);
        label sets without `label` are skipped — they can't be
        attributed to any group."""
        out: Dict[str, float] = {}
        with self._lock:
            for k, v in self._values.items():
                lv = dict(k).get(label)
                if lv is None:
                    continue
                out[lv] = out.get(lv, 0.0) + v
        return out

    def breakdown(self, group: str, **fixed) -> Dict[str, float]:
        """Totals grouped by `group`'s label value, restricted to label
        sets carrying every `fixed` label at the given value (e.g. one
        channel's demotion counts by reason)."""
        out: Dict[str, float] = {}
        with self._lock:
            for k, v in self._values.items():
                d = dict(k)
                if any(d.get(fk) != fv for fk, fv in fixed.items()):
                    continue
                gv = d.get(group)
                if gv is None:
                    continue
                out[gv] = out.get(gv, 0.0) + v
        return out

    def expose(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} counter"]
        with self._lock:
            for k, v in sorted(self._values.items()):
                out.append(f"{self.name}{_fmt_labels(k)} {v}")
        return out


class Gauge:
    def __init__(self, name: str, help_: str = ""):
        self.name = _check_metric_name(name)
        self.help = help_
        self._lock = threading.Lock()
        self._values: Dict[Tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = value

    def add(self, delta: float = 1.0, **labels) -> None:
        k = _label_key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + delta

    def value(self, **labels) -> float:
        k = _label_key(labels)
        with self._lock:
            return self._values.get(k, 0.0)

    def values(self) -> Dict[Tuple, float]:
        """Snapshot of every label set (SLO breaker-fraction source)."""
        with self._lock:
            return dict(self._values)

    def mean_by(self, label: str) -> Dict[str, float]:
        """Per-label-value means (per-channel SLO source); label sets
        without `label` are skipped."""
        acc: Dict[str, List[float]] = {}
        with self._lock:
            for k, v in self._values.items():
                lv = dict(k).get(label)
                if lv is None:
                    continue
                a = acc.setdefault(lv, [0.0, 0.0])
                a[0] += v
                a[1] += 1.0
        return {lv: s / n for lv, (s, n) in acc.items()}

    def expose(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} gauge"]
        with self._lock:
            for k, v in sorted(self._values.items()):
                out.append(f"{self.name}{_fmt_labels(k)} {v}")
        return out


class Histogram:
    def __init__(self, name: str, help_: str = "",
                 buckets: Tuple[float, ...] = _DEFAULT_BUCKETS):
        self.name = _check_metric_name(name)
        self.help = help_
        self.buckets = tuple(buckets)
        self._lock = threading.Lock()
        self._counts: Dict[Tuple, List[int]] = {}
        self._sum: Dict[Tuple, float] = {}
        self._n: Dict[Tuple, int] = {}

    def observe(self, value: float, **labels) -> None:
        k = _label_key(labels)
        with self._lock:
            counts = self._counts.setdefault(k, [0] * len(self.buckets))
            i = bisect.bisect_left(self.buckets, value)
            if i < len(counts):
                counts[i] += 1
            self._sum[k] = self._sum.get(k, 0.0) + value
            self._n[k] = self._n.get(k, 0) + 1

    def state(self) -> Tuple[List[int], float, int]:
        """Aggregate (bucket counts, sum, n) across every label set.

        Cumulative snapshots of this feed the SLO evaluator's windowed
        quantiles (delta between two snapshots = the window's
        distribution).
        """
        with self._lock:
            counts = [0] * len(self.buckets)
            for per_key in self._counts.values():
                for i, c in enumerate(per_key):
                    counts[i] += c
            return counts, sum(self._sum.values()), sum(self._n.values())

    def state_by(self, label: str) -> Dict[str, Tuple[List[int], float, int]]:
        """Per-label-value (bucket counts, sum, n) — the `state()` shape
        grouped by one label (per-channel SLO quantiles); label sets
        without `label` are skipped."""
        acc: Dict[str, list] = {}
        with self._lock:
            for k, counts in self._counts.items():
                lv = dict(k).get(label)
                if lv is None:
                    continue
                a = acc.setdefault(lv, [[0] * len(self.buckets), 0.0, 0])
                for i, c in enumerate(counts):
                    a[0][i] += c
                a[1] += self._sum[k]
                a[2] += self._n[k]
        return {lv: (c, s, n) for lv, (c, s, n) in acc.items()}

    def expose(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        with self._lock:
            for k, counts in sorted(self._counts.items()):
                cum = 0
                for ub, c in zip(self.buckets, counts):
                    cum += c
                    le = "+Inf" if ub == float("inf") else repr(ub)
                    le_label = 'le="%s"' % le
                    out.append(f"{self.name}_bucket"
                               f"{_fmt_labels(k, le_label)} {cum}")
                out.append(f"{self.name}_sum{_fmt_labels(k)} {self._sum[k]}")
                out.append(f"{self.name}_count{_fmt_labels(k)} {self._n[k]}")
        return out


class MetricsRegistry:
    """Process metrics registry (the metrics.Provider role)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(name, lambda: Counter(name, help_), Counter)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(name, lambda: Gauge(name, help_), Gauge)

    def histogram(self, name: str, help_: str = "",
                  buckets: Tuple[float, ...] = _DEFAULT_BUCKETS) -> Histogram:
        return self._get(name, lambda: Histogram(name, help_, buckets),
                         Histogram)

    def get(self, name: str):
        """Registered metric by name, or None (read-only lookup)."""
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> Dict[str, object]:
        """Snapshot of the registered set, name -> metric (the
        timeseries sampler's sweep source — read-only)."""
        with self._lock:
            return dict(self._metrics)

    def _get(self, name, factory, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered "
                                f"as {type(m).__name__}")
            return m

    def expose_text(self) -> str:
        """Prometheus text exposition format (system.go:183 /metrics)."""
        with self._lock:
            metrics = list(self._metrics.values())
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"


registry = MetricsRegistry()     # the process default, like prometheus's
