"""Metric time-series history: bounded ring store + leak-slope gate.

The registry (`ops_plane.metrics`) is cumulative and instantaneous —
`/metrics` answers "what is the value now", never "how did it get
here".  This module adds the missing axis: a per-node ring store that
samples every registered Counter/Gauge/Histogram on a configurable
cadence and keeps three tiers of history with increasing reach and
decreasing resolution:

  raw   one point per sample            (default 10 min @ 1 s)
  1m    min/mean/max per 60 s bucket    (default 2 h)
  10m   min/mean/max per 600 s bucket   (default 24 h)

Raw points are appended on every sample; a coarse bucket is flushed the
first time a sample lands past its end, so downsampling is O(1) per
sample and the store's footprint is fixed by config, not uptime.

Served as `GET /metrics/history?name=<series>&window=<seconds>` on the
ops server (tier auto-selected from the window, or forced with
`&tier=raw|1m|10m`) and consumed by `node.top --spark` sparklines.

The same history feeds the long-soak leak gate (ROADMAP direction #4):
`theil_sen` is a median-of-pairwise-slopes estimator — robust to the
sawtooth a GC or ring eviction leaves in RSS — with Sen's
normal-approximation confidence interval, and `assess_leak` turns a
series into a verdict: leaking only when the slope CI excludes zero
AND the projected growth over the window is a material fraction of the
series' level (a one-time step or allocator jitter never fires, a
steady climb does).  `workload/scenarios.py` wires this as the
`leak_free` expect kind.

Everything here is off the hot path: the sampler thread reads the same
cumulative snapshots the SLO evaluator reads (`Counter.total`,
`Gauge.values`, `Histogram.state`), so observing code pays nothing new.
Nodes construct the store only when the `timeseries` config sub-dict
enables it — disabled, there is no thread, no ring, and no route.
"""

from __future__ import annotations

import math
import statistics
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .metrics import registry as default_registry

__all__ = ["TimeSeriesStore", "theil_sen", "assess_leak",
           "evaluate_leak_gate", "register_routes"]

# (tier name, bucket width seconds); raw is width 0 (no bucketing)
_COARSE_TIERS: Tuple[Tuple[str, float], ...] = (("1m", 60.0),
                                                ("10m", 600.0))


class _Series:
    """One metric's rings: raw points + per-tier bucket accumulators."""

    __slots__ = ("raw", "coarse", "_acc")

    def __init__(self, raw_len: int, coarse_lens: Dict[str, int]):
        self.raw: deque = deque(maxlen=raw_len)
        self.coarse: Dict[str, deque] = {
            tier: deque(maxlen=n) for tier, n in coarse_lens.items()}
        # tier -> [bucket_start, min, max, sum, n] (open bucket)
        self._acc: Dict[str, Optional[list]] = {
            tier: None for tier in coarse_lens}

    def record(self, now: float, value: float) -> None:
        self.raw.append((now, value))
        for tier, width in _COARSE_TIERS:
            if tier not in self.coarse:
                continue
            bucket = math.floor(now / width) * width
            acc = self._acc[tier]
            if acc is not None and acc[0] != bucket:
                self.coarse[tier].append(
                    (acc[0], acc[3] / acc[4], acc[1], acc[2]))
                acc = None
            if acc is None:
                self._acc[tier] = [bucket, value, value, value, 1]
            else:
                acc[1] = min(acc[1], value)
                acc[2] = max(acc[2], value)
                acc[3] += value
                acc[4] += 1


class TimeSeriesStore:
    """Bounded ring store over a MetricsRegistry, with tiered history.

    Config keys (the node's `timeseries` sub-dict):
      enabled        node-level gate (read by the node, not here)
      interval_s     sampling cadence            (default 1.0)
      raw_window_s   raw-tier retention          (default 600)
      m1_window_s    1m-tier retention           (default 7200)
      m10_window_s   10m-tier retention          (default 86400)
    """

    def __init__(self, cfg: Optional[dict] = None, *,
                 registry: Optional[MetricsRegistry] = None,
                 clock=None):
        cfg = dict(cfg or {})
        self.registry = registry or default_registry
        self._clock = clock or time.monotonic
        self.interval_s = max(0.05, float(cfg.get("interval_s", 1.0)))
        self.raw_window_s = float(cfg.get("raw_window_s", 600.0))
        self.m1_window_s = float(cfg.get("m1_window_s", 7200.0))
        self.m10_window_s = float(cfg.get("m10_window_s", 86400.0))
        self._raw_len = max(
            8, int(math.ceil(self.raw_window_s / self.interval_s)) + 2)
        self._coarse_lens = {
            "1m": max(4, int(math.ceil(self.m1_window_s / 60.0)) + 2),
            "10m": max(4, int(math.ceil(self.m10_window_s / 600.0)) + 2),
        }
        self._series: Dict[str, _Series] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- writing -------------------------------------------------------------

    def record(self, name: str, value: float,
               now: Optional[float] = None) -> None:
        """Append one point (extra series beyond the registry sweep)."""
        now = self._clock() if now is None else now
        with self._lock:
            s = self._series.get(name)
            if s is None:
                s = _Series(self._raw_len, self._coarse_lens)
                self._series[name] = s
            s.record(now, float(value))

    def sample(self, now: Optional[float] = None) -> None:
        """One sweep over every registered metric.

        Counters record their cross-label total, gauges the mean over
        label sets (a single unlabelled gauge records itself), and a
        histogram contributes `<name>_count` + `<name>_sum` — enough to
        derive windowed rates and means client-side.
        """
        now = self._clock() if now is None else now
        for name, m in self.registry.metrics().items():
            if isinstance(m, Counter):
                self.record(name, m.total(), now)
            elif isinstance(m, Gauge):
                vals = m.values()
                if vals:
                    self.record(name, sum(vals.values()) / len(vals), now)
            elif isinstance(m, Histogram):
                _, total, n = m.state()
                self.record(name + "_count", n, now)
                self.record(name + "_sum", total, now)

    # -- reading -------------------------------------------------------------

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def _pick_tier(self, window_s: float) -> str:
        if window_s <= self.raw_window_s:
            return "raw"
        if window_s <= self.m1_window_s:
            return "1m"
        return "10m"

    def history(self, name: str, window_s: Optional[float] = None,
                tier: Optional[str] = None,
                now: Optional[float] = None) -> dict:
        """Points for one series: raw tier as [t, v], coarse tiers as
        [bucket_start, mean, min, max]; only points inside the window
        (ending at `now`) are returned."""
        now = self._clock() if now is None else now
        window_s = self.raw_window_s if window_s is None else float(window_s)
        tier = tier or self._pick_tier(window_s)
        if tier not in ("raw", "1m", "10m"):
            raise ValueError(f"unknown tier {tier!r}")
        lo = now - window_s
        with self._lock:
            s = self._series.get(name)
            if s is None:
                pts: List[list] = []
            elif tier == "raw":
                pts = [[t, v] for t, v in s.raw if t >= lo]
            else:
                pts = [[t, mean, mn, mx]
                       for t, mean, mn, mx in s.coarse[tier] if t >= lo]
                acc = s._acc.get(tier)
                if acc is not None and acc[0] >= lo:
                    # the open bucket: partial, but the freshest data
                    pts.append([acc[0], acc[3] / acc[4], acc[1], acc[2]])
        return {"name": name, "tier": tier, "window_s": window_s,
                "interval_s": self.interval_s, "now": now, "points": pts}

    # -- lifecycle -----------------------------------------------------------

    def step(self) -> None:
        self.sample()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample()
            except Exception:       # keep the sampler alive
                import logging
                logging.getLogger(__name__).exception(
                    "timeseries sample failed")

    def start(self) -> "TimeSeriesStore":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="timeseries-sampler", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


# ---------------------------------------------------------------------------
# leak-slope estimation (Theil–Sen + Sen's CI)

def theil_sen(points) -> Optional[dict]:
    """Median of all pairwise slopes with Sen's 95% confidence interval
    (normal approximation of Kendall's S).  `points` is a sequence of
    (t, v); returns None with fewer than 2 distinct timestamps.

    O(n^2) in the point count — callers feed windowed history (a few
    hundred points), never the unbounded series.
    """
    pts = sorted((float(t), float(v)) for t, v in points)
    n = len(pts)
    slopes: List[float] = []
    for i in range(n):
        ti, vi = pts[i]
        for j in range(i + 1, n):
            dt = pts[j][0] - ti
            if dt > 0:
                slopes.append((pts[j][1] - vi) / dt)
    if not slopes:
        return None
    slopes.sort()
    big_n = len(slopes)
    slope = statistics.median(slopes)
    sigma = math.sqrt(n * (n - 1) * (2 * n + 5) / 18.0)
    c = 1.96 * sigma
    lo_i = max(0, min(big_n - 1, int(math.floor((big_n - c) / 2.0))))
    hi_i = max(0, min(big_n - 1, int(math.ceil((big_n + c) / 2.0))))
    return {"slope": slope, "ci_lo": slopes[lo_i], "ci_hi": slopes[hi_i],
            "n_points": n, "n_slopes": big_n}


def assess_leak(points, *, max_growth_frac: float = 0.05,
                min_points: int = 8, warmup_s: float = 0.0) -> dict:
    """Leak verdict for one series' windowed points.

    Leaking iff the Theil–Sen slope CI excludes zero from below AND the
    slope projected over the observed span grows the series by more
    than `max_growth_frac` of its mean level — so a one-time step, GC
    sawtooth, or allocator jitter never fires, while a steady climb
    does.  `warmup_s` drops the head of the window (startup ramps are
    not leaks).
    """
    pts = sorted((float(t), float(v)) for t, v in points)
    if warmup_s > 0.0 and pts:
        t0 = pts[0][0]
        pts = [(t, v) for t, v in pts if t >= t0 + warmup_s]
    if len(pts) < min_points:
        return {"leaking": False, "verdict": "insufficient_data",
                "n_points": len(pts), "min_points": min_points}
    est = theil_sen(pts)
    if est is None:
        return {"leaking": False, "verdict": "insufficient_data",
                "n_points": len(pts), "min_points": min_points}
    span_s = pts[-1][0] - pts[0][0]
    mean_level = sum(v for _, v in pts) / len(pts)
    projected = est["slope"] * span_s
    growth_frac = projected / max(abs(mean_level), 1e-9)
    leaking = bool(est["ci_lo"] > 0.0 and growth_frac > max_growth_frac)
    return {
        "leaking": leaking,
        "verdict": "leaking" if leaking else "flat",
        "slope_per_s": est["slope"],
        "ci_lo": est["ci_lo"], "ci_hi": est["ci_hi"],
        "span_s": span_s, "n_points": est["n_points"],
        "mean_level": mean_level,
        "projected_growth": projected,
        "growth_frac": growth_frac,
        "max_growth_frac": max_growth_frac,
    }


def evaluate_leak_gate(store: TimeSeriesStore, series: Dict[str, dict],
                       window_s: Optional[float] = None,
                       now: Optional[float] = None,
                       warmup_s: float = 0.0) -> dict:
    """Run `assess_leak` over named series from one store.

    `series` maps series name -> per-series overrides
    ({max_growth_frac, min_points, warmup_s}); returns
    {"series": {name: verdict}, "leaking": [names]}.
    """
    out: dict = {"series": {}, "leaking": []}
    for name, overrides in series.items():
        o = dict(overrides or {})
        hist = store.history(name, window_s=window_s, tier="raw", now=now)
        verdict = assess_leak(
            [(p[0], p[1]) for p in hist["points"]],
            max_growth_frac=float(o.get("max_growth_frac", 0.05)),
            min_points=int(o.get("min_points", 8)),
            warmup_s=float(o.get("warmup_s", warmup_s)))
        out["series"][name] = verdict
        if verdict["leaking"]:
            out["leaking"].append(name)
    out["pass"] = not out["leaking"]
    return out


# ---------------------------------------------------------------------------
# ops route

def register_routes(ops, store: TimeSeriesStore) -> None:
    """Mount GET /metrics/history on an OperationsServer.

    No `name` lists the available series; with a name, `window` (s) and
    `tier` shape the reply.  The built-in /metrics handler matches the
    exact path only, so this prefix route never shadows it.
    """
    from urllib.parse import parse_qs, urlparse

    def _history(path: str, body: bytes):
        q = parse_qs(urlparse(path).query)
        name = (q.get("name") or [None])[0]
        if not name:
            return 200, {"series": store.names(),
                         "interval_s": store.interval_s,
                         "windows_s": {"raw": store.raw_window_s,
                                       "1m": store.m1_window_s,
                                       "10m": store.m10_window_s}}
        window = (q.get("window") or q.get("window_s") or [None])[0]
        tier = (q.get("tier") or [None])[0]
        try:
            out = store.history(
                name, window_s=float(window) if window else None, tier=tier)
        except ValueError as exc:
            return 400, {"error": str(exc)}
        if not out["points"] and name not in store.names():
            return 404, {"error": "unknown series", "name": name,
                         "series": store.names()}
        return 200, out

    ops.register_route("GET", "/metrics/history", _history)
