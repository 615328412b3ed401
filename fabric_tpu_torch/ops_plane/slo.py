"""SLO evaluator: multi-window burn-rate alerting over the metrics plane.

Implements the SRE-workbook multi-window pattern on top of the local
ops_plane registry: each objective is measured over a SHORT and a LONG
rolling window, burn rate = measured value relative to the objective's
threshold, and an alert fires only when BOTH windows burn — the short
window proves the problem is happening *now*, the long window proves it
is sustained (one slow block never pages, a stuck pipeline does).
Alerts are deduplicated by a per-objective state machine with hysteresis
(clear only when the short window drops below clear_ratio * threshold)
and land in three places: a jlog record, a `slo.alert` root span in the
trace stream, and the `/slo` + `/slo/alerts` ops routes.

Everything here is sampling/aggregation off the hot path: the evaluator
thread reads cumulative snapshots (Histogram.state / Counter.total /
Gauge.values) on an interval and derives windowed deltas, so observing
code never pays more than it already does for the registry.

Node wiring: the `slo` sub-dict of the local config (peer and orderer),
env-overridable as FABRIC_TPU_<ROLE>_SLO__<KEY> (localconfig tiering).

Per-channel objectives: `slo: {per_channel: ["commit_p99_s"]}` expands
the named objective into a channel-grouped template — one independent
instance (own windows, own burn state, own alert) per observed
`channel` label value, named `commit_p99_s_by_channel[<ch>]`, so one
slow channel pages without being averaged away by its quiet neighbours.
The aggregated original keeps running unchanged.  An objective may also
carry `per: <label>` directly to group by any other label.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from .logging import jlog
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .metrics import registry as default_registry

logger = logging.getLogger("fabric_tpu_torch.ops_plane.slo")

# the four pipeline-economics objectives every node watches out of the
# box; node config merges overrides (or adds new ones) by name
DEFAULT_OBJECTIVES: Dict[str, dict] = {
    "commit_p99_s": {
        "kind": "max", "source": "histogram_quantile",
        "metric": "validation_duration_seconds", "q": 0.99,
        "threshold": 5.0,
        "help": "per-block validate wall time p99 (seconds)"},
    "verify_throughput_floor": {
        "kind": "min", "source": "counter_rate",
        "metric": "provider_device_sigs_total", "threshold": 0.0,
        "help": "device-verified signatures per second"},
    "breaker_open_frac": {
        "kind": "max", "source": "gauge_mean",
        "metric": "gateway_orderer_breaker_open", "threshold": 0.5,
        "help": "fraction of orderer circuit breakers open"},
    "overlap_floor": {
        "kind": "min", "source": "gauge_mean",
        "metric": "pipeline_collect_under_verify_frac", "threshold": 0.0,
        "help": "live collect-under-verify overlap fraction"},
}

_BURN_CAP = 1e6          # keep /slo JSON strict (no Infinity literals)


def _burn(kind: str, value: Optional[float],
          threshold: float) -> Optional[float]:
    """Burn rate: 1.0 = consuming budget exactly at the threshold.

    max-objectives (value must stay <= threshold): value/threshold.
    min-objectives (value must stay >= threshold): threshold/value.
    """
    if value is None:
        return None
    if kind == "max":
        if threshold <= 0.0:
            return 0.0 if value <= 0.0 else _BURN_CAP
        return min(_BURN_CAP, value / threshold)
    if threshold <= 0.0:
        return 0.0
    if value <= 0.0:
        return _BURN_CAP
    return min(_BURN_CAP, threshold / value)


class SloEvaluator:
    """Samples the registry on an interval, evaluates objectives over
    short/long windows, and runs the multi-window alert state machine."""

    def __init__(self, cfg: Optional[dict] = None, *,
                 registry: Optional[MetricsRegistry] = None,
                 clock=None):
        cfg = dict(cfg or {})
        self.registry = registry or default_registry
        self._clock = clock or time.monotonic
        self.sample_interval_s = float(cfg.get("sample_interval_s", 5.0))
        self.short_window_s = float(cfg.get("short_window_s", 60.0))
        self.long_window_s = float(cfg.get("long_window_s", 300.0))
        self.burn_threshold = float(cfg.get("burn_threshold", 1.0))
        self.clear_ratio = float(cfg.get("clear_ratio", 0.9))
        # delta sources need this much of the window covered by samples
        self.min_coverage = float(cfg.get("min_coverage", 0.5))

        self.objectives: Dict[str, dict] = {}
        merged = {k: dict(v) for k, v in DEFAULT_OBJECTIVES.items()}
        for name, o in (cfg.get("objectives") or {}).items():
            merged.setdefault(name, {}).update(o or {})
        # `per_channel: [names]` templates: each named objective (after
        # the merge above) also gets a channel-expanded variant that
        # evaluates — and alerts — once per observed `channel` label
        # value, so one slow channel pages as `commit_p99_s_by_channel
        # [ch]` without drowning in the aggregate.  The aggregated
        # original keeps running unchanged.  An objective may also
        # carry `per: <label>` directly.
        for name in cfg.get("per_channel") or ():
            base = merged.get(name)
            if base is None:
                raise ValueError(
                    f"slo per_channel names unknown objective {name!r}")
            merged[f"{name}_by_channel"] = dict(base, per="channel")
        for name, o in merged.items():
            if o.get("enabled", True) is False:
                continue
            o.setdefault("kind", "max")
            o.setdefault("source", "gauge_mean")
            o.setdefault("threshold", 0.0)
            if "metric" not in o:
                raise ValueError(f"slo objective {name!r} needs a metric")
            self.objectives[name] = o

        maxlen = max(16, int(self.long_window_s /
                             max(self.sample_interval_s, 1e-3)) * 2 + 4)
        self._samples: deque = deque(maxlen=min(maxlen, 4096))
        self._lock = threading.RLock()
        self._states: Dict[str, dict] = {
            n: {"state": "no_data", "since": time.time()}
            for n in self.objectives}
        self._active: Dict[str, dict] = {}
        self._history: deque = deque(maxlen=64)
        self._last_status: List[dict] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # alert-transition hooks (incidents.py attaches here): called
        # as hook(name, alert_dict) AFTER the transition is recorded.
        # Invoked under the evaluator lock — hooks must not block
        # (the incident recorder only spawns a capture thread).
        self.on_fire = None
        self.on_clear = None

    # -- sampling ------------------------------------------------------------

    @staticmethod
    def _snap_key(o: dict) -> str:
        """Snapshot key: the metric name, suffixed with the grouping
        label for `per` objectives so an aggregated and a per-channel
        objective over the SAME metric coexist in one sample."""
        per = o.get("per")
        return f"{o['metric']}|{per}" if per else o["metric"]

    def _capture(self) -> dict:
        snap: dict = {}
        for o in self.objectives.values():
            key = self._snap_key(o)
            if key in snap:
                continue
            m = self.registry.get(o["metric"])
            per = o.get("per")
            if per:
                # grouped snapshot: {label value -> classic-shape state}
                if isinstance(m, Histogram):
                    snap[key] = ("h*", m.buckets, m.state_by(per))
                elif isinstance(m, Counter):
                    snap[key] = ("c*", m.total_by(per))
                elif isinstance(m, Gauge):
                    snap[key] = ("g*", m.mean_by(per))
                continue
            if isinstance(m, Histogram):
                snap[key] = ("h", m.buckets, m.state())
            elif isinstance(m, Counter):
                snap[key] = ("c", m.total())
            elif isinstance(m, Gauge):
                vals = m.values()
                snap[key] = ("g", (sum(vals.values()) / len(vals))
                             if vals else None)
        return snap

    def sample(self, now: Optional[float] = None) -> None:
        now = self._clock() if now is None else now
        snap = self._capture()
        with self._lock:
            self._samples.append((now, snap))

    # -- windowed values -----------------------------------------------------

    def _select(self, o: dict, group: Optional[str]):
        """Entry accessor for one sample dict: classic objectives read
        the metric's aggregate tuple; `per` instances project their
        group's slice out of the grouped snapshot into the same
        ("h"/"c"/"g", ...) shape so the windowing below is shared."""
        key = self._snap_key(o)
        if group is None:
            return lambda p: p.get(key)

        def sel(p):
            ent = p.get(key)
            if ent is None:
                return None
            if ent[0] == "h*":
                st = ent[2].get(group)
                return None if st is None else ("h", ent[1], st)
            if ent[0] == "c*":
                v = ent[1].get(group)
                return None if v is None else ("c", v)
            if ent[0] == "g*":
                v = ent[1].get(group)
                return None if v is None else ("g", v)
            return None
        return sel

    def _window_value(self, o: dict, samples: list, now: float,
                      window_s: float,
                      group: Optional[str] = None) -> Optional[float]:
        src = o["source"]
        sel = self._select(o, group)
        if src == "gauge_mean":
            vals = [sel(p)[1] for t, p in samples
                    if now - window_s < t <= now and sel(p) is not None
                    and sel(p)[0] == "g" and sel(p)[1] is not None]
            return (sum(vals) / len(vals)) if vals else None
        # delta sources: newest sample vs the newest sample at/before
        # the window start (falling back to the oldest we have)
        present = [(t, sel(p)) for t, p in samples if sel(p) is not None]
        if len(present) < 2:
            return None
        t1, e1 = present[-1]
        base = None
        for t, e in present:
            if t <= now - window_s:
                base = (t, e)
            else:
                break
        t0, e0 = base if base is not None else present[0]
        span = t1 - t0
        if span <= 0.0 or span < self.min_coverage * window_s:
            return None
        if src == "counter_rate":
            if e0[0] != "c" or e1[0] != "c":
                return None
            return max(0.0, e1[1] - e0[1]) / span
        if src == "histogram_quantile":
            if e0[0] != "h" or e1[0] != "h":
                return None
            buckets = e1[1]
            c0, _, n0 = e0[2]
            c1, _, n1 = e1[2]
            n = n1 - n0
            if n <= 0:
                return None
            target = float(o.get("q", 0.99)) * n
            cum = 0
            last_finite = 0.0
            for ub, a, b in zip(buckets, c1, c0):
                cum += a - b
                if ub != float("inf"):
                    last_finite = ub
                if cum >= target:
                    return ub if ub != float("inf") else last_finite
            return last_finite
        return None

    # -- evaluation + alert state machine ------------------------------------

    def _observed_groups(self, o: dict, samples: list) -> List[str]:
        """Every label value a `per` objective's metric was seen with in
        the current sample set (union across samples, so a group that
        just went quiet still evaluates its long window)."""
        key = self._snap_key(o)
        groups: set = set()
        for _, p in samples:
            ent = p.get(key)
            if ent is None:
                continue
            groups.update(ent[2] if ent[0] == "h*" else ent[1])
        return sorted(groups)

    def _eval_one(self, name: str, o: dict, samples: list, now: float,
                  group: Optional[str] = None) -> dict:
        short_s = float(o.get("short_window_s", self.short_window_s))
        long_s = float(o.get("long_window_s", self.long_window_s))
        bt = float(o.get("burn_threshold", self.burn_threshold))
        kind = o["kind"]
        thr = float(o["threshold"])
        vs = self._window_value(o, samples, now, short_s, group=group)
        vl = self._window_value(o, samples, now, long_s, group=group)
        bs = _burn(kind, vs, thr)
        bl = _burn(kind, vl, thr)
        with self._lock:
            st = self._states.setdefault(
                name, {"state": "no_data", "since": time.time()})
            prev = st["state"]
            if prev == "alerting":
                # hysteresis: only a clearly-healthy SHORT window
                # clears; no-data holds the alert (absence of
                # evidence is not recovery)
                if bs is not None and bs < bt * self.clear_ratio:
                    st["state"] = "ok"
                    st["since"] = time.time()
                    self._clear_alert(name, o, vs, bs, bl)
            else:
                if bs is not None and bl is not None \
                        and bs >= bt and bl >= bt:
                    st["state"] = "alerting"
                    st["since"] = time.time()
                    self._fire_alert(name, o, vs, bs, bl)
                elif bs is None and bl is None:
                    if prev != "no_data":
                        st["state"] = "no_data"
                        st["since"] = time.time()
                elif prev != "ok":
                    st["state"] = "ok"
                    st["since"] = time.time()
            state = st["state"]
            since = st["since"]
        status = {
            "name": name, "kind": kind, "source": o["source"],
            "metric": o["metric"], "threshold": thr,
            "help": o.get("help", ""),
            "windows": {"short_s": short_s, "long_s": long_s},
            "burn_threshold": bt,
            "value_short": vs, "value_long": vl,
            "burn_short": bs, "burn_long": bl,
            "state": state, "since": since}
        if o.get("per"):
            status["per"] = o["per"]
            status["group"] = group
        return status

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        now = self._clock() if now is None else now
        with self._lock:
            samples = list(self._samples)
        statuses: List[dict] = []
        for name, o in self.objectives.items():
            if not o.get("per"):
                statuses.append(self._eval_one(name, o, samples, now))
                continue
            # per-label objective: one independent instance (own windows,
            # own alert state, own /slo row) per observed label value
            groups = self._observed_groups(o, samples)
            if not groups:
                statuses.append(self._eval_one(name, o, samples, now))
                continue
            for g in groups:
                statuses.append(self._eval_one(
                    f"{name}[{g}]", o, samples, now, group=g))
        with self._lock:
            self._last_status = statuses
        return statuses

    def _alert_attrs(self, name, o, value, bs, bl) -> dict:
        # `o` is passed in (not looked up) because per-label instance
        # names like "commit_p99_s_by_channel[ch1]" are not objective
        # keys — they share their template's config
        return {"objective": name, "metric": o["metric"],
                "kind": o["kind"], "threshold": float(o["threshold"]),
                "value": value, "burn_short": bs, "burn_long": bl}

    def _fire_alert(self, name, o, value, bs, bl) -> None:
        rec = dict(self._alert_attrs(name, o, value, bs, bl),
                   state="firing", fired_at=time.time())
        self._active[name] = rec
        self._history.append(rec)
        try:
            self.registry.counter(
                "slo_alerts_total", "SLO alerts fired").add(
                    1, objective=name)
            self.registry.gauge(
                "slo_alerting", "1 while the objective is alerting").set(
                    1.0, objective=name)
        except Exception:
            pass
        jlog(logger, "slo.alert_fired", level=logging.WARNING,
             **self._alert_attrs(name, o, value, bs, bl))
        self._trace_alert("slo.alert_fired", name, o, value, bs, bl)
        hook = self.on_fire
        if hook is not None:
            try:
                hook(name, dict(rec))
            except Exception:
                logger.exception("slo on_fire hook failed")

    def _clear_alert(self, name, o, value, bs, bl) -> None:
        rec = self._active.pop(name, None)
        if rec is not None:
            rec["state"] = "resolved"
            rec["cleared_at"] = time.time()
        try:
            self.registry.gauge(
                "slo_alerting", "1 while the objective is alerting").set(
                    0.0, objective=name)
        except Exception:
            pass
        jlog(logger, "slo.alert_cleared",
             **self._alert_attrs(name, o, value, bs, bl))
        self._trace_alert("slo.alert_cleared", name, o, value, bs, bl)
        hook = self.on_clear
        if hook is not None:
            try:
                hook(name, dict(rec) if rec is not None
                     else self._alert_attrs(name, o, value, bs, bl))
            except Exception:
                logger.exception("slo on_clear hook failed")

    def _trace_alert(self, event, name, o, value, bs, bl) -> None:
        """Alert transitions land in the trace stream as a `slo.alert`
        root span carrying an event annotation — the evaluator thread
        has no ambient request context, so it roots its own trace."""
        try:
            from . import tracing
            attrs = self._alert_attrs(name, o, value, bs, bl)
            with tracing.tracer.start_span("slo.alert", attributes=attrs):
                tracing.event(event, **attrs)
        except Exception:
            pass

    # -- public surface ------------------------------------------------------

    def step(self, now: Optional[float] = None) -> None:
        self.sample(now)
        self.evaluate(now)

    def status(self) -> dict:
        with self._lock:
            statuses = list(self._last_status)
            n_samples = len(self._samples)
            active = sorted(self._active)
        if not statuses:           # no step yet: evaluate on demand
            statuses = self.evaluate()
            with self._lock:
                active = sorted(self._active)
        return {"enabled": True, "sampled_at": time.time(),
                "sample_count": n_samples,
                "sample_interval_s": self.sample_interval_s,
                "windows": {"short_s": self.short_window_s,
                            "long_s": self.long_window_s},
                "burn_threshold": self.burn_threshold,
                "clear_ratio": self.clear_ratio,
                "alerting": active,
                "objectives": statuses}

    def alerts_snapshot(self) -> dict:
        with self._lock:
            return {"active": [dict(r) for r in self._active.values()],
                    "history": [dict(r) for r in self._history]}

    def burn_state(self) -> dict:
        """Consumer view for load-control planes (gateway admission):
        the max short-window burn across objectives plus the per-
        objective burns.  Reads the LAST evaluation only — never
        re-samples — so callers may poll it on a hot path."""
        with self._lock:
            statuses = list(self._last_status)
            active = sorted(self._active)
        burns = {s["name"]: s["burn_short"] for s in statuses
                 if s.get("burn_short") is not None}
        return {"max_burn_short": max(burns.values()) if burns else None,
                "alerting": active, "burns": burns}

    # -- background thread ---------------------------------------------------

    def start(self) -> "SloEvaluator":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.sample_interval_s):
                try:
                    self.step()
                except Exception:      # never take the node down
                    logger.exception("slo evaluator step failed")

        self._thread = threading.Thread(
            target=loop, name="slo-evaluator", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        th, self._thread = self._thread, None
        if th is not None:
            th.join(timeout=2.0)


def register_routes(ops, evaluator: SloEvaluator) -> None:
    """Mount GET /slo and GET /slo/alerts.  /slo/alerts first: the ops
    server matches registered prefixes in insertion order."""
    ops.register_route("GET", "/slo/alerts",
                       lambda path, body: (200,
                                           evaluator.alerts_snapshot()))
    ops.register_route("GET", "/slo",
                       lambda path, body: (200, evaluator.status()))
