"""SLO-triggered incident capture: the cluster's flight data recorder.

The r5 burn-rate evaluator (slo.py) can say THAT an objective is
burning; diagnosing WHY needs evidence from the burn window — a
profile covering it, the slowest traces, peer-node state — and until
now a human had to capture all of that by hand, after the fact.  This
plane closes the loop: an `IncidentRecorder` hooks the evaluator's
alert transitions and, on fire, atomically writes a self-contained
`incident_NNNN/` bundle:

    incident.json        alert attrs, node identity, peer roll call
    metric_history.json  the timeseries ring's trailing window for the
                         burning objective's metric + every input series
    traces.json          the FlightRecorder's K slowest traces (full
                         span records, not just summaries)
    profile.json         merged sampled profile over the burn window
    profile_folded.txt   same, flamegraph-ready folded stacks
    snapshots.json       admission / breaker / byzantine / lifecycle /
                         resources snapshots (whatever the node wired)
    jlog_tail.txt        the last N structured log lines
    peers/<endpoint>.json  each peer's /incidents/snapshot at the burn
                         instant (dead peers recorded as errors and the
                         bundle marked `partial` — same fail-open rule
                         as node/tracecollect.py)
    MANIFEST.json        sha256 of every file above; `verify_bundle`
                         re-hashes and names any tamper/missing file

Rate-limiting is per OBJECTIVE (cooldown_s): a flapping alert cannot
fill the disk.  Retention is bounded (keep last N bundles, gc the
oldest).  Everything is served on the ops surface: GET /incidents
(index), GET /incidents/<id> (manifest + verification), and GET
/incidents/snapshot (the self-view peers fetch during fan-out).

Zero-overhead guard: a node that leaves the `incidents` sub-dict
disabled constructs no recorder, registers no counter or route, and
serves a byte-identical /metrics surface (tests/test_incidents.py).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import threading
import time
import urllib.request
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from .logging import jlog
from .metrics import MetricsRegistry, registry as default_registry

logger = logging.getLogger("fabric_tpu_torch.ops_plane.incidents")

__all__ = ["IncidentRecorder", "verify_bundle", "register_routes"]

MANIFEST = "MANIFEST.json"


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(65536), b""):
            h.update(chunk)
    return h.hexdigest()


def verify_bundle(bundle_dir: str) -> dict:
    """Re-hash a bundle against its MANIFEST.  Returns
    {"ok": bool, "files": n, "mismatched": [...], "missing": [...],
     "extra": [...]}  — any tamper, truncation, or deletion is named."""
    mpath = os.path.join(bundle_dir, MANIFEST)
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as exc:
        return {"ok": False, "files": 0, "mismatched": [],
                "missing": [MANIFEST], "extra": [],
                "error": str(exc)[:200]}
    want: Dict[str, str] = dict(manifest.get("files", {}))
    mismatched, missing = [], []
    for rel, digest in sorted(want.items()):
        p = os.path.join(bundle_dir, rel)
        try:
            got = _sha256_file(p)
        except OSError:
            missing.append(rel)
            continue
        if got != digest:
            mismatched.append(rel)
    have = set()
    for root, _dirs, files in os.walk(bundle_dir):
        for fn in files:
            rel = os.path.relpath(os.path.join(root, fn), bundle_dir)
            if rel != MANIFEST:
                have.add(rel)
    extra = sorted(have - set(want))
    return {"ok": not (mismatched or missing or extra),
            "files": len(want), "mismatched": mismatched,
            "missing": missing, "extra": extra}


class _JlogTail(logging.Handler):
    """Bounded in-memory tail of the structured log stream — the
    bundle's `jlog_tail.txt` evidence."""

    def __init__(self, maxlen: int):
        super().__init__()
        self.buf: deque = deque(maxlen=maxlen)
        self.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s %(message)s"))

    def emit(self, record):
        try:
            self.buf.append(self.format(record))
        except Exception:
            pass


class IncidentRecorder:
    """Captures incident bundles when an attached SloEvaluator fires.

    Config (the node's `incidents` sub-dict):
        enabled            gate read by the NODE (disabled -> never
                           constructed; the zero-overhead guard)
        dir                bundle directory (node default: <data_dir>/
                           incidents)
        cooldown_s         per-objective re-capture suppression (120)
        keep               retained bundles; oldest gc'd first (8)
        slow_traces        K slowest FlightRecorder traces bundled (5)
        profile_window_s   sampled-profile span copied per bundle (120)
        history_window_s   timeseries window copied per bundle (300)
        jlog_tail          log lines retained for the tail file (200)
        peers              ops endpoints ("host:port") fanned out to
        peer_timeout_s     per-peer snapshot fetch budget (2.0)
        sync               capture on the alert thread instead of a
                           one-shot capture thread (tests)
    """

    def __init__(self, cfg: Optional[dict] = None, *,
                 registry: Optional[MetricsRegistry] = None,
                 clock=None, node_name: str = "node",
                 profiler=None, timeseries=None):
        cfg = dict(cfg or {})
        self.dir = str(cfg.get("dir") or os.path.join(
            os.getcwd(), "incidents"))
        self.cooldown_s = float(cfg.get("cooldown_s", 120.0))
        self.keep = max(1, int(cfg.get("keep", 8)))
        self.slow_traces = max(0, int(cfg.get("slow_traces", 5)))
        self.profile_window_s = float(cfg.get("profile_window_s", 120.0))
        self.history_window_s = float(cfg.get("history_window_s", 300.0))
        self.peers: List[str] = [str(p) for p in cfg.get("peers", [])]
        self.peer_timeout_s = float(cfg.get("peer_timeout_s", 2.0))
        self.sync = bool(cfg.get("sync", False))
        self.node_name = str(node_name)
        self.registry = registry or default_registry
        self._clock = clock or time.time
        self.profiler = profiler
        self.timeseries = timeseries
        self._sources: Dict[str, Callable[[], object]] = {}
        self._slo = None
        self._lock = threading.Lock()
        self._last_fire: Dict[str, float] = {}
        self._suppressed: deque = deque(maxlen=32)
        self._threads: List[threading.Thread] = []
        os.makedirs(self.dir, exist_ok=True)
        self._seq = self._scan_seq()
        self._captured_c = self.registry.counter(
            "incidents_captured_total", "incident bundles written")
        self._suppressed_c = self.registry.counter(
            "incidents_suppressed_total",
            "alert fires suppressed by per-objective cooldown")
        self._tail = _JlogTail(max(8, int(cfg.get("jlog_tail", 200))))
        logging.getLogger("fabric_tpu_torch").addHandler(self._tail)

    # -- wiring --------------------------------------------------------------

    def add_source(self, name: str, fn: Callable[[], object]) -> None:
        """Register a snapshot source (admission, byzantine, resources,
        lifecycle...); called at capture time, failures recorded inline."""
        self._sources[str(name)] = fn

    def attach_slo(self, evaluator) -> None:
        """Hook the evaluator's alert transitions (slo.py on_fire /
        on_clear callbacks)."""
        self._slo = evaluator
        evaluator.on_fire = self.on_alert_fired
        evaluator.on_clear = self.on_alert_cleared

    # -- alert hooks ---------------------------------------------------------

    def on_alert_fired(self, name: str, alert: dict) -> Optional[str]:
        """Fire hook: cooldown-gate, then capture (async by default).
        Returns the bundle id when captured synchronously."""
        now = self._clock()
        with self._lock:
            last = self._last_fire.get(name)
            if last is not None and now - last < self.cooldown_s:
                self._suppressed.append(
                    {"objective": name, "at": now,
                     "cooldown_left_s": round(
                         self.cooldown_s - (now - last), 3)})
                try:
                    self._suppressed_c.add(1)
                except Exception:
                    pass
                return None
            self._last_fire[name] = now
        alert = dict(alert or {}, objective=alert.get("objective", name))
        if self.sync:
            return self.capture(alert)
        th = threading.Thread(target=self.capture, args=(alert,),
                              name="incident-capture", daemon=True)
        with self._lock:
            self._threads = [t for t in self._threads if t.is_alive()]
            self._threads.append(th)
        th.start()
        return None

    def on_alert_cleared(self, name: str, alert: dict) -> None:
        """Clears never capture — the evidence window was the burn —
        but they land in the log tail for the NEXT bundle's timeline."""
        jlog(logger, "incidents.alert_cleared", objective=name)

    # -- capture -------------------------------------------------------------

    def _scan_seq(self) -> int:
        seq = 0
        try:
            for d in os.listdir(self.dir):
                if d.startswith("incident_"):
                    try:
                        seq = max(seq, int(d.split("_", 1)[1]))
                    except ValueError:
                        pass
        except OSError:
            pass
        return seq

    def capture(self, alert: dict) -> Optional[str]:
        """Write one bundle atomically (tmp dir -> rename); never
        raises — an incident capture must not become an incident."""
        try:
            return self._capture(alert)
        except Exception:
            logger.exception("incident capture failed")
            return None

    def _capture(self, alert: dict) -> str:
        now = self._clock()
        with self._lock:
            self._seq += 1
            seq = self._seq
        inc_id = f"incident_{seq:04d}"
        tmp = os.path.join(self.dir, f".tmp_{seq:04d}_{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
        files: Dict[str, str] = {}

        def put(rel: str, payload) -> None:
            path = os.path.join(tmp, rel)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            if isinstance(payload, str):
                data = payload.encode()
            else:
                data = json.dumps(payload, indent=2, default=str,
                                  sort_keys=True).encode()
            with open(path, "wb") as f:
                f.write(data)
            files[rel] = hashlib.sha256(data).hexdigest()

        # -- snapshots from the wired sources (fail-open per source) --
        snaps: Dict[str, object] = {}
        for sname, fn in sorted(self._sources.items()):
            try:
                snaps[sname] = fn()
            except Exception as exc:
                snaps[sname] = {"error": repr(exc)[:200]}
        if self._slo is not None:
            try:
                snaps["slo"] = self._slo.status()
            except Exception as exc:
                snaps["slo"] = {"error": repr(exc)[:200]}
        put("snapshots.json", snaps)

        # -- metric history: the burning metric + every input series --
        if self.timeseries is not None:
            hist: Dict[str, object] = {}
            try:
                for name in self.timeseries.names():
                    hist[name] = self.timeseries.history(
                        name, window_s=self.history_window_s)
            except Exception as exc:
                hist["error"] = repr(exc)[:200]
            put("metric_history.json",
                {"metric": alert.get("metric"), "series": hist})

        # -- the K slowest traces, full span records ------------------
        if self.slow_traces:
            traces: List[dict] = []
            try:
                from . import tracing
                rec = tracing.tracer.recorder
                for s in rec.list()["slowest"][:self.slow_traces]:
                    full = rec.get(s["trace_id"])
                    traces.append(full if full is not None else s)
            except Exception as exc:
                traces = [{"error": repr(exc)[:200]}]
            put("traces.json", {"slowest": traces})

        # -- the sampled-profile windows overlapping the burn ---------
        fired_at = float(alert.get("fired_at", now))
        if self.profiler is not None:
            try:
                prof = self.profiler.profile(
                    window_s=self.profile_window_s, now=now)
                folded = prof.pop("folded")
                prof["overlapping"] = self.profiler.windows_overlapping(
                    fired_at - self.profile_window_s, now)
                put("profile.json", prof)
                put("profile_folded.txt",
                    self.profiler.folded_text(folded))
            except Exception as exc:
                put("profile.json", {"error": repr(exc)[:200]})

        # -- jlog tail ------------------------------------------------
        put("jlog_tail.txt", "\n".join(self._tail.buf))

        # -- cluster fan-out: every peer's state at the burn instant --
        partial = False
        peer_status: Dict[str, str] = {}
        for ep in self.peers:
            snap = self._fetch_peer(ep)
            safe = ep.replace(":", "_").replace("/", "_")
            if snap is None:
                partial = True
                peer_status[ep] = "unreachable"
                put(f"peers/{safe}.json",
                    {"endpoint": ep, "error": "unreachable"})
            else:
                peer_status[ep] = "ok"
                put(f"peers/{safe}.json", snap)

        put("incident.json", {
            "schema": 1, "id": inc_id, "node": self.node_name,
            "objective": alert.get("objective"),
            "alert": alert, "captured_at": now,
            "cooldown_s": self.cooldown_s, "partial": partial,
            "peers": peer_status})
        put(MANIFEST, {"id": inc_id, "created_at": now,
                       "algo": "sha256", "files": files})

        final = os.path.join(self.dir, inc_id)
        os.replace(tmp, final)
        try:
            self._captured_c.add(1)
        except Exception:
            pass
        jlog(logger, "incidents.captured", level=logging.WARNING,
             id=inc_id, objective=alert.get("objective"),
             partial=partial, dir=final)
        self._gc()
        return inc_id

    def _fetch_peer(self, endpoint: str) -> Optional[dict]:
        """One peer's /incidents/snapshot; None on ANY failure — a dead
        peer must not sink the bundle (it gets marked partial instead)."""
        url = f"http://{endpoint}/incidents/snapshot"
        try:
            with urllib.request.urlopen(
                    url, timeout=self.peer_timeout_s) as resp:
                return json.loads(resp.read())
        except Exception:
            logger.warning("incident fan-out: %s unreachable", endpoint)
            return None

    def _gc(self) -> None:
        """Bounded retention: keep the newest `keep` bundles."""
        try:
            bundles = sorted(d for d in os.listdir(self.dir)
                             if d.startswith("incident_"))
        except OSError:
            return
        for d in bundles[:max(0, len(bundles) - self.keep)]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # -- reading -------------------------------------------------------------

    def list(self) -> List[dict]:
        out: List[dict] = []
        try:
            bundles = sorted(d for d in os.listdir(self.dir)
                             if d.startswith("incident_"))
        except OSError:
            return out
        for d in bundles:
            meta = {"id": d}
            try:
                with open(os.path.join(self.dir, d,
                                       "incident.json")) as f:
                    inc = json.load(f)
                meta.update(objective=inc.get("objective"),
                            captured_at=inc.get("captured_at"),
                            partial=inc.get("partial", False),
                            node=inc.get("node"))
            except (OSError, ValueError) as exc:
                meta["error"] = str(exc)[:200]
            out.append(meta)
        return out

    def index(self) -> dict:
        with self._lock:
            suppressed = list(self._suppressed)
        incidents = self.list()
        return {"dir": self.dir, "count": len(incidents),
                "keep": self.keep, "cooldown_s": self.cooldown_s,
                "peers": list(self.peers),
                "suppressed": suppressed, "incidents": incidents}

    def get(self, inc_id: str) -> Optional[dict]:
        """One bundle's manifest + fresh verification + file sizes."""
        bundle = os.path.join(self.dir, inc_id)
        if not (inc_id.startswith("incident_")
                and os.path.isdir(bundle)):
            return None
        out: dict = {"id": inc_id, "dir": bundle}
        try:
            with open(os.path.join(bundle, "incident.json")) as f:
                out["incident"] = json.load(f)
        except (OSError, ValueError) as exc:
            out["incident"] = {"error": str(exc)[:200]}
        try:
            with open(os.path.join(bundle, MANIFEST)) as f:
                manifest = json.load(f)
            out["files"] = {
                rel: os.path.getsize(os.path.join(bundle, rel))
                for rel in manifest.get("files", {})
                if os.path.exists(os.path.join(bundle, rel))}
        except (OSError, ValueError):
            out["files"] = {}
        out["verify"] = verify_bundle(bundle)
        return out

    def self_snapshot(self) -> dict:
        """What THIS node serves to a firing peer's fan-out: sources,
        SLO status, and the profile windows covering the recent past —
        everything except the heavyweight folded stacks."""
        snaps: Dict[str, object] = {}
        for sname, fn in sorted(self._sources.items()):
            try:
                snaps[sname] = fn()
            except Exception as exc:
                snaps[sname] = {"error": repr(exc)[:200]}
        out = {"node": self.node_name, "time": self._clock(),
               "snapshots": snaps}
        if self._slo is not None:
            try:
                out["slo"] = self._slo.status()
            except Exception as exc:
                out["slo"] = {"error": repr(exc)[:200]}
        if self.profiler is not None:
            try:
                prof = self.profiler.profile(
                    window_s=self.profile_window_s)
                prof.pop("folded", None)
                out["profile"] = prof
            except Exception as exc:
                out["profile"] = {"error": repr(exc)[:200]}
        return out

    # -- lifecycle -----------------------------------------------------------

    def drain(self, timeout_s: float = 30.0) -> None:
        """Wait for in-flight async captures (scenario/test teardown)."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            threads = list(self._threads)
        for th in threads:
            th.join(timeout=max(0.0, deadline - time.monotonic()))

    def stop(self) -> None:
        self.drain(timeout_s=5.0)
        if self._slo is not None:
            # == not `is`: bound methods are re-created per attribute
            # access, but compare equal for the same (func, instance)
            if getattr(self._slo, "on_fire", None) == self.on_alert_fired:
                self._slo.on_fire = None
            if getattr(self._slo, "on_clear", None) \
                    == self.on_alert_cleared:
                self._slo.on_clear = None
        logging.getLogger("fabric_tpu_torch").removeHandler(self._tail)


def register_routes(ops, recorder: IncidentRecorder) -> None:
    """Mount GET /incidents, /incidents/<id>, /incidents/snapshot.
    Specific prefixes FIRST: the ops server matches registered prefixes
    in insertion order."""
    ops.register_route(
        "GET", "/incidents/snapshot",
        lambda path, body: (200, recorder.self_snapshot()))

    def _one(path: str, body: bytes) -> Tuple[int, dict]:
        inc_id = path.split("?", 1)[0].rstrip("/").rsplit("/", 1)[-1]
        out = recorder.get(inc_id)
        if out is None:
            return 404, {"error": "unknown incident", "id": inc_id}
        return 200, out

    ops.register_route("GET", "/incidents/", _one)
    ops.register_route("GET", "/incidents",
                       lambda path, body: (200, recorder.index()))
