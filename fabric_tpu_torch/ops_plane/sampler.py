"""Always-on wall-clock sampling profiler (`GET /profile/sampled`).

The on-demand `/debug/pprof` route (profiling.py) answers "where is
time going RIGHT NOW, for the next N seconds" — which is almost always
too late for an incident: by the time a human notices the burn and
posts the capture request, the bad window is over.  This plane inverts
the capture direction: a daemon thread walks `sys._current_frames()`
at a low fixed rate (default ~19 Hz — deliberately co-prime with the
common 10/20/50/100 ms periodic loops in this codebase, so the sampler
never phase-locks onto them) and aggregates folded call stacks per
THREAD ROLE into a bounded ring of time-bucketed windows.  The profile
covering any incident interval therefore *already exists* when an SLO
alert fires; incidents.py just copies the overlapping windows into the
bundle.

Aggregation shape (the r15 raw→coarse tier idea, applied to stacks):

  open window     [bucket_start, bucket_start + window_s): folded-stack
                  counts accumulate in place (the "open bucket")
  fine ring       sealed windows, bounded deque — recent history at
                  window_s resolution (default 10 s × 30 = 5 min)
  coarse ring     fine windows evicted off the ring MERGE into
                  coarse_window_s buckets (default 60 s × 30 = 30 min)
                  — counts are carried, never dropped, until the coarse
                  ring itself rolls

A "folded stack" is the flamegraph interchange format: semicolon-
joined frames, root first, prefixed with the sampled thread's role
(`workload;runner.fire;gateway.submit_envelope 31`).  Roles collapse
pool-numbered thread names (`workload-7` → `workload`) so a 128-worker
pool aggregates into one flame instead of 128 singletons.

Zero-overhead guard: nothing in this module runs at import; a node
that leaves the `profiler` sub-dict disabled constructs no sampler,
registers no counter, starts no thread, and serves a byte-identical
/metrics surface (asserted in tests/test_sampler.py).

Render a flamegraph from the folded output with Brendan Gregg's
flamegraph.pl, or paste into https://www.speedscope.app:

    curl -s 'http://127.0.0.1:9443/profile/sampled?window=120&fmt=folded' \
        | flamegraph.pl > profile.svg
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from .metrics import MetricsRegistry, registry as default_registry

__all__ = ["SamplingProfiler", "register_routes"]

_OWN_THREAD_NAME = "profile-sampler"


def role_of(thread_name: str) -> str:
    """Collapse pool-numbered thread names into one role: `workload-17`
    → `workload`, `Thread-3` → `Thread`, `slo-evaluator` stays put."""
    base = thread_name.rstrip("0123456789")
    base = base.rstrip("-_")
    return base or thread_name


def _frame_label(frame) -> str:
    code = frame.f_code
    mod = os.path.basename(code.co_filename)
    if mod.endswith(".py"):
        mod = mod[:-3]
    return f"{mod}.{code.co_name}"


class _Window:
    """One time bucket of folded-stack counts."""

    __slots__ = ("start", "end", "samples", "folded")

    def __init__(self, start: float, end: float):
        self.start = start
        self.end = end
        self.samples = 0                    # sampler ticks in this bucket
        self.folded: Dict[str, int] = {}    # folded stack -> count

    def add(self, stacks: List[str]) -> None:
        self.samples += 1
        for s in stacks:
            self.folded[s] = self.folded.get(s, 0) + 1

    def merge_from(self, other: "_Window") -> None:
        self.samples += other.samples
        self.start = min(self.start, other.start)
        self.end = max(self.end, other.end)
        for s, c in other.folded.items():
            self.folded[s] = self.folded.get(s, 0) + c

    def summary(self) -> dict:
        return {"start": self.start, "end": self.end,
                "samples": self.samples, "stacks": len(self.folded)}


class SamplingProfiler:
    """Continuous `sys._current_frames()` sampler with a bounded
    fine/coarse window ring.

    Config (the node's `profiler` sub-dict):
        enabled            gate read by the NODE, not here (disabled ->
                           never constructed; the zero-overhead guard)
        hz                 sampling rate (default 19.0)
        window_s           fine bucket width (default 10.0)
        windows            fine ring length (default 30)
        coarse_window_s    coarse bucket width (default 60.0)
        coarse_windows     coarse ring length (default 30)
        max_depth          frames kept per stack, leaf-up (default 64)
        top_n              default rows in the self-time table
    """

    def __init__(self, cfg: Optional[dict] = None, *,
                 registry: Optional[MetricsRegistry] = None,
                 clock=None):
        cfg = dict(cfg or {})
        self.hz = max(0.1, float(cfg.get("hz", 19.0)))
        self.window_s = max(0.1, float(cfg.get("window_s", 10.0)))
        self.windows = max(1, int(cfg.get("windows", 30)))
        self.coarse_window_s = max(self.window_s, float(
            cfg.get("coarse_window_s", 60.0)))
        self.coarse_windows = max(1, int(cfg.get("coarse_windows", 30)))
        self.max_depth = max(2, int(cfg.get("max_depth", 64)))
        self.top_n = max(1, int(cfg.get("top_n", 25)))
        self.registry = registry or default_registry
        self._clock = clock or time.time
        self._lock = threading.Lock()
        self._open: Optional[_Window] = None
        self._fine: deque = deque()
        self._coarse: deque = deque()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # counters register at CONSTRUCTION: a disabled plane never
        # constructs, so the disabled /metrics stays byte-identical
        self._samples_c = self.registry.counter(
            "profiler_samples_total",
            "sampler ticks taken by the wall-clock profiler")
        self._threads_c = self.registry.counter(
            "profiler_thread_samples_total",
            "thread stacks folded by the profiler")
        # walk-time counter = the profiler's own duty cycle; the smoke
        # overhead gate reads this instead of flaky A/B throughput runs
        self._walk_c = self.registry.counter(
            "profiler_walk_seconds_total",
            "wall seconds the profiler spent walking frames")

    # -- sampling ------------------------------------------------------------

    def _collect_stacks(self) -> List[str]:
        """One walk over every live thread -> folded stacks (role-
        prefixed, root-first).  Overridable/injectable for tests."""
        names = {t.ident: t.name for t in threading.enumerate()}
        own = threading.get_ident()
        out: List[str] = []
        for tid, frame in sys._current_frames().items():
            if tid == own or names.get(tid) == _OWN_THREAD_NAME:
                continue
            entries: List[str] = []
            f = frame
            while f is not None and len(entries) < self.max_depth:
                entries.append(_frame_label(f))
                f = f.f_back
            entries.reverse()               # root first (folded format)
            role = role_of(names.get(tid, f"tid{tid}"))
            out.append(role + ";" + ";".join(entries))
        return out

    def sample_once(self, now: Optional[float] = None) -> int:
        """Take one sample tick; returns the number of threads folded.
        `now` is injectable so tests drive the window ring directly."""
        t0 = time.perf_counter()
        now = self._clock() if now is None else float(now)
        stacks = self._collect_stacks()
        start = (now // self.window_s) * self.window_s
        with self._lock:
            if self._open is None or self._open.start != start:
                self._roll(start)
            self._open.add(stacks)
        try:
            self._samples_c.add(1)
            self._threads_c.add(len(stacks))
            self._walk_c.add(time.perf_counter() - t0)
        except Exception:
            pass
        return len(stacks)

    def _roll(self, new_start: float) -> None:
        """Seal the open window and open the bucket at `new_start`;
        fine overflow merges into the coarse tier (counts are CARRIED,
        not dropped — the r15 tier idea).  Caller holds the lock."""
        if self._open is not None and self._open.samples:
            self._fine.append(self._open)
        while len(self._fine) > self.windows:
            w = self._fine.popleft()
            cstart = (w.start // self.coarse_window_s) \
                * self.coarse_window_s
            if self._coarse and self._coarse[-1].start == cstart:
                self._coarse[-1].merge_from(w)
            else:
                cw = _Window(cstart, cstart + self.coarse_window_s)
                cw.merge_from(w)
                self._coarse.append(cw)
            while len(self._coarse) > self.coarse_windows:
                self._coarse.popleft()
        self._open = _Window(new_start, new_start + self.window_s)

    # -- reading -------------------------------------------------------------

    def _windows_locked(self) -> List[_Window]:
        out = list(self._coarse) + list(self._fine)
        if self._open is not None and self._open.samples:
            out.append(self._open)
        return out

    def profile(self, window_s: Optional[float] = None,
                now: Optional[float] = None,
                top_n: Optional[int] = None) -> dict:
        """Merged folded profile over the trailing `window_s` seconds
        (coarse + fine + open buckets overlapping the interval)."""
        now = self._clock() if now is None else float(now)
        window_s = float(window_s if window_s is not None
                         else 6 * self.window_s)
        t0 = now - window_s
        merged: Dict[str, int] = {}
        samples = 0
        summaries: List[dict] = []
        with self._lock:
            for w in self._windows_locked():
                if w.end <= t0 or w.start > now:
                    continue
                samples += w.samples
                summaries.append(w.summary())
                for s, c in w.folded.items():
                    merged[s] = merged.get(s, 0) + c
        return {"now": now, "window_s": window_s, "hz": self.hz,
                "samples": samples, "stacks": len(merged),
                "folded": merged, "windows": summaries,
                "top": self.top_table(merged, top_n or self.top_n)}

    def windows_overlapping(self, t0: float, t1: float) -> List[dict]:
        """Summaries of the buckets intersecting [t0, t1] — the
        incident bundle's 'profile covers the burn' evidence."""
        with self._lock:
            return [w.summary() for w in self._windows_locked()
                    if w.end > t0 and w.start <= t1]

    @staticmethod
    def folded_text(folded: Dict[str, int]) -> str:
        """Flamegraph interchange: one `stack count` line, hottest
        first (order is cosmetic; flamegraph.pl re-sorts)."""
        lines = sorted(folded.items(), key=lambda kv: (-kv[1], kv[0]))
        return "\n".join(f"{s} {c}" for s, c in lines)

    @staticmethod
    def top_table(folded: Dict[str, int], n: int) -> List[dict]:
        """Self-time table: a frame's `self` counts samples where it
        was the leaf; `total` counts samples where it appears anywhere
        on the stack (each stack counted once per frame)."""
        self_c: Dict[str, int] = {}
        total_c: Dict[str, int] = {}
        grand = 0
        for stack, c in folded.items():
            frames = stack.split(";")[1:]   # drop the role prefix
            if not frames:
                continue
            grand += c
            self_c[frames[-1]] = self_c.get(frames[-1], 0) + c
            for fr in set(frames):
                total_c[fr] = total_c.get(fr, 0) + c
        rows = sorted(self_c.items(), key=lambda kv: (-kv[1], kv[0]))[:n]
        return [{"frame": fr, "self": c,
                 "self_frac": round(c / grand, 4) if grand else 0.0,
                 "total": total_c.get(fr, c)} for fr, c in rows]

    # -- background thread ---------------------------------------------------

    def start(self) -> "SamplingProfiler":
        if self._thread is not None:
            return self
        self._stop.clear()
        interval = 1.0 / self.hz

        def loop():
            while not self._stop.wait(interval):
                try:
                    self.sample_once()
                except Exception:
                    pass                    # never take the node down

        self._thread = threading.Thread(
            target=loop, name=_OWN_THREAD_NAME, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        th, self._thread = self._thread, None
        if th is not None:
            th.join(timeout=2.0)


def register_routes(ops, profiler: SamplingProfiler) -> None:
    """Mount GET /profile/sampled?window=&top=&fmt=folded|json.
    `fmt=folded` answers text/plain folded stacks (pipe straight into
    flamegraph.pl); the default JSON carries the folded text as a
    string field plus the top-N self-time table."""
    from urllib.parse import parse_qs, urlparse

    def _route(path: str, body: bytes) -> Tuple[int, object]:
        q = parse_qs(urlparse(path).query)
        try:
            window = float(q.get("window", [6 * profiler.window_s])[0])
            top = int(q.get("top", [profiler.top_n])[0])
        except ValueError as exc:
            return 400, {"error": str(exc)}
        prof = profiler.profile(window_s=window, top_n=top)
        if q.get("fmt", ["json"])[0] == "folded":
            return 200, profiler.folded_text(prof["folded"])
        prof["folded"] = profiler.folded_text(prof["folded"])
        return 200, prof

    ops.register_route("GET", "/profile/sampled", _route)
