"""Span tracer + in-memory flight recorder for the tx pipeline.

Dependency-free (stdlib only) tracing in the OpenTelemetry shape —
trace_id/span_id/parent, monotonic timestamps, attributes — with W3C
`traceparent`-style context propagation carried inside the RPC plane's
req/cast frames (comm/rpc.py adds a "tp" field when an ambient span is
active).  Two trace families exist:

  * request traces — rooted at an opted-in client (GatewayClient /
    examples/gateway_load.py) and continued across processes by the
    RPC server, covering gateway admission, endorsement and ordering;
  * block traces — rooted at `committer.store_block`, covering VSCC
    batch verify (device time), MVCC, ledger append and commit
    notification.

The two are stitched by **links**: the commit notifier remembers each
block's trace id, and the gateway's commit_status span links to it, so
`GET /traces/<request-id>` exports the request's spans *and* the linked
block's spans in one Chrome trace-event JSON (Perfetto-loadable).

The flight recorder is bounded: last N complete traces + K slowest.
Everything is off by default — `tracer` starts disabled and every
instrumentation site gets the shared no-op span, keeping the hot path
at one attribute load — and is switched on per-node via the `tracing`
sub-dict of localconfig (`FABRIC_TPU_PEER_TRACING__SAMPLE_RATE=0.1`
etc.), mirroring how Fabric gates its operations surface.
"""

from __future__ import annotations

import os
import random
import threading
import time
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Optional

from .metrics import registry as default_registry

# one wall-clock anchor so exported timestamps are perf_counter-precise
# relative to each other yet land on real epoch time in Perfetto
_WALL_ANCHOR = time.time() - time.perf_counter()

_SPAN_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                 0.25, 0.5, 1.0, 2.5, 5.0, float("inf"))


class SpanContext(NamedTuple):
    """Propagatable identity of a span (the traceparent payload)."""
    trace_id: str            # 32 lowercase hex chars
    span_id: str             # 16 lowercase hex chars
    sampled: bool
    remote: bool = False     # True when parsed off the wire


def format_traceparent(ctx: SpanContext) -> str:
    return "00-%s-%s-%s" % (ctx.trace_id, ctx.span_id,
                            "01" if ctx.sampled else "00")


def parse_traceparent(value) -> Optional[SpanContext]:
    """Parse `00-<32hex>-<16hex>-<2hex>`; returns None on any malformation."""
    if not isinstance(value, str):
        return None
    parts = value.split("-")
    if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    try:
        int(parts[1], 16), int(parts[2], 16)
        flags = int(parts[3], 16)
    except ValueError:
        return None
    return SpanContext(parts[1], parts[2], bool(flags & 1), remote=True)


class _NoopSpan:
    """Shared do-nothing span: returned whenever tracing is off."""
    __slots__ = ()
    recording = False
    context = None

    def set_attribute(self, key, value):
        return self

    def add_link(self, trace_id):
        return self

    def add_event(self, name, **attributes):
        return self

    def end(self, status: str = "OK", end_time: Optional[float] = None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NOOP_SPAN = _NoopSpan()


class Span:
    """A live span.  Use as a context manager (activates its context on
    the current thread) or keep the object and call .end() from another
    thread — cross-thread handoff is how the gateway's admission-queue
    wait span is closed by the batcher."""

    __slots__ = ("_tracer", "name", "context", "parent_id", "start",
                 "attributes", "status", "thread", "_ended", "_prev",
                 "_entered")

    recording = True

    def __init__(self, tracer: "Tracer", name: str, context: SpanContext,
                 parent_id: Optional[str], attributes: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.context = context
        self.parent_id = parent_id
        self.start = time.perf_counter()
        self.attributes = dict(attributes) if attributes else {}
        self.status = "OK"
        self.thread = threading.current_thread().name
        self._ended = False
        self._prev = None
        self._entered = False

    def set_attribute(self, key, value):
        self.attributes[key] = value
        return self

    def add_link(self, trace_id: Optional[str]):
        """Record a pointer to another trace (request <-> block stitch)."""
        if trace_id:
            self.attributes.setdefault("links", []).append(trace_id)
        return self

    def add_event(self, name: str, **attributes):
        """Timestamped annotation INSIDE this span — what happened at
        +Nms into a long operation (a fault fired, a breaker tripped).
        Exported with the span under attributes["events"]."""
        ev = {"name": name,
              "t_offset_ms": round(
                  (time.perf_counter() - self.start) * 1e3, 3)}
        if attributes:
            ev.update(attributes)
        self.attributes.setdefault("events", []).append(ev)
        return self

    def end(self, status: str = "OK", end_time: Optional[float] = None):
        if self._ended:
            return
        self._ended = True
        if status != "OK":
            self.status = status
        self._tracer._on_span_end(
            self, end_time if end_time is not None else time.perf_counter())

    def __enter__(self):
        tls = self._tracer._tls
        self._prev = getattr(tls, "ctx", None)
        tls.ctx = self.context
        self._entered = True
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._entered:
            self._tracer._tls.ctx = self._prev
            self._entered = False
        if exc_type is not None:
            self.set_attribute("error", repr(exc))
            self.end(status="ERROR")
        else:
            self.end()
        return False


class _Activation:
    __slots__ = ("_tls", "_ctx", "_prev")

    def __init__(self, tls, ctx):
        self._tls = tls
        self._ctx = ctx

    def __enter__(self):
        self._prev = getattr(self._tls, "ctx", None)
        if self._ctx is not None:
            self._tls.ctx = self._ctx
        return self._ctx

    def __exit__(self, exc_type, exc, tb):
        if self._ctx is not None:
            self._tls.ctx = self._prev
        return False


class FlightRecorder:
    """Bounded store of finished traces: last `max_traces` complete ones
    plus the `max_slow` slowest ever seen (so a tail-latency outlier
    survives long after ring eviction — the flight-recorder property).

    `retention` adds a per-root-span-name cap on top of the global ring:
    ``{"gossip.pull_window": 8}`` keeps only the newest 8 pull-window
    traces, so a high-frequency poller can't flush the rarer (and more
    interesting) request/block traces out of the recorder.  Configured
    via the tracing localconfig sub-dict, e.g.
    ``FABRIC_TPU_PEER_TRACING__RETENTION='{"gossip.pull_window": 8}'``."""

    def __init__(self, max_traces: int = 256, max_slow: int = 32,
                 retention: Optional[Dict[str, int]] = None):
        self.max_traces = int(max_traces)
        self.max_slow = int(max_slow)
        self.retention = dict(retention or {})   # root span name -> max kept
        self._lock = threading.Lock()
        self._recent: "OrderedDict[str, dict]" = OrderedDict()
        self._slow: List[dict] = []          # sorted by duration desc

    def add(self, record: dict) -> None:
        with self._lock:
            tid = record["trace_id"]
            old = self._recent.pop(tid, None)
            if old is not None:              # late fragment: merge spans
                old["spans"].extend(record["spans"])
                old["duration_s"] = max(old["duration_s"],
                                        record["duration_s"])
                record = old
            self._recent[tid] = record
            root = record.get("root_name")
            cap = self.retention.get(root) if self.retention else None
            if cap is not None:
                # oldest-first: OrderedDict keeps insertion order
                same = [k for k, r in self._recent.items()
                        if r.get("root_name") == root]
                for k in same[:max(0, len(same) - int(cap))]:
                    self._maybe_keep_slow(self._recent.pop(k))
            while len(self._recent) > self.max_traces:
                evicted_id, evicted = self._recent.popitem(last=False)
                self._maybe_keep_slow(evicted)
            self._maybe_keep_slow(record)

    def _maybe_keep_slow(self, record: dict) -> None:
        if self.max_slow <= 0:
            return
        for r in self._slow:
            if r["trace_id"] == record["trace_id"]:
                return
        self._slow.append(record)
        self._slow.sort(key=lambda r: -r["duration_s"])
        del self._slow[self.max_slow:]

    def append_span(self, trace_id: str, span: dict) -> bool:
        """Attach a late span to an already-finished trace, if retained."""
        with self._lock:
            rec = self._recent.get(trace_id)
            if rec is None:
                for r in self._slow:
                    if r["trace_id"] == trace_id:
                        rec = r
                        break
            if rec is None:
                return False
            rec["spans"].append(span)
            return True

    def get(self, trace_id: str) -> Optional[dict]:
        with self._lock:
            rec = self._recent.get(trace_id)
            if rec is None:
                for r in self._slow:
                    if r["trace_id"] == trace_id:
                        rec = r
                        break
            return rec

    def list(self) -> dict:
        def summary(rec):
            return {"trace_id": rec["trace_id"],
                    "root": rec.get("root_name"),
                    "start": rec.get("start_wall"),
                    "duration_ms": round(rec["duration_s"] * 1e3, 3),
                    "n_spans": len(rec["spans"])}
        with self._lock:
            recent = [summary(r) for r in reversed(self._recent.values())]
            slow = [summary(r) for r in self._slow]
        return {"recent": recent, "slowest": slow}

    def clear(self) -> None:
        with self._lock:
            self._recent.clear()
            self._slow.clear()


class Tracer:
    """Process-wide tracer.  Sampling is decided once at root-span
    creation and rides the context flags everywhere downstream."""

    def __init__(self, recorder: Optional[FlightRecorder] = None):
        self.enabled = False
        self.sample_rate = 1.0
        self.recorder = recorder or FlightRecorder()
        self._tls = threading.local()
        self._lock = threading.Lock()
        # trace_id -> {"spans": [dict], "open_roots": set, "t0": perf,
        #              "root_name": str, "start_wall": float}
        self._active: Dict[str, dict] = {}
        self._stats: Dict[str, list] = {}    # name -> [n, sum, max, buckets]
        self._registry = default_registry
        self._rand = random.Random(os.urandom(8))

    # -- configuration ------------------------------------------------------

    def configure(self, cfg: Optional[dict] = None, *,
                  default_enabled: bool = True) -> "Tracer":
        """Apply a localconfig `tracing` sub-dict.  Called by node
        constructors, so env overrides like
        FABRIC_TPU_PEER_TRACING__SAMPLE_RATE work out of the box."""
        cfg = cfg or {}
        self.enabled = bool(cfg.get("enabled", default_enabled))
        self.sample_rate = max(0.0, min(1.0, float(
            cfg.get("sample_rate", self.sample_rate))))
        self.recorder.max_traces = int(
            cfg.get("max_traces", self.recorder.max_traces))
        self.recorder.max_slow = int(
            cfg.get("max_slow", self.recorder.max_slow))
        retention = cfg.get("retention")
        if retention is not None:
            self.recorder.retention = {str(k): int(v)
                                       for k, v in dict(retention).items()}
        return self

    # -- context ------------------------------------------------------------

    def current_context(self) -> Optional[SpanContext]:
        return getattr(self._tls, "ctx", None)

    def current_trace_id(self) -> Optional[str]:
        ctx = getattr(self._tls, "ctx", None)
        return ctx.trace_id if ctx is not None else None

    def traceparent(self) -> Optional[str]:
        """Wire form of the ambient context, or None (fast when idle)."""
        ctx = getattr(self._tls, "ctx", None)
        return format_traceparent(ctx) if ctx is not None else None

    def context_from(self, traceparent) -> Optional[SpanContext]:
        if not self.enabled:
            return None
        return parse_traceparent(traceparent)

    def activate(self, ctx: Optional[SpanContext]):
        """Context manager making `ctx` the ambient context on this
        thread without opening a span (per-item context switching in
        batched handlers)."""
        return _Activation(self._tls, ctx)

    # -- span creation ------------------------------------------------------

    def start_span(self, name: str, parent="ambient",
                   attributes: Optional[dict] = None,
                   require_parent: bool = False):
        """Create a span.  parent: "ambient" (default, thread-local),
        a SpanContext, or None to force a new root.  require_parent=True
        yields a no-op when there is no ambient/explicit parent — used by
        mid-pipeline stages so untraced traffic records nothing."""
        if not self.enabled:
            return NOOP_SPAN
        if parent == "ambient":
            parent = getattr(self._tls, "ctx", None)
        if parent is None:
            if require_parent:
                return NOOP_SPAN
            sampled = self.sample_rate >= 1.0 or \
                self._rand.random() < self.sample_rate
            ctx = SpanContext(os.urandom(16).hex(), os.urandom(8).hex(),
                              sampled)
            span = Span(self, name, ctx, None, attributes)
            if sampled:
                self._register_root(span)
            return span
        ctx = SpanContext(parent.trace_id, os.urandom(8).hex(),
                          parent.sampled)
        span = Span(self, name, ctx, parent.span_id, attributes)
        if parent.sampled and parent.remote:
            # continuing a trace whose root lives in another process:
            # this span anchors the local fragment
            self._register_root(span)
        return span

    def record_span(self, name: str, start: float, end: float,
                    attributes: Optional[dict] = None,
                    parent: Optional[SpanContext] = None) -> None:
        """Retroactive span from explicit perf_counter() endpoints —
        used for phases timed by existing code (CommitStats et al.)."""
        if not self.enabled:
            return
        if parent is None:
            parent = getattr(self._tls, "ctx", None)
        if parent is None or not parent.sampled:
            return
        ctx = SpanContext(parent.trace_id, os.urandom(8).hex(),
                          True)
        span = Span(self, name, ctx, parent.span_id, attributes)
        span.start = start
        span.end(end_time=end)

    def event(self, name: str, **attributes) -> None:
        """Instant annotation on the AMBIENT trace: a zero-duration
        child span of whatever is active on this thread.  For code that
        has no span object in hand (the fault plane firing deep inside
        the transport) but should still show up on /traces/<id>.
        No ambient sampled context => free no-op."""
        if not self.enabled:
            return
        ctx = getattr(self._tls, "ctx", None)
        if ctx is None or not ctx.sampled:
            return
        now = time.perf_counter()
        self.record_span(name, now, now,
                         attributes=attributes or None, parent=ctx)

    # -- lifecycle plumbing -------------------------------------------------

    def _register_root(self, span: Span) -> None:
        with self._lock:
            entry = self._active.get(span.context.trace_id)
            if entry is None:
                entry = {"spans": [], "open_roots": set(),
                         "t0": span.start, "root_name": span.name,
                         "start_wall": span.start + _WALL_ANCHOR}
                self._active[span.context.trace_id] = entry
                # backstop against leaked fragments (e.g. a remote caller
                # that dies before its server span ends)
                if len(self._active) > max(64, 2 * self.recorder.max_traces):
                    tid, stale = next(iter(self._active.items()))
                    del self._active[tid]
                    self._finalize_locked(tid, stale)
            entry["open_roots"].add(span.context.span_id)

    def _on_span_end(self, span: Span, end: float) -> None:
        dur = max(0.0, end - span.start)
        self._observe(span.name, dur)
        if not span.context.sampled:
            return
        d = {"name": span.name, "trace_id": span.context.trace_id,
             "span_id": span.context.span_id, "parent_id": span.parent_id,
             "start": span.start, "duration_s": dur,
             "thread": span.thread, "status": span.status,
             "attributes": span.attributes}
        tid = span.context.trace_id
        with self._lock:
            entry = self._active.get(tid)
            if entry is not None:
                entry["spans"].append(d)
                entry["open_roots"].discard(span.context.span_id)
                if not entry["open_roots"]:
                    del self._active[tid]
                    self._finalize_locked(tid, entry)
                return
        # trace already finalized (late child, e.g. a lagging listener):
        # try to attach to the retained record, else drop
        self.recorder.append_span(tid, d)

    def _finalize_locked(self, trace_id: str, entry: dict) -> None:
        spans = entry["spans"]
        if not spans:
            return
        t0 = min(s["start"] for s in spans)
        t1 = max(s["start"] + s["duration_s"] for s in spans)
        self.recorder.add({"trace_id": trace_id,
                           "root_name": entry["root_name"],
                           "start_wall": entry["start_wall"],
                           "duration_s": t1 - t0,
                           "spans": spans})

    # -- per-stage stats ----------------------------------------------------

    def _observe(self, name: str, dur: float) -> None:
        try:
            with self._lock:
                st = self._stats.get(name)
                if st is None:
                    st = [0, 0.0, 0.0, [0] * len(_SPAN_BUCKETS)]
                    self._stats[name] = st
                st[0] += 1
                st[1] += dur
                st[2] = max(st[2], dur)
                for i, ub in enumerate(_SPAN_BUCKETS):
                    if dur <= ub:
                        st[3][i] += 1
                        break
            self._registry.histogram(
                "span_duration_seconds",
                "Duration of tracer spans by span name",
                buckets=_SPAN_BUCKETS).observe(dur, span=name)
        except Exception:
            pass                 # stats must never break the traced path

    def span_stats(self) -> dict:
        with self._lock:
            out = {}
            for name, (n, total, mx, buckets) in sorted(self._stats.items()):
                out[name] = {
                    "count": n,
                    "total_s": round(total, 6),
                    "mean_ms": round(total / n * 1e3, 3) if n else 0.0,
                    "max_ms": round(mx * 1e3, 3),
                    "buckets": {("+Inf" if ub == float("inf") else repr(ub)): c
                                for ub, c in zip(_SPAN_BUCKETS, buckets)},
                }
        return out

    # -- export -------------------------------------------------------------

    def export_chrome(self, trace_id: str,
                      follow_links: bool = True,
                      max_traces: int = 16) -> Optional[dict]:
        """Chrome trace-event JSON for one trace plus the transitive
        closure of its linked traces (bounded by `max_traces`),
        loadable in Perfetto / chrome://tracing.  Transitive: a client
        request links its block trace, which links the speculative
        verify traces that pre-verified its signatures — all of them
        belong in one picture."""
        rec = self.recorder.get(trace_id)
        if rec is None:
            return None
        records = [rec]
        truncated = False
        if follow_links:
            seen = {trace_id}
            frontier = [rec]
            while frontier:
                nxt = []
                for r in frontier:
                    for span in r["spans"]:
                        for linked in span["attributes"].get("links", ()):
                            if linked in seen:
                                continue
                            if len(records) >= max_traces:
                                # bounded on purpose, but never silently:
                                # the export says so and telemetry counts
                                truncated = True
                                continue
                            seen.add(linked)
                            lrec = self.recorder.get(linked)
                            if lrec is not None:
                                records.append(lrec)
                                nxt.append(lrec)
                frontier = nxt
        if truncated:
            default_registry.counter(
                "tracing_export_links_truncated_total",
                "export_chrome link closures cut at max_traces").add()
        events = []
        tids: Dict[str, int] = {}
        for r in records:
            for s in r["spans"]:
                tid = tids.setdefault(s["thread"], len(tids) + 1)
                args = dict(s["attributes"])
                args.update({"trace_id": s["trace_id"],
                             "span_id": s["span_id"],
                             "parent_id": s["parent_id"],
                             "status": s["status"]})
                events.append({
                    "name": s["name"], "cat": "fabric_tpu", "ph": "X",
                    "ts": round((s["start"] + _WALL_ANCHOR) * 1e6, 3),
                    "dur": round(s["duration_s"] * 1e6, 3),
                    "pid": 1, "tid": tid, "args": args,
                })
        for thread, tid in tids.items():
            events.append({"name": "thread_name", "ph": "M", "pid": 1,
                           "tid": tid, "args": {"name": thread}})
        events.sort(key=lambda e: (e["ph"] != "M", e.get("ts", 0)))
        return {"traceEvents": events,
                "displayTimeUnit": "ms",
                "otherData": {"trace_id": trace_id,
                              "root": rec.get("root_name"),
                              "n_traces_merged": len(records),
                              "truncated": truncated}}

    def reset(self) -> None:
        """Drop all state (tests)."""
        with self._lock:
            self._active.clear()
            self._stats.clear()
        self.recorder.clear()


tracer = Tracer()                # the process default


def configure(cfg: Optional[dict] = None, *,
              default_enabled: bool = True) -> Tracer:
    return tracer.configure(cfg, default_enabled=default_enabled)


def event(name: str, **attributes) -> None:
    """Module-level shorthand for `tracer.event` (ambient annotation)."""
    tracer.event(name, **attributes)


def register_routes(ops, t: Optional[Tracer] = None,
                    cluster_fn=None) -> None:
    """Mount GET /traces, /traces/<id>, /spans/stats on an
    OperationsServer.

    Query params on /traces/<id>: `follow=0` exports the one trace
    without its link closure (node/tracecollect.py follows links
    cluster-wide itself), and `cluster=1` delegates to `cluster_fn`
    (trace_id -> (code, payload)) — the node-wired cross-node assembly
    — when one was registered.
    """
    from urllib.parse import parse_qs, urlparse

    t = t or tracer

    def _traces(path: str, body: bytes):
        u = urlparse(path)
        q = parse_qs(u.query)
        tail = u.path[len("/traces"):].strip("/")
        if not tail:
            return 200, t.recorder.list()
        if cluster_fn is not None and \
                (q.get("cluster") or ["0"])[0] not in ("", "0", "false"):
            return cluster_fn(tail)
        follow = (q.get("follow") or ["1"])[0] not in ("0", "false")
        out = t.export_chrome(tail, follow_links=follow)
        if out is None:
            return 404, {"error": "unknown trace", "trace_id": tail}
        return 200, out

    def _stats(path: str, body: bytes):
        return 200, {"enabled": t.enabled,
                     "sample_rate": t.sample_rate,
                     "spans": t.span_stats()}

    ops.register_route("GET", "/traces", _traces)
    ops.register_route("GET", "/spans/stats", _stats)
