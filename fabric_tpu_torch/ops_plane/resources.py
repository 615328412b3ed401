"""Process resource telemetry: stdlib /proc collector feeding /metrics.

The leak gate (ROADMAP direction #4) needs RSS, fd count, thread
count, GC pressure, native arena-pool occupancy and verdict-cache
occupancy AS TIME SERIES — none of which the registry records today.
This collector samples them on an interval into plain gauges, so the
existing exposition (`/metrics`), the SLO evaluator and the timeseries
ring store all pick them up with zero extra wiring:

  process_resident_memory_bytes   /proc/self/status VmRSS
  process_open_fds                len(/proc/self/fd)
  process_threads                 threading.active_count()
  process_allocated_blocks        sys.getallocatedblocks() — the
                                  crispest pure-Python ref-leak proxy
  process_gc_collections_total    gc.get_stats(), {generation=} label
  process_gc_uncollectable_total  gc.get_stats(), {generation=} label
  native_arena_pool_free          _fastparse.stats() pool gauges
  native_arena_pool_hit_total     (arena reuse economics; absent when
  native_arena_pool_miss_total     the native parser isn't built)
  native_arena_pool_drop_total
  cuda_allocated_bytes            torch.cuda.memory_allocated summed
                                  over the visible devices — only when
                                  CUDA is ALREADY initialised (the
                                  collector never initializes a device)

Extra per-node series (verdict-cache occupancy, queue depths...) ride
`add_source(name, fn)`: fn() -> float, sampled with the same cadence
and surfaced as a gauge of the same name.

Zero-overhead guarantee: gauges register at construction time, so a
node that leaves the `resources` config sub-dict disabled constructs
nothing and its /metrics output is byte-identical to before this
module existed.  All reads are stdlib (/proc, gc, sys, threading) and
every probe degrades to "metric absent" off-Linux or when a source is
missing, never to an exception on the sampling thread.

`provenance()` also lives here: the {platform, device_kind, n_devices,
hostname} stamp a measurement records, with "gpu" only when CUDA was
already in use.

Counterpart of `fabric_tpu/ops_plane/resources.py`: the device series
reads `torch.cuda` where the reference reads jax's live arrays, and its
gauge is named for what it reads.
"""

from __future__ import annotations

import gc
import logging
import os
import socket
import sys
import threading
import time
from typing import Callable, Dict, Optional

from .metrics import MetricsRegistry
from .metrics import registry as default_registry

logger = logging.getLogger("fabric_tpu_torch.ops_plane.resources")

__all__ = ["ResourceCollector", "read_rss_bytes", "count_open_fds",
           "provenance", "register_routes"]


def read_rss_bytes() -> Optional[float]:
    """VmRSS from /proc/self/status, bytes; None off-Linux."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) * 1024.0
    except OSError:
        pass
    return None


def count_open_fds() -> Optional[int]:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return None


def _cuda_in_use():
    """torch.cuda, when torch is already imported and CUDA is already
    initialised in this process; else None (never initialises it)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            return torch.cuda
    except Exception:
        pass
    return None


def provenance() -> dict:
    """Where a measurement ran: {platform, device_kind, n_devices,
    hostname}.  `platform` is "gpu" only when CUDA is available and
    already initialised in this process; everything else is
    "cpu-virtual".  Never initializes CUDA itself: callers that bench
    devices have already used it."""
    out = {"platform": "cpu-virtual", "device_kind": "unknown",
           "n_devices": 0, "hostname": socket.gethostname()}
    cuda = _cuda_in_use()
    if cuda is not None:
        try:
            out["n_devices"] = cuda.device_count()
            out["device_kind"] = str(cuda.get_device_name(0))
            out["platform"] = "gpu"
        except Exception:
            pass
    return out


class ResourceCollector:
    """Samples process/runtime resources into registry gauges.

    Config keys (the node's `resources` sub-dict):
      enabled       node-level gate (read by the node, not here)
      interval_s    sampling cadence (default 5.0)
      device_memory include cuda_allocated_bytes (default True; only
                    ever read when CUDA is already initialised)
    """

    def __init__(self, cfg: Optional[dict] = None, *,
                 registry: Optional[MetricsRegistry] = None,
                 clock=None):
        cfg = dict(cfg or {})
        self.registry = registry or default_registry
        self._clock = clock or time.monotonic
        self.interval_s = max(0.05, float(cfg.get("interval_s", 5.0)))
        self.device_memory = bool(cfg.get("device_memory", True))
        self._sources: Dict[str, Callable[[], float]] = {}
        self._g_rss = self.registry.gauge(
            "process_resident_memory_bytes", "VmRSS of this process")
        self._g_fds = self.registry.gauge(
            "process_open_fds", "open file descriptors")
        self._g_threads = self.registry.gauge(
            "process_threads", "live Python threads")
        self._g_blocks = self.registry.gauge(
            "process_allocated_blocks",
            "sys.getallocatedblocks() — live interpreter allocations")
        self._g_gc_coll = self.registry.gauge(
            "process_gc_collections_total", "GC runs per generation")
        self._g_gc_unc = self.registry.gauge(
            "process_gc_uncollectable_total",
            "uncollectable objects per generation")
        self._g_device = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def add_source(self, name: str, fn: Callable[[], float]) -> None:
        """Register an extra series: fn() -> float, sampled each
        collect into a gauge named `name` (exceptions skip the tick)."""
        self.registry.gauge(name, "resource collector source")
        self._sources[name] = fn

    # -- one sweep -----------------------------------------------------------

    def collect(self) -> dict:
        """Sample every source into its gauge; returns the snapshot."""
        snap: dict = {}
        rss = read_rss_bytes()
        if rss is not None:
            self._g_rss.set(rss)
            snap["process_resident_memory_bytes"] = rss
        fds = count_open_fds()
        if fds is not None:
            self._g_fds.set(float(fds))
            snap["process_open_fds"] = fds
        nthreads = float(threading.active_count())
        self._g_threads.set(nthreads)
        snap["process_threads"] = nthreads
        try:
            blocks = float(sys.getallocatedblocks())
            self._g_blocks.set(blocks)
            snap["process_allocated_blocks"] = blocks
        except Exception:
            pass
        try:
            for gen, st in enumerate(gc.get_stats()):
                self._g_gc_coll.set(float(st.get("collections", 0)),
                                    generation=str(gen))
                self._g_gc_unc.set(float(st.get("uncollectable", 0)),
                                   generation=str(gen))
            snap["process_gc_collections_total"] = sum(
                st.get("collections", 0) for st in gc.get_stats())
        except Exception:
            pass
        self._collect_native(snap)
        if self.device_memory:
            self._collect_device(snap)
        for name, fn in self._sources.items():
            try:
                v = float(fn())
            except Exception:
                continue
            self.registry.gauge(name).set(v)
            snap[name] = v
        return snap

    def _collect_native(self, snap: dict) -> None:
        """Arena-pool occupancy from the native parser's counters —
        the parse-path's reuse economics, absent until the block path has
        loaded _fastparse (the gauges simply never register; sampling
        never builds it)."""
        fastparse = sys.modules.get("fabric_tpu_torch.native._fastparse")
        if fastparse is None:
            return
        try:
            stats = fastparse.stats()
        except Exception:
            return
        for key, metric in (("pool_free", "native_arena_pool_free"),
                            ("pool_hit", "native_arena_pool_hit_total"),
                            ("pool_miss", "native_arena_pool_miss_total"),
                            ("pool_drop", "native_arena_pool_drop_total")):
            if key in stats:
                self.registry.gauge(metric).set(float(stats[key]))
                snap[metric] = float(stats[key])

    def _collect_device(self, snap: dict) -> None:
        """Device-memory bytes the caching allocator has handed out,
        summed over the visible devices — only when CUDA is ALREADY
        initialised (sampling must never initialize a device)."""
        cuda = _cuda_in_use()
        if cuda is None:
            return
        try:
            total = float(sum(cuda.memory_allocated(d)
                              for d in range(cuda.device_count())))
        except Exception:
            return
        if self._g_device is None:
            self._g_device = self.registry.gauge(
                "cuda_allocated_bytes",
                "torch.cuda.memory_allocated summed over the devices")
        self._g_device.set(total)
        snap["cuda_allocated_bytes"] = total

    # -- lifecycle -----------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.collect()
            except Exception:       # keep the collector alive
                logger.exception("resource collect failed")

    def start(self) -> "ResourceCollector":
        if self._thread is None:
            self._stop.clear()
            self.collect()          # first point lands immediately
            self._thread = threading.Thread(
                target=self._loop, name="resource-collector", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


def register_routes(ops, collector: ResourceCollector) -> None:
    """Mount GET /resources: one fresh snapshot as JSON (the same
    numbers the gauges carry, without parsing exposition text)."""

    def _resources(path: str, body: bytes):
        return 200, collector.collect()

    ops.register_route("GET", "/resources", _resources)
