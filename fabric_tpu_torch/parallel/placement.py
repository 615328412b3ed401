"""Per-channel device placement: carve the device list into spans.

Counterpart of `fabric_tpu/parallel/placement.py`, copied: the same
EWMA, hysteresis, idle decay, span cache and `snapshot()`.  What
differs: a span's provider is a `CudaProvider(mesh=...)` over the span,
or, for a span of one device, `CudaProvider(device=...)` on it.  The
`placement_channel_devices` gauge and `_queue_backlog`'s read of
`provider_dispatch_queue_depth` go through the port's ops plane.

The reference's notes follow.

The reference validates channels independently — each channel gets its
own txvalidator goroutine pool sized by `peer.validatorPoolSize`
(core/committer/txvalidator/v20/validator.go), all contending for the
same host cores.  Here the contended resource is the device mesh: a
peer joined to N channels owns all 8 chips, and pinning every channel's
batches to the full mesh would serialize them through one compiled
program while 7/8 of each tile sits empty on light channels.

`PlacementScheduler` instead assigns each channel a **disjoint
contiguous device span** sized from its observed pressure (EWMA of the
per-flush batch sizes the validator reports via `demand`, plus the
process-global `provider_dispatch_queue_depth` backlog at report time —
a flush landing behind unresolved device work signals more pressure
than its batch size alone):

  - shares are powers of two (`mesh.allocate_devices`), so a channel's
    shard sizes are stable across rebalances;
  - spans are contiguous (`mesh.carve_submeshes`; on a TPU slice that
    keeps a sub-mesh on ICI neighbours, while the H100s of one host are
    joined all to all by NVLink);
  - rebalances are hysteretic: the carve is only redone when a new
    channel registers or some channel's demand drifts by more than
    `rebalance_ratio` from the demand snapshot the current carve was
    built from.  Providers are cached per device span, so a rebalance
    that hands a channel a span some earlier carve used re-attaches the
    already-warm provider (its banks already hold the channel's tables).

The scheduler never blocks a verify: `provider_for` does cheap host
bookkeeping and returns a provider; device work stays inside it.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from . import mesh as meshmod


class PlacementScheduler:
    def __init__(self, devices=None, provider_factory=None,
                 wrap: Optional[Callable] = None,
                 rebalance_ratio: float = 2.0,
                 ewma_alpha: float = 0.3,
                 idle_halflife_s: float = 30.0,
                 clock: Optional[Callable[[], float]] = None):
        """`provider_factory(mesh, device=None) -> Provider` builds the
        per-span provider (mesh None and the span's device when the span
        is one device); `wrap(provider) -> provider` optionally decorates
        each one once (the factory passes its degradation breaker,
        `bccsp.degrade.DegradingProvider`, here when asked to degrade)."""
        if devices is None:
            from ..device import visible_devices
            devices = visible_devices()
        if provider_factory is None:
            from ..bccsp.cuda import CudaProvider

            def provider_factory(m, device=None):
                return CudaProvider(mesh=m, device=device)
        self.devices = list(devices)
        self.provider_factory = provider_factory
        self.wrap = wrap
        self.rebalance_ratio = float(rebalance_ratio)
        self.ewma_alpha = float(ewma_alpha)
        self.idle_halflife_s = float(idle_halflife_s)
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        self._demand = {}          # channel -> EWMA of reported batch sizes
        self._last_report = {}     # channel -> clock() of last demand report
        self._carve_demand = {}    # demand snapshot the current carve used
        self._assign = {}          # channel -> (lo, size)
        self._providers = {}       # (lo, size) -> wrapped provider
        self.rebalances = 0

    # -- internals (callers hold self._lock) --------------------------------

    def _span_provider(self, lo: int, size: int):
        key = (lo, size)
        p = self._providers.get(key)
        if p is None:
            if size == 1:
                # one device: no mesh, the lanes pinned to the span's
                # device, not devices[0]
                p = self.provider_factory(None, device=self.devices[lo])
            else:
                m = meshmod.make_mesh(self.devices[lo:lo + size])
                p = self.provider_factory(m)
            if self.wrap is not None:
                p = self.wrap(p)
            self._providers[key] = p
        return p

    def _recarve(self):
        channels = sorted(self._demand)
        sizes = meshmod.allocate_devices(
            len(self.devices), [self._demand[c] for c in channels])
        lo = 0
        self._assign = {}
        for ch, sz in zip(channels, sizes):
            self._assign[ch] = (lo, sz)
            lo += sz
        self._carve_demand = dict(self._demand)
        self.rebalances += 1
        try:
            from ..ops_plane import registry
            g = registry.gauge(
                "placement_channel_devices",
                "devices assigned to each channel by the placement scheduler")
            for ch, (_, sz) in self._assign.items():
                g.set(float(sz), channel=ch)
        except Exception:
            pass

    def _decay_idle(self, now: float) -> None:
        """Halve a quiet channel's EWMA every `idle_halflife_s` it goes
        without reporting demand.  Without this a channel that went
        silent kept the demand of its last busy flush forever, pinning
        its device span until some OTHER channel's registration forced a
        recarve; with it, sustained silence drifts the demand past
        `rebalance_ratio` and the next flush on any channel releases the
        span back to the busy ones."""
        hl = self.idle_halflife_s
        if hl <= 0:
            return
        for ch, last in self._last_report.items():
            steps = int((now - last) // hl)
            if steps <= 0:
                continue
            d = self._demand.get(ch)
            if d is not None and d > 1e-6:
                self._demand[ch] = max(d * 0.5 ** steps, 1e-6)
            # advance by whole half-lives so decay never compounds per call
            self._last_report[ch] = last + steps * hl

    @staticmethod
    def _queue_backlog() -> float:
        """Process-global `provider_dispatch_queue_depth` — device
        dispatches enqueued but not yet resolved.  A flush that lands
        while earlier dispatches are still in flight is under-reporting
        pressure if only its own batch size counts, so the backlog is
        folded into the demand sample (the gauge is process-global; the
        reporting channel is the one currently contending with it)."""
        try:
            from ..ops_plane import registry
            g = registry.gauge(
                "provider_dispatch_queue_depth",
                "device dispatches enqueued, not yet resolved")
            return max(0.0, sum(g.values().values()))
        except Exception:
            return 0.0

    def _drifted(self) -> bool:
        for ch, d in self._demand.items():
            base = self._carve_demand.get(ch)
            if base is None:
                return True
            hi, lo = max(d, base, 1e-9), max(min(d, base), 1e-9)
            if hi / lo >= self.rebalance_ratio:
                return True
        return False

    # -- public API ----------------------------------------------------------

    def provider_for(self, channel_id: str, demand: Optional[int] = None):
        """The provider for `channel_id`'s current device span.

        `demand` is the caller's queue depth at this flush (batch size);
        it feeds the EWMA that sizes the next carve.  Registration of a
        new channel always recarves; otherwise only ratio drift does."""
        with self._lock:
            now = self._clock()
            a = self.ewma_alpha
            prev = self._demand.get(channel_id)
            if demand is not None and demand > 0:
                sample = float(demand) + self._queue_backlog()
                self._demand[channel_id] = (
                    sample if prev is None
                    else (1 - a) * prev + a * sample)
                self._last_report[channel_id] = now
            elif prev is None:
                self._demand[channel_id] = 1.0
                self._last_report[channel_id] = now
            self._decay_idle(now)
            new_channel = channel_id not in self._assign
            if new_channel or (self._drifted() and self._would_resize()):
                self._recarve()
            lo, size = self._assign[channel_id]
            return self._span_provider(lo, size)

    def _would_resize(self) -> bool:
        """True when recarving under current demand changes any span
        size — drift that allocates identically is not worth a carve."""
        channels = sorted(self._demand)
        sizes = meshmod.allocate_devices(
            len(self.devices), [self._demand[c] for c in channels])
        for ch, sz in zip(channels, sizes):
            cur = self._assign.get(ch)
            if cur is None or cur[1] != sz:
                return True
        return False

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "channels": {
                    ch: {"devices": sz, "span_start": lo,
                         "demand_ewma": round(self._demand.get(ch, 0.0), 2)}
                    for ch, (lo, sz) in self._assign.items()},
                "n_devices": len(self.devices),
                "rebalances": self.rebalances,
                "cached_spans": sorted(self._providers),
            }
