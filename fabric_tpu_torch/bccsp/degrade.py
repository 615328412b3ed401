"""Graceful degradation wrapper for the BCCSP plane.

`DegradingProvider` fronts a primary (device) provider with a circuit
breaker and a software fallback that is guaranteed to produce identical
validation flags (both implement the same malformed-item-is-False
batch_verify contract):

  HEALTHY    batches go to the primary; exceptions from enqueue or
             resolve count against the breaker (the CUDA provider never
             falls back silently: it raises, and its `stats["fallbacks"]`
             stays 0, so the wrapper does not watch that counter)
  DEGRADED   the breaker tripped: batches route straight to the SW
             fallback, skipping the cost of a doomed device attempt;
             a cooldown timer (exponential per trip) arms a probe
  PROBE      first batch after cooldown goes to the primary again —
             success restores HEALTHY, failure re-trips with a longer
             cooldown

Every transition emits `bccsp_degraded` (gauge), a
`bccsp_breaker_transitions_total` count, a jlog line, and a span event
on the ambient trace.  Signing, key-gen, and hashing are host-side in
every provider and always delegate to the primary.

The ops plane reads `.backend`: "cuda" while healthy, "sw(degraded)"
while tripped.  `fallback_batches` and `fallback_items` count what the
SW fallback verified, for any reason (a failed enqueue or resolve, or
a batch routed there while tripped): a caller that must not lose the
card reads them as 0.

Counterpart of `fabric_tpu/bccsp/degrade.py` on the port's imports.
The breaker's threshold and cooldowns are module constants (the
reference's defaults, which no caller changes), and the reference's
watch on a primary's silent fallbacks is left out: the port's primary
raises instead.  `factory.init_factories` wraps a provider in it only
when asked (`degrade=True`); the CUDA default is fail-stop.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Sequence

import numpy as np

from fabric_tpu_torch.ops_plane import tracing
from fabric_tpu_torch.ops_plane.logging import jlog

from .provider import Provider, VerifyItem

logger = logging.getLogger("fabric_tpu_torch.bccsp.degrade")

FAILURE_THRESHOLD = 2          # consecutive primary failures that trip
COOLDOWN_BASE_S = 1.0          # first trip's cooldown; doubles a trip
COOLDOWN_MAX_S = 30.0


class DegradingProvider(Provider):
    def __init__(self, primary: Provider, fallback: Provider):
        self.primary = primary
        self.sw = fallback
        self.name = primary.name
        self._lock = threading.Lock()
        self._degraded = False
        self._consec_fails = 0
        self._trips = 0
        self._probe_at = 0.0
        self.fallback_batches = 0
        self.fallback_items = 0

    # -- breaker --------------------------------------------------------

    @property
    def degraded(self) -> bool:
        return self._degraded

    @property
    def backend(self) -> str:
        return (f"{self.sw.name}(degraded)" if self._degraded
                else self.primary.name)

    def _use_primary(self) -> bool:
        """Route the next batch to the primary?  True also arms the
        post-cooldown probe."""
        if not self._degraded:
            return True
        with self._lock:
            if self._degraded and time.monotonic() >= self._probe_at:
                # push the next probe out so concurrent batches don't
                # stampede a sick device; success clears everything
                self._probe_at = time.monotonic() + COOLDOWN_BASE_S
                return True
            return False

    def _on_success(self) -> None:
        with self._lock:
            self._consec_fails = 0
            if not self._degraded:
                return
            self._degraded = False
            self._trips_observe("restored")

    def _on_failure(self, why: str) -> None:
        with self._lock:
            self._consec_fails += 1
            if self._degraded:
                # failed probe: back off harder
                self._trips += 1
                self._probe_at = time.monotonic() + self._cooldown()
                return
            if self._consec_fails < FAILURE_THRESHOLD:
                return
            self._degraded = True
            self._trips += 1
            self._probe_at = time.monotonic() + self._cooldown()
            self._trips_observe(why)

    def _cooldown(self) -> float:
        return min(COOLDOWN_MAX_S,
                   COOLDOWN_BASE_S * (2 ** min(self._trips - 1, 16)))

    def _trips_observe(self, reason: str) -> None:
        """Caller holds self._lock; everything here is best-effort."""
        state = "degraded" if self._degraded else "healthy"
        try:
            from fabric_tpu_torch.ops_plane import registry
            registry.gauge(
                "bccsp_degraded",
                "1 while the crypto provider runs on the SW fallback"
            ).set(1.0 if self._degraded else 0.0)
            registry.counter(
                "bccsp_breaker_transitions_total",
                "crypto-provider breaker state changes").add(
                    1, to=state, reason=reason)
            jlog(logger, "bccsp.breaker",
                 level=logging.WARNING if self._degraded else logging.INFO,
                 state=state, reason=reason, trips=self._trips,
                 backend=self.backend)
            tracing.event("bccsp." + state, reason=reason,
                          backend=self.backend)
        except Exception:
            pass

    # -- verification ---------------------------------------------------

    def _fallback(self, items: list):
        """The SW fallback's async verify of `items`, counted."""
        with self._lock:
            self.fallback_batches += 1
            self.fallback_items += len(items)
        return self.sw.batch_verify_async(items)

    def batch_verify_async(self, items: Sequence[VerifyItem]):
        items = list(items)
        if not self._use_primary():
            return self._fallback(items)
        try:
            resolve = self.primary.batch_verify_async(items)
        except Exception as exc:
            self._on_failure("enqueue:" + type(exc).__name__)
            logger.warning("primary bccsp enqueue failed (%r); "
                           "falling back to %s", exc, self.sw.name)
            return self._fallback(items)

        def _resolve():
            try:
                out = resolve()
            except Exception as exc:
                self._on_failure("resolve:" + type(exc).__name__)
                logger.warning("primary bccsp resolve failed (%r); "
                               "re-verifying %d items on %s",
                               exc, len(items), self.sw.name)
                return self._fallback(items)()
            self._on_success()
            return out

        return _resolve

    def batch_verify(self, items: Sequence[VerifyItem]) -> np.ndarray:
        return self.batch_verify_async(items)()

    # -- host-side verbs ------------------------------------------------

    def key_gen(self, scheme: str):
        return self.primary.key_gen(scheme)

    def sign(self, private_key, payload: bytes) -> bytes:
        return self.primary.sign(private_key, payload)

    def hash(self, data: bytes, algo: str = "sha256") -> bytes:
        return self.primary.hash(data, algo)

    def stats_snapshot(self):
        snap = getattr(self.primary, "stats_snapshot", None)
        return snap() if callable(snap) else None

    def __getattr__(self, name):
        # anything this wrapper doesn't own (stats, idemix probes,
        # device labels, ...) belongs to the primary — callers must not
        # have to care whether the provider is breaker-fronted
        return getattr(self.primary, name)
