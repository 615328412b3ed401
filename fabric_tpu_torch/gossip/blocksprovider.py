"""Peer-side deliver client: pull blocks from the ordering service.

Reference parity: internal/pkg/peer/blocksprovider/blocksprovider.go —
DeliverBlocks (:113) seeks from the current ledger height, verifies each
block's orderer signature (:226 -> mcs.go:124), and hands verified blocks
to gossip for dissemination + commit; reconnects with capped exponential
backoff on stream failure.  core/deliverservice/deliveryclient.go:82
starts/stops one provider per channel when leadership changes.

Batch-first: `pull_window` fetches up to `window` blocks and verifies all
their orderer signatures in ONE batched dispatch (mcs.verify_window)
before committing any.

Counterpart of `fabric_tpu/gossip/blocksprovider.py`, the same code on the port's
imports.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional

from fabric_tpu_torch.orderer.deliver import (
    BEHAVIOR_FAIL_IF_NOT_READY,
    DeliverError,
    NotReadyError,
    SeekInfo,
)
from fabric_tpu_torch.ops_plane import tracing

logger = logging.getLogger("fabric_tpu_torch.gossip.blocksprovider")


class BlocksProvider:
    """One channel's orderer puller (runs on the elected leader peer)."""

    def __init__(self, channel_id: str, deliver_handler, gossip_state,
                 mcs=None, window: int = 32,
                 backoff_base_s: float = 0.05, backoff_max_s: float = 2.0,
                 signed=None, standing=None):
        self.channel_id = channel_id
        self.deliver = deliver_handler   # orderer DeliverHandler (or client)
        self.state = gossip_state
        self.mcs = mcs
        self.window = window
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.signed = signed
        # optional callable(sender identity) -> bool: True means the
        # stream's source is quarantined.  A standing-aware deliver
        # client (node/peer.RemoteDeliver) only serves from such a
        # source as a last resort, so a flagged window is counted and
        # logged here — visibility that the channel is running degraded,
        # not a refusal (the byzantine monitor still judges every block)
        self.standing = standing
        self.last_resort_windows = 0
        self._failures = 0
        self._stopped = False

    # -- one-shot window pull (deterministic; loop() wraps it) ---------------

    def pull_window(self) -> int:
        """Fetch + batch-verify + hand over up to `window` blocks.
        Returns how many blocks were accepted.

        The whole pull runs under a `gossip.pull_window` root span, so
        the deliver req frame carries a traceparent (comm/rpc.py attaches
        "tp" from the ambient context) and the orderer's `orderer.deliver`
        span lands in the SAME trace — one /traces/<id> export covers
        seek, stream, window sig-verify and handover.  These traces are
        high-frequency (one per poll); cap them with the recorder's
        per-root retention policy (tracing config `retention`)."""
        height = self.state.committer.height
        with tracing.tracer.start_span(
                "gossip.pull_window",
                attributes={"channel": self.channel_id, "height": height,
                            "window": self.window}) as span:
            blocks: List = []
            sender = None
            try:
                for item in self.deliver.deliver(
                        self.channel_id,
                        SeekInfo(start=height, stop=height + self.window - 1,
                                 behavior=BEHAVIOR_FAIL_IF_NOT_READY),
                        signed=self.signed):
                    # deliver handlers yield bare blocks; standing-aware
                    # clients yield (block, attests, sender)
                    if isinstance(item, tuple):
                        block, sender = item[0], item[2]
                    else:
                        block = item
                    blocks.append(block)
            except NotReadyError:
                pass  # reached the orderer tip mid-window: fine
            except DeliverError as e:
                self._failures += 1
                logger.warning("[%s] deliver failed (%d): %s",
                               self.channel_id, self._failures, e)
                span.set_attribute("error", str(e))
                return 0
            except Exception as e:
                # transport-level death (RpcClosed/RpcTimeout/ConnectionError
                # — a severed channel or partitioned orderer), not a deliver
                # protocol error: same retry treatment, the loop()'s backoff
                # + re-pull IS the catch-up path once the partition heals
                self._failures += 1
                logger.warning("[%s] deliver transport failed (%d): %r",
                               self.channel_id, self._failures, e)
                span.set_attribute("error", repr(e))
                return 0
            if not blocks:
                if self._failures:
                    self._mark_healed(0)   # reachable again, already at tip
                return 0
            if (self.standing is not None and sender is not None
                    and self.standing(sender)):
                self.last_resort_windows += 1
                logger.warning(
                    "[%s] window served by a QUARANTINED source (last "
                    "resort; every healthy endpoint failed)",
                    self.channel_id)
                span.set_attribute("last_resort", True)
                try:
                    from fabric_tpu_torch.ops_plane import registry
                    registry.counter(
                        "gossip_deliver_last_resort_total",
                        "deliver windows pulled from a quarantined "
                        "source").add(1, channel=self.channel_id)
                except Exception:
                    pass
            if self.mcs is not None:
                with tracing.tracer.start_span(
                        "gossip.verify_window",
                        attributes={"blocks": len(blocks)}):
                    verdicts = self.mcs.verify_window(blocks)  # ONE dispatch
            else:
                verdicts = [True] * len(blocks)
            accepted = 0
            for block, ok in zip(blocks, verdicts):
                if not ok:
                    self._failures += 1
                    logger.error("[%s] block %d failed orderer-sig verify; "
                                 "dropping rest of window", self.channel_id,
                                 block.header.number)
                    break  # later blocks chain off the bad one
                self.state.add_block(block)
                accepted += 1
            span.set_attribute("blocks", len(blocks))
            span.set_attribute("accepted", accepted)
            if accepted:
                if self._failures:
                    self._mark_healed(accepted)
                self._failures = 0
            return accepted

    def _mark_healed(self, accepted: int) -> None:
        """First successful deliver contact after a failure streak."""
        from fabric_tpu_torch.ops_plane.logging import jlog
        jlog(logger, "deliver.healed", channel=self.channel_id,
             failures=self._failures, accepted=accepted,
             height=self.state.committer.height)
        self._failures = 0
        try:
            from fabric_tpu_torch.ops_plane import registry
            registry.counter(
                "gossip_deliver_recoveries_total",
                "deliver reconnects after a failure streak").add(
                    1, channel=self.channel_id)
        except Exception:
            pass

    def catch_up(self, max_windows: int = 1000) -> int:
        """Drain to the orderer tip NOW: pull windows until one comes
        back empty.  The chaos harness calls this after healing a
        partition instead of waiting out the poll/backoff cadence; the
        steady-state loop() converges the same way, just slower."""
        total = 0
        for _ in range(max_windows):
            got = self.pull_window()
            total += got
            if got == 0:
                break
        return total

    def backoff_s(self) -> float:
        """Capped exponential backoff (blocksprovider.go retry loop)."""
        return min(self.backoff_max_s,
                   self.backoff_base_s * (2 ** min(self._failures, 16)))

    # -- continuous loop (real deployments; tests call pull_window) ----------

    def loop(self, poll_s: float = 0.05) -> None:
        while not self._stopped:
            got = self.pull_window()
            if got == 0:
                time.sleep(self.backoff_s() if self._failures else poll_s)

    def stop(self) -> None:
        self._stopped = True
