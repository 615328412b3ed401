"""Block delivery streams (server side).

Reference parity: common/deliver/deliver.go — Handle (:157) parses a
SeekInfo envelope and deliverBlocks (:199) streams blocks from the
channel ledger, blocking at the chain tip when behavior=BLOCK_UNTIL_READY.
The reader ACL (deliver/acl.go re-evaluated on config change) maps to the
readers-policy check in `authorize`.

Counterpart of `fabric_tpu/orderer/deliver.py`, the same code on the port's
imports.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Iterator, Optional

from fabric_tpu_torch.policy import SignedData
from fabric_tpu_torch.protocol import Block

SEEK_OLDEST = "oldest"
SEEK_NEWEST = "newest"

BEHAVIOR_BLOCK_UNTIL_READY = "block_until_ready"
BEHAVIOR_FAIL_IF_NOT_READY = "fail_if_not_ready"


class DeliverError(Exception):
    pass


class NotReadyError(DeliverError):
    """Seek past the tip with FAIL_IF_NOT_READY."""


@dataclass(frozen=True)
class SeekInfo:
    """ab.SeekInfo: start/stop positions. int = specified block number."""
    start: object = SEEK_OLDEST        # int | "oldest" | "newest"
    stop: Optional[object] = None      # int | "newest" | None (= stream forever)
    behavior: str = BEHAVIOR_BLOCK_UNTIL_READY


class DeliverHandler:
    """deliver.Handler bound to a registrar of channels."""

    def __init__(self, registrar):
        self.registrar = registrar

    def deliver(self, channel_id: str, seek: SeekInfo,
                signed: Optional[SignedData] = None,
                timeout_s: Optional[float] = None) -> Iterator[Block]:
        """Generator of blocks per the seek request.

        `signed` is the deliver request's creator triple, checked against
        the channel Readers policy when the channel enforces one.

        When the request rode in on a traced RPC (the req frame carried
        a traceparent — e.g. a leader peer's gossip.pull_window), the
        stream is timed under an `orderer.deliver` child span; untraced
        traffic records nothing (require_parent).
        """
        from fabric_tpu_torch.ops_plane import tracing
        span = tracing.tracer.start_span(
            "orderer.deliver", require_parent=True,
            attributes={"channel": channel_id})
        sent = 0
        status = "OK"
        try:
            support = self.registrar.get(channel_id)
            if support is None:
                raise DeliverError(f"unknown channel {channel_id!r}")
            support.authorize_read(signed)

            height = support.ledger.height
            start = self._resolve(seek.start, height)
            stop = (self._resolve(seek.stop, height)
                    if seek.stop is not None else None)
            if stop is not None and stop < start:
                raise DeliverError(f"seek stop {stop} < start {start}")
            span.set_attribute("start", start)

            num = start
            while stop is None or num <= stop:
                if num >= support.ledger.height:
                    if seek.behavior == BEHAVIOR_FAIL_IF_NOT_READY:
                        raise NotReadyError(
                            f"block {num} past tip {support.ledger.height}")
                    if not support.wait_for_height(num + 1, timeout_s):
                        return  # timed out waiting at the tip
                yield support.ledger.get_by_number(num)
                sent += 1
                num += 1
        except NotReadyError:
            raise    # at-tip is the normal end of a window pull
        except BaseException as e:   # incl. GeneratorExit on client cancel
            span.set_attribute("error", repr(e))
            status = "ERROR"
            raise
        finally:
            span.set_attribute("blocks", sent)
            span.end(status=status)

    @staticmethod
    def _resolve(pos, height: int) -> int:
        if pos == SEEK_OLDEST:
            return 0
        if pos == SEEK_NEWEST:
            return max(0, height - 1)
        return int(pos)
