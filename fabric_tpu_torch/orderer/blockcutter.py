"""Batching of ordered envelopes into blocks.

Reference parity: orderer/common/blockcutter/blockcutter.go —
`Ordered` (:69) accumulates envelopes and cuts batches on
MaxMessageCount / PreferredMaxBytes; `Cut` (:127) flushes the pending
batch (driven by the consenter's batch timeout).

The batch size is a *performance-coupled* knob: blocks sized to the
device verify batch's sweet spot keep the commit-side dispatch
(committer/txvalidator.py) on the batched lanes, so
`BatchConfig.max_message_count` defaults to 512 rather than Fabric's 10.

Counterpart of `fabric_tpu/orderer/blockcutter.py`, whole, on the port's
imports.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from fabric_tpu_torch.protocol import Envelope


@dataclass(frozen=True)
class BatchConfig:
    """Orderer.BatchSize equivalent (sampleconfig/orderer.yaml)."""
    max_message_count: int = 512
    absolute_max_bytes: int = 10 * 1024 * 1024
    preferred_max_bytes: int = 2 * 1024 * 1024
    # Orderer.BatchTimeout (seconds) — enforced by the chain loop, not here
    batch_timeout_s: float = 2.0


class BlockCutter:
    """One channel's receiver (blockcutter.go receiver struct)."""

    def __init__(self, config: BatchConfig, config_source=None):
        self._static_config = config
        # optional callable returning the live BatchConfig (channel bundle);
        # committed config changes to batch limits then take effect on the
        # next ordered envelope, like the reference re-reads SharedConfig
        self._config_source = config_source
        self._pending: List[bytes] = []
        self._pending_bytes = 0

    @property
    def config(self) -> BatchConfig:
        if self._config_source is not None:
            cfg = self._config_source()
            if cfg is not None:
                return cfg
        return self._static_config

    def ordered(self, env: Envelope) -> Tuple[List[List[bytes]], bool]:
        """Enqueue one envelope; returns (cut_batches, pending_remaining).

        Semantics mirror blockcutter.go:69-125:
        - an envelope larger than preferred_max_bytes is cut as its own
          batch (isolated message), after first cutting any pending batch;
        - appending past preferred_max_bytes cuts the pending batch first;
        - reaching max_message_count cuts immediately.
        """
        raw = env.serialize()
        size = len(raw)
        batches: List[List[bytes]] = []

        if size > self.config.preferred_max_bytes:
            if self._pending:
                batches.append(self.cut())
            batches.append([raw])
            return batches, False

        if self._pending_bytes + size > self.config.preferred_max_bytes \
                and self._pending:
            batches.append(self.cut())

        self._pending.append(raw)
        self._pending_bytes += size

        if len(self._pending) >= self.config.max_message_count:
            batches.append(self.cut())

        return batches, bool(self._pending)

    def cut(self) -> List[bytes]:
        """Flush the pending batch (blockcutter.go:127 Cut)."""
        batch, self._pending, self._pending_bytes = self._pending, [], 0
        return batch

    @property
    def pending_count(self) -> int:
        return len(self._pending)
