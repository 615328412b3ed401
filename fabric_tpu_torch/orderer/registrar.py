"""Multichannel registrar: per-channel ordering resources.

Reference parity: orderer/common/multichannel/registrar.go +
chainsupport.go — one ChainSupport per channel bundling the msg
processor, block cutter, block writer, and consenter chain; the
registrar creates channels from genesis blocks and routes broadcast/
deliver traffic to them.

Counterpart of `fabric_tpu/orderer/registrar.py`, whole, on the port's
imports: config blocks' Admins signatures and deliver's Readers check
verify through the channel's provider.  `ChainSupport.release()` wakes
the deliver streams waiting at the tip when the node stops (ROADMAP
C25).
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, Optional

from fabric_tpu_torch.ledger.blkstorage import BlockStore
from fabric_tpu_torch.orderer.blockcutter import BatchConfig, BlockCutter
from fabric_tpu_torch.orderer.blockwriter import BlockWriter
from fabric_tpu_torch.orderer.consensus import Chain, SoloChain
from fabric_tpu_torch.orderer.msgprocessor import StandardChannelProcessor
from fabric_tpu_torch.policy import PolicyEvaluator, SignaturePolicy, SignedData
from fabric_tpu_torch.protocol import Block


logger = logging.getLogger("fabric_tpu_torch.orderer.registrar")


class ChainSupport:
    """chainsupport.go ChainSupport: everything one channel needs."""

    def __init__(self, channel_id: str, ledger: BlockStore,
                 processor: StandardChannelProcessor, cutter: BlockCutter,
                 writer: BlockWriter, chain_factory: Callable[..., Chain],
                 readers_policy: Optional[SignaturePolicy] = None,
                 bundle_source=None):
        self.channel_id = channel_id
        self.ledger = ledger
        self.processor = processor
        self.cutter = cutter
        self.writer = writer
        self.readers_policy = readers_policy
        self.bundle_source = bundle_source
        self._tip_cond = threading.Condition()
        self._released = False
        self.chain = chain_factory(cutter=cutter, writer=writer,
                                   on_block=self._on_block)

    def _on_block(self, block: Block) -> None:
        if self.bundle_source is not None:
            # orderer-side config application: a written config block
            # atomically swaps the channel bundle (the reference updates the
            # bundle in multichannel BlockWriter for config blocks).
            try:
                from fabric_tpu_torch.config import apply_config_block
                apply_config_block(self.bundle_source, block,
                                   self.processor.provider)
            except Exception:
                logger.exception("config block application failed")
        with self._tip_cond:
            self._tip_cond.notify_all()

    def wait_for_height(self, height: int,
                        timeout_s: Optional[float] = None) -> bool:
        """Block until ledger height >= height (deliver tip waiting),
        or until `release()`."""
        with self._tip_cond:
            self._tip_cond.wait_for(
                lambda: self.ledger.height >= height or self._released,
                timeout=timeout_s)
            return self.ledger.height >= height

    def release(self) -> None:
        """Wake every deliver stream waiting at the tip, now and later,
        as if its wait had timed out: the node is stopping."""
        with self._tip_cond:
            self._released = True
            self._tip_cond.notify_all()

    def authorize_read(self, signed: Optional[SignedData]) -> None:
        """deliver/acl.go sessionAC equivalent: Readers policy check,
        re-resolved from the live bundle on every call (the reference
        re-evaluates the ACL on config changes, deliver/acl.go)."""
        readers = self.readers_policy
        if self.bundle_source is not None:
            readers = (self.bundle_source.current().policy("Readers")
                       or readers)
        if readers is None:
            return
        from fabric_tpu_torch.orderer.deliver import DeliverError
        if signed is None:
            raise DeliverError("deliver request not signed and channel "
                               "enforces a Readers policy")
        if not self.processor.evaluator.evaluate_signed_data(
                readers, [signed]):
            raise DeliverError("deliver request does not satisfy channel "
                               "Readers policy")


class Registrar:
    """registrar.go Registrar: channel_id -> ChainSupport."""

    def __init__(self):
        self._channels: Dict[str, ChainSupport] = {}
        self._lock = threading.RLock()

    def create_channel(self, channel_id: str, msps: Dict[str, object],
                       provider, writers_policy: SignaturePolicy,
                       readers_policy: Optional[SignaturePolicy] = None,
                       signer=None, batch_config: Optional[BatchConfig] = None,
                       ledger: Optional[BlockStore] = None,
                       genesis: Optional[Block] = None,
                       chain_factory: Callable[..., Chain] = SoloChain,
                       bundle_source=None) -> ChainSupport:
        with self._lock:
            if channel_id in self._channels:
                raise ValueError(f"channel {channel_id!r} already exists")
            ledger = ledger if ledger is not None else BlockStore()
            if genesis is not None and ledger.height == 0:
                ledger.add_block(genesis)
            cfg = batch_config or BatchConfig()
            config_source = None
            if bundle_source is not None:
                def config_source(_src=bundle_source):
                    b = _src.current().batch
                    return BatchConfig(
                        max_message_count=b.max_message_count,
                        absolute_max_bytes=b.absolute_max_bytes,
                        preferred_max_bytes=b.preferred_max_bytes,
                        batch_timeout_s=getattr(b, "timeout_s", 2.0))
            cutter = BlockCutter(cfg, config_source=config_source)
            writer = BlockWriter(channel_id, ledger, signer)
            processor = StandardChannelProcessor(
                channel_id, msps, provider, writers_policy,
                absolute_max_bytes=cfg.absolute_max_bytes,
                bundle_source=bundle_source)
            support = ChainSupport(channel_id, ledger, processor, cutter,
                                   writer, chain_factory, readers_policy,
                                   bundle_source=bundle_source)
            self._channels[channel_id] = support
            return support

    def get(self, channel_id: str) -> Optional[ChainSupport]:
        with self._lock:
            return self._channels.get(channel_id)

    def remove(self, channel_id: str) -> None:
        """channelparticipation Remove: drop the chain from this node
        (the ledger files remain on disk; rejoining resumes them)."""
        with self._lock:
            self._channels.pop(channel_id, None)

    def channels(self) -> Dict[str, ChainSupport]:
        with self._lock:
            return dict(self._channels)

    def halt_all(self) -> None:
        with self._lock:
            for support in self._channels.values():
                support.chain.halt()
