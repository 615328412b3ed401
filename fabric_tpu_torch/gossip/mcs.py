"""Message crypto service: the gossip plane's verification gateway.

Reference parity: internal/peer/gossip/mcs.go — VerifyBlock (:124,
orderer signature over the block) and VerifyByChannel/Verify (:204, peer
message signatures).  Batch-first: `block_verify_items` exposes the block
check as batchable VerifyItems so a catch-up window of blocks is one
device dispatch; `verify_peer_msg` stays immediate (interactive path).

Counterpart of `fabric_tpu/gossip/mcs.py`, the same code on the port's
imports.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from fabric_tpu_torch.msp import deserialize_from_msps
from fabric_tpu_torch.orderer.blockwriter import block_signature_items
from fabric_tpu_torch.protocol import Block


class MessageCryptoService:
    def __init__(self, msps: Dict[str, object], provider):
        self.msps = msps
        self.provider = provider

    # -- block verification (mcs.go:124) ------------------------------------

    def block_verify_items(self, block: Block):
        """VerifyItems for a block's orderer signature(s), or None when
        structurally invalid (no/malformed signature metadata)."""
        if block.header.data_hash != self._data_hash(block):
            return None  # data does not match the signed header
        return block_signature_items(block, self.msps)

    def verify_block(self, block: Block) -> bool:
        items = self.block_verify_items(block)
        if not items:
            return False
        return bool(np.asarray(self.provider.batch_verify(items)).all())

    def verify_window(self, blocks: List[Block]) -> List[bool]:
        """Batch-verify a window of blocks in ONE provider dispatch
        (the streaming window of the deliver client).  Structural failures
        short-circuit to False without touching the device."""
        spans: List[Optional[slice]] = []
        items = []
        for block in blocks:
            bi = self.block_verify_items(block)
            if not bi:
                spans.append(None)
                continue
            spans.append(slice(len(items), len(items) + len(bi)))
            items.extend(bi)
        verdicts = (np.asarray(self.provider.batch_verify(items))
                    if items else np.zeros(0, dtype=bool))
        return [bool(verdicts[s].all()) if s is not None else False
                for s in spans]

    @staticmethod
    def _data_hash(block: Block) -> bytes:
        # BlockView exposes the hash over its raw data span — identical
        # bytes to block_data_hash(block.data) without materializing the
        # per-envelope list (protocol/wire.py layout fact)
        pre = getattr(block, "computed_data_hash", None)
        if pre is not None:
            return pre
        from fabric_tpu_torch.protocol.types import block_data_hash
        return block_data_hash(block.data)

    # -- peer message verification (mcs.go:204) ------------------------------

    def verify_peer_msg(self, identity: bytes, msg: bytes,
                        signature: bytes) -> bool:
        ident = deserialize_from_msps(self.msps, identity, validate=True)
        if ident is None:
            return False
        try:
            return ident.verify(msg, signature)
        except Exception:
            return False
