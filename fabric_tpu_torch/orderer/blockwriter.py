"""Block assembly + orderer block signature.

Reference parity: orderer/common/multichannel/blockwriter.go —
CreateNextBlock assembles the next block from a batch of envelopes;
WriteBlock stamps last-config metadata, signs the block with the
orderer's identity, and appends to the orderer blockledger.  The peer
later verifies exactly this signature (internal/peer/gossip/mcs.go:124
VerifyBlock) — `block_signature_items` emits that check as VerifyItems
so the delivery plane can fold orderer-sig verification into the same
device batch as the endorsement signatures.

Counterpart of `fabric_tpu/orderer/blockwriter.py`, the same code on the port's
imports.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from fabric_tpu_torch.bccsp import VerifyItem
from fabric_tpu_torch.ledger.blkstorage import BlockStore
from fabric_tpu_torch.msp import SigningIdentity, deserialize_from_msps
from fabric_tpu_torch.protocol import Block
from fabric_tpu_torch.protocol.build import new_nonce
from fabric_tpu_torch.protocol.types import (
    BlockHeader,
    BlockMetadata,
    block_data_hash,
)
from fabric_tpu_torch.protocol.types import (
    META_LAST_CONFIG,
    META_SIGNATURES,
)
from fabric_tpu_torch.utils import serde


def block_signed_bytes(block: Block, sig_header: dict, last_config: int) -> bytes:
    """The bytes the orderer signature covers: header ‖ sig-header ‖
    last-config (protoutil/blockutils.go SignatureHeader+BlockHeaderBytes)."""
    return serde.encode({
        "header": block.header.to_dict(),
        "sig_header": sig_header,
        "last_config": last_config,
    })


def block_signature_items(block: Block, msps: Dict[str, object]
                          ) -> Optional[List[VerifyItem]]:
    """MCS.VerifyBlock as batchable work: one VerifyItem per block
    signature, or None when the metadata is malformed / signer unknown."""
    sigs = block.metadata.items.get(META_SIGNATURES)
    last_config = block.metadata.items.get(META_LAST_CONFIG, 0)
    if not sigs:
        return None
    items: List[VerifyItem] = []
    for entry in sigs:
        try:
            sig_header = entry["sig_header"]
            ident = deserialize_from_msps(msps, sig_header["creator"],
                                          validate=True)
            if ident is None:
                return None
            msg = block_signed_bytes(block, sig_header, last_config)
            items.append(ident.verify_item(msg, entry["signature"]))
        except Exception:
            return None
    return items


class BlockWriter:
    """One channel's block producer (multichannel/blockwriter.go)."""

    def __init__(self, channel_id: str, ledger: BlockStore,
                 signer: Optional[SigningIdentity] = None):
        self.channel_id = channel_id
        self.ledger = ledger
        self.signer = signer
        info = ledger.chain_info()
        self._next_number = info.height
        self._prev_hash = info.current_hash if info.height else b"\x00" * 32
        self._last_config = self._recover_last_config()

    def _recover_last_config(self) -> int:
        if self.ledger.height == 0:
            return 0
        last = self.ledger.get_by_number(self.ledger.height - 1)
        return int(last.metadata.items.get(META_LAST_CONFIG, 0))

    def create_next_block(self, envelopes: Sequence[bytes]) -> Block:
        """blockwriter.go CreateNextBlock (input: serialized envelopes)."""
        data = list(envelopes)
        header = BlockHeader(self._next_number, self._prev_hash,
                             block_data_hash(data))
        return Block(header, data, BlockMetadata())

    def write_block(self, block: Block, is_config: bool = False) -> Block:
        """blockwriter.go WriteBlock/WriteConfigBlock: stamp last-config,
        sign, append.  Must be called with consecutive block numbers."""
        if block.header.number != self._next_number:
            raise ValueError(
                f"out-of-order write: got block {block.header.number}, "
                f"expected {self._next_number}")
        if is_config:
            self._last_config = block.header.number
        block.metadata.items[META_LAST_CONFIG] = self._last_config
        if self.signer is not None:
            sig_header = {"creator": self.signer.serialize(),
                          "nonce": new_nonce()}
            msg = block_signed_bytes(block, sig_header, self._last_config)
            block.metadata.items[META_SIGNATURES] = [{
                "sig_header": sig_header,
                "signature": self.signer.sign(msg),
            }]
        self.ledger.add_block(block)
        self._next_number += 1
        self._prev_hash = block.hash()
        return block

    def resync(self) -> None:
        """Re-derive position from the ledger after out-of-band appends
        (raft catch-up replication writes blocks directly to the store)."""
        info = self.ledger.chain_info()
        self._next_number = info.height
        self._prev_hash = info.current_hash if info.height else b"\x00" * 32
        self._last_config = self._recover_last_config()

    @property
    def height(self) -> int:
        return self._next_number
