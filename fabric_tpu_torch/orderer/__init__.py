"""Ordering service plane: the parts the peer's block intake needs.

Counterpart of `fabric_tpu/orderer`, so far only its block writer and
signature (`blockwriter`: `BlockWriter`, `block_signed_bytes`,
`block_signature_items`) and its deliver stream (`deliver`:
`DeliverHandler`, `SeekInfo`), each a whole copy on the port's imports,
and two partial modules the byzantine monitor reads: `raft` (only
`entry_signed_bytes`) and `cluster` (only `cert_fingerprint`).  The
block cutter, message processor, consensus (solo, the Raft state
machine), broadcast, the cluster's transport and registrar come with the
port's orderer.
"""

from fabric_tpu_torch.orderer.blockwriter import (
    BlockWriter,
    block_signed_bytes,
    block_signature_items,
)
from fabric_tpu_torch.orderer.deliver import DeliverHandler, SeekInfo

__all__ = [
    "BlockWriter", "block_signed_bytes", "block_signature_items",
    "DeliverHandler", "SeekInfo",
]
