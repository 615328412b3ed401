"""Ordering service plane: the parts the peer and its tests need.

Counterpart of `fabric_tpu/orderer`, so far these modules, each a whole
copy on the port's imports: the block cutter (`blockcutter`:
`BatchConfig`, `BlockCutter`), the message processor (`msgprocessor`:
`classify`, `StandardChannelProcessor`), the block writer and signature
(`blockwriter`), and the deliver stream (`deliver`); and two partial
modules the byzantine monitor reads: `raft` (only `entry_signed_bytes`)
and `cluster` (only `cert_fingerprint`).  Consensus (solo, the Raft
state machine), broadcast, the cluster's transport and the registrar
come with the port's orderer.
"""

from fabric_tpu_torch.orderer.blockcutter import BatchConfig, BlockCutter
from fabric_tpu_torch.orderer.blockwriter import (
    BlockWriter,
    block_signed_bytes,
    block_signature_items,
)
from fabric_tpu_torch.orderer.msgprocessor import (
    MsgClass,
    MsgProcessorError,
    StandardChannelProcessor,
    classify,
)
from fabric_tpu_torch.orderer.deliver import DeliverHandler, SeekInfo

__all__ = [
    "BatchConfig", "BlockCutter", "BlockWriter", "block_signed_bytes",
    "block_signature_items", "MsgClass", "MsgProcessorError",
    "StandardChannelProcessor", "classify", "DeliverHandler", "SeekInfo",
]
