"""Ordering service plane.

Reference parity (SURVEY.md §2 "Ordering service", §3.4):
  orderer/common/blockcutter   -> blockcutter.BlockCutter
  orderer/common/msgprocessor  -> msgprocessor.{StandardChannelProcessor,...}
  orderer/common/multichannel  -> blockwriter.BlockWriter, registrar.Registrar
  orderer/consensus/solo       -> consensus.SoloChain
  orderer/consensus/etcdraft   -> raft.RaftNode + consensus.RaftChain
  orderer/common/broadcast     -> broadcast.BroadcastHandler
  common/deliver               -> deliver.DeliverHandler

Counterpart of `fabric_tpu/orderer/__init__.py`, whole, on the port's
imports: every module of the reference's ordering plane, the same
exports.
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
from fabric_tpu_torch.orderer.consensus import Chain, SoloChain
from fabric_tpu_torch.orderer.broadcast import BroadcastHandler, BroadcastResponse
from fabric_tpu_torch.orderer.deliver import DeliverHandler, SeekInfo
from fabric_tpu_torch.orderer.registrar import ChainSupport, Registrar

__all__ = [
    "BatchConfig", "BlockCutter", "BlockWriter", "block_signed_bytes",
    "block_signature_items", "MsgClass", "MsgProcessorError",
    "StandardChannelProcessor", "classify", "Chain", "SoloChain",
    "BroadcastHandler", "BroadcastResponse", "DeliverHandler", "SeekInfo",
    "ChainSupport", "Registrar",
]
