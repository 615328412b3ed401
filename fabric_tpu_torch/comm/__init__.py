"""Authenticated communication plane (the reference's internal/pkg/comm).

SecureChannel: mutually authenticated AEAD connections bound to MSP
identities; RpcServer/RpcConnection: unary + streaming + one-way RPC on
top — the transport under Deliver, gossip and the snapshot fetch.

Counterpart of `fabric_tpu/comm`, the same code on the port's imports.
The handshake verifies the peer's transcript signature through the
factory's default provider: on the card, the CUDA provider (one item,
the generic lane).
"""

from . import faults
from .secure import HandshakeError, SecureChannel, SecureServer, dial
from .rpc import (RpcClosed, RpcConnection, RpcError, RpcServer,
                  RpcTimeout, connect)
from .faults import FaultPlan, FaultRule, FaultSchedule

__all__ = ["SecureChannel", "SecureServer", "HandshakeError", "dial",
           "RpcConnection", "RpcServer", "RpcError", "RpcTimeout",
           "RpcClosed", "connect", "faults", "FaultPlan", "FaultRule",
           "FaultSchedule"]
