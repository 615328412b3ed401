"""Chaincode plane: contract runtime, simulation stub, lifecycle.

Reference parity (SURVEY.md §2 "Endorsement side"):
  core/chaincode (gRPC FSM runtime)   -> runtime.ChaincodeRegistry (in-proc)
  shim GetState/PutState/...          -> stub.ChaincodeStub
  core/chaincode/lifecycle            -> lifecycle.LifecycleContract/_cache

Redesign note: Fabric launches chaincode as separate
Docker/external-builder processes speaking a gRPC state-machine protocol
(core/chaincode/handler.go).  Here contracts execute in-process against a
read-committed simulator — the process boundary bought isolation for
untrusted Go binaries, not performance, and the simulation results (rwsets)
are byte-identical either way.  An external-runner hook stays available via
runtime.ExternalContract for out-of-process contracts.

Counterpart of `fabric_tpu/chaincode`, the same code on the port's
imports: the stub, the registry, `_lifecycle` with its package store
and policy provider, the external chaincode process plane (`extcc`:
its wire protocol and `FABRIC_TPU_CC_*` launch environment are the
reference's, so either package's peer drives either package's
chaincode process) and the external builders.
"""

from .stub import ChaincodeStub, SimulationError
from .runtime import Contract, ChaincodeDefinition, ChaincodeRegistry, ExternalContract
from .lifecycle import LIFECYCLE_NS, LifecycleContract, LifecyclePolicyProvider

__all__ = ["ChaincodeStub", "SimulationError", "Contract",
           "ChaincodeDefinition", "ChaincodeRegistry", "ExternalContract",
           "LIFECYCLE_NS", "LifecycleContract", "LifecyclePolicyProvider"]
