"""Contract registry + execution engine.

Reference parity: core/chaincode/chaincode_support.go (Launch/Execute,
:79,:154) and core/container/externalbuilder — re-designed in-process (see
package docstring).  A ChaincodeDefinition mirrors the _lifecycle committed
definition (name, version, endorsement policy, sequence); execution renders
a response `(status, payload)` plus the rwset staged in the stub.

Counterpart of `fabric_tpu/chaincode/runtime.py`, the same code on the
port's imports.
"""

from __future__ import annotations

import subprocess
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from fabric_tpu_torch.chaincode.stub import ChaincodeStub, SimulationError


@dataclass(frozen=True)
class ChaincodeDefinition:
    """A committed chaincode definition (lifecycle.ChaincodeDefinition)."""
    name: str
    version: str
    policy_bytes: bytes = b""   # serialized SignaturePolicy; b"" = channel default
    sequence: int = 1


class Contract:
    """Base class for in-process contracts (the shim's Chaincode iface).

    Subclasses implement `invoke(stub, fn, args) -> bytes` and may raise
    SimulationError to produce a 500 response.
    """

    def invoke(self, stub: ChaincodeStub, fn: str, args: List[bytes]) -> bytes:
        raise NotImplementedError


class ExternalContract(Contract):
    """Out-of-process contract hook (externalbuilder run-style): executes a
    command that receives the invocation on stdin and returns state ops on
    stdout, for contracts that must not run in the peer process."""

    def __init__(self, argv: List[str], timeout_s: float = 30.0):
        self.argv = argv
        self.timeout_s = timeout_s

    def invoke(self, stub: ChaincodeStub, fn: str, args: List[bytes]) -> bytes:
        from fabric_tpu_torch.utils import serde
        req = serde.encode({"fn": fn, "args": list(args),
                            "channel": stub.channel_id, "txid": stub.txid})
        try:
            out = subprocess.run(self.argv, input=req, capture_output=True,
                                 timeout=self.timeout_s, check=True).stdout
        except subprocess.SubprocessError as e:
            raise SimulationError(f"external contract failed: {e}") from e
        resp = serde.decode(out)
        for op in resp.get("ops", []):
            if op["op"] == "put":
                stub.put_state(op["key"], op["value"])
            elif op["op"] == "del":
                stub.del_state(op["key"])
        return resp.get("payload", b"")


class ChaincodeRegistry:
    """namespace -> (definition, contract).  The Execute path of
    chaincode_support.go:154 without the process boundary."""

    def __init__(self):
        self._contracts: Dict[str, Tuple[ChaincodeDefinition, Contract]] = {}

    def install(self, definition: ChaincodeDefinition,
                contract: Contract) -> None:
        self._contracts[definition.name] = (definition, contract)

    def definition(self, name: str) -> Optional[ChaincodeDefinition]:
        entry = self._contracts.get(name)
        return entry[0] if entry else None

    def names(self) -> List[str]:
        return sorted(self._contracts)

    def execute(self, stub: ChaincodeStub, name: str, fn: str,
                args: List[bytes]) -> Tuple[int, bytes]:
        """Run one invocation; returns (status, payload). 500 on contract
        error — the rwset staged so far is DISCARDED by the caller then
        (failed simulations are not endorsed)."""
        entry = self._contracts.get(name)
        if entry is None:
            raise SimulationError(f"chaincode {name!r} not installed")
        _, contract = entry
        try:
            payload = contract.invoke(stub, fn, args)
            return 200, payload or b""
        except SimulationError:
            raise
        except Exception as e:
            raise SimulationError(f"contract {name!r} raised: {e}") from e

    def invoke_into(self, caller_stub: ChaincodeStub, name: str, fn: str,
                    args: List[bytes]) -> bytes:
        """cc2cc: run `name` against the caller's rwset, scoped to the
        callee namespace."""
        entry = self._contracts.get(name)
        if entry is None:
            raise SimulationError(f"chaincode {name!r} not installed")
        _, contract = entry
        return contract.invoke(caller_stub.scoped(name), fn, args) or b""


class FuncContract(Contract):
    """Adapter: register plain functions as contract methods."""

    def __init__(self, **handlers: Callable):
        self._handlers = handlers

    def invoke(self, stub: ChaincodeStub, fn: str, args: List[bytes]) -> bytes:
        if fn not in self._handlers:
            raise SimulationError(f"unknown function {fn!r}")
        return self._handlers[fn](stub, *args) or b""
