"""_lifecycle system chaincode: chaincode definitions as consensus state.

Reference parity: core/chaincode/lifecycle/{lifecycle,cache}.go — org
approvals and committed definitions live in the `_lifecycle` namespace of
the channel state, so they replicate through ordinary ordering + commit;
the validator's plugin dispatcher reads each namespace's endorsement
policy from that state (plugindispatcher/dispatcher.go:102 via the
lifecycle cache).

Counterpart of `fabric_tpu/chaincode/lifecycle.py`, the same code on the
port's imports.  Its `LifecyclePolicyProvider` is what the port's
`committer.TxValidator` takes as `policies`: each block's endorsement
policies are then read from committed `_lifecycle` state.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from fabric_tpu_torch.chaincode.runtime import ChaincodeDefinition, Contract
from fabric_tpu_torch.chaincode.stub import ChaincodeStub, SimulationError
from fabric_tpu_torch.ledger.statedb import StateDB
from fabric_tpu_torch.policy import SignaturePolicy
from fabric_tpu_torch.utils import serde

LIFECYCLE_NS = "_lifecycle"


def _def_key(name: str) -> str:
    return f"namespaces/fields/{name}/definition"


def _approval_key(name: str, sequence: int, mspid: str) -> str:
    return f"namespaces/fields/{name}/approvals/{sequence}/{mspid}"


class LifecycleContract(Contract):
    """The `_lifecycle` contract: approve_for_org / commit / query.

    approve: records the calling org's approval of (name, sequence, ...).
    commit : requires approvals recorded for the majority of the
             channel's org set (lifecycle's default LifecycleEndorsement
             majority policy), then writes the definition.

    `msp_ids` is either a static org list (single-channel/test use) or
    a callable(channel_id) -> org list, so a node-global contract
    instance evaluates each channel's commit against THAT channel's
    live org set — a fixed bootstrap-channel list would let an
    under-approved definition commit on a wider channel.
    """

    def __init__(self, msp_ids):
        self._msp_ids = msp_ids

    def _orgs(self, stub: ChaincodeStub) -> List[str]:
        if callable(self._msp_ids):
            return sorted(self._msp_ids(
                getattr(stub, "channel_id", None)))
        return sorted(self._msp_ids)

    def invoke(self, stub: ChaincodeStub, fn: str, args: List[bytes]) -> bytes:
        if fn == "approve_for_org":
            return self._approve(stub, *args)
        if fn == "commit":
            return self._commit(stub, *args)
        if fn == "query_definition":
            return self._query(stub, *args)
        raise SimulationError(f"unknown lifecycle function {fn!r}")

    def _approve(self, stub: ChaincodeStub, name: bytes, version: bytes,
                 sequence: bytes, policy: bytes = b"") -> bytes:
        # the approval is bound to the SUBMITTER's org — never an argument,
        # or any org could forge the others' approvals
        mspid_s = self._creator_mspid(stub)
        seq = int(sequence)
        stub.put_state(_approval_key(name.decode(), seq, mspid_s),
                       serde.encode({"version": version.decode(),
                                     "policy": policy}))
        return b"approved"

    def _commit(self, stub: ChaincodeStub, name: bytes, version: bytes,
                sequence: bytes, policy: bytes = b"") -> bytes:
        name_s, seq = name.decode(), int(sequence)
        want = serde.encode({"version": version.decode(), "policy": policy})
        orgs = self._orgs(stub)
        approvals = 0
        for mspid in orgs:
            got = stub.get_state(_approval_key(name_s, seq, mspid))
            if got == want:
                approvals += 1
        if not orgs or approvals <= len(orgs) // 2:
            raise SimulationError(
                f"insufficient approvals for {name_s} seq {seq}: "
                f"{approvals}/{len(orgs)}")
        prev = stub.get_state(_def_key(name_s))
        if prev is not None and serde.decode(prev)["sequence"] >= seq:
            raise SimulationError(f"sequence {seq} already committed")
        stub.put_state(_def_key(name_s), serde.encode({
            "version": version.decode(), "policy": policy, "sequence": seq}))
        return b"committed"

    def _query(self, stub: ChaincodeStub, name: bytes) -> bytes:
        got = stub.get_state(_def_key(name.decode()))
        if got is None:
            raise SimulationError(f"no definition for {name.decode()!r}")
        return got

    @staticmethod
    def _creator_mspid(stub: ChaincodeStub) -> str:
        try:
            return serde.decode(stub.creator)["mspid"]
        except Exception:
            raise SimulationError("cannot derive creator mspid")


# ---------------------------------------------------------------------------
# install / package (lifecycle.go InstallChaincode + persistence/)
# ---------------------------------------------------------------------------

def package_chaincode(label: str, code: bytes,
                      metadata: Optional[dict] = None) -> bytes:
    """Build a chaincode package (the reference's tar.gz package role:
    persistence/chaincode_package.go) — canonical serde of label +
    metadata + code bytes."""
    if not label or any(c in label for c in "/\\:"):
        raise ValueError("invalid package label")
    return serde.encode({"label": label, "code": code,
                         "metadata": metadata or {}})


def package_id(pkg: bytes) -> str:
    """`label:sha256(pkg)` — the hash-addressed package identity
    (persistence.PackageID)."""
    import hashlib
    label = serde.decode(pkg)["label"]
    return f"{label}:{hashlib.sha256(pkg).hexdigest()}"


class ChaincodeInstaller:
    """Installed-chaincode store (lifecycle.go InstallChaincode /
    QueryInstalledChaincodes): packages persisted by package id under a
    directory, content-addressed so re-install is idempotent and a
    tampered package can never impersonate an id."""

    def __init__(self, root: str):
        import os
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, pid: str) -> str:
        # filename = content hash only: labels may contain any filename
        # character, so the hash (hex) is the unambiguous disk key
        import os
        return os.path.join(self.root, pid.rsplit(":", 1)[1] + ".pkg")

    def install(self, pkg: bytes) -> str:
        import os
        pid = package_id(pkg)
        path = self._path(pid)
        if not os.path.exists(path):
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(pkg)
            os.replace(tmp, path)
        return pid

    def get(self, pid: str) -> Optional[bytes]:
        import hashlib
        import os
        path = self._path(pid)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            pkg = f.read()
        try:
            ok = package_id(pkg) == pid
        except Exception:
            ok = False
        if not ok:
            raise ValueError(f"installed package {pid} corrupted on disk")
        return pkg

    def installed(self) -> List[str]:
        import os
        out = []
        for fname in sorted(os.listdir(self.root)):
            if not fname.endswith(".pkg"):
                continue
            with open(os.path.join(self.root, fname), "rb") as f:
                try:
                    out.append(package_id(f.read()))
                except Exception:
                    continue       # unreadable package: skip
        return sorted(out)


class LifecyclePolicyProvider:
    """policy_for(namespace) backed by committed _lifecycle state — the
    validator-side lifecycle cache (lifecycle/cache.go) feeding the plugin
    dispatcher.  Falls back to `default` (channel majority-endorsement)."""

    def __init__(self, db: StateDB, default: Optional[SignaturePolicy] = None,
                 system_policies: Optional[Dict[str, SignaturePolicy]] = None):
        self.db = db
        self.default = default
        self.system = dict(system_policies or {})

    def set_policy(self, namespace: str, policy: SignaturePolicy) -> None:
        """Static override for system namespaces (e.g. _lifecycle itself)."""
        self.system[namespace] = policy

    def policy_for(self, namespace: str) -> Optional[SignaturePolicy]:
        if namespace in self.system:
            return self.system[namespace]
        vv = self.db.get(LIFECYCLE_NS, _def_key(namespace))
        if vv is not None:
            raw = serde.decode(vv.value).get("policy", b"")
            if raw:
                return SignaturePolicy.deserialize(raw)
            return self.default
        return None  # undefined chaincode: validator flags INVALID_CHAINCODE

    def definition_for(self, namespace: str) -> Optional[ChaincodeDefinition]:
        vv = self.db.get(LIFECYCLE_NS, _def_key(namespace))
        if vv is None:
            return None
        d = serde.decode(vv.value)
        return ChaincodeDefinition(namespace, d["version"],
                                   d.get("policy", b""), d["sequence"])
