"""Channel configuration as consensus state: typed config + live Bundle.

Reference parity:
  common/channelconfig/bundle.go     — immutable typed view of the config
  common/channelconfig/application.go, orderer.go, organization.go
  common/capabilities/*.go           — feature gating per channel
  common/configtx/validator.go       — config-tx validation & sequencing

Design (TPU-first framework, host-side control plane): a channel's
configuration is a serializable `ChannelConfig` value committed through
the ordering service like any transaction; every consumer (msgprocessor
writers filter, deliver readers ACL, txvalidator MSPs/policies, block
cutter batch limits) reads the *current* immutable `Bundle` through a
shared `BundleSource` and picks up the new bundle atomically when a
config block commits — mirroring how the reference resolves resources
through the bundle at each use (channelconfig/bundlesource.go).

Deviation from the reference, documented: config updates here carry the
full next ChannelConfig plus the expected sequence number, not a
read-set/write-set delta (configtx/update.go).  Validation still enforces
the two invariants that matter for safety: monotonic sequence (exactly
current+1) and authorization by the current Admins policy.

Counterpart of `fabric_tpu/config/channelconfig.py`, whole: a config
serializes to the reference's bytes.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from fabric_tpu_torch.msp import MSP, MSPConfig, Principal
from fabric_tpu_torch.msp.cache import CachedMSP
from fabric_tpu_torch.policy import (
    PolicyEvaluator,
    SignaturePolicy,
    SignedData,
    n_out_of,
    signed_by,
)
from fabric_tpu_torch.utils import serde


class ConfigError(Exception):
    """Config transaction rejected."""


# Capability names (common/capabilities/application.go flags, reduced to
# the ones this framework gates behavior on).
CAP_V2_0 = "V2_0"
CAP_KEY_LEVEL_ENDORSEMENT = "V1_3_KeyLevelEndorsement"


@dataclass(frozen=True)
class OrgConfig:
    """One organization: MSP material + org-scoped policy expressions."""
    mspid: str
    root_certs: tuple            # PEM bytes
    admins: tuple = ()           # PEM bytes of admin certs (by-identity role)
    intermediate_certs: tuple = ()
    crls: tuple = ()

    def to_dict(self) -> dict:
        return {"mspid": self.mspid, "root_certs": list(self.root_certs),
                "admins": list(self.admins),
                "intermediate_certs": list(self.intermediate_certs),
                "crls": list(self.crls)}

    @staticmethod
    def from_dict(d: dict) -> "OrgConfig":
        return OrgConfig(d["mspid"], tuple(d["root_certs"]),
                         tuple(d.get("admins", ())),
                         tuple(d.get("intermediate_certs", ())),
                         tuple(d.get("crls", ())))


@dataclass(frozen=True)
class BatchConfig:
    """orderer.BatchSize/BatchTimeout (orderer/common/localconfig)."""
    max_message_count: int = 500
    absolute_max_bytes: int = 10 * 1024 * 1024
    preferred_max_bytes: int = 2 * 1024 * 1024
    timeout_s: float = 2.0

    def to_dict(self) -> dict:
        return {"max_message_count": self.max_message_count,
                "absolute_max_bytes": self.absolute_max_bytes,
                "preferred_max_bytes": self.preferred_max_bytes,
                "timeout_ms": int(self.timeout_s * 1000)}

    @staticmethod
    def from_dict(d: dict) -> "BatchConfig":
        return BatchConfig(d["max_message_count"], d["absolute_max_bytes"],
                           d["preferred_max_bytes"], d["timeout_ms"] / 1000.0)


@dataclass(frozen=True)
class ChannelConfig:
    """The full channel configuration value (a config block's payload).

    policies: name -> SignaturePolicy for the channel-level policies the
    stack consults ("Readers", "Writers", "Admins", plus application
    defaults like "Endorsement").  acls: resource name -> policy name
    (core/aclmgmt resource map).
    """
    channel_id: str
    sequence: int
    orgs: tuple                       # tuple[OrgConfig]
    policies: Dict[str, SignaturePolicy]
    batch: BatchConfig = BatchConfig()
    capabilities: tuple = (CAP_V2_0, CAP_KEY_LEVEL_ENDORSEMENT)
    acls: Dict[str, str] = field(default_factory=dict)
    consenters: tuple = ()            # raft node ids, informational

    def to_dict(self) -> dict:
        return {
            "channel_id": self.channel_id,
            "sequence": self.sequence,
            "orgs": [o.to_dict() for o in self.orgs],
            "policies": {k: v.to_dict() for k, v in self.policies.items()},
            "batch": self.batch.to_dict(),
            "capabilities": list(self.capabilities),
            "acls": dict(self.acls),
            "consenters": list(self.consenters),
        }

    def serialize(self) -> bytes:
        return serde.encode(self.to_dict())

    @staticmethod
    def from_dict(d: dict) -> "ChannelConfig":
        return ChannelConfig(
            channel_id=d["channel_id"],
            sequence=d["sequence"],
            orgs=tuple(OrgConfig.from_dict(o) for o in d["orgs"]),
            policies={k: SignaturePolicy.from_dict(v)
                      for k, v in d["policies"].items()},
            batch=BatchConfig.from_dict(d["batch"]),
            capabilities=tuple(d.get("capabilities", ())),
            acls=dict(d.get("acls", {})),
            consenters=tuple(d.get("consenters", ())),
        )

    @staticmethod
    def deserialize(data: bytes) -> "ChannelConfig":
        return ChannelConfig.from_dict(serde.decode(data))


def default_policies(mspids: List[str]) -> Dict[str, SignaturePolicy]:
    """The implicit-meta defaults: Readers/Writers = any member,
    Admins = majority of org admins (policies/implicitmeta.go semantics,
    compiled down to explicit NOutOf over org principals)."""
    members = [signed_by(Principal.member(m)) for m in mspids]
    admins = [signed_by(Principal.admin(m)) for m in mspids]
    majority = len(mspids) // 2 + 1
    return {
        "Readers": n_out_of(1, members),
        "Writers": n_out_of(1, members),
        "Admins": n_out_of(majority, admins),
        "Endorsement": n_out_of(majority, members),
    }


class Bundle:
    """Immutable materialization of a ChannelConfig: live MSPs + policy
    evaluator + batch/capability accessors (channelconfig/bundle.go)."""

    def __init__(self, config: ChannelConfig):
        self.config = config
        self.msps: Dict[str, CachedMSP] = {}
        for org in config.orgs:
            self.msps[org.mspid] = CachedMSP(MSP(MSPConfig(
                mspid=org.mspid,
                root_certs_pem=list(org.root_certs),
                intermediate_certs_pem=list(org.intermediate_certs),
                admin_certs_pem=list(org.admins),
                crls_pem=list(org.crls),
            )))

    @property
    def channel_id(self) -> str:
        return self.config.channel_id

    @property
    def sequence(self) -> int:
        return self.config.sequence

    @property
    def batch(self) -> BatchConfig:
        return self.config.batch

    def has_capability(self, cap: str) -> bool:
        return cap in self.config.capabilities

    def policy(self, name: str) -> Optional[SignaturePolicy]:
        return self.config.policies.get(name)

    def acl_policy_name(self, resource: str, default: str = "Writers") -> str:
        return self.config.acls.get(resource, default)

    def evaluator(self, provider) -> PolicyEvaluator:
        return PolicyEvaluator(self.msps, provider)

    def evaluate_policy(self, name: str, signed_data, provider) -> bool:
        """Control-plane policy evaluation (batched through the provider
        like every other signature set)."""
        pol = self.policy(name)
        if pol is None:
            return False
        return PolicyEvaluator(self.msps, provider).evaluate_signed_data(
            pol, signed_data)


class BundleSource:
    """Thread-safe holder of the current Bundle; consumers call current()
    at each use so a committed config block takes effect atomically
    (channelconfig/bundlesource.go)."""

    def __init__(self, bundle: Bundle, config_height: int = 0):
        self._lock = threading.Lock()
        self._bundle = bundle
        self._listeners: List = []
        # block number at/below which config txs are genuine catch-up
        # replay: the height of the block that carried the bootstrap
        # config (0 for a genesis bootstrap).  The committer advances it
        # as config blocks are applied, and uses it to tell historical
        # replay apart from a fresh block carrying a stale-sequence
        # config tx (which must be flagged INVALID, configtx semantics).
        self.config_height = int(config_height)

    def current(self) -> Bundle:
        with self._lock:
            return self._bundle

    def update(self, bundle: Bundle, config_height: int = None) -> None:
        with self._lock:
            # check-and-swap under one lock: concurrent appliers must not
            # be able to install an older bundle over a newer one
            if bundle.sequence <= self._bundle.sequence:
                raise ConfigError(
                    f"config sequence regression: {bundle.sequence} <= "
                    f"{self._bundle.sequence}")
            self._bundle = bundle
            if config_height is not None:
                # advanced atomically with the bundle so on_update
                # listeners (e.g. the peer's config persistence) observe
                # a consistent (bundle, height) pair
                self.config_height = max(self.config_height,
                                         int(config_height))
            listeners = list(self._listeners)
        for cb in listeners:
            cb(bundle)

    def on_update(self, cb) -> None:
        """Register callback(bundle) invoked after each update."""
        with self._lock:
            self._listeners.append(cb)
