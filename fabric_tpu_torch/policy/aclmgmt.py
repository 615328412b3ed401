"""aclmgmt — API-resource name -> channel-policy registry.

Reference parity: Hyperledger Fabric core/aclmgmt/aclmgmt.go:15 (the
ACLProvider interface CheckACL(resource, channel, idinfo)) and
core/aclmgmt/resources.go (the named-resource catalogue with default
policies).  The reference resolves a resource to a policy name through
the channel config's ACLs section (configurable by config tx,
sampleconfig/configtx.yaml Application.ACLs) falling back to hardcoded
defaults; this module does the same against ChannelConfig.acls
(fabric_tpu_torch/config/channelconfig.py) — so an ACL change committed
in a config transaction changes authorization behavior at every
consuming call site with no code change.

Counterpart of `fabric_tpu/policy/aclmgmt.py`, whole, over the port's
`config.BundleSource`; its signature checks go through the provider it
is given (on the card, the CUDA provider's P-256 lanes).
"""

from __future__ import annotations

from typing import Dict, Optional

from .evaluator import PolicyEvaluator
from .policy import SignedData

# resource name -> default channel-policy name (resources.go defaults:
# proposals need Writers, queries need Readers, admin verbs need Admins)
DEFAULT_ACLS: Dict[str, str] = {
    "peer/Propose": "Writers",
    "peer/ChaincodeToChaincode": "Writers",
    "qscc/GetChainInfo": "Readers",
    "qscc/GetBlockByNumber": "Readers",
    "qscc/GetBlockByHash": "Readers",
    "qscc/GetTransactionByID": "Readers",
    "cscc/GetChannels": "Readers",
    "cscc/GetChannelConfig": "Readers",
    "cscc/JoinChain": "Admins",
    "discovery/Discover": "Readers",
    "event/Block": "Readers",
    "privdata/Fetch": "Readers",
    "participation/Join": "Admins",
    "participation/Remove": "Admins",
    "participation/List": "Admins",
    # NOTE: lifecycle/Install and lifecycle/QueryInstalled are PEER-
    # LOCAL operations gated against the local org's admin principal
    # (PeerNode._check_local_admin), not channel-config ACL mappings.
}


class ACLError(PermissionError):
    pass


class ACLProvider:
    """Evaluates a named API resource's policy against a SignedData.

    Bound to a BundleSource so config-tx ACL updates (and policy/MSP
    rotations) take effect at the block boundary, like every other
    consumer of the live bundle."""

    def __init__(self, bundle_source, provider):
        self.bundle_source = bundle_source
        self.provider = provider

    def policy_name(self, resource: str) -> Optional[str]:
        bundle = self.bundle_source.current()
        name = bundle.config.acls.get(resource)
        if name:
            return name
        return DEFAULT_ACLS.get(resource)

    def _policy(self, resource: str):
        name = self.policy_name(resource)
        if name is None:
            raise ACLError(f"{resource}: no ACL mapping")
        bundle = self.bundle_source.current()
        policy = bundle.config.policies.get(name)
        if policy is None:
            raise ACLError(f"{resource}: policy {name!r} not defined")
        return bundle, policy, name

    def check_acl(self, resource: str, sd: Optional[SignedData]) -> None:
        """Raises ACLError unless `sd` satisfies the resource's policy.

        Unknown resources and unresolvable policy names DENY (the
        reference fails closed, aclmgmt resource checks)."""
        if sd is None:
            raise ACLError(f"{resource}: no signed data")
        bundle, policy, name = self._policy(resource)
        evaluator = PolicyEvaluator(bundle.msps, self.provider)
        if not evaluator.evaluate_signed_data(policy, [sd]):
            raise ACLError(f"{resource}: signed data does not satisfy "
                           f"policy {name!r}")

    def check(self, resource: str, subject) -> None:
        """Polymorphic gate: SignedData -> signature-verified check;
        identity object/bytes -> handshake-authenticated check."""
        if subject is None:
            raise ACLError(f"{resource}: unauthenticated caller")
        if isinstance(subject, SignedData):
            return self.check_acl(resource, subject)
        if hasattr(subject, "serialize"):
            return self.check_identity(resource, subject.serialize())
        return self.check_identity(resource, subject)

    def check_identity(self, resource: str, identity_bytes) -> None:
        """check_acl for a HANDSHAKE-AUTHENTICATED caller: the RPC plane
        already proved possession of the identity's key (comm/secure.py
        handshake binding), so the resource policy is evaluated over the
        identity's principals without a per-request signature — the slot
        the reference fills by evaluating ACLs against the mTLS/creator
        identity."""
        if identity_bytes is None:
            raise ACLError(f"{resource}: unauthenticated caller")
        bundle, policy, name = self._policy(resource)
        from fabric_tpu_torch.msp import deserialize_from_msps
        ident = deserialize_from_msps(bundle.msps, bytes(identity_bytes),
                                      validate=True)
        if ident is None:
            raise ACLError(f"{resource}: unknown caller identity")
        evaluator = PolicyEvaluator(bundle.msps, self.provider)
        if not evaluator.evaluate(policy, [ident]):
            raise ACLError(f"{resource}: caller does not satisfy "
                           f"policy {name!r}")
