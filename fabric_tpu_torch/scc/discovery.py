"""Endorser discovery: which peers can satisfy a chaincode's policy?

Reference parity: Fabric's discovery/service.go:67 +
discovery/endorsement/endorsement.go + common/graph: given a chaincode's endorsement policy and live
channel membership, compute LAYOUTS — the minimal principal combinations that satisfy the
policy — and the live peers implementing each principal group.

Policy trees here are the framework's NOutOf/SignedBy AST; a layout maps
principal-group key (mspid:role) -> how many endorsements needed from
that group, plus the live peers available per group.

Counterpart of `fabric_tpu/scc/discovery.py`, the same code on the
port's imports.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from fabric_tpu_torch.policy import SignaturePolicy


@dataclass(frozen=True)
class Layout:
    """One way to satisfy the policy: {group_key: required_count}."""
    quantities: Tuple[Tuple[str, int], ...]

    def as_dict(self) -> Dict[str, int]:
        return dict(self.quantities)


def _group_key(principal) -> str:
    return f"{principal.mspid}:{principal.role or principal.kind}"


def _combinations(policy: SignaturePolicy) -> List[Dict[str, int]]:
    """All minimal principal-count multisets satisfying the policy tree
    (common/graph/choose.go layout enumeration, depth-first)."""
    if policy.kind == "signed_by":
        return [{_group_key(policy.principal): 1}]
    # n_out_of: choose every n-subset of rules, merge their layouts
    import itertools
    out: List[Dict[str, int]] = []
    for subset in itertools.combinations(policy.rules, policy.n):
        partials: List[Dict[str, int]] = [{}]
        for rule in subset:
            nxt = []
            for combo in _combinations(rule):
                for p in partials:
                    merged = dict(p)
                    for k, v in combo.items():
                        merged[k] = merged.get(k, 0) + v
                    nxt.append(merged)
            partials = nxt
        out.extend(partials)
    # dedup
    seen, uniq = set(), []
    for c in out:
        key = tuple(sorted(c.items()))
        if key not in seen:
            seen.add(key)
            uniq.append(c)
    return uniq


class DiscoveryService:
    """membership: callable() -> list of peers, each a dict with at least
    {"id": str, "mspid": str, "roles": [..]} (live gossip membership in
    the reference, discovery/support/gossip)."""

    def __init__(self, membership, policy_for):
        self.membership = membership       # () -> List[dict]
        self.policy_for = policy_for       # namespace -> SignaturePolicy|None

    def endorsers(self, namespace: str) -> dict:
        """service.go Process for an endorsement query: layouts + the live
        peers per principal group.  Layouts whose groups lack enough live
        peers are filtered out (endorsement.go computePrincipalSets)."""
        policy = self.policy_for(namespace)
        if policy is None:
            raise ValueError(f"no endorsement policy for {namespace!r}")
        peers = self.membership()
        by_group: Dict[str, List[dict]] = {}
        for p in peers:
            for role in ("member", "admin", "peer"):
                if role == "member" or role in p.get("roles", ()):
                    by_group.setdefault(f"{p['mspid']}:{role}", []).append(p)
        layouts = []
        for combo in _combinations(policy):
            if all(len(by_group.get(g, ())) >= n for g, n in combo.items()):
                layouts.append(Layout(tuple(sorted(combo.items()))))
        return {
            "chaincode": namespace,
            "layouts": layouts,
            "peers_by_group": {g: [p["id"] for p in ps]
                               for g, ps in by_group.items()},
        }
