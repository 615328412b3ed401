"""Collection configuration + the hashed-namespace convention.

Reference parity: the collection config package (core/common/privdata,
collection criteria in gossip/privdata) reduced to the fields this
framework's planes consume: membership policy (org list), BTL, and the
required/max peer counts that drive distribution.

Counterpart of `fabric_tpu/privdata/collection.py`, the same code on the port's
imports.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

PVT_SEP = "$"


def pvt_namespace(namespace: str, collection: str) -> str:
    """Public-ledger namespace carrying a collection's write HASHES."""
    return f"{namespace}{PVT_SEP}{collection}"


def hash_key(key: str) -> str:
    return hashlib.sha256(key.encode()).hexdigest()


def hash_value(value: bytes) -> bytes:
    return hashlib.sha256(value).digest()


@dataclass(frozen=True)
class CollectionConfig:
    """StaticCollectionConfig equivalent."""
    name: str
    member_orgs: Tuple[str, ...]
    block_to_live: int = 0          # 0 = never purge
    required_peer_count: int = 0    # distribution ack threshold
    maximum_peer_count: int = 2

    def is_member(self, mspid: str) -> bool:
        return mspid in self.member_orgs

    def to_dict(self) -> dict:
        return {"name": self.name, "member_orgs": list(self.member_orgs),
                "block_to_live": self.block_to_live,
                "required_peer_count": self.required_peer_count,
                "maximum_peer_count": self.maximum_peer_count}

    @staticmethod
    def from_dict(d: dict) -> "CollectionConfig":
        return CollectionConfig(d["name"], tuple(d["member_orgs"]),
                                d.get("block_to_live", 0),
                                d.get("required_peer_count", 0),
                                d.get("maximum_peer_count", 2))


class CollectionRegistry:
    """(namespace, collection) -> CollectionConfig; committed with the
    chaincode definition in the reference (_lifecycle), registered on the
    lifecycle object here."""

    def __init__(self):
        self._configs: Dict[Tuple[str, str], CollectionConfig] = {}

    def define(self, namespace: str, cfg: CollectionConfig) -> None:
        self._configs[(namespace, cfg.name)] = cfg

    def get(self, namespace: str, collection: str) -> Optional[CollectionConfig]:
        return self._configs.get((namespace, collection))

    def for_namespace(self, namespace: str) -> List[CollectionConfig]:
        return [c for (ns, _), c in self._configs.items() if ns == namespace]
