"""Private data pillar: collections, transient + pvtdata stores, coordinator.

Re-design of Fabric's private-data capability:
core/transientstore/store.go,
core/ledger/pvtdatastorage/store.go, gossip/privdata/coordinator.go,
gossip/privdata/pvtdataprovider.go, reconcile.go.

Model (same on-chain/off-chain split as the reference):
  - a chaincode writes to a named COLLECTION: the public rwset carries
    only hash(key) -> hash(value) writes under namespace "ns$collection";
    the cleartext keys/values travel off-chain,
  - at endorsement the cleartext is staged in the endorser's
    TransientStore and distributed to collection member peers over the
    authenticated comm plane,
  - at commit the Coordinator matches each valid tx's private write-set
    hashes against transient/received data (pulling from peers when
    missing), commits cleartext to the PvtDataStore, and purges expired
    collections by block-to-live (BTL),
  - non-member peers commit the block with hashes only; a later
    reconciliation pull can backfill if the peer joins the collection.

Counterpart of `fabric_tpu/privdata`, the same code on the port's
imports.
"""

from .collection import CollectionConfig, CollectionRegistry, pvt_namespace
from .transientstore import TransientStore
from .pvtdatastore import PvtDataStore
from .coordinator import Coordinator, MissingPvtData

__all__ = [
    "CollectionConfig", "CollectionRegistry", "pvt_namespace",
    "TransientStore", "PvtDataStore", "Coordinator", "MissingPvtData",
]
