"""Commit-time coordinator: match, fetch, commit, purge private data.

Reference parity: Fabric's gossip/privdata/coordinator.go
StoreBlock — before/with the block commit, assemble each valid tx's
private write-sets: transient store first, then pull from collection
member peers (pvtdataprovider.go / fetcher), verify cleartext against
the on-chain hashes, commit to the pvt store, process BTL purges, and
purge the transient store.  Missing collections are recorded for
reconciliation (reconcile.go), which retries the pull later.

Counterpart of `fabric_tpu/privdata/coordinator.py`, the same code on the port's
imports.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from fabric_tpu_torch.protocol import Envelope
from fabric_tpu_torch.protocol.txflags import TxFlags, ValidationCode
from fabric_tpu_torch.protocol.types import META_TXFLAGS, TxRwSet

from .collection import PVT_SEP, CollectionRegistry, hash_key, hash_value
from .pvtdatastore import PvtDataStore
from .transientstore import TransientStore

logger = logging.getLogger("fabric_tpu_torch.privdata")


@dataclass
class MissingPvtData:
    block_num: int
    txid: str
    namespace: str
    collection: str
    # on-chain hashed writes (hashed key -> hashed value, None = delete):
    # reconciliation MUST re-verify fetched cleartext against these — a
    # malicious peer answering the pull must not be able to poison state
    # (reference: gossip/privdata/reconcile.go verifies vs the block).
    expected: Dict[str, object] = field(default_factory=dict)


class Coordinator:
    """Wraps a Committer with private-data assembly.

    fetch: optional callable (txid, namespace, collection) -> dict|None —
    the network pull from member peers (reconciliation transport).
    mspid: this peer's org (collection membership decisions).
    """

    def __init__(self, committer, registry: CollectionRegistry,
                 transient: TransientStore, pvt_store: PvtDataStore,
                 mspid: str, fetch: Optional[Callable] = None):
        self.committer = committer
        self.registry = registry
        self.transient = transient
        self.pvt_store = pvt_store
        self.mspid = mspid
        self.fetch = fetch
        self.missing: List[MissingPvtData] = []

    @property
    def height(self) -> int:
        return self.committer.height

    @property
    def validator(self):
        return self.committer.validator

    @property
    def ledger(self):
        return self.committer.ledger

    # -- the StoreBlock composition -----------------------------------------

    def store_block(self, block):
        result = self.committer.store_block(block)
        flags = TxFlags.from_bytes(block.metadata.items[META_TXFLAGS])
        writes: Dict[Tuple[str, str], Dict[str, object]] = {}
        btl: Dict[Tuple[str, str], int] = {}
        txids = []
        for tx_num, env_bytes in enumerate(block.data):
            if not flags.is_valid(tx_num):
                continue
            try:
                env = Envelope.deserialize(env_bytes)
                txid = env.header().channel_header.txid
                rwset = _tx_rwset(env)
            except Exception:
                continue
            txids.append(txid)
            if rwset is None:
                continue
            for ns_set in rwset.ns_rwsets:
                if PVT_SEP not in ns_set.namespace or not ns_set.writes:
                    continue
                ns, coll = ns_set.namespace.split(PVT_SEP, 1)
                cfg = self.registry.get(ns, coll)
                if cfg is None or not cfg.is_member(self.mspid):
                    continue   # not our collection: hashes only
                expected = {w.key: (None if w.is_delete else w.value)
                            for w in ns_set.writes}
                clear = self._resolve(txid, ns, coll, expected)
                if clear is None:
                    self.missing.append(MissingPvtData(
                        block.header.number, txid, ns, coll, dict(expected)))
                    continue
                writes.setdefault((ns, coll), {}).update(clear)
                self.pvt_store.record_tx(txid, ns, coll, clear,
                                         block_num=block.header.number,
                                         btl=cfg.block_to_live)
                btl[(ns, coll)] = cfg.block_to_live
        if writes:
            self.pvt_store.commit(block.header.number, writes, btl)
        self.pvt_store.process_purges(block.header.number)
        self.transient.purge_by_txids(txids)
        return result

    def _resolve(self, txid: str, ns: str, coll: str,
                 expected: Dict[str, object]) -> Optional[dict]:
        """Find cleartext matching the on-chain hashes: transient store,
        then the network fetcher."""
        candidates = []
        for sets in self.transient.get(txid):
            if (ns, coll) in sets:
                candidates.append(sets[(ns, coll)])
        if self.fetch is not None:
            fetched = self.fetch(txid, ns, coll)
            if fetched:
                candidates.append(fetched)
        for cand in candidates:
            out = _match_hashes(cand, expected)
            if out is not None:
                return out
        return None

    # -- reconciliation ------------------------------------------------------

    def reconcile(self) -> int:
        """Retry missing collections via the fetcher (reconcile.go).
        Returns how many were recovered."""
        if self.fetch is None:
            return 0
        recovered = 0
        still = []
        for m in self.missing:
            fetched = self.fetch(m.txid, m.namespace, m.collection)
            verified = _match_hashes(fetched, m.expected) if fetched else None
            if verified is not None:
                cfg = self.registry.get(m.namespace, m.collection)
                self.pvt_store.commit(
                    m.block_num, {(m.namespace, m.collection): verified},
                    {(m.namespace, m.collection):
                     cfg.block_to_live if cfg else 0})
                self.pvt_store.record_tx(
                    m.txid, m.namespace, m.collection, verified,
                    block_num=m.block_num,
                    btl=cfg.block_to_live if cfg else 0)
                recovered += 1
            else:
                if fetched:
                    logger.warning(
                        "reconcile: fetched pvtdata for %s %s/%s failed "
                        "hash verification; discarding", m.txid,
                        m.namespace, m.collection)
                still.append(m)
        self.missing = still
        return recovered


def _tx_rwset(env: Envelope) -> Optional[TxRwSet]:
    try:
        from fabric_tpu_torch.protocol.types import Transaction
        tx = Transaction.from_dict(env.payload_dict()["data"])
        return tx.actions[0].action.rwset if tx.actions else None
    except Exception:
        return None


def _match_hashes(cleartext: dict, expected: Dict[str, object]) -> Optional[dict]:
    """Check a candidate cleartext set against the on-chain hashed writes.
    Accepts the candidate only if EVERY hashed write is explained."""
    out = {}
    for hk, hv in expected.items():
        found = None
        for key, value in cleartext.items():
            if hash_key(key) == hk:
                found = (key, value)
                break
        if found is None:
            return None
        key, value = found
        if hv is None:           # delete
            if value is not None:
                return None
        else:
            if value is None or hash_value(value) != hv:
                return None
        out[key] = value
    return out
