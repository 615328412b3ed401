"""Committed private data store with block-to-live purging.

Reference parity: Fabric's core/ledger/pvtdatastorage/store.go +
txmgmt/pvtstatepurgemgmt — cleartext collection state keyed by
(namespace, collection, key), an expiry index by purge-block, and purge
processing at each commit.  Durable variant: snapshot into the ledger
directory (the ledger remains the source of truth for the hashes; this
store only caches the cleartext, so losing it is recoverable by
reconciliation, not a safety issue).

Counterpart of `fabric_tpu/privdata/pvtdatastore.py`, the same code on the port's
imports.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple


class PvtDataStore:
    def __init__(self):
        self._lock = threading.Lock()
        # (ns, coll, key) -> (value, committed_block)
        self._state: Dict[Tuple[str, str, str], Tuple[bytes, int]] = {}
        # expiry_block -> list of keys to purge
        self._expiry: Dict[int, List[Tuple[str, str, str]]] = {}
        # (ns, coll, txid) -> {key: value} — the pull-service index
        self._by_txid: Dict[Tuple[str, str, str], dict] = {}
        # expiry_block -> tx-index entries to drop alongside the state keys
        self._tx_expiry: Dict[int, List[Tuple[str, str, str]]] = {}

    def commit(self, block_num: int, writes: dict, btl_by_coll: dict) -> None:
        """writes: {(ns, coll): {key: value|None}}; btl_by_coll maps
        (ns, coll) -> block_to_live (0 = forever)."""
        with self._lock:
            for (ns, coll), kvs in writes.items():
                btl = btl_by_coll.get((ns, coll), 0)
                for key, value in kvs.items():
                    sk = (ns, coll, key)
                    if value is None:
                        self._state.pop(sk, None)
                        continue
                    self._state[sk] = (value, block_num)
                    if btl:
                        self._expiry.setdefault(block_num + btl + 1, []) \
                            .append(sk)

    def process_purges(self, block_num: int) -> int:
        """Purge collections whose BTL elapsed as of block_num
        (pvtstatepurgemgmt.DeleteExpiredAndUpdateBookkeeping)."""
        purged = 0
        with self._lock:
            for expiry in [b for b in self._expiry if b <= block_num]:
                for sk in self._expiry.pop(expiry):
                    ent = self._state.get(sk)
                    # only purge if not rewritten since (a newer write has
                    # its own expiry entry)
                    if ent is not None and ent[1] + 1 <= expiry:
                        del self._state[sk]
                        purged += 1
            for expiry in [b for b in self._tx_expiry if b <= block_num]:
                for tk in self._tx_expiry.pop(expiry):
                    self._by_txid.pop(tk, None)
        return purged

    def record_tx(self, txid: str, namespace: str, collection: str,
                  kv: dict, block_num: int = 0, btl: int = 0) -> None:
        """Index a committed tx's collection cleartext by txid — the
        lookup surface the privdata pull service answers from
        (pvtdataprovider.go serves by txid+collection).  BTL applies to
        this index exactly like the keyed state: expired private data
        must stop being servable."""
        with self._lock:
            tk = (namespace, collection, txid)
            self._by_txid.setdefault(tk, {}).update(kv)
            if btl:
                self._tx_expiry.setdefault(block_num + btl + 1, []).append(tk)

    def get_tx_set(self, namespace: str, collection: str,
                   txid: str) -> Optional[dict]:
        with self._lock:
            got = self._by_txid.get((namespace, collection, txid))
            return dict(got) if got is not None else None

    def get(self, namespace: str, collection: str, key: str) -> Optional[bytes]:
        with self._lock:
            ent = self._state.get((namespace, collection, key))
            return ent[0] if ent else None

    def has_collection(self, namespace: str, collection: str) -> bool:
        with self._lock:
            return any(ns == namespace and c == collection
                       for (ns, c, _) in self._state)
