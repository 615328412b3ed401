"""Transient store: endorsement-time staging of private write-sets.

Reference parity: Fabric's core/transientstore/store.go — private
simulation results are keyed by (txid, endorser-height) so the commit
coordinator can look them up when the tx lands in a block, and purged
both by txid at commit and by height retention.

Counterpart of `fabric_tpu/privdata/transientstore.py`, the same code on the port's
imports.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple


class TransientStore:
    """In-memory store of txid -> list of (received_height, pvt_sets).

    pvt_sets: {(namespace, collection): {key: value|None}} — None marks a
    private delete.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._by_txid: Dict[str, List[Tuple[int, dict]]] = {}

    def persist(self, txid: str, height: int, pvt_sets: dict) -> None:
        with self._lock:
            self._by_txid.setdefault(txid, []).append((height, pvt_sets))

    def get(self, txid: str) -> List[dict]:
        with self._lock:
            return [sets for _, sets in self._by_txid.get(txid, [])]

    def purge_by_txids(self, txids) -> None:
        """Called post-commit for the block's transactions (store.go
        PurgeByTxids)."""
        with self._lock:
            for t in txids:
                self._by_txid.pop(t, None)

    def purge_below_height(self, height: int) -> None:
        """Retention purge (store.go PurgeBelowHeight)."""
        with self._lock:
            for txid in list(self._by_txid):
                kept = [(h, s) for h, s in self._by_txid[txid] if h >= height]
                if kept:
                    self._by_txid[txid] = kept
                else:
                    del self._by_txid[txid]

    def __len__(self) -> int:
        with self._lock:
            return len(self._by_txid)
