"""Certstore: pull-replicated identity certificates.

Reference parity: gossip/gossip/certstore.go — peers replicate each
other's identity certificates via the pull mechanism so gossip message
signatures can be verified even for peers never heard from directly.
Items are serialized MSP identities keyed by their sha256; `add`
validates against the channel MSPs (an identity no MSP vouches for is
rejected — idStore.put's verification in the reference), so a malicious
responder cannot poison the store.

Counterpart of `fabric_tpu/gossip/certstore.py`, the same code on the port's
imports.
"""

from __future__ import annotations

import hashlib
import logging
import threading
from typing import Dict, List, Optional

from .pull import PullStore

logger = logging.getLogger("fabric_tpu_torch.gossip.certstore")


def identity_digest(identity: bytes) -> str:
    return hashlib.sha256(identity).hexdigest()


class CertStore(PullStore):
    def __init__(self, msps: Dict[str, object], self_identity: bytes = b""):
        self.msps = msps
        self._lock = threading.Lock()
        self._certs: Dict[str, bytes] = {}
        if self_identity:
            self.add(identity_digest(self_identity), self_identity)

    def digests(self) -> List[str]:
        with self._lock:
            return sorted(self._certs)

    def get(self, item_id: str) -> Optional[bytes]:
        with self._lock:
            return self._certs.get(item_id)

    def add(self, item_id: str, payload: bytes) -> bool:
        if identity_digest(payload) != item_id:
            return False                      # id must bind the content
        from fabric_tpu_torch.msp import deserialize_from_msps
        ident = deserialize_from_msps(self.msps, payload, validate=True)
        if ident is None:
            logger.debug("certstore: rejected unvouched identity %s",
                         item_id[:16])
            return False
        with self._lock:
            self._certs[item_id] = payload
        return True

    def lookup(self, identity: bytes) -> Optional[bytes]:
        return self.get(identity_digest(identity))

    def __len__(self) -> int:
        with self._lock:
            return len(self._certs)
