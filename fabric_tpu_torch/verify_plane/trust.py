"""Per-identity attestation trust: standing, not just membership.

`trust_attestations` says whether verdict attestations may be honoured
AT ALL; the `attestors` allowlist says who is eligible.  This registry
adds the third axis — each attestor identity's own persistent standing.
Keyed by the same (mspid, cert sha256) binding the allowlist pins,
every identity accumulates accepted/mismatched counts, and the first
DIGEST MISMATCH permanently revokes its vouching right.

Why mismatch is the revocation signal: the attestation digest is
re-derived by the receiver from its own envelope bytes and own MSP set,
so an honest attestor can never produce a mismatch — the digest is a
pure function of bytes both sides hold.  A mismatch therefore means the
sender vouched for bytes it did not deliver (bug or compromise), and a
gateway that did it once must not keep seeding verdict caches.
Revocation only withdraws the fast path: envelopes arriving from a
revoked attestor are simply device-verified like everyone else's, so
liveness is untouched.

Standing persists across restarts when a state path is given (the
orderer keeps it under its data dir) — a revoked gateway stays revoked
until an operator deletes the state file, mirroring how the allowlist
itself is an operator decision.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Dict, Optional, Tuple

logger = logging.getLogger("fabric_tpu_torch.verify_plane")

Binding = Tuple[str, str]           # (mspid, cert sha256 hex)


class AttestorTrust:
    """Thread-safe per-attestor standing registry."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._lock = threading.Lock()
        # key "mspid|fp" -> {"accepted": n, "mismatched": n, "revoked": b}
        self._state: Dict[str, dict] = {}
        if path is not None and os.path.exists(path):
            try:
                with open(path, "r", encoding="utf-8") as f:
                    data = json.load(f)
                if isinstance(data, dict):
                    self._state = {str(k): dict(v)
                                   for k, v in data.items()
                                   if isinstance(v, dict)}
            except Exception:
                logger.exception("attestor trust state unreadable: %s", path)

    @staticmethod
    def _key(binding: Binding) -> str:
        mspid, fp = binding
        return f"{mspid}|{str(fp).lower()}"

    def _entry(self, binding: Binding) -> dict:
        return self._state.setdefault(
            self._key(binding),
            {"accepted": 0, "mismatched": 0, "revoked": False})

    def allowed(self, binding: Binding) -> bool:
        """May this (allowlisted) identity still vouch?"""
        with self._lock:
            ent = self._state.get(self._key(binding))
            return ent is None or not ent.get("revoked", False)

    def note_accepted(self, binding: Binding, n: int = 1) -> None:
        with self._lock:
            self._entry(binding)["accepted"] += int(n)
            self._save()

    def note_mismatch(self, binding: Binding) -> None:
        """A vouch for bytes the sender did not deliver: revoke."""
        with self._lock:
            ent = self._entry(binding)
            ent["mismatched"] += 1
            first = not ent["revoked"]
            ent["revoked"] = True
            self._save()
        if first:
            logger.warning(
                "attestor %s|%s REVOKED: attestation digest mismatch "
                "(vouched for bytes it did not deliver)", *binding)
            try:
                from fabric_tpu_torch.ops_plane import registry
                registry.counter(
                    "attestors_revoked_total",
                    "attestor identities revoked on digest mismatch").add(1)
            except Exception:
                pass

    def revoked_count(self) -> int:
        with self._lock:
            return sum(1 for e in self._state.values()
                       if e.get("revoked", False))

    def snapshot(self) -> Dict[str, dict]:
        """Ops view: per-identity standing (JSON-safe copy)."""
        with self._lock:
            return {k: dict(v) for k, v in self._state.items()}

    def _save(self) -> None:
        # caller holds the lock; atomic replace so a crash mid-write
        # never leaves a torn state file
        if self.path is None:
            return
        try:
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(self._state, f, sort_keys=True)
            os.replace(tmp, self.path)
        except Exception:
            logger.exception("attestor trust state not persisted")
