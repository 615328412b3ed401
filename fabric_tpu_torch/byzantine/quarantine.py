"""Persistent quarantine registry: per-identity standing, revoked for
provable crimes.

The Byzantine analogue of `verify_plane/trust.py` AttestorTrust: a
thread-safe JSON-backed registry keyed by a string identity — an
orderer/peer transport binding ("mspid|cert-sha256") or a gossip
endpoint ("gossip|host:port") — where a proven crime (equivocation,
fork) quarantines the identity immediately and permanently, while
scored offenses (garbage frames, bad signatures) accumulate until a
threshold quarantines repeat offenders.

Quarantine withdraws TRUST, not liveness: quarantined sources are
refused at gossip intake and skipped by the deliver client's endpoint
rotation, but no honest path depends on them — the stream re-sources
from a healthy endpoint and exactly-once survives on the committer's
replay guard.

State persists across restarts when a path is given (atomic tmp +
os.replace, exactly trust.py's discipline): a quarantined orderer stays
quarantined until an operator deletes the state file.

Counterpart of `fabric_tpu/byzantine/quarantine.py`, the same code on
the port's imports.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, Optional

logger = logging.getLogger("fabric_tpu_torch.byzantine")

# crime reasons quarantine immediately; offense reasons score up to the
# threshold first (a single garbage frame is noise, a pattern is not)
CRIME_REASONS = ("equivocation", "fork", "tampered_attestation")
OFFENSE_REASONS = ("garbage", "bad_sig", "bad_hash", "stale")


class QuarantineRegistry:
    """Thread-safe per-identity standing registry (node-scoped)."""

    def __init__(self, path: Optional[str] = None,
                 score_threshold: int = 3):
        self.path = path
        self.score_threshold = int(score_threshold)
        self._lock = threading.Lock()
        # key -> {"quarantined": bool, "reason": str|None, "score": n,
        #         "offenses": {reason: n}, "at": epoch|None}
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
                logger.exception("quarantine state unreadable: %s", path)

    def _entry(self, key: str) -> dict:
        return self._state.setdefault(
            key, {"quarantined": False, "reason": None, "score": 0,
                  "offenses": {}, "at": None, "last_offense_at": None,
                  "pardons": 0})

    def is_quarantined(self, key: Optional[str]) -> bool:
        if key is None:
            return False
        with self._lock:
            ent = self._state.get(key)
            return ent is not None and bool(ent.get("quarantined"))

    def quarantine(self, key: str, reason: str) -> bool:
        """Permanently quarantine `key`.  Returns True the FIRST time
        (so callers emit the fraud proof / log exactly once)."""
        with self._lock:
            ent = self._entry(key)
            first = not ent["quarantined"]
            ent["quarantined"] = True
            if first:
                ent["reason"] = reason
                ent["at"] = time.time()
            self._save()
        if first:
            logger.warning("identity %s QUARANTINED: %s", key, reason)
            self._bump("byzantine_quarantines_total",
                       "identities quarantined by the byzantine plane",
                       reason)
        return first

    def offense(self, key: str, reason: str, weight: int = 1) -> bool:
        """Score an offense against `key`; quarantines (reason
        "poison") once the accumulated score crosses the threshold.
        Returns True if this offense caused the quarantine."""
        with self._lock:
            ent = self._entry(key)
            ent["offenses"][reason] = ent["offenses"].get(reason, 0) \
                + int(weight)
            ent["score"] += int(weight)
            ent["last_offense_at"] = time.time()
            crossed = (not ent["quarantined"]
                       and ent["score"] >= self.score_threshold)
            self._save()
        self._bump("byzantine_offenses_total",
                   "scored byzantine offenses at gossip/deliver intake",
                   reason)
        if crossed:
            return self.quarantine(key, "poison")
        return False

    # -- proof-backed pardon ---------------------------------------------------
    # Offense-based quarantines ("poison": a SCORE crossed a threshold)
    # may be pardoned after a clean-observation window — scores measure
    # behaviour, and behaviour can improve.  Crime convictions never
    # decay: equivocation/fork/tampered_attestation are proven by signed
    # evidence, and a signature does not become less valid with time.

    def pardonable_keys(self, clean_window_s: float,
                        now: Optional[float] = None) -> list:
        """Quarantined identities eligible for pardon: offense-based
        reason AND no offense observed for `clean_window_s`."""
        now = time.time() if now is None else now
        out = []
        with self._lock:
            for key, ent in self._state.items():
                if not ent.get("quarantined"):
                    continue
                if ent.get("reason") in CRIME_REASONS:
                    continue
                since = ent.get("last_offense_at") or ent.get("at") or now
                if now - since >= clean_window_s:
                    out.append(key)
        return sorted(out)

    def pardon(self, key: str) -> bool:
        """Restore `key`'s standing (offense-based quarantines only).
        Returns True when standing was restored, False when refused —
        crime convictions NEVER decay, and a non-quarantined key has
        nothing to pardon.  Live readers (standing-aware deliver, gossip
        intake) see the restoration immediately: they consult
        is_quarantined() per use, never a cached verdict."""
        with self._lock:
            ent = self._state.get(key)
            if ent is None or not ent.get("quarantined"):
                return False
            if ent.get("reason") in CRIME_REASONS:
                logger.warning("pardon REFUSED for %s: %s is a crime "
                               "conviction", key, ent.get("reason"))
                return False
            ent["quarantined"] = False
            ent["reason"] = None
            ent["score"] = 0
            ent["offenses"] = {}
            ent["at"] = None
            ent["pardons"] = int(ent.get("pardons", 0)) + 1
            self._save()
        logger.warning("identity %s PARDONED (standing restored)", key)
        self._bump("byzantine_pardons_total",
                   "offense quarantines pardoned after a clean window",
                   "poison")
        return True

    def decay_scores(self, clean_window_s: float, amount: int = 1,
                     now: Optional[float] = None) -> int:
        """Sub-threshold standing decay: a NON-quarantined identity that
        has stayed clean for a window sheds `amount` score (offense
        tallies remain as history).  Returns how many entries decayed."""
        now = time.time() if now is None else now
        decayed = 0
        with self._lock:
            for ent in self._state.values():
                if ent.get("quarantined") or ent.get("score", 0) <= 0:
                    continue
                since = max(ent.get("last_offense_at") or 0,
                            ent.get("decayed_at") or 0)
                if since and now - since >= clean_window_s:
                    ent["score"] = max(0, ent["score"] - int(amount))
                    ent["decayed_at"] = now
                    decayed += 1
            if decayed:
                self._save()
        return decayed

    def pardon_count(self) -> int:
        with self._lock:
            return sum(int(e.get("pardons", 0))
                       for e in self._state.values())

    def count(self) -> int:
        with self._lock:
            return sum(1 for e in self._state.values()
                       if e.get("quarantined"))

    def reasons(self) -> Dict[str, int]:
        """reason -> quarantined-identity count (the BYZ column's
        breakdown)."""
        out: Dict[str, int] = {}
        with self._lock:
            for e in self._state.values():
                if e.get("quarantined"):
                    r = e.get("reason") or "?"
                    out[r] = out.get(r, 0) + 1
        return out

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {k: {**dict(v), "offenses": dict(v.get("offenses", {}))}
                    for k, v in self._state.items()}

    @staticmethod
    def _bump(name: str, help_text: str, reason: str) -> None:
        try:
            from fabric_tpu_torch.ops_plane import registry
            registry.counter(name, help_text).add(1, reason=reason)
        except Exception:
            pass                  # observability never breaks containment

    def _save(self) -> None:
        # caller holds the lock; atomic replace, trust.py discipline
        if self.path is None:
            return
        try:
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(self._state, f, sort_keys=True)
            os.replace(tmp, self.path)
        except Exception:
            logger.exception("quarantine state not persisted")
