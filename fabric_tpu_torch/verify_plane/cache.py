"""Signed verdict cache: the verify-once plane's memory.

The pipeline verifies each signature up to three times — gateway
ingress, orderer SigFilter, commit-time txvalidator — even though
`Verify` is a pure function of the VerifyItem 4-tuple (scheme, pubkey,
signature, payload): the same item always yields the same bit, no
matter which site asks.  `VerdictCache` stores that bit once per node
so every later site degrades to a host-side lookup.

Safety model (the part the differential fuzz gate enforces):

  - The cache key is a SHA-256 digest over all four VerifyItem fields
    (length-prefixed).  A signature swapped after a verdict was cached
    produces a DIFFERENT key — the stale verdict is simply never found.
  - Every entry carries an HMAC-SHA256 tag keyed by a per-node secret
    (os.urandom, never persisted) over (key ‖ verdict ‖ scope ‖ epoch).
    A poisoned entry — verdict bit flipped, tag forged, entry copied
    from another node — fails the MAC check and is dropped +
    re-verified; a MAC failure can NEVER turn into a skipped
    verification.
  - Epochs are PER SCOPE (the channel id): each entry records the
    scope it was minted under and that scope's config sequence at mint
    time, both under the MAC.  A config update (new CRL, rotated CA,
    policy change) bumps only its own channel's epoch; entries minted
    under an older sequence of that channel read as stale and force
    re-verification, while the node's other channels' entries stay
    live — one shared per-node cache never flaps between channels,
    and two channels that happen to sit at the same sequence number
    can never alias.  This is belt-and-suspenders: identity *validity*
    (MSP chain + CRL) and policy evaluation are never cached — they
    always run live at the gate — only the pure signature bit is.
  - The cache is bounded (LRU).  Eviction is silent and safe: a miss
    just means one more device verification.

Everything the plane does is observable: hits/misses/rejects{reason}/
evictions counters, per-site device-verification counters (the ≤1
device verify per unique (identity, sig) pair telemetry), and a
duplicate-verification counter that stays at zero when the plane is
doing its job.

Counterpart of `fabric_tpu/verify_plane/cache.py`.  The port has no ops
plane yet, so each cache keeps those counters itself, in `stats`, under
the reference's series names (a label's values as a dict), and
`snapshot()` reads them there; `note_device_verifications` is a method.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import threading
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple

REASON_MAC = "mac"
REASON_STALE = "stale"


def item_digest(item) -> bytes:
    """Cache key: SHA-256 over all four VerifyItem fields.  Length
    prefixes keep (pubkey, signature, payload) splices unambiguous —
    two different items can never share a preimage."""
    scheme, pubkey, signature, payload = item
    h = hashlib.sha256()
    h.update(scheme.encode())
    h.update(b"\x00")
    for b in (pubkey, signature, payload):
        h.update(len(b).to_bytes(4, "big"))
        h.update(bytes(b))
    return h.digest()


class CoverageWindow:
    """speculative_coverage_frac over a rolling block window: the
    fraction of a committed block's unique verify items whose verdicts
    were already cached when validation began (same WINDOW discipline
    as txvalidator._PipelineEconomics)."""

    WINDOW = 64

    def __init__(self):
        self._lock = threading.Lock()
        self._blocks = deque(maxlen=self.WINDOW)   # (hits, total)

    def note(self, hits: int, total: int) -> None:
        if total > 0:
            with self._lock:
                self._blocks.append((hits, total))

    def frac(self) -> float:
        with self._lock:
            hits = sum(h for h, _ in self._blocks)
            total = sum(t for _, t in self._blocks)
        return (hits / total) if total else 0.0


class VerdictCache:
    """Bounded, MAC'd, epoch-aware signature-verdict cache (one per
    node; all of the node's verify sites share it)."""

    def __init__(self, capacity: int = 65536,
                 secret: Optional[bytes] = None, owner: str = "node"):
        self.capacity = int(capacity)
        self.owner = owner
        self._secret = secret or os.urandom(32)
        self._lock = threading.Lock()
        # digest -> (mac16, verdict, scope, epoch, trace_id)
        self._data: "OrderedDict[bytes, tuple]" = OrderedDict()
        # scope (channel id) -> pinned config sequence; unregistered
        # scopes mint/judge at 0
        self._epochs: Dict[str, int] = {}
        # a speculative verifier feeds this cache (gates whether the
        # node reports speculative_coverage_frac at all)
        self.speculative_attached = False
        self.coverage = CoverageWindow()
        # the plane's counters, by the reference's series names; a
        # labelled series is a dict of its label's values
        self.stats = {
            "verify_cache_hits_total": 0,
            "verify_cache_misses_total": 0,
            "verify_cache_rejects_total": {REASON_MAC: 0, REASON_STALE: 0},
            "verify_cache_evictions_total": 0,
            "verify_plane_device_verifications_total": {},
            "verify_plane_duplicate_device_verifications_total": {},
            "verify_plane_attested_skips_total": 0,
        }

    # -- MAC ---------------------------------------------------------------

    def _tag(self, digest: bytes, verdict: bool, scope: str,
             epoch: int) -> bytes:
        # scope last: every preceding field is fixed-width, so the
        # variable-length channel id can never splice into them
        msg = digest + (b"\x01" if verdict else b"\x00") \
            + int(epoch).to_bytes(8, "big") + scope.encode()
        return hmac.new(self._secret, msg, hashlib.sha256).digest()[:16]

    # -- epochs (per-channel config sequence) ------------------------------

    def _epoch_of(self, scope: str) -> int:
        return self._epochs.get(scope, 0)

    def set_epoch(self, epoch: int, scope: str = "") -> None:
        """Pin ONE scope (channel) to a config sequence; that scope's
        entries minted under any other sequence become stale
        (identity/policy revision bump).  Other scopes' entries are
        untouched — the cache is shared per node, the epochs are not."""
        with self._lock:
            self._epochs[scope] = int(epoch)

    def bump_epoch(self, scope: str = "") -> None:
        with self._lock:
            self._epochs[scope] = self._epochs.get(scope, 0) + 1

    # -- lookups -----------------------------------------------------------

    def get(self, item) -> Optional[bool]:
        """MAC-verified verdict for `item`, or None (miss / reject —
        either way the caller must do a full verification)."""
        v, _ = self.lookup(item)
        return v

    def lookup(self, item) -> Tuple[Optional[bool], str]:
        """(verdict-or-None, speculative trace_id) — trace_id is "" when
        the entry carries no span to link."""
        d = item_digest(item)
        reason = None
        hit = None
        with self._lock:
            ent = self._data.get(d)
            if ent is not None:
                mac, verdict, scope, epoch, trace = ent
                if not hmac.compare_digest(
                        mac, self._tag(d, verdict, scope, epoch)):
                    # poisoned entry: hard-drop, count, FULL re-verify
                    del self._data[d]
                    reason = REASON_MAC
                elif epoch != self._epoch_of(scope):
                    del self._data[d]
                    reason = REASON_STALE
                else:
                    self._data.move_to_end(d)
                    hit = (bool(verdict), trace)
            st = self.stats
            if hit is not None:
                st["verify_cache_hits_total"] += 1
            else:
                if reason is not None:
                    st["verify_cache_rejects_total"][reason] += 1
                st["verify_cache_misses_total"] += 1
        return hit if hit is not None else (None, "")

    def peek(self, item) -> Optional[bool]:
        """Lookup WITHOUT touching hit/miss counters or LRU order (the
        attestation builder probes with this so economics counters keep
        describing the verify path only)."""
        d = item_digest(item)
        with self._lock:
            ent = self._data.get(d)
            if ent is None:
                return None
            mac, verdict, scope, epoch, trace = ent
            if epoch != self._epoch_of(scope) or not hmac.compare_digest(
                    mac, self._tag(d, verdict, scope, epoch)):
                return None
            return bool(verdict)

    # -- fills -------------------------------------------------------------

    def put(self, item, verdict: bool, trace_id: str = "",
            scope: str = "") -> bool:
        """Record a verdict this node just computed (or, on the orderer,
        accepted from an authorized attestation), minted under `scope`'s
        current epoch.  Returns True when the digest was already present
        with a valid entry — i.e. this was a duplicate device
        verification."""
        d = item_digest(item)
        verdict = bool(verdict)
        with self._lock:
            epoch = self._epoch_of(scope)
            prev = self._data.pop(d, None)
            dup = prev is not None and hmac.compare_digest(
                prev[0], self._tag(d, prev[1], prev[2], prev[3])) \
                and prev[3] == self._epoch_of(prev[2])
            self._data[d] = (self._tag(d, verdict, scope, epoch), verdict,
                             scope, epoch, str(trace_id))
            evicted = 0
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)
                evicted += 1
            self.stats["verify_cache_evictions_total"] += evicted
        return dup

    def filter(self, items: Sequence) -> Tuple[List[int], List[Tuple]]:
        """Partition a dispatch batch against the cache.

        Returns (miss_positions, hits) where `hits` is a list of
        (position, verdict, trace_id).  Positions index into `items`.
        """
        miss: List[int] = []
        hits: List[Tuple[int, bool, str]] = []
        for i, it in enumerate(items):
            v, trace = self.lookup(it)
            if v is None:
                miss.append(i)
            else:
                hits.append((i, v, trace))
        return miss, hits

    def store(self, items: Sequence, verdicts, site: str,
              trace_id: str = "", scope: str = "") -> None:
        """Record a device dispatch's results and its economics: `items`
        aligned with `verdicts`, all freshly verified at `site` on
        behalf of channel `scope`."""
        dupes = 0
        for it, v in zip(items, verdicts):
            if self.put(it, bool(v), trace_id=trace_id, scope=scope):
                dupes += 1
        self.note_device_verifications(len(items), site)
        if dupes:
            self._count(
                "verify_plane_duplicate_device_verifications_total", site,
                dupes)

    def note_device_verifications(self, n: int, site: str) -> None:
        if n:
            self._count("verify_plane_device_verifications_total", site, n)

    def note_attested(self, n: int) -> None:
        with self._lock:
            self.stats["verify_plane_attested_skips_total"] += n

    def _count(self, series: str, label: str, n: int) -> None:
        with self._lock:
            by = self.stats[series]
            by[label] = by.get(label, 0) + n

    # -- introspection ------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def snapshot(self) -> dict:
        with self._lock:
            size = len(self._data)
            epochs = dict(self._epochs)
            st = self.stats
            rejects = sum(st["verify_cache_rejects_total"].values())
            return {"owner": self.owner, "size": size,
                    "capacity": self.capacity, "epochs": epochs,
                    "speculative": self.speculative_attached,
                    "coverage_frac": round(self.coverage.frac(), 4),
                    "hits_total": st["verify_cache_hits_total"],
                    "misses_total": st["verify_cache_misses_total"],
                    "rejects_total": rejects,
                    "evictions_total": st["verify_cache_evictions_total"]}


class CachingProvider:
    """Provider wrapper that consults/extends a VerdictCache around
    `batch_verify` — drops in wherever a Provider goes (the orderer's
    PolicyEvaluator path: SigFilter, block-signature checks), so every
    evaluate_signed_data transparently becomes verify-once."""

    def __init__(self, inner, cache: VerdictCache, site: str,
                 scope: str = ""):
        self._inner = inner
        self._cache = cache
        self._site = site
        self._scope = scope

    @property
    def name(self) -> str:
        return f"verify-once({self._inner.name})"

    def verify(self, item) -> bool:
        return bool(self.batch_verify([item])[0])

    def batch_verify(self, items):
        import numpy as np
        items = list(items)
        out = np.zeros(len(items), dtype=bool)
        miss, hits = self._cache.filter(items)
        for pos, v, _ in hits:
            out[pos] = v
        if miss:
            sub = [items[i] for i in miss]
            res = self._inner.batch_verify(sub)
            self._cache.store(sub, res, self._site, scope=self._scope)
            for i, v in zip(miss, res):
                out[i] = bool(v)
        return out

    def batch_verify_async(self, items):
        import numpy as np
        items = list(items)
        miss, hits = self._cache.filter(items)
        if not miss:
            out = np.zeros(len(items), dtype=bool)
            for pos, v, _ in hits:
                out[pos] = v
            return lambda: out
        sub = [items[i] for i in miss]
        resolve = self._inner.batch_verify_async(sub)
        cache, site, scope = self._cache, self._site, self._scope

        def resolved():
            res = resolve()
            cache.store(sub, res, site, scope=scope)
            out = np.zeros(len(items), dtype=bool)
            for pos, v, _ in hits:
                out[pos] = v
            for i, v in zip(miss, res):
                out[i] = bool(v)
            return out

        return resolved

    def __getattr__(self, name):
        return getattr(self._inner, name)
