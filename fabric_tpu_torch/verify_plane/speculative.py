"""Speculative verification: fill the verdict cache DURING ordering.

The gateway's batcher hands each outgoing batch here right before it
broadcasts to the orderer.  The creator signatures are stamped
synchronously (one batched dispatch — they also back the verdict
attestations that ride beside the envelopes), and the endorsement
signatures are verified on a background worker *while the orderer is
cutting the block* (arxiv 2104.06968's validate-off-the-wire overlap).
By the time the block comes back through deliver, the commit-time
validator's dispatch degrades to cache lookups + MVCC.

Item derivation MUST be bit-identical to the committer's pass-1 walk
or the cache keys would never match at commit: envelopes go through
the same walker record the classic tail consumes,
and items are assembled with the same P256 fast path / `verify_item`
fallback as `TxValidator._collect_tx_fast`.  MSP chain validation is
deliberately NOT consulted here — only the pure signature bit is
cached; identity validity is always judged live at the gate.

Counterpart of `fabric_tpu/verify_plane/speculative.py`.  Items are
derived through the port's C walker only (`native/fastcollect.c`
collect, which loads or raises); `collect_py` is its differential
oracle in the tests.  Not ported yet: the `verify_plane.speculative`
span and the trace links it puts into the cache entries (every entry's
trace id is ""), and the gateway wiring that calls `stamp`.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

from fabric_tpu_torch import native
from fabric_tpu_torch.bccsp import SCHEME_P256, VerifyItem

from .cache import VerdictCache, item_digest

# native pass-1 walker: the gateway's submit path derives items through
# the SAME extractor the committer runs, so the zero-copy ingest bytes
# never detour through a Python object tree here either
_fastcollect = native.extension("fastcollect")

logger = logging.getLogger("fabric_tpu_torch.verify_plane")


def _raw_bytes(env):
    """Serialized envelope bytes: raw submissions pass through untouched
    (the gateway keeps wire bytes all the way here), Envelope objects
    serialize once."""
    if isinstance(env, (bytes, bytearray, memoryview)):
        return env
    return env.serialize()


def _ident_item(msps, memo: dict, ident_bytes: bytes, msg: bytes,
                sig: bytes, digest: Optional[bytes]):
    """One identity's VerifyItem, memoized per call batch.  `digest` is
    the precomputed sha256 for the P256 fast path (None falls back to
    verify_item, which hashes itself)."""
    ent = memo.get(ident_bytes, memo)
    if ent is memo:
        from fabric_tpu_torch.msp import deserialize_from_msps
        ident = deserialize_from_msps(msps, ident_bytes)
        ent = None if ident is None else (
            ident, ident._pub_wire
            if getattr(ident, "scheme", None) == SCHEME_P256 else None)
        memo[ident_bytes] = ent
    if ent is None:
        return None
    ident, pub_wire = ent
    if pub_wire is not None and digest is not None:
        return VerifyItem(SCHEME_P256, pub_wire, sig, digest)
    return ident.verify_item(msg, sig)


def derive_items(raw_env: bytes, channel_id: str, msps,
                 memo: Optional[dict] = None) -> Tuple[List, List]:
    """(creator_items, endorsement_items) for one serialized envelope —
    the exact VerifyItems the committer will intern for it, or empty
    lists when the envelope is structurally invalid (the committer
    flags those without any crypto; nothing to speculate on)."""
    if memo is None:
        memo = {}
    rec = _fastcollect.collect([raw_env], channel_id)[0]
    if isinstance(rec, int) or len(rec) == 2:
        return [], []
    txtype, txid, creator, payload, pdigest, signature, actions = rec
    it = _ident_item(msps, memo, creator, payload, signature, pdigest)
    creators = [it] if it is not None else []
    endorse: List = []
    if txtype != 0:
        for cc_id, endorsed, endorsements, ns_writes, meta in actions:
            for endorser, esig, edigest in endorsements:
                it = _ident_item(msps, memo, endorser,
                                 endorsed + endorser, esig, edigest)
                if it is not None:
                    endorse.append(it)
    return creators, endorse


class SpeculativeVerifier:
    """Background verdict-cache filler for a gateway-hosting node.

    `provider_source()` returns the node's verify provider (resolved
    per dispatch so degradation/placement swaps keep working);
    `msps_source(channel_id)` returns the channel's live MSP set;
    `epoch_source(channel_id)`, when given, returns the channel's
    config sequence so entries are minted under the same per-channel
    epoch the commit gate will judge them against.
    """

    def __init__(self, cache: VerdictCache, provider_source,
                 msps_source, max_queue: int = 4096, epoch_source=None):
        self.cache = cache
        self.provider_source = provider_source
        self.msps_source = msps_source
        self.epoch_source = epoch_source
        self._queue: deque = deque(maxlen=int(max_queue))   # (cid, items)
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="verify-plane-spec", daemon=True)
        self.dispatched = 0          # items device-verified speculatively
        cache.speculative_attached = True

    def start(self) -> "SpeculativeVerifier":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)

    # -- the synchronous ingress half ------------------------------------

    def stamp(self, envs, channel_ids, spans=None) -> List[str]:
        """Verify each envelope's creator signature NOW (one batched
        dispatch for the whole gateway batch) and queue its endorsement
        set for background verification.  Returns the per-envelope
        verdict attestation digests ("" where no verdict is available)
        that ride beside the envelopes to the orderer.

        `envs` entries may be Envelope objects or raw serialized bytes;
        the gateway submit path hands wire bytes straight through so the
        native extractor works on the original frame buffer.

        `spans`, when given, are the per-envelope ordering spans; the
        ingress verify trace is linked into each so a client's request
        trace reaches the device work done on its behalf (the batcher
        thread has no ambient context, so without the link the
        speculative trace would be a disconnected root)."""
        per_env_items: List[List] = []
        memos: Dict[str, dict] = {}
        for cid in set(channel_ids):
            self._pin_epoch(cid)
        for env, cid in zip(envs, channel_ids):
            try:
                creators, endorse = derive_items(
                    _raw_bytes(env), cid, self.msps_source(cid),
                    memos.setdefault(cid, {}))
            except Exception:
                logger.debug("speculative derive failed", exc_info=True)
                creators, endorse = [], []
            per_env_items.append(creators)
            if endorse:
                with self._cv:
                    self._queue.append((cid, endorse))
                    self._cv.notify()
        # one dispatch per channel: every verdict is minted under ITS
        # channel's epoch (the scope the commit gate judges it by)
        by_cid: Dict[str, List] = {}
        for items, cid in zip(per_env_items, channel_ids):
            by_cid.setdefault(cid, []).extend(items)
        for cid, flat in by_cid.items():
            if not flat:
                continue
            tid = self._verify_batch(flat, stage="ingress", scope=cid)
            if tid and spans:
                for sp, sp_cid in zip(spans, channel_ids):
                    if sp_cid != cid:
                        continue
                    try:
                        sp.add_link(tid)
                    except Exception:
                        pass
        attests = []
        for items in per_env_items:
            if len(items) == 1 and self.cache.peek(items[0]) is True:
                attests.append(item_digest(items[0]).hex())
            else:
                attests.append("")
        return attests

    # -- the background half ----------------------------------------------

    def _pin_epoch(self, cid: str) -> None:
        """Align the cache's per-channel epoch with the channel's live
        config sequence before minting under that scope."""
        if self.epoch_source is None:
            return
        try:
            self.cache.set_epoch(self.epoch_source(cid), scope=cid)
        except Exception:
            pass

    def _loop(self) -> None:
        while not self._stop.is_set():
            with self._cv:
                while not self._queue and not self._stop.is_set():
                    self._cv.wait(0.2)
                batches: Dict[str, List] = {}
                while self._queue:
                    cid, items = self._queue.popleft()
                    batches.setdefault(cid, []).extend(items)
            for cid, batch in batches.items():
                try:
                    self._verify_batch(batch, stage="overlap", scope=cid)
                except Exception:
                    logger.exception("speculative verify batch failed")

    def _verify_batch(self, items, stage: str, scope: str = "") -> str:
        """Dispatch the not-yet-cached subset and stamp the verdicts.
        Returns the trace id that links the commit-time block trace to
        this work: "" until the port traces (the reference opens a
        `verify_plane.speculative` span here, tagged with `stage`)."""
        miss, _hits = self.cache.filter(items)
        if not miss:
            return ""
        sub = [items[i] for i in miss]
        out = self.provider_source().batch_verify_async(sub)()
        self.cache.store(sub, out, site="speculative", scope=scope)
        self.dispatched += len(sub)
        return ""
