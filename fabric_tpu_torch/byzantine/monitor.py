"""ByzantineMonitor: the per-channel intake judge.

Every block that passed signature verification — from the deliver
stream or from gossip — is presented to `check_block(block, source)`
before it may enter the gossip buffer.  The verdicts:

  admit    normal path: witnessed, safe to buffer/commit
  stale    height already committed with the same hash (idempotent dup)
  hold     the height is DISPUTED (two validly-signed headers) and this
           hash has not yet won quorum confirmation — do not buffer;
           the deliver loop re-sources and anti-entropy re-supplies the
           winner once confirmed
  reject   this block is evidence of a crime (its signer equivocated or
           forked off the committed chain); the signer is quarantined
           and a signed fraud proof is persisted

Attribution policy (the no-false-positive core): only the identity
whose SIGNATURE covers a losing header is convicted.  Transport relays
are never convicted for the blocks they forward — an honest peer can
relay both sides of a fork before anyone knows it is a fork.  Transport
sources are only scored for intake offenses that honest code can never
emit (unparseable frames, bad signatures), and quarantined on repeat.

Dispute resolution: a disputed height is confirmed for hash A when
either (a) every competing hash has zero live (non-quarantined)
signers, or (b) A has >= `confirm_quorum` distinct live signers and
strictly more than every competitor.  With the default quorum of 2 this
is the f=1 containment bound: one lying consenter cannot outvote two
honest ones, and a single-consenter dev topology still resolves via
rule (a) once the liar is convicted of equivocation.

Exactly-once survives containment by construction: re-sourcing re-seeks
from the committed height and the committer's replay guard already
dedups overlap, so quarantining a stream's orderer loses nothing that
was accepted.

Counterpart of `fabric_tpu/byzantine/monitor.py`, the same code on the
port's imports.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional

from fabric_tpu_torch.byzantine.quarantine import (CRIME_REASONS,
                                             QuarantineRegistry)
from fabric_tpu_torch.byzantine.witness import WitnessLog
from fabric_tpu_torch.utils import serde

logger = logging.getLogger("fabric_tpu_torch.byzantine")

VERDICT_ADMIT = "admit"
VERDICT_STALE = "stale"
VERDICT_HOLD = "hold"
VERDICT_REJECT = "reject"


def _hex(b) -> str:
    try:
        return bytes(b).hex()
    except Exception:
        return str(b)


def _jsonable_sigs(block) -> List[dict]:
    """Block metadata signature entries as JSON-safe evidence."""
    try:
        from fabric_tpu_torch.protocol.types import META_SIGNATURES
        sigs = block.metadata.items.get(META_SIGNATURES) or []
    except Exception:
        return []
    out = []
    for entry in sigs:
        try:
            out.append({
                "creator": _hex(entry["sig_header"]["creator"]),
                "nonce": _hex(entry["sig_header"].get("nonce", b"")),
                "signature": _hex(entry["signature"])})
        except Exception:
            continue
    return out


def _incriminating_sigs(block) -> List[dict]:
    """The exact (signed-bytes, signature, creator) triples from the
    block's metadata — the portable core of a block-level fraud proof.
    Unlike `_jsonable_sigs` (display evidence), these carry the FULL
    message each signature covers, so any third party can re-verify the
    accused signed a conflicting header without trusting accuser or
    relay."""
    try:
        from fabric_tpu_torch.orderer.blockwriter import block_signed_bytes
        from fabric_tpu_torch.protocol.types import (META_LAST_CONFIG,
                                               META_SIGNATURES)
        sigs = block.metadata.items.get(META_SIGNATURES) or []
        last_config = block.metadata.items.get(META_LAST_CONFIG, 0)
    except Exception:
        return []
    out = []
    for entry in sigs:
        try:
            out.append({
                "creator": _hex(entry["sig_header"]["creator"]),
                "signed": _hex(block_signed_bytes(
                    block, entry["sig_header"], last_config)),
                "signature": _hex(entry["signature"])})
        except Exception:
            continue
    return out


def build_fraud_proof(channel_id: str, height: int, accused: str,
                      reason: str, evidence: dict,
                      signer=None) -> dict:
    """A self-contained, portable accusation: the witness-log extract
    plus the conflicting header we hold, signed by the accusing peer so
    a third party can check WHO is making the claim.  The provable core
    is inside `evidence`: two different header hashes at one height,
    each covered by a valid consenter signature."""
    body = {
        "v": 1, "channel": channel_id, "height": int(height),
        "accused": accused, "reason": reason, "evidence": evidence,
        "at": time.time(),
    }
    if signer is not None:
        try:
            body["accuser"] = _hex(signer.serialize())
            canonical = json.dumps(body, sort_keys=True).encode()
            body["signature"] = _hex(signer.sign(canonical))
        except Exception:
            logger.exception("fraud proof signing failed")
    return body


def verify_fraud_proof(proof: dict, msps) -> bool:
    """Check the accuser's signature over the canonical proof body."""
    try:
        from fabric_tpu_torch.msp import deserialize_from_msps
        body = {k: v for k, v in proof.items() if k != "signature"}
        canonical = json.dumps(body, sort_keys=True).encode()
        ident = deserialize_from_msps(
            msps, bytes.fromhex(proof["accuser"]), validate=True)
        if ident is None:
            return False
        return bool(ident.verify(canonical,
                                 bytes.fromhex(proof["signature"])))
    except Exception:
        return False


def _verify_entry_equivocation(accused: str, ev: dict, msps):
    """Raft-entry equivocation evidence is fully self-contained: two
    valid consenter signatures over two DIFFERENT payloads for one
    (term, index) slot."""
    try:
        from fabric_tpu_torch.msp import deserialize_from_msps
        from fabric_tpu_torch.orderer import raft as raftmod
        from fabric_tpu_torch.orderer.cluster import cert_fingerprint
        ident = deserialize_from_msps(
            msps, bytes.fromhex(ev["proposer"]), validate=True)
        if ident is None:
            return False, "unknown_proposer"
        if f"{ident.mspid}|{cert_fingerprint(ident.cert)}" != accused:
            return False, "proposer_not_accused"
        term, index = int(ev["term"]), int(ev["index"])
        payloads = set()
        for side in ("a", "b"):
            s = ev[side]
            data = bytes.fromhex(s["data"])
            kind = s["entry_kind"]
            if not ident.verify(
                    raftmod.entry_signed_bytes(term, index, data, kind),
                    bytes.fromhex(s["sig"])):
                return False, f"bad_sig_{side}"
            payloads.add((kind, data))
        if len(payloads) < 2:
            return False, "identical_payloads"
        return True, "entry_equivocation_pair"
    except Exception:
        return False, "malformed_entry_evidence"


def verify_fraud_proof_strict(proof: dict, msps, ledger=None):
    """Independently re-verify a RECEIVED fraud proof — trust neither
    relay nor accuser.  Beyond the accuser's signature, the evidence
    payload itself must incriminate the accused:

      * raft-entry equivocation: two valid signatures by the accused
        over two different payloads for one log slot (self-contained);
      * block equivocation: two valid signatures by the accused over
        two different headers at the proof height (self-contained);
      * fork: ONE valid signature by the accused over a header at the
        proof height that conflicts with OUR OWN committed chain — the
        local ledger is the second witness, so the claim is checked
        against evidence the receiver already holds.

    A proof accusing a node of anything a crash-stop fault could
    explain — no signature by the accused over conflicting payloads —
    is rejected, never convicted.  -> (ok, why)."""
    if not verify_fraud_proof(proof, msps):
        return False, "bad_accuser_sig"
    reason = proof.get("reason")
    if reason not in CRIME_REASONS:
        return False, "unprovable_reason"
    accused = proof.get("accused") or ""
    ev = proof.get("evidence") or {}
    if ev.get("kind") == "raft_entry_equivocation":
        return _verify_entry_equivocation(accused, ev, msps)
    height = int(proof.get("height", -1))
    if height < 0:
        return False, "no_height"
    hashes = set()
    for ent in ev.get("attested") or []:
        try:
            import hashlib
            from fabric_tpu_torch.msp import deserialize_from_msps
            from fabric_tpu_torch.orderer.cluster import cert_fingerprint
            ident = deserialize_from_msps(
                msps, bytes.fromhex(ent["creator"]), validate=True)
            if ident is None:
                continue
            if f"{ident.mspid}|{cert_fingerprint(ident.cert)}" != accused:
                continue
            signed = bytes.fromhex(ent["signed"])
            if not ident.verify(signed, bytes.fromhex(ent["signature"])):
                continue
            hdr = serde.decode(signed)["header"]
            if int(hdr.get("number", -1)) != height:
                continue
            hashes.add(hashlib.sha256(serde.encode(hdr)).hexdigest())
        except Exception:
            continue
    if not hashes:
        return False, "no_self_incriminating_signature"
    if len(hashes) >= 2:
        return True, "equivocation_pair"
    hhex = next(iter(hashes))
    if ledger is not None:
        try:
            from fabric_tpu_torch.protocol import block_header_hash
            if height < ledger.height:
                stored = ledger.blockstore.get_by_number(height)
                if block_header_hash(stored.header).hex() != hhex:
                    return True, "fork_vs_local_chain"
                return False, "matches_local_chain"
        except Exception:
            pass
    return False, "unverifiable_single_header"


def build_pardon(channel_id: str, pardoned: str, reason: str,
                 clean_window_s: float, clean_since: float,
                 signer=None) -> dict:
    """A signed standing-restoration record, symmetric to a fraud
    proof: WHO is pardoned, WHAT offense-based reason is being cleared,
    and the clean-observation window the issuer attests to.  Receivers
    re-verify the issuer's signature and that the cleared reason is not
    a crime — a pardon can never launder an equivocation conviction."""
    body = {
        "v": 1, "kind": "pardon", "channel": channel_id,
        "pardoned": pardoned, "reason": reason,
        "clean_window_s": float(clean_window_s),
        "clean_since": float(clean_since), "at": time.time(),
    }
    if signer is not None:
        try:
            body["issuer"] = _hex(signer.serialize())
            canonical = json.dumps(body, sort_keys=True).encode()
            body["signature"] = _hex(signer.sign(canonical))
        except Exception:
            logger.exception("pardon signing failed")
    return body


def verify_pardon(pardon: dict, msps) -> bool:
    """Check the issuer's signature over the canonical pardon body."""
    try:
        from fabric_tpu_torch.msp import deserialize_from_msps
        body = {k: v for k, v in pardon.items() if k != "signature"}
        canonical = json.dumps(body, sort_keys=True).encode()
        ident = deserialize_from_msps(
            msps, bytes.fromhex(pardon["issuer"]), validate=True)
        if ident is None:
            return False
        return bool(ident.verify(canonical,
                                 bytes.fromhex(pardon["signature"])))
    except Exception:
        return False


def verify_pardon_strict(pardon: dict, msps):
    """Independently re-verify a RECEIVED pardon — trust neither issuer
    claim nor relay.  The issuer must validate against the channel MSPs
    and have signed the canonical body (any tampering — a different
    pardoned key, an altered reason — breaks the signature), and the
    cleared reason must be offense-based: crime convictions are proven
    by signed evidence and NEVER decay, so a 'pardon' naming one is
    forged or malicious by construction.  -> (ok, why)."""
    if pardon.get("kind") != "pardon":
        return False, "not_a_pardon"
    if not verify_pardon(pardon, msps):
        return False, "bad_issuer_sig"
    if pardon.get("reason") in CRIME_REASONS:
        return False, "crime_never_decays"
    if not pardon.get("pardoned"):
        return False, "no_subject"
    return True, "verified"


class ByzantineMonitor:
    """One channel's detection/containment judge (thread-safe)."""

    def __init__(self, channel_id: str, witness: WitnessLog,
                 quarantine: QuarantineRegistry, ledger=None,
                 msps=None, signer=None, proof_dir: Optional[str] = None,
                 confirm_quorum: int = 2,
                 pardon_window_s: Optional[float] = None):
        self.channel_id = channel_id
        self.witness = witness
        self.quarantine = quarantine
        self.ledger = ledger           # needs .height + .blockstore
        self.msps = msps
        self.signer = signer
        self.proof_dir = proof_dir
        self.confirm_quorum = max(1, int(confirm_quorum))
        self._lock = threading.Lock()
        self.proofs: List[dict] = []
        self._proof_seq = 0
        # single-header proofs that arrived BEFORE our chain reached the
        # proof height (no local block to conflict with yet): parked and
        # re-judged as commits land, so a fast accuser never outruns a
        # slow receiver.  Bounded — an attacker spraying unverifiable
        # accusations only ever occupies this much memory.
        self._deferred: List[dict] = []
        self.DEFERRED_MAX = 32
        # on_proof(proof): fired once per NEW local conviction with the
        # signed portable proof — the proof-gossip plane broadcasts it.
        # NEVER fired for remotely-received proofs (accept_remote_proof),
        # so re-broadcast loops terminate at the quarantine dedup.
        self.on_proof = None
        # proof-backed pardon: when pardon_window_s is set, an
        # offense-quarantined identity that stays clean for the window
        # is pardoned — a SIGNED pardon_NNNNN.json record persisted and
        # gossiped exactly like a fraud proof, re-verified by receivers.
        # None = disabled (quarantine stays permanent).
        self.pardon_window_s = pardon_window_s
        self.pardons: List[dict] = []
        self._pardon_seq = 0
        # on_pardon(record): fired once per NEW locally-issued pardon
        # (never for remotely-received ones — same loop-termination
        # discipline as on_proof).
        self.on_pardon = None
        if proof_dir is not None:
            try:
                os.makedirs(proof_dir, exist_ok=True)
                for name in sorted(os.listdir(proof_dir)):
                    if name.startswith("fraud_") and name.endswith(".json"):
                        with open(os.path.join(proof_dir, name)) as f:
                            self.proofs.append(json.load(f))
                    elif name.startswith("pardon_") \
                            and name.endswith(".json"):
                        with open(os.path.join(proof_dir, name)) as f:
                            self.pardons.append(json.load(f))
                self._proof_seq = len(self.proofs)
                self._pardon_seq = len(self.pardons)
            except Exception:
                logger.exception("fraud proof dir unreadable: %s",
                                 proof_dir)

    # -- identity helpers ----------------------------------------------------

    def signer_bindings(self, block) -> List[str]:
        """'mspid|cert-sha256' for every identity whose (already
        verified) signature the block's metadata carries."""
        try:
            from fabric_tpu_torch.protocol.types import META_SIGNATURES
            sigs = block.metadata.items.get(META_SIGNATURES) or []
        except Exception:
            return []
        out: List[str] = []
        for entry in sigs:
            try:
                from fabric_tpu_torch.msp import deserialize_from_msps
                from fabric_tpu_torch.orderer.cluster import cert_fingerprint
                ident = deserialize_from_msps(
                    self.msps, entry["sig_header"]["creator"],
                    validate=False)
                if ident is None:
                    continue
                key = f"{ident.mspid}|{cert_fingerprint(ident.cert)}"
                if key not in out:
                    out.append(key)
            except Exception:
                continue
        return out

    def blocked_source(self, source: Optional[str]) -> bool:
        return self.quarantine.is_quarantined(source)

    def offense(self, source: str, reason: str) -> None:
        """Score a transport-level intake offense (garbage / bad sig)."""
        self.quarantine.offense(source, reason)

    # -- the intake judgment -------------------------------------------------

    def check_block(self, block, source: str) -> str:
        """Judge one signature-verified block from `source` (a transport
        identity key).  See module docstring for the verdicts."""
        from fabric_tpu_torch.protocol import block_header_hash
        try:
            num = int(block.header.number)
            hhex = block_header_hash(block.header).hex()
        except Exception:
            return VERDICT_HOLD
        signers = self.signer_bindings(block)
        with self._lock:
            # 1. committed heights: the blockstore is the witness
            committed = self._committed_hash(num)
            if committed is not None:
                if committed == hhex:
                    return VERDICT_STALE
                # validly-signed header off the committed chain: every
                # signer provably signed outside consensus
                self._convict(
                    signers, num, "fork",
                    {"committed": committed, "conflicting": hhex,
                     "header": self._header_dict(block),
                     "signatures": _jsonable_sigs(block),
                     "attested": _incriminating_sigs(block),
                     "source": source})
                return VERDICT_REJECT

            # 2. witness the vouch, then judge the height's state
            ent = self.witness.vouch(num, hhex, source, signers)
            if len(ent["hashes"]) > 1:
                self._judge_dispute(num, ent, block, source)
                ent = self.witness.get(num) or ent
                confirmed = ent.get("confirmed")
                if confirmed is None:
                    return VERDICT_HOLD
                return (VERDICT_ADMIT if confirmed == hhex
                        else VERDICT_REJECT)
            # single known hash: admit unless it is vouched ONLY by
            # quarantined identities (a convicted signer's solo word is
            # not enough — re-sourcing fetches a healthy-signed copy)
            if signers and not any(
                    not self.quarantine.is_quarantined(s)
                    for s in signers):
                return VERDICT_HOLD
            return VERDICT_ADMIT

    def check_commit(self, block) -> bool:
        """Drain-time guard: may this buffered block be committed?
        False when its height is disputed-unresolved or its hash lost —
        blocks buffered BEFORE their height became disputed are caught
        here."""
        from fabric_tpu_torch.protocol import block_header_hash
        try:
            num = int(block.header.number)
            hhex = block_header_hash(block.header).hex()
        except Exception:
            return False
        ent = self.witness.get(num)
        if ent is None:
            return True
        confirmed = ent.get("confirmed")
        if confirmed is not None:
            return confirmed == hhex
        return len(ent["hashes"]) <= 1

    def on_committed(self, height: int) -> None:
        self.witness.prune_below(height)
        self._retry_deferred()
        if self.pardon_window_s is not None:
            self.maybe_pardon()
            self.quarantine.decay_scores(self.pardon_window_s)

    # -- proof-backed pardon -------------------------------------------------

    def maybe_pardon(self, now: Optional[float] = None) -> List[dict]:
        """Issue pardons for every offense-quarantined identity whose
        clean-observation window has elapsed.  Each pardon is a signed,
        persisted record (pardon_NNNNN.json beside the fraud proofs) and
        fires on_pardon for the gossip plane.  Returns the new records.
        The registry's pardon() re-checks crime permanence, so even a
        racing conviction cannot be laundered."""
        if self.pardon_window_s is None:
            return []
        issued: List[dict] = []
        for key in self.quarantine.pardonable_keys(self.pardon_window_s,
                                                   now=now):
            # snapshot the entry BEFORE pardon() resets it: the record
            # must name the reason being cleared and the clean-since
            # instant the issuer attests to
            ent = self.quarantine.snapshot().get(key) or {}
            reason = ent.get("reason") or "poison"
            since = ent.get("last_offense_at") or ent.get("at") or 0.0
            if not self.quarantine.pardon(key):
                continue           # raced with a crime conviction: refused
            record = build_pardon(self.channel_id, key, reason,
                                  self.pardon_window_s, since,
                                  self.signer)
            with self._lock:
                self.pardons.append(record)
                self._persist_pardon(record)
            issued.append(record)
            logger.warning("[%s] issued pardon for %s (clean for %.1fs)",
                           self.channel_id, key, self.pardon_window_s)
            if self.on_pardon is not None:
                try:
                    self.on_pardon(record)
                except Exception:
                    logger.exception("pardon broadcast failed")
        return issued

    def accept_remote_pardon(self, pardon: dict,
                             relay: Optional[str] = None) -> str:
        """Judge a pardon received over the wire.  Restores standing
        only when the record independently re-verifies AND our own
        conviction for that identity is offense-based — a local CRIME
        conviction (signed evidence we hold) is never overridden by
        anyone's pardon.  -> 'pardoned' | 'duplicate' | 'rejected'."""
        ok, why = verify_pardon_strict(pardon, self.msps)
        if not ok:
            logger.warning("[%s] remote pardon rejected (%s) relay=%s",
                           self.channel_id, why, relay)
            return "rejected"
        key = pardon["pardoned"]
        if not self.quarantine.is_quarantined(key):
            return "duplicate"     # already restored (or never held here)
        if not self.quarantine.pardon(key):
            # pardon() refused: our local conviction is a crime
            logger.warning("[%s] remote pardon for %s REFUSED: local "
                           "crime conviction stands relay=%s",
                           self.channel_id, key, relay)
            return "rejected"
        with self._lock:
            self.pardons.append(pardon)
            self._persist_pardon(pardon)
        logger.warning("[%s] standing restored for %s via remote pardon "
                       "relay=%s", self.channel_id, key, relay)
        return "pardoned"

    def _persist_pardon(self, record: dict) -> None:
        """Caller holds the lock; same atomic discipline as proofs."""
        if self.proof_dir is None:
            return
        try:
            name = f"pardon_{self._pardon_seq:05d}.json"
            self._pardon_seq += 1
            tmp = os.path.join(self.proof_dir, name + ".tmp")
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(record, f, sort_keys=True)
            os.replace(tmp, os.path.join(self.proof_dir, name))
        except Exception:
            logger.exception("pardon record not persisted")

    def convict_external(self, identity: str, reason: str,
                         evidence: Optional[dict] = None) -> None:
        """Quarantine an identity for a crime proven OUTSIDE the witness
        log (e.g. a tampered attestation digest caught by the
        trust registry)."""
        with self._lock:
            self._convict([identity], -1, reason, evidence or {})

    def accept_remote_proof(self, proof: dict,
                            relay: Optional[str] = None) -> str:
        """Judge a fraud proof received over the wire and convict WITHOUT
        local witness evidence when — and only when — it independently
        re-verifies (verify_fraud_proof_strict: accuser signature AND a
        self-incriminating payload by the accused).  The relay is never
        trusted and never blamed.  -> 'convicted' | 'duplicate' |
        'rejected'."""
        ok, why = verify_fraud_proof_strict(proof, self.msps,
                                            ledger=self.ledger)
        if not ok:
            if why == "unverifiable_single_header":
                # accuser sig and the self-incriminating signature both
                # held — we just have not committed the proof height
                # yet.  Park it; _retry_deferred re-judges on commit.
                with self._lock:
                    if (not self.quarantine.is_quarantined(
                            proof.get("accused"))
                            and len(self._deferred) < self.DEFERRED_MAX):
                        self._deferred.append(proof)
                        logger.info(
                            "[%s] remote fraud proof deferred (height "
                            "%s not committed yet) relay=%s",
                            self.channel_id, proof.get("height"), relay)
                        return "deferred"
            logger.warning("[%s] remote fraud proof rejected (%s) "
                           "relay=%s", self.channel_id, why, relay)
            return "rejected"
        accused, reason = proof["accused"], proof["reason"]
        with self._lock:
            if not self.quarantine.quarantine(accused, reason):
                return "duplicate"
            logger.warning("[%s] convicted %s via remote fraud proof "
                           "(%s, %s) relay=%s", self.channel_id, accused,
                           reason, why, relay)
            self.proofs.append(proof)
            self._persist_proof(proof)
        return "convicted"

    def _retry_deferred(self) -> None:
        """Re-judge parked single-header proofs against the chain we
        hold NOW.  A proof that verifies convicts like any local one —
        on_proof fires, so the epidemic resumes from here."""
        with self._lock:
            if not self._deferred:
                return
            still: List[dict] = []
            for proof in self._deferred:
                ok, why = verify_fraud_proof_strict(proof, self.msps,
                                                    ledger=self.ledger)
                if not ok:
                    if why == "unverifiable_single_header":
                        still.append(proof)   # height still ahead of us
                    continue                  # e.g. matches_local_chain
                accused, reason = proof["accused"], proof["reason"]
                if not self.quarantine.quarantine(accused, reason):
                    continue
                logger.warning("[%s] convicted %s via deferred fraud "
                               "proof (%s, %s)", self.channel_id,
                               accused, reason, why)
                self.proofs.append(proof)
                self._persist_proof(proof)
                if self.on_proof is not None:
                    try:
                        self.on_proof(proof)
                    except Exception:
                        logger.exception("fraud proof broadcast failed")
            self._deferred = still

    # -- internals -----------------------------------------------------------

    def _committed_hash(self, num: int) -> Optional[str]:
        from fabric_tpu_torch.protocol import block_header_hash
        try:
            if self.ledger is None or num >= self.ledger.height:
                return None
            stored = self.ledger.blockstore.get_by_number(num)
            return block_header_hash(stored.header).hex()
        except Exception:
            return None

    @staticmethod
    def _header_dict(block) -> dict:
        try:
            return {k: (_hex(v) if isinstance(v, (bytes, bytearray,
                                                  memoryview)) else v)
                    for k, v in block.header.to_dict().items()}
        except Exception:
            return {}

    def _live_signers(self, rec: dict) -> List[str]:
        return [s for s in rec["signers"]
                if not self.quarantine.is_quarantined(s)]

    def _judge_dispute(self, num: int, ent: dict, block,
                       source: str) -> None:
        """Called under the lock with >= 2 hashes witnessed at `num`.
        Convicts same-signer equivocators, then tries to confirm a
        winner by live-signer quorum."""
        hashes = ent["hashes"]
        evidence = {"witness": {h: {"sources": list(r["sources"]),
                                    "signers": list(r["signers"])}
                                for h, r in hashes.items()},
                    "header": self._header_dict(block),
                    "signatures": _jsonable_sigs(block),
                    "attested": _incriminating_sigs(block),
                    "source": source}
        # (a) the perfect proof: one identity signed two different
        # headers at one height
        seen: Dict[str, str] = {}
        for h, rec in hashes.items():
            for s in rec["signers"]:
                if s in seen and seen[s] != h:
                    self._convict([s], num, "equivocation", evidence)
                else:
                    seen.setdefault(s, h)
        if ent.get("confirmed") is not None:
            return
        # (b) quorum confirmation over live signers
        live = {h: self._live_signers(rec) for h, rec in hashes.items()}
        alive = {h: sigs for h, sigs in live.items() if sigs}
        winner = None
        if len(alive) == 1:
            winner = next(iter(alive))
        elif alive:
            ranked = sorted(alive.items(), key=lambda kv: -len(kv[1]))
            top_h, top_live = ranked[0]
            if (len(top_live) >= self.confirm_quorum
                    and len(top_live) > len(ranked[1][1])):
                winner = top_h
        if winner is None:
            return
        self.witness.confirm(num, winner)
        losers = [s for h, rec in hashes.items() if h != winner
                  for s in rec["signers"]]
        self._convict(sorted(set(losers)), num, "fork",
                      {**evidence, "confirmed": winner})

    def _convict(self, identities: List[str], height: int, reason: str,
                 evidence: dict) -> None:
        """Quarantine + emit one signed fraud proof per NEW conviction.
        Caller holds the lock."""
        for ident in identities:
            if not ident:
                continue
            if not self.quarantine.quarantine(ident, reason):
                continue              # already quarantined: no new proof
            proof = build_fraud_proof(self.channel_id, height, ident,
                                      reason, evidence, self.signer)
            self.proofs.append(proof)
            self._persist_proof(proof)
            if self.on_proof is not None:
                try:
                    self.on_proof(proof)
                except Exception:
                    logger.exception("fraud proof broadcast failed")

    def _persist_proof(self, proof: dict) -> None:
        if self.proof_dir is None:
            return
        try:
            name = f"fraud_{self._proof_seq:05d}.json"
            self._proof_seq += 1
            tmp = os.path.join(self.proof_dir, name + ".tmp")
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(proof, f, sort_keys=True)
            os.replace(tmp, os.path.join(self.proof_dir, name))
        except Exception:
            logger.exception("fraud proof not persisted")

    # -- ops view ------------------------------------------------------------

    def snapshot(self) -> dict:
        return {"channel": self.channel_id,
                "witness": self.witness.stats(),
                "disputed_heights": self.witness.disputed_heights(),
                "fraud_proofs": len(self.proofs),
                "deferred_proofs": len(self._deferred),
                "pardons": len(self.pardons),
                "pardon_window_s": self.pardon_window_s}
