"""Early-abort analysis: doom MVCC losers before device dispatch.

A transaction reading (ns, key) at version V can only survive the MVCC
pass if the version it observes at validation time equals V.  What it
can possibly observe is bounded before any signature work happens:

    M = {committed version of (ns, key)}
      ∪ {Version(block, j) : j < tx, j puts (ns, key) in this block}
      ∪ {None               if any j < tx deletes (ns, key)}

— the committed version if no preceding in-block writer lands, or one of
the preceding writers' versions if one does.  M is computed as a
SUPERSET of the observable set (writers that will themselves fail the
gate are still included — that only enlarges M and suppresses dooming),
so V ∉ M proves the tx loses MVCC no matter which txs turn out valid.
Such a tx is flagged MVCC_READ_CONFLICT by the txvalidator before its
VerifyItems are ever enqueued.

Range queries doom too, when decidable: a scanned interval that is
provably untouched by every preceding in-block write (no recorded
put/delete key falls in [start, end) of that namespace) merges to
exactly the committed range no matter which writers land, so replaying
it against committed state alone decides the oracle's verdict — a
mismatch dooms the tx PHANTOM_READ_CONFLICT.  A touched interval stays
undecidable and suppresses dooming, never flags.

Because the oracle stamps the code of the FIRST failing check in rwset
walk order (reads then ranges, per namespace), a certain failure only
dooms when no EARLIER check of the OTHER kind is uncertain: an
uncertain read before a certainly-failing range could fail first with
MVCC_READ_CONFLICT (and vice versa with PHANTOM_READ_CONFLICT), so
such a tx is known dead but its code byte is not — it is skipped (its
writes still never land) rather than doomed with a guess.

Scope guards (all conservative — any doubt means "doom nothing"):
  - only endorser txs that parse cleanly; parse failures stay on the
    BAD_RWSET path;
  - range queries over intervals touched by any preceding in-block
    write are never doomed (interval phantoms then depend on which
    writers land);
  - the committed version must be accounted for exactly.  Serially that
    means statedb.savepoint == block_num - 1 (validate runs strictly
    after the previous block's state commit).  Under the pipelined
    commit window the savepoint may lag anywhere in [N-W, N-1]; the
    guard then accepts a PendingOverlay covering every block of the gap
    (the window's frozen in-flight write set), and any key or interval
    the overlay touches is judged UNCERTAIN — the observable version
    depends on writes that are still in flight — which suppresses both
    the certainly-passes and the certainly-fails verdicts for it.  A
    gap the overlay does not fully cover fails the guard and gets no
    early aborts for that block — never a wrong flag.

Consensus note: the final flag byte of a doomed tx is MVCC_READ_CONFLICT
(or PHANTOM_READ_CONFLICT for a doomed range) even when the skipped
signature gate would have said BAD_CREATOR_
SIGNATURE / ENDORSEMENT_POLICY_FAILURE — the tx is invalid either way,
but the byte feeds the commit hash, so `parallel_commit.early_abort`
must be configured uniformly across peers of a channel (README
"Parallel commit").

Counterpart of `fabric_tpu/committer/parallel_commit/earlyabort.py`,
whole.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Set, Tuple

from fabric_tpu_torch.protocol import Envelope
from fabric_tpu_torch.protocol.txflags import ValidationCode

from fabric_tpu_torch.ledger.mvcc import _validate_range_query, parse_endorser_tx
from fabric_tpu_torch.ledger.statedb import StateDB, UpdateBatch

from .graph import PendingOverlay


class EarlyAbortAnalyzer:
    """Bound to one channel's state DB; stateless across blocks.

    `overlay_source` (e.g. KVLedger.pending_overlay on a windowed
    ledger) supplies the in-flight write-set snapshot that lets dooming
    keep working while the savepoint lags mid-window; without one the
    analyzer falls back to the strict savepoint == block-1 guard."""

    def __init__(self, statedb: StateDB, channel_id: str = "",
                 overlay_source: Optional[
                     Callable[[], Optional[PendingOverlay]]] = None):
        self.statedb = statedb
        self.channel_id = channel_id
        self.overlay_source = overlay_source

    def doomed(self, block,
               overlay: Optional[PendingOverlay] = None
               ) -> Dict[int, ValidationCode]:
        """tx_num -> MVCC_READ_CONFLICT for txs that cannot win MVCC.
        Empty when the savepoint guard fails (see module docstring)."""
        db = self.statedb
        blk = int(block.header.number)
        if overlay is None and self.overlay_source is not None:
            try:
                overlay = self.overlay_source()
            except Exception:
                overlay = None
        # snapshot the overlay BEFORE reading the savepoint: retirement
        # applies a block and only then pops it, so a savepoint read
        # second can only have advanced — the overlay stays a superset
        # of the real gap and the guard stays conservative
        sp = db.savepoint
        sp = -1 if sp is None else sp
        if sp != blk - 1:
            if (overlay is None
                    or not overlay.covers(sp + 1, blk - 1)
                    or any(b >= blk for b in overlay.blocks)):
                return {}
        pending = overlay.keys if overlay is not None else frozenset()

        def pending_interval(ns2: str, start2: str, end2: str) -> bool:
            return (overlay is not None
                    and overlay.touches_interval(ns2, start2, end2))

        doomed: Dict[int, ValidationCode] = {}
        puts: Dict[Tuple[str, str], Set[Tuple[int, int]]] = {}
        deleted: Set[Tuple[str, str]] = set()
        touched_keys: Set[Tuple[str, str]] = set()  # puts ∪ deleted
        committed_memo: Dict[Tuple[str, str],
                             Optional[Tuple[int, int]]] = {}

        def committed(k: Tuple[str, str]) -> Optional[Tuple[int, int]]:
            if k not in committed_memo:
                vv = db.get(k[0], k[1])
                committed_memo[k] = (None if vv is None else
                                     (vv.version.block_num,
                                      vv.version.tx_num))
            return committed_memo[k]

        for tx_num, raw in enumerate(block.data):
            try:
                parsed = parse_endorser_tx(Envelope.deserialize(raw))
            except Exception:
                continue
            if parsed is None:
                continue
            _txid, rwset = parsed
            dead = False
            dead_code: Optional[ValidationCode] = None
            read_unc = False    # an earlier read COULD fail (code 11)
            range_unc = False   # an earlier range COULD fail (code 12)
            for ns_rw in rwset.ns_rwsets:
                ns = ns_rw.namespace
                for read in ns_rw.reads:
                    k = (ns, read.key)
                    if k in pending:
                        # an in-flight predecessor writes this key: the
                        # observable version depends on a write that has
                        # not landed — could pass, could fail first
                        read_unc = True
                        continue
                    v = read.version
                    vt = None if v is None else (v.block_num, v.tx_num)
                    touched = k in deleted or k in puts
                    if vt == committed(k) and not touched:
                        continue         # certainly passes
                    in_m = (vt == committed(k)
                            or (vt is None and k in deleted)
                            or (vt is not None and vt in puts.get(k, ())))
                    if in_m:
                        read_unc = True  # outcome depends on writers
                        continue
                    dead = True          # V ∉ M: certainly fails
                    if not range_unc:
                        dead_code = ValidationCode.MVCC_READ_CONFLICT
                    break
                if dead:
                    break
                for rq in ns_rw.range_queries:
                    start, end = rq.start_key, rq.end_key
                    if any(ns2 == ns and k2 >= start
                           and (not end or k2 < end)
                           for ns2, k2 in touched_keys):
                        range_unc = True  # interval touched: undecidable
                        continue
                    if pending_interval(ns, start, end):
                        range_unc = True  # in-flight write in interval
                        continue
                    # untouched interval: the oracle's merged range IS
                    # the committed range — replay decides the verdict
                    if _validate_range_query(db, UpdateBatch(), ns, rq):
                        continue         # certainly passes
                    dead = True
                    if not read_unc:
                        dead_code = ValidationCode.PHANTOM_READ_CONFLICT
                    break
                if dead:
                    break
            if dead:
                # dead_code None: certainly invalid but the first-failure
                # code is ambiguous (earlier uncertain check of the other
                # kind) — don't doom, but its writes still never land
                if dead_code is not None:
                    doomed[tx_num] = dead_code
                continue
            for ns_rw in rwset.ns_rwsets:
                ns = ns_rw.namespace
                for w in ns_rw.writes:
                    k = (ns, w.key)
                    touched_keys.add(k)
                    if w.is_delete:
                        deleted.add(k)
                    else:
                        puts.setdefault(k, set()).add((blk, tx_num))
        return doomed
