"""Per-block read/write-set conflict graph + wavefront leveling.

Two transactions conflict when they touch a common (ns, key) and at
least one of them writes it — ww, wr (an earlier write feeding a later
read), and rw (an earlier read that a later write must not overtake:
waves reorder execution across tx order, so a later tx's write may be
applied to the working batch before an earlier tx validates unless an
edge orders them).  Range queries are pinned conservatively to their
namespace key-interval [start_key, end_key) (end_key "" = unbounded):
any write landing inside the interval, before or after the querying tx,
gets an edge.

Edges only ever point from a lower tx_num to a higher one, so the graph
is a DAG by construction; `level[j] = 1 + max(level[preds])` partitions
the block into waves — every transaction in a wave is independent of
every other, and all of a transaction's conflicting predecessors sit in
strictly earlier waves.

Cross-block extension (the commit window): a `PendingOverlay` freezes
the write keys of blocks that are admitted to the pipelined commit
window but whose state apply has not landed yet.  Building block N+1's
graph against that overlay adds virtual edges from the pending blocks
into N+1: a pending write feeding one of N+1's reads (cross-block wr)
or falling inside one of its scanned intervals (cross-block range)
makes the tx's verdict depend on state that is still in flight, so the
tx — and transitively everything ordered after it — is DEFERRED until
the overlay retires.  Cross-block ww hits are counted but never defer:
retirement is strictly in order, so same-key writes serialize at apply
time regardless of when the later block validated.

Counterpart of `fabric_tpu/committer/parallel_commit/graph.py`, whole.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, \
    Set, Tuple

EDGE_KINDS = ("ww", "wr", "rw", "range")
# cross-block edge kinds: an in-flight predecessor block's pending write
# vs this block's footprint (wr = feeds a read, range = lands inside a
# scanned interval — both defer; ww = same-key write, informational)
XBLOCK_KINDS = ("xww", "xwr", "xrange")


@dataclass
class TxFootprint:
    """The MVCC-relevant key touches of one parsed endorser tx."""
    tx_num: int
    reads: Set[Tuple[str, str]] = field(default_factory=set)
    writes: Set[Tuple[str, str]] = field(default_factory=set)
    # (ns, start_key, end_key); end_key "" = unbounded
    ranges: List[Tuple[str, str, str]] = field(default_factory=list)


def footprint_of(tx_num: int, rwset) -> TxFootprint:
    fp = TxFootprint(tx_num)
    for ns_rw in rwset.ns_rwsets:
        ns = ns_rw.namespace
        for r in ns_rw.reads:
            fp.reads.add((ns, r.key))
        for w in ns_rw.writes:
            fp.writes.add((ns, w.key))
        for rq in ns_rw.range_queries:
            fp.ranges.append((ns, rq.start_key, rq.end_key))
    return fp


def _in_interval(key: str, start_key: str, end_key: str) -> bool:
    """Same interval semantics as mvcc._merged_range: [start, end),
    falsy end_key = scan to the end of the namespace."""
    return key >= start_key and (not end_key or key < end_key)


class PendingOverlay:
    """Frozen write-key snapshot of the commit window's in-flight blocks.

    `blocks` are the block numbers admitted to the window whose state
    apply has not retired yet; `keys` is the UNION of their (ns, key)
    write sets, taken as a SUPERSET: every write of every tx still
    flagged valid at admit time is included, even ones that later lose
    MVCC — over-inclusion only defers more and is always safe, while a
    missed key could let a dependent tx validate against stale state.
    The snapshot is immutable: the window re-snapshots per admit."""

    __slots__ = ("blocks", "keys", "_by_ns")

    def __init__(self, blocks: Iterable[int],
                 keys: Iterable[Tuple[str, str]]):
        self.blocks: Tuple[int, ...] = tuple(sorted(int(b) for b in blocks))
        self.keys: FrozenSet[Tuple[str, str]] = frozenset(keys)
        by_ns: Dict[str, List[str]] = {}
        for ns, key in self.keys:
            by_ns.setdefault(ns, []).append(key)
        self._by_ns = {ns: sorted(ks) for ns, ks in by_ns.items()}

    @property
    def empty(self) -> bool:
        return not self.blocks

    def covers(self, lo: int, hi: int) -> bool:
        """True when every block of [lo, hi] is represented (the early-
        abort analyzer's guard: the gap between the state savepoint and
        the block under analysis must be exactly the in-flight set)."""
        return set(range(lo, hi + 1)) <= set(self.blocks)

    def touches_interval(self, ns: str, start_key: str,
                         end_key: str) -> bool:
        """Any pending write inside [start_key, end_key) of `ns`
        (mvcc._merged_range interval semantics)."""
        ks = self._by_ns.get(ns)
        if not ks:
            return False
        i = bisect.bisect_left(ks, start_key)
        return i < len(ks) and (not end_key or ks[i] < end_key)

    def conflicts(self, fp: TxFootprint) -> Optional[str]:
        """First DEFERRING cross-block hazard for `fp`, or None: "xwr"
        (a pending write feeds one of fp's reads — the observed version
        depends on whether/when the overlay lands) or "xrange" (a
        pending write lands inside a scanned interval — phantom verdict
        depends on the overlay).  Write-write overlap is NOT a deferral
        hazard — see module docstring."""
        for k in fp.reads:
            if k in self.keys:
                return "xwr"
        for ns, start_key, end_key in fp.ranges:
            if self.touches_interval(ns, start_key, end_key):
                return "xrange"
        return None

    def ww_hits(self, fp: TxFootprint) -> int:
        return sum(1 for k in fp.writes if k in self.keys)


class ConflictGraph:
    """Built once per block from the participating tx footprints
    (block order).  Exposes `preds` (tx_num -> conflicting lower
    tx_nums), `waves` (lists of tx_nums, block-ordered within each
    wave), and per-kind deduplicated `edge_counts`.

    With `overlay` set (pipelined commit window), also computes
    `deferred`: txs with a cross-block wr/range edge into the overlay,
    closed transitively over in-block successors — an early (non-
    deferred) tx therefore has ONLY early predecessors, so the early
    waves are a self-contained prefix projection that validates
    identically before or after the overlay's apply lands."""

    def __init__(self, footprints: Sequence[TxFootprint],
                 overlay: Optional[PendingOverlay] = None):
        self.preds: Dict[int, Set[int]] = {fp.tx_num: set()
                                           for fp in footprints}
        self.edge_counts: Dict[str, int] = {k: 0 for k in EDGE_KINDS}
        self.xblock_counts: Dict[str, int] = {k: 0 for k in XBLOCK_KINDS}
        self.deferred: Set[int] = set()
        self._seen_pairs: Set[Tuple[int, int]] = set()
        self._build(footprints)
        self.waves: List[List[int]] = self._level(footprints)
        if overlay is not None and not overlay.empty:
            self._cross_block(footprints, overlay)

    def _cross_block(self, footprints: Sequence[TxFootprint],
                     overlay: PendingOverlay) -> None:
        # direct hits, then transitive closure over preds: footprints
        # arrive in block order and edges point low -> high, so one
        # forward pass resolves every predecessor before its successors
        for fp in footprints:
            kind = overlay.conflicts(fp)
            if kind is not None:
                self.xblock_counts[kind] += 1
                self.deferred.add(fp.tx_num)
            ww = overlay.ww_hits(fp)
            if ww:
                self.xblock_counts["xww"] += ww
        for fp in footprints:
            if fp.tx_num in self.deferred:
                continue
            if any(p in self.deferred for p in self.preds[fp.tx_num]):
                self.deferred.add(fp.tx_num)

    def split_waves(self) -> Tuple[List[List[int]], List[List[int]]]:
        """(early_waves, deferred_waves), each preserving wave level
        order and in-wave block order.  Early waves may validate while
        the overlay's apply is still in flight; deferred waves run only
        after every in-flight predecessor block retires."""
        early: List[List[int]] = []
        late: List[List[int]] = []
        for wave in self.waves:
            e = [t for t in wave if t not in self.deferred]
            d = [t for t in wave if t in self.deferred]
            if e:
                early.append(e)
            if d:
                late.append(d)
        return early, late

    def _edge(self, a: int, b: int, kind: str) -> None:
        if a == b:
            return
        lo, hi = (a, b) if a < b else (b, a)
        if (lo, hi) in self._seen_pairs:
            return
        self._seen_pairs.add((lo, hi))
        self.preds[hi].add(lo)
        self.edge_counts[kind] += 1

    def _build(self, footprints: Sequence[TxFootprint]) -> None:
        # per-key chains: a writer links to the previous writer (ww) and
        # to every reader since it (rw); a reader links to the previous
        # writer (wr).  Transitivity through levels covers the rest.
        last_writer: Dict[Tuple[str, str], int] = {}
        readers_since: Dict[Tuple[str, str], List[int]] = {}
        all_writes: Dict[str, List[Tuple[str, int]]] = {}   # ns -> [(key, tx)]
        for fp in footprints:
            tx = fp.tx_num
            for k in fp.reads:
                if k not in fp.writes:        # read-write handled below
                    w = last_writer.get(k)
                    if w is not None:
                        self._edge(w, tx, "wr")
                    readers_since.setdefault(k, []).append(tx)
            for k in fp.writes:
                w = last_writer.get(k)
                if w is not None:
                    self._edge(w, tx, "ww" if k not in fp.reads else "wr")
                elif k in fp.reads:
                    pass                      # first toucher, no pred
                for r in readers_since.pop(k, ()):
                    self._edge(r, tx, "rw")
                last_writer[k] = tx
                all_writes.setdefault(k[0], []).append((k[1], tx))
        # range intervals vs every overlapping write, both directions
        for fp in footprints:
            for ns, start_key, end_key in fp.ranges:
                for key, wtx in all_writes.get(ns, ()):
                    if _in_interval(key, start_key, end_key):
                        self._edge(fp.tx_num, wtx, "range")

    def _level(self, footprints: Sequence[TxFootprint]) -> List[List[int]]:
        level: Dict[int, int] = {}
        by_level: Dict[int, List[int]] = {}
        for fp in footprints:                 # block order -> preds done
            lv = 1 + max((level[p] for p in self.preds[fp.tx_num]),
                         default=0)
            level[fp.tx_num] = lv
            by_level.setdefault(lv, []).append(fp.tx_num)
        return [by_level[lv] for lv in sorted(by_level)]

    @property
    def n_edges(self) -> int:
        return len(self._seen_pairs)

    @property
    def max_wave_width(self) -> int:
        return max((len(w) for w in self.waves), default=0)
