"""Raft consensus core: a deterministic tick/step/ready state machine.

Reference parity: orderer/consensus/etcdraft/{chain,node,storage}.go, which
drive the vendored etcd/raft library.  This is a from-scratch Raft in the
same architectural style as etcd/raft — a *pure* state machine advanced by
`tick()` and `step(msg)`, with all I/O (message sends, disk writes, entry
application) drained through `ready()` — because that style is what makes
consensus testable without a cluster (SURVEY.md §4.2) and lets the orderer
own its WAL/snapshot persistence exactly like etcdraft/storage.go:19-24.

Implements: leader election with randomized timeouts and pre-vote-free
up-to-date checks, log replication with conflict-hint backtracking, commit
via quorum match + current-term guard (§5.4.2 of the Raft paper), snapshot
install for lagging followers, and single-server membership changes.
Persistence: `WAL` (append-only hard-state+entry records, torn-write
tolerant) and `SnapshotFile`, both fsync'd before messages leave the node.

Counterpart of `fabric_tpu/orderer/raft.py`, whole, on the port's imports:
the WAL's records and `SnapshotFile`'s bytes are the reference's, so
either package replays the other's `wal.bin` and `snap.bin`, and the
messages it emits are the ones the reference's cluster sends.
"""

from __future__ import annotations

import os
import random
import struct
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from fabric_tpu_torch.utils import serde

FOLLOWER = "follower"
CANDIDATE = "candidate"
LEADER = "leader"

# message types
MSG_VOTE = "vote"
MSG_VOTE_RESP = "vote_resp"
MSG_APP = "app"            # AppendEntries (heartbeat when entries empty)
MSG_APP_RESP = "app_resp"
MSG_SNAP = "snap"          # InstallSnapshot
MSG_TIMEOUT_NOW = "timeout_now"  # leadership transfer: campaign NOW

ENTRY_NORMAL = "normal"
ENTRY_CONF = "conf"        # data: serde{"op": "add"|"remove", "node": id}
ENTRY_SNAPSHOT = "snapshot"  # pseudo-entry surfacing an installed snapshot


@dataclass(frozen=True)
class Entry:
    term: int
    index: int
    data: bytes = b""
    kind: str = ENTRY_NORMAL
    # Consenter attribution: the proposing consenter's serialized
    # identity plus its signature over entry_signed_bytes().  Both empty
    # on legacy/unsigned entries — whether that is acceptable is the
    # cluster service's call (it only enforces on channels whose local
    # chain signs its own entries).
    proposer: bytes = b""
    sig: bytes = b""


def entry_signed_bytes(term: int, index: int, data: bytes,
                       kind: str) -> bytes:
    """Canonical byte string a consenter signs for one entry.  Covers
    (term, index, kind, data) — the full identity of a log slot — so the
    same signer producing two different payloads for one slot yields two
    valid signatures over DIFFERENT canonical bytes: a self-incriminating
    equivocation pair, attributable from the entries alone."""
    return (b"raft-ent\x00" + struct.pack("<QQ", term, index)
            + kind.encode("utf-8") + b"\x00" + data)


@dataclass(frozen=True)
class Snapshot:
    index: int
    term: int
    data: bytes          # application state at `index` (e.g. last block info)
    nodes: Tuple[int, ...]


@dataclass(frozen=True)
class Message:
    type: str
    frm: int
    to: int
    term: int
    index: int = 0       # prev_log_index for APP; candidate last index for VOTE
    log_term: int = 0    # prev_log_term for APP; candidate last term for VOTE
    entries: Tuple[Entry, ...] = ()
    commit: int = 0
    reject: bool = False
    hint: int = 0        # follower's suggested next_index on reject
    snapshot: Optional[Snapshot] = None


@dataclass
class Ready:
    """What the container must do after step/tick: persist happened
    already (storage is injected); send messages; apply entries."""
    messages: List[Message] = field(default_factory=list)
    committed: List[Entry] = field(default_factory=list)
    became_leader: bool = False
    lost_leadership: bool = False


# ---------------------------------------------------------------------------
# persistence


_REC = struct.Struct("<I")


class WAL:
    """Append-only log of hard-state + entry records (etcdraft's wal dir).

    Record = u32 length ‖ serde{kind: "hs"|"ent"|"trunc", ...}; a torn
    trailing record is dropped on replay (crash during append).
    `trunc` records mark logical truncation points (conflict overwrite or
    snapshot compaction) so replay reconstructs the exact final log.
    """

    def __init__(self, path: Optional[str]):
        self.path = path
        self._f = None
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "ab")

    def append(self, rec: dict) -> None:
        if self._f is None:
            return
        raw = serde.encode(rec)
        self._f.write(_REC.pack(len(raw)) + raw)

    def sync(self) -> None:
        if self._f is not None:
            self._f.flush()
            os.fsync(self._f.fileno())

    def rewrite(self, records: Sequence[dict]) -> None:
        """Atomically replace the WAL with `records` (post-compaction)."""
        if self.path is None:
            return
        self._f.close()
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            for rec in records:
                raw = serde.encode(rec)
                f.write(_REC.pack(len(raw)) + raw)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._f = open(self.path, "ab")

    @staticmethod
    def replay(path: str) -> List[dict]:
        recs = []
        if not os.path.exists(path):
            return recs
        with open(path, "rb") as f:
            raw = f.read()
        off = 0
        while off + _REC.size <= len(raw):
            (n,) = _REC.unpack_from(raw, off)
            if off + _REC.size + n > len(raw):
                break  # torn write
            try:
                recs.append(serde.decode(raw[off + _REC.size:off + _REC.size + n]))
            except ValueError:
                break
            off += _REC.size + n
        return recs

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class SnapshotFile:
    """Atomic snapshot persistence (etcdraft's snap dir)."""

    def __init__(self, path: Optional[str]):
        self.path = path

    def save(self, snap: Snapshot) -> None:
        if self.path is None:
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(serde.encode({
                "index": snap.index, "term": snap.term,
                "data": snap.data, "nodes": list(snap.nodes)}))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def load(self) -> Optional[Snapshot]:
        if self.path is None or not os.path.exists(self.path):
            return None
        with open(self.path, "rb") as f:
            d = serde.decode(f.read())
        return Snapshot(d["index"], d["term"], d["data"],
                        tuple(d["nodes"]))


# ---------------------------------------------------------------------------
# the node


class RaftNode:
    """One Raft participant.  Drive with tick()/step()/propose(), then
    drain `take_ready()` — messages in it are only handed out after the
    triggering state was persisted to the WAL."""

    def __init__(self, node_id: int, peers: Sequence[int],
                 wal_path: Optional[str] = None,
                 snap_path: Optional[str] = None,
                 election_tick: int = 10, heartbeat_tick: int = 1,
                 snapshot_interval: int = 0,
                 snapshot_data: Callable[[int], bytes] = lambda idx: b"",
                 entry_signer: Optional[
                     Callable[[int, int, bytes, str],
                              Tuple[bytes, bytes]]] = None):
        self.id = node_id
        # entry_signer(term, index, data, kind) -> (proposer, sig): signs
        # every locally-appended entry (client proposals, conf changes,
        # AND the new-leader no-op) with the consenter's identity
        self.entry_signer = entry_signer
        self.nodes: Tuple[int, ...] = tuple(sorted(set(peers) | {node_id}))
        self.election_tick = election_tick
        self.heartbeat_tick = heartbeat_tick
        self.snapshot_interval = snapshot_interval
        self.snapshot_data = snapshot_data

        self.term = 0
        self.voted_for: Optional[int] = None
        self.role = FOLLOWER
        self.leader_id: Optional[int] = None
        # log[i] has index snap_index + 1 + i
        self.log: List[Entry] = []
        self.snap_index = 0
        self.snap_term = 0
        self.snap_data = b""  # app state AT snap_index, fixed at compact time
        self.commit_index = 0
        self.applied_index = 0

        self._elapsed = 0
        self._timeout = self._rand_timeout()
        self._votes: Dict[int, bool] = {}
        self.next_index: Dict[int, int] = {}
        self.match_index: Dict[int, int] = {}
        self._ready = Ready()

        self._wal = WAL(wal_path)
        self._snapfile = SnapshotFile(snap_path)
        if wal_path is not None:
            self._recover(wal_path)

    # -- persistence --------------------------------------------------------

    def _recover(self, wal_path: str) -> None:
        snap = self._snapfile.load()
        if snap is not None:
            self.snap_index, self.snap_term = snap.index, snap.term
            self.snap_data = snap.data
            self.commit_index = self.applied_index = snap.index
            self.nodes = snap.nodes
        for rec in WAL.replay(wal_path):
            if rec["k"] == "hs":
                self.term, self.voted_for = rec["t"], rec.get("v")
            elif rec["k"] == "trunc":
                upto = rec["i"]  # keep entries with index < upto
                if upto <= self.snap_index:
                    self.log = []
                elif upto - self.snap_index - 1 < len(self.log):
                    self.log = self.log[:upto - self.snap_index - 1]
            elif rec["k"] == "ent":
                e = Entry(rec["t"], rec["i"], rec["d"], rec["kd"],
                          rec.get("pr", b""), rec.get("sg", b""))
                if e.index > self.snap_index:
                    # replayed entries are contiguous post-trunc
                    pos = e.index - self.snap_index - 1
                    self.log = self.log[:pos] + [e]
            elif rec["k"] == "commit":
                self.commit_index = max(self.commit_index, rec["i"])
        self.commit_index = min(self.commit_index, self.last_index())
        # committed-but-unapplied entries re-apply on restart (the app's
        # commit path must be idempotent, like kvledger recovery)

    def _persist_hard_state(self) -> None:
        self._wal.append({"k": "hs", "t": self.term, "v": self.voted_for})

    def _persist_entries(self, entries: Sequence[Entry]) -> None:
        for e in entries:
            rec = {"k": "ent", "t": e.term, "i": e.index,
                   "d": e.data, "kd": e.kind}
            if e.sig:
                rec["pr"], rec["sg"] = e.proposer, e.sig
            self._wal.append(rec)

    def _persist_commit(self) -> None:
        self._wal.append({"k": "commit", "i": self.commit_index})

    # -- log accessors -------------------------------------------------------

    def last_index(self) -> int:
        return self.snap_index + len(self.log)

    def _term_at(self, index: int) -> Optional[int]:
        if index == self.snap_index:
            return self.snap_term
        if index < self.snap_index or index > self.last_index():
            return None
        return self.log[index - self.snap_index - 1].term

    def _entries_from(self, index: int, max_n: int = 64) -> List[Entry]:
        start = index - self.snap_index - 1
        return self.log[start:start + max_n]

    # -- public API ----------------------------------------------------------

    def take_ready(self) -> Ready:
        self._wal.sync()  # nothing leaves the node before the WAL is durable
        r, self._ready = self._ready, Ready()
        # hand out committed-but-unapplied entries
        while self.applied_index < self.commit_index:
            self.applied_index += 1
            e = self.log[self.applied_index - self.snap_index - 1]
            if e.kind == ENTRY_CONF:
                self._apply_conf(e)
            r.committed.append(e)
        # messages minted while applying (the farewell append to a
        # removed consenter) must ride THIS ready: the application's
        # conf hook runs on r.committed and drops the removed node's
        # transport address — a later ready could no longer reach it
        if self._ready.messages:
            r.messages.extend(self._ready.messages)
            self._ready.messages = []
        return r

    def maybe_compact(self) -> None:
        """Periodic compaction.  Call AFTER the application has applied the
        entries from take_ready(), so snapshot_data(applied_index) reflects
        them (the etcdraft chain calls this from its run loop post-apply)."""
        if (self.snapshot_interval
                and self.applied_index - self.snap_index >= self.snapshot_interval):
            self.compact(self.applied_index)

    def _new_entry(self, data: bytes, kind: str = ENTRY_NORMAL) -> Entry:
        """Next local entry, signed by the consenter when a signer is
        configured (the only path that mints proposer/sig pairs)."""
        term, index = self.term, self.last_index() + 1
        if self.entry_signer is None:
            return Entry(term, index, data, kind)
        proposer, sig = self.entry_signer(term, index, data, kind)
        return Entry(term, index, data, kind, proposer, sig)

    def propose(self, data: bytes) -> int:
        """Leader-only: append + replicate. Returns the entry index."""
        if self.role != LEADER:
            raise NotLeaderError(self.leader_id)
        e = self._new_entry(data)
        self.log.append(e)
        self._persist_entries([e])
        self.match_index[self.id] = e.index
        self._broadcast_append()
        self._maybe_commit()  # single-node cluster commits immediately
        return e.index

    def propose_conf(self, op: str, node: int, **meta) -> int:
        """Single-server membership change through the log itself.
        Extra keyword payload (host/port/mspid/cert_fp for an added
        consenter) rides inside the entry so every replica — including
        ones that restart and re-apply — learns the full transport +
        identity binding from the SAME committed record; _apply_conf
        only reads op/node, so old replicas ignore the extras."""
        if self.role != LEADER:
            raise NotLeaderError(self.leader_id)
        data = serde.encode({"op": op, "node": node, **meta})
        e = self._new_entry(data, ENTRY_CONF)
        self.log.append(e)
        self._persist_entries([e])
        self.match_index[self.id] = e.index
        self._broadcast_append()
        self._maybe_commit()
        return e.index

    def transfer_leadership(self, to: int) -> bool:
        """Graceful handover (etcd/raft MsgTransferLeader): tell an
        up-to-date follower to campaign NOW.  Only fires when `to`'s
        match index is caught up to our last entry — transferring to a
        lagging follower would force an availability gap while it
        catches up.  Returns True when the order was sent; the caller
        polls role/leader_id for the outcome (the transferee's higher
        term deposes us via the normal vote path)."""
        if self.role != LEADER or to == self.id or to not in self.nodes:
            return False
        if self.match_index.get(to, 0) < self.last_index():
            self._send_append(to)   # nudge replication along
            return False
        self._send(Message(MSG_TIMEOUT_NOW, self.id, to, self.term))
        return True

    def tick(self) -> None:
        self._elapsed += 1
        if self.role == LEADER:
            if self._elapsed >= self.heartbeat_tick:
                self._elapsed = 0
                self._broadcast_append()
        elif self._elapsed >= self._timeout:
            self._campaign()

    def step(self, m: Message) -> None:
        if m.term > self.term:
            self._become_follower(m.term,
                                  m.frm if m.type == MSG_APP
                                  or m.type == MSG_SNAP else None)
        if m.term < self.term:
            # stale sender: tell it about the newer term
            if m.type in (MSG_VOTE, MSG_APP, MSG_SNAP):
                self._send(Message(MSG_APP_RESP, self.id, m.frm, self.term,
                                   reject=True))
            return
        handler = {MSG_VOTE: self._on_vote,
                   MSG_VOTE_RESP: self._on_vote_resp,
                   MSG_APP: self._on_append,
                   MSG_APP_RESP: self._on_append_resp,
                   MSG_SNAP: self._on_snapshot,
                   MSG_TIMEOUT_NOW: self._on_timeout_now}[m.type]
        handler(m)

    def _on_timeout_now(self, m: Message) -> None:
        """Leadership-transfer order from the current leader: campaign
        immediately, without waiting out the election timeout.  The
        up-to-date check in _campaign's voters still applies, so a
        stale transferee cannot steal the log."""
        if m.frm != self.leader_id or self.role == LEADER:
            return
        self._campaign()

    def compact(self, index: int) -> None:
        """Take a snapshot at `index` and drop the log prefix."""
        if index <= self.snap_index:
            return
        term = self._term_at(index)
        snap = Snapshot(index, term, self.snapshot_data(index), self.nodes)
        self._snapfile.save(snap)
        self.log = self.log[index - self.snap_index:]
        self.snap_index, self.snap_term = index, term
        self.snap_data = snap.data
        # rewrite the WAL: replay after compaction is O(post-snapshot log),
        # not O(all history) — etcd's segment-release equivalent
        self._wal.rewrite(self._wal_records())

    def _wal_records(self) -> List[dict]:
        recs = [{"k": "hs", "t": self.term, "v": self.voted_for}]
        for e in self.log:
            rec = {"k": "ent", "t": e.term, "i": e.index, "d": e.data,
                   "kd": e.kind}
            if e.sig:
                rec["pr"], rec["sg"] = e.proposer, e.sig
            recs.append(rec)
        recs.append({"k": "commit", "i": self.commit_index})
        return recs

    # -- roles ---------------------------------------------------------------

    def _rand_timeout(self) -> int:
        # deterministic per (id, term): reproducible tests, no tie storms
        return self.election_tick + \
            random.Random(f"{self.id}:{self.term}").randint(0, self.election_tick)

    def _become_follower(self, term: int, leader: Optional[int]) -> None:
        lost = self.role == LEADER
        self.role = FOLLOWER
        if term != self.term:
            self.voted_for = None  # a vote binds to its term (Raft §5.2)
        self.term = term
        self.leader_id = leader
        self._elapsed = 0
        self._timeout = self._rand_timeout()
        self._persist_hard_state()
        if lost:
            self._ready.lost_leadership = True

    def _campaign(self) -> None:
        if self.id not in self.nodes:
            return  # removed from membership
        self.role = CANDIDATE
        self.term += 1
        self.voted_for = self.id
        self.leader_id = None
        self._votes = {self.id: True}
        self._elapsed = 0
        self._timeout = self._rand_timeout()
        self._persist_hard_state()
        if self._quorum(sum(self._votes.values())):
            self._become_leader()  # single-node cluster
            return
        for n in self.nodes:
            if n != self.id:
                self._send(Message(MSG_VOTE, self.id, n, self.term,
                                   index=self.last_index(),
                                   log_term=self._term_at(self.last_index()) or 0))

    def _become_leader(self) -> None:
        self.role = LEADER
        self.leader_id = self.id
        self._elapsed = 0
        self.next_index = {n: self.last_index() + 1 for n in self.nodes}
        self.match_index = {n: 0 for n in self.nodes}
        self._ready.became_leader = True
        # Append an empty entry for the new term (etcd/raft becomeLeader):
        # without it, the §5.4.2 current-term commit guard in _maybe_commit
        # would leave a deposed leader's replicated entries uncommitted
        # until new client traffic arrives — stalling idle channels.
        e = self._new_entry(b"")
        self.log.append(e)
        self._persist_entries([e])
        self.match_index[self.id] = e.index
        self._broadcast_append()
        self._maybe_commit()  # single-node cluster commits immediately

    def _quorum(self, count: int) -> bool:
        return count > len(self.nodes) // 2

    # -- vote handling -------------------------------------------------------

    def _on_vote(self, m: Message) -> None:
        my_last_term = self._term_at(self.last_index()) or 0
        up_to_date = (m.log_term, m.index) >= (my_last_term, self.last_index())
        grant = up_to_date and self.voted_for in (None, m.frm) \
            and self.role == FOLLOWER
        if grant:
            self.voted_for = m.frm
            self._elapsed = 0
            self._persist_hard_state()
        self._send(Message(MSG_VOTE_RESP, self.id, m.frm, self.term,
                           reject=not grant))

    def _on_vote_resp(self, m: Message) -> None:
        if self.role != CANDIDATE:
            return
        self._votes[m.frm] = not m.reject
        if self._quorum(sum(self._votes.values())):
            self._become_leader()

    # -- replication ---------------------------------------------------------

    def _broadcast_append(self) -> None:
        for n in self.nodes:
            if n != self.id:
                self._send_append(n)

    def _send_append(self, to: int) -> None:
        next_idx = self.next_index.get(to, self.last_index() + 1)
        if next_idx <= self.snap_index:
            # follower is behind the compacted prefix: install the snapshot
            # fixed at compact time (NOT re-derived from current app state)
            snap = Snapshot(self.snap_index, self.snap_term,
                            self.snap_data, self.nodes)
            self._send(Message(MSG_SNAP, self.id, to, self.term,
                               snapshot=snap))
            return
        prev = next_idx - 1
        self._send(Message(
            MSG_APP, self.id, to, self.term, index=prev,
            log_term=self._term_at(prev) or 0,
            entries=tuple(self._entries_from(next_idx)),
            commit=self.commit_index))

    def _on_append(self, m: Message) -> None:
        self._elapsed = 0
        self.leader_id = m.frm
        if self.role != FOLLOWER:
            self._become_follower(m.term, m.frm)
        prev_term = self._term_at(m.index)
        if prev_term is None or prev_term != m.log_term:
            # conflict: hint leader to back up to our last plausible index
            hint = min(m.index, self.last_index())
            # skip back over our conflicting term in one step
            while hint > self.commit_index and \
                    (self._term_at(hint) or 0) != m.log_term:
                hint -= 1
            self._send(Message(MSG_APP_RESP, self.id, m.frm, self.term,
                               index=m.index, reject=True,
                               hint=max(hint, self.commit_index)))
            return
        # append, truncating conflicts
        new_entries = []
        for e in m.entries:
            existing = self._term_at(e.index)
            if existing is None:
                new_entries.append(e)
            elif existing != e.term:
                # conflict: truncate from here, keep the leader's entries
                self.log = self.log[:e.index - self.snap_index - 1]
                self._wal.append({"k": "trunc", "i": e.index})
                new_entries.append(e)
        for e in new_entries:
            self.log.append(e)
        if new_entries:
            self._persist_entries(new_entries)
        last_new = m.index + len(m.entries)
        # clamp BOTH ways: never past what this message proves replicated,
        # never backwards on duplicated/reordered deliveries
        new_commit = max(self.commit_index,
                         min(m.commit, last_new, self.last_index()))
        if new_commit != self.commit_index:
            self.commit_index = new_commit
            self._persist_commit()
        self._send(Message(MSG_APP_RESP, self.id, m.frm, self.term,
                           index=last_new))

    def _on_append_resp(self, m: Message) -> None:
        if self.role != LEADER:
            return
        if m.reject:
            self.next_index[m.frm] = max(1, min(
                m.hint + 1, self.next_index.get(m.frm, 1) - 1))
            self._send_append(m.frm)
            return
        if m.index > self.match_index.get(m.frm, 0):
            self.match_index[m.frm] = m.index
        self.next_index[m.frm] = m.index + 1
        self._maybe_commit()
        if self.next_index[m.frm] <= self.last_index():
            self._send_append(m.frm)  # keep streaming the backlog

    def _maybe_commit(self) -> None:
        for idx in range(self.last_index(), self.commit_index, -1):
            if (self._term_at(idx) == self.term and
                    self._quorum(sum(1 for n in self.nodes
                                     if self.match_index.get(n, 0) >= idx))):
                self.commit_index = idx
                self._persist_commit()
                self._broadcast_append()  # propagate the new commit index
                break

    # -- snapshot install ----------------------------------------------------

    def _on_snapshot(self, m: Message) -> None:
        self._elapsed = 0
        self.leader_id = m.frm
        snap = m.snapshot
        if snap.index <= self.commit_index:
            self._send(Message(MSG_APP_RESP, self.id, m.frm, self.term,
                               index=self.commit_index))
            return
        self.log = []
        self.snap_index, self.snap_term = snap.index, snap.term
        self.snap_data = snap.data
        self.commit_index = self.applied_index = snap.index
        self.nodes = snap.nodes
        self._snapfile.save(snap)
        self._wal.append({"k": "trunc", "i": snap.index + 1})
        # surface the snapshot to the application as a pseudo-entry so the
        # container can restore app state (etcdraft chain.go catch-up path)
        self._ready.committed.append(
            Entry(snap.term, snap.index, snap.data, ENTRY_SNAPSHOT))
        self._send(Message(MSG_APP_RESP, self.id, m.frm, self.term,
                           index=snap.index))

    # -- membership ----------------------------------------------------------

    def _apply_conf(self, e: Entry) -> None:
        d = serde.decode(e.data)
        nodes = set(self.nodes)
        if d["op"] == "add":
            nodes.add(d["node"])
        elif d["op"] == "remove":
            nodes.discard(d["node"])
        self.nodes = tuple(sorted(nodes))
        if self.role == LEADER:
            for n in self.nodes:
                self.next_index.setdefault(n, self.last_index() + 1)
                self.match_index.setdefault(n, 0)
            if self.id not in self.nodes:
                self._become_follower(self.term, None)  # self-eviction
            elif d["op"] == "remove" and d["node"] != self.id:
                # farewell append: replication to the removed server
                # stops the instant its removal commits, so without one
                # last append carrying the new commit index it never
                # learns it was removed and can never self-evict (the
                # classic removed-server problem)
                self._send_append(int(d["node"]))

    # -- plumbing ------------------------------------------------------------

    def _send(self, m: Message) -> None:
        self._ready.messages.append(m)

    def close(self) -> None:
        self._wal.sync()
        self._wal.close()


class NotLeaderError(Exception):
    def __init__(self, leader_id: Optional[int]):
        super().__init__(f"not leader (leader={leader_id})")
        self.leader_id = leader_id
