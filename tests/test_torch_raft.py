"""The port's Raft core (fabric_tpu_torch.orderer.raft `RaftNode`, its
`WAL` and `SnapshotFile`; consensus `RaftChain`, `make_entry_signer`;
cluster `EntryVerifier`, `msg_to_dict` / `msg_from_dict`) against the
reference's, on the CPU.

* The reference's own scenarios on the port: every test function of
  tests/test_raft.py and tests/test_signed_entries.py
  (tests/ref_scenarios.py), all on SW.
* Disk formats: each package's `RaftNode` takes the same proposals on
  the same cluster (entries unsigned, `entry_signer=None`, so nothing
  random lands on disk), compacting into a snapshot; the two packages'
  `wal.bin` and `snap.bin` are byte-identical, and each package's node
  recovers the other's files to the same hard state, snapshot and log.
* Wire: a three-node cluster of two reference nodes and one port node
  whose messages cross as the cluster transport sends them
  (`msg_to_dict`, then `serde.encode` on the sender's side, the
  receiver's `serde.decode` and `msg_from_dict`), every entry signed by
  its proposer's package (`make_entry_signer`) and checked by the
  receiver's package (`EntryVerifier`): it elects a leader, and with the
  leader in either package every node ends with the same log, entry for
  entry (term, index, kind, data, proposer, signature) and the same
  committed payloads.

Tolerance: exact equality.
"""

import pytest

from node_world import mod, sw_defaults
from ref_scenarios import run_scenario, scenario_module, scenario_names

REF_FILES = ("test_raft", "test_signed_entries")
RUNS = [(f, t) for f in REF_FILES for t in scenario_names(f)]
SIDES = ("ref", "port")


@pytest.fixture(scope="module", autouse=True)
def _sw():
    """Identities hash and verify through each package's default: SW."""
    sw_defaults()


@pytest.mark.parametrize("case,name", RUNS,
                         ids=[f"{f}::{t}" for f, t in RUNS])
def test_reference_scenario(case, name, request):
    run_scenario(scenario_module(case, "fabric_tpu_torch"), name, request)


def _drive(raft, nodes, proposals):
    """Elect node 1 (the only one whose clock runs), then propose each
    payload on it and route messages until quiet; compact after every
    apply, as the chain's run loop does."""
    by_id = {n.id: n for n in nodes}
    leader = by_id[1]

    def pump():
        for _ in range(200):
            msgs = []
            for n in nodes:
                msgs.extend(n.take_ready().messages)
                n.maybe_compact()
            if not msgs:
                return
            for m in msgs:
                by_id[m.to].step(m)

    for _ in range(100):
        leader.tick()
        pump()
        if leader.role == raft.LEADER:
            break
    assert leader.role == raft.LEADER
    for p in proposals:
        leader.propose(p)
        pump()
    return leader


def _state(node):
    return (node.term, node.voted_for, node.commit_index, node.snap_index,
            node.snap_term, node.snap_data, node.nodes,
            [(e.term, e.index, e.data, e.kind, e.proposer, e.sig)
             for e in node.log])


def test_wal_and_snapshot_files_cross_replay(tmp_path):
    """Both packages write the same bytes, and each replays the other's."""
    proposals = [b"tx-%02d" % i for i in range(23)]
    files, states = {}, {}
    for side in SIDES:
        raft = mod(side, "orderer.raft")
        d = tmp_path / side
        nodes = [raft.RaftNode(
            i, [1, 2, 3], wal_path=str(d / f"wal-{i}.bin"),
            snap_path=str(d / f"snap-{i}.bin"), snapshot_interval=8,
            snapshot_data=lambda idx: b"app@%d" % idx)
            for i in (1, 2, 3)]
        _drive(raft, nodes, proposals)
        states[side] = [_state(n) for n in nodes]
        for n in nodes:
            n.close()
        files[side] = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
    assert sorted(files["ref"]) == [f"{k}-{i}.bin" for k in ("snap", "wal")
                                    for i in (1, 2, 3)]
    assert files["ref"] == files["port"]
    assert states["ref"] == states["port"]
    assert all(s[3] > 0 for s in states["ref"])      # a snapshot was taken
    # each package recovers the files the other wrote
    for writer, reader in (("ref", "port"), ("port", "ref")):
        raft = mod(reader, "orderer.raft")
        d = tmp_path / writer
        for i in (1, 2, 3):
            node = raft.RaftNode(i, [1, 2, 3],
                                 wal_path=str(d / f"wal-{i}.bin"),
                                 snap_path=str(d / f"snap-{i}.bin"))
            assert _state(node)[:2] == states[writer][i - 1][:2]
            assert _state(node)[3:] == states[writer][i - 1][3:]
            assert node.commit_index == node.last_index()
            node.close()
        assert raft.WAL.replay(str(d / "wal-1.bin")) == \
            mod(writer, "orderer.raft").WAL.replay(str(d / "wal-1.bin"))
        snap = raft.SnapshotFile(str(d / "snap-1.bin")).load()
        assert (snap.index, snap.term, snap.data, snap.nodes) == \
            states[writer][0][3:7]


@pytest.fixture(scope="module")
def consenters():
    """Three orderer identities of one `DevOrg` (P-256, as provisioned
    orderers are), each held by both packages, with each package's
    MSPs."""
    from intake_world import load, msps_for, signer_for
    org = mod("ref", "msp.ca").DevOrg("OrdererOrg")
    idents = [org.new_identity(f"osn{i}") for i in (1, 2, 3)]
    out = {}
    for side in SIDES:
        ns = load(side)
        out[side] = {"msps": msps_for(ns, [org]),
                     "signers": [signer_for(ns, i) for i in idents]}
    return out


@pytest.mark.parametrize("lead", SIDES)
def test_mixed_package_cluster_elects_and_replicates(lead, consenters):
    """Nodes 1 and 2 are the reference's, node 3 the port's; `lead`
    names the package whose node is elected and proposes."""
    pkg_of = {1: "ref", 2: "ref", 3: "port"}
    leader_id = 3 if lead == "port" else 1
    fp = mod("ref", "orderer.cluster").cert_fingerprint
    binding = {i: (consenters["ref"]["signers"][i - 1].mspid,
                   fp(consenters["ref"]["signers"][i - 1].cert))
               for i in (1, 2, 3)}
    nodes, verifiers = {}, {}
    for i, side in pkg_of.items():
        signer = consenters[side]["signers"][i - 1]
        nodes[i] = mod(side, "orderer.raft").RaftNode(
            i, [1, 2, 3], entry_signer=mod(
                side, "orderer.consensus").make_entry_signer(signer))
        verifiers[i] = mod(side, "orderer.cluster").EntryVerifier(
            "ch", consenters[side]["msps"], binding)
    committed = {i: [] for i in nodes}
    checked = {i: 0 for i in nodes}

    def carry(m):
        src, dst = pkg_of[m.frm], pkg_of[m.to]
        raw = mod(src, "utils.serde").encode(
            {"channel": "ch",
             "msg": mod(src, "orderer.cluster").msg_to_dict(m)})
        body = mod(dst, "utils.serde").decode(raw)
        msg = mod(dst, "orderer.cluster").msg_from_dict(body["msg"])
        if msg.entries:
            ok, reason, crimes = verifiers[m.to].check(msg.entries)
            assert ok and not crimes, reason
            checked[m.to] += len(msg.entries)
        nodes[m.to].step(msg)

    def pump():
        for _ in range(200):
            msgs = []
            for i, n in nodes.items():
                r = n.take_ready()
                committed[i].extend(e.data for e in r.committed
                                    if e.kind == "normal" and e.data)
                msgs.extend(r.messages)
            if not msgs:
                return
            for m in msgs:
                carry(m)

    leader = nodes[leader_id]
    for _ in range(100):
        leader.tick()
        pump()
        if leader.role == "leader":
            break
    assert leader.role == "leader"
    assert {n.leader_id for n in nodes.values()} == {leader_id}
    payloads = [b"%s-%d" % (lead.encode(), i) for i in range(12)]
    for p in payloads:
        leader.propose(p)
        pump()
    for _ in range(3):                      # heartbeats carry the commit
        leader.tick()
        pump()
    logs = {i: [(e.term, e.index, e.kind, e.data, e.proposer, e.sig)
                for e in n.log] for i, n in nodes.items()}
    assert logs[1] == logs[2] == logs[3]
    assert len(logs[1]) == len(payloads) + 1           # + the leader no-op
    assert {e[4] for e in logs[1]} == {
        consenters[lead]["signers"][leader_id - 1].serialize()}
    assert committed[1] == committed[2] == committed[3] == payloads
    assert all(n.commit_index == len(payloads) + 1 for n in nodes.values())
    assert all(checked[i] > 0 for i in nodes if i != leader_id)
