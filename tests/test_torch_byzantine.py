"""The port's byzantine plane (fabric_tpu_torch.byzantine: the witness
log, the quarantine registry, the monitor with its fraud proofs and
pardons, ProofGossip, the ops view; and orderer/raft.py's
`entry_signed_bytes` and orderer/cluster.py's `cert_fingerprint`, which
it reads) against the reference's, on the CPU.

* The reference's own scenarios on both packages: every test function
  of tests/test_byzantine.py (the `node.top` BYZ column on each
  package's own `node.top`) and tests/test_proof_gossip.py (tests/ref_scenarios.py;
  each package's own `testing.adversary` forgeries on its types).
* Differentials, with one fixed clock patched into both packages'
  `monitor` and `quarantine` modules, and the accusers and pardon
  issuers Ed25519 peers (their signatures are deterministic), so files
  and records can be compared byte for byte:
  - a scripted run of a monitor per package over the same signed
    blocks (built once, parsed by each package): verdicts, the witness
    and quarantine files, the fraud-proof files, equal;
  - proofs and pardons built by either package re-verify strictly in
    the other (`verify_fraud_proof_strict`, `verify_pardon_strict`);
  - tamper, replay, an unknown accuser, crash-stop accusations and
    unprovable reasons: the same verdicts; pardons, score decay and a
    reload after a restart: the same standing and files;
  - the Raft-entry equivocation pair through the port's
    `orderer/raft.py` (`entry_signed_bytes`) and `cluster.py`
    (`cert_fingerprint`), and its malformed variants;
  - the port's `gossip/state.py` monitor branches (garbage and bad
    signature offenses, a quarantined source refused, a stale copy, a
    fork convicted, the drain's `check_commit` eviction) and
    `gossip/node.py`'s fraud-proof dispatch to `ProofGossip` (broadcast,
    conviction on the other peer, the relay, the duplicate), on two
    gossip nodes per package over an in-process network.

Tolerance: exact equality.
"""
import json
import os
import types

import pytest

from fabric_tpu.bccsp import SCHEME_ED25519
from fabric_tpu.msp.ca import DevOrg

from intake_world import load, msps_for, signer_for
from ref_scenarios import PKGS, run_scenario, scenario_module, scenario_names

REF_FILES = ("test_byzantine", "test_proof_gossip")
RUNS = [(f, t, p) for f in REF_FILES for t in scenario_names(f)
        for p in PKGS]
SIDES = ("ref", "port")
T0 = 1_760_000_000.0


@pytest.mark.parametrize("case,name,pkg", RUNS,
                         ids=[f"{f}::{t}-{p}" for f, t, p in RUNS])
def test_reference_scenario(case, name, pkg, request):
    run_scenario(scenario_module(case, pkg), name, request)


# ---------------------------------------------------------------------------
# the shared world
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    """Identities minted once: an orderer org (P-256, three consenters)
    and a peer org (Ed25519, two peers, the accusers); both packages'
    modules, MSPs and SW providers."""
    pk = {side: load(side) for side in SIDES}
    for P in pk.values():
        P.factory.init_factories(P.factory.FactoryOpts(default="SW"))
    ord_org = DevOrg("OrdererOrg")
    peer_org = DevOrg("PeerOrg", scheme=SCHEME_ED25519)
    orgs = (ord_org, peer_org)
    return types.SimpleNamespace(
        pk=pk, orgs=orgs,
        osns=[ord_org.new_identity(f"osn{i}") for i in range(3)],
        peers=[peer_org.new_identity(f"peer{i}") for i in range(2)],
        outsider=DevOrg("Outsiders", scheme=SCHEME_ED25519)
        .new_identity("notary"),
        msps={side: msps_for(P, orgs) for side, P in pk.items()})


@pytest.fixture()
def clock(world, monkeypatch):
    """One settable clock in both packages' monitor and quarantine
    modules."""
    now = [T0]
    fake = types.SimpleNamespace(time=lambda: now[0])
    for P in world.pk.values():
        monkeypatch.setattr(P.monitor, "time", fake)
        monkeypatch.setattr(P.quarantine, "time", fake)
    return now


def ref_helpers():
    return scenario_module("test_byzantine", "fabric_tpu")


def signed_raw(num, prev, data, signer) -> bytes:
    """A block signed the block writer's way, built once (the
    reference's), as bytes each package parses."""
    return ref_helpers()._signed_block(num, prev, data, signer).serialize()


def parse(P, raw):
    return P.protocol.Block.deserialize(raw)


def binding(P, signer) -> str:
    return f"{signer.mspid}|{P.cluster.cert_fingerprint(signer.cert)}"


class LedgerStub:
    """What the monitor needs of a ledger: height + blockstore lookup."""

    def __init__(self, blocks=None):
        self.blocks = dict(blocks or {})

    @property
    def height(self):
        return max(self.blocks) + 1 if self.blocks else 0

    @property
    def blockstore(self):
        return self

    def get_by_number(self, num):
        return self.blocks[num]


def monitor(P, world, side, root, ledger=None, signer=0, **kw):
    q = P.quarantine.QuarantineRegistry(str(root / "q.json"),
                                        score_threshold=kw.pop("threshold",
                                                               3))
    w = P.witness.WitnessLog(str(root / "w.json"))
    mon = P.monitor.ByzantineMonitor(
        "ch", w, q, ledger=ledger, msps=world.msps[side],
        signer=signer_for(P, world.peers[signer]),
        proof_dir=str(root / "proofs"), **kw)
    return mon, q, w


def files(root) -> dict:
    out = {}
    for dirpath, _dirs, names in os.walk(root):
        for n in sorted(names):
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


# ---------------------------------------------------------------------------
# a monitor run, files byte for byte
# ---------------------------------------------------------------------------

def monitor_run(P, world, side, root, raws, clock) -> list:
    ledger = LedgerStub({0: parse(P, raws["b0"])})
    mon, q, w = monitor(P, world, side, root, ledger=ledger)
    fired = []
    mon.on_proof = fired.append
    out = []
    for step, (name, src) in enumerate((
            ("b0", "gossip|p:1"),            # committed copy: stale
            ("fork0", "gossip|p:1"),         # off the committed chain
            ("a3", "deliver|o1"), ("b3", "deliver|o1"),   # equivocation
            ("a3_osn2", "deliver|o2"),       # a live signer resolves it
            ("x4_0", "s1"), ("x4_2", "s3"), ("x4_1", "s2"))):  # quorum
        clock[0] = T0 + step
        out.append((name, mon.check_block(parse(P, raws[name]), src)))
    out.append(("commit", [mon.check_commit(parse(P, raws[n]))
                           for n in ("a3", "b3", "x4_0", "x4_2")]))
    clock[0] = T0 + 100
    for _ in range(3):
        q.offense("gossip|evil:0", "garbage")
    mon.convict_external("OrdererOrg|feedface", "tampered_attestation",
                         {"block": 4})
    w.flush()
    out.append(("proofs", len(mon.proofs), len(fired),
                [p["reason"] for p in mon.proofs]))
    out.append(("snapshot", mon.snapshot(), q.snapshot(), q.reasons()))
    out.append(("view", P.byzops.byzantine_view(q, {"ch": mon})))
    return out


@pytest.fixture(scope="module")
def raws(world):
    from fabric_tpu.testing.adversary import forge_sibling
    osn = world.osns
    b0 = signed_raw(0, b"\x00" * 32, [b"tx"], osn[0])
    return {
        "b0": b0,
        "fork0": forge_sibling(parse(world.pk["ref"], b0),
                               osn[1]).serialize(),
        "a3": signed_raw(3, b"\x01" * 32, [b"tx"], osn[1]),
        "b3": signed_raw(3, b"\x01" * 32, [b"tx", b"tx"], osn[1]),
        "a3_osn2": signed_raw(3, b"\x01" * 32, [b"tx"], osn[2]),
        "x4_0": signed_raw(4, b"\x02" * 32, [b"x"], osn[0]),
        "x4_1": signed_raw(4, b"\x02" * 32, [b"x"], osn[2]),
        "x4_2": signed_raw(4, b"\x02" * 32, [b"x", b"y"], osn[0]),
    }


def test_monitor_runs_and_files_equal(world, raws, clock, tmp_path):
    got, trees = {}, {}
    for side in SIDES:
        root = tmp_path / side
        root.mkdir()
        got[side] = monitor_run(world.pk[side], world, side, root, raws,
                                clock)
        trees[side] = files(root)
    assert got["port"] == got["ref"]
    assert trees["port"] == trees["ref"]
    verdicts = dict(r[:2] for r in got["port"][:8])
    # fork0 convicts osn1 (fork), so its lone a3 is held; b3 is its
    # equivocation (held), a live osn2 confirms a3's hash; osn0 signs
    # two headers at 4 (convicted, held) and osn2 confirms x4_0's
    assert verdicts == {"b0": "stale", "fork0": "reject", "a3": "hold",
                        "b3": "hold", "a3_osn2": "admit", "x4_0": "admit",
                        "x4_2": "hold", "x4_1": "admit"}
    assert sorted(trees["port"]) == [
        "proofs/fraud_00000.json", "proofs/fraud_00001.json",
        "proofs/fraud_00002.json", "q.json", "w.json"]
    assert got["port"][9] == ("proofs", 3, 3, ["fork", "equivocation",
                                               "tampered_attestation"])


# ---------------------------------------------------------------------------
# proofs and pardons across the packages
# ---------------------------------------------------------------------------

_BLOCKS: dict = {}


def signed_once(key, *args) -> bytes:
    """signed_raw(*args), made once a key (a P-256 signature differs
    from call to call), so both packages build from the same blocks."""
    if key not in _BLOCKS:
        _BLOCKS[key] = signed_raw(*args)
    return _BLOCKS[key]


def equivocation_proof(P, world, height=5, accuser=None, reason=None):
    """A genuine equivocation pair by osn1, accused and built by package
    P."""
    evil = world.osns[1]
    a = parse(P, signed_once(("a", height), height, b"\x01" * 32,
                             [b"tx-a"], evil))
    b = parse(P, signed_once(("b", height), height, b"\x01" * 32,
                             [b"tx-a", b"tx-a"], evil))
    M = P.monitor
    signer = accuser if accuser is not None else world.peers[0]
    return M.build_fraud_proof(
        "ch", height, binding(P, evil), reason or "equivocation",
        {"attested": M._incriminating_sigs(a) + M._incriminating_sigs(b)},
        signer_for(P, signer))


def fork_proof(P, world):
    evil = world.osns[1]
    forged = parse(P, signed_once("forged", 3, b"\x02" * 32,
                                  [b"tx-h", b"tx-h"], evil))
    return P.monitor.build_fraud_proof(
        "ch", 3, binding(P, evil), "fork",
        {"attested": P.monitor._incriminating_sigs(forged)},
        signer_for(P, world.peers[0]))


def proofs_by(P, world) -> dict:
    """Every proof kind package P builds, and its tampered variants."""
    good = equivocation_proof(P, world)
    cooked = json.loads(json.dumps(good))
    ent = cooked["evidence"]["attested"][0]
    ent["signature"] = ("00" if ent["signature"][:2] != "00"
                        else "ff") + ent["signature"][2:]
    M = P.monitor
    dead = binding(P, world.osns[2])
    return {
        "pair": good,
        "framed": dict(good, accused=binding(P, world.osns[2])),
        "emptied": dict(good, evidence={"attested": []}),
        "cooked": M.build_fraud_proof(
            "ch", cooked["height"], cooked["accused"], cooked["reason"],
            cooked["evidence"], signer_for(P, world.peers[0])),
        "outsider": equivocation_proof(P, world, accuser=world.outsider),
        "crash_stop": M.build_fraud_proof(
            "ch", 4, dead, "equivocation",
            {"attested": [], "note": "stopped answering"},
            signer_for(P, world.peers[0])),
        "unprovable": M.build_fraud_proof(
            "ch", 4, dead, "stale", {"attested": []},
            signer_for(P, world.peers[0])),
        "fork": fork_proof(P, world),
        "pardon": M.build_pardon("ch", "Org9|cafe", "poison", 5.0, 0.0,
                                 signer_for(P, world.peers[1])),
        "pardon_crime": M.build_pardon(
            "ch", dead, "equivocation", 5.0, 0.0,
            signer_for(P, world.peers[1])),
    }


def test_proofs_verify_strictly_across_packages(world, clock):
    honest = signed_once("honest", 3, b"\x02" * 32, [b"tx-h"],
                         world.osns[0])
    built = {side: proofs_by(world.pk[side], world) for side in SIDES}
    # the same records, byte for byte (fixed clock, Ed25519 accusers)
    assert json.dumps(built["port"], sort_keys=True) == \
        json.dumps(built["ref"], sort_keys=True)
    verdicts = {}
    for by in SIDES:
        for on in SIDES:
            P = world.pk[on]
            led = LedgerStub({n: parse(P, honest) for n in range(4)})
            row = {}
            for name, rec in built[by].items():
                rec = json.loads(json.dumps(rec))   # the wire's round trip
                if name.startswith("pardon"):
                    row[name] = P.monitor.verify_pardon_strict(
                        rec, world.msps[on])
                else:
                    row[name] = (P.monitor.verify_fraud_proof_strict(
                        rec, world.msps[on]),
                        P.monitor.verify_fraud_proof_strict(
                            rec, world.msps[on], ledger=led))
            verdicts[(by, on)] = row
    want = verdicts[("ref", "ref")]
    assert all(v == want for v in verdicts.values())
    assert want["pair"][0] == (True, "equivocation_pair")
    assert want["framed"][0][0] is False and want["cooked"][0][0] is False
    assert want["emptied"][0] == want["outsider"][0] == (
        False, "bad_accuser_sig")
    assert want["crash_stop"][0] == (False,
                                     "no_self_incriminating_signature")
    assert want["unprovable"][0] == (False, "unprovable_reason")
    assert want["fork"] == ((False, "unverifiable_single_header"),
                            (True, "fork_vs_local_chain"))
    assert want["pardon"] == (True, "verified")
    assert want["pardon_crime"] == (False, "crime_never_decays")


def remote_run(P, world, side, root, built) -> list:
    """accept_remote_proof / _pardon verdicts on one monitor, in order:
    rejections, a deferred fork proof convicting once the chain holds a
    conflicting block, a conviction, its replay, a pardon."""
    led = LedgerStub()
    mon, q, _ = monitor(P, world, side, root, ledger=led, threshold=1)
    fired = []
    mon.on_proof = fired.append
    out = []
    for name in ("framed", "emptied", "cooked", "outsider", "crash_stop",
                 "unprovable", "fork", "pair", "pair"):
        out.append((name, mon.accept_remote_proof(
            json.loads(json.dumps(built[name])), relay="peerX")))
    honest = signed_once("honest", 3, b"\x02" * 32, [b"tx-h"],
                         world.osns[0])
    led.blocks = {n: parse(P, honest) for n in range(4)}
    mon.on_committed(4)
    q.offense("Org9|cafe", "garbage")
    for name in ("pardon_crime", "pardon", "pardon"):
        out.append((name, mon.accept_remote_pardon(
            json.loads(json.dumps(built[name])))))
    out.append(("fired", [p["accused"] for p in fired]))
    out.append(("state", q.snapshot(), mon.snapshot(), len(mon.pardons)))
    return out


def test_remote_verdicts_equal(world, clock, tmp_path):
    built = proofs_by(world.pk["ref"], world)
    got, trees = {}, {}
    for side in SIDES:
        root = tmp_path / side
        root.mkdir()
        got[side] = remote_run(world.pk[side], world, side, root, built)
        trees[side] = files(root)
    assert got["port"] == got["ref"]
    assert trees["port"] == trees["ref"]
    # "cooked" keeps one valid header of the pair and "fork" is one
    # header: both wait for the chain (deferred); "pair" convicts, its
    # replay is a duplicate; once the chain holds a conflicting block 3
    # the deferred fork proof finds osn1 already convicted
    assert [r[1] for r in got["port"][:9]] == [
        "rejected", "rejected", "deferred", "rejected", "rejected",
        "rejected", "deferred", "convicted", "duplicate"]
    assert [r[1] for r in got["port"][9:12]] == ["rejected", "pardoned",
                                                 "duplicate"]


def standing_run(P, world, side, root, clock) -> list:
    """Pardons after a clean window, score decay, crimes that never
    decay, and a restart over the same files."""
    mon, q, _ = monitor(P, world, side, root, threshold=2,
                        pardon_window_s=30.0)
    fired = []
    mon.on_pardon = fired.append
    crime = binding(P, world.osns[1])
    q.quarantine(crime, "equivocation")
    out = []
    for key in ("Org1|aa", "Org1|aa", "Org2|bb"):
        clock[0] += 1
        out.append(q.offense(key, "garbage_frame"))
    out.append([r["pardoned"] for r in mon.maybe_pardon()])
    clock[0] += 60
    mon.on_committed(5)
    out.append(([r["pardoned"] for r in fired], q.snapshot()))
    q2 = P.quarantine.QuarantineRegistry(str(root / "q.json"),
                                         score_threshold=2)
    mon2 = P.monitor.ByzantineMonitor(
        "ch", P.witness.WitnessLog(str(root / "w.json")), q2,
        msps=world.msps[side], signer=signer_for(P, world.peers[0]),
        proof_dir=str(root / "proofs"), pardon_window_s=30.0)
    q2.offense("Org1|aa", "garbage_frame")
    q2.offense("Org1|aa", "garbage_frame")
    clock[0] += 60
    out.append(([r["pardoned"] for r in mon2.maybe_pardon()],
                [p["pardoned"] for p in mon2.pardons], q2.pardon_count(),
                q2.is_quarantined(crime), q2.pardon(crime)))
    return out


def test_pardons_decay_and_reload_equal(world, clock, tmp_path):
    got, trees = {}, {}
    for side in SIDES:
        clock[0] = T0
        root = tmp_path / side
        root.mkdir()
        got[side] = standing_run(world.pk[side], world, side, root, clock)
        trees[side] = files(root)
    assert got["port"] == got["ref"]
    assert trees["port"] == trees["ref"]
    assert got["port"][3] == []
    assert got["port"][4][0] == ["Org1|aa"]
    assert got["port"][5][:2] == (["Org1|aa"], ["Org1|aa", "Org1|aa"])
    assert got["port"][5][3:] == (True, False)


# ---------------------------------------------------------------------------
# the Raft-entry equivocation pair (partial orderer/raft.py, cluster.py)
# ---------------------------------------------------------------------------

def entry_proof(P, world, mutate=None):
    osn = signer_for(P, world.osns[1])
    ev = {"kind": "raft_entry_equivocation",
          "proposer": osn.serialize().hex(), "term": 7, "index": 42}
    for side, data in (("a", b"block-A"), ("b", b"block-B")):
        kind = "normal"
        sig = osn.sign(P.raft.entry_signed_bytes(7, 42, data, kind))
        ev[side] = {"data": data.hex(), "entry_kind": kind,
                    "sig": sig.hex()}
    accused = binding(P, world.osns[1])
    if mutate is not None:
        accused = mutate(ev, accused)
    return P.monitor.build_fraud_proof(
        "ch", -1, accused, "equivocation", ev,
        signer_for(P, world.peers[0]))


def _same_payload(ev, accused):
    ev["b"] = dict(ev["a"])
    return accused


def _bad_sig(ev, accused):
    ev["b"]["sig"] = ev["a"]["sig"]
    return accused


def _other_accused(ev, accused):
    return accused[:-1] + ("0" if accused[-1] != "0" else "1")


def _unknown_proposer(ev, accused):
    ev["proposer"] = "00" + ev["proposer"]
    return accused


def _malformed(ev, accused):
    del ev["term"]
    return accused


ENTRY_CASES = {"pair": None, "identical_payloads": _same_payload,
               "bad_sig": _bad_sig, "not_accused": _other_accused,
               "unknown_proposer": _unknown_proposer,
               "malformed": _malformed}


@pytest.mark.parametrize("case", sorted(ENTRY_CASES))
def test_raft_entry_equivocation_pair(world, clock, case):
    for args in ((0, 0, b"", "normal"), (7, 42, b"x" * 40, "conf"),
                 (2 ** 63, 2 ** 64 - 1, b"\x00\xff", "snapshot")):
        assert world.pk["port"].raft.entry_signed_bytes(*args) == \
            world.pk["ref"].raft.entry_signed_bytes(*args)
    assert binding(world.pk["port"], world.osns[0]) == \
        binding(world.pk["ref"], world.osns[0])
    got = {}
    for by in SIDES:
        proof = json.loads(json.dumps(entry_proof(world.pk[by], world,
                                                  ENTRY_CASES[case])))
        for on in SIDES:
            got[(by, on)] = world.pk[on].monitor.verify_fraud_proof_strict(
                proof, world.msps[on])
    want = {"pair": (True, "entry_equivocation_pair"),
            "identical_payloads": (False, "identical_payloads"),
            "bad_sig": (False, "bad_sig_b"),
            "not_accused": (False, "proposer_not_accused"),
            "unknown_proposer": (False, "unknown_proposer"),
            "malformed": (False, "malformed_entry_evidence")}[case]
    assert set(got.values()) == {want}, got


# ---------------------------------------------------------------------------
# gossip/state.py's monitor branches and gossip/node.py's proof dispatch
# ---------------------------------------------------------------------------

class BlockCommitter:
    """What GossipState needs of a committer: height, store_block and the
    ledger's block store (the package's own BlockStore); `ledger` is also
    what the monitor reads (height, blockstore)."""

    def __init__(self, P):
        store = P.blkstorage.BlockStore()
        self.ledger = types.SimpleNamespace(blockstore=store)
        self.stored = []

    @property
    def height(self):
        return self.ledger.blockstore.height

    def store_block(self, block):
        self.ledger.blockstore.add_block(block)
        self.stored.append(block.header.number)


class ChainView:
    """The monitor's view of a committer's chain: height + blockstore."""

    def __init__(self, committer):
        self.blockstore = committer.ledger.blockstore

    @property
    def height(self):
        return self.blockstore.height


def gossip_world(P, world, side, root):
    """Two gossip nodes over an in-process network, each with its
    monitor (wired as the reference's peer channel wires it) and its
    ProofGossip; the MCS checks orderer signatures on SW."""
    net = P.gcomm.InProcNetwork()
    prov = P.factory.get_default()
    nodes = []
    for i in range(2):
        c = BlockCommitter(P)
        mcs = P.mcs.MessageCryptoService(world.msps[side], prov)
        node = P.gnode.GossipNode(net.register, f"peer{i}", c, mcs=mcs,
                                  signer=signer_for(P, world.peers[i]),
                                  bootstrap=[f"peer{1 - i}"])
        d = root / f"peer{i}"
        d.mkdir()
        mon, q, _ = monitor(P, world, side, d, ledger=ChainView(c),
                            signer=i)
        node.state.monitor = mon
        pg = P.proofgossip.ProofGossip(node.endpoint, node.discovery, mon)
        node.state.proofs = pg
        mon.on_proof = pg.broadcast
        mon.on_pardon = pg.broadcast_pardon
        nodes.append(types.SimpleNamespace(node=node, c=c, mon=mon, q=q,
                                           pg=pg))
    return net, nodes


def gossip_run(P, world, side, root, raws) -> list:
    net, (n0, n1) = gossip_world(P, world, side, root)
    verdicts = []
    inner = n0.mon.check_block

    def check_block(block, source):
        v = inner(block, source)
        verdicts.append((block.header.number, source, v))
        return v
    n0.mon.check_block = check_block
    MSG_BLOCK = P.gstate.MSG_BLOCK
    out = []

    def send(frm, to, raw):
        net.send(frm, to, MSG_BLOCK, {"block": raw})
        net.deliver_all()

    # both peers commit block 0 and block 1 by gossip
    for node_id in ("peer0", "peer1"):
        send("orderer", node_id, raws["c0"])
        send("orderer", node_id, raws["c1"])
    out.append(("heights", list(n0.c.stored), list(n1.c.stored)))
    # garbage, then a broken signature, from one gossip source: scored,
    # quarantined at the threshold, then refused outright
    send("evil", "peer0", b"\x00garbage")
    send("evil", "peer0", raws["c2_broken"])
    send("evil", "peer0", b"\x01garbage")
    send("evil", "peer0", raws["c2"])
    out.append(("evil", n0.q.snapshot().get("gossip|evil"),
                list(n0.c.stored), n0.node.state.buffered))
    # a stale copy of a committed block: no offense
    send("peer1", "peer0", raws["c0"])
    # block 3 buffered ahead of the chain, then its equivocating sibling
    # by the same consenter: held, and the drain's check_commit evicts
    # the buffered copy when block 2 lands
    send("orderer", "peer0", raws["c3"])
    send("orderer", "peer0", raws["c3_equiv"])
    out.append(("buffered", n0.node.state.buffered))
    send("orderer", "peer0", raws["c2"])
    out.append(("after_drain", list(n0.c.stored), n0.node.state.buffered))
    # a validly signed fork of committed block 1 by osn1: peer 0
    # convicts osn1 and gossips the proof; peer 1 re-verifies it against
    # its own chain, convicts, and relays it back: a duplicate
    send("orderer", "peer0", raws["c1_fork"])
    out.append(("verdicts", verdicts))
    out.append(("proofgossip", n0.pg.snapshot(), n1.pg.snapshot()))
    out.append(("quarantined", sorted(
        k for k, v in n0.q.snapshot().items() if v["quarantined"]),
        sorted(k for k, v in n1.q.snapshot().items() if v["quarantined"])))
    out.append(("proofs", [p["reason"] for p in n0.mon.proofs],
                [p["reason"] for p in n1.mon.proofs]))
    return out


def test_gossip_monitor_branches_and_proof_dispatch(world, clock,
                                                    tmp_path):
    osn = world.osns
    c0 = signed_raw(0, b"\x00" * 32, [b"t0"], osn[0])
    R = world.pk["ref"]
    h0 = R.protocol.block_header_hash(parse(R, c0).header)
    c1 = signed_raw(1, h0, [b"t1"], osn[0])
    h1 = R.protocol.block_header_hash(parse(R, c1).header)
    c2 = signed_raw(2, h1, [b"t2"], osn[0])
    h2 = R.protocol.block_header_hash(parse(R, c2).header)
    from fabric_tpu.testing.adversary import break_signature, forge_sibling
    raws = {"c0": c0, "c1": c1, "c2": c2,
            "c2_broken": break_signature(parse(R, c2)).serialize(),
            "c3": signed_raw(3, h2, [b"t3"], osn[2]),
            "c3_equiv": signed_raw(3, h2, [b"t3", b"t3"], osn[2]),
            "c1_fork": forge_sibling(parse(R, c1), osn[1]).serialize()}
    got, trees = {}, {}
    for side in SIDES:
        root = tmp_path / side
        root.mkdir()
        got[side] = gossip_run(world.pk[side], world, side, root, raws)
        trees[side] = files(root)
    assert got["port"] == got["ref"]
    assert trees["port"] == trees["ref"]
    res = dict((r[0], r[1:]) for r in got["port"])
    assert res["heights"] == ([0, 1], [0, 1])
    evil, stored, buffered = res["evil"]
    assert (evil["quarantined"], evil["reason"], evil["offenses"]) == (
        True, "poison", {"garbage": 2, "bad_sig": 1})
    assert stored == [0, 1] and buffered == []   # evil's block 2 refused
    assert res["buffered"] == ([3],)
    assert res["after_drain"] == ([0, 1, 2], [])
    assert res["verdicts"] == ([
        (0, "gossip|orderer", "admit"), (1, "gossip|orderer", "admit"),
        (0, "gossip|peer1", "stale"), (3, "gossip|orderer", "admit"),
        (3, "gossip|orderer", "hold"), (2, "gossip|orderer", "admit"),
        (1, "gossip|orderer", "reject")],)
    pg0, pg1 = res["proofgossip"]
    # peer 0 broadcast osn2's equivocation and osn1's fork; peer 1, at
    # height 2, parked the first (deferred) and convicted on the second
    # against its own block 1, relaying it back: a duplicate on peer 0
    assert pg0["broadcasts"] == 2 and pg0["received"]["duplicate"] == 1
    assert pg1["received"] == {"convicted": 1, "deferred": 1,
                               "duplicate": 0, "rejected": 0}
    assert pg1["relayed"] == 1
    P = world.pk["port"]
    assert res["quarantined"] == (
        sorted([binding(P, osn[1]), binding(P, osn[2]), "gossip|evil"]),
        [binding(P, osn[1])])
    assert res["proofs"] == (["equivocation", "fork"], ["fork"])
