"""The port's gossip plane (fabric_tpu_torch.gossip) against the
reference's, on the CPU.

tests/test_gossip.py's scenarios, each run on both packages (`pk`) and
held equal: the pull exchange and the certstore; membership, death,
partition and heal; block convergence with anti-entropy catch-up; the
certstore under churn; election failover; and the MCS refusing a
gossiped block whose orderer signature (or data) was tampered with,
over blocks each package's `BlockWriter` signs with one orderer
identity.  Heights, committed header hashes, membership views, leaders
and certstore digests must be equal between the packages.  Added: one
`SecureGossipTransport` exchange between a port endpoint and a
reference endpoint, each way, in both crypto modes.

Gossip runs on `InProcNetwork` pumped deterministically (the pull
engines get seeded generators); the secure exchange waits on a queue
with a 5-s timeout, never on a wall-clock deadline.  Each package's
default provider is SW (the MCS's and discovery's verifies).  Tolerance:
exact equality."""
import queue
import random

import pytest

from fabric_tpu.msp.ca import DevOrg

from intake_world import MODES, PKGS, load, msps_for, set_mode, signer_for


@pytest.fixture(scope="module")
def pk():
    out = {name: load(name) for name in PKGS}
    for P in out.values():
        P.factory.init_factories(P.factory.FactoryOpts(default="SW"))
    return out


def both(pk, scenario, *args):
    """Run `scenario` on both packages; their outcomes must be equal."""
    port = scenario(pk["port"], *args)
    assert port == scenario(pk["ref"], *args)
    return port


class DictStore:
    def __init__(self, items=None, reject=frozenset()):
        self.items = dict(items or {})
        self.reject = set(reject)

    def digests(self):
        return sorted(self.items)

    def get(self, item_id):
        return self.items.get(item_id)

    def add(self, item_id, payload):
        if item_id in self.reject:
            return False
        self.items[item_id] = payload
        return True


class FakeCommitter:
    """store_block/height surface + a blockstore for anti-entropy."""

    class _Store:
        def __init__(self, blocks):
            self._blocks = blocks

        @property
        def height(self):
            return len(self._blocks)

        def get_by_number(self, n):
            return self._blocks[n]

    def __init__(self):
        self.blocks = {}
        self.ledger = type("L", (), {})()
        self.ledger.blockstore = self._Store(self.blocks)

    @property
    def height(self):
        return len(self.blocks)

    def store_block(self, block):
        assert block.header.number == self.height, "out-of-order commit"
        self.blocks[block.header.number] = block

    def hashes(self):
        return [self.blocks[n].hash() for n in sorted(self.blocks)]


def mk_blocks(P, n):
    blocks, prev = [], b"\x00" * 32
    for i in range(n):
        blk = P.build.new_block(i, prev, [])
        blocks.append(blk)
        prev = blk.hash()
    return blocks


def fleet(P, n, **kw):
    net = P.gcomm.InProcNetwork()
    ids = [f"p{i}" for i in range(n)]
    nodes = {}
    for pid in ids:
        nodes[pid] = P.gnode.GossipNode(
            net.register, pid, FakeCommitter(),
            bootstrap=[p for p in ids if p != pid][:2], **kw)
    return net, nodes


def pump(net, nodes, rounds=8):
    for _ in range(rounds):
        for nd in nodes.values():
            nd.tick()
        net.deliver_all()


def views(nodes):
    return {pid: nd.discovery.alive_ids() for pid, nd in nodes.items()}


# -- pull and certstore ----------------------------------------------------------

def _pull_pair(P, store_a, store_b):
    D = P.discovery
    disc = {D.MSG_ALIVE, D.MSG_MEMBERSHIP_REQ, D.MSG_MEMBERSHIP_RESP}
    net = P.gcomm.InProcNetwork()

    class Node:
        def __init__(self, pid, store, bootstrap, seed):
            self.endpoint = net.register(pid, self.handle)
            self.discovery = D.Discovery(self.endpoint, bootstrap=bootstrap)
            self.pull = P.pull.PullMediator(self.endpoint, self.discovery,
                                            "k", store,
                                            rng=random.Random(seed))

        def handle(self, msg_type, frm, body):
            if msg_type in disc:
                self.discovery.handle(msg_type, frm, body)
            else:
                self.pull.handle(msg_type, frm, body)

    a, b = Node("a", store_a, ["b"], 1), Node("b", store_b, ["a"], 2)
    for _ in range(2):
        a.discovery.tick()
        b.discovery.tick()
        net.deliver_all()
    return net, a, b


def _pull_scenario(P):
    sa = DictStore({"x": b"1", "y": b"2", "z": b"3"})
    sb = DictStore({"x": b"1"}, reject={"evil"})
    net, a, b = _pull_pair(P, sa, sb)
    out = [a.discovery.alive_ids(), b.discovery.alive_ids()]
    b.pull.tick()
    net.deliver_all()
    out.append((sorted(sb.items.items()), dict(b.pull.stats)))
    b.pull.tick()
    net.deliver_all()
    out.append(dict(b.pull.stats))
    # unsolicited digest and a poisoned response stay out
    b.pull.handle(P.pull.MSG_PULL_DIGEST, "a",
                  {"kind": "k", "nonce": 999, "digests": ["w"]})
    net.deliver_all()
    b.pull.handle(P.pull.MSG_PULL_RESP, "a",
                  {"kind": "k", "nonce": 1, "items": [["evil", b"p"]]})
    out.append(sorted(sb.items))
    return out


def test_pull_exchange(pk):
    out = both(pk, _pull_scenario)
    assert out[2] == ([("x", b"1"), ("y", b"2"), ("z", b"3")],
                      {"rounds": 1, "items_pulled": 2})
    assert out[3]["items_pulled"] == 2 and out[4] == ["x", "y", "z"]


def _certstore_scenario(P, org1, org2, idents):
    msps = msps_for(P, (org1,))
    me = signer_for(P, idents[0]).serialize()
    store = P.certstore.CertStore(msps, me)
    other = signer_for(P, idents[1]).serialize()
    rogue = signer_for(P, idents[2]).serialize()
    digest = P.certstore.identity_digest
    return [len(store), store.add(digest(other), other),
            store.lookup(other) == other, store.add(digest(rogue), rogue),
            store.add(digest(other), me), store.digests()]


def test_certstore_validates_identities(pk):
    org1, org2 = DevOrg("Org1"), DevOrg("Org2")
    idents = (org1.new_identity("p1"), org1.new_identity("p2"),
              org2.new_identity("evil"))
    out = both(pk, _certstore_scenario, org1, org2, idents)
    assert out[:5] == [1, True, True, False, False] and len(out[5]) == 2


# -- membership --------------------------------------------------------------------

def _membership_scenario(P):
    net, nodes = fleet(P, 6)
    pump(net, nodes)
    out = [views(nodes)]
    net.dropped.add("p5")                   # death
    nodes.pop("p5")
    for nd in nodes.values():
        nd.discovery.expiration = 1
    pump(net, nodes, rounds=6)
    out.append(views(nodes))
    left, right = {"p0", "p1"}, {"p2", "p3", "p4"}
    net.partitions = [left, right]          # partition
    pump(net, nodes, rounds=6)
    out.append(views(nodes))
    net.partitions = []                     # heal
    for nd in nodes.values():
        nd.discovery.expiration = 50
    pump(net, nodes, rounds=8)
    out.append(views(nodes))
    return out


def test_membership_death_partition_heal(pk):
    full, dead, split, healed = both(pk, _membership_scenario)
    ids = {f"p{i}" for i in range(6)}
    assert all(set(v) == ids - {p} for p, v in full.items())
    assert all(set(v) == ids - {p, "p5"} for p, v in dead.items())
    for p, v in split.items():
        side = {"p0", "p1"} if p in ("p0", "p1") else {"p2", "p3", "p4"}
        assert set(v) == side - {p}
    assert all(set(v) == ids - {p, "p5"} for p, v in healed.items())


# -- blocks ---------------------------------------------------------------------------

def _convergence_scenario(P):
    net, nodes = fleet(P, 5)
    pump(net, nodes)
    blocks = mk_blocks(P, 8)
    net.dropped.add("p4")                   # cut off while 0..3 spread
    heights = []
    for blk in blocks[:4]:
        nodes["p0"].state.add_block(blk)
        pump(net, nodes, rounds=3)
        heights.append({p: nd.height for p, nd in nodes.items()})
    net.dropped.discard("p4")               # rejoins: anti-entropy
    for blk in blocks[4:]:
        nodes["p0"].state.add_block(blk)
        pump(net, nodes, rounds=3)
        heights.append({p: nd.height for p, nd in nodes.items()})
    pump(net, nodes, rounds=10)
    heights.append({p: nd.height for p, nd in nodes.items()})
    return heights, {p: nd.state.committer.hashes()
                     for p, nd in nodes.items()}


def test_block_convergence_and_catchup(pk):
    heights, hashes = both(pk, _convergence_scenario)
    assert heights[3]["p4"] == 0 and heights[3]["p1"] == 4
    assert set(heights[-1].values()) == {8}
    assert len({tuple(h) for h in hashes.values()}) == 1


def _churn_scenario(P, org, signers):
    net = P.gcomm.InProcNetwork()
    msps = msps_for(P, (org,))
    ids = [f"p{i}" for i in range(4)]
    nodes = {}
    for i, pid in enumerate(ids[:3]):
        nodes[pid] = P.gnode.GossipNode(
            net.register, pid, FakeCommitter(),
            bootstrap=[p for p in ids[:3] if p != pid], msps=msps,
            signer=signer_for(P, signers[i]))
    for nd in nodes.values():
        nd.cert_pull.rng = random.Random(nd.id)
    for _ in range(6):
        pump(net, nodes, rounds=4)
    out = [{p: nd.certstore.digests() for p, nd in nodes.items()}]
    nodes["p3"] = P.gnode.GossipNode(
        net.register, "p3", FakeCommitter(), bootstrap=["p0", "p1"],
        msps=msps, signer=signer_for(P, signers[3]))
    nodes["p3"].cert_pull.rng = random.Random("p3")
    for _ in range(10):
        pump(net, nodes, rounds=4)
    out.append({p: nd.certstore.digests() for p, nd in nodes.items()})
    return out


def test_certstore_convergence_under_churn(pk):
    org = DevOrg("Org1")
    signers = [org.new_identity(f"peer-p{i}") for i in range(4)]
    before, after = both(pk, _churn_scenario, org, signers)
    assert all(len(d) == 3 for d in before.values())
    assert all(len(d) == 4 for d in after.values())


def _election_scenario(P):
    net, nodes = fleet(P, 4)
    pump(net, nodes, rounds=10)
    leaders = [sorted(p for p, nd in nodes.items() if nd.election.is_leader)]
    (leader,) = leaders[0]
    net.dropped.add(leader)
    nodes.pop(leader)
    for nd in nodes.values():
        nd.discovery.expiration = 1
    pump(net, nodes, rounds=12)
    leaders.append(sorted(p for p, nd in nodes.items()
                          if nd.election.is_leader))
    return leaders


def test_leader_election_failover(pk):
    assert both(pk, _election_scenario) == [["p0"], ["p1"]]


# -- the MCS on gossiped blocks ---------------------------------------------------

def signed_chain(P, orderer, n):
    """n empty blocks written and signed by package P's BlockWriter."""
    writer = P.blockwriter.BlockWriter("ch", P.blkstorage.BlockStore(),
                                       signer=signer_for(P, orderer))
    return [writer.write_block(writer.create_next_block([]))
            for _ in range(n)]


def tampered(P, block, what):
    """A copy of `block` whose orderer signature (or data) was changed."""
    T = P.types
    raw = P.types.Block.deserialize(block.serialize())
    if what == "signature":
        entry = dict(raw.metadata.items[T.META_SIGNATURES][0])
        sig = bytearray(entry["signature"])
        sig[-1] ^= 0x01
        entry["signature"] = bytes(sig)
        raw.metadata.items[T.META_SIGNATURES] = [entry]
    elif what == "data":
        raw = T.Block(raw.header, [b"smuggled"], raw.metadata)
    else:                                   # unknown signer
        entry = dict(raw.metadata.items[T.META_SIGNATURES][0])
        sh = dict(entry["sig_header"])
        sh["creator"] = signer_for(P, DevOrg("Evil").admin).serialize()
        entry["sig_header"] = sh
        raw.metadata.items[T.META_SIGNATURES] = [entry]
    return raw


def _mcs_scenario(P, orgs, orderer, peers):
    msps = msps_for(P, orgs)
    mcs = P.mcs.MessageCryptoService(msps, P.factory.get_default())
    net = P.gcomm.InProcNetwork()
    ids = ["p0", "p1", "p2"]
    nodes = {pid: P.gnode.GossipNode(
        net.register, pid, FakeCommitter(), mcs=mcs,
        signer=signer_for(P, peers[i]),
        bootstrap=[p for p in ids if p != pid]) for i, pid in enumerate(ids)}
    pump(net, nodes, rounds=4)
    out = [views(nodes)]
    chain = signed_chain(P, orderer, 4)
    bad = {w: tampered(P, chain[1], w)
           for w in ("signature", "data", "unknown_signer")}
    out.append(mcs.verify_window([chain[0], bad["signature"], chain[1],
                                  bad["data"], bad["unknown_signer"]]))
    nodes["p0"].state.add_block(chain[0])
    net.deliver_all()
    # a relay injects the tampered copies of block 1 straight to p1
    for w, blk in bad.items():
        nodes["p1"].state.handle(P.gstate.MSG_BLOCK, "px",
                                 {"block": blk.serialize()})
        out.append((w, {p: nd.height for p, nd in nodes.items()},
                    nodes["p1"].state.buffered))
    for blk in chain[1:]:
        nodes["p0"].state.add_block(blk)
        net.deliver_all()
    pump(net, nodes, rounds=2)
    out.append({p: nd.state.committer.hashes() for p, nd in nodes.items()})
    return out, [b.hash() for b in chain]


def test_mcs_refuses_tampered_orderer_signature(pk):
    orgs = (DevOrg("Org1"), DevOrg("OrdererOrg"))
    orderer = orgs[1].new_identity("orderer")
    peers = [orgs[0].new_identity(f"peer{i}") for i in range(3)]
    (port, chain) = _mcs_scenario(pk["port"], orgs, orderer, peers)
    (ref, ref_chain) = _mcs_scenario(pk["ref"], orgs, orderer, peers)
    assert chain == ref_chain          # the headers, so the hashes
    assert port == ref
    assert port[1] == [True, False, True, False, False]
    for _, heights, buffered in port[2:5]:
        assert heights == {"p0": 1, "p1": 1, "p2": 1} and buffered == []
    assert all(h == chain for h in port[5].values())


# -- the secure transport across packages --------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_secure_gossip_transport_across_packages(pk, monkeypatch, mode):
    set_mode(monkeypatch, mode)
    orgs = (DevOrg("Org1"), DevOrg("Org2"))
    idents = {"port": orgs[0].new_identity("p-port"),
              "ref": orgs[1].new_identity("p-ref")}
    servers, transports, inbox = {}, {}, {}
    try:
        for name in PKGS:
            P = pk[name]
            signer, msps = signer_for(P, idents[name]), msps_for(P, orgs)
            servers[name] = P.rpc.RpcServer("127.0.0.1", 0, signer,
                                            msps).start()
            t = P.gcomm.SecureGossipTransport(servers[name], signer, msps)
            inbox[name] = queue.Queue()
            t.start(lambda mt, frm, body, q=inbox[name]: q.put(
                (mt, frm, body)))
            transports[name] = t
        for src, dst, mspid in (("port", "ref", "Org1"),
                                ("ref", "port", "Org2")):
            transports[src].send(transports[dst].id, "gossip.alive",
                                 {"x": 1, "blob": b"b" * 300})
            mt, frm, body = inbox[dst].get(timeout=5.0)
            assert (mt, frm) == ("gossip.alive", transports[src].id)
            assert body["_from_mspid"] == mspid
            assert body["x"] == 1 and bytes(body["blob"]) == b"b" * 300
    finally:
        for t in transports.values():
            t.close()
        for s in servers.values():
            s.stop()
