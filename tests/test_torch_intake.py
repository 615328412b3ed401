"""The peer's block intake on the port, whole, against the reference's, on
the CPU: RemoteDeliver -> block_signature_items -> the provider ->
GossipNode -> Coordinator -> Committer, and the snapshot fetch.

- The orderer stand-in is the reference's: its `RpcServer` serves
  `deliver` through its `DeliverHandler` over a one-channel registrar,
  holding a seeded chain of six blocks (50, 50, 50, 50, 50 and 20 txs:
  transfers, MVCC conflicts, stale reads, bad creator signatures,
  endorsements from an org outside the channel and, in block 2, one
  private-data tx), each block written and signed by the reference's
  `BlockWriter` with an orderer org's identity.  The first time each
  peer asks for block 3 it is served a copy whose orderer signature was
  corrupted.
- The port's intake is built as the peer wires it (`PeerChannel`): a
  `GossipNode` whose `BlocksProvider` pulls through `RemoteDeliver`
  (window 1, one block a pull), checks the orderer signatures through
  the MCS on the factory's provider asked to degrade,
  `DegradingProvider` over `CudaProvider(device="cpu")` (the
  kernels' plain versions; the orderer's and the stream's keys get
  their tables first, so every batch takes KP3's plain version), and
  hands the block to `GossipState.add_block`, which gossips it and
  drains it into the privdata `Coordinator` over a `Committer` on the
  default peer's classic tail (SBE lookup, a `VerdictCache(65536)`).
  A second port node, fed only by gossip over `InProcNetwork`, has its
  own MCS and committer on SW and fetches the private data from the
  first.  The reference's intake is the same, on SW.
- After every pull: the heights, each block's gate flags, final flags,
  metadata flags and commit hash, and the pvt store are equal across
  the reference's intake and both port nodes.  The tampered block 3 is
  dropped, uncommitted, by both packages, and the next pull commits the
  good one.  After every pull the port's wrapper is HEALTHY and its SW
  fallback has verified nothing; it ends with `fallbacks` 0.
- The snapshot fetch across packages, both ways: the port's
  `bootstrap_from_peers` against a reference server of
  `state.snapshot_meta`/`state.snapshot_chunk`, and the reference's
  against a port server; each install is byte-identical to the other
  package's install from the same server.

Handshakes and gossip alive messages verify through each package's
default provider, SW here (the handshake on the CUDA provider is a GPU
test in tests/test_torch_cuda.py).  Every wait is a pull or an RPC with
its own timeout; servers bind port 0 and stop in a `finally`.
Tolerance: exact equality throughout."""
import os
import random

import pytest

from fabric_tpu.chaincode.stub import ChaincodeStub
from fabric_tpu.ledger.statedb import StateDB as RefStateDB
from fabric_tpu.msp.ca import DevOrg
from fabric_tpu.protocol import (Envelope, KVRead, KVWrite, NsRwSet,
                                 TxRwSet, Version, build)

from intake_world import PKGS, load, msps_for, signer_for

POLICY = "AND('Org1.member', 'Org2.member')"
TAMPERED = 3            # the block served with a corrupted signature first
BLOCK_TXS = (50, 50, 50, 50, 50, 20)
PVT_BLOCK = 2


@pytest.fixture(scope="module")
def pk():
    out = {name: load(name) for name in PKGS}
    for P in out.values():
        P.factory.init_factories(P.factory.FactoryOpts(default="SW"))
    return out


@pytest.fixture(scope="module")
def world():
    orgs = {m: DevOrg(m) for m in ("Org1", "Org2", "OrdererOrg")}
    ids = {"e1": orgs["Org1"].new_identity("endorser"),
           "e2": orgs["Org2"].new_identity("endorser"),
           "client": orgs["Org1"].new_identity("client"),
           "orderer": orgs["OrdererOrg"].new_identity("orderer0"),
           "peer1": orgs["Org1"].new_identity("peer1"),
           "peer2": orgs["Org1"].new_identity("peer2"),
           "ref_peer": orgs["Org2"].new_identity("peer0"),
           "rogue": DevOrg("OrgX").new_identity("endorser")}
    blocks, pvt = stream(ids, random.Random(20240611))
    return {"orgs": list(orgs.values()), "ids": ids, "blocks": blocks,
            "pvt": pvt}


def stream(ids, rng):
    """The chain's envelopes, block by block, and the private write's
    (txid, pvt sets).  Reads carry the version committed before the
    block (or the version an earlier valid tx of the block wrote,
    which conflicts); every 9th tx reads a stale version, every 11th
    carries a corrupted creator signature, every 13th is endorsed by an
    org outside the channel."""
    accts = [f"acct{i:03d}" for i in range(60)]
    committed, blocks, pvt = {}, [], None
    for blk, n in enumerate(BLOCK_TXS):
        envs, inblock = [], {}
        for t in range(n):
            if blk == PVT_BLOCK and t == 0:
                stub = ChaincodeStub(RefStateDB(), "cc", channel_id="ch",
                                     txid="")
                stub.put_state("pub.secret", b"open")
                stub.put_private_data("secrets", "sec1", b"classified")
                env = build.endorser_tx("ch", "cc", "1.0", stub.rwset(),
                                        ids["client"], [ids["e1"],
                                                        ids["e2"]])
                pvt = (env.header().channel_header.txid,
                       stub.private_sets())
                envs.append(env)
                inblock["pub.secret"] = (blk, t)
                continue
            if blk == 0:
                a, b = accts[t % 60], accts[(t + 50) % 60]
            else:
                a, b = rng.sample(accts, 2)
            reads = [(k, committed.get(k)) for k in (a, b)]
            if blk and t % 9 == 4:
                v = committed.get(a) or (0, 0)
                reads[0] = (a, (v[0], v[1] + 7))
            rwset = TxRwSet((NsRwSet(
                "cc",
                reads=tuple(KVRead(k, None if v is None else Version(*v))
                            for k, v in reads),
                writes=(KVWrite(a, b"%d.%d" % (blk, t)),
                        KVWrite(b, b"%d.%d" % (blk, t)))),))
            endorsers = [ids["e1"], ids["e2"]]
            if blk and t % 13 == 6:
                endorsers = [ids["e1"], ids["rogue"]]
            env = build.endorser_tx("ch", "cc", "1.0", rwset, ids["client"],
                                    endorsers)
            bad = blk and t % 11 == 2
            if bad:
                sig = bytearray(env.signature)
                sig[-1] ^= 0x01
                env = Envelope(env.payload, bytes(sig))
            envs.append(env)
            cur = {k: inblock.get(k, committed.get(k)) for k, _ in reads}
            if not bad and endorsers[1] is ids["e2"] and all(
                    cur[k] == v for k, v in reads):
                inblock[a] = inblock[b] = (blk, t)
        committed.update(inblock)
        blocks.append(envs)
    return blocks, pvt


# -- the orderer stand-in (the reference's) ------------------------------------

class OneChannel:
    """A registrar of one channel over the orderer's block store; block
    TAMPERED goes out with a corrupted signature to each peer's first
    request for it."""

    def __init__(self, R, store):
        self.R = R
        self.ledger = self
        self.store = store
        self.served_tampered = set()
        self.requester = None

    @property
    def height(self):
        return self.store.height

    def get(self, channel_id):
        return self if channel_id == "ch" else None

    def authorize_read(self, signed):
        pass

    def wait_for_height(self, height, timeout_s=None):
        return self.store.height >= height

    def get_by_number(self, num):
        block = self.store.get_by_number(num)
        if num == TAMPERED and self.requester not in self.served_tampered:
            self.served_tampered.add(self.requester)
            T = self.R.types
            entry = dict(block.metadata.items[T.META_SIGNATURES][0])
            sig = bytearray(entry["signature"])
            sig[-1] ^= 0x01
            entry["signature"] = bytes(sig)
            items = dict(block.metadata.items)
            items[T.META_SIGNATURES] = [entry]
            block = T.Block(block.header, block.data,
                            T.BlockMetadata(items))
        return block


@pytest.fixture(scope="module")
def orderer(pk, world):
    R = pk["ref"]
    ids = world["ids"]
    store = R.blkstorage.BlockStore()
    writer = R.blockwriter.BlockWriter("ch", store, signer=ids["orderer"])
    for envs in world["blocks"]:
        writer.write_block(writer.create_next_block(
            [e.serialize() for e in envs]))
    registrar = OneChannel(R, store)
    handler = R.deliver.DeliverHandler(registrar)

    def rpc_deliver(body, ident):
        registrar.requester = ident.serialize()
        seek = R.deliver.SeekInfo(start=body.get("start", 0),
                                  stop=body.get("stop"),
                                  behavior=body.get("behavior"))
        for block in handler.deliver(body["channel"], seek, None,
                                     timeout_s=body.get("timeout_s", 5)):
            yield {"block": block.serialize()}

    srv = R.rpc.RpcServer("127.0.0.1", 0, ids["orderer"],
                          msps_for(R, world["orgs"]))
    srv.serve_stream("deliver", rpc_deliver)
    srv.start()
    try:
        yield srv, store
    finally:
        srv.stop()


# -- the peers -------------------------------------------------------------------

class Peer:
    """One package's intake: GossipNode (+ BlocksProvider over
    RemoteDeliver when `orderer_addr`) -> Coordinator -> Committer."""

    def __init__(self, P, world, name, signer, provider, net,
                 orderer_addr=None, fetch=None, bootstrap=()):
        self.P = P
        self.ledger = P.ledger.KVLedger("ch", P.ledger.LedgerConfig())
        msps = msps_for(P, world["orgs"])
        from importlib import import_module
        sbe = import_module(f"{P.root}.committer.sbe")
        vp = import_module(f"{P.root}.verify_plane")
        validator = P.committer.TxValidator(
            "ch", msps, provider, P.committer.PolicyRegistry(
                P.policy.parse_policy(POLICY)),
            sbe_lookup=sbe.statedb_lookup(self.ledger.statedb),
            verify_cache=vp.VerdictCache(65536))
        self.committer = P.committer.Committer(self.ledger, validator)
        pd = P.privdata
        registry = pd.CollectionRegistry()
        registry.define("cc", pd.CollectionConfig(
            "secrets", member_orgs=("Org1",), block_to_live=3))
        self.transient = pd.TransientStore()
        self.pvt = pd.PvtDataStore()
        self.coord = pd.Coordinator(self.committer, registry,
                                    self.transient, self.pvt,
                                    mspid="Org1", fetch=fetch)
        deliver = (P.peer.RemoteDeliver([orderer_addr], signer, msps)
                   if orderer_addr else None)
        self.node = P.gnode.GossipNode(
            net.register, name, self.coord,
            mcs=P.mcs.MessageCryptoService(msps, provider), signer=signer,
            deliver_handler=deliver, bootstrap=list(bootstrap), window=1)
        self.records = []
        inner = self.committer.store_block

        def store_block(block):
            res = inner(block)
            T = P.types
            stored = self.ledger.blockstore.get_by_number(
                block.header.number)
            self.records.append((
                block.header.number, res.validation.flags.to_bytes(),
                res.final_flags.to_bytes(),
                bytes(stored.metadata.items[T.META_TXFLAGS]),
                bytes(stored.metadata.items[T.META_COMMIT_HASH]),
                self.ledger.commit_hash))
            return res
        self.committer.store_block = store_block

    def pull(self) -> int:
        return self.node.provider.pull_window()

    def pvt_state(self):
        with self.pvt._lock:
            return (dict(self.pvt._state),
                    {k: dict(v) for k, v in self.pvt._by_txid.items()})


def table_keys(world):
    return [world["ids"][k].verify_item(b"", b"").pubkey
            for k in ("orderer", "e1", "e2", "client")]


def test_intake_matches_reference(pk, world, orderer):
    srv, store = orderer
    P, R = pk["port"], pk["ref"]
    ids = world["ids"]
    txid, sets = world["pvt"]
    provider = P.factory.init_factories(P.factory.FactoryOpts(
        default="CUDA", device="cpu", degrade=True))
    P.factory.set_default(P.sw.SoftwareProvider())
    assert isinstance(provider, P.degrade.DegradingProvider)
    for pub in table_keys(world):
        provider.primary.key_tables.get_or_build(pub)

    ref_net = R.gcomm.InProcNetwork()
    ref = Peer(R, world, "r1", ids["ref_peer"], R.factory.get_default(),
               ref_net, orderer_addr=srv.addr)
    net = P.gcomm.InProcNetwork()
    p1 = Peer(P, world, "p1", signer_for(P, ids["peer1"]), provider, net,
              orderer_addr=srv.addr, bootstrap=["p2"])
    p2 = Peer(P, world, "p2", signer_for(P, ids["peer2"]),
              P.sw.SoftwareProvider(), net, bootstrap=["p1"],
              fetch=lambda t, ns, c: p1.pvt.get_tx_set(ns, c, t))
    for peer in (ref, p1):
        peer.transient.persist(txid, 0, sets)
    for _ in range(2):                      # membership, signed alives
        for peer in (p1, p2):
            peer.node.discovery.tick()
        net.deliver_all()
    assert p1.node.discovery.alive_ids() == ["p2"]

    pulls = []
    for step in range(len(BLOCK_TXS) + 2):
        got = (ref.pull(), p1.pull())
        net.deliver_all()                   # p1's gossip reaches p2
        pulls.append(got)
        heights = (ref.ledger.height, p1.ledger.height, p2.ledger.height)
        assert len(set(heights)) == 1, (step, heights)
        assert ref.records == p1.records == p2.records, step
        assert ref.pvt_state() == p1.pvt_state() == p2.pvt_state(), step
        # nothing routed to the wrapper's SW fallback
        assert not provider.degraded, step
        assert (provider.fallback_batches, provider.fallback_items) == (
            0, 0), step
    # block 3's first copy was dropped by both; the next pull took it
    assert pulls == [(1, 1)] * TAMPERED + [(0, 0)] + [(1, 1)] * (
        len(BLOCK_TXS) - TAMPERED) + [(0, 0)]
    assert [r[0] for r in p1.records] == list(range(len(BLOCK_TXS)))
    assert p1.node.provider._failures == 1       # the past-the-tip pull
    assert ref.ledger.commit_hash == p1.ledger.commit_hash == \
        p2.ledger.commit_hash
    codes = {c for r in p1.records for c in r[2]}
    assert {0, 4, 10, 11} <= codes, codes
    state, by_txid = p1.pvt_state()
    assert state == {("cc", "secrets", "sec1"): (b"classified", PVT_BLOCK)}
    assert len(p2.coord.missing) == len(p1.coord.missing) == 0
    # the port's breaker never left HEALTHY; nothing fell back
    assert not provider.degraded and provider.backend == "cuda"
    st = provider.primary.stats
    assert st["fallbacks"] == 0 and st["device_sigs"] > 0
    assert st["fast_key_sigs"] == st["device_sigs"]


# -- the snapshot fetch across packages ------------------------------------------

def _snapshot_server(S, ledger, signer, msps):
    snap = S.snapshot
    srv = S.rpc.RpcServer("127.0.0.1", 0, signer, msps)
    srv.serve(snap.META_VERB, lambda body, ident: snap.export_meta(ledger))
    srv.serve(snap.CHUNK_VERB, lambda body, ident: snap.serve_chunk(
        ledger, str(body["db"]), int(body["gen"]), str(body["file"]),
        int(body["offset"])))
    return srv.start()


@pytest.mark.parametrize("server", PKGS)
def test_snapshot_fetch_across_packages(pk, world, server, tmp_path):
    from test_torch_snapshot import dir_bytes, endorser_raws, source
    from test_torch_snapshot import load as snap_load
    orgs, ids = world["orgs"], world["ids"]
    S = pk[server]
    raws = endorser_raws(orgs[0], n_blocks=4, txs_per_block=5)
    src = source(snap_load(server), str(tmp_path / "src"), raws)
    srv = _snapshot_server(S, src, signer_for(S, ids["peer1"]),
                           msps_for(S, orgs))
    installed, outs = {}, {}
    try:
        for name in PKGS:
            C = pk[name]
            root = str(tmp_path / f"dst-{name}")
            assert C.snapshot.needs_bootstrap(root, "ch")
            outs[name] = C.snapshot.bootstrap_from_peers(
                root, "ch", [srv.addr], signer_for(C, ids["peer2"]),
                msps_for(C, orgs), chunk_timeout_s=5.0, attempts=2)
            assert not C.snapshot.needs_bootstrap(root, "ch")
            installed[name] = dir_bytes(root)
    finally:
        srv.stop()
    assert installed["port"] == installed["ref"]
    assert os.path.join("ch", "blocks", "BOOTSTRAP.json") in installed["port"]
    for out in outs.values():
        assert out["height"] == 4 and out["from"] == list(srv.addr)
    assert {k: v for k, v in outs["port"].items() if k != "seconds"} == \
        {k: v for k, v in outs["ref"].items() if k != "seconds"}
    # the port opens its install at the snapshot height and commit hash
    P = pk["port"]
    opened = P.ledger.KVLedger("ch", P.ledger.LedgerConfig(
        root=str(tmp_path / "dst-port"), state_shards=4))
    assert opened.height == src.height == 4
    assert opened.commit_hash == src.commit_hash


def test_snapshot_fetch_refuses_bad_hash(pk, world, tmp_path):
    """A server whose chunk bytes do not match its manifest's sha256 is
    refused by the port's fetch, and nothing is installed."""
    from test_torch_snapshot import endorser_raws, source
    from test_torch_snapshot import load as snap_load
    orgs, ids = world["orgs"], world["ids"]
    R, P = pk["ref"], pk["port"]
    src = source(snap_load("ref"), str(tmp_path / "src"),
                 endorser_raws(orgs[0], n_blocks=2, txs_per_block=3))
    srv = R.rpc.RpcServer("127.0.0.1", 0, ids["peer1"], msps_for(R, orgs))
    srv.serve(R.snapshot.META_VERB,
              lambda body, ident: R.snapshot.export_meta(src))

    def chunk(body, ident):
        out = R.snapshot.serve_chunk(src, str(body["db"]), int(body["gen"]),
                                     str(body["file"]), int(body["offset"]))
        if out["data"]:
            out["data"] = b"\x00" + bytes(out["data"])[1:]
        return out
    srv.serve(R.snapshot.CHUNK_VERB, chunk)
    srv.start()
    root = str(tmp_path / "dst")
    try:
        with pytest.raises(P.snapshot.SnapshotError, match="hash mismatch"):
            P.snapshot.bootstrap_from_peers(
                root, "ch", [srv.addr], signer_for(P, ids["peer2"]),
                msps_for(P, orgs), chunk_timeout_s=5.0, attempts=1)
    finally:
        srv.stop()
    assert P.snapshot.needs_bootstrap(root, "ch")
