"""The port's private-data plane (fabric_tpu_torch.privdata: collections,
transient store, pvt store, coordinator) against the reference's, on the
CPU.

tests/test_privdata.py's coordinator cases, each run through both
packages' `Coordinator` over their own `Committer`, `TxValidator` (SW)
and in-memory `KVLedger`, on the same blocks: the envelopes are built
once, by the reference's chaincode stub (public write + a private write
to collection `secrets`, members Org1, BTL 2), and chained once; the
reference commits them as `Block`s, the port as `BlockView`s.  Cases:
a transient-store hit on a member and the same block on a non-member
(hashes only); a remote fetch at commit; missing data, then reconcile;
tampered cleartext, then a poisoned and an honest reconcile; a BTL
purge over five blocks.  After every block (and every reconcile) the
two packages' pvt stores (state, expiry index, txid index), missing
records, flags and commit hashes must be equal.  Tolerance: exact
equality."""
import dataclasses

import pytest

from fabric_tpu.chaincode.stub import ChaincodeStub
from fabric_tpu.ledger.statedb import StateDB as RefStateDB
from fabric_tpu.msp.ca import DevOrg
from fabric_tpu.protocol import Block, block_header_hash, build

from intake_world import PKGS, load, msps_for


@pytest.fixture(scope="module")
def pk():
    out = {name: load(name) for name in PKGS}
    for P in out.values():
        P.factory.init_factories(P.factory.FactoryOpts(default="SW"))
    return out


@pytest.fixture(scope="module")
def org():
    return DevOrg("Org1")


def pvt_tx(org, i, value=b"classified"):
    """(envelope, txid, pvt sets) of a public + private write."""
    stub = ChaincodeStub(RefStateDB(), "cc", channel_id="ch", txid="")
    stub.put_state(f"pub{i}", b"open")
    stub.put_private_data("secrets", f"sec{i}", value)
    env = build.endorser_tx("ch", "cc", "1.0", stub.rwset(),
                            org.new_identity("client"),
                            [org.new_identity("e")])
    return env, env.header().channel_header.txid, stub.private_sets()


def chain(env_blocks):
    raws, prev = [], b"\x00" * 32
    for num, envs in enumerate(env_blocks):
        block = build.new_block(num, prev, envs)
        prev = block_header_hash(block.header)
        raws.append(block.serialize())
    return raws


class Peer:
    """One package's coordinator stack."""

    def __init__(self, P, org, mspid="Org1", fetch=None):
        self.P = P
        pd = P.privdata
        self.ledger = P.ledger.KVLedger("ch", P.ledger.LedgerConfig())
        validator = P.committer.TxValidator(
            "ch", msps_for(P, (org,)), P.factory.get_default(),
            P.committer.PolicyRegistry(P.policy.parse_policy(
                "OR('Org1.member')")))
        registry = pd.CollectionRegistry()
        registry.define("cc", pd.CollectionConfig(
            "secrets", member_orgs=("Org1",), block_to_live=2))
        self.transient = pd.TransientStore()
        self.pvt = pd.PvtDataStore()
        self.coord = pd.Coordinator(
            P.committer.Committer(self.ledger, validator), registry,
            self.transient, self.pvt, mspid=mspid, fetch=fetch)

    def commit(self, raw):
        P = self.P
        block = (P.wire.parse_block(raw) if P.name == "port"
                 else Block.deserialize(raw))
        self.coord.store_block(block)
        stored = self.ledger.blockstore.get_by_number(block.header.number)
        return (bytes(stored.metadata.items[P.types.META_TXFLAGS]),
                self.ledger.commit_hash)

    def state(self):
        pvt = self.pvt
        with pvt._lock:
            return {"state": dict(pvt._state),
                    "expiry": {k: list(v) for k, v in pvt._expiry.items()},
                    "by_txid": {k: dict(v) for k, v in pvt._by_txid.items()},
                    "tx_expiry": {k: list(v)
                                  for k, v in pvt._tx_expiry.items()},
                    "missing": [dataclasses.asdict(m)
                                for m in self.coord.missing],
                    "transient": len(self.transient)}


def run(pk, org, script):
    """script(P) -> a list of observations; equal across packages."""
    port = script(pk["port"])
    assert port == script(pk["ref"])
    return port


def test_transient_hit_member_and_nonmember(pk, org):
    env, txid, sets = pvt_tx(org, 1)
    (raw,) = chain([[env]])

    def script(P):
        member, other = Peer(P, org), Peer(P, org, mspid="Org2")
        member.transient.persist(txid, 0, sets)
        out = [member.commit(raw), member.state(),
               other.commit(raw), other.state()]
        out.append(other.ledger.statedb.get(
            P.collection.pvt_namespace("cc", "secrets"),
            P.collection.hash_key("sec1")).value)
        return out

    out = run(pk, org, script)
    assert out[1]["state"][("cc", "secrets", "sec1")] == (b"classified", 0)
    assert out[1]["transient"] == 0 and out[1]["missing"] == []
    assert out[3]["state"] == {} and out[3]["missing"] == []
    assert out[0] == out[2]                 # same flags, same commit hash
    assert out[4] == pk["port"].collection.hash_value(b"classified")


def test_remote_fetch_at_commit(pk, org):
    env, txid, sets = pvt_tx(org, 1)
    (raw,) = chain([[env]])
    served = {(txid, "cc", "secrets"): dict(sets[("cc", "secrets")])}

    def script(P):
        calls = []

        def fetch(t, ns, coll):
            calls.append((t, ns, coll))
            return served.get((t, ns, coll))
        peer = Peer(P, org, fetch=fetch)
        return [peer.commit(raw), peer.state(), calls]

    out = run(pk, org, script)
    assert out[1]["state"][("cc", "secrets", "sec1")] == (b"classified", 0)
    assert out[2] == [(txid, "cc", "secrets")]


def test_missing_then_reconciled(pk, org):
    env, txid, sets = pvt_tx(org, 1)
    env2, _, _ = pvt_tx(org, 2)
    raws = chain([[env], [env2]])

    def script(P):
        served = {}
        peer = Peer(P, org, fetch=lambda t, ns, c: served.get((t, ns, c)))
        out = [peer.commit(raws[0]), peer.state()]
        served[(txid, "cc", "secrets")] = {"sec1": b"classified"}
        out += [peer.coord.reconcile(), peer.state(), peer.commit(raws[1]),
                peer.state()]
        return out

    out = run(pk, org, script)
    assert len(out[1]["missing"]) == 1 and out[2] == 1
    assert out[3]["missing"] == [] and \
        out[3]["state"][("cc", "secrets", "sec1")] == (b"classified", 0)
    assert len(out[5]["missing"]) == 1      # block 1's sec2: nobody serves


def test_tampered_then_poisoned_then_honest(pk, org):
    env, txid, sets = pvt_tx(org, 1)
    (raw,) = chain([[env]])
    forged = {k: {kk: b"forged" for kk in v} for k, v in sets.items()}

    def script(P):
        served = {}
        peer = Peer(P, org, fetch=lambda t, ns, c: served.get((t, ns, c)))
        peer.transient.persist(txid, 0, forged)
        out = [peer.commit(raw), peer.state()]
        served[(txid, "cc", "secrets")] = {"sec1": b"poison"}
        out += [peer.coord.reconcile(), peer.state()]
        served[(txid, "cc", "secrets")] = {"sec1": b"classified"}
        out += [peer.coord.reconcile(), peer.state()]
        return out

    out = run(pk, org, script)
    assert out[1]["state"] == {} and len(out[1]["missing"]) == 1
    assert out[2] == 0 and len(out[3]["missing"]) == 1
    assert out[4] == 1 and out[5]["missing"] == []


def test_btl_purge(pk, org):
    txs = [pvt_tx(org, i) for i in range(1, 6)]
    raws = chain([[env] for env, _, _ in txs])

    def script(P):
        peer = Peer(P, org)
        out = []
        for (env, txid, sets), raw in zip(txs, raws):
            peer.transient.persist(txid, 0, sets)
            out += [peer.commit(raw), peer.state()]
        out.append(peer.pvt.get_tx_set("cc", "secrets", txs[0][1]))
        return out

    out = run(pk, org, script)
    states = out[1:10:2]
    assert ("cc", "secrets", "sec1") in states[2]["state"]
    assert ("cc", "secrets", "sec1") not in states[3]["state"]   # purged
    assert states[4]["state"][("cc", "secrets", "sec5")] == (b"classified", 4)
    assert out[-1] is None
