"""The port's system chaincodes (fabric_tpu_torch.scc: qscc, cscc,
discovery) against the reference's, on the CPU.

* The reference's own scenarios on both packages: every test function
  of tests/test_scc.py (tests/ref_scenarios.py).
* Differentials on one chain: tests/endorse_world.py's channel on both
  packages, `cc` and `cc2` defined through `_lifecycle` and two blocks
  of endorsed txs committed on every peer.  qscc on each peer's block
  store through its `ACLProvider` (each query its own `qscc/<Function>`
  resource; GetChainInfo retargeted to the channel policy AnyAdmin in a
  second run): chain info, every block by number and by hash, every
  committed tx by id, the errors for what is not there, and each
  decision for a member, an admin, a tampered signature and no caller;
  cscc over both peers' channels (join, list, config, the errors);
  discovery over a membership and each peer's `policy_for` (the
  committed `cc` and policies of several shapes).

Held: every answer equal to the block store's and the reference's
(blocks and envelopes by their bytes), every ACL decision equal.
Tolerance: exact equality.
"""
import pytest

from endorse_world import TS, Duo, mint
from intake_world import signer_for
from ref_scenarios import PKGS, run_scenario, scenario_module, scenario_names

RUNS = [("test_scc", t, p) for t in scenario_names("test_scc") for p in PKGS]


@pytest.mark.parametrize("case,name,pkg", RUNS,
                         ids=[f"{f}::{t}-{p}" for f, t, p in RUNS])
def test_reference_scenario(case, name, pkg, request):
    run_scenario(scenario_module(case, pkg), name, request)


@pytest.fixture(scope="module")
def chain():
    """The channel on both packages with cc, cc2 defined and two blocks
    of transfers -> (ids, duo, txids)."""
    import types
    from fabric_tpu.protocol import build as rb
    from fabric_tpu_torch.protocol import build as pb
    saved = (rb.time, pb.time)
    rb.time = pb.time = types.SimpleNamespace(time=lambda: TS)
    try:
        ids = mint()
        duo = Duo(ids)
        duo.deploy()
        txids = []
        for calls in ((("seed", [b"a", b"10", b"b", b"5"]),),
                      (("transfer", [b"a", b"b", b"3"]),
                       ("put", [b"c", b"1"]))):
            envs = []
            for i, (fn, args) in enumerate(calls):
                client = ids.clients[i % 2]
                sp = duo.proposal(client, "cc", fn, args)
                envs.append(duo.envelope(sp, duo.endorse(sp), client))
                txids.append(envs[-1].header().channel_header.txid)
            assert duo.commit(envs) == [0] * len(envs)
    finally:
        rb.time, pb.time = saved
    return ids, duo, txids


def signed(P, ident, payload, flip=False):
    sig = bytearray(ident.sign(payload))
    if flip:
        sig[-1] ^= 1
    return P.policy.SignedData(payload, ident.serialize(), bytes(sig))


def qscc_answers(P, peer, ids, txids, acls=None) -> list:
    """Every qscc query on `peer`'s block store, for each caller, as
    ("ok", bytes or dict) | ("deny", text) | ("error", text)."""
    from endorse_world import bundle_source
    acl = P.acl.ACLProvider(bundle_source(P, ids, acls), peer.acl.provider)
    q = P.qscc.Qscc("ch", peer.ledger.blockstore, acl=acl)
    store = peer.ledger.blockstore
    callers = {
        "member": signed(P, signer_for(P, ids.clients[0]), b"q"),
        "ed25519-member": signed(P, signer_for(P, ids.clients[1]), b"q"),
        "admin": signed(P, signer_for(P, ids.orgs[1].admin), b"q"),
        "tampered": signed(P, signer_for(P, ids.clients[0]), b"q", True),
        "none": None}

    def ask(fn, *args):
        try:
            got = fn(*args)
        except P.acl.ACLError as exc:
            return ("deny", str(exc))
        except P.qscc.QsccError as exc:
            return ("error", str(exc))
        return ("ok", got if isinstance(got, dict) else got.serialize())
    out = []
    for who, sd in callers.items():
        out.append(("info", who, None, ask(q.get_chain_info, sd)))
        for n in range(store.height + 1):
            out.append(("number", who, n, ask(q.get_block_by_number, n,
                                              sd)))
        for n in range(store.height):
            h = store.get_by_number(n).hash()
            out.append(("hash", who, n, ask(q.get_block_by_hash, h, sd)))
        out.append(("hash", who, None,
                    ask(q.get_block_by_hash, b"\x01" * 32, sd)))
        for txid in list(txids) + ["absent"]:
            out.append(("tx", who, txid, ask(q.get_transaction_by_id,
                                             txid, sd)))
    return out


@pytest.mark.parametrize("acls", (None, {"qscc/GetChainInfo": "AnyAdmin"}),
                         ids=("defaults", "retargeted"))
def test_qscc_answers_equal_the_block_store(chain, acls):
    ids, duo, txids = chain
    got = {pkg: [qscc_answers(duo.P[pkg], peer, ids, txids, acls)
                 for peer in duo.peers[pkg]] for pkg in ("ref", "port")}
    assert got["port"] == got["ref"]
    rows = {(kind, who, arg): ans for kind, who, arg, ans in got["port"][0]}
    store = duo.peers["port"][0].ledger.blockstore
    for n in range(store.height):
        block = ("ok", store.get_by_number(n).serialize())
        assert rows[("number", "member", n)] == block
        assert rows[("hash", "member", n)] == block
    assert rows[("number", "member", store.height)][0] == "error"
    assert rows[("hash", "member", None)][0] == "error"
    assert rows[("tx", "member", "absent")][0] == "error"
    info = rows[("info", "member", None)]
    if acls is None:
        assert info == ("ok", {
            "height": store.height,
            "current_hash": store.chain_info().current_hash,
            "previous_hash": store.chain_info().previous_hash})
    else:
        assert info[0] == "deny"
        assert rows[("info", "admin", None)][0] == "ok"
    for who in ("tampered", "none"):
        assert {ans[0] for (_k, w, _a), ans in rows.items()
                if w == who} == {"deny"}
    P = duo.P["port"]
    for txid in txids:
        ok, raw = rows[("tx", "ed25519-member", txid)]
        env = P.protocol.Envelope.deserialize(raw)
        assert ok == "ok" and env.header().channel_header.txid == txid


def test_cscc_over_both_channels(chain):
    ids, duo, _ = chain
    out = {}
    for pkg, P in duo.P.items():
        created = []

        def create(cid, config, _P=P):
            ch = type("Chan", (), {})()
            ch.bundle_source = _P.config.BundleSource(_P.config.Bundle(
                config))
            created.append(cid)
            return ch
        cscc = P.cscc.Cscc(create_channel=create)
        cscc.register("ch", duo.peers[pkg][0])
        peer_cfg = cscc.get_channel_config
        rows = [cscc.get_channels()]
        duo.peers[pkg][0].bundle_source = duo.peers[pkg][0].source
        rows.append(peer_cfg("ch").to_dict())
        cfg2 = P.config.ChannelConfig(
            "ch2", 0, peer_cfg("ch").orgs,
            P.config.default_policies(["Org1", "Org2"]))
        cscc.join_chain("ch2", cfg2)
        rows += [cscc.get_channels(), peer_cfg("ch2").to_dict(), created]
        for fn, args in ((cscc.join_chain, ("ch2", cfg2)),
                         (peer_cfg, ("nope",))):
            with pytest.raises(P.cscc.CsccError) as exc:
                fn(*args)
            rows.append(str(exc.value))
        out[pkg] = rows
    assert out["port"] == out["ref"]
    assert out["port"][2] == ["ch", "ch2"]


POLICIES = ("AND('Org1.member', 'Org2.member')",
            "OR('Org1.member', 'Org2.member')",
            "OutOf(2, 'Org1.member', 'Org2.member', 'Org3.member')",
            "AND('Org1.admin', OR('Org2.member', 'Org3.member'))",
            "AND('Org1.member', 'Org3.member')")
MEMBERS = [{"id": "peer1", "mspid": "Org1", "roles": ["peer"]},
           {"id": "peer2", "mspid": "Org2"},
           {"id": "peer2b", "mspid": "Org2", "roles": ["admin"]}]


def layouts(P, svc, ns) -> dict:
    try:
        got = svc.endorsers(ns)
    except ValueError as exc:
        return {"error": str(exc)}
    return {"layouts": [lay.as_dict() for lay in got["layouts"]],
            "peers": got["peers_by_group"]}


def test_discovery_layouts_equal(chain):
    """The committed cc (AND of both orgs) gives the one layout
    {Org1: 1, Org2: 1} on every peer; policies of other shapes and an
    undefined chaincode give the reference's answers."""
    ids, duo, _ = chain
    out = {}
    for pkg, P in duo.P.items():
        rows = []
        for peer in duo.peers[pkg]:
            svc = P.sdiscovery.DiscoveryService(lambda: MEMBERS,
                                                peer.policies.policy_for)
            rows.append(layouts(P, svc, "cc"))
            rows.append(layouts(P, svc, "undefined"))
        for text in POLICIES:
            pol = P.policy.parse_policy(text)
            svc = P.sdiscovery.DiscoveryService(lambda: MEMBERS,
                                                lambda ns, _p=pol: _p)
            rows.append(layouts(P, svc, "x"))
        out[pkg] = rows
    assert out["port"] == out["ref"]
    assert out["port"][0]["layouts"] == [{"Org1:member": 1,
                                          "Org2:member": 1}]
    assert "error" in out["port"][1]
