"""The port's endorsement side (fabric_tpu_torch.endorser, .chaincode
stub, runtime and `_lifecycle`) against the reference's, on the CPU.

Two kinds of test:

* The reference's own scenarios on both packages: every test function
  of tests/test_endorser.py and tests/test_handlers.py, its source with
  the package's imports pointing at the package (tests/ref_scenarios.py).
* Differentials on tests/endorse_world.py's channel (Org1 P-256, Org2
  Ed25519; one endorsing peer a org, each with its own ledger, committer
  on `LifecyclePolicyProvider`, privdata coordinator and ACL provider),
  the same on both packages, driven in step: each signed proposal made
  once and sent to both packages' endorsers, each block assembled once
  and committed on every peer of both.  Round trips, a failed
  simulation, a bad signature, the `peer/Propose` ACL, an outsider,
  divergent responses, MVCC and phantom conflicts between endorse and
  commit, cc2cc writes, lifecycle approve/commit on the deep and the
  classic tail, too few approvals, a forged approval, a malformed
  proposal, private writes through the transient store to the
  coordinator, the endorser's spans under an RPC root, and one
  proposal through the port's endorser on the CUDA provider's plain
  lanes.

Held: status, message, payload and endorser bytes equal; each
endorsement signature verifies on both packages' SW; an Ed25519
endorser's responses, and an Ed25519 client's assembled envelope, byte
for byte; after every block, flags, state, history, pvt store, the
transient store's size, commit hash and `policy_for` equal.  Tolerance:
exact equality.
"""
import pytest

from endorse_world import COLLECTION, TS, Duo, compare_response, mint
from intake_world import signer_for
from ref_scenarios import PKGS, run_scenario, scenario_module, scenario_names

REF_FILES = ("test_endorser", "test_handlers")
RUNS = [(f, t, p) for f in REF_FILES for t in scenario_names(f)
        for p in PKGS]


@pytest.mark.parametrize("case,name,pkg", RUNS,
                         ids=[f"{f}::{t}-{p}" for f, t, p in RUNS])
def test_reference_scenario(case, name, pkg, request):
    run_scenario(scenario_module(case, pkg), name, request)


# ---------------------------------------------------------------------------
# differentials
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ids():
    return mint()


def deployed(ids, **kw):
    duo = Duo(ids, **kw)
    duo.deploy()
    return duo


@pytest.fixture(autouse=True)
def fixed_clock(monkeypatch):
    """Envelope and proposal timestamps fixed in both packages, so an
    Ed25519 client's envelopes are byte-equal."""
    import types
    from fabric_tpu.protocol import build as rb
    from fabric_tpu_torch.protocol import build as pb
    for mod in (rb, pb):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            time=lambda: TS))


def ok_block(duo, client, calls, expect=None):
    """Each (cc, fn, args) proposed by `client`, endorsed by both peers,
    assembled and committed in one block -> flags."""
    envs = []
    for cc, fn, args in calls:
        sp = duo.proposal(client, cc, fn, args)
        resps = duo.endorse(sp)
        assert all(r.status == 200 for r in resps["ref"]), \
            [r.message for r in resps["ref"]]
        envs.append(duo.envelope(sp, resps, client))
    codes = duo.commit(envs)
    if expect is not None:
        assert codes == expect
    return codes


def seed(duo, client, **accounts):
    args = [x for k, v in accounts.items() for x in (k.encode(), v)]
    return ok_block(duo, client, [("cc", "seed", args)], expect=[0])


@pytest.mark.parametrize("org", (0, 1), ids=("p256-client", "ed25519-client"))
def test_round_trips(ids, org):
    duo = deployed(ids)
    client = ids.clients[org]
    seed(duo, client, a=b"100", b=b"50")
    ok_block(duo, client, [("cc", "transfer", [b"a", b"b", b"30"]),
                           ("cc", "put", [b"c", b"7"])], expect=[0, 0])
    for pkg in ("ref", "port"):
        assert duo.state(pkg, "a") == b"70" and duo.state(pkg, "b") == b"80"
    # a query: endorsed, never submitted
    resps = duo.endorse(duo.proposal(client, "cc", "get", [b"c"]))
    assert [r.status for r in resps["port"]] == [200, 200]


def test_failed_simulation_not_endorsed(ids):
    duo = deployed(ids)
    client = ids.clients[0]
    sp = duo.proposal(client, "cc", "transfer", [b"nobody", b"a", b"1"])
    resps = duo.endorse(sp)
    assert [(r.status, r.message) for r in resps["port"]] == \
        [(500, "insufficient funds")] * 2
    assert "failed" in duo.assembly_error(sp, resps, client)


@pytest.mark.parametrize("org", (0, 1), ids=("p256-client", "ed25519-client"))
def test_bad_proposal_signature(ids, org):
    duo = deployed(ids)
    sp = duo.proposal(ids.clients[org], "cc", "put", [b"k", b"v"])
    sig = bytearray(sp.signature)
    sig[-1] ^= 1
    bad = type(sp)(sp.proposal_bytes, bytes(sig))
    resps = duo.endorse(bad)
    assert [(r.status, r.message) for r in resps["port"]] == \
        [(500, "bad proposal signature")] * 2


def test_acl_gate_and_outsider(ids):
    """peer/Propose retargeted to the channel policy AnyAdmin by the
    channel's ACLs: a member is refused, an admin endorsed; a creator of
    an org outside the channel is refused before the ACL."""
    duo = deployed(ids, acls={"peer/Propose": "AnyAdmin"})
    member = duo.endorse(duo.proposal(ids.clients[0], "cc", "put",
                                      [b"k", b"v"]))
    assert {r.status for r in member["port"]} == {500}
    assert "peer/Propose" in member["port"][0].message
    admin = duo.endorse(duo.proposal(ids.orgs[0].admin, "cc", "put",
                                     [b"k", b"v"]))
    assert [r.status for r in admin["port"]] == [200, 200]
    outsider = duo.endorse(duo.proposal(ids.outsider, "cc", "put",
                                        [b"k", b"v"]))
    assert [r.message for r in outsider["port"]] == \
        ["unknown or invalid creator identity"] * 2


def test_divergent_responses_rejected(ids):
    duo = deployed(ids)
    client = ids.clients[1]
    sp = duo.proposal(client, "cc", "put", [b"k", b"v"])
    resps = duo.endorse(sp)
    for pkg, P in duo.P.items():
        r2 = resps[pkg][1]
        resps[pkg][1] = P.proposal.ProposalResponse(
            200, "", r2.payload[:-1] + b"\x00", r2.endorsement)
    assert "distinct simulation payloads" in duo.assembly_error(
        sp, resps, client)


def test_mvcc_and_phantom_between_endorse_and_commit(ids):
    duo = deployed(ids)
    client = ids.clients[0]
    seed(duo, client, m=b"100", n=b"0", r1=b"1", r2=b"1")
    # two transfers simulate against the same version of "m"
    ok_block(duo, client, [("cc", "transfer", [b"m", b"n", b"10"]),
                           ("cc", "transfer", [b"m", b"n", b"20"])],
             expect=[0, 11])
    assert duo.state("port", "m") == b"90"
    # a scan endorsed, then a phantom insert commits first
    sp = duo.proposal(client, "cc", "scan", [b"r", b"s"])
    env_scan = duo.envelope(sp, duo.endorse(sp), client)
    ok_block(duo, client, [("cc", "put", [b"r3", b"1"])], expect=[0])
    assert duo.commit([env_scan]) == [12]


def test_cc2cc_writes_the_callee_namespace(ids):
    duo = deployed(ids)
    ok_block(duo, ids.clients[1], [("cc", "call_other",
                                    [b"cc2", b"put", b"zz", b"9"])],
             expect=[0])
    for pkg in ("ref", "port"):
        assert duo.state(pkg, "zz", "cc2") == b"9"
        assert duo.state(pkg, "zz", "cc") is None


def lifecycle_tx(duo, admin, fn, args):
    sp = duo.proposal(admin, "_lifecycle", fn, args)
    resps = duo.endorse(sp)
    return sp, resps


@pytest.mark.parametrize("classic", (False, True), ids=("deep", "classic"))
def test_lifecycle_approve_commit_feeds_the_committer(ids, classic):
    """Both orgs approve `newcc` (OR Org2), one commits it; every peer's
    `policy_for("newcc")` gives the same bytes, and the next block, on
    the per-block policy memo, takes an Org2-only endorsement of it."""
    duo = deployed(ids, classic=classic)
    pol = duo.P["ref"].policy.parse_policy("OR('Org2.member')").serialize()
    args = [b"newcc", b"1.0", b"1", pol]
    for org in (0, 1):
        admin = ids.orgs[org].admin
        sp, resps = lifecycle_tx(duo, admin, "approve_for_org", args)
        assert duo.commit([duo.envelope(sp, resps, admin)]) == [0]
    admin = ids.orgs[0].admin
    sp, resps = lifecycle_tx(duo, admin, "commit", args)
    assert duo.commit([duo.envelope(sp, resps, admin)]) == [0]
    for pkg in ("ref", "port"):
        for peer in duo.peers[pkg]:
            assert peer.policies.policy_for("newcc").serialize() == pol
            d = peer.policies.definition_for("newcc")
            assert (d.version, d.sequence, d.policy_bytes) == ("1.0", 1, pol)
            peer.registry.install(
                duo.P[pkg].runtime.ChaincodeDefinition("newcc", "1.0"),
                peer.registry._contracts["cc"][1])
    client = ids.clients[1]
    sp = duo.proposal(client, "newcc", "put", [b"q", b"1"])
    resps = duo.endorse(sp, endorsers=(1,))
    assert duo.commit([duo.envelope(sp, resps, client)]) == [0]
    # the channel default (MAJORITY) still gates cc: one org fails it
    sp = duo.proposal(client, "cc", "put", [b"q", b"1"])
    resps = duo.endorse(sp, endorsers=(1,))
    assert duo.commit([duo.envelope(sp, resps, client)]) == [10]


def test_lifecycle_too_few_and_forged_approvals(ids):
    duo = deployed(ids)
    admin = ids.orgs[0].admin
    args = [b"solo", b"1.0", b"1", b""]
    sp, resps = lifecycle_tx(duo, admin, "approve_for_org", args)
    assert duo.commit([duo.envelope(sp, resps, admin)]) == [0]
    _, resps = lifecycle_tx(duo, admin, "commit", args)
    assert {r.message for r in resps["port"]} == {
        "insufficient approvals for solo seq 1: 1/2"}
    # an extra argument naming another org is refused outright
    _, resps = lifecycle_tx(duo, admin, "approve_for_org", args + [b"Org2"])
    assert {r.status for r in resps["port"]} == {500}


def test_malformed_proposal_returns_500(ids):
    duo = deployed(ids)
    serde = duo.P["ref"].serde
    raw = serde.encode({
        "header": {"channel_header": {"type": "endorser_transaction",
                                      "channel_id": "ch", "txid": "x",
                                      "epoch": 0, "timestamp": 0},
                   "signature_header": {"creator": b"junk", "nonce": 7}},
        "chaincode_id": "cc", "fn": "put", "args": []})
    R = duo.P["ref"]
    resps = duo.endorse(R.proposal.SignedProposal(raw, b"sig"))
    assert {r.status for r in resps["port"]} == {500}
    resps = duo.endorse(R.proposal.SignedProposal(b"\x00garbage", b"sig"))
    assert resps["port"][0].message.startswith("undecodable proposal")


def test_private_writes_through_transient_store_to_coordinator(ids):
    """Private writes: only hashes enter the rwset, the cleartext waits in
    each endorser's transient store; at commit the member peer (Org1)
    takes it into its pvt store, the other keeps hashes only, and both
    purge their transient stores."""
    duo = deployed(ids)
    client = ids.clients[0]
    sp = duo.proposal(client, "cc", "put_private", [b"s1", b"hidden"])
    resps = duo.endorse(sp)
    for pkg in ("ref", "port"):
        assert [len(p.transient) for p in duo.peers[pkg]] == [1, 1]
    assert duo.commit([duo.envelope(sp, resps, client)]) == [0]
    for pkg in ("ref", "port"):
        p1, p2 = duo.peers[pkg]
        assert p1.pvt.get("cc", COLLECTION, "s1") == b"hidden"
        assert p2.pvt.get("cc", COLLECTION, "s1") is None
        assert len(p1.transient) == len(p2.transient) == 0
    resps = duo.endorse(duo.proposal(client, "cc", "get_private", [b"s1"]))
    assert [r.status for r in resps["port"]] == [200, 200]


def test_endorser_spans_under_an_rpc_root(ids):
    """The endorser's three spans are children of the RPC server's root
    span, on both packages; without a root none is recorded."""
    from fabric_tpu.ops_plane import tracing as rtr
    from fabric_tpu_torch.ops_plane import tracing as ptr
    duo = deployed(ids)
    sp = duo.proposal(ids.clients[1], "cc", "put", [b"k", b"v"])
    names = {}
    for pkg, tr in (("ref", rtr.tracer), ("port", ptr.tracer)):
        was = (tr.enabled, tr.sample_rate)
        tr.reset()
        tr.configure({"enabled": True, "sample_rate": 1.0})
        try:
            P = duo.P[pkg]
            psp = P.proposal.SignedProposal(sp.proposal_bytes, sp.signature)
            peer = duo.peers[pkg][0]
            peer.endorser.process_proposal(psp)
            assert tr.recorder.list()["recent"] == []
            with tr.start_span("rpc.endorser.propose"):
                peer.endorser.process_proposal(psp)
            (rec,) = tr.recorder.list()["recent"]
            spans = tr.recorder.get(rec["trace_id"])["spans"]
            by_id = {s["span_id"]: s for s in spans}
            names[pkg] = sorted(
                (s["name"], by_id[s["parent_id"]]["name"]
                 if s["parent_id"] in by_id else None) for s in spans)
        finally:
            tr.enabled, tr.sample_rate = was
            tr.reset()
    assert names["port"] == names["ref"] == [
        ("endorser.sign", "rpc.endorser.propose"),
        ("endorser.simulate", "rpc.endorser.propose"),
        ("endorser.validate", "rpc.endorser.propose"),
        ("rpc.endorser.propose", None)]


def test_endorser_on_the_cuda_provider_matches_reference(ids):
    """One proposal of an Org1 (P-256) client through the port's endorser
    with the factory's default and the ACL on CudaProvider(device="cpu")
    (KP3's plain version: one item a call), the reference's on SW; the
    responses equal, the block's flags equal, no fallback."""
    from fabric_tpu_torch.bccsp import factory
    from fabric_tpu_torch.bccsp.cuda import CudaProvider
    prov = CudaProvider(device="cpu", fast_key_threshold=1)
    default = factory._default
    factory._default = prov
    calls = []
    inner = prov.batch_verify_async

    def counted(items):
        calls.append(len(items))
        return inner(items)
    prov.batch_verify_async = counted
    try:
        duo = Duo(ids, providers={"port": prov})
        endorser = duo.peers["port"][0].endorser
        during = []

        def process_proposal(sp, _inner=endorser.process_proposal):
            n = len(calls)
            out = _inner(sp)
            during.append(calls[n:])
            return out
        endorser.process_proposal = process_proposal
        client = ids.clients[0]
        sp = duo.proposal(client, "cc", "put", [b"k", b"v"])
        resps = duo.endorse(sp, endorsers=(0,))
        assert resps["port"][0].status == 200
        # creator verify, then the peer/Propose ACL: one item each
        assert during == [[1, 1]]
        bad = duo.endorse(type(sp)(sp.proposal_bytes,
                                   sp.signature[:-1] + bytes(
                                       [sp.signature[-1] ^ 1])),
                          endorsers=(0,))
        assert bad["port"][0].message == "bad proposal signature"
    finally:
        factory._default = default
    assert prov.stats["fallbacks"] == 0


def test_responses_compare_catches_a_changed_payload(ids):
    """The comparison itself: a response whose payload differs is caught
    (so an equal comparison above means equal bytes)."""
    duo = deployed(ids)
    sp = duo.proposal(ids.clients[1], "cc", "put", [b"k", b"v"])
    resps = duo.endorse(sp)
    r, p = resps["ref"][1], resps["port"][1]
    P = duo.P["port"]
    changed = P.proposal.ProposalResponse(p.status, p.message,
                                          p.payload + b"x", p.endorsement)
    with pytest.raises(AssertionError):
        compare_response(duo.P, ids, r, changed)
    assert signer_for(P, ids.peers[1]).serialize() == \
        p.endorsement.endorser
