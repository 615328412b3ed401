"""Key-level (state-based) endorsement on the port against the reference.

The five scenarios of tests/test_sbe.py: each one's envelopes are built
once, by the reference (its ChaincodeStub and `build`), and committed by
both packages' classic tails; each must meet the reference test's own
expectations, and the two packages must agree on every block's
validation and final flags, the state and the commit hash.  Then a
seeded SBE stream (`chip_smoke.sbe_stream`: policy sets and deletes,
same-block transitions, two key policies in one tx) against its labels,
with the channel capability on and off.  Tolerance: exact equality."""
import dataclasses
import importlib

import pytest

import chip_smoke
from fabric_tpu.chaincode.stub import ChaincodeStub
from fabric_tpu.committer import sbe as ref_sbe
from fabric_tpu.ledger.statedb import StateDB
from fabric_tpu.msp.ca import DevOrg
from fabric_tpu.policy import parse_policy as ref_parse_policy
from fabric_tpu.protocol import (Block, KVWrite, NsRwSet, TxRwSet,
                                 ValidationCode, block_header_hash, build)
from fabric_tpu_torch.protocol import wire

from test_torch_committer import state_of

PKGS = ("fabric_tpu", "fabric_tpu_torch")
V = int(ValidationCode.VALID)
EPF = int(ValidationCode.ENDORSEMENT_POLICY_FAILURE)
CAP_SBE = "V1_3_KeyLevelEndorsement"


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(scope="module", autouse=True)
def providers():
    return {pkg: mod(pkg, "bccsp.factory").init_factories(
        mod(pkg, "bccsp.factory").FactoryOpts(default="SW")) for pkg in PKGS}


@pytest.fixture(scope="module")
def orgs():
    return DevOrg("Org1"), DevOrg("Org2")


def msps_of(pkg, orgs):
    M = mod(pkg, "msp")
    if pkg == "fabric_tpu":
        return {o.mspid: M.CachedMSP(o.msp()) for o in orgs}
    return {o.mspid: M.CachedMSP(M.MSP(M.MSPConfig(
        **dataclasses.asdict(o.msp_config())))) for o in orgs}


def stack(pkg, providers, orgs, cc_policy, caps=None):
    """A committer of `pkg` whose validator reads key policies from its
    ledger's state (the default peer's wiring); on a channel bundle with
    capabilities `caps` when given, else on static MSPs."""
    C = mod(pkg, "committer")
    policy = mod(pkg, "policy").parse_policy(cc_policy)
    ledger = mod(pkg, "ledger").KVLedger("ch")
    provider = providers[pkg]
    src, msps = None, msps_of(pkg, orgs)
    if caps is not None:
        cfg = mod(pkg, "config")
        org_cfgs = []
        for o in orgs:
            mc = o.msp_config()
            org_cfgs.append(cfg.OrgConfig(
                mspid=o.mspid, root_certs=tuple(mc.root_certs_pem),
                admins=tuple(mc.admin_certs_pem)))
        src = cfg.BundleSource(cfg.Bundle(cfg.ChannelConfig(
            channel_id="ch", sequence=0, orgs=tuple(org_cfgs),
            policies=cfg.default_policies([o.mspid for o in orgs]),
            capabilities=caps)))
        msps = None
    validator = C.TxValidator(
        "ch", msps, provider, C.PolicyRegistry(policy), bundle_source=src,
        sbe_lookup=mod(pkg, "committer.sbe").statedb_lookup(ledger.statedb))
    return C.Committer(ledger, validator, bundle_source=src,
                       provider=provider if src is not None else None)


def commit_both(providers, orgs, env_blocks, cc_policy, caps=None):
    """Both packages over the same block bytes -> per block
    (validation codes, final codes), after checking that the packages
    agree on them, on the state and on the commit hash."""
    raws, prev = [], b"\x00" * 32
    for num, envs in enumerate(env_blocks):
        block = build.new_block(num, prev, envs)
        prev = block_header_hash(block.header)
        raws.append(block.serialize())
    out = {}
    for pkg in PKGS:
        com = stack(pkg, providers, orgs, cc_policy, caps)
        codes = []
        for raw in raws:
            block = (Block.deserialize(raw) if pkg == "fabric_tpu"
                     else wire.parse_block(raw))
            res = com.store_block(block)
            codes.append((res.validation.flags.codes(),
                          res.final_flags.codes()))
        out[pkg] = (codes, state_of(com.ledger), com.ledger.commit_hash)
    assert out["fabric_tpu_torch"] == out["fabric_tpu"]
    return [vc for vc, _fc in out["fabric_tpu"][0]]


# -- the five scenarios of tests/test_sbe.py ------------------------------


def tx(org_client, endorsers, writes=(), sbe_set=(), sbe_del=()):
    stub = ChaincodeStub(StateDB(), "cc", channel_id="ch")
    for k, v in writes:
        stub.put_state(k, v)
    for k, pol in sbe_set:
        stub.set_state_validation_parameter(k, pol)
    for k in sbe_del:
        stub.set_state_validation_parameter(k, None)
    return build.endorser_tx("ch", "cc", "1.0", stub.rwset(),
                             org_client.new_identity("client"),
                             endorsers)


def scenario_overrides_and_transitions(o1, o2):
    e1, e2 = [o1.new_identity("e1")], [o2.new_identity("e2")]
    both = ref_parse_policy("AND('Org1.member','Org2.member')")
    blocks = [
        [tx(o1, e1, writes=[("k", b"v0")], sbe_set=[("k", both)])],
        [tx(o1, e1, writes=[("k", b"v1")]),
         tx(o1, e1, writes=[("other", b"x")]),
         tx(o1, e1 + e2, writes=[("k", b"v2")])]]

    def check(codes):
        assert codes[0] == [V]
        assert codes[1][:2] == [EPF, V]
        assert codes[1][2] != EPF
    return blocks, check


def scenario_same_block_transition(o1, o2):
    e1 = [o1.new_identity("e1")]
    org2_only = ref_parse_policy("OR('Org2.member')")
    blocks = [[tx(o1, e1, sbe_set=[("k2", org2_only)]),
               tx(o1, e1, writes=[("k2", b"a")]),
               tx(o1, [o2.new_identity("e2")], writes=[("k2", b"b")])]]

    def check(codes):
        assert codes[0][0] == V
        assert codes[0][1] == EPF
        assert codes[0][2] != EPF
    return blocks, check


def scenario_delete_falls_back(o1, o2):
    e1 = [o1.new_identity("e1")]
    org2_only = ref_parse_policy("OR('Org2.member')")
    blocks = [[tx(o1, e1, sbe_set=[("k3", org2_only)])],
              [tx(o1, e1, writes=[("k3", b"x")])],
              [tx(o1, [o2.new_identity("e2")], sbe_del=["k3"])],
              [tx(o1, e1, writes=[("k3", b"y")])]]

    def check(codes):
        assert codes == [[V], [EPF], [V], [V]]
    return blocks, check


def scenario_two_key_policies(o1, o2):
    e1 = [o1.new_identity("e1")]
    loose = ref_parse_policy("OR('Org1.member')")
    strict = ref_parse_policy("AND('Org1.member','Org2.member')")
    blocks = [[tx(o1, e1, writes=[("ka", b"v"), ("kb", b"v")],
                  sbe_set=[("ka", loose), ("kb", strict)])],
              [tx(o1, e1, writes=[("ka", b"v1"), ("kb", b"v1")]),
               tx(o1, e1, writes=[("ka", b"v2")])]]

    def check(codes):
        assert codes[0] == [V]
        assert codes[1][0] == EPF
        assert codes[1][1] != EPF
    return blocks, check


def scenario_capability(o1, o2):
    e1 = [o1.new_identity("e1")]
    both = ref_parse_policy("AND('Org1.member','Org2.member')")
    blocks = [[tx(o1, e1, writes=[("k", b"v")], sbe_set=[("k", both)])],
              [tx(o1, e1, writes=[("k", b"v1")])]]
    return blocks, None


SCENARIOS = {"overrides_and_transitions": scenario_overrides_and_transitions,
             "same_block_transition": scenario_same_block_transition,
             "delete_falls_back": scenario_delete_falls_back,
             "two_key_policies": scenario_two_key_policies}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_sbe_scenario_matches_reference(providers, orgs, name):
    blocks, check = SCENARIOS[name](*orgs)
    check(commit_both(providers, orgs, blocks, "OR('Org1.member')"))


@pytest.mark.parametrize("caps,want", [
    (("V2_0", CAP_SBE), [[V], [EPF]]),
    (("V2_0",), [[V], [V]])], ids=["capability_on", "capability_off"])
def test_sbe_gated_by_channel_capability(providers, orgs, caps, want):
    blocks, _ = scenario_capability(*orgs)
    assert commit_both(providers, orgs, blocks, "OR('Org1.member')",
                       caps) == want


# -- a seeded SBE stream against its labels --------------------------------


def stream_envelopes(orgs, specs):
    """The stream's specs as envelopes built by the reference."""
    peers = [o.new_identity("peer0") for o in orgs]
    clients = [o.new_identity(f"client{i}") for i, o in
               enumerate(orgs * 2)]
    pols = {p: ref_sbe.encode_policy(ref_parse_policy(s))
            for p, s in chip_smoke.SBE_POLICIES.items()}
    envs = []
    for creator, ends, nonce, writes, meta in specs:
        ns = [NsRwSet("cc", writes=tuple(KVWrite(k, b"v") for k in writes))]
        if meta:
            ns.append(NsRwSet("cc#meta", writes=tuple(
                KVWrite(k, b"", True) if p is None else KVWrite(k, pols[p])
                for k, p in meta)))
        envs.append(build.endorser_tx(
            "ch", "cc", "1.0", TxRwSet(tuple(ns)), clients[creator],
            [peers[o] for o in ends], nonce=nonce))
    return envs


@pytest.mark.parametrize("caps", [("V2_0", CAP_SBE), ("V2_0",)],
                         ids=["capability_on", "capability_off"])
def test_seeded_sbe_stream_matches_labels(providers, orgs, caps):
    """Three seeded blocks of the SBE stream: the labels on a channel
    with the capability, all VALID without it; the packages agree."""
    spec_blocks, labels, counts = chip_smoke.sbe_stream(3, 40, range(4), 7)
    assert {"set", "delete", "transition_set", "transition_write",
            "two_policies", "write_policed"} <= set(counts)
    env_blocks = [stream_envelopes(orgs, specs) for specs in spec_blocks]
    codes = commit_both(providers, orgs, env_blocks,
                        chip_smoke.SBE_CC_POLICY, caps)
    if CAP_SBE in caps:
        assert codes == labels
        assert any(EPF in lab for lab in labels)
    else:
        assert codes == [[V] * len(lab) for lab in labels]
