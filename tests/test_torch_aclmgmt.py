"""The port's ACL provider (fabric_tpu_torch.policy.aclmgmt) against the
reference's, on the CPU.

tests/test_aclmgmt.py's tests of the provider (the defaults, member
against admin; a config ACL change retargeting a resource at the block
boundary; the handshake-identity check), each parametrised over both
packages (`pkg`): every decision, allowed or the refusal's text, is
recorded, and the port's case also runs the reference's steps and
holds the decisions equal; its qscc test, each query of the package's
`scc.Qscc` through its own named resource.  Added: `DEFAULT_ACLS` equal
to the reference's;
a flipped signature byte denied; the port's provider on
`CudaProvider(device="cpu")` (KP3's plain version) deciding as the
reference's on `SoftwareProvider`.  Identities and signatures come from
the reference's DevOrg; each package builds its channel config from the
same certificates.  Tolerance: exact equality."""
import importlib
import types

import pytest

from fabric_tpu.msp.ca import DevOrg

PKGS = ("ref", "port")


def load(name: str):
    root = "fabric_tpu" if name == "ref" else "fabric_tpu_torch"
    mod = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    factory = mod("bccsp.factory" if name == "ref" else "bccsp")
    return types.SimpleNamespace(
        name=name, config=mod("config"), policy=mod("policy"),
        acl=mod("policy.aclmgmt"), qscc=mod("scc.qscc"),
    blkstorage=mod("ledger.blkstorage"),
        sw=factory.init_factories(factory.FactoryOpts(default="SW")))


@pytest.fixture(scope="module")
def pk():
    return {name: load(name) for name in PKGS}


@pytest.fixture(scope="module")
def org():
    return DevOrg("Org1")


def source(P, org, acls=None, sequence=0):
    C = P.config
    mc = org.msp_config()
    orgs = (C.OrgConfig(mspid="Org1", root_certs=tuple(mc.root_certs_pem),
                        admins=tuple(mc.admin_certs_pem)),)
    return C.BundleSource(C.Bundle(C.ChannelConfig(
        channel_id="ch", sequence=sequence, orgs=orgs,
        policies=C.default_policies(["Org1"]), acls=dict(acls or {}))))


def signed(P, ident, payload: bytes, flip: bool = False):
    sig = bytearray(ident.sign(payload))
    if flip:
        sig[-1] ^= 1
    return P.policy.SignedData(payload, ident.serialize(), bytes(sig))


def decide(P, fn, *args):
    """'allow', or the ACLError's text."""
    try:
        fn(*args)
        return "allow"
    except P.acl.ACLError as exc:
        return f"deny: {exc}"


def differential(pk, pkg, scenario, *args):
    got = scenario(pk[pkg], *args)
    if pkg == "port":
        assert got == scenario(pk["ref"], *args)
    return got


def _defaults(P, org, member, provider=None):
    acl = P.acl.ACLProvider(source(P, org), provider or P.sw)
    sd = signed(P, member, b"query")
    sd_admin = signed(P, org.admin, b"query")
    return [decide(P, acl.check_acl, "qscc/GetBlockByNumber", sd),
            decide(P, acl.check_acl, "cscc/JoinChain", sd),
            decide(P, acl.check_acl, "cscc/JoinChain", sd_admin),
            decide(P, acl.check_acl, "no/SuchResource", sd_admin),
            decide(P, acl.check_acl, "peer/Propose", sd),
            decide(P, acl.check_acl, "peer/Propose",
                   signed(P, member, b"query", flip=True)),
            decide(P, acl.check_acl, "peer/Propose", None),
            acl.policy_name("peer/Propose"), acl.policy_name("nope")]


@pytest.mark.parametrize("pkg", PKGS)
def test_default_acls_member_vs_admin(pk, pkg, org):
    got = differential(pk, pkg, _defaults, org, org.new_identity("m1"))
    assert got[0] == "allow" and got[1].startswith("deny")
    assert got[2] == "allow" and "no ACL mapping" in got[3]
    assert got[4] == "allow" and got[5].startswith("deny")
    assert "no signed data" in got[6]
    assert got[7:] == ["Writers", None]


def _retarget(P, org, member):
    src = source(P, org)
    acl = P.acl.ACLProvider(src, P.sw)
    sd = signed(P, member, b"q")
    out = [decide(P, acl.check_acl, "qscc/GetBlockByNumber", sd)]
    src.update(P.config.Bundle(source(
        P, org, {"qscc/GetBlockByNumber": "Admins"}, 1).current().config))
    out.append(decide(P, acl.check_acl, "qscc/GetBlockByNumber", sd))
    out.append(decide(P, acl.check_acl, "qscc/GetBlockByNumber",
                      signed(P, org.admin, b"q")))
    out.append(acl.policy_name("qscc/GetBlockByNumber"))
    return out


@pytest.mark.parametrize("pkg", PKGS)
def test_config_acl_change_retargets_resource(pk, pkg, org):
    got = differential(pk, pkg, _retarget, org, org.new_identity("m2"))
    assert got[0] == "allow" and got[1].startswith("deny")
    assert got[2] == "allow" and got[3] == "Admins"


def _handshake(P, org, member, foreign):
    acl = P.acl.ACLProvider(source(P, org), P.sw)
    return [decide(P, acl.check, "qscc/GetChainInfo", member),
            decide(P, acl.check, "participation/Join", member),
            decide(P, acl.check, "participation/Join", org.admin),
            decide(P, acl.check, "qscc/GetChainInfo", None),
            decide(P, acl.check, "qscc/GetChainInfo", foreign),
            decide(P, acl.check_identity, "qscc/GetChainInfo",
                   member.serialize()),
            decide(P, acl.check, "qscc/GetChainInfo",
                   signed(P, member, b"x"))]


@pytest.mark.parametrize("pkg", PKGS)
def test_handshake_identity_check(pk, pkg, org):
    got = differential(pk, pkg, _handshake, org, org.new_identity("m3"),
                       DevOrg("Evil").new_identity("x"))
    assert got[0] == "allow" and got[1].startswith("deny")
    assert got[2] == "allow" and "unauthenticated" in got[3]
    assert "unknown caller identity" in got[4]
    assert got[5] == got[6] == "allow"


def _qscc(P, org, member):
    """tests/test_aclmgmt.py's test_qscc_consumes_acl: GetChainInfo
    retargeted to Admins, GetBlockByNumber on its Readers default over an
    empty store."""
    src = source(P, org, {"qscc/GetChainInfo": "Admins"})
    qscc = P.qscc.Qscc("ch", P.blkstorage.BlockStore(),
                       acl=P.acl.ACLProvider(src, P.sw))

    def query(fn, *args):
        try:
            return ("ok", fn(*args))
        except P.acl.ACLError as exc:
            return ("deny", str(exc))
        except P.qscc.QsccError as exc:
            return ("error", str(exc))
    return [query(qscc.get_chain_info, member),
            query(qscc.get_chain_info, org.admin),
            query(qscc.get_block_by_number, 0, member),
            query(qscc.get_block_by_hash, b"\x00" * 32, member),
            query(qscc.get_transaction_by_id, "tx", None)]


@pytest.mark.parametrize("pkg", PKGS)
def test_qscc_consumes_acl(pk, pkg, org):
    got = differential(pk, pkg, _qscc, org, org.new_identity("m4"))
    assert got[0][0] == "deny" and "'Admins'" in got[0][1]
    assert got[1] == ("ok", {"height": 0, "current_hash": b"\x00" * 32,
                             "previous_hash": b"\x00" * 32})
    assert [g[0] for g in got[2:]] == ["error", "error", "deny"]
    assert "unauthenticated" in got[4][1]


def test_default_acls_equal_the_reference(pk):
    assert pk["port"].acl.DEFAULT_ACLS == pk["ref"].acl.DEFAULT_ACLS
    assert pk["port"].policy.ACLProvider is pk["port"].acl.ACLProvider


def test_acl_on_the_cuda_provider_matches_reference(pk, org):
    """The port's provider on CudaProvider(device="cpu"): every item
    through KP3's plain version (one dispatch a check), the decisions
    the reference's on SW."""
    from fabric_tpu_torch.bccsp.cuda import CudaProvider
    prov = CudaProvider(device="cpu", fast_key_threshold=1)
    member = org.new_identity("m5")
    P = pk["port"]
    acl = P.acl.ACLProvider(source(P, org), prov)
    got = [decide(P, acl.check_acl, "peer/Propose",
                  signed(P, member, b"p")),
           decide(P, acl.check_acl, "peer/Propose",
                  signed(P, member, b"p", flip=True))]
    R = pk["ref"]
    racl = R.acl.ACLProvider(source(R, org), R.sw)
    want = [decide(R, racl.check_acl, "peer/Propose",
                   signed(R, member, b"p")),
            decide(R, racl.check_acl, "peer/Propose",
                   signed(R, member, b"p", flip=True))]
    assert got == want and got[0] == "allow" and got[1].startswith("deny")
    assert prov.stats["fallbacks"] == 0
