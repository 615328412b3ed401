"""The port's idemix plane (fabric_tpu_torch.idemix) and the providers'
idemix lane against the reference's (fabric_tpu.idemix), on the CPU.

* The port's BN254 host constants equal the reference's.
* Presentations and idemixgen files cross both ways: made by the
  reference and verified by the port, and the reverse.
* `CudaProvider(device="cpu")` (the plain KB8), the port's
  `SoftwareProvider` and the reference's `verify_item_host` agree on the
  red/green set of tests/test_idemix_device.py: valid presentations of
  two issuers, a forged credential that passes every host check, a
  presentation over another payload, a cross-issuer swap and garbage;
  nothing falls back.
* A block whose creators are idemix identities commits through the
  port's Committer with the flags, state and commit hash of the
  reference's software stack on the same block bytes (as
  tests/test_idemix.py:test_idemix_msp_end_to_end_tx)."""
import dataclasses

import pytest

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)

from fabric_tpu.bccsp import VerifyItem as RefItem
from fabric_tpu.bccsp.factory import FactoryOpts as RefOpts
from fabric_tpu.bccsp.factory import init_factories as ref_init
from fabric_tpu.committer import Committer as RefCommitter
from fabric_tpu.committer import PolicyRegistry as RefPolicies
from fabric_tpu.committer import TxValidator as RefValidator
from fabric_tpu.idemix import bn254 as ref_bn
from fabric_tpu.idemix import gen as ref_gen
from fabric_tpu.idemix.msp import IdemixMSP as RefIdemixMSP
from fabric_tpu.idemix.msp import IdemixSigningIdentity as RefSigner
from fabric_tpu.idemix.msp import collect_item_parts as ref_collect
from fabric_tpu.idemix.msp import verify_item_host as ref_verify
from fabric_tpu.ledger import KVLedger as RefLedger
from fabric_tpu.msp import CachedMSP as RefCachedMSP
from fabric_tpu.msp.ca import DevOrg
from fabric_tpu.policy import parse_policy as ref_parse_policy
from fabric_tpu.protocol import Block, KVWrite, NsRwSet, TxRwSet, build
from fabric_tpu_torch.bccsp import VerifyItem
from fabric_tpu_torch.bccsp.cuda import CudaProvider
from fabric_tpu_torch.bccsp.sw import SoftwareProvider
from fabric_tpu_torch.committer import Committer, PolicyRegistry, TxValidator
from fabric_tpu_torch.idemix import bn254 as bn
from fabric_tpu_torch.idemix import gen
from fabric_tpu_torch.idemix.msp import (IdemixMSP, IdemixSigningIdentity,
                                         collect_item_parts, verify_item_host)
from fabric_tpu_torch.ledger import KVLedger
from fabric_tpu_torch.msp import MSP, CachedMSP, MSPConfig
from fabric_tpu_torch.ops import bn254 as K
from fabric_tpu_torch.policy import parse_policy
from fabric_tpu_torch.protocol import wire

POLICY = "OR('Org1.member')"


def test_constants_equal_the_reference():
    for name in ("P", "R", "X_BN", "T_TRACE", "G1_GEN", "G2_GEN", "B_TWIST",
                 "IS_D_TWIST", "GAMMA", "ATE_LAMBDA", "XI"):
        assert getattr(bn, name) == getattr(ref_bn, name), name
    assert bn.ate_precompute(bn.G2_GEN) == ref_bn.ate_precompute(
        ref_bn.G2_GEN)
    assert K.P == bn.P


@pytest.fixture(scope="module")
def ref_world(tmp_path_factory):
    """The reference's idemixgen: one issuer, one signer."""
    d = tmp_path_factory.mktemp("ref_idemix")
    out = ref_gen.generate(str(d), "IdemixOrg", ["alice:engineering:member"])
    alice = ref_gen.load_signer(str(d / "alice.signer"),
                                str(d / "msp_config.bin"))
    return d, out, alice


@pytest.fixture(scope="module")
def port_world(tmp_path_factory):
    """The port's idemixgen: two issuers, alice and carol."""
    signers = []
    dirs = []
    for org, user in (("IdemixOrg", "alice"), ("OtherOrg", "carol")):
        d = tmp_path_factory.mktemp(f"port_{org}")
        gen.generate(str(d), org, [f"{user}:engineering:member"])
        signers.append(gen.load_signer(str(d / f"{user}.signer"),
                                       str(d / "msp_config.bin")))
        dirs.append(d)
    return dirs, signers


def test_reference_presentations_verify_in_the_port(ref_world):
    d, _out, ref_alice = ref_world
    item = ref_alice.verify_item(b"p", ref_alice.sign(b"p"))
    assert verify_item_host(VerifyItem(*item))
    assert not verify_item_host(VerifyItem(*item._replace(
        payload=bytes(32))))
    # the port reads the reference's files and signs; the reference
    # verifies
    alice = gen.load_signer(str(d / "alice.signer"),
                            str(d / "msp_config.bin"))
    mine = alice.verify_item(b"q", alice.sign(b"q"))
    assert mine.pubkey == item.pubkey
    assert ref_verify(RefItem(*mine))


def test_port_presentations_verify_in_the_reference(port_world):
    (d, _), (alice, _) = port_world
    item = alice.verify_item(b"p", alice.sign(b"p"))
    assert ref_verify(RefItem(*item))
    assert not ref_verify(RefItem(*item._replace(payload=bytes(32))))
    ref_alice = ref_gen.load_signer(str(d / "alice.signer"),
                                    str(d / "msp_config.bin"))
    theirs = ref_alice.verify_item(b"q", ref_alice.sign(b"q"))
    assert verify_item_host(VerifyItem(*theirs))


def forge(signer, cls):
    """A signer whose credential carries a random A: every host check of
    its presentations passes, only the pairing equation fails."""
    c = signer._cred
    forged = type(c)(bn.g1_mul(12345, bn.G1_GEN), c.e, c.s, list(c.attrs))
    return cls(signer.mspid, signer._config, forged, signer.ou, signer.role,
               handle_sig=signer._handle_sig)


@pytest.fixture(scope="module")
def corpus(port_world):
    _, (alice, carol) = port_world
    items = [s.verify_item(b"m%d" % i, s.sign(b"m%d" % i))
             for i, s in enumerate((alice, carol))]
    forger = forge(alice, IdemixSigningIdentity)
    items.append(forger.verify_item(b"forged", forger.sign(b"forged")))
    items.append(alice.verify_item(b"other", alice.sign(b"x")))
    items.append(VerifyItem(items[1].scheme, items[1].pubkey,
                            items[0].signature, items[1].payload))
    items.append(VerifyItem(items[0].scheme, items[0].pubkey, b"\x01\x02",
                            items[0].payload))
    labels = [True] * 2 + [False] * 4
    return items, labels


def test_providers_match_reference_on_red_green(corpus):
    items, labels = corpus
    prov = CudaProvider(device="cpu")
    got = prov.batch_verify(items)
    assert got.tolist() == labels
    # the two valid presentations and the forged credential pass every
    # host check and reach the pairing check, in one launch across both
    # issuers; the other payload, the swap (its non-revocation proof is
    # bound to the other issuer's epoch key) and garbage do not, by the
    # port's host checks and by the reference's
    reach = [True] * 3 + [False] * 3
    assert [collect_item_parts(it)[0] for it in items] == reach
    assert [ref_collect(RefItem(*it))[0] for it in items] == reach
    assert prov.stats["dispatches"] == 1
    assert prov.stats["device_sigs"] == reach.count(True)
    assert prov.stats["fallbacks"] == 0
    assert len(prov._idemix_slots) == 2           # g2 + two issuers' w
    assert tuple(prov._idemix_lines.shape) == (3, 137, 2, 2, 8)
    assert SoftwareProvider().batch_verify(items).tolist() == labels
    assert [ref_verify(RefItem(*it)) for it in items] == labels


def test_block_with_idemix_creators_matches_reference(ref_world, tmp_path):
    """Creators: a reference idemix signer, a forged credential of the
    same issuer (only the pairing check catches it) and an X.509 client;
    endorsers X.509 Org1 under OR('Org1.member').  The reference's SW
    stack and the port's stack on the CUDA provider (the plain KB8 on
    the CPU) commit the same bytes."""
    d, out, alice = ref_world
    org1 = DevOrg("Org1")
    rws = TxRwSet((NsRwSet("cc", writes=(KVWrite("k", b"v"),)),))
    creators = [alice, forge(alice, RefSigner), org1.new_identity("client")]
    envs = [build.endorser_tx("ch", "cc", "1.0", rws, c,
                              [org1.new_identity("e1")]) for c in creators]
    raw = build.new_block(0, b"\x00" * 32, envs).serialize()

    ref_policies = RefPolicies()
    ref_policies.set_policy("cc", ref_parse_policy(POLICY))
    ref_ledger = RefLedger("ch")
    ref = RefCommitter(ref_ledger, RefValidator(
        "ch", {"Org1": RefCachedMSP(org1.msp()),
               "IdemixOrg": RefIdemixMSP(out["config"])},
        ref_init(RefOpts(default="SW")), ref_policies))
    ref_codes = [int(c) for c in ref.store_block(
        Block.deserialize(raw)).final_flags.codes()]
    assert ref_codes == [0, 4, 0]

    config = gen.load_msp_config(str(d / "msp_config.bin"))
    for provider in (CudaProvider(device="cpu"),):
        policies = PolicyRegistry()
        policies.set_policy("cc", parse_policy(POLICY))
        ledger = KVLedger("ch")
        msps = {"Org1": CachedMSP(MSP(MSPConfig(
                    **dataclasses.asdict(org1.msp_config())))),
                "IdemixOrg": IdemixMSP(config)}
        port = Committer(ledger, TxValidator("ch", msps, provider, policies))
        res = port.store_block(wire.parse_block(raw))
        assert [int(c) for c in res.final_flags.codes()] == ref_codes
        assert ledger.commit_hash == ref_ledger.commit_hash
        assert ledger.get_state("cc", "k") == ref_ledger.get_state("cc", "k")
        assert provider.stats["fallbacks"] == 0

