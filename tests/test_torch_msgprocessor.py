"""The port's message processor and block cutter (fabric_tpu_torch.orderer
.msgprocessor, .blockcutter) against the reference's, on the CPU.

One corpus, signed once by the reference's identities (Org1 P-256, Org2
Ed25519 and their admins; an org outside the channel), and its envelope
bytes decoded by each package: a good envelope of each scheme, a bad
signature, an expired certificate (the processor's clock set past every
certificate's end), an oversize envelope (the channel's AbsoluteMaxBytes
cut to 64 KiB), an empty envelope, an undecodable header, a wrong
channel, an outsider's creator, a config update signed by a majority of
the admins and one signed by a client, and the verify-once plane's
gateway attestations: an authorised attestor's digest over a bad
signature (honoured, so the SigFilter's verify is skipped), an
unauthorised attestor's (ignored), and an authorised attestor's
mismatched digest (ignored, the attestor revoked).  Both packages'
`StandardChannelProcessor` run on SW over the same channel config, each
with its own `VerdictCache` and `AttestorTrust`.

Held, case by case: the message class or the error text, the cache's
size and its lookup of the creator's item, and the attestor standing
files byte for byte.  `BlockCutter`: the same batches and pending flags
on one stream of envelopes of mixed sizes.  Tolerance: exact equality.
"""
import datetime
import json
import os

import pytest

from node_world import ROOTS, mod, sw_defaults


CHANNEL = "ch"
MAX_BYTES = 64 * 1024
FUTURE = datetime.datetime(2200, 1, 1, tzinfo=datetime.timezone.utc)



@pytest.fixture(scope="module", autouse=True)
def sw_default():
    sw_defaults()


@pytest.fixture(scope="module")
def world():
    from fabric_tpu.bccsp import SCHEME_ED25519
    from fabric_tpu.config import (BatchConfig, ChannelConfig, OrgConfig,
                                   build_config_envelope, default_policies)
    from fabric_tpu.msp.ca import DevOrg
    from fabric_tpu.protocol import Envelope, KVWrite, NsRwSet, TxRwSet, build
    from fabric_tpu.protocol.types import TX_CONFIG

    orgs = (DevOrg("Org1"), DevOrg("Org2", scheme=SCHEME_ED25519))
    outsider = DevOrg("Org9").new_identity("mallory")
    org_cfgs = []
    for o in orgs:
        mc = o.msp_config()
        org_cfgs.append(OrgConfig(o.mspid, tuple(mc.root_certs_pem),
                                  tuple(mc.admin_certs_pem)))
    cfg = ChannelConfig(channel_id=CHANNEL, sequence=0,
                        orgs=tuple(org_cfgs),
                        policies=default_policies([o.mspid for o in orgs]),
                        batch=BatchConfig(absolute_max_bytes=MAX_BYTES))
    clients = [o.new_identity("client") for o in orgs]
    peers = [o.new_identity("peer0") for o in orgs]

    def tx(signer, value=b"v", channel=CHANNEL):
        rw = TxRwSet((NsRwSet("cc", writes=(KVWrite("k", value),)),))
        return build.endorser_tx(channel, "cc", "1.0", rw, signer, [signer])

    def broken(env):
        sig = bytearray(env.signature)
        sig[-1] ^= 1
        return Envelope(env.payload, bytes(sig))

    bad = broken(tx(clients[0], b"bad"))
    cfg1 = ChannelConfig(channel_id=CHANNEL, sequence=1, orgs=cfg.orgs,
                         policies=cfg.policies, batch=cfg.batch)
    cases = {
        "good_p256": (tx(clients[0]), None),
        "good_ed25519": (tx(clients[1]), None),
        "bad_signature": (bad, None),
        "expired": (tx(clients[0], b"late"), None),
        "oversize": (tx(clients[0], b"x" * (MAX_BYTES + 1)), None),
        "empty": (Envelope(b"", b""), None),
        "undecodable": (Envelope(b"\x01garbage", b"sig"), None),
        "wrong_channel": (tx(clients[0], channel="other"), None),
        "outsider": (tx(outsider), None),
        "config_admins": (build_config_envelope(
            cfg1, [o.admin for o in orgs]), None),
        "config_client": (build.signed_envelope(
            TX_CONFIG, CHANNEL, {"config": cfg1.serialize(), "sigs": []},
            clients[0]), None),
        "attest_authorised": (broken(tx(clients[0], b"att")), 0),
        "attest_unauthorised": (broken(tx(clients[1], b"att")), 1),
        "attest_mismatch": (tx(clients[0], b"mis"), 0),
    }
    return {"orgs": orgs, "cfg": cfg.serialize(), "peers": peers,
            "cases": {k: (e.serialize(), a) for k, (e, a) in cases.items()}}


def processor(pkg, world, root, now=None):
    """Package `pkg`'s processor over the corpus's channel, on SW, with a
    VerdictCache, trust on and Org1's peer as the one attestor (its
    standing persisted under `root`)."""
    config = mod(pkg, "config")
    sw = mod(pkg, "bccsp.sw")
    vp = mod(pkg, "verify_plane")
    cluster = mod(pkg, "orderer.cluster")
    mp = mod(pkg, "orderer.msgprocessor")
    source = config.BundleSource(config.Bundle(
        config.ChannelConfig.deserialize(world["cfg"])))
    msps = source.current().msps
    peer1 = world["peers"][0]
    binding = {"mspid": peer1.mspid,
               "cert_fp": cluster.cert_fingerprint(
                   mod(pkg, "msp").deserialize_from_msps(
                       msps, peer1.serialize()).cert)}
    os.makedirs(root, exist_ok=True)
    proc = mp.StandardChannelProcessor(
        CHANNEL, msps, sw.SoftwareProvider(), None,
        now=now, bundle_source=source,
        verify_cache=vp.VerdictCache(capacity=1024, owner="orderer1"),
        trust_attestations=True, attestors=[binding],
        attestor_trust=vp.AttestorTrust(os.path.join(root, "trust.json")))
    return proc, msps


def run_case(pkg, world, name, root):
    """(verdict, cache size, the creator item's lookup, trust file)."""
    P = mod(pkg, "protocol")
    msps_mod = mod(pkg, "msp")
    vp = mod(pkg, "verify_plane")
    now = (lambda: FUTURE) if name == "expired" else None
    proc, msps = processor(pkg, world, os.path.join(root, pkg, name), now)
    raw, attestor_idx = world["cases"][name]
    env = P.Envelope.deserialize(raw)
    attest = attestor = None
    if attestor_idx is not None:
        attestor = msps_mod.deserialize_from_msps(
            msps, world["peers"][attestor_idx].serialize())
        ident = msps_mod.deserialize_from_msps(
            msps, env.header().signature_header.creator)
        item = ident.verify_item(env.payload, env.signature)
        attest = vp.item_digest(item).hex()
        if name == "attest_mismatch":
            attest = "00" * (len(attest) // 2)
    try:
        verdict = proc.process(env, attest=attest, attestor=attestor).value
    except mod(pkg, "orderer.msgprocessor").MsgProcessorError as exc:
        verdict = f"rejected: {exc}"
    lookup = None
    try:
        ident = msps_mod.deserialize_from_msps(
            msps, env.header().signature_header.creator)
        if ident is not None:
            lookup = proc.verify_cache.lookup(
                ident.verify_item(env.payload, env.signature))
    except Exception:
        lookup = "no item"
    path = os.path.join(root, pkg, name, "trust.json")
    trust = open(path, "rb").read() if os.path.exists(path) else None
    return verdict, proc.verify_cache.snapshot()["size"], lookup, trust


CASES = ("good_p256", "good_ed25519", "bad_signature", "expired",
         "oversize", "empty", "undecodable", "wrong_channel", "outsider",
         "config_admins", "config_client", "attest_authorised",
         "attest_unauthorised", "attest_mismatch")
WANT = {"good_p256": "normal", "good_ed25519": "normal",
        "bad_signature": "SigFilter", "expired": "expired",
        "oversize": "AbsoluteMaxBytes", "empty": "EmptyRejectRule",
        "undecodable": "undecodable", "wrong_channel": "sent to",
        "outsider": "undeserializable", "config_admins": "config",
        "config_client": "config update rejected",
        "attest_authorised": "normal", "attest_unauthorised": "SigFilter",
        "attest_mismatch": "normal"}


@pytest.mark.parametrize("name", CASES)
def test_processor_matches_reference(world, name, tmp_path):
    ref = run_case("ref", world, name, str(tmp_path))
    port = run_case("port", world, name, str(tmp_path))
    assert port == ref
    assert WANT[name] in ref[0]
    if name == "attest_authorised":
        # the attestation seeded the cache: a bad signature admitted
        assert ref[2] == (True, "hit") or ref[2][0] is True
    if name == "attest_mismatch":
        standing = json.loads(port[3])
        assert [v.get("revoked") for v in standing.values()] == [True]


def test_classify_matches_reference(world):
    for name in ("good_p256", "config_admins", "config_client"):
        raw = world["cases"][name][0]
        got = [mod(p, "orderer.msgprocessor").classify(
            mod(p, "protocol").Envelope.deserialize(raw)).value
            for p in ROOTS]
        assert got[0] == got[1]


def test_blockcutter_matches_reference(world):
    """One stream through both packages' BlockCutter: count cuts, the
    preferred-bytes cut, an isolated oversize envelope, and the final
    flush."""
    raws = [world["cases"][n][0] for n in
            ("good_p256", "good_ed25519", "bad_signature", "expired",
             "oversize", "outsider", "good_p256", "attest_authorised",
             "attest_mismatch", "wrong_channel")]
    out = {}
    for pkg in ROOTS:
        bc = mod(pkg, "orderer.blockcutter")
        Envelope = mod(pkg, "protocol").Envelope
        cutter = bc.BlockCutter(bc.BatchConfig(
            max_message_count=3, preferred_max_bytes=MAX_BYTES // 2))
        seen = [cutter.ordered(Envelope.deserialize(r)) for r in raws]
        seen.append((cutter.cut(), cutter.pending_count))
        out[pkg] = seen
    assert out["port"] == out["ref"]
    assert any(len(b) == 1 and len(b[0]) > MAX_BYTES
               for batches, _ in out["ref"][:-1] for b in batches)
