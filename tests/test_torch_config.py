"""The port's channel-config plane (fabric_tpu_torch.config and the
committer's commit-time config-block application) against the
reference's, on the CPU.

Ports of tests/test_channelconfig.py (bundles, the sequence and Admins
rules) and tests/test_committer.py's config-tx tests (authorized,
unauthorized, in a multi-tx block, replayed), each parametrised over
both packages and, on the port's case, held equal to the reference's
outcome: flags, bundle sequence, ledger state and commit hash, and the
ledger directory with its `confighistory.bin` byte for byte.  The
reference's orderer-side tests (admission, rotation through a solo
chain) have no counterpart: the orderer is not ported; the rotation is
checked at commit here instead, Org2's txs refused and Org3's admitted
once the config block commits.  Config envelopes are built once, by
the reference, from the reference's DevOrgs; the port's configs are
built from the same certificates and serialize to the same bytes.

The bulk runs on each package's software provider; one case runs the
port's CUDA provider on the CPU (its lanes' plain versions, a few
seconds a call) for the Admins signatures of a config update."""
import importlib
import os

import pytest

from fabric_tpu.msp.ca import DevOrg
from fabric_tpu.protocol import KVWrite

from test_torch_ledger_durable import (PKGS, chain, commit_raws, dir_bytes,
                                       differential, ledger_view, load,
                                       parse, rw)


@pytest.fixture(scope="module")
def pk():
    return {name: load(name) for name in PKGS}


@pytest.fixture(scope="module")
def devs():
    return DevOrg("Org1"), DevOrg("Org2"), DevOrg("Org3")


def cfgmod(P):
    return importlib.import_module(
        "fabric_tpu.config" if P.name == "ref" else "fabric_tpu_torch.config")


def org_config(C, dev):
    mc = dev.msp_config()
    return C.OrgConfig(mspid=dev.mspid,
                       root_certs=tuple(mc.root_certs_pem),
                       admins=tuple(mc.admin_certs_pem),
                       intermediate_certs=tuple(mc.intermediate_certs_pem),
                       crls=tuple(mc.crls_pem))


def make_config(C, channel_id, devs, sequence):
    return C.ChannelConfig(
        channel_id=channel_id, sequence=sequence,
        orgs=tuple(org_config(C, d) for d in devs),
        policies=C.default_policies([d.mspid for d in devs]))


def envelope(devs, orgs, sequence, signers, channel_id="ch"):
    """A config envelope built by the reference."""
    from fabric_tpu import config as ref_cfg
    return ref_cfg.build_config_envelope(
        make_config(ref_cfg, channel_id, orgs, sequence), signers)


# ---------------------------------------------------------------------------
# tests/test_channelconfig.py
# ---------------------------------------------------------------------------

def _bundle(P, devs):
    C = cfgmod(P)
    o1, o2, _ = devs
    cfg = make_config(C, "ch", [o1, o2], 0)
    b = C.Bundle(cfg)
    assert set(b.msps) == {"Org1", "Org2"}
    assert b.policy("Admins") is not None
    assert b.has_capability("V2_0")
    assert C.ChannelConfig.deserialize(
        cfg.serialize()).to_dict() == cfg.to_dict()
    return cfg.serialize(), b.policy("Admins").serialize()


@pytest.mark.parametrize("pkg", PKGS)
def test_bundle_materializes_msps_and_policies(pk, pkg, devs):
    differential(pk, pkg, lambda P: _bundle(P, devs))


@pytest.fixture(scope="module")
def update_envs(devs):
    o1, o2, o3 = devs
    return {
        "good": envelope(devs, [o1, o2, o3], 1, [o1.admin, o2.admin]),
        "bad_seq": envelope(devs, [o1, o2, o3], 5, [o1.admin, o2.admin]),
        "under": envelope(devs, [o1, o2, o3], 1, [o1.admin]),
        "member": envelope(devs, [o1, o2, o3], 1,
                           [o1.new_identity("m"), o2.new_identity("m2")]),
    }


def _update_rules(P, devs, envs):
    C = cfgmod(P)
    Env = importlib.import_module(
        f"{'fabric_tpu' if P.name == 'ref' else 'fabric_tpu_torch'}"
        ".protocol").Envelope
    o1, o2, _ = devs
    src = C.BundleSource(C.Bundle(make_config(C, "ch", [o1, o2], 0)))

    def run(name):
        env = Env.deserialize(envs[name].serialize())
        try:
            return C.validate_config_update(src.current(), env, P.provider)
        except C.ConfigError as exc:
            return str(exc)

    got = run("good")
    assert [o.mspid for o in got.orgs] == ["Org1", "Org2", "Org3"]
    out = {"good": got.serialize()}
    for name, match in (("bad_seq", "sequence"), ("under", "Admins"),
                        ("member", "Admins")):
        out[name] = run(name)
        assert match in out[name], name
    src.update(C.Bundle(got))
    with pytest.raises(C.ConfigError, match="regression"):
        src.update(C.Bundle(make_config(C, "ch", [o1], 1)))
    return out


@pytest.mark.parametrize("pkg", PKGS)
def test_config_update_sequence_and_admins(pk, pkg, devs, update_envs):
    differential(pk, pkg, lambda P: _update_rules(P, devs, update_envs))


# ---------------------------------------------------------------------------
# tests/test_committer.py: config txs at commit
# ---------------------------------------------------------------------------

def config_world(P, devs, root, orgs_n=1, provider=None, history=False):
    """test_committer.py's _config_world on a durable ledger: Org1 (or
    Org1..Org<orgs_n>) at sequence 0, OR('Org1.member') on cc."""
    C = cfgmod(P)
    src = C.BundleSource(C.Bundle(make_config(C, "ch", devs[:orgs_n], 0)))
    policies = P.PolicyRegistry(P.parse_policy("OR('Org1.member')"))
    ledger = P.KVLedger("ch", P.LedgerConfig(root=root))
    validator = P.TxValidator("ch", None, provider or P.provider, policies,
                              bundle_source=src)
    ch = None
    if history:
        ch = P.ConfigHistory(os.path.join(root, "ch", "confighistory"))
    committer = P.Committer(ledger, validator, bundle_source=src,
                            provider=provider or P.provider,
                            confighistory=ch)
    return src, committer


@pytest.fixture(scope="module")
def commit_txs(devs):
    """test_unauthorized_config_tx_flagged_invalid_at_commit's three
    blocks, then test_config_tx_in_multi_tx_block_invalid's, chained."""
    from fabric_tpu.protocol import build
    o1 = devs[0]
    bad = envelope(devs, [o1], 5, [o1.admin])
    member = envelope(devs, [o1], 1, [o1.new_identity("m")])
    good = envelope(devs, [o1], 1, [o1.admin])
    normal = build.endorser_tx("ch", "cc", "1.0",
                               rw(writes=[KVWrite("k", b"v")]),
                               o1.new_identity("client"),
                               [o1.new_identity("e1")])
    return {"sequence": chain([[bad], [member], [good]]),
            "multi": chain([[normal, good]]),
            "replay": chain([[good]])}


def _unauthorized(P, devs, raws, root):
    src, committer = config_world(P, devs, root, history=True)
    VC = P.ValidationCode
    out = []
    for raw, seq in zip(raws, (0, 0, 1)):
        res = committer.store_block(parse(P, raw))
        out.append(res.final_flags.codes())
        assert src.current().sequence == seq
    assert out[0] == out[1] == [int(VC.INVALID_CONFIG_TRANSACTION)]
    assert out[2] == [int(VC.VALID)]
    assert committer.confighistory.latest_height() == 2
    return out, ledger_view(committer.ledger), dir_bytes(root)


@pytest.mark.parametrize("pkg", PKGS)
def test_unauthorized_config_tx_flagged_invalid_at_commit(pk, pkg, devs,
                                                          commit_txs,
                                                          tmp_path):
    differential(pk, pkg, lambda P: _unauthorized(
        P, devs, commit_txs["sequence"], str(tmp_path / P.name)))


def _multi_tx(P, devs, raws, root):
    src, committer = config_world(P, devs, root)
    res = committer.store_block(parse(P, raws[0]))
    assert res.final_flags.is_valid(0)
    assert (res.final_flags.flag(1)
            == P.ValidationCode.INVALID_CONFIG_TRANSACTION)
    assert src.current().sequence == 0
    return res.final_flags.codes(), ledger_view(committer.ledger)


@pytest.mark.parametrize("pkg", PKGS)
def test_config_tx_in_multi_tx_block_invalid(pk, pkg, devs, commit_txs,
                                             tmp_path):
    differential(pk, pkg, lambda P: _multi_tx(
        P, devs, commit_txs["multi"], str(tmp_path / P.name)))


def _replay(P, devs, raws, base):
    C = cfgmod(P)
    src, committer = config_world(P, devs, os.path.join(base, "a"))
    res = committer.store_block(parse(P, raws[0]))
    assert res.final_flags.is_valid(0) and src.current().sequence == 1
    src2, committer2 = config_world(P, devs, os.path.join(base, "b"))
    src2.update(C.Bundle(make_config(C, "ch", devs[:1], 1)))
    res2 = committer2.store_block(parse(P, raws[0]))
    assert res2.final_flags.is_valid(0)
    assert src2.current().sequence == 1
    assert src2.config_height == 0
    return (res.final_flags.codes(), res2.final_flags.codes(),
            ledger_view(committer2.ledger))


@pytest.mark.parametrize("pkg", PKGS)
def test_config_block_replay_keeps_valid_flags(pk, pkg, devs, commit_txs,
                                               tmp_path):
    differential(pk, pkg, lambda P: _replay(
        P, devs, commit_txs["replay"], str(tmp_path / P.name)))


# ---------------------------------------------------------------------------
# rotation at commit, a stale sequence above config_height, and the
# config history across a reopen
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rotation(devs):
    """Block 0: Org2 and Org3 each endorse a tx (Org1 + Org2 at sequence
    0).  Block 1: the config tx rotating Org2 -> Org3 (sequence 1, Org1
    and Org2 admins).  Block 2: the same two kinds of tx again.  Block
    3: another update at sequence 1 (Org1, Org2 and Org3), a stale
    sequence in a new block."""
    from fabric_tpu.protocol import build
    o1, o2, o3 = devs

    def tx(dev, key):
        return build.endorser_tx("ch", "cc", "1.0",
                                 rw(writes=[KVWrite(key, b"v")]),
                                 dev.new_identity("client"),
                                 [dev.new_identity("peer0")])

    cfg = envelope(devs, [o1, o3], 1, [o1.admin, o2.admin])
    stale = envelope(devs, [o1, o2, o3], 1, [o1.admin, o2.admin])
    return chain([[tx(o2, "a2"), tx(o3, "a3")], [cfg],
                  [tx(o2, "b2"), tx(o3, "b3")], [stale]])


def _rotation(P, devs, raws, root):
    C = cfgmod(P)
    VC = P.ValidationCode
    src = C.BundleSource(C.Bundle(make_config(C, "ch", devs[:2], 0)))
    policies = P.PolicyRegistry(P.parse_policy(
        "OR('Org1.member', 'Org2.member', 'Org3.member')"))

    def open_stack():
        ledger = P.KVLedger("ch", P.LedgerConfig(root=root))
        ch = P.ConfigHistory(os.path.join(root, "ch", "confighistory"))
        validator = P.TxValidator("ch", None, P.provider, policies,
                                  bundle_source=src)
        return P.Committer(ledger, validator, bundle_source=src,
                           provider=P.provider, confighistory=ch)

    committer = open_stack()
    seen = []
    committer.add_commit_listener(
        lambda block, flags: seen.append((block.header.number,
                                          flags.codes())))
    codes = commit_raws(P, committer, raws)
    assert codes[0][0] == codes[2][1] == int(VC.VALID)
    assert codes[0][1] != int(VC.VALID) and codes[2][0] != int(VC.VALID)
    assert codes[1] == [int(VC.VALID)]
    assert codes[3] == [int(VC.INVALID_CONFIG_TRANSACTION)]
    assert set(src.current().msps) == {"Org1", "Org3"}
    assert src.config_height == 1
    assert seen == list(enumerate(codes))
    reopened = open_stack()
    assert reopened.confighistory.entries() == \
        committer.confighistory.entries()
    assert C.ChannelConfig.deserialize(
        reopened.confighistory.config_at(99)).sequence == 1
    assert reopened.ledger.commit_hash == committer.ledger.commit_hash
    return codes, ledger_view(reopened.ledger), dir_bytes(root)


@pytest.mark.parametrize("pkg", PKGS)
def test_config_rotation_at_commit_and_history_reopen(pk, pkg, devs,
                                                      rotation, tmp_path):
    differential(pk, pkg, lambda P: _rotation(
        P, devs, rotation, str(tmp_path / P.name)))


# ---------------------------------------------------------------------------
# the port's CUDA provider (plain lanes on the CPU) for the Admins check
# ---------------------------------------------------------------------------

def test_config_update_admins_on_cuda_provider(pk, devs, commit_txs,
                                               tmp_path):
    """The authorized update committed through the port's
    CudaProvider(device="cpu"), after the two refused ones on the
    software provider: the config tx's creator signature (the
    validator's batch) and its Admins signature (the committer's policy
    check) each run KP2's plain version (one signature a key, no
    table); flags, sequence, state and directory equal the reference's
    on its software provider."""
    from fabric_tpu_torch.bccsp.cuda import CudaProvider
    from fabric_tpu_torch.ops import p256
    raws = commit_txs["sequence"]
    P = pk["port"]
    prov = CudaProvider(device="cpu")
    src, committer = config_world(P, devs, str(tmp_path / "port"),
                                  history=True)
    codes = commit_raws(P, committer, raws[:2])
    committer.validator.provider = committer.provider = prov
    calls = []
    real = p256.verify_words_plain

    def counted(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    p256.verify_words_plain = counted
    try:
        codes += commit_raws(P, committer, raws[2:])
    finally:
        p256.verify_words_plain = real
    assert len(calls) == 2, calls
    assert prov.stats["fallbacks"] == 0
    R = pk["ref"]
    rsrc, rc = config_world(R, devs, str(tmp_path / "ref"), history=True)
    assert codes == commit_raws(R, rc, raws)
    assert src.current().sequence == rsrc.current().sequence == 1
    assert ledger_view(committer.ledger) == ledger_view(rc.ledger)
    assert dir_bytes(tmp_path / "port") == dir_bytes(tmp_path / "ref")
