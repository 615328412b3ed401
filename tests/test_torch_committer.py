"""The port's block path (fabric_tpu_torch: parse -> collect -> verify ->
gate -> MVCC -> commit) against the reference's, on the CPU.

Every corpus of tests/test_device_validate.py is committed through four
stacks: the reference with device validation off (host gate + serial
MVCC) and on (its jitted program, single-device as ROADMAP C1
prescribes), and the port with it off and on (KV7's plain version).  The
envelopes are built once, by the reference, and every stack commits the
same block bytes: the reference's stacks as protocol Blocks, the port's
as zero-copy BlockViews (the peer's deliver path).  Each side's MSPs are
built from the same org CA certs, and each side verifies signatures with
its own software provider.  The four must agree on the final flags, the
metadata flags, the state rows, the history rows and the commit hash,
and the two device stacks on their demotion reasons.

Also here: the port's stack in its lite certificate mode (no
`cryptography`, as on the GPU hosts), host path against device path; a
failed build of a native extension raises; and the reference's and the
port's `_fastcollect` side by side in one process."""
import dataclasses
import json
import random
import subprocess
import sys
from pathlib import Path

import pytest

import jax

from fabric_tpu.bccsp.factory import FactoryOpts as RefOpts
from fabric_tpu.bccsp.factory import init_factories as ref_init
from fabric_tpu.committer import Committer as RefCommitter
from fabric_tpu.committer import PolicyRegistry as RefPolicies
from fabric_tpu.committer import TxValidator as RefValidator
from fabric_tpu.committer.device_validate import DeviceValidator as RefDV
from fabric_tpu.ledger import KVLedger as RefLedger
from fabric_tpu.ledger import LedgerConfig as RefLedgerConfig
from fabric_tpu.msp import CachedMSP as RefCachedMSP
from fabric_tpu.msp.ca import DevOrg
from fabric_tpu.ops_plane import registry
from fabric_tpu.policy import parse_policy as ref_parse_policy
from fabric_tpu.protocol import (Block, Envelope, KVRead, KVWrite, NsRwSet,
                                 RangeQueryInfo, TxRwSet, ValidationCode,
                                 Version, block_header_hash)
from fabric_tpu.protocol import build
from fabric_tpu.protocol.types import META_TXFLAGS
from fabric_tpu_torch import native
from fabric_tpu_torch.bccsp import FactoryOpts, init_factories
from fabric_tpu_torch.committer import Committer, PolicyRegistry, TxValidator
from fabric_tpu_torch.committer import device_validate as port_dv
from fabric_tpu_torch.committer.device_validate import DeviceValidator
from fabric_tpu_torch.ledger import KVLedger, LedgerConfig
from fabric_tpu_torch.msp import MSP, CachedMSP, MSPConfig
from fabric_tpu_torch.policy import parse_policy
from fabric_tpu_torch.protocol import wire

REPO = Path(__file__).resolve().parents[1]
POLICY = "AND('Org1.member', 'Org2.member')"
REASONS = port_dv.DEMOTION_REASONS
KINDS = ("ref_host", "ref_dev", "port_host", "port_dev")


@pytest.fixture(scope="module", autouse=True)
def providers():
    return (ref_init(RefOpts(default="SW")),
            init_factories(FactoryOpts(default="SW")))


@pytest.fixture(scope="module")
def orgs():
    return DevOrg("Org1"), DevOrg("Org2")


def rw(reads=(), writes=(), ranges=(), ns="cc"):
    return TxRwSet((NsRwSet(ns, reads=tuple(reads), writes=tuple(writes),
                            range_queries=tuple(ranges)),))


def make_tx(orgs, rwset, endorsers=None, creator=None):
    org1, org2 = orgs
    endorsers = endorsers or [org1.new_identity("e1"),
                              org2.new_identity("e2")]
    return build.endorser_tx("ch", "cc", "1.0", rwset,
                             creator or org1.new_identity("client"),
                             endorsers)


def seed_block(orgs, n=8):
    """Block 0: put k00..k{n-1} = b"v0"."""
    return [make_tx(orgs, rw(writes=[KVWrite(f"k{i:02d}", b"v0")]))
            for i in range(n)]


def chain(env_blocks):
    """The blocks' wire bytes, numbered and hash-chained from 0."""
    raws, prev = [], b"\x00" * 32
    for num, envs in enumerate(env_blocks):
        block = build.new_block(num, prev, envs)
        prev = block_header_hash(block.header)
        raws.append(block.serialize())
    return raws


def _ref_demotions():
    out = {}
    for r in REASONS:
        try:
            out[r] = registry.counter(
                "validator_device_demotions_total").value(
                    channel="ch", reason=r)
        except Exception:
            out[r] = 0.0
    return out


def make_stack(kind, providers, orgs):
    """-> (committer, device validator or None)."""
    ref_sw, port_sw = providers
    device = kind.endswith("_dev")
    if kind.startswith("ref"):
        msps = {o.mspid: RefCachedMSP(o.msp()) for o in orgs}
        policies = RefPolicies()
        policies.set_policy("cc", ref_parse_policy(POLICY))
        ledger = RefLedger("ch", RefLedgerConfig(device_validate=device))
        dv = None
        if device:
            dv = RefDV(ledger.statedb, "ch", devices=[jax.devices()[0]])
            ledger.set_prepared_source(dv.take_prepared)
        return RefCommitter(ledger, RefValidator(
            "ch", msps, ref_sw, policies, device_validate=dv)), dv
    msps = {o.mspid: CachedMSP(MSP(MSPConfig(
        **dataclasses.asdict(o.msp_config())))) for o in orgs}
    policies = PolicyRegistry()
    policies.set_policy("cc", parse_policy(POLICY))
    ledger = KVLedger("ch", LedgerConfig(device_validate=device))
    dv = None
    if device:
        dv = DeviceValidator(ledger.statedb, "ch", device="cpu")
        ledger.set_prepared_source(dv.take_prepared)
    return Committer(ledger, TxValidator(
        "ch", msps, port_sw, policies, device_validate=dv)), dv


def state_of(ledger):
    return sorted(
        (k, None if vv is None else
         (vv.value, vv.version.block_num, vv.version.tx_num))
        for k, vv in ledger.statedb._data.items())


def history_of(ledger):
    h = ledger.historydb
    return {k: [(m.block_num, m.tx_num, m.txid, m.value, m.is_delete)
                for m in h.get_history(*k)]
            for k in sorted(h._index)}


def run_stack(kind, providers, orgs, raws):
    """Commit the raw blocks -> dict of what the stacks must agree on."""
    committer, dv = make_stack(kind, providers, orgs)
    before = _ref_demotions()
    blocks = []
    for raw in raws:
        block = (Block.deserialize(raw) if kind.startswith("ref")
                 else wire.parse_block(raw))
        if kind.startswith("port"):
            assert isinstance(block, wire.BlockView)
        res = committer.store_block(block)
        blocks.append((res.final_flags.codes(),
                       bytes(block.metadata.items[META_TXFLAGS])))
    lg = committer.ledger
    out = {"blocks": blocks, "hash": lg.commit_hash, "state": state_of(lg),
           "history": history_of(lg)}
    if kind == "ref_dev":
        after = _ref_demotions()
        out["demotions"] = {r: int(after[r] - before[r]) for r in REASONS}
    elif kind == "port_dev":
        st = dv.stats
        out["demotions"] = dict(st["validator_device_demotions_total"])
        out["device_blocks"] = st["validator_device_blocks_total"]
        assert st["validator_device_dispatches_total"] == \
            st["validator_device_blocks_total"]
        assert st["validator_device_stash_misses_total"] == 0
    return out


def assert_four_way(providers, orgs, env_blocks, *, device_blocks=None,
                    demotions=None):
    """All four stacks over the same bytes; -> the per-block codes."""
    raws = chain(env_blocks)
    res = {k: run_stack(k, providers, orgs, raws) for k in KINDS}
    base = res["ref_host"]
    for k in KINDS[1:]:
        for key in ("blocks", "hash", "state", "history"):
            assert res[k][key] == base[key], (k, key)
    assert res["port_dev"]["demotions"] == res["ref_dev"]["demotions"]
    if demotions is not None:
        want = dict.fromkeys(REASONS, 0)
        want.update(demotions)
        assert res["port_dev"]["demotions"] == want
    if device_blocks is not None:
        assert res["port_dev"]["device_blocks"] == device_blocks
    return [codes for codes, _meta in base["blocks"]]


V = int(ValidationCode.VALID)
MVCC = int(ValidationCode.MVCC_READ_CONFLICT)
PHANTOM = int(ValidationCode.PHANTOM_READ_CONFLICT)
POLICY_FAIL = int(ValidationCode.ENDORSEMENT_POLICY_FAILURE)
BADSIG = int(ValidationCode.BAD_CREATOR_SIGNATURE)


# the corpora: orgs -> the blocks' envelopes (block 0 first); the
# classic-tail tests (test_torch_classic.py) run each of them too


def corpus_ww_chain(orgs):
    envs1 = [make_tx(orgs, rw(reads=[KVRead("k00", Version(0, 0))],
                              writes=[KVWrite("k00", bytes([i]))]))
             for i in range(5)]
    return [seed_block(orgs), envs1]


def corpus_delete_then_read(orgs):
    envs1 = [make_tx(orgs, rw(writes=[KVWrite("k01", b"", True)]))]
    envs2 = [
        make_tx(orgs, rw(reads=[KVRead("k01", Version(0, 1))])),
        make_tx(orgs, rw(reads=[KVRead("k01", None)],
                         writes=[KVWrite("k01", b"back")])),
        make_tx(orgs, rw(reads=[KVRead("k02", Version(0, 2))],
                         writes=[KVWrite("k02", b"", True)])),
        make_tx(orgs, rw(reads=[KVRead("k02", Version(0, 2))])),
    ]
    return [seed_block(orgs), envs1, envs2]


def corpus_phantom_range(orgs):
    seed = seed_block(orgs, 4)
    ok_set = tuple(KVRead(f"k{i:02d}", Version(0, i)) for i in range(3))
    envs1 = [
        make_tx(orgs, rw(ranges=[RangeQueryInfo("k00", "k03", True,
                                                ok_set)])),
        make_tx(orgs, rw(ranges=[RangeQueryInfo("k00", "k03", True,
                                                ok_set[:2])])),
    ]
    envs2 = [make_tx(orgs, rw(writes=[KVWrite("k09", b"x")]))]
    return [seed, envs1, envs2]


def corpus_hash_collision(orgs):
    envs0 = [make_tx(orgs, rw(writes=[KVWrite("ab", b"1")])),
             make_tx(orgs, rw(writes=[KVWrite("bA", b"2")]))]
    envs1 = [make_tx(orgs, rw(reads=[KVRead("ab", Version(0, 0)),
                                     KVRead("bA", Version(0, 1))],
                              writes=[KVWrite("k05", b"x")]))]
    return [envs0, envs1]


def corpus_zero_and_full_conflict(orgs):
    envs_ok = [make_tx(orgs, rw(reads=[KVRead(f"k{i:02d}", Version(0, i))],
                                writes=[KVWrite(f"k{i:02d}", b"v1")]))
               for i in range(6)]
    envs_bad = [make_tx(orgs, rw(reads=[KVRead(f"k{i:02d}", Version(9, 9))]))
                for i in range(6)]
    return [seed_block(orgs), envs_ok, envs_bad]


def corpus_policy_and_signature_failures(orgs):
    org1, _org2 = orgs
    good = make_tx(orgs, rw(reads=[KVRead("k00", Version(0, 0))],
                            writes=[KVWrite("k00", b"a")]))
    only1 = make_tx(orgs, rw(reads=[KVRead("k00", Version(0, 0))],
                             writes=[KVWrite("k00", b"b")]),
                    endorsers=[org1.new_identity("e")])
    bad = make_tx(orgs, rw(writes=[KVWrite("k01", b"c")]))
    bad = Envelope(bad.payload, bad.signature[:-2] + b"\x00\x01")
    chaser = make_tx(orgs, rw(reads=[KVRead("k00", Version(0, 0))],
                              writes=[KVWrite("k00", b"d")]))
    return [seed_block(orgs), [good, only1, bad, chaser]]


def corpus_garbage_endorser_payload(orgs):
    org1, _ = orgs
    junk = build.signed_envelope("endorser_transaction", "ch",
                                 {"not": "a tx"}, org1.new_identity("j"))
    good = make_tx(orgs, rw(writes=[KVWrite("k07", b"g")]))
    return [[good, junk]]


def corpus_seeded_random(orgs):
    rng = random.Random(0xFAB11)
    keys = [f"k{i:02d}" for i in range(8)]
    env_blocks = [seed_block(orgs, 8)]
    committed = {k: Version(0, i) for i, k in enumerate(keys)}
    for blk in (1, 2, 3):
        envs = []
        for _tx in range(8):
            reads, writes = [], []
            for k in rng.sample(keys, rng.randint(0, 3)):
                choice = rng.random()
                if choice < 0.5:
                    ver = committed.get(k)
                elif choice < 0.75:
                    ver = Version(rng.randint(0, 3), rng.randint(0, 7))
                else:
                    ver = None
                reads.append(KVRead(k, ver))
            for k in rng.sample(keys, rng.randint(0, 2)):
                if rng.random() < 0.25:
                    writes.append(KVWrite(k, b"", True))
                else:
                    writes.append(KVWrite(k, bytes([blk, rng.randint(0, 9)])))
            envs.append(make_tx(orgs, rw(reads=reads, writes=writes)))
        env_blocks.append(envs)
    return env_blocks


CORPORA = {"ww_chain": corpus_ww_chain,
           "delete_then_read": corpus_delete_then_read,
           "phantom_range": corpus_phantom_range,
           "hash_collision": corpus_hash_collision,
           "zero_and_full_conflict": corpus_zero_and_full_conflict,
           "policy_and_signature_failures":
               corpus_policy_and_signature_failures,
           "garbage_endorser_payload": corpus_garbage_endorser_payload,
           "seeded_random": corpus_seeded_random}


def test_ww_chain_same_key(providers, orgs):
    codes = assert_four_way(providers, orgs, corpus_ww_chain(orgs),
                            device_blocks=2, demotions={})
    assert codes[1] == [V, MVCC, MVCC, MVCC, MVCC]


def test_delete_then_read(providers, orgs):
    codes = assert_four_way(providers, orgs, corpus_delete_then_read(orgs),
                            device_blocks=3, demotions={})
    assert codes[2] == [MVCC, V, V, MVCC]


def test_phantom_range_query_demotes(providers, orgs):
    codes = assert_four_way(providers, orgs, corpus_phantom_range(orgs),
                            device_blocks=2,
                            demotions={"range_query": 1})
    assert codes[1] == [V, PHANTOM]


def test_engineered_hash_collision_demotes(providers, orgs):
    """djb2-64("ab") == djb2-64("bA"): the lanes flag the collision and
    the block demotes, never a wrong verdict."""
    codes = assert_four_way(providers, orgs, corpus_hash_collision(orgs),
                            device_blocks=0,
                            demotions={"hash_collision": 2})
    assert codes == [[V, V], [V]]


def test_zero_and_full_conflict(providers, orgs):
    codes = assert_four_way(providers, orgs,
                            corpus_zero_and_full_conflict(orgs),
                            device_blocks=3, demotions={})
    assert codes[1] == [V] * 6
    assert codes[2] == [MVCC] * 6


def test_policy_and_signature_failures(providers, orgs):
    codes = assert_four_way(
        providers, orgs, corpus_policy_and_signature_failures(orgs),
        device_blocks=2, demotions={})
    assert codes[1] == [V, POLICY_FAIL, BADSIG, MVCC]


def test_garbage_endorser_payload(providers, orgs):
    codes = assert_four_way(providers, orgs,
                            corpus_garbage_endorser_payload(orgs),
                            demotions={})
    assert codes[0][0] == V
    assert codes[0][1] != V


def test_seeded_random_blocks(providers, orgs):
    assert_four_way(providers, orgs, corpus_seeded_random(orgs),
                    device_blocks=4, demotions={})


def test_stash_miss_falls_back(providers, orgs):
    """Flags tampered between validate and commit: the prepared batch is
    discarded and host MVCC runs with the tampered flags, on both
    sides."""
    raw = chain([seed_block(orgs, 3)])[0]
    for kind in ("ref_dev", "port_dev"):
        committer, dv = make_stack(kind, providers, orgs)
        block = (Block.deserialize(raw) if kind == "ref_dev"
                 else wire.parse_block(raw))
        res = committer.validator.validate(block)
        assert res.flags.codes() == [V] * 3
        block.metadata.items[META_TXFLAGS] = bytes([255] * 3)
        committer.ledger.commit(block)
        assert committer.ledger.get_state("cc", "k00") is None
    assert dv.stats["validator_device_stash_misses_total"] == 1


def test_kv7_error_propagates(providers, orgs, monkeypatch):
    """An error of the kernel step is not a demotion: it leaves run()
    (the reference would demote it as reason `error`), while a failing
    host step still demotes."""
    from fabric_tpu_torch.ops import block_validate as kv7
    raws = chain([seed_block(orgs, 2)])

    def boom(*a, **k):
        raise RuntimeError("block_validate launch failed: CUDA error 1")

    committer, dv = make_stack("port_dev", providers, orgs)
    monkeypatch.setattr(kv7, "block_validate", boom)
    with pytest.raises(RuntimeError, match="launch failed"):
        committer.store_block(wire.parse_block(raws[0]))
    assert dv.stats["validator_device_dispatches_total"] == 1
    monkeypatch.undo()

    committer, dv = make_stack("port_dev", providers, orgs)
    monkeypatch.setattr(DeviceValidator, "_gather_committed",
                        staticmethod(boom))
    res = committer.store_block(wire.parse_block(raws[0]))
    assert res.final_flags.codes() == [V, V]
    assert dv.stats["validator_device_demotions_total"]["error"] == 1
    assert dv.stats["validator_device_dispatches_total"] == 0


LITE_SCRIPT = r"""
import json, sys
sys.modules["cryptography"] = None          # as on the GPU hosts
from fabric_tpu_torch import crypto
assert not crypto.HAVE_CRYPTOGRAPHY
from fabric_tpu_torch.bccsp import FactoryOpts, init_factories
from fabric_tpu_torch.committer import Committer, PolicyRegistry, TxValidator
from fabric_tpu_torch.committer.device_validate import DeviceValidator
from fabric_tpu_torch.ledger import KVLedger, LedgerConfig
from fabric_tpu_torch.msp import CachedMSP
from fabric_tpu_torch.msp.ca import DevOrg
from fabric_tpu_torch.policy import parse_policy
from fabric_tpu_torch.protocol import (Envelope, KVRead, KVWrite, NsRwSet,
                                       TxRwSet, Version, block_header_hash,
                                       build, wire)
from fabric_tpu_torch.protocol.types import META_TXFLAGS
sw = init_factories(FactoryOpts(default="SW"))
orgs = [DevOrg("Org1"), DevOrg("Org2")]
assert b"FABRICTPU" in orgs[0].root.cert_pem()      # lite certs

def rw(reads=(), writes=()):
    return TxRwSet((NsRwSet("cc", reads=tuple(reads), writes=tuple(writes),
                            range_queries=()),))

def tx(r, endorsers=None):
    return build.endorser_tx(
        "ch", "cc", "1.0", r, orgs[0].new_identity("c"),
        endorsers or [orgs[0].new_identity("e1"), orgs[1].new_identity("e2")])

b0 = [tx(rw(writes=[KVWrite(f"k{i}", b"v")])) for i in range(4)]
b1 = [tx(rw(reads=[KVRead("k0", Version(0, 0))], writes=[KVWrite("k0", b"a")])),
      tx(rw(reads=[KVRead("k0", Version(0, 0))], writes=[KVWrite("k0", b"b")])),
      tx(rw(writes=[KVWrite("k1", b"", True)]), [orgs[0].new_identity("e")]),
      tx(rw(reads=[KVRead("k2", Version(0, 2))], writes=[KVWrite("k2", b"", True)])),
      tx(rw(reads=[KVRead("k2", None)]))]
bad = tx(rw(writes=[KVWrite("k3", b"x")]))
b1.append(Envelope(bad.payload, bad.signature[:-2] + b"\x00\x01"))
raws, prev = [], b"\x00" * 32
for num, envs in enumerate((b0, b1)):
    block = build.new_block(num, prev, envs)
    prev = block_header_hash(block.header)
    raws.append(block.serialize())
out = {}
for device in (False, True):
    msps = {o.mspid: CachedMSP(o.msp()) for o in orgs}
    pol = PolicyRegistry()
    pol.set_policy("cc", parse_policy("AND('Org1.member', 'Org2.member')"))
    lg = KVLedger("ch", LedgerConfig(device_validate=device))
    dv = None
    if device:
        dv = DeviceValidator(lg.statedb, "ch", device="cpu")
        lg.set_prepared_source(dv.take_prepared)
    c = Committer(lg, TxValidator("ch", msps, sw, pol, device_validate=dv))
    codes = [c.store_block(wire.parse_block(r)).final_flags.codes()
             for r in raws]
    state = sorted((list(k), None if v is None else
                    [v.value.hex(), v.version.block_num, v.version.tx_num])
                   for k, v in lg.statedb._data.items())
    out[str(device)] = {"codes": codes, "hash": lg.commit_hash.hex(),
                        "state": state,
                        "blocks": dv and dv.stats["validator_device_blocks_total"]}
print(json.dumps(out))
"""


def test_lite_certificate_mode_host_and_device_agree():
    """Without `cryptography` the port's MSP mints and reads lite certs;
    a whole stack runs on them, host path and device path alike."""
    proc = subprocess.run([sys.executable, "-c", LITE_SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    host, dev = out["False"], out["True"]
    assert host["codes"] == dev["codes"] == [
        [V] * 4, [V, MVCC, POLICY_FAIL, V, V, BADSIG]]
    assert host["hash"] == dev["hash"]
    assert host["state"] == dev["state"]
    assert dev["blocks"] == 2


def test_failed_native_build_raises(monkeypatch, tmp_path):
    """No fallback: a compiler failure raises from every build entry."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "find_cc", lambda: "false")
    for name in native.EXTENSIONS:
        with pytest.raises(RuntimeError, match=f"cc failed for {name}.c"):
            native.build_extension(name)
    with pytest.raises(RuntimeError, match="cc failed for der.c"):
        native.build("der")
    assert not list(tmp_path.iterdir())


def test_two_fastcollect_builds_side_by_side(orgs):
    """The reference's and the port's `_fastcollect` are distinct
    modules with their own C statics; on the same block they digest to
    the same codes, txids and identities, in either order."""
    from fabric_tpu.native import load as ref_load
    ref_fc = ref_load("_fastcollect")
    port_fc = native.extension("fastcollect")
    assert ref_fc is not port_fc
    assert port_fc.__name__ == "fabric_tpu_torch.native._fastcollect"
    assert Path(port_fc.__file__).parent == native.BUILD_DIR
    envs = seed_block(orgs, 6)
    envs.append(envs[2])                            # a duplicate txid
    data = build.new_block(0, b"\x00" * 32, envs).data
    outs = []
    for fc in (ref_fc, port_fc, ref_fc):
        codes, seen, works, creators, endorsers = fc.digest(
            data, "ch", [], None)
        outs.append((bytes(codes), sorted(seen.items()), len(works),
                     list(creators), list(endorsers)))
    assert outs[0] == outs[1] == outs[2]
    assert outs[0][0][-1] == int(ValidationCode.DUPLICATE_TXID)
