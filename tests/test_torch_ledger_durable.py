"""The port's durable ledger (fabric_tpu_torch.ledger: block segment
files, state and history WALs, sharded checkpoints, recovery on open,
the admin operations, the config history and the rich queries) against
the reference's, on the CPU.

Every test here is a test of tests/test_crash_recovery.py,
tests/test_ledger.py or tests/test_state_shards.py, parametrised over
both packages: each case runs the reference test's steps and asserts
its expectations on one package, and the port's case also runs them on
the reference and holds the two outcomes equal (state, history, commit
hashes, recovery counts, and where files are written, the files byte
for byte).  Envelopes are built once, by the reference, from a seeded
stream (`random` and numpy seeds); each package's MSPs are built from
the same org CA certificates and each verifies with its own software
provider.  Added: whole ledger directories written by the two
packages after the same block stream, byte for byte, with host MVCC and
with KV7's plain version; and each package reopening the other's
directory and committing the next block to the same commit hash.

No ledger module imports JAX; the reference's tests of the raft WAL and
of snapshot transfer have no counterpart here (neither is ported)."""
import dataclasses
import importlib
import json
import os
import random
import shutil
import time
import types

import numpy as np
import pytest

from fabric_tpu.msp.ca import DevOrg
from fabric_tpu.protocol import (Block, KVRead, KVWrite, NsRwSet, TxRwSet,
                                 Version, block_header_hash)
from fabric_tpu.protocol import build

PKGS = ("ref", "port")
SEED = 0xD0AB1E
POLICY = "AND('Org1.member', 'Org2.member')"


def load(name: str):
    """The package's ledger, protocol and committer surface."""
    root = "fabric_tpu" if name == "ref" else "fabric_tpu_torch"
    mod = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    ledger, proto = mod("ledger"), mod("protocol")
    committer, msp = mod("committer"), mod("msp")
    factory = mod("bccsp.factory" if name == "ref" else "bccsp")
    return types.SimpleNamespace(
        name=name, KVLedger=ledger.KVLedger, LedgerConfig=ledger.LedgerConfig,
        StateDB=ledger.StateDB, UpdateBatch=ledger.UpdateBatch,
        HistoryDB=ledger.HistoryDB, BlockStore=ledger.BlockStore,
        BlockStoreError=ledger.BlockStoreError,
        ckpt=mod("ledger.checkpoint"), shard_of=mod("ledger.statedb").shard_of,
        ConfigHistory=mod("ledger.confighistory").ConfigHistory,
        Version=proto.Version, Block=proto.Block,
        BlockHeader=proto.BlockHeader, block_data_hash=proto.block_data_hash,
        block_header_hash=proto.block_header_hash, TxFlags=proto.TxFlags,
        ValidationCode=proto.ValidationCode,
        META_TXFLAGS=mod("protocol.types").META_TXFLAGS,
        wire=mod("protocol.wire") if name == "port" else None,
        Committer=committer.Committer, TxValidator=committer.TxValidator,
        PolicyRegistry=committer.PolicyRegistry,
        parse_policy=mod("policy").parse_policy, msp=msp,
        provider=factory.init_factories(factory.FactoryOpts(default="SW")))


@pytest.fixture(scope="module")
def pk():
    return {name: load(name) for name in PKGS}


@pytest.fixture(scope="module")
def orgs():
    return DevOrg("Org1"), DevOrg("Org2")


# ---------------------------------------------------------------------------
# helpers shared by both packages (also imported by test_torch_config.py)
# ---------------------------------------------------------------------------

def msps_of(P, devs):
    """Each package's MSPs from the reference DevOrgs' CA material."""
    if P.name == "ref":
        return {d.mspid: P.msp.CachedMSP(d.msp()) for d in devs}
    return {d.mspid: P.msp.CachedMSP(P.msp.MSP(P.msp.MSPConfig(
        **dataclasses.asdict(d.msp_config())))) for d in devs}


def parse(P, raw: bytes):
    """A block as each package's deliver path takes it."""
    return P.wire.parse_block(raw) if P.wire else P.Block.deserialize(raw)


def rw(reads=(), writes=(), ranges=(), ns="cc"):
    return TxRwSet((NsRwSet(ns, reads=tuple(reads), writes=tuple(writes),
                            range_queries=tuple(ranges)),))


def make_tx(orgs, rwset, endorsers=None, creator=None):
    org1, org2 = orgs[:2]
    endorsers = endorsers or [org1.new_identity("e1"),
                              org2.new_identity("e2")]
    return build.endorser_tx("ch", "cc", "1.0", rwset,
                             creator or org1.new_identity("client"),
                             endorsers)


def chain(env_blocks, start: int = 0, prev: bytes = b"\x00" * 32):
    """The blocks' wire bytes, numbered and hash-chained from `start`."""
    raws = []
    for num, envs in enumerate(env_blocks, start=start):
        block = build.new_block(num, prev, envs)
        prev = block_header_hash(block.header)
        raws.append(block.serialize())
    return raws


def seeded_stream(orgs, n_blocks=5, n_tx=8, n_keys=10, seed=SEED):
    """Block 0 seeds n_keys accounts; later blocks mix reads at the
    committed version, stale and absent reads, puts and deletes, drawn
    from `random` (keys, choices) and numpy (values) seeded streams."""
    rng = random.Random(seed)
    vals = np.random.default_rng(seed)
    keys = [f"k{i:02d}" for i in range(n_keys)]
    committed = {k: Version(0, i) for i, k in enumerate(keys)}
    blocks = [[make_tx(orgs, rw(writes=[KVWrite(k, b"v0")]))
               for k in keys]]
    for blk in range(1, n_blocks):
        envs = []
        for _tx in range(n_tx):
            reads, writes = [], []
            for k in rng.sample(keys, rng.randint(0, 3)):
                u = rng.random()
                ver = (committed.get(k) if u < 0.6 else
                       Version(rng.randint(0, 3), rng.randint(0, 7))
                       if u < 0.8 else None)
                reads.append(KVRead(k, ver))
            for k in rng.sample(keys, rng.randint(1, 2)):
                if rng.random() < 0.2:
                    writes.append(KVWrite(k, b"", True))
                else:
                    writes.append(KVWrite(k, vals.bytes(6)))
            envs.append(make_tx(orgs, rw(reads=reads, writes=writes)))
        blocks.append(envs)
    return blocks


def stack(P, orgs, root=None, device=False, **cfg):
    """Committer -> TxValidator (deep path) -> optional DeviceValidator
    (the port's plain KV7 on the CPU) -> KVLedger; -> (committer, dv)."""
    policies = P.PolicyRegistry()
    policies.set_policy("cc", P.parse_policy(POLICY))
    ledger = P.KVLedger("ch", P.LedgerConfig(root=root,
                                             device_validate=device, **cfg))
    dv = None
    if device:
        from fabric_tpu_torch.committer.device_validate import (
            DeviceValidator)
        dv = DeviceValidator(ledger.statedb, "ch", device="cpu")
        ledger.set_prepared_source(dv.take_prepared)
    return P.Committer(ledger, P.TxValidator(
        "ch", msps_of(P, orgs), P.provider, policies,
        device_validate=dv)), dv


def commit_raws(P, committer, raws):
    return [committer.store_block(parse(P, r)).final_flags.codes()
            for r in raws]


def state_of(ledger):
    return sorted((k, vv.value, vv.version.block_num, vv.version.tx_num)
                  for k, vv in ledger.statedb._data.items())


def history_of(ledger):
    h = ledger.historydb
    return {k: [(m.block_num, m.tx_num, m.txid, m.value, m.is_delete)
                for m in h.get_history(*k)]
            for k in sorted(h._index)}


def ledger_view(ledger):
    return {"height": ledger.height, "hash": ledger.commit_hash,
            "state": state_of(ledger), "history": history_of(ledger)}


def dir_bytes(root) -> dict:
    """{path relative to root: file bytes} of every file under root."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def differential(pk, pkg, scenario, *args):
    """Run scenario(P, *args) on `pkg`; on the port also on the
    reference, and hold the two outcomes equal."""
    got = scenario(pk[pkg], *args)
    if pkg == "port":
        want = scenario(pk["ref"], *args)
        assert got == want
    return got


# ---------------------------------------------------------------------------
# tests/test_crash_recovery.py: the block store's tails
# ---------------------------------------------------------------------------

def _raw_block(P, num: int, prev: bytes):
    data = [b"opaque-envelope-%d" % num]
    return P.Block(P.BlockHeader(num, prev, P.block_data_hash(data)), data)


def _fill_store(P, root: str, n: int = 3) -> bytes:
    bs = P.BlockStore(root)
    prev = b"\x00" * 32
    for i in range(n):
        blk = _raw_block(P, i, prev)
        bs.add_block(blk)
        prev = P.block_header_hash(blk.header)
    return bs.chain_info().current_hash


def _torn_tail(P, root):
    seg0 = os.path.join(root, "blocks_000000.bin")
    tip = _fill_store(P, root, n=3)
    good_size = os.path.getsize(seg0)
    with open(seg0, "ab") as f:
        f.write((5000).to_bytes(8, "little") + b"only-a-few-bytes")
    bs = P.BlockStore(root)
    assert bs.height == 3
    assert bs.chain_info().current_hash == tip
    assert bs.get_by_number(2).header.number == 2
    assert os.path.getsize(seg0) == good_size
    bs.add_block(_raw_block(P, 3, tip))
    assert P.BlockStore(root).height == 4
    return dir_bytes(root)


def _garbage_tail(P, root):
    seg0 = os.path.join(root, "blocks_000000.bin")
    tip = _fill_store(P, root, n=2)
    good_size = os.path.getsize(seg0)
    junk = b"\xff\x00\xfe\x01" * 12
    with open(seg0, "ab") as f:
        f.write(len(junk).to_bytes(8, "little") + junk)
    bs = P.BlockStore(root)
    assert bs.height == 2
    assert bs.chain_info().current_hash == tip
    assert os.path.getsize(seg0) == good_size
    return dir_bytes(root)


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("tail", ["torn", "garbage"])
def test_blockstore_recovers_tail(pk, pkg, tail, tmp_path):
    fn = _torn_tail if tail == "torn" else _garbage_tail
    n = iter(range(2))
    differential(pk, pkg, lambda P: fn(
        P, str(tmp_path / f"{P.name}{next(n)}" / "blocks")))


# ---------------------------------------------------------------------------
# tests/test_crash_recovery.py: the ledger, kill mid-commit and rebuild
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_tx_blocks(orgs):
    """Ten one-tx blocks writing k0..k9 = v-k<i>, chained from 0."""
    return chain([[make_tx(orgs, rw(writes=[KVWrite(
        f"k{i}", b"v-k%d" % i)]))] for i in range(10)])


def _kill_mid_commit(P, orgs, raws, root):
    committer, _ = stack(P, orgs, root)
    commit_raws(P, committer, raws[:1])
    ledger = committer.ledger
    real_apply = ledger.statedb.apply_updates

    def die(batch, height):
        raise RuntimeError("kill -9 (injected mid-commit)")

    ledger.statedb.apply_updates = die
    with pytest.raises(RuntimeError, match="injected mid-commit"):
        commit_raws(P, committer, raws[1:2])
    ledger.statedb.apply_updates = real_apply
    assert ledger.blockstore.height == 2
    assert ledger.get_state("cc", "k1") is None
    pre_crash_hash = ledger.commit_hash

    reopened = P.KVLedger("ch", P.LedgerConfig(root=root))
    assert reopened.height == 2
    assert reopened.get_state("cc", "k0") == b"v-k0"
    assert reopened.get_state("cc", "k1") == b"v-k1"
    assert reopened.commit_hash == pre_crash_hash
    assert len(reopened.get_history("cc", "k1")) == 1
    assert reopened.last_recovery["replayed_blocks"] == 1
    view = ledger_view(reopened)

    committer2, _ = stack(P, orgs, root)
    codes = commit_raws(P, committer2, raws[2:3])
    assert codes == [[0]] and committer2.ledger.height == 3
    return view, ledger_view(committer2.ledger), dir_bytes(root)


@pytest.mark.parametrize("pkg", PKGS)
def test_kvledger_recovers_kill_mid_commit(pk, pkg, orgs, one_tx_blocks,
                                           tmp_path):
    differential(pk, pkg, lambda P: _kill_mid_commit(
        P, orgs, one_tx_blocks, str(tmp_path / P.name)))


def _statedb_rebuild(P, orgs, raws, root):
    committer, _ = stack(P, orgs, root)
    commit_raws(P, committer, raws[:3])
    tip_hash = committer.ledger.commit_hash
    shutil.rmtree(os.path.join(root, "ch", "state"))
    reopened = P.KVLedger("ch", P.LedgerConfig(root=root))
    assert reopened.height == 3
    for i in range(3):
        assert reopened.get_state("cc", f"k{i}") == b"v-k%d" % i
    assert reopened.commit_hash == tip_hash
    return ledger_view(reopened), dict(reopened.last_recovery)


@pytest.mark.parametrize("pkg", PKGS)
def test_kvledger_recovers_statedb_rebuild(pk, pkg, orgs, one_tx_blocks,
                                           tmp_path):
    differential(pk, pkg, lambda P: _statedb_rebuild(
        P, orgs, one_tx_blocks, str(tmp_path / P.name)))


# ---------------------------------------------------------------------------
# tests/test_crash_recovery.py: the sharded checkpoint plane
# ---------------------------------------------------------------------------

_SHARD_CFG = dict(snapshot_every=2, state_shards=4)


def _corrupt_partial_generation(C, sroot):
    m = C.read_manifest(sroot)
    d = C.gen_dir(sroot, m["gen"] + 1)
    os.makedirs(d)
    with open(os.path.join(d, C.shard_file(0)), "wb") as f:
        f.write(b"half-writ")
    with open(os.path.join(sroot, "MANIFEST.new"), "wb") as f:
        f.write(b"\x01\x02torn")


def _corrupt_between_renames(C, sroot):
    m = os.path.join(sroot, C.MANIFEST)
    os.replace(m, m + C.PREV_SUFFIX)


def _corrupt_missing_shard(C, sroot):
    m = C.read_manifest(sroot)
    os.remove(os.path.join(C.gen_dir(sroot, m["gen"]),
                           m["shards"][0]["file"]))


def _corrupt_bitflip_shard(C, sroot):
    m = C.read_manifest(sroot)
    p = os.path.join(C.gen_dir(sroot, m["gen"]), m["shards"][0]["file"])
    with open(p, "r+b") as f:
        data = bytearray(f.read())
        data[len(data) // 2] ^= 0xFF
        f.seek(0)
        f.write(bytes(data))


def _corrupt_torn_manifest(C, sroot):
    p = os.path.join(sroot, C.MANIFEST)
    with open(p, "r+b") as f:
        data = f.read()
        f.seek(0)
        f.truncate(max(1, len(data) // 3))


def _corrupt_garbage_manifest(C, sroot):
    with open(os.path.join(sroot, C.MANIFEST), "wb") as f:
        f.write(b"\xff\x00\xfe\x01disk-scribble" * 7)


_CORRUPTIONS = {
    "partial_generation": (_corrupt_partial_generation, {"manifest"}),
    "between_renames": (_corrupt_between_renames, {"manifest_prev"}),
    "missing_shard": (_corrupt_missing_shard, {"manifest_prev"}),
    "bitflip_shard": (_corrupt_bitflip_shard, {"manifest_prev"}),
    "torn_manifest": (_corrupt_torn_manifest, {"manifest_prev"}),
    "garbage_manifest": (_corrupt_garbage_manifest, {"manifest_prev"}),
}


def _checkpoint_corruption(P, orgs, raws, base, name):
    corrupt, sources = _CORRUPTIONS[name]
    root = os.path.join(base, "ledger")
    committer, _ = stack(P, orgs, root, **_SHARD_CFG)
    commit_raws(P, committer, raws[:6])
    live = committer.ledger
    ref_hash, ref_state = live.commit_hash, state_of(live)

    odir = os.path.join(base, "oracle")
    shutil.copytree(root, odir)
    shutil.rmtree(os.path.join(odir, "ch", "state"))
    shutil.rmtree(os.path.join(odir, "ch", "history"), ignore_errors=True)
    oracle = P.KVLedger("ch", P.LedgerConfig(root=odir, **_SHARD_CFG))
    assert oracle.commit_hash == ref_hash
    assert oracle.last_recovery["replayed_blocks"] == 6

    corrupt(P.ckpt, os.path.join(root, "ch", "state"))
    re = P.KVLedger("ch", P.LedgerConfig(root=root, **_SHARD_CFG))
    assert re.statedb.last_recovery["source"] in sources, name
    assert re.commit_hash == ref_hash == oracle.commit_hash
    assert state_of(re) == ref_state == state_of(oracle)
    assert re.get_history("cc", "k0") == oracle.get_history("cc", "k0")
    assert re.last_recovery["replayed_blocks"] <= 2

    committer2, _ = stack(P, orgs, root, **_SHARD_CFG)
    commit_raws(P, committer2, raws[6:7])
    assert committer2.ledger.height == 7
    return (dict(re.statedb.last_recovery), dict(re.last_recovery),
            ledger_view(committer2.ledger))


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("name", sorted(_CORRUPTIONS))
def test_state_checkpoint_corruption_recovers(pk, pkg, name, orgs,
                                              one_tx_blocks, tmp_path):
    differential(pk, pkg, lambda P: _checkpoint_corruption(
        P, orgs, one_tx_blocks, str(tmp_path / P.name), name))


def _kill_at_every_rename(P, base, monkeypatch):
    n_replaces = 4 + 3
    out = []
    for kill_at in list(range(n_replaces)) + [999]:
        root = os.path.join(base, f"kill{kill_at}")
        db = P.StateDB(root, snapshot_every=100, n_shards=4)
        for blk in range(1, 5):
            b = P.UpdateBatch()
            for i in range(6):
                b.put("cc", f"k{i}", b"v%d-%d" % (blk, i), P.Version(blk, i))
            db.apply_updates(b, blk)
            if blk == 2:
                db.checkpoint()
        ref = dict(db._data)

        real_replace = os.replace
        calls = {"n": 0}

        def dying(src, dst, *, _real=real_replace, _k=kill_at):
            if calls["n"] == _k:
                raise RuntimeError("kill -9 (injected mid-checkpoint)")
            calls["n"] += 1
            return _real(src, dst)

        monkeypatch.setattr(P.ckpt.os, "replace", dying)
        try:
            db.checkpoint()
            assert kill_at >= n_replaces, "expected the injected kill"
        except RuntimeError:
            assert kill_at < n_replaces
        finally:
            monkeypatch.setattr(P.ckpt.os, "replace", real_replace)

        re = P.StateDB(root, snapshot_every=100, n_shards=4)
        assert dict(re._data) == ref, f"kill_at={kill_at} lost state"
        assert re.savepoint == 4
        assert re.last_recovery["source"] in ("manifest", "manifest_prev")
        out.append((sorted((k, v.value, v.version.to_list())
                           for k, v in re._data.items()),
                    re.last_recovery["source"], dir_bytes(root)))
    return out


@pytest.mark.parametrize("pkg", PKGS)
def test_statedb_checkpoint_kill_at_every_rename(pk, pkg, tmp_path,
                                                 monkeypatch):
    differential(pk, pkg, lambda P: _kill_at_every_rename(
        P, str(tmp_path / P.name), monkeypatch))


# ---------------------------------------------------------------------------
# tests/test_ledger.py
# ---------------------------------------------------------------------------

def _admin_blocks(org, rwsets_per_block, start=0, prev=b"\x00" * 32):
    """test_ledger.py's blocks: txs created and endorsed by the admin."""
    return chain([[build.endorser_tx("ch", "cc", "1.0", r, org.admin,
                                     [org.admin]) for r in rwsets]
                  for rwsets in rwsets_per_block], start, prev)


def flagged(P, raw: bytes):
    """The block with every tx flagged VALID, as ledger_block does."""
    block = P.Block.deserialize(raw)
    n = len(block.data)
    block.metadata.items[P.META_TXFLAGS] = P.TxFlags(
        n, P.ValidationCode.VALID).to_bytes()
    return block


@pytest.fixture(scope="module")
def index_blocks(orgs):
    """Four txs, blocks 0 and 1 of two each, and three bad successors."""
    org = orgs[0]
    envs = [build.endorser_tx("ch", "cc", "1.0",
                              rw(writes=[KVWrite(f"k{i}", b"v")]),
                              org.admin, [org.admin]) for i in range(4)]
    b0 = build.new_block(0, b"\x00" * 32, envs[:2])
    b1 = build.new_block(1, b0.hash(), envs[2:])
    return envs, b0, b1, [build.new_block(5, b1.hash(), envs[:1]),
                          build.new_block(2, b"\xff" * 32, envs[:1]),
                          build.new_block(2, b1.hash(), envs[:1])]


def _blockstore_append_index_recover(P, blocks, root):
    envs, b0, b1, (gap, bad_prev, b2) = blocks
    bs = P.BlockStore(root)
    pb0, pb1 = (P.Block.deserialize(b.serialize()) for b in (b0, b1))
    bs.add_block(pb0)
    bs.add_block(pb1)
    assert bs.height == 2
    assert bs.chain_info().current_hash == b1.hash()
    txid = envs[2].header().channel_header.txid
    assert bs.get_by_txid(txid).header.number == 1
    assert bs.get_by_hash(b0.hash()).header.number == 0
    for bad in (gap, bad_prev):
        with pytest.raises(P.BlockStoreError):
            bs.add_block(P.Block.deserialize(bad.serialize()))
    bs2 = P.BlockStore(root)
    assert bs2.height == 2
    assert [b.header.number for b in bs2.iter_blocks()] == [0, 1]
    assert bs2.get_by_txid(txid).header.number == 1
    assert bs2.get_tx_validation_code(txid) == P.ValidationCode.NOT_VALIDATED
    seg = os.path.join(root, "blocks_000000.bin")
    with open(seg, "ab") as f:
        f.write(b"\x40\x00\x00\x00\x00\x00\x00\x00partial")
    bs3 = P.BlockStore(root)
    assert bs3.height == 2
    bs3.add_block(P.Block.deserialize(b2.serialize()))
    assert P.BlockStore(root).height == 3
    return dir_bytes(root)


@pytest.mark.parametrize("pkg", PKGS)
def test_blockstore_append_index_recover(pk, pkg, index_blocks, tmp_path):
    differential(pk, pkg, lambda P: _blockstore_append_index_recover(
        P, index_blocks, str(tmp_path / P.name)))


def _statedb_versions_scan_persistence(P, root):
    V = P.Version
    db = P.StateDB(root, snapshot_every=2)
    b = P.UpdateBatch()
    b.put("cc", "a", b"1", V(0, 0))
    b.put("cc", "c", b"2", V(0, 1))
    b.put("other", "b", b"9", V(0, 2))
    db.apply_updates(b, 0)
    b = P.UpdateBatch()
    b.put("cc", "b", b"3", V(1, 0))
    b.delete("cc", "c", V(1, 1))
    db.apply_updates(b, 1)
    b = P.UpdateBatch()
    b.put("cc", "d", b"4", V(2, 0))
    db.apply_updates(b, 2)
    assert db.get("cc", "a").value == b"1"
    assert db.get("cc", "c") is None
    assert [k for k, _ in db.range_scan("cc", "a", "")] == ["a", "b", "d"]
    assert [k for k, _ in db.range_scan("cc", "a", "c")] == ["a", "b"]
    assert db.savepoint == 2
    db2 = P.StateDB(root)
    assert db2.savepoint == 2
    assert db2.get("cc", "d").value == b"4"
    assert db2.get("cc", "c") is None
    assert [k for k, _ in db2.range_scan("cc", "", "")] == ["a", "b", "d"]
    with pytest.raises(ValueError):
        db2.apply_updates(P.UpdateBatch(), 1)
    return db2.status(), dir_bytes(root)


@pytest.mark.parametrize("pkg", PKGS)
def test_statedb_versions_scan_persistence(pk, pkg, tmp_path):
    differential(pk, pkg, lambda P: _statedb_versions_scan_persistence(
        P, str(tmp_path / P.name)))


@pytest.fixture(scope="module")
def query_blocks(orgs):
    org = orgs[0]
    b0 = _admin_blocks(org, [[rw(writes=[KVWrite("k", b"v0")])]])
    b1 = _admin_blocks(org, [[
        rw(reads=[KVRead("k", Version(0, 0))], writes=[KVWrite("k", b"v1")]),
        rw(reads=[KVRead("k", Version(0, 0))], writes=[KVWrite("k", b"BAD")]),
    ]], 1, header_hash_of(b0[0]))
    return b0 + b1


def header_hash_of(raw: bytes) -> bytes:
    return block_header_hash(Block.deserialize(raw).header)


def _kvledger_commit_query_history(P, raws, root):
    cfg = P.LedgerConfig(root=root)
    lg = P.KVLedger("ch", cfg)
    lg.commit(flagged(P, raws[0]))
    stats = lg.commit(flagged(P, raws[1]))
    assert stats.valid_txs == 1
    assert lg.get_state("cc", "k") == b"v1"
    assert [m.value for m in lg.get_history("cc", "k")] == [b"v1", b"v0"]
    assert lg.height == 2
    ch1 = lg.commit_hash
    assert ch1 != b"\x00" * 32
    lg2 = P.KVLedger("ch", cfg)
    assert lg2.height == 2
    assert lg2.get_state("cc", "k") == b"v1"
    assert lg2.commit_hash == ch1
    lg2.rebuild_dbs()
    assert lg2.get_state("cc", "k") == b"v1"
    assert lg2.commit_hash == ch1
    assert [m.value for m in lg2.get_history("cc", "k")] == [b"v1", b"v0"]
    return ledger_view(lg2), dir_bytes(root)


@pytest.mark.parametrize("pkg", PKGS)
def test_kvledger_commit_query_history(pk, pkg, query_blocks, tmp_path):
    differential(pk, pkg, lambda P: _kvledger_commit_query_history(
        P, query_blocks, str(tmp_path / P.name)))


def _crash_between_state_and_history(P, raws, root):
    cfg = P.LedgerConfig(root=root)
    lg = P.KVLedger("ch", cfg)
    lg.commit(flagged(P, raws[0]))
    hist_wal = os.path.join(root, "ch", "history", "history.wal")
    before = os.path.getsize(hist_wal)
    lg.commit(flagged(P, raws[1]))
    with open(hist_wal, "r+b") as f:
        f.truncate(before)
    lg2 = P.KVLedger("ch", cfg)
    assert lg2.get_state("cc", "k") == b"v1"
    assert [m.value for m in lg2.get_history("cc", "k")] == [b"v1", b"v0"]
    assert lg2.historydb.savepoint == 1
    return ledger_view(lg2), dict(lg2.last_recovery), dir_bytes(root)


@pytest.mark.parametrize("pkg", PKGS)
def test_recovery_crash_between_state_and_history(pk, pkg, query_blocks,
                                                  tmp_path):
    differential(pk, pkg, lambda P: _crash_between_state_and_history(
        P, query_blocks, str(tmp_path / P.name)))


def _blockstore_in_memory_mode(P, raw):
    bs = P.BlockStore(None)
    b0 = P.Block.deserialize(raw)
    bs.add_block(b0)
    assert bs.height == 1 and bs.root is None
    assert bs.get_by_number(0).header == b0.header
    assert bs.get_by_hash(P.block_header_hash(b0.header)).header.number == 0
    txid = P.wire.envelope_summary(b0.data[0])[2] if P.wire else \
        importlib.import_module("fabric_tpu.protocol").Envelope.deserialize(
            b0.data[0]).header().channel_header.txid
    assert bs.has_txid(txid)
    return bs.chain_info().current_hash, txid


@pytest.mark.parametrize("pkg", PKGS)
def test_blockstore_in_memory_mode(pk, pkg, query_blocks):
    differential(pk, pkg, lambda P: _blockstore_in_memory_mode(
        P, query_blocks[0]))


@pytest.fixture(scope="module")
def admin_blocks(orgs):
    """test_ledger_admin_rollback_reset_pause's blocks: k0..k3, then k9
    after a rollback to 2, then kA."""
    org = orgs[0]
    head = _admin_blocks(org, [[rw(writes=[KVWrite(f"k{i}", b"v%d" % i)])]
                               for i in range(4)])
    tail = _admin_blocks(org, [[rw(writes=[KVWrite("k9", b"v9")])],
                               [rw(writes=[KVWrite("kA", b"vA")])]],
                         2, header_hash_of(head[1]))
    return head, tail


def _ledger_admin(P, blocks, root):
    head, tail = blocks
    cfg = P.LedgerConfig(root=root)
    lg = P.KVLedger("ch", cfg)
    for raw in head:
        lg.commit(flagged(P, raw))
    assert lg.height == 4 and lg.get_state("cc", "k3") == b"v3"
    lg.rollback(2)
    assert lg.height == 2
    assert lg.get_state("cc", "k1") == b"v1"
    assert lg.get_state("cc", "k3") is None
    lg.commit(flagged(P, tail[0]))
    assert lg.height == 3 and lg.get_state("cc", "k9") == b"v9"
    lg.pause()
    blk = flagged(P, tail[1])
    with pytest.raises(RuntimeError, match="paused"):
        lg.commit(blk)
    assert P.KVLedger("ch", cfg).paused
    lg.resume()
    lg.commit(blk)
    assert lg.get_state("cc", "kA") == b"vA"
    status = lg.state_status()
    lg.reset()
    assert lg.height == 1
    assert lg.get_state("cc", "kA") is None
    return status, ledger_view(lg), dir_bytes(root)


@pytest.mark.parametrize("pkg", PKGS)
def test_ledger_admin_rollback_reset_pause(pk, pkg, admin_blocks, tmp_path):
    differential(pk, pkg, lambda P: _ledger_admin(
        P, admin_blocks, str(tmp_path / P.name)))


def _confighistory_heights(P, root):
    ch = P.ConfigHistory(root)
    assert ch.config_at(5) is None
    ch.record(2, b"cfg-seq1")
    ch.record(7, b"cfg-seq2")
    ch.record(7, b"replayed")
    assert ch.config_at(1) is None
    assert ch.config_at(2) == b"cfg-seq1"
    assert ch.config_at(6) == b"cfg-seq1"
    assert ch.config_at(7) == b"cfg-seq2"
    assert ch.config_at(99) == b"cfg-seq2"
    ch2 = P.ConfigHistory(root)
    assert ch2.config_at(99) == b"cfg-seq2"
    assert len(ch2.entries()) == 2
    return ch2.entries(), ch2.latest_height(), dir_bytes(root)


@pytest.mark.parametrize("pkg", PKGS)
def test_confighistory_heights(pk, pkg, tmp_path):
    differential(pk, pkg, lambda P: _confighistory_heights(
        P, str(tmp_path / P.name)))


def _rich_query_selectors(P):
    db = P.StateDB()
    batch = P.UpdateBatch()
    docs = [
        ("a1", {"type": "asset", "owner": "alice", "value": 10}),
        ("a2", {"type": "asset", "owner": "bob", "value": 25}),
        ("a3", {"type": "car", "owner": "alice", "value": 99}),
        ("a4", {"type": "asset", "owner": "carol", "value": 7}),
    ]
    for k, d in docs:
        batch.put("cc", k, json.dumps(d).encode(), P.Version(1, 0))
    batch.put("cc", "raw", b"\xff\xfe not json", P.Version(1, 0))
    db.apply_updates(batch, 1)

    def q(sel, **kw):
        return [k for k, _ in db.execute_query("cc", sel, **kw)]

    out = [q({"type": "asset"}), q({"type": "asset", "owner": "alice"}),
           q({"value": {"$gt": 9, "$lt": 50}}),
           q({"owner": {"$in": ["bob", "carol"]}}),
           q({"$or": [{"owner": "bob"}, {"type": "car"}]}),
           q({"type": "asset"}, limit=2), q({"missing": {"$gt": 1}})]
    assert out == [["a1", "a2", "a4"], ["a1"], ["a1", "a2"], ["a2", "a4"],
                   ["a2", "a3"], ["a1", "a2"], []]
    return out


@pytest.mark.parametrize("pkg", PKGS)
def test_rich_query_selectors(pk, pkg):
    differential(pk, pkg, _rich_query_selectors)


def _rich_query_index(P):
    rng = random.Random(42)
    db = P.StateDB()
    batch = P.UpdateBatch()
    n = 20000
    for i in range(n):
        doc = {"size": rng.randrange(0, 1000),
               "owner": f"o{rng.randrange(0, 50)}",
               "tag": rng.choice(["a", "b", None])}
        if i % 17 == 0:
            del doc["size"]
        batch.put("cc", f"k{i:06d}", json.dumps(doc).encode(),
                  P.Version(1, i))
    batch.put("cc", "raw", b"\x00not-json", P.Version(1, n))
    db.apply_updates(batch, 1)
    selectors = [
        {"size": {"$gte": 100, "$lt": 120}},
        {"size": 7},
        {"size": {"$gt": 990}, "owner": "o3"},
        {"size": {"$in": [1, 2, 3]}},
        {"owner": "o7", "size": {"$lte": 50}},
        {"size": {"$ne": 5}},
        {"tag": "a"},
    ]
    scans = [list(db.execute_query("cc", s)) for s in selectors]
    db.create_index("cc", "size")
    for s, want in zip(selectors, scans):
        assert list(db.execute_query("cc", s)) == want, s
    t0 = time.perf_counter()
    for _ in range(20):
        list(db.execute_query("cc", {"size": {"$gte": 500, "$lt": 503}}))
    indexed_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(20):
        list(db.execute_query("cc", {"tag": "zzz"}))
    scan_s = time.perf_counter() - t0
    assert indexed_s * 5 < scan_s, (indexed_s, scan_s)
    b2 = P.UpdateBatch()
    b2.put("cc", "k000001", json.dumps({"size": 100000}).encode(),
           P.Version(2, 0))
    b2.delete("cc", "k000002", P.Version(2, 1))
    db.apply_updates(b2, 2)
    got = list(db.execute_query("cc", {"size": {"$gte": 100000}}))
    assert [k for k, _ in got] == ["k000001"]
    assert not any(k == "k000002" for k, _ in
                   db.execute_query("cc", {"size": {"$gte": 0}}))
    return [[(k, vv.value) for k, vv in s] for s in scans]


@pytest.mark.parametrize("pkg", PKGS)
def test_rich_query_index_differential_and_sublinear(pk, pkg):
    differential(pk, pkg, _rich_query_index)


def _rich_query_bookmarks(P):
    db = P.StateDB()
    batch = P.UpdateBatch()
    for i in range(25):
        batch.put("cc", f"k{i:02d}", json.dumps({"v": i % 2}).encode(),
                  P.Version(1, i))
    db.apply_updates(batch, 1)
    db.create_index("cc", "v")
    pages, bm, marks = [], "", []
    while True:
        page, bm = db.query_page("cc", {"v": 1}, limit=5, bookmark=bm)
        pages.extend(k for k, _ in page)
        marks.append(bm)
        if not bm:
            break
    assert pages == [f"k{i:02d}" for i in range(25) if i % 2 == 1]
    return pages, marks


@pytest.mark.parametrize("pkg", PKGS)
def test_rich_query_bookmark_pagination(pk, pkg):
    differential(pk, pkg, _rich_query_bookmarks)


# ---------------------------------------------------------------------------
# tests/test_state_shards.py
# ---------------------------------------------------------------------------

def _random_batches(P, seed=7, blocks=6, keys=120):
    rnd = random.Random(seed)
    names = [f"k{i:04d}" for i in range(keys)]
    batches = []
    for blk in range(1, blocks + 1):
        b = P.UpdateBatch()
        for t, key in enumerate(rnd.sample(names, 40)):
            if rnd.random() < 0.2:
                b.delete("cc", key, P.Version(blk, t))
            else:
                b.put("cc", key, b"v-%d-%s" % (blk, key.encode()),
                      P.Version(blk, t))
        for t, i in enumerate(rnd.sample(range(keys), 10)):
            b.put("docs", f"d{i:04d}",
                  b'{"size": %d, "owner": "o%d"}' % (i, i % 3),
                  P.Version(blk, 100 + t))
        batches.append(b)
    return batches


def _dump(db):
    return sorted((k, vv.value, vv.version.block_num, vv.version.tx_num)
                  for k, vv in db._data.items())


def _shard_of_placement(P):
    out = []
    for n in (1, 2, 7, 8, 64):
        for i in range(200):
            ns, key = f"ns{i % 3}", f"key-{i:04d}"
            s = P.shard_of(ns, key, n)
            assert 0 <= s < max(1, n)
            out.append(s)
    assert P.shard_of("cc", "anything", 1) == 0
    assert P.shard_of("cc", "anything", 0) == 0
    assert P.shard_of("ab", "c", 1 << 30) != P.shard_of("a", "bc", 1 << 30)
    counts = [0] * 8
    for i in range(4000):
        counts[P.shard_of("cc", f"k{i:05d}", 8)] += 1
    assert min(counts) > 0 and max(counts) < 3 * (4000 // 8)
    return out, counts


@pytest.mark.parametrize("pkg", PKGS)
def test_shard_of_deterministic_bounded_and_spread(pk, pkg):
    differential(pk, pkg, _shard_of_placement)


def _preshard_cache(P):
    b = P.UpdateBatch()
    b.put("cc", "k1", b"v", P.Version(1, 0))
    first = b.items_by_shard(4)
    assert b.items_by_shard(4) is first
    b.put("cc", "k2", b"v", P.Version(1, 1))
    second = b.items_by_shard(4)
    assert second is not first
    assert sum(len(x) for x in second) == 2
    assert sum(len(x) for x in b.items_by_shard(7)) == 2
    return [[k for k, _ in s] for s in second]


@pytest.mark.parametrize("pkg", PKGS)
def test_update_batch_preshard_cache_invalidation(pk, pkg):
    differential(pk, pkg, _preshard_cache)


def _sharded_matches_flat(P):
    dbs = {n: P.StateDB(n_shards=n) for n in (1, 4, 7)}
    for db in dbs.values():
        db.create_index("docs", "size")
        for blk, batch in enumerate(_random_batches(P), start=1):
            db.apply_updates(batch, blk)
    flat = dbs[1]
    sel = {"size": {"$gte": 10, "$lt": 90}}
    want = (_dump(flat), list(flat.range_scan("cc", "", "")),
            list(flat.range_scan("cc", "k0010", "k0050", limit=7)),
            list(flat.execute_query("docs", sel)))
    for n in (4, 7):
        db = dbs[n]
        assert (_dump(db), list(db.range_scan("cc", "", "")),
                list(db.range_scan("cc", "k0010", "k0050", limit=7)),
                list(db.execute_query("docs", sel))) == want
        assert sum(1 for s in db.shard_sizes() if s) > 1
    return want[0], [k for k, _ in want[1]], [k for k, _ in want[3]]


@pytest.mark.parametrize("pkg", PKGS)
def test_sharded_statedb_matches_flat(pk, pkg):
    differential(pk, pkg, _sharded_matches_flat)


def _checkpoint_reopen_restripe(P, root):
    db = P.StateDB(root, snapshot_every=2, n_shards=4)
    for blk, batch in enumerate(_random_batches(P, blocks=5), start=1):
        db.apply_updates(batch, blk)
    ref = _dump(db)
    assert db.status()["checkpoint_gen"] >= 1
    re4 = P.StateDB(root, snapshot_every=2, n_shards=4)
    assert re4.last_recovery["source"] == "manifest"
    assert re4.savepoint == 5
    assert _dump(re4) == ref
    re7 = P.StateDB(root, snapshot_every=2, n_shards=7)
    assert _dump(re7) == ref
    assert list(re7.range_scan("cc", "", "")) == list(
        re4.range_scan("cc", "", ""))
    return ref, re4.status(), dir_bytes(root)


@pytest.mark.parametrize("pkg", PKGS)
def test_statedb_checkpoint_reopen_and_restripe(pk, pkg, tmp_path):
    differential(pk, pkg, lambda P: _checkpoint_reopen_restripe(
        P, str(tmp_path / P.name)))


def _checkpoint_reuse(P, root):
    db = P.StateDB(root, snapshot_every=100, n_shards=2)
    b = P.UpdateBatch()
    b.put("cc", "k", b"v", P.Version(1, 0))
    db.apply_updates(b, 1)
    m1 = db.checkpoint()
    m2 = db.checkpoint()
    assert m1["gen"] == m2["gen"] == 1
    assert m1["savepoint"] == 1
    return m1, dir_bytes(root)


@pytest.mark.parametrize("pkg", PKGS)
def test_statedb_checkpoint_reuse_when_clean(pk, pkg, tmp_path):
    differential(pk, pkg, lambda P: _checkpoint_reuse(
        P, str(tmp_path / P.name)))


def _history_checkpoint_reopen(P, root):
    h = P.HistoryDB(root, n_shards=4, checkpoint_every=2)
    for blk in range(1, 6):
        h.commit(blk, [(0, f"tx{blk}", "cc", f"k{blk % 3}",
                        b"v%d" % blk, False)])
    mods = h.get_history("cc", "k1")
    re4 = P.HistoryDB(root, n_shards=4, checkpoint_every=2)
    assert re4.last_recovery["source"] in ("manifest", "manifest_prev")
    assert re4.savepoint == 5
    assert re4.get_history("cc", "k1") == mods
    re3 = P.HistoryDB(root, n_shards=3, checkpoint_every=2)
    assert re3.get_history("cc", "k1") == mods
    return ([(m.block_num, m.txid, m.value) for m in mods], re4.status(),
            dir_bytes(root))


@pytest.mark.parametrize("pkg", PKGS)
def test_historydb_sharded_checkpoint_reopen(pk, pkg, tmp_path):
    differential(pk, pkg, lambda P: _history_checkpoint_reopen(
        P, str(tmp_path / P.name)))


@pytest.fixture(scope="module")
def shard_blocks(orgs):
    """test_state_shards.py's deterministic envelope matrix."""
    org = orgs[0]
    rnd = random.Random(11)
    blocks = []
    for blk in range(4):
        rwsets = []
        for t in range(6):
            writes = [KVWrite(f"k{rnd.randrange(18):03d}",
                              b"b%d-t%d" % (blk, t))]
            if rnd.random() < 0.25:
                writes.append(KVWrite(f"gone{t}", b"", True))
            rwsets.append(TxRwSet((NsRwSet("cc", writes=tuple(writes)),)))
        blocks.append(rwsets)
    return _admin_blocks(org, blocks)


def _chain_across_widths(P, raws, base):
    ledgers = {}
    for n in (1, 4, 7):
        cfg = P.LedgerConfig(root=os.path.join(base, f"n{n}"),
                             snapshot_every=3, state_shards=n)
        ledgers[n] = P.KVLedger("ch", cfg)
        for raw in raws:
            ledgers[n].commit(flagged(P, raw))
    ref = ledgers[1]
    for n in (4, 7):
        lg = ledgers[n]
        assert lg.commit_hash == ref.commit_hash, f"n={n} chain diverged"
        assert _dump(lg.statedb) == _dump(ref.statedb)
        assert list(lg.range_query("cc", "", "")) == list(
            ref.range_query("cc", "", ""))
        assert lg.get_history("cc", "k000") == ref.get_history("cc", "k000")
    for n in (1, 4, 7):
        re = P.KVLedger("ch", P.LedgerConfig(
            root=os.path.join(base, f"n{n}"), snapshot_every=3,
            state_shards=n))
        assert re.commit_hash == ref.commit_hash
        assert _dump(re.statedb) == _dump(ref.statedb)
    return ref.commit_hash, _dump(ref.statedb), dir_bytes(base)


@pytest.mark.parametrize("pkg", PKGS)
def test_ledger_commit_chain_identical_across_shard_widths(pk, pkg,
                                                           shard_blocks,
                                                           tmp_path):
    differential(pk, pkg, lambda P: _chain_across_widths(
        P, shard_blocks, str(tmp_path / P.name)))


def _parallel_serial_identity(P, base):
    def state(root):
        db = P.StateDB(root=root, n_shards=8)
        b = P.UpdateBatch()
        for i in range(800):
            b.put("cc", f"k{i:05d}", b"v%d" % i, P.Version(1, i))
        db.apply_updates(b, 1)
        return db

    def history(root):
        db = P.HistoryDB(root=root, n_shards=8)
        db.commit(1, [(i, f"tx{i}", "cc", f"k{i:05d}", b"v", False)
                      for i in range(800)])
        return db

    out = []
    for make, kind in ((state, "state"), (history, "history")):
        par = make(os.path.join(base, kind, "par"))
        ser = make(os.path.join(base, kind, "ser"))
        par._HOST_CORES = 8
        ser._HOST_CORES = 1
        mp, ms = par.checkpoint(), ser.checkpoint()
        assert [s["sha256"] for s in mp["shards"]] \
            == [s["sha256"] for s in ms["shards"]]
        assert [s["bytes"] for s in mp["shards"]] \
            == [s["bytes"] for s in ms["shards"]]
        assert dir_bytes(os.path.join(base, kind, "par")) \
            == dir_bytes(os.path.join(base, kind, "ser"))
        out.append(mp)
    ra = P.StateDB(root=os.path.join(base, "state", "par"), n_shards=8)
    assert len(ra) == 800
    rh = P.HistoryDB(root=os.path.join(base, "history", "par"), n_shards=8)
    assert rh.last_recovery["source"] != "fresh"
    assert [m.txid for m in rh.get_history("cc", "k00007")] == ["tx7"]
    return out


@pytest.mark.parametrize("pkg", PKGS)
def test_checkpoint_parallel_serial_bit_identity(pk, pkg, tmp_path):
    differential(pk, pkg, lambda P: _parallel_serial_identity(
        P, str(tmp_path / P.name)))


# ---------------------------------------------------------------------------
# whole directories byte for byte, and each package on the other's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stream(orgs):
    """Five blocks of the seeded stream, plus a sixth to commit after a
    reopen."""
    return chain(seeded_stream(orgs, n_blocks=6))


def _durable_run(P, orgs, raws, root, device=False):
    committer, dv = stack(P, orgs, root, device=device, state_shards=4,
                          snapshot_every=2)
    codes = commit_raws(P, committer, raws)
    if dv is not None:
        st = dv.stats
        assert st["validator_device_blocks_total"] == len(raws)
        assert st["validator_device_stash_misses_total"] == 0
    return codes, ledger_view(committer.ledger)


@pytest.mark.parametrize("lane", ["host_mvcc", "kv7_plain"])
def test_directories_byte_identical(pk, orgs, stream, lane, tmp_path):
    """The same stream through the reference (host MVCC) and the port
    (host MVCC, or KV7's plain version with its prepared batch) leaves
    the same files: block segments, state and history WALs, every
    checkpoint generation and its manifests."""
    raws = stream[:5]
    ref = _durable_run(pk["ref"], orgs, raws, str(tmp_path / "ref"))
    port = _durable_run(pk["port"], orgs, raws, str(tmp_path / "port"),
                        device=(lane == "kv7_plain"))
    assert port == ref
    assert ref[0] != [[0] * len(c) for c in ref[0]]      # conflicts happen
    a, b = dir_bytes(tmp_path / "ref"), dir_bytes(tmp_path / "port")
    assert sorted(a) == sorted(b)
    assert any(p.endswith("MANIFEST.prev") for p in a)
    assert any("state.wal" in p for p in a)
    for path in a:
        assert a[path] == b[path], path


@pytest.mark.parametrize("writer,reader", [("ref", "port"),
                                           ("port", "ref")])
def test_cross_open(pk, orgs, stream, writer, reader, tmp_path):
    """Each package reopens the other's directory (the state WAL's tail
    past the last checkpoint replayed, history likewise) to the same
    height, state, history and commit hash, and commits the next block
    to the same hash and bytes as the writer itself would."""
    raws = stream[:5]
    roots = {k: str(tmp_path / k) for k in ("mine", "theirs")}
    _durable_run(pk[writer], orgs, raws, roots["mine"])
    shutil.copytree(roots["mine"], roots["theirs"])
    reopened, views = {}, {}
    for side, P in (("mine", pk[writer]), ("theirs", pk[reader])):
        committer, _ = stack(P, orgs, roots[side], state_shards=4,
                             snapshot_every=2)
        lg = committer.ledger
        assert lg.height == 5
        assert lg.statedb.last_recovery["source"] == "manifest"
        assert lg.historydb.last_recovery["wal_blocks"] == 1
        reopened[side] = ledger_view(lg)
        commit_raws(P, committer, stream[5:6])
        views[side] = ledger_view(lg)
    assert reopened["mine"] == reopened["theirs"]
    assert views["mine"] == views["theirs"]
    assert dir_bytes(roots["mine"]) == dir_bytes(roots["theirs"])


def test_stash_after_reopen_kv7(pk, orgs, stream, tmp_path):
    """A port ledger reopened with KV7 wired: the DeviceValidator reads
    the recovered savepoint, so the next block goes through KV7 and its
    prepared batch; a block whose flags the committer changes after the
    gate (here: tampered) is a counted stash miss and takes host MVCC,
    and the block after it goes back to KV7."""
    P = pk["port"]
    root = str(tmp_path / "port")
    _durable_run(P, orgs, stream[:4], root)
    committer, dv = stack(P, orgs, root, device=True, state_shards=4,
                          snapshot_every=2)
    assert committer.ledger.statedb.savepoint == 3
    block = parse(P, stream[4])
    committer.validator.validate(block)
    block.metadata.items[P.META_TXFLAGS] = bytes([255]) * len(block.data)
    committer.ledger.commit(block)
    assert dv.stats["validator_device_stash_misses_total"] == 1
    assert dv.stats["validator_device_blocks_total"] == 1
    codes = commit_raws(P, committer, stream[5:6])
    assert dv.stats["validator_device_blocks_total"] == 2
    assert dv.stats["validator_device_stash_misses_total"] == 1
    ref, _ = stack(pk["ref"], orgs, str(tmp_path / "ref"))
    for raw in stream[:4]:
        ref.store_block(parse(pk["ref"], raw))
    rblock = parse(pk["ref"], stream[4])
    ref.validator.validate(rblock)
    rblock.metadata.items[pk["ref"].META_TXFLAGS] = \
        bytes([255]) * len(rblock.data)
    ref.ledger.commit(rblock)
    assert commit_raws(pk["ref"], ref, stream[5:6]) == codes
    assert ledger_view(ref.ledger) == ledger_view(committer.ledger)
