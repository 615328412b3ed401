"""The port's snapshot export and install (fabric_tpu_torch.ledger.snapshot,
KVLedger.snapshot_export) against the reference's, on the CPU.

The snapshot tests of tests/test_state_shards.py (the export -> chunks
-> install -> reopen round trip, the bounded tail replay after an
install, serve_chunk refusing traversal and unknown databases), each
parametrised over both packages (`pkg`); the port's case also runs the
reference's steps and holds the outcomes equal: the export's metadata
(manifests, file list, hashes), state, history, commit hashes and
recovery counts.  Added: each package's export installed by both
packages, the installed directories byte for byte, each opened by the
other package and committing the same next block to the same commit
hash; and the port's `LedgerConfig` fields against the reference's, by
name and default.  The fetch over comm/rpc (`bootstrap_from_peers`)
across the packages is held in tests/test_torch_intake.py; blocks are
built once, by the reference.  Tolerance: exact equality."""
import dataclasses
import hashlib
import importlib
import os
import random
import types

import pytest

from fabric_tpu.msp.ca import DevOrg
from fabric_tpu.protocol import (KVWrite, NsRwSet, TxRwSet,
                                 block_header_hash, build)
from fabric_tpu.protocol.types import META_TXFLAGS

PKGS = ("ref", "port")


def load(name: str):
    root = "fabric_tpu" if name == "ref" else "fabric_tpu_torch"
    mod = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    proto, ledger = mod("protocol"), mod("ledger")
    return types.SimpleNamespace(
        name=name, proto=proto, ledger=ledger, snapshot=mod("ledger.snapshot"),
        BlockStoreError=ledger.BlockStoreError,
        wire=mod("protocol.wire") if name == "port" else None)


@pytest.fixture(scope="module")
def pk():
    return {name: load(name) for name in PKGS}


@pytest.fixture(scope="module")
def org():
    return DevOrg("Org1")


def differential(pk, pkg, scenario, *args):
    got = scenario(pk[pkg], *args)
    if pkg == "port":
        assert got == scenario(pk["ref"], *args)
    return got


def dir_bytes(root) -> dict:
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def endorser_raws(org, n_blocks=4, txs_per_block=6, start=0,
                  prev=b"\x00" * 32, seed=11):
    """tests/test_state_shards.py's envelope matrix as hash-chained
    block bytes, built once and committed to every ledger."""
    rnd = random.Random(seed)
    raws = []
    for blk in range(start, start + n_blocks):
        envs = []
        for t in range(txs_per_block):
            key = f"k{rnd.randrange(18):03d}"
            writes = [KVWrite(key, b"b%d-t%d" % (blk, t))]
            if rnd.random() < 0.25:
                writes.append(KVWrite(f"gone{t}", b"", True))
            envs.append(build.endorser_tx(
                "ch", "cc", "1.0", TxRwSet((NsRwSet("cc", writes=tuple(
                    writes)),)), org.admin, [org.admin]))
        block = build.new_block(blk, prev, envs)
        prev = block_header_hash(block.header)
        raws.append(block.serialize())
    return raws


def tail_of(org, raws, n_blocks, seed):
    """n_blocks more blocks chained to the last of raws."""
    from fabric_tpu.protocol import Block
    last = Block.deserialize(raws[-1]).header
    return endorser_raws(org, n_blocks, 3, start=last.number + 1,
                         prev=block_header_hash(last), seed=seed)


def commit_all(P, ledger, raws):
    for raw in raws:
        block = (P.wire.parse_block(raw) if P.wire
                 else P.proto.Block.deserialize(raw))
        block.metadata.items[META_TXFLAGS] = P.proto.TxFlags(
            len(block.data), P.proto.ValidationCode.VALID).to_bytes()
        ledger.commit(block)


def dump(db):
    return sorted((k, vv.value, vv.version.block_num, vv.version.tx_num)
                  for k, vv in db._data.items())


def history(lg, key="k000"):
    return [(m.block_num, m.tx_num, m.txid, m.value, m.is_delete)
            for m in lg.get_history("cc", key)]


def fetch_via_chunks(P, ledger, meta):
    """Every snapshot file assembled through serve_chunk, its manifest
    hash checked as the fetching client does."""
    payloads = {"state": [], "history": []}
    for ent in meta["files"]:
        buf = bytearray()
        while True:
            resp = P.snapshot.serve_chunk(ledger, ent["db"], ent["gen"],
                                          ent["file"], len(buf))
            buf += resp["data"]
            if resp["eof"]:
                break
        assert hashlib.sha256(bytes(buf)).hexdigest() == ent["sha256"]
        payloads[ent["db"]].append(bytes(buf))
    return payloads


def source(P, root, raws, **cfg):
    cfg = {"snapshot_every": 100, "state_shards": 4, **cfg}
    lg = P.ledger.KVLedger("ch", P.ledger.LedgerConfig(root=root, **cfg))
    commit_all(P, lg, raws)
    return lg


# ---------------------------------------------------------------------------
# tests/test_state_shards.py:256-354
# ---------------------------------------------------------------------------

def _roundtrip(P, tmp, raws, tail):
    src = source(P, os.path.join(tmp, P.name, "src"), raws)
    meta = P.snapshot.export_meta(src)
    assert meta["height"] == src.height
    assert meta["commit_hash"] == src.commit_hash
    assert any(e["db"] == "state" for e in meta["files"])
    payloads = fetch_via_chunks(P, src, meta)
    dst_root = os.path.join(tmp, P.name, "dst")
    assert P.snapshot.needs_bootstrap(dst_root, "ch")
    P.snapshot.install(dst_root, "ch", meta, payloads)
    assert not P.snapshot.needs_bootstrap(dst_root, "ch")
    dst = P.ledger.KVLedger("ch", P.ledger.LedgerConfig(root=dst_root,
                                                        state_shards=4))
    assert dst.height == src.height
    assert dst.commit_hash == src.commit_hash
    assert dst.blockstore.base == meta["height"]
    assert dump(dst.statedb) == dump(src.statedb)
    assert history(dst) == history(src)
    assert dst.last_recovery["replayed_blocks"] == 0
    with pytest.raises(P.BlockStoreError, match="pruned"):
        dst.blockstore.get_by_number(0)
    commit_all(P, src, tail)
    commit_all(P, dst, tail)
    assert dst.height == src.height and dst.commit_hash == src.commit_hash
    return (meta, dump(dst.statedb), history(dst), dst.commit_hash,
            dir_bytes(dst_root))


@pytest.mark.parametrize("pkg", PKGS)
def test_snapshot_roundtrip_installs_and_reopens(pk, pkg, org, tmp_path):
    raws = endorser_raws(org, n_blocks=5)
    tail = tail_of(org, raws, 1, seed=12)
    meta, *_ = differential(pk, pkg, _roundtrip, str(tmp_path), raws, tail)
    assert meta["height"] == 5 and meta["history_manifest"] is not None


def _tail_replay(P, tmp, raws, tail):
    src = source(P, os.path.join(tmp, P.name, "src"), raws)
    meta = P.snapshot.export_meta(src)
    payloads = fetch_via_chunks(P, src, meta)
    dst_root = os.path.join(tmp, P.name, "dst")
    P.snapshot.install(dst_root, "ch", meta, payloads)
    dst = P.ledger.KVLedger("ch", P.ledger.LedgerConfig(root=dst_root,
                                                        state_shards=4))
    commit_all(P, src, tail)
    commit_all(P, dst, tail)
    os.remove(os.path.join(dst_root, "ch", "state", "state.wal"))
    re = P.ledger.KVLedger("ch", P.ledger.LedgerConfig(root=dst_root,
                                                       state_shards=4))
    assert re.commit_hash == src.commit_hash
    assert dump(re.statedb) == dump(src.statedb)
    assert re.last_recovery["start"] >= meta["height"]
    assert re.last_recovery["replayed_blocks"] == 2
    return re.last_recovery, re.commit_hash, dump(re.statedb)


@pytest.mark.parametrize("pkg", PKGS)
def test_snapshot_install_tail_replay_bounded(pk, pkg, org, tmp_path):
    raws = endorser_raws(org, n_blocks=3)
    tail = tail_of(org, raws, 2, seed=13)
    rec, *_ = differential(pk, pkg, _tail_replay, str(tmp_path), raws, tail)
    assert rec == {"replayed_blocks": 2, "start": 3, "height": 5}


def _refusals(P, tmp, raws):
    src = source(P, os.path.join(tmp, P.name), raws, snapshot_every=256,
                 state_shards=2)
    meta = P.snapshot.export_meta(src)
    ent = meta["files"][0]
    errors = []
    with pytest.raises(P.snapshot.SnapshotError) as e:
        P.snapshot.serve_chunk(src, "wat", ent["gen"], ent["file"], 0)
    errors.append(str(e.value))
    for bad in ("../MANIFEST", "shard_0000.bin/../../MANIFEST",
                "MANIFEST", "shard_.evil"):
        with pytest.raises(P.snapshot.SnapshotError) as e:
            P.snapshot.serve_chunk(src, "state", ent["gen"], bad, 0)
        errors.append(str(e.value))
    with pytest.raises(P.snapshot.SnapshotError, match="gone"):
        P.snapshot.serve_chunk(src, "state", 99999, ent["file"], 0)
    mem = P.ledger.KVLedger("ch", P.ledger.LedgerConfig())
    commit_all(P, mem, raws)
    with pytest.raises(P.snapshot.SnapshotError, match="nothing"):
        P.snapshot.export_meta(mem)
    assert mem.snapshot_export() == (None, None)
    return errors


@pytest.mark.parametrize("pkg", PKGS)
def test_serve_chunk_rejects_traversal_and_unknown_db(pk, pkg, org,
                                                      tmp_path):
    raws = endorser_raws(org, n_blocks=1, txs_per_block=2)
    errors = differential(pk, pkg, _refusals, str(tmp_path), raws)
    assert "unknown snapshot db" in errors[0]
    assert all("invalid snapshot file name" in e for e in errors[1:])


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("exporter", PKGS)
def test_snapshot_installs_in_the_other_package(pk, exporter, org,
                                                tmp_path):
    """One package exports (serve_chunk assembles every file); both
    install it: the directories are byte for byte equal; each package
    opens the other's install at the same height, state, history and
    commit hash, and commits the same next blocks to the same hash."""
    raws = endorser_raws(org, n_blocks=4)
    tail = tail_of(org, raws, 2, seed=14)
    E = pk[exporter]
    src = source(E, str(tmp_path / "src"), raws)
    meta = E.snapshot.export_meta(src)
    payloads = fetch_via_chunks(E, src, meta)
    other = pk["port" if exporter == "ref" else "ref"]
    # the other package's export of the same chain describes the same
    # files with the same hashes
    twin = source(other, str(tmp_path / "twin"), raws)
    assert other.snapshot.export_meta(twin) == meta
    for name in PKGS:
        pk[name].snapshot.install(str(tmp_path / f"by_{name}"), "ch", meta,
                                  payloads)
    assert dir_bytes(tmp_path / "by_ref") == dir_bytes(tmp_path / "by_port")
    views = {}
    for installer, opener in (("ref", "port"), ("port", "ref")):
        O = pk[opener]
        lg = O.ledger.KVLedger("ch", O.ledger.LedgerConfig(
            root=str(tmp_path / f"by_{installer}"), state_shards=4))
        view = [lg.height, lg.commit_hash, dump(lg.statedb), history(lg)]
        commit_all(O, lg, tail)
        views[opener] = view + [lg.height, lg.commit_hash,
                                dump(lg.statedb)]
    commit_all(E, src, tail)
    assert views["ref"] == views["port"]
    assert views["ref"][:2] == [4, meta["commit_hash"]]
    assert views["ref"][4:6] == [src.height, src.commit_hash]


def test_ledger_config_fields_equal_the_reference(pk):
    """The port's LedgerConfig takes every field the reference's does,
    in the same order, with the same defaults."""
    def fields(P):
        return [(f.name, f.default) for f in
                dataclasses.fields(P.ledger.LedgerConfig)]
    assert fields(pk["port"]) == fields(pk["ref"])
    names = [n for n, _ in fields(pk["port"])]
    for name in ("parallel_commit", "commit_workers", "commit_adaptive",
                 "commit_serial_fallback", "commit_window"):
        assert name in names
    for meth in ("commit_begin", "commit_finish", "abort_window",
                 "pending_overlay", "snapshot_export"):
        assert callable(getattr(pk["port"].ledger.KVLedger, meth))


@pytest.mark.parametrize("pkg", PKGS)
def test_state_status_reports_scheduler_and_window(pk, pkg, org):
    raws = endorser_raws(org, n_blocks=2)

    def status(P):
        lg = P.ledger.KVLedger("ch", P.ledger.LedgerConfig(
            parallel_commit=True, commit_window=3, commit_workers=2))
        commit_all(P, lg, raws)
        st = lg.state_status()
        win = st["commit_window"]
        return (st["commit_serial_fallbacks"] >= 0, st["height"],
                st["commit_hash"],
                {k: win[k] for k in ("depth", "max_window", "admitted",
                                     "retired")})
    _ok, height, _h, win = differential(pk, pkg, status)
    assert height == 2 and win == {"depth": 0, "max_window": 3,
                                   "admitted": 0, "retired": 0}
