"""The port's wavefront parallel commit, commit window and pipelined
committer (fabric_tpu_torch.committer.parallel_commit.scheduler,
KVLedger.commit_begin / commit_finish / abort_window,
committer.PipelinedCommitter) against the reference's, on the CPU.

Every test of tests/test_parallel_commit.py about the scheduler, the
window and the pipeline runs here on both packages (`pkg`): each case
runs the reference test's steps and asserts its expectations on one
package, and the port's case also runs them on the reference and holds
the two outcomes equal: the flags' bytes, the `UpdateBatch` items in
insertion order, the history list, state and commit hash.  The
reference's ops-plane counters have no counterpart in the port (they
wait for its ops plane); the port's cases read the scheduler's own
counts (`ParallelCommitScheduler.stats()`) instead.  Added: the
seeded 300-tx stream of tests/test_torch_early_abort.py through the
port's `PipelinedCommitter` on `CudaProvider(device="cpu")` (the
kernels' plain versions) against the reference's on `SoftwareProvider`,
on the deep, classic and KV7 tails, early abort wired to
`ledger.pending_overlay`; a retire failure breaking both pipelines the
same way; a config block draining the window.  Envelopes are built
once, by the reference; each package parses their bytes.  Tolerance:
exact equality."""
import dataclasses
import importlib
import os
import random
import threading
import types

import pytest

from fabric_tpu.msp.ca import DevOrg
from fabric_tpu.protocol import (Envelope, KVRead, KVWrite, NsRwSet, TxRwSet,
                                 Version, block_header_hash, build)
from fabric_tpu.protocol.types import META_TXFLAGS, RangeQueryInfo

PKGS = ("ref", "port")
# the window's counts (its times differ from run to run)
COUNTS = ("depth", "max_window", "admitted", "retired", "early_txs",
          "deferred_txs")


def load(name: str):
    root = "fabric_tpu" if name == "ref" else "fabric_tpu_torch"
    mod = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    proto, ledger = mod("protocol"), mod("ledger")
    factory = mod("bccsp.factory" if name == "ref" else "bccsp")
    return types.SimpleNamespace(
        name=name, proto=proto, ledger=ledger, mvcc=mod("ledger.mvcc"),
        pc=mod("committer.parallel_commit"), committer=mod("committer"),
        msp=mod("msp"), policy=mod("policy"), config=mod("config"),
        sbe=mod("committer.sbe"),
        wire=mod("protocol.wire") if name == "port" else None,
        sw=factory.init_factories(factory.FactoryOpts(default="SW")))


@pytest.fixture(scope="module")
def pk():
    return {name: load(name) for name in PKGS}


@pytest.fixture(scope="module")
def org():
    return DevOrg("Org1")


def dir_bytes(root) -> dict:
    """{path relative to root: bytes} of every file under root."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def differential(pk, pkg, scenario, *args, **kw):
    """scenario(P, *args, **kw) on `pkg`; on the port also on the
    reference, the two outcomes held equal."""
    got = scenario(pk[pkg], *args, **kw)
    if pkg == "port":
        assert got == scenario(pk["ref"], *args, **kw)
    return got


def tx(org, rwset):
    return build.endorser_tx("ch", "cc", "1.0", rwset, org.admin, [org.admin])


def rw(reads=(), writes=(), ns="cc", rqs=()):
    return TxRwSet((NsRwSet(ns, reads=tuple(reads), writes=tuple(writes),
                            range_queries=tuple(rqs)),))


def envs_of(P, envs):
    """The package's envelopes, parsed from the reference's bytes."""
    return [P.proto.Envelope.deserialize(e.serialize()) for e in envs]


def block_of(P, raw: bytes):
    return P.wire.parse_block(raw) if P.wire else P.proto.Block.deserialize(
        raw)


def chain(env_blocks, start: int = 0, prev: bytes = b"\x00" * 32):
    """The blocks' wire bytes, numbered and hash-chained from `start`."""
    raws = []
    for num, envs in enumerate(env_blocks, start=start):
        block = build.new_block(num, prev, envs)
        prev = block_header_hash(block.header)
        raws.append(block.serialize())
    return raws


def flagged(P, raw: bytes, codes=()):
    """A block of `raw` with all-VALID metadata flags, then `codes`."""
    block = block_of(P, raw)
    flags = P.proto.TxFlags(len(block.data), P.proto.ValidationCode.VALID)
    for t, code in codes:
        flags.set(t, P.proto.ValidationCode(code))
    block.metadata.items[META_TXFLAGS] = flags.to_bytes()
    return block


def seeded_db(P, n_keys=20):
    """Committed state k00..k{n-1} = b"v<i>" at Version(1, i)."""
    db = P.ledger.StateDB()
    b = P.ledger.UpdateBatch()
    for i in range(n_keys):
        b.put("cc", f"k{i:02d}", b"v%d" % i, P.proto.Version(1, i))
    db.apply_updates(b, 1)
    return db


def norm(flags, batch, history):
    """Comparable snapshot, batch.items() insertion order included."""
    items = [(k, None if vv is None else
              (vv.value, vv.version.block_num, vv.version.tx_num))
             for k, vv in batch.items()]
    return flags.to_bytes(), items, list(history)


def three_way(P, envs, block_num=2, pre=()):
    """The serial oracle vs the scheduler at 4 and 1 workers, on fresh
    DBs, held bit-identical -> the oracle's normalized output.  `pre`:
    [(tx_num, code)] set on the flags first (gate failures)."""
    envs = envs_of(P, envs)
    outs = []
    for workers in (None, 4, 1):
        db = seeded_db(P)
        flags = P.proto.TxFlags(len(envs), P.proto.ValidationCode.VALID)
        for t, code in pre:
            flags.set(t, P.proto.ValidationCode(code))
        if workers is None:
            batch, history = P.mvcc.validate_and_prepare_batch(
                db, block_num, envs, flags)
        else:
            sched = P.pc.ParallelCommitScheduler(
                max_workers=workers, channel_id="t", serial_fallback=False)
            try:
                batch, history = sched.validate_and_prepare_batch(
                    db, block_num, envs, flags)
            finally:
                sched.close()
        outs.append(norm(flags, batch, history))
    assert outs[0] == outs[1], "serial vs 4-worker diverged"
    assert outs[0] == outs[2], "serial vs 1-worker diverged"
    return outs[0]


def codes(out):
    return list(out[0])


# ---------------------------------------------------------------------------
# tests/test_parallel_commit.py:104-249 — corpora, fuzz, ledger identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_corpus_ww_chains_same_key(pk, pkg, org):
    v10 = Version(1, 0)
    envs = [
        tx(org, rw(reads=[KVRead("k00", v10)], writes=[KVWrite("k00", b"a")])),
        tx(org, rw(reads=[KVRead("k00", v10)], writes=[KVWrite("k00", b"b")])),
        tx(org, rw(reads=[KVRead("k00", Version(2, 0))],
                   writes=[KVWrite("k00", b"c")])),
        tx(org, rw(reads=[KVRead("k00", Version(2, 2))])),
        tx(org, rw(reads=[KVRead("k00", Version(2, 1))])),
    ]
    out = differential(pk, pkg, three_way, envs)
    assert codes(out) == [0, 11, 0, 0, 11]
    assert out[1][-1][1][0] == b"c"
    assert [h[0] for h in out[2]] == [0, 2]


@pytest.mark.parametrize("pkg", PKGS)
def test_corpus_range_phantoms(pk, pkg, org):
    def rec(i):
        return KVRead(f"k{i:02d}", Version(1, i))
    rq_full = RangeQueryInfo("k05", "k08", True, (rec(5), rec(6), rec(7)))
    rq_open = RangeQueryInfo("k05", "k08", False, (rec(5), rec(6)))
    envs = [
        tx(org, rw(rqs=[rq_full], writes=[KVWrite("z0", b"1")])),
        tx(org, rw(writes=[KVWrite("k06", b"new")])),
        tx(org, rw(rqs=[rq_full], writes=[KVWrite("z1", b"1")])),
        tx(org, rw(writes=[KVWrite("k09", b"x")])),
        tx(org, rw(rqs=[RangeQueryInfo("k10", "k12", True,
                                       (rec(10), rec(11)))],
                   writes=[KVWrite("z2", b"1")])),
        tx(org, rw(rqs=[rq_open])),
        tx(org, rw(writes=[KVWrite("k05", b"", True)])),
        tx(org, rw(rqs=[RangeQueryInfo("k10", "k12", False, (rec(10),))],
                   writes=[KVWrite("z3", b"1")])),
    ]
    out = differential(pk, pkg, three_way, envs)
    assert codes(out) == [0, 0, 12, 0, 0, 12, 0, 0]


@pytest.mark.parametrize("pkg", PKGS)
def test_corpus_delete_then_read(pk, pkg, org):
    envs = [
        tx(org, rw(writes=[KVWrite("k03", b"", True)])),
        tx(org, rw(reads=[KVRead("k03", Version(1, 3))])),
        tx(org, rw(reads=[KVRead("k03", None)],
                   writes=[KVWrite("k03", b"back")])),
        tx(org, rw(reads=[KVRead("k03", Version(2, 2))])),
    ]
    out = differential(pk, pkg, three_way, envs)
    assert codes(out) == [0, 11, 0, 0]
    assert [(h[0], h[5]) for h in out[2]] == [(0, True), (2, False)]


@pytest.mark.parametrize("pkg", PKGS)
def test_corpus_parse_failures_config_and_gate_skips(pk, pkg, org):
    cfg_env = build.signed_envelope("config", "ch", {"data": b"{}"},
                                    org.admin)
    envs = [
        tx(org, rw(writes=[KVWrite("k01", b"won")])),
        Envelope(b"\xde\xad\xbe\xef", b""),
        cfg_env,
        tx(org, rw(writes=[KVWrite("k01", b"gate-loser")])),
        tx(org, rw(reads=[KVRead("k01", Version(2, 0))])),
    ]
    out = differential(pk, pkg, three_way, envs, 2, [(3, 10)])
    assert codes(out) == [0, 22, 0, 10, 0]
    assert dict(out[1])[("cc", "k01")][0] == b"won"


@pytest.mark.parametrize("pkg", PKGS)
def test_corpus_all_conflict_and_no_conflict(pk, pkg, org):
    bogus = [tx(org, rw(reads=[KVRead(f"k{i:02d}", Version(9, 9))],
                        writes=[KVWrite(f"k{i:02d}", b"x")]))
             for i in range(8)]
    out = differential(pk, pkg, three_way, bogus)
    assert codes(out) == [11] * 8 and not out[1] and not out[2]
    clean = [tx(org, rw(reads=[KVRead(f"k{i:02d}", Version(1, i))],
                        writes=[KVWrite(f"n{i}", b"y")]))
             for i in range(8)]
    out = differential(pk, pkg, three_way, clean)
    assert codes(out) == [0] * 8 and len(out[1]) == 8


def random_envs(rng, org, keys=tuple(f"k{i:02d}" for i in range(12))):
    envs = []
    for _t in range(rng.randrange(1, 10)):
        reads, writes, rqs = [], [], []
        for _ in range(rng.randrange(0, 3)):
            k = rng.choice(keys)
            ver = rng.choice([Version(1, int(k[1:])), Version(7, 7), None])
            reads.append(KVRead(k, ver))
        for _ in range(rng.randrange(0, 3)):
            k = rng.choice(keys)
            if rng.random() < 0.25:
                writes.append(KVWrite(k, b"", True))
            else:
                writes.append(KVWrite(k, rng.randbytes(4)))
        if rng.random() < 0.3:
            lo, hi = sorted(rng.sample(range(12), 2))
            recs = tuple(KVRead(f"k{i:02d}", Version(1, i))
                         for i in range(lo, hi))
            rqs.append(RangeQueryInfo(f"k{lo:02d}", f"k{hi:02d}",
                                      rng.random() < 0.5, recs))
        envs.append(tx(org, rw(reads=reads, writes=writes, rqs=rqs)))
    return envs


@pytest.mark.parametrize("pkg", PKGS)
def test_differential_fuzz_random_blocks(pk, pkg, org):
    """25 seeded random blocks: the scheduler tracks the oracle at every
    worker count, and the port's outputs equal the reference's."""
    for seed in range(25):
        differential(pk, pkg, three_way, random_envs(random.Random(seed),
                                                     org))


def pipeline_blocks(org):
    b0 = [tx(org, rw(writes=[KVWrite(f"k{i}", b"v%d" % i)]))
          for i in range(6)]
    b1 = [
        tx(org, rw(reads=[KVRead("k0", Version(0, 0))],
                   writes=[KVWrite("k0", b"w")])),
        tx(org, rw(reads=[KVRead("k0", Version(0, 0))],
                   writes=[KVWrite("k0", b"lose")])),
        tx(org, rw(writes=[KVWrite("k1", b"", True)])),
        tx(org, rw(reads=[KVRead("k1", None)])),
        tx(org, rw(rqs=[RangeQueryInfo(
            "k2", "k5", True,
            (KVRead("k2", Version(0, 2)), KVRead("k3", Version(0, 3)),
             KVRead("k4", Version(0, 4))))],
            writes=[KVWrite("k9", b"rq")])),
    ]
    return b0, b1


def _parallel_vs_serial(P, raws):
    results = []
    for parallel in (False, True):
        lg = P.ledger.KVLedger("ch", P.ledger.LedgerConfig(
            parallel_commit=parallel, commit_workers=4,
            commit_serial_fallback=False))
        for raw in raws:
            lg.commit(flagged(P, raw))
        state = {k: lg.get_state("cc", k) for k in
                 [f"k{i}" for i in range(10)]}
        hist = [(m.value, m.is_delete) for m in lg.get_history("cc", "k0")]
        results.append((lg.commit_hash, state, hist))
    assert results[0] == results[1]
    return results[1]


@pytest.mark.parametrize("pkg", PKGS)
def test_kvledger_parallel_matches_serial_commit_hash(pk, pkg, org):
    raws = chain(pipeline_blocks(org))
    _h, state, _hist = differential(pk, pkg, _parallel_vs_serial, raws)
    assert state["k0"] == b"w" and state["k1"] is None


# ---------------------------------------------------------------------------
# tests/test_parallel_commit.py:519-590 — the adaptive pool, the fallback
# ---------------------------------------------------------------------------

def _adaptive(P):
    s = P.pc.ParallelCommitScheduler(max_workers=8, channel_id="ch",
                                     adaptive=True, width_window=4)
    seen = [s.target_workers(1), s.target_workers(3), s.target_workers(16)]
    for _ in range(4):
        last = s.target_workers(1)
    seen.append(last)
    pinned = P.pc.ParallelCommitScheduler(max_workers=8, adaptive=False)
    seen.append(pinned.target_workers(1))
    pool_a = s._executor(2)
    sizes = [s._pool_size]
    pool_b = s._executor(5)
    sizes.append(s._pool_size)
    same = s._executor(5) is pool_b
    s.close()
    return seen, sizes, pool_b is not pool_a, same


@pytest.mark.parametrize("pkg", PKGS)
def test_adaptive_pool_tracks_rolling_wave_width(pk, pkg):
    seen, sizes, swapped, stable = differential(pk, pkg, _adaptive)
    assert seen == [1, 3, 8, 1, 8]
    assert sizes == [2, 5] and swapped and stable


def fallback_envs(org, n=4):
    return [tx(org, rw(writes=[KVWrite(f"k{i:02d}", b"f%d" % i)]))
            for i in range(n)]


def _fallback(P, envs, **kw):
    """The scheduler with `kw` against the oracle -> (normalized output,
    fallbacks, waves, max width)."""
    envs = envs_of(P, envs)
    flags_o = P.proto.TxFlags(len(envs), P.proto.ValidationCode.VALID)
    flags_s = P.proto.TxFlags(len(envs), P.proto.ValidationCode.VALID)
    want = norm(flags_o, *P.mvcc.validate_and_prepare_batch(
        seeded_db(P), 2, envs, flags_o))
    sched = P.pc.ParallelCommitScheduler(max_workers=4, channel_id="fb",
                                         **kw)
    try:
        got = norm(flags_s, *sched.validate_and_prepare_batch(
            seeded_db(P), 2, envs, flags_s))
    finally:
        sched.close()
    assert got == want
    if P.name == "port":
        st = sched.stats()
        assert st["serial_fallbacks"] == sum(
            st["fallback_reasons"].values())
    return got, sched.serial_fallbacks, sched.last_waves, \
        sched.last_max_width


@pytest.mark.parametrize("pkg", PKGS)
def test_serial_fallback_one_core_matches_oracle(pk, pkg, org):
    _out, fallbacks, waves, width = differential(
        pk, pkg, _fallback, fallback_envs(org), host_cores=1)
    assert fallbacks == 1 and waves == 0 and width == 0
    if pkg == "port":
        P = pk["port"]
        sched = P.pc.ParallelCommitScheduler(host_cores=1)
        envs = envs_of(P, fallback_envs(org))
        sched.validate_and_prepare_batch(
            seeded_db(P), 2, envs, P.proto.TxFlags(len(envs), 0))
        assert sched.stats()["fallback_reasons"] == {"one_core": 1}


@pytest.mark.parametrize("pkg", PKGS)
def test_serial_fallback_disabled_keeps_wave_path(pk, pkg, org):
    _out, fallbacks, waves, _w = differential(
        pk, pkg, _fallback, fallback_envs(org), host_cores=1,
        serial_fallback=False)
    assert fallbacks == 0 and waves >= 1


@pytest.mark.parametrize("pkg", PKGS)
def test_serial_fallback_narrow_block_counted(pk, pkg, org):
    envs = [tx(org, rw(reads=[KVRead("k00", Version(1, 0) if i == 0
                                     else Version(2, i - 1))],
                       writes=[KVWrite("k00", b"c%d" % i)]))
            for i in range(4)]
    _out, fallbacks, waves, width = differential(
        pk, pkg, _fallback, envs, host_cores=4)
    assert fallbacks == 1 and waves == 4 and width == 1
    if pkg == "port":
        P = pk["port"]
        sched = P.pc.ParallelCommitScheduler(host_cores=4)
        penvs = envs_of(P, envs)
        sched.validate_and_prepare_batch(
            seeded_db(P), 2, penvs, P.proto.TxFlags(len(penvs), 0))
        assert sched.stats()["fallback_reasons"] == {"narrow": 1}
        assert sched.stats()["widths"] == [1]


# ---------------------------------------------------------------------------
# tests/test_parallel_commit.py:679-955 — the cross-block window
# ---------------------------------------------------------------------------

def stream_serial(P, raws, root=None):
    lg = P.ledger.KVLedger("ch", P.ledger.LedgerConfig(root=root))
    for raw in raws:
        lg.commit(flagged(P, raw))
    return lg


def stream_windowed(P, raws, W, root=None, batches=None):
    """The stream through commit_begin / commit_finish with up to W
    blocks in flight; `batches` collects each finish's (batch, history)
    normalized."""
    lg = P.ledger.KVLedger("ch", P.ledger.LedgerConfig(root=root,
                                                       commit_window=W))
    if batches is not None:
        real = lg._commit_window.finish

        def finish(db, entry):
            batch, history = real(db, entry)
            batches.append(norm(entry.flags, batch, history))
            return batch, history
        lg._commit_window.finish = finish
    tickets = []
    for raw in raws:
        tickets.append(lg.commit_begin(flagged(P, raw)))
        if len(tickets) >= W:
            lg.commit_finish(tickets.pop(0))
    while tickets:
        lg.commit_finish(tickets.pop(0))
    return lg


def ledger_snapshot(P, lg, keys):
    flags = [bytes(lg.blockstore.get_by_number(n).metadata.items[
        META_TXFLAGS]) for n in range(lg.height)]
    state = {k: lg.get_state("cc", k) for k in keys}
    hist = {k: [(m.block_num, m.tx_num, m.value, m.is_delete)
                for m in lg.get_history("cc", k)] for k in keys}
    return lg.commit_hash, flags, state, hist


def stream_identical(P, raws, keys, windows=(1, 2, 4)):
    """Serial against W in `windows`, held identical -> (the serial
    snapshot, each W's finished batches, each W's window stats)."""
    want = ledger_snapshot(P, stream_serial(P, raws), keys)
    batches, stats = {}, {}
    for W in windows:
        batches[W] = []
        lg = stream_windowed(P, raws, W, batches=batches[W])
        assert ledger_snapshot(P, lg, keys) == want, \
            f"windowed W={W} diverged from serial"
        st = lg._commit_window.stats()
        stats[W] = {k: st[k] for k in COUNTS}
    return want, batches, stats


@pytest.mark.parametrize("pkg", PKGS)
def test_window_adjacent_block_ww_wr_rw_chains(pk, pkg, org):
    b0 = [tx(org, rw(writes=[KVWrite(f"k{i}", b"v%d" % i)]))
          for i in range(4)]
    b1 = [tx(org, rw(reads=[KVRead("k0", Version(1, 0))],
                     writes=[KVWrite("k0", b"w1")])),
          tx(org, rw(writes=[KVWrite("k1", b"blind")])),
          tx(org, rw(writes=[KVWrite("z0", b"z")]))]
    b2 = [tx(org, rw(reads=[KVRead("k0", Version(1, 0))])),
          tx(org, rw(reads=[KVRead("k0", Version(2, 0))],
                     writes=[KVWrite("k0", b"w2")]))]
    keys = [f"k{i}" for i in range(4)] + ["z0"]
    _want, _b, stats = differential(pk, pkg, stream_identical,
                                    chain([b0, b1, b2]), keys)
    assert stats[2]["deferred_txs"] >= 2
    assert stats[2]["early_txs"] >= 2


def _graph(P, envs, blocks, keys):
    """Block-level white box: the conflict graph of `envs` against an
    overlay of `blocks` writing `keys` -> (xblock counts, deferred)."""
    parsed = [(i, P.mvcc.parse_endorser_tx(e)[1])
              for i, e in enumerate(envs_of(P, envs))]
    g = P.pc.ConflictGraph([P.pc.footprint_of(i, r) for i, r in parsed],
                           overlay=P.pc.PendingOverlay(blocks, keys))
    return dict(g.xblock_counts), sorted(g.deferred)


@pytest.mark.parametrize("pkg", PKGS)
def test_window_cross_block_range_phantom(pk, pkg, org):
    b0 = [tx(org, rw(writes=[KVWrite("k25", b"phantom")]))]
    scan = tx(org, rw(rqs=[RangeQueryInfo(
        "k2", "k5", True,
        (KVRead("k2", Version(1, 2)), KVRead("k3", Version(1, 3)),
         KVRead("k4", Version(1, 4))))], writes=[KVWrite("z1", b"s")]))
    b1 = [scan, tx(org, rw(writes=[KVWrite("z2", b"i")]))]
    seed = [tx(org, rw(writes=[KVWrite(f"k{i:02d}", b"v%d" % i)]))
            for i in range(6)]
    differential(pk, pkg, stream_identical, chain([seed, b0, b1]),
                 [f"k{i:02d}" for i in range(6)] + ["k25", "z1", "z2"])
    counts, deferred = differential(pk, pkg, _graph, b1, [1],
                                    [("cc", "k25")])
    assert counts["xrange"] == 1 and deferred == [0]


@pytest.mark.parametrize("pkg", PKGS)
def test_window_doomed_then_rewritten_key(pk, pkg, org):
    b0 = [tx(org, rw(writes=[KVWrite(f"k{i:02d}", b"v%d" % i)]))
          for i in range(4)]
    b1 = [tx(org, rw(reads=[KVRead("k00", Version(9, 9))],
                     writes=[KVWrite("k50", b"never")])),
          tx(org, rw(reads=[KVRead("k01", Version(1, 1))],
                     writes=[KVWrite("k01", b"won")]))]
    b2 = [tx(org, rw(reads=[KVRead("k50", None)],
                     writes=[KVWrite("z3", b"ok")])),
          tx(org, rw(reads=[KVRead("k01", Version(2, 1))]))]
    keys = [f"k{i:02d}" for i in range(4)] + ["k50", "z3"]
    differential(pk, pkg, stream_identical, chain([b0, b1, b2]), keys)
    _c, deferred = differential(pk, pkg, _graph, b2, [2],
                                [("cc", "k50"), ("cc", "k01")])
    assert deferred == [0, 1]


def window_fuzz_blocks(rng, org, keys):
    blocks = [[tx(org, rw(writes=[KVWrite(k, b"s%d" % i)]))
               for i, k in enumerate(keys[:8])]]
    for _b in range(rng.randrange(2, 5)):
        envs = []
        for _t in range(rng.randrange(1, 6)):
            reads, writes, rqs = [], [], []
            for _ in range(rng.randrange(0, 3)):
                k = rng.choice(keys)
                ver = rng.choice([Version(0, int(k[1:])), Version(7, 7),
                                  None])
                reads.append(KVRead(k, ver))
            for _ in range(rng.randrange(0, 3)):
                k = rng.choice(keys)
                if rng.random() < 0.25:
                    writes.append(KVWrite(k, b"", True))
                else:
                    writes.append(KVWrite(k, rng.randbytes(4)))
            if rng.random() < 0.3:
                lo, hi = sorted(rng.sample(range(12), 2))
                recs = tuple(KVRead(f"k{i:02d}", Version(0, i))
                             for i in range(lo, min(hi, 8)))
                rqs.append(RangeQueryInfo(f"k{lo:02d}", f"k{hi:02d}",
                                          rng.random() < 0.5, recs))
            envs.append(tx(org, rw(reads=reads, writes=writes, rqs=rqs)))
        blocks.append(envs)
    return blocks


@pytest.mark.parametrize("pkg", PKGS)
def test_window_differential_fuzz_25_seeds(pk, pkg, org):
    """Seeded random streams through {serial, W=1, 2, 4}: flags, state,
    history and commit hash bit-exact, each finish's batch and history
    equal between the packages."""
    keys = [f"k{i:02d}" for i in range(12)]
    for seed in range(25):
        raws = chain(window_fuzz_blocks(random.Random(1000 + seed), org,
                                        keys))
        differential(pk, pkg, stream_identical, raws, keys)


def _window_level(P, blocks):
    """CommitWindow.admit / finish against the serial oracle, block by
    block -> the normalized outputs."""
    db_s, out = seeded_db(P), []
    for num, envs in enumerate(blocks, start=2):
        envs = envs_of(P, envs)
        flags = P.proto.TxFlags(len(envs), P.proto.ValidationCode.VALID)
        batch, hist = P.mvcc.validate_and_prepare_batch(db_s, num, envs,
                                                        flags)
        out.append(norm(flags, batch, hist))
        db_s.apply_updates(batch, num)
    db_w = seeded_db(P)
    window = P.pc.CommitWindow(channel_id="t", max_window=3)
    entries = [window.admit(db_w, num, b"h%d" % num, envs_of(P, envs),
                            P.proto.TxFlags(len(envs),
                                            P.proto.ValidationCode.VALID))
               for num, envs in enumerate(blocks, start=2)]
    for entry in entries:
        batch, hist = window.finish(db_w, entry)
        assert norm(entry.flags, batch, hist) == out[entry.num - 2]
        window.apply_started()
        db_w.apply_updates(batch, entry.num)
        window.apply_ended()
        window.retire(entry)
    return out, [(e.early_n, e.deferred_n) for e in entries]


@pytest.mark.parametrize("pkg", PKGS)
def test_window_level_batch_insertion_order_fuzz(pk, pkg, org):
    keys = [f"k{i:02d}" for i in range(10)]
    for seed in range(10):
        rng = random.Random(7000 + seed)
        blocks = []
        for _b in range(3):
            envs = []
            for _t in range(rng.randrange(1, 5)):
                reads = [KVRead(rng.choice(keys),
                                rng.choice([Version(1, 3), None]))
                         for _ in range(rng.randrange(0, 2))]
                writes = [KVWrite(rng.choice(keys), rng.randbytes(3))
                          for _ in range(rng.randrange(0, 3))]
                envs.append(tx(org, rw(reads=reads, writes=writes)))
            blocks.append(envs)
        differential(pk, pkg, _window_level, blocks)


def _guards(P, raws):
    lg = P.ledger.KVLedger("ch", P.ledger.LedgerConfig(commit_window=2))
    blocks = [flagged(P, raw) for raw in raws]
    seen = []
    t0 = lg.commit_begin(blocks[0])
    bad = flagged(P, chain([[]], start=5)[0])
    with pytest.raises(ValueError, match="out-of-order"):
        lg.commit_begin(bad)
    with pytest.raises(RuntimeError, match="pipelined window"):
        lg.commit(bad)
    t1 = lg.commit_begin(blocks[1])
    with pytest.raises(RuntimeError, match="window full"):
        lg.commit_begin(blocks[2])
    with pytest.raises(RuntimeError, match="out of order"):
        lg.commit_finish(t1)
    seen.append(lg.commit_finish(t0).valid_txs)
    seen.append(lg.commit_finish(t1).valid_txs)
    assert lg.height == 2 and lg._commit_window.depth() == 0
    # the serial path is open again once the window is empty
    lg.commit(blocks[2])
    assert lg.pending_overlay().empty
    plain = P.ledger.KVLedger("ch", P.ledger.LedgerConfig())
    assert plain.pending_overlay() is None and plain.abort_window() == 0
    with pytest.raises(RuntimeError, match="disabled"):
        plain.commit_begin(blocks[0])
    st = lg.state_status()["commit_window"]
    return seen, lg.commit_hash, {k: st[k] for k in COUNTS}


@pytest.mark.parametrize("pkg", PKGS)
def test_window_ordering_and_depth_guards(pk, pkg, org):
    b = [tx(org, rw(writes=[KVWrite("k0", b"x")]))]
    seen, _h, st = differential(pk, pkg, _guards, chain([b, b, b]))
    assert seen == [1, 1] and st["retired"] == 2 and st["depth"] == 0


def crash_blocks(org):
    return [
        [tx(org, rw(writes=[KVWrite(f"k{i}", b"v%d" % i)]))
         for i in range(4)],
        [tx(org, rw(reads=[KVRead("k0", Version(1, 0))],
                    writes=[KVWrite("k0", b"w")]))],
        [tx(org, rw(writes=[KVWrite("z0", b"z")]))],
        [tx(org, rw(reads=[KVRead("z0", Version(3, 0))],
                    writes=[KVWrite("z1", b"zz")]))],
    ]


def _crash(P, raws, keys, root):
    want = ledger_snapshot(P, stream_serial(P, raws), keys)
    lg = P.ledger.KVLedger("ch", P.ledger.LedgerConfig(root=root,
                                                       commit_window=4))
    blocks = [flagged(P, raw) for raw in raws]
    tickets = [lg.commit_begin(b) for b in blocks]
    lg.commit_finish(tickets[0])
    lg.commit_finish(tickets[1])
    assert lg.abort_window() == 2
    lg2 = P.ledger.KVLedger("ch", P.ledger.LedgerConfig(root=root))
    assert lg2.height == 2
    assert lg2.last_recovery["replayed_blocks"] == 0
    # redelivery: the dropped blocks' metadata is untouched by the window
    for block in blocks[2:]:
        lg2.commit(block)
    got = ledger_snapshot(P, lg2, keys)
    assert got == want
    return got


@pytest.mark.parametrize("pkg", PKGS)
def test_window_crash_recovery_replays_exactly_once(pk, pkg, org,
                                                    tmp_path):
    raws = chain(crash_blocks(org))
    keys = [f"k{i}" for i in range(4)] + ["z0", "z1"]
    got = _crash(pk[pkg], raws, keys, str(tmp_path / pkg))
    if pkg == "port":
        assert got == _crash(pk["ref"], raws, keys, str(tmp_path / "ref"))
        # and the two ledger directories, byte for byte
        assert dir_bytes(tmp_path / "port") == dir_bytes(tmp_path / "ref")


def _overlay_guard(P, envs):
    db = seeded_db(P)
    raw = chain([envs], start=4)[0]
    block = block_of(P, raw)
    an = P.pc.EarlyAbortAnalyzer(db, "ch")
    overlay = P.pc.PendingOverlay([2, 3], [("cc", "k03")])
    partial = P.pc.PendingOverlay([3], [("cc", "k03")])
    stale = P.pc.PendingOverlay([2, 3, 4], [("cc", "k03")])
    an2 = P.pc.EarlyAbortAnalyzer(db, "ch", overlay_source=lambda: overlay)
    return [{t: int(c) for t, c in d.items()} for d in (
        an.doomed(block), an.doomed(block, overlay=overlay),
        an.doomed(block, overlay=partial), an.doomed(block, overlay=stale),
        an2.doomed(block))]


@pytest.mark.parametrize("pkg", PKGS)
def test_early_abort_overlay_guard_midwindow(pk, pkg, org):
    envs = [
        tx(org, rw(reads=[KVRead("k02", Version(9, 9))])),
        tx(org, rw(reads=[KVRead("k03", Version(9, 9))])),
        tx(org, rw(rqs=[RangeQueryInfo(
            "k03", "k05", True,
            (KVRead("k03", Version(1, 3)), KVRead("k04", Version(1, 4))))])),
    ]
    none, covered, partial, stale, wired = differential(
        pk, pkg, _overlay_guard, envs)
    assert none == partial == stale == {}
    assert covered == wired == {0: 11}


# ---------------------------------------------------------------------------
# tests/test_parallel_commit.py:990 — the pipelined committer, and more
# ---------------------------------------------------------------------------

def msps_of(P, orgs):
    """Each package's MSPs from the reference DevOrgs' CA material."""
    if P.name == "ref":
        return {o.mspid: P.msp.CachedMSP(o.msp()) for o in orgs}
    return {o.mspid: P.msp.CachedMSP(P.msp.MSP(P.msp.MSPConfig(
        **dataclasses.asdict(o.msp_config())))) for o in orgs}


def pipe_stack(P, orgs, W, policy="OR('Org1.member')", provider=None,
               tail="deep", early_abort=False, bundle=None):
    """Committer -> TxValidator (`tail`: deep, classic or kv7) ->
    KVLedger(commit_window=W) -> (committer, device validator or None).
    kv7: the port's DeviceValidator on KV7's plain version, the
    reference's pinned to one device (ROADMAP C1)."""
    policies = P.committer.PolicyRegistry()
    policies.set_policy("cc", P.policy.parse_policy(policy))
    kv7 = tail == "kv7"
    ledger = P.ledger.KVLedger("ch", P.ledger.LedgerConfig(
        commit_window=W, device_validate=kv7))
    dv = None
    if kv7 and P.name == "port":
        from fabric_tpu_torch.committer.device_validate import (
            DeviceValidator)
        dv = DeviceValidator(ledger.statedb, "ch", device="cpu")
    elif kv7:
        import jax
        from fabric_tpu.committer.device_validate import DeviceValidator
        dv = DeviceValidator(ledger.statedb, "ch",
                             devices=[jax.devices()[0]])
    if dv is not None:
        ledger.set_prepared_source(dv.take_prepared)
    ea = (P.pc.EarlyAbortAnalyzer(ledger.statedb, "ch",
                                  overlay_source=ledger.pending_overlay)
          if early_abort else None)
    provider = provider or P.sw
    v = P.committer.TxValidator(
        "ch", None if bundle is not None else msps_of(P, orgs), provider,
        policies, bundle_source=bundle, early_abort=ea, device_validate=dv,
        sbe_lookup=(P.sbe.statedb_lookup(ledger.statedb)
                    if tail == "classic" else None))
    return P.committer.Committer(
        ledger, v, bundle_source=bundle,
        provider=provider if bundle is not None else None), dv


def spy_finish(ledger, out: list):
    """Record each window finish's (flags, batch items, history)."""
    real = ledger._commit_window.finish

    def finish(db, entry):
        batch, history = real(db, entry)
        out.append(norm(entry.flags, batch, history))
        return batch, history
    ledger._commit_window.finish = finish


def state_rows(lg):
    return sorted((k, vv.value, vv.version.block_num, vv.version.tx_num)
                  for k, vv in lg.statedb._data.items())


def history_rows(lg):
    h = lg.historydb
    return {k: [(m.block_num, m.tx_num, m.txid, m.value, m.is_delete)
                for m in h.get_history(*k)] for k in sorted(h._index)}


def run_pipeline(P, committer, raws, after=None):
    """Submit every block, then collect the futures -> [(codes, metadata
    flags, state, history, commit hash) per block] from `after` (called
    from the retire thread's commit listener)."""
    rows = []

    def listener(block, final):
        lg = committer.ledger
        rows.append((final.codes(), bytes(block.metadata.items[
            META_TXFLAGS]), state_rows(lg), history_rows(lg),
            lg.commit_hash))
    committer.add_commit_listener(listener)
    pipe = P.committer.PipelinedCommitter(committer)
    try:
        futs = [pipe.submit(block_of(P, raw)) for raw in raws]
        results = [f.result(timeout=600) for f in futs]
        pipe.drain(timeout=60)
    finally:
        pipe.close()
    assert [r.final_flags.codes() for r in results] == [r[0] for r in rows]
    return rows


def run_serial(P, committer, raws):
    rows = []
    for raw in raws:
        block = block_of(P, raw)
        res = committer.store_block(block)
        lg = committer.ledger
        rows.append((res.final_flags.codes(), bytes(block.metadata.items[
            META_TXFLAGS]), state_rows(lg), history_rows(lg),
            lg.commit_hash))
    return rows


def small_stream(org1):
    def mk(rwset):
        return build.endorser_tx("ch", "cc", "1.0", rwset,
                                 org1.new_identity("c"),
                                 [org1.new_identity("e")])
    return chain([
        [mk(rw(writes=[KVWrite("a", b"1"), KVWrite("b", b"2")]))],
        [mk(rw(reads=[KVRead("a", Version(0, 0))],
               writes=[KVWrite("a", b"3")])),
         mk(rw(writes=[KVWrite("c", b"4")]))],
        [mk(rw(reads=[KVRead("c", Version(1, 1))],
               writes=[KVWrite("c", b"5")]))],
    ])


def _pipelined_small(P, orgs, raws):
    ser, _ = pipe_stack(P, orgs, 0)
    want = run_serial(P, ser, raws)
    com, _ = pipe_stack(P, orgs, 4)
    got = run_pipeline(P, com, raws)
    assert got == want
    assert com.ledger._commit_window.stats()["retired"] == 3
    return got


@pytest.mark.parametrize("pkg", PKGS)
def test_pipelined_committer_stream_matches_serial(pk, pkg):
    org1 = DevOrg("Org1")
    rows = differential(pk, pkg, _pipelined_small, (org1,),
                        small_stream(org1))
    assert [r[0].count(0) for r in rows] == [1, 2, 1]


@pytest.fixture(scope="module")
def stream300():
    """The 300-tx stream of tests/test_torch_early_abort.py, its block 2
    reading the versions block 1 left (one serial commit of blocks 0
    and 1 on the reference) -> (orgs, hash-chained raws)."""
    from test_torch_early_abort import stream_300
    orgs = (DevOrg("Org1"), DevOrg("Org2"))
    blocks, transfers = stream_300(orgs)
    R = load("ref")
    lg = R.ledger.KVLedger("ch", R.ledger.LedgerConfig())
    for raw in chain(blocks):
        lg.commit(flagged(R, raw))
    db = lg.statedb
    blocks = blocks + [transfers(lambda k: db.get("cc", k).version, b"2")]
    return orgs, chain(blocks)


@pytest.fixture(scope="module")
def cuda_cpu():
    """The port's CUDA provider on the kernels' plain versions; every key
    gets a table, so every item goes to KP3's plain version."""
    from fabric_tpu_torch.bccsp.cuda import CudaProvider
    return CudaProvider(device="cpu", fast_key_threshold=1)


@pytest.mark.parametrize("tail", ["deep", "classic", "kv7"])
def test_pipelined_300_tx_stream_matches_reference(pk, stream300, cuda_cpu,
                                                   tail):
    """The port's PipelinedCommitter (W=2, CudaProvider on the CPU,
    early abort on the window's overlay) against the reference's (W=2,
    SW) and the reference's serial committer: each block's flags,
    metadata flags, finished batch items in order, history list, state,
    history and commit hash equal, whatever the threads' timing.  On
    the KV7 tail, KV7 runs only with the window empty and otherwise
    demotes as `savepoint`."""
    orgs, raws = stream300
    policy = "AND('Org1.member', 'Org2.member')"
    serial, _ = pipe_stack(pk["ref"], orgs, 0, policy)
    want = run_serial(pk["ref"], serial, raws)
    got, batches = {}, {}
    for P, prov in ((pk["ref"], None), (pk["port"], cuda_cpu)):
        com, dv = pipe_stack(P, orgs, 2, policy, provider=prov, tail=tail,
                             early_abort=True)
        batches[P.name] = []
        spy_finish(com.ledger, batches[P.name])
        got[P.name] = run_pipeline(P, com, raws)
        if dv is not None and P.name == "port":
            st = dv.stats
            dem = {k: v for k, v in
                   st["validator_device_demotions_total"].items() if v}
            assert set(dem) <= {"savepoint"}, dem
            assert st["validator_device_blocks_total"] + sum(
                dem.values()) == len(raws)
            assert st["validator_device_blocks_total"] >= 1
    assert got["port"] == got["ref"] == want
    assert batches["port"] == batches["ref"]
    assert [b[0] for b in batches["port"]] == [r[1] for r in want]
    assert cuda_cpu.stats["fallbacks"] == 0
    assert [r[0].count(0) for r in want][0] == 100


def _retire_failure(P, orgs, raws):
    """Block 2's retire fails once block 3 is queued behind it: both
    futures fail, the block store holds blocks 0 and 1, the window is
    dropped; a new pipeline takes block 1 again (acknowledged, not
    recommitted) and blocks 2 and 3, each finished exactly once, to the
    serial commit hash."""
    ser, _ = pipe_stack(P, orgs, 0)
    want = run_serial(P, ser, raws)
    com, _ = pipe_stack(P, orgs, 4)
    lg = com.ledger
    finished, go = [], threading.Event()
    real = lg._commit_window.finish

    def finish(db, entry):
        if entry.num == 2 and not finished.count(2):
            go.wait(60)
            finished.append(2)
            raise RuntimeError("injected retire failure")
        finished.append(entry.num)
        return real(db, entry)
    lg._commit_window.finish = finish
    pipe = P.committer.PipelinedCommitter(com)
    futs = [pipe.submit(block_of(P, raw)) for raw in raws]
    go.set()
    outcome = []
    for f in futs:
        try:
            f.result(timeout=60)
            outcome.append("ok")
        except RuntimeError as exc:
            outcome.append(str(exc).split(":")[0])
    assert pipe.broken is not None
    with pytest.raises(RuntimeError, match="broken"):
        pipe.submit(block_of(P, raws[2]))
    pipe.close()
    state = (lg.height, lg.blockstore.height, lg._commit_window.depth())
    pipe = P.committer.PipelinedCommitter(com)
    try:
        again = [pipe.submit(block_of(P, raw)) for raw in raws[1:]]
        replayed = again[0].result(timeout=60)
        rest = [f.result(timeout=60) for f in again[1:]]
    finally:
        pipe.close()
    assert replayed.commit_stats is None        # acknowledged, no commit
    assert [r.final_flags.codes() for r in rest] == [w[0] for w in want[2:]]
    assert lg.commit_hash == want[-1][4]
    assert (state_rows(lg), history_rows(lg)) == want[-1][2:4]
    return outcome, state, finished


@pytest.mark.parametrize("pkg", PKGS)
def test_pipelined_retire_failure_fails_successors_and_replays_once(
        pk, pkg):
    org1 = DevOrg("Org1")
    raws = small_stream(org1) + []
    # a fourth block, chained to the third
    from fabric_tpu.protocol import Block
    tip = block_header_hash(Block.deserialize(raws[-1]).header)
    raws += chain([[build.endorser_tx(
        "ch", "cc", "1.0", rw(writes=[KVWrite("d", b"6")]),
        org1.new_identity("c"), [org1.new_identity("e")])]],
        start=3, prev=tip)
    outcome, state, finished = differential(pk, pkg, _retire_failure,
                                            (org1,), raws)
    assert outcome == ["ok", "ok", "injected retire failure",
                       "pipeline broken at block 2"]
    assert state == (2, 2, 0)
    assert finished == [0, 1, 2, 2, 3]


def _config_drain(P, devs, raws, cfg_raw):
    """Blocks 0 and 1 in flight, then a config block: the window drains,
    the config commits serially, the bundle moves, and the blocks after
    it validate under the new config."""
    C = P.config
    o1, o2 = devs
    oc = [C.OrgConfig(mspid=d.mspid,
                      root_certs=tuple(d.msp_config().root_certs_pem),
                      admins=tuple(d.msp_config().admin_certs_pem))
          for d in devs]
    src = C.BundleSource(C.Bundle(C.ChannelConfig(
        "ch", 0, (oc[0],), C.default_policies(["Org1"]))))
    com, _ = pipe_stack(P, devs, 2, "OR('Org1.member', 'Org2.member')",
                        bundle=src)
    seq = []
    com.add_commit_listener(
        lambda block, final: seq.append(src.current().sequence))
    pipe = P.committer.PipelinedCommitter(com)
    try:
        futs = [pipe.submit(block_of(P, raw)) for raw in raws[:2]]
        cfg = pipe.submit(block_of(P, cfg_raw))
        assert all(f.done() for f in futs) and cfg.done()
        tail = pipe.submit(block_of(P, raws[2]))
        codes = [f.result(timeout=60).final_flags.codes()
                 for f in (*futs, cfg, tail)]
    finally:
        pipe.close()
    return codes, seq, src.current().sequence, com.ledger.commit_hash


@pytest.mark.parametrize("pkg", PKGS)
def test_pipelined_config_block_drains_window(pk, pkg):
    """A block created by Org2 is refused before the config block that
    adds Org2 and valid after it, through the same pipeline."""
    from fabric_tpu import config as ref_cfg
    devs = (DevOrg("Org1"), DevOrg("Org2"))

    def mk(creator, key):
        return build.endorser_tx("ch", "cc", "1.0",
                                 rw(writes=[KVWrite(key, b"v")]), creator,
                                 [devs[0].new_identity("e")])
    o2 = devs[1].new_identity("c2")
    b0 = [mk(devs[0].new_identity("c1"), "a")]
    b1 = [mk(o2, "b")]
    cfg = ref_cfg.ChannelConfig("ch", 1, tuple(
        ref_cfg.OrgConfig(mspid=d.mspid,
                          root_certs=tuple(d.msp_config().root_certs_pem),
                          admins=tuple(d.msp_config().admin_certs_pem))
        for d in devs), ref_cfg.default_policies(["Org1", "Org2"]))
    env = ref_cfg.build_config_envelope(cfg, [devs[0].admin])
    raws = chain([b0, b1, [env], [mk(o2, "c")]])
    codes, seq, final_seq, _h = differential(
        pk, pkg, _config_drain, devs, raws[:2] + raws[3:], raws[2])
    assert codes == [[0], [4], [0], [0]]
    # listeners run before the bundle moves, at the config block too
    assert seq == [0, 0, 0, 1] and final_seq == 1


def _durable_window_dirs(P, raws, tmp):
    """The stream on a durable ledger (8 shards, a checkpoint every 2
    blocks) serially and through the window at W=4 -> the windowed
    directory, held byte for byte to the serial one."""
    cfg = {"state_shards": 8, "snapshot_every": 2}
    serial = P.ledger.KVLedger("ch", P.ledger.LedgerConfig(
        root=os.path.join(tmp, P.name, "serial"), **cfg))
    for raw in raws:
        serial.commit(flagged(P, raw))
    lg = P.ledger.KVLedger("ch", P.ledger.LedgerConfig(
        root=os.path.join(tmp, P.name, "window"), commit_window=4, **cfg))
    tickets = [lg.commit_begin(flagged(P, raw)) for raw in raws[:4]]
    for t in tickets:
        lg.commit_finish(t)
    for raw in raws[4:]:
        lg.commit_finish(lg.commit_begin(flagged(P, raw)))
    got = dir_bytes(os.path.join(tmp, P.name, "window"))
    assert got == dir_bytes(os.path.join(tmp, P.name, "serial"))
    return got


@pytest.mark.parametrize("pkg", PKGS)
def test_durable_window_directory_equals_serial(pk, pkg, org, tmp_path):
    """The windowed durable directory (block segments, WALs, checkpoints)
    is the serial one's byte for byte, on both packages and between
    them."""
    keys = [f"k{i:02d}" for i in range(12)]
    blocks = window_fuzz_blocks(random.Random(77), org, keys)
    blocks += window_fuzz_blocks(random.Random(78), org, keys)[1:]
    differential(pk, pkg, _durable_window_dirs, chain(blocks),
                 str(tmp_path))
