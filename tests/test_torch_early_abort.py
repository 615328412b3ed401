"""The port's early abort against the reference's, on the CPU.

The reference's early-abort tests of tests/test_parallel_commit.py (the
analyzer's doom sets, its savepoint guard, ranges, code ambiguity, the
overlay guard mid-window with a `PendingOverlay` built directly, and
the committer's flag parity with fewer dispatched items on both tails),
each run on both packages; then the two packages' doom sets on seeded
random blocks, and a seeded 300-tx commit stream committed by both
packages with early abort on both tails and without it: the same flags,
state and commit hash, the same dispatched items, fewer than without.
Tolerance: exact equality."""
import importlib
import random
from types import SimpleNamespace

import pytest

from fabric_tpu.msp.ca import DevOrg
from fabric_tpu.protocol import (Envelope, KVRead, KVWrite, NsRwSet,
                                 TxRwSet, ValidationCode, Version, build)
from fabric_tpu.protocol import block_header_hash
from fabric_tpu.protocol.types import META_TXFLAGS, RangeQueryInfo
from fabric_tpu_torch.protocol import wire

PKGS = ("fabric_tpu", "fabric_tpu_torch")
MVCC = int(ValidationCode.MVCC_READ_CONFLICT)
PHANTOM = int(ValidationCode.PHANTOM_READ_CONFLICT)
V = int(ValidationCode.VALID)


def load(pkg):
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")
    return SimpleNamespace(
        pkg=pkg, pc=m("committer.parallel_commit"), committer=m("committer"),
        ledger=m("ledger"), mvcc=m("ledger.mvcc"), msp=m("msp"),
        policy=m("policy"), protocol=m("protocol"),
        factory=m("bccsp.factory"))


@pytest.fixture(scope="module", params=PKGS)
def P(request):
    P = load(request.param)
    P.sw = P.factory.init_factories(P.factory.FactoryOpts(default="SW"))
    return P


@pytest.fixture(scope="module")
def org():
    return DevOrg("Org1")


def tx(org, rwset):
    return build.endorser_tx("ch", "cc", "1.0", rwset, org.admin,
                             [org.admin])


def rw(reads=(), writes=(), ns="cc", rqs=()):
    return TxRwSet((NsRwSet(ns, reads=tuple(reads), writes=tuple(writes),
                            range_queries=tuple(rqs)),))


def seeded_db(P, n_keys=20):
    """Committed state k00..k{n-1} = b"v<i>" at Version(1, i)."""
    db = P.ledger.StateDB()
    b = P.ledger.UpdateBatch()
    for i in range(n_keys):
        b.put("cc", f"k{i:02d}", b"v%d" % i, P.protocol.Version(1, i))
    db.apply_updates(b, 1)
    return db


def block_of(P, envs, number=2, prev=b"\x00" * 32):
    raw = build.new_block(number, prev, envs).serialize()
    return (wire.parse_block(raw) if P.pkg == "fabric_tpu_torch"
            else importlib.import_module("fabric_tpu.protocol").Block
            .deserialize(raw))


def doomed(P, db, envs, number=2, overlay=None, **kw):
    got = P.pc.EarlyAbortAnalyzer(db, "ch", **kw).doomed(
        block_of(P, envs, number), overlay=overlay)
    return {t: int(c) for t, c in got.items()}


def _rec(i):
    return KVRead(f"k{i:02d}", Version(1, i))


# -- tests/test_parallel_commit.py's early-abort tests -----------------------


def test_early_abort_analyzer_doom_set(P, org):
    envs = [
        tx(org, rw(reads=[KVRead("k00", Version(9, 9))])),
        tx(org, rw(writes=[KVWrite("k01", b"x")])),
        tx(org, rw(reads=[KVRead("k01", Version(2, 1))])),
        tx(org, rw(reads=[KVRead("k01", Version(1, 1))])),
        tx(org, rw(writes=[KVWrite("k02", b"", True)])),
        tx(org, rw(reads=[KVRead("k02", None)])),
        tx(org, rw(reads=[KVRead("k02", Version(8, 8))])),
        tx(org, rw(reads=[KVRead("k03", Version(9, 9))],
                   rqs=[RangeQueryInfo("k0", "k1", True, ())])),
        tx(org, rw(reads=[KVRead("nope", None)])),
    ]
    block = build.new_block(2, b"\x00" * 32, envs)
    block.data.append(b"\xba\xad")        # unparsable: skipped, not fatal
    if P.pkg == "fabric_tpu_torch":
        block = wire.parse_block(block.serialize())
    got = P.pc.EarlyAbortAnalyzer(seeded_db(P), "ch").doomed(block)
    assert {t: int(c) for t, c in got.items()} == {0: MVCC, 6: MVCC,
                                                   7: MVCC}


def test_early_abort_savepoint_guard(P, org):
    db = seeded_db(P)
    env = tx(org, rw(reads=[KVRead("k00", Version(9, 9))]))
    assert doomed(P, db, [env], number=5) == {}
    assert doomed(P, db, [env], number=2) != {}


def test_early_abort_doomed_writes_never_mask_later_reads(P, org):
    envs = [tx(org, rw(reads=[KVRead("k00", Version(9, 9))],
                       writes=[KVWrite("k05", b"never")])),
            tx(org, rw(reads=[KVRead("k05", Version(2, 0))]))]
    assert sorted(doomed(P, seeded_db(P), envs)) == [0, 1]


def test_early_abort_range_doom_set(P, org):
    envs = [
        tx(org, rw(rqs=[RangeQueryInfo("k05", "k08", True, (_rec(5),))])),
        tx(org, rw(rqs=[RangeQueryInfo(
            "k05", "k08", True, (_rec(5), _rec(6), _rec(7)))])),
        tx(org, rw(writes=[KVWrite("k06", b"new")])),
        tx(org, rw(rqs=[RangeQueryInfo(
            "k05", "k08", True, (_rec(5), _rec(6), _rec(7)))])),
        tx(org, rw(rqs=[RangeQueryInfo(
            "k17", "k19", True,
            (_rec(17), KVRead("k18x", None), _rec(18)))])),
        tx(org, rw(rqs=[RangeQueryInfo("k19", "", True, (_rec(19),))])),
    ]
    assert doomed(P, seeded_db(P), envs) == {0: PHANTOM, 4: PHANTOM}


def test_early_abort_range_doom_matches_oracle_codes(P, org):
    envs = [
        tx(org, rw(writes=[KVWrite("k01", b"x")])),
        tx(org, rw(rqs=[RangeQueryInfo("k05", "k08", True, (_rec(5),))])),
        tx(org, rw(reads=[KVRead("k09", Version(9, 9))],
                   rqs=[RangeQueryInfo("k10", "k12", True,
                                       (_rec(10), _rec(11)))])),
        tx(org, rw(rqs=[RangeQueryInfo("k10", "k12", True, (_rec(10),))])),
    ]
    got = doomed(P, seeded_db(P), envs)
    assert got == {1: PHANTOM, 2: MVCC, 3: PHANTOM}
    flags = P.protocol.TxFlags(len(envs), P.protocol.ValidationCode.VALID)
    P.mvcc.validate_and_prepare_batch(
        seeded_db(P), 2, [P.protocol.Envelope.deserialize(e.serialize())
                          for e in envs], flags)
    for t, code in got.items():
        assert int(flags.flag(t)) == code


def test_early_abort_range_code_ambiguity_suppresses_doom(P, org):
    envs = [
        tx(org, TxRwSet((NsRwSet("aa", writes=(KVWrite("k10", b"w"),)),
                         NsRwSet("cc", writes=(KVWrite("k00", b"w"),))))),
        tx(org, rw(reads=[KVRead("k00", Version(1, 0))],
                   rqs=[RangeQueryInfo("k05", "k08", True, (_rec(5),))])),
        tx(org, TxRwSet((
            NsRwSet("aa", range_queries=(
                RangeQueryInfo("k10", "k12", True, ()),)),
            NsRwSet("cc", reads=(KVRead("k15", Version(9, 9)),))))),
        tx(org, rw(reads=[KVRead("k00", Version(1, 0)),
                          KVRead("k15", Version(9, 9))])),
    ]
    assert doomed(P, seeded_db(P), envs) == {3: MVCC}


def test_early_abort_range_dead_tx_writes_never_land(P, org):
    envs = [
        tx(org, rw(rqs=[RangeQueryInfo("k05", "k08", True, (_rec(5),))],
                   writes=[KVWrite("k11", b"never")])),
        tx(org, rw(rqs=[RangeQueryInfo("k10", "k12", True, (_rec(10),))])),
        tx(org, rw(rqs=[RangeQueryInfo("k10", "k12", True,
                                       (_rec(10), _rec(11)))])),
    ]
    assert doomed(P, seeded_db(P), envs) == {0: PHANTOM, 1: PHANTOM}


def test_early_abort_overlay_guard_midwindow(P, org):
    """Savepoint 1, block 4: an overlay covering blocks 2-3 keeps
    dooming, its keys judged uncertain; no, a partial or a stale overlay
    dooms nothing; overlay_source delivers the same."""
    db = seeded_db(P)
    envs = [
        tx(org, rw(reads=[KVRead("k02", Version(9, 9))])),
        tx(org, rw(reads=[KVRead("k03", Version(9, 9))])),
        tx(org, rw(rqs=[RangeQueryInfo(
            "k03", "k05", True,
            (KVRead("k03", Version(1, 3)), KVRead("k04", Version(1, 4))))])),
    ]
    PO = P.pc.PendingOverlay
    assert doomed(P, db, envs, number=4) == {}
    overlay = PO([2, 3], [("cc", "k03")])
    assert doomed(P, db, envs, number=4, overlay=overlay) == {0: MVCC}
    assert doomed(P, db, envs, number=4,
                  overlay=PO([3], [("cc", "k03")])) == {}
    assert doomed(P, db, envs, number=4,
                  overlay=PO([2, 3, 4], [("cc", "k03")])) == {}
    assert doomed(P, db, envs, number=4,
                  overlay_source=lambda: overlay) == {0: MVCC}


class CountingProvider:
    """Delegating provider counting the items dispatched."""

    def __init__(self, inner):
        self.inner = inner
        self.name = inner.name
        self.n_items = 0

    def batch_verify(self, items):
        items = list(items)
        self.n_items += len(items)
        return self.inner.batch_verify(items)

    def batch_verify_async(self, items):
        items = list(items)
        self.n_items += len(items)
        return self.inner.batch_verify_async(items)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def committer(P, orgs, early_abort, tail, policy="OR('Org1.member')"):
    """-> (committer, counting provider, analyzer or None).  Tail "kv7":
    the port's deep tail with a DeviceValidator (KV7's plain version on
    the CPU), the reference's deep host tail."""
    import dataclasses
    if P.pkg == "fabric_tpu":
        msps = {o.mspid: P.msp.CachedMSP(o.msp()) for o in orgs}
    else:
        msps = {o.mspid: P.msp.CachedMSP(P.msp.MSP(P.msp.MSPConfig(
            **dataclasses.asdict(o.msp_config())))) for o in orgs}
    policies = P.committer.PolicyRegistry()
    policies.set_policy("cc", P.policy.parse_policy(policy))
    kv7 = tail == "kv7" and P.pkg == "fabric_tpu_torch"
    ledger = P.ledger.KVLedger("ch", P.ledger.LedgerConfig(
        device_validate=kv7))
    dv = None
    if kv7:
        from fabric_tpu_torch.committer.device_validate import (
            DeviceValidator)
        dv = DeviceValidator(ledger.statedb, "ch", device="cpu")
        ledger.set_prepared_source(dv.take_prepared)
    counting = CountingProvider(P.sw)
    ea = P.pc.EarlyAbortAnalyzer(ledger.statedb, "ch") \
        if early_abort else None
    v = P.committer.TxValidator("ch", msps, counting, policies,
                                early_abort=ea, device_validate=dv)
    v.force_python_collect = tail == "python"
    if tail == "classic":
        v.sbe_lookup = lambda ns, k: None
    return P.committer.Committer(ledger, v), counting, ea


def commit_chain(P, com, env_blocks):
    """Commit the blocks -> ([final codes], [metadata flags])."""
    prev, codes, metas = b"\x00" * 32, [], []
    for num, envs in enumerate(env_blocks):
        block = build.new_block(num, prev, envs)
        prev = block_header_hash(block.header)
        raw = block.serialize()
        b = (wire.parse_block(raw) if P.pkg == "fabric_tpu_torch"
             else importlib.import_module("fabric_tpu.protocol").Block
             .deserialize(raw))
        codes.append(com.store_block(b).final_flags.codes())
        metas.append(bytes(b.metadata.items[META_TXFLAGS]))
    return codes, metas


@pytest.mark.parametrize("tail", ["classic", "python", "deep"])
def test_committer_early_abort_flag_parity_and_fewer_dispatches(P, tail):
    org1 = DevOrg("Org1")

    def mk(rwset):
        return build.endorser_tx("ch", "cc", "1.0", rwset,
                                 org1.new_identity("c"),
                                 [org1.new_identity("e")])

    b0 = [mk(rw(writes=[KVWrite("a", b"1"), KVWrite("b", b"2")]))]
    b1 = [mk(rw(reads=[KVRead("a", Version(9, 9))],
                writes=[KVWrite("a", b"doomed")])),
          mk(rw(reads=[KVRead("a", Version(0, 0))],
                writes=[KVWrite("a", b"3")])),
          mk(rw(reads=[KVRead("b", Version(0, 0))]))]
    outs = []
    for early in (False, True):
        com, counting, _ = committer(P, [org1], early, tail)
        codes, _ = commit_chain(P, com, [b0, b1])
        outs.append((codes[1], com.ledger.commit_hash,
                     com.ledger.get_state("cc", "a"), counting.n_items))
    (c0, h0, a0, n0), (c1, h1, a1, n1) = outs
    assert c0 == c1 == [MVCC, V, V]
    assert h0 == h1 and a0 == a1 == b"3"
    assert n1 < n0


# -- the two packages' doom sets, seeded ------------------------------------


def random_block(rng, org, n=24):
    keys = [f"k{i:02d}" for i in range(24)]
    envs = []
    for _ in range(n):
        reads, writes, rqs = [], [], []
        for k in rng.sample(keys, rng.randint(0, 3)):
            u = rng.random()
            i = int(k[1:])
            ver = (Version(1, i) if u < 0.4 else
                   Version(2, rng.randrange(n)) if u < 0.7 else
                   None if u < 0.85 else Version(9, 9))
            reads.append(KVRead(k, ver))
        for k in rng.sample(keys, rng.randint(0, 2)):
            writes.append(KVWrite(k, b"", rng.random() < 0.2))
        if rng.random() < 0.2:
            a = rng.randrange(20)
            b = a + rng.randint(1, 4)
            rqs.append(RangeQueryInfo(
                f"k{a:02d}", f"k{b:02d}" if rng.random() < 0.8 else "", True,
                tuple(_rec(i) for i in range(a, min(b, 20))
                      if rng.random() < 0.9)))
        envs.append(tx(org, rw(reads=reads, writes=writes, rqs=rqs)))
    return envs


def test_doom_sets_equal_on_seeded_random_blocks(org):
    ref, port = load("fabric_tpu"), load("fabric_tpu_torch")
    n_doomed = 0
    for seed in range(6):
        envs = random_block(random.Random(seed), org)
        a = doomed(ref, seeded_db(ref), envs)
        b = doomed(port, seeded_db(port), envs)
        assert a == b, seed
        n_doomed += len(a)
    assert n_doomed > 0


def stream_300(orgs):
    """A seeded 300-tx commit stream's first two blocks: 100 accounts
    seeded, then 100 transfers (read two accounts at the version block 0
    left, write both; every tenth first read stale) -> (blocks, a tx
    maker, the accounts).  Block 2 is made by the test."""
    rng = random.Random(300)
    org1, org2 = orgs
    clients = [o.new_identity(f"c{i}") for i, o in enumerate(orgs * 4)]
    ends = [org1.new_identity("e1"), org2.new_identity("e2")]
    accts = [f"acct{i:03d}" for i in range(100)]

    def mk(reads, writes):
        return build.endorser_tx("ch", "cc", "1.0", rw(reads, writes),
                                 rng.choice(clients), ends)

    def transfers(version_of, tag):
        envs = []
        for t in range(100):
            a, b = rng.sample(accts, 2)
            va, vb = version_of(a), version_of(b)
            if t % 10 == 3:
                va = Version(va.block_num, va.tx_num + 7)
            envs.append(mk([KVRead(a, va), KVRead(b, vb)],
                           [KVWrite(a, tag), KVWrite(b, tag)]))
        return envs

    seeded = {a: Version(0, i) for i, a in enumerate(accts)}
    blocks = [[mk([], [KVWrite(a, b"100")]) for a in accts],
              transfers(seeded.get, b"1")]
    return blocks, transfers


@pytest.mark.parametrize("tail", ["classic", "deep", "kv7"])
def test_300_tx_stream_early_abort_matches_reference(tail):
    """The 300-tx stream on both packages, early abort on and off: the
    doom sets, final flags, metadata flags, state and commit hash of the
    port equal the reference's, the dispatched items too, fewer with
    early abort; every doomed tx is invalid without it, and reads
    MVCC_READ_CONFLICT or PHANTOM_READ_CONFLICT with it."""
    orgs = (DevOrg("Org1"), DevOrg("Org2"))
    blocks, transfers = stream_300(orgs)
    # block 2 reads at the versions block 1 left, found by one commit of
    # blocks 0 and 1 on the reference
    ref = load("fabric_tpu")
    ref.sw = ref.factory.init_factories(ref.factory.FactoryOpts(
        default="SW"))
    probe, _, _ = committer(ref, orgs, False, "deep",
                            "AND('Org1.member', 'Org2.member')")
    commit_chain(ref, probe, blocks)
    db = probe.ledger.statedb
    blocks = blocks + [transfers(lambda k: db.get("cc", k).version, b"2")]
    assert sum(map(len, blocks)) == 300
    out = {}
    for pkg in PKGS:
        P = load(pkg)
        P.sw = P.factory.init_factories(P.factory.FactoryOpts(default="SW"))
        for early in (False, True):
            com, counting, ea = committer(
                P, orgs, early, tail, "AND('Org1.member', 'Org2.member')")
            dooms = []
            if ea is not None:
                real = ea.doomed

                def spy(block, overlay=None, real=real):
                    got = real(block, overlay=overlay)
                    dooms.append({t: int(c) for t, c in got.items()})
                    return got
                ea.doomed = spy
            codes, metas = commit_chain(P, com, blocks)
            dv = com.validator.device_validate
            if dv is not None:          # every block through KV7
                assert dv.stats["validator_device_blocks_total"] == 3
            lg = com.ledger
            state = sorted((k, vv.value, vv.version.block_num,
                            vv.version.tx_num)
                           for k, vv in lg.statedb._data.items())
            out[pkg, early] = (codes, metas, state, lg.commit_hash,
                               counting.n_items, dooms)
    for early in (False, True):
        assert out["fabric_tpu_torch", early] == out["fabric_tpu", early]
    codes0, _m0, state0, _h0, n0, _ = out["fabric_tpu_torch", False]
    codes1, _m1, state1, _h1, n1, dooms = out["fabric_tpu_torch", True]
    assert n1 < n0 and state1 == state0
    assert sum(len(d) for d in dooms) > 0
    for num, d in enumerate(dooms):
        for t in range(len(codes0[num])):
            if t in d:
                assert codes0[num][t] != V
                assert codes1[num][t] in (MVCC, PHANTOM)
            else:
                assert codes1[num][t] == codes0[num][t]
