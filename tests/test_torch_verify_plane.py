"""The port's verify-once plane against the reference's, on the CPU.

The tests of tests/test_verify_plane.py that need no orderer and no
gateway, each parametrised over both packages: the cache's MAC, epochs,
LRU and counters, the caching provider, the validator's cache split on
every tail (deep, classic on the C walker, classic on the Python
mirror), the speculative verifier, and block attestations.  The port's
counters are the cache's own (`VerdictCache.stats`, by the reference's
series names), the reference's its ops-plane registry.  Beside them:
`item_digest` and the MAC tags equal across packages for one secret,
`AttestorTrust`'s state file byte for byte after the same events, and
cache on against cache off under the seeded differential fuzz, in both
packages.  Tolerance: exact equality."""
import importlib
import random
import time
from types import SimpleNamespace

import numpy as np
import pytest

from fabric_tpu.msp.ca import DevOrg
from fabric_tpu.protocol import (Envelope, KVRead, KVWrite, NsRwSet,
                                 TxRwSet, ValidationCode, Version, build)
from fabric_tpu.verify_plane.cache import _m

PKGS = ("fabric_tpu", "fabric_tpu_torch")
TAILS = ("deep", "classic", "python")
V = int(ValidationCode.VALID)


def load(pkg):
    """The modules of one package that these tests drive."""
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")
    return SimpleNamespace(
        pkg=pkg, vp=m("verify_plane"), cache=m("verify_plane.cache"),
        committer=m("committer"), msp=m("msp"), policy=m("policy"),
        types=m("protocol.types"), factory=m("bccsp.factory"))


@pytest.fixture(scope="module", params=PKGS)
def P(request):
    P = load(request.param)
    P.sw = P.factory.init_factories(P.factory.FactoryOpts(default="SW"))
    return P


@pytest.fixture()
def orgs():
    return DevOrg("Org1"), DevOrg("Org2")


def msps(P, *orgs):
    if P.pkg == "fabric_tpu":
        return {o.mspid: P.msp.CachedMSP(o.msp()) for o in orgs}
    import dataclasses
    return {o.mspid: P.msp.CachedMSP(P.msp.MSP(P.msp.MSPConfig(
        **dataclasses.asdict(o.msp_config())))) for o in orgs}


def rw(reads=(), writes=(), ns="cc"):
    return TxRwSet((NsRwSet(ns, reads=tuple(reads), writes=tuple(writes)),))


def make_tx(org1, org2, rwset=None, endorsers=None, creator=None):
    endorsers = endorsers or [org1.new_identity("e1"),
                              org2.new_identity("e2")]
    return build.endorser_tx(
        "ch", "cc", "1.0", rwset or rw(writes=[KVWrite("k", b"v")]),
        creator or org1.new_identity("client"), endorsers)


def make_block(P, envs, number=0):
    data = [e if isinstance(e, (bytes, bytearray)) else e.serialize()
            for e in envs]
    T = P.types
    return T.Block(T.BlockHeader(number, b"p", b"d"), data,
                   T.BlockMetadata())


def creator_item(P, env, m):
    creators, _ = P.vp.derive_items(env.serialize(), "ch", m)
    assert len(creators) == 1
    return creators[0]


def policies(P, pol="AND('Org1.member', 'Org2.member')"):
    p = P.committer.PolicyRegistry()
    p.set_policy("cc", P.policy.parse_policy(pol))
    return p


def validator(P, m, provider, tail="deep", **kw):
    v = P.committer.TxValidator(
        "ch", m, provider, policies(P),
        sbe_lookup=None if tail == "deep" else (lambda ns, k: None), **kw)
    v.force_python_collect = tail == "python"
    return v


def counts(P, cache):
    """The plane's counters: the reference's process-wide registry, the
    port's cache's own."""
    if P.pkg == "fabric_tpu":
        m = _m()
        return {"hits": m["hits"].total(), "misses": m["misses"].total(),
                "mac": m["rejects"].value(reason="mac"),
                "stale": m["rejects"].value(reason="stale"),
                "evictions": m["evictions"].total(),
                "device": m["device"].total(), "dupes": m["dupes"].total(),
                "attested": m["attested"].total()}
    st = cache.stats
    rej = st["verify_cache_rejects_total"]
    return {"hits": st["verify_cache_hits_total"],
            "misses": st["verify_cache_misses_total"],
            "mac": rej["mac"], "stale": rej["stale"],
            "evictions": st["verify_cache_evictions_total"],
            "device": sum(st["verify_plane_device_verifications_total"]
                          .values()),
            "dupes": sum(st[
                "verify_plane_duplicate_device_verifications_total"]
                .values()),
            "attested": st["verify_plane_attested_skips_total"]}


def delta(before, after):
    return {k: after[k] - before[k] for k in before}


class CountingProvider:
    """Delegating provider that records every device dispatch."""

    def __init__(self, inner):
        self.inner = inner
        self.batches = []
        self.name = inner.name

    def batch_verify(self, items):
        items = list(items)
        self.batches.append(items)
        return self.inner.batch_verify(items)

    def batch_verify_async(self, items):
        items = list(items)
        self.batches.append(items)
        return self.inner.batch_verify_async(items)

    def __getattr__(self, name):
        return getattr(self.inner, name)

    @property
    def dispatched(self):
        return sum(len(b) for b in self.batches)


# -- cache semantics ---------------------------------------------------------


def test_cache_roundtrip_and_sign_of_verdict(P, orgs):
    m = msps(P, *orgs)
    cache = P.vp.VerdictCache(capacity=16)
    it = creator_item(P, make_tx(*orgs), m)
    assert cache.get(it) is None
    cache.put(it, True)
    assert cache.get(it) is True
    cache.put(it, False)
    assert cache.get(it) is False
    assert len(cache) == 1


@pytest.mark.parametrize("tail", TAILS)
def test_mac_tamper_never_silently_accepted(P, orgs, tail):
    """A flipped cached verdict reads as a miss and is dropped; the
    commit gate re-verifies and still flags the tx."""
    m = msps(P, *orgs)
    cache = P.vp.VerdictCache(capacity=16)
    env = make_tx(*orgs)
    env = Envelope(env.payload, env.signature[:-2] + b"\x00\x01")
    it = creator_item(P, env, m)
    cache.put(it, False)
    d = P.vp.item_digest(it)
    mac, verdict, scope, epoch, trace = cache._data[d]
    cache._data[d] = (mac, True, scope, epoch, trace)
    before = counts(P, cache)
    assert cache.get(it) is None
    assert d not in cache._data
    moved = delta(before, counts(P, cache))
    assert moved["mac"] == 1 and moved["hits"] == 0
    res = validator(P, m, P.sw, tail, verify_cache=cache).validate(
        make_block(P, [env]))
    assert res.flags.codes() == [int(ValidationCode.BAD_CREATOR_SIGNATURE)]


def test_entry_from_another_node_rejected(P, orgs):
    m = msps(P, *orgs)
    theirs, ours = P.vp.VerdictCache(capacity=4), P.vp.VerdictCache(
        capacity=4)
    it = creator_item(P, make_tx(*orgs), m)
    theirs.put(it, True)
    d = P.vp.item_digest(it)
    ours._data[d] = theirs._data[d]
    assert ours.get(it) is None
    assert d not in ours._data


@pytest.mark.parametrize("tail", TAILS)
def test_sig_substitution_changes_cache_key(P, orgs, tail):
    m = msps(P, *orgs)
    cache = P.vp.VerdictCache(capacity=16)
    env = make_tx(*orgs)
    cache.put(creator_item(P, env, m), True)
    swapped = Envelope(env.payload, env.signature[:-2] + b"\x00\x01")
    assert cache.get(creator_item(P, swapped, m)) is None
    inner = CountingProvider(P.sw)
    res = validator(P, m, inner, tail, verify_cache=cache).validate(
        make_block(P, [swapped]))
    assert res.flags.codes() == [int(ValidationCode.BAD_CREATOR_SIGNATURE)]
    assert inner.dispatched > 0


def test_epoch_bump_invalidates_cached_verdicts(P, orgs):
    m = msps(P, *orgs)
    cache = P.vp.VerdictCache(capacity=16)
    it = creator_item(P, make_tx(*orgs), m)
    cache.put(it, True)
    cache.set_epoch(1)
    before = counts(P, cache)
    assert cache.get(it) is None
    assert delta(before, counts(P, cache))["stale"] == 1
    assert len(cache) == 0
    cache.put(it, True)
    assert cache.get(it) is True


def test_epoch_is_scoped_per_channel(P, orgs):
    m = msps(P, *orgs)
    cache = P.vp.VerdictCache(capacity=16)
    it_a = creator_item(P, make_tx(*orgs), m)
    it_b = creator_item(P, make_tx(*orgs), m)
    cache.set_epoch(3, scope="chA")
    cache.set_epoch(3, scope="chB")
    cache.put(it_a, True, scope="chA")
    cache.put(it_b, True, scope="chB")
    cache.set_epoch(4, scope="chA")
    before = counts(P, cache)
    assert cache.get(it_a) is None
    assert cache.get(it_b) is True
    moved = delta(before, counts(P, cache))
    assert moved["stale"] == 1 and moved["hits"] == 1
    cache.set_epoch(3, scope="chB")
    assert cache.get(it_b) is True


def test_lru_bound_and_eviction_counter(P, orgs):
    m = msps(P, *orgs)
    cache = P.vp.VerdictCache(capacity=4)
    items = [creator_item(P, make_tx(*orgs), m) for _ in range(7)]
    before = counts(P, cache)
    for it in items:
        cache.put(it, True)
    assert len(cache) == 4
    assert delta(before, counts(P, cache))["evictions"] == 3
    assert cache.get(items[0]) is None
    assert cache.get(items[-1]) is True


def test_peek_skips_counters_and_lru(P, orgs):
    m = msps(P, *orgs)
    cache = P.vp.VerdictCache(capacity=16)
    it = creator_item(P, make_tx(*orgs), m)
    cache.put(it, True)
    before = counts(P, cache)
    assert cache.peek(it) is True
    assert cache.peek(creator_item(P, make_tx(*orgs), m)) is None
    assert delta(before, counts(P, cache)) == {k: 0 for k in before}


def test_snapshot_reads_the_counters(P, orgs):
    m = msps(P, *orgs)
    cache = P.vp.VerdictCache(capacity=2, owner="peer0")
    items = [creator_item(P, make_tx(*orgs), m) for _ in range(3)]
    for it in items:
        cache.put(it, True)
    cache.get(items[0])
    cache.get(items[2])
    snap = cache.snapshot()
    assert {k: snap[k] for k in ("owner", "size", "capacity")} == {
        "owner": "peer0", "size": 2, "capacity": 2}
    if P.pkg == "fabric_tpu_torch":
        assert (snap["hits_total"], snap["misses_total"],
                snap["evictions_total"]) == (1, 1, 1)


# -- caching provider --------------------------------------------------------


def test_caching_provider_dispatches_each_item_once(P, orgs):
    m = msps(P, *orgs)
    items = [creator_item(P, make_tx(*orgs), m) for _ in range(4)]
    inner = CountingProvider(P.sw)
    cache = P.vp.VerdictCache(capacity=16)
    p = P.vp.CachingProvider(inner, cache, site="orderer")
    before = counts(P, cache)
    out1 = p.batch_verify(items)
    assert out1.all() and inner.dispatched == 4
    out2 = p.batch_verify(items)
    np.testing.assert_array_equal(out1, out2)
    assert inner.dispatched == 4
    extra = creator_item(P, make_tx(*orgs), m)
    out3 = p.batch_verify(items[:2] + [extra])
    assert out3.all() and inner.dispatched == 5
    assert delta(before, counts(P, cache))["device"] == 5
    if P.pkg == "fabric_tpu_torch":
        assert cache.stats["verify_plane_device_verifications_total"] == {
            "orderer": 5}


def test_caching_provider_async_all_hit_path(P, orgs):
    m = msps(P, *orgs)
    items = [creator_item(P, make_tx(*orgs), m) for _ in range(3)]
    inner = CountingProvider(P.sw)
    p = P.vp.CachingProvider(inner, P.vp.VerdictCache(capacity=16),
                             site="commit")
    assert p.batch_verify_async(items)().all()
    resolve = p.batch_verify_async(items)
    assert inner.dispatched == 3
    assert resolve().all()


# -- differential fuzz: cache-on == cache-off --------------------------------


def adversarial_corpus(org1, org2, rng, n=24):
    """Serialized envelopes mixing valid txs, broken creator sigs,
    broken endorsements, duplicates, truncations and junk."""
    raws = []
    for _ in range(n):
        kind = rng.randrange(8)
        if kind == 0 and raws:
            raws.append(rng.choice(raws))
            continue
        env = make_tx(org1, org2,
                      rw(reads=[KVRead("r", Version(0, 1))],
                         writes=[KVWrite(f"k{rng.random()}", b"v")]))
        raw = env.serialize()
        if kind == 1:
            raw = Envelope(env.payload,
                           env.signature[:-2] + b"\x00\x01").serialize()
        elif kind == 2:
            raw = make_tx(org1, org2,
                          endorsers=[org1.new_identity("e")]).serialize()
        elif kind == 3 and len(raw) > 8:
            raw = raw[:rng.randrange(4, len(raw))]
        elif kind == 4:
            raw = rng.randbytes(rng.randrange(0, 40))
        raws.append(raw)
    return raws


@pytest.fixture(scope="module")
def fuzz_blocks():
    """Three seeds of three adversarial blocks each, built once."""
    org1, org2 = DevOrg("Org1"), DevOrg("Org2")
    out = []
    for seed in (7, 19, 40):
        rng = random.Random(seed)
        blocks = [adversarial_corpus(org1, org2, rng) for _ in range(3)]
        blocks[2] = blocks[2] + [blocks[0][0]]
        out.append(blocks)
    return (org1, org2), out


@pytest.mark.parametrize("tail", TAILS)
def test_differential_fuzz_cache_on_equals_cache_off(P, fuzz_blocks, tail):
    """Cache off, on, and on with a 3-entry cache (evictions mid-block):
    bit-identical flags on every tail, and in both packages (the
    reference's deep tail without a cache is the baseline)."""
    orgs, seeds = fuzz_blocks
    m = msps(P, *orgs)
    ref = load("fabric_tpu")
    ref_sw = ref.factory.init_factories(ref.factory.FactoryOpts(
        default="SW"))
    ref_m = msps(ref, *orgs)
    for blocks in seeds:
        def run(P, m, sw, tail, cache):
            v = validator(P, m, sw, tail, verify_cache=cache)
            return [v.validate(make_block(P, raws, number=i)).flags.codes()
                    for i, raws in enumerate(blocks)]

        base = run(ref, ref_m, ref_sw, "deep", None)
        assert run(P, m, P.sw, tail, None) == base
        assert run(P, m, P.sw, tail, P.vp.VerdictCache(4096)) == base
        assert run(P, m, P.sw, tail, P.vp.VerdictCache(3)) == base


@pytest.mark.parametrize("tail", ["deep", "classic"])
def test_cached_verdict_cannot_vouch_for_revoked_identity(P, orgs, tail):
    env = make_tx(*orgs)
    cache = P.vp.VerdictCache(capacity=64)
    v1 = validator(P, msps(P, *orgs), P.sw, tail, verify_cache=cache)
    assert v1.validate(make_block(P, [env])).flags.codes() == [V]
    for with_cache in (cache, None):
        v2 = validator(P, msps(P, orgs[0]), P.sw, tail,
                       verify_cache=with_cache)
        assert v2.validate(make_block(P, [env])).flags.codes() == [
            int(ValidationCode.ENDORSEMENT_POLICY_FAILURE)]


@pytest.mark.parametrize("tail", TAILS)
def test_verify_once_telemetry_one_device_verify_per_item(P, orgs, tail):
    m = msps(P, *orgs)
    envs = [make_tx(*orgs) for _ in range(6)]
    inner = CountingProvider(P.sw)
    cache = P.vp.VerdictCache(capacity=4096)
    v = validator(P, m, inner, tail, verify_cache=cache)
    before = counts(P, cache)
    v.validate(make_block(P, envs, number=0))
    first = inner.dispatched
    assert first > 0
    v.validate(make_block(P, envs, number=1))
    assert inner.dispatched == first
    moved = delta(before, counts(P, cache))
    assert moved["dupes"] == 0 and moved["device"] == first
    if P.pkg == "fabric_tpu_torch":
        assert set(cache.stats[
            "verify_plane_device_verifications_total"]) == {"commit"}


# -- speculative verification ------------------------------------------------


@pytest.mark.parametrize("tail", TAILS)
def test_derive_items_match_commit_time_keys(P, orgs, tail):
    """Stamping at ingress makes the commit-time validation fully
    cache-served, on every tail."""
    m = msps(P, *orgs)
    envs = [make_tx(*orgs) for _ in range(5)]
    cache = P.vp.VerdictCache(capacity=4096)
    spec = P.vp.SpeculativeVerifier(cache, lambda: P.sw, lambda cid: m)
    attests = spec.stamp(envs, ["ch"] * len(envs))
    assert all(a for a in attests)
    while spec._queue:
        cid, items = spec._queue.popleft()
        spec._verify_batch(items, stage="overlap", scope=cid)
    inner = CountingProvider(P.sw)
    res = validator(P, m, inner, tail, verify_cache=cache).validate(
        make_block(P, envs))
    assert res.flags.codes() == [V] * 5
    assert inner.dispatched == 0
    assert cache.coverage.frac() == 1.0


def test_speculative_worker_fills_cache_in_background(P, orgs):
    m = msps(P, *orgs)
    envs = [make_tx(*orgs) for _ in range(3)]
    cache = P.vp.VerdictCache(capacity=4096)
    spec = P.vp.SpeculativeVerifier(cache, lambda: P.sw,
                                    lambda cid: m).start()
    try:
        spec.stamp(envs, ["ch"] * 3)
        deadline = time.time() + 5.0
        while len(cache) < 9 and time.time() < deadline:
            time.sleep(0.02)
        assert len(cache) == 9
        assert spec.dispatched >= 6
    finally:
        spec.stop()
    assert not spec._thread.is_alive()


def test_structurally_invalid_envelope_stamps_nothing(P, orgs):
    m = msps(P, *orgs)
    cache = P.vp.VerdictCache(capacity=64)
    spec = P.vp.SpeculativeVerifier(cache, lambda: P.sw, lambda cid: m)

    class FakeEnv:
        def serialize(self):
            return b"\xde\xad"

    assert spec.stamp([FakeEnv()], ["ch"]) == [""] and len(cache) == 0


# -- block attestations and attestor trust ---------------------------------


def order_env(org):
    rwset = TxRwSet((NsRwSet("cc", writes=(KVWrite("k", b"v"),)),))
    return build.endorser_tx("ch", "cc", "1.0", rwset,
                             org.new_identity("client"),
                             [org.new_identity("e")])


def test_attest_block_emits_digests_only_for_cached_true(P):
    org = DevOrg("Org1")
    m = msps(P, org)
    envs = [order_env(org) for _ in range(3)]
    cache = P.vp.VerdictCache(capacity=64)
    block = make_block(P, envs, number=3)
    assert P.vp.attest_block(cache, block, "ch", m) is None
    cache.put(creator_item(P, envs[0], m), True, scope="ch")
    cache.put(creator_item(P, envs[2], m), False, scope="ch")
    attests = P.vp.attest_block(cache, block, "ch", m)
    assert attests is not None and len(attests) == 3
    assert attests[0] == P.vp.item_digest(creator_item(P, envs[0], m)).hex()
    assert attests[1] is None and attests[2] is None


def test_accept_block_attestations_rederives_before_seeding(P):
    org = DevOrg("Org1")
    m = msps(P, org)
    env = order_env(org)
    good = P.vp.item_digest(creator_item(P, env, m)).hex()
    tampered = Envelope(env.payload, env.signature[:-2] + b"\x00\x01")
    cache = P.vp.VerdictCache(capacity=64)
    before = counts(P, cache)
    accept = P.vp.accept_block_attestations
    assert accept(cache, make_block(P, [env]), ["ab" * 32], "ch", m) == 0
    assert accept(cache, make_block(P, [tampered]), [good], "ch", m) == 0
    assert cache.peek(creator_item(P, env, m)) is None
    assert accept(cache, make_block(P, [env]), [good], "ch", m) == 1
    assert cache.peek(creator_item(P, env, m)) is True
    assert delta(before, counts(P, cache))["attested"] == 1


def test_attest_roundtrip_skips_peer_device_verify(P):
    org = DevOrg("Org1")
    m = msps(P, org)
    env = order_env(org)
    block = make_block(P, [env], number=7)
    orderer_cache = P.vp.VerdictCache(capacity=64, owner="orderer")
    orderer_cache.put(creator_item(P, env, m), True, scope="ch")
    attests = P.vp.attest_block(orderer_cache, block, "ch", m)
    peer_cache = P.vp.VerdictCache(capacity=64, owner="peer")
    assert P.vp.accept_block_attestations(peer_cache, block, attests,
                                          "ch", m) == 1
    inner = CountingProvider(P.sw)
    cp = P.vp.CachingProvider(inner, peer_cache, site="committer",
                              scope="ch")
    assert bool(cp.batch_verify([creator_item(P, env, m)]).all())
    assert inner.dispatched == 0


def test_deliver_attestation_mismatch_revokes_sender(P, orgs):
    m = msps(P, *orgs)
    envs = [make_tx(*orgs) for _ in range(2)]
    good = P.vp.item_digest(creator_item(P, envs[0], m)).hex()
    cache = P.vp.VerdictCache(capacity=64)
    trust = P.vp.AttestorTrust()
    binding = ("OrdererOrg", "ab" * 32)
    n = P.vp.accept_block_attestations(
        cache, make_block(P, envs), [good, "cd" * 32], "ch", m,
        trust=trust, attestor_binding=binding)
    assert n == 1
    assert not trust.allowed(binding)


# -- across the packages ----------------------------------------------------


def test_item_digest_and_mac_equal_across_packages(orgs):
    ref, port = load("fabric_tpu"), load("fabric_tpu_torch")
    env = make_tx(*orgs)
    ref_it = creator_item(ref, env, msps(ref, *orgs))
    port_it = creator_item(port, env, msps(port, *orgs))
    assert tuple(ref_it) == tuple(port_it)
    assert ref.vp.item_digest(ref_it) == port.vp.item_digest(port_it)
    secret = bytes(range(32))
    caches = [P.vp.VerdictCache(capacity=8, secret=secret)
              for P in (ref, port)]
    for c, it in zip(caches, (ref_it, port_it)):
        c.set_epoch(5, scope="ch")
        c.put(it, True, scope="ch")
    d = ref.vp.item_digest(ref_it)
    assert caches[0]._data[d] == caches[1]._data[d]
    for verdict, epoch, scope in ((True, 5, "ch"), (False, 0, ""),
                                  (True, 2 ** 40, "other")):
        assert caches[0]._tag(d, verdict, scope, epoch) == \
            caches[1]._tag(d, verdict, scope, epoch)


def test_attestor_trust_state_file_byte_identical(tmp_path):
    """The same accepts and mismatches in both packages: the same state
    file, byte for byte, and the same standing after a reload."""
    files = {}
    for pkg in PKGS:
        T = load(pkg).vp.AttestorTrust
        path = tmp_path / f"{pkg}.json"
        trust = T(str(path))
        trust.note_accepted(("Org1", "AB" * 32), 3)
        trust.note_accepted(("Org2", "cd" * 32))
        trust.note_mismatch(("Org2", "cd" * 32))
        trust.note_mismatch(("Org2", "cd" * 32))
        assert trust.revoked_count() == 1
        files[pkg] = path.read_bytes()
        reloaded = T(str(path))
        assert not reloaded.allowed(("Org2", "CD" * 32))
        assert reloaded.allowed(("Org1", "ab" * 32))
        assert reloaded.snapshot() == trust.snapshot()
    assert files["fabric_tpu"] == files["fabric_tpu_torch"]
