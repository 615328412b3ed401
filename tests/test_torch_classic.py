"""The port's classic commit tail against the reference's, on the CPU.

The classic tail is what a default peer of the reference runs: key-level
endorsement on (`sbe_lookup`), so `TxValidator` leaves the deep C path
for the C walker's `collect` (or its Python mirror, `collect_py`) and
the per-tx Python tail.  Every corpus of test_torch_committer.py goes
through the reference's classic tail and the port's, C walker and
Python mirror, and the port's deep tail; the port's `collect_py` is held
record for record against the reference's and against the port's C
`collect` on the reference's three-way fuzz generator; sub-block
dispatch chunks and `provider_source` are held to the reference's calls;
and one small block runs on the port's CUDA provider (its kernels' plain
versions on the CPU).  Tolerance: exact equality of flags, bytes and
hashes."""
import dataclasses
import random

import pytest

from fabric_tpu.bccsp.factory import FactoryOpts as RefOpts
from fabric_tpu.bccsp.factory import init_factories as ref_init
from fabric_tpu.committer import Committer as RefCommitter
from fabric_tpu.committer import PolicyRegistry as RefPolicies
from fabric_tpu.committer import TxValidator as RefValidator
from fabric_tpu.committer import collect_py as ref_collect_py
from fabric_tpu.committer import sbe as ref_sbe
from fabric_tpu.ledger import KVLedger as RefLedger
from fabric_tpu.msp import CachedMSP as RefCachedMSP
from fabric_tpu.msp.ca import DevOrg
from fabric_tpu.policy import parse_policy as ref_parse_policy
from fabric_tpu.protocol import (Block, KVWrite, NsRwSet, TxRwSet,
                                 ValidationCode, build)
from fabric_tpu.protocol.types import META_TXFLAGS, BlockHeader, BlockMetadata
from fabric_tpu_torch.bccsp import FactoryOpts, init_factories
from fabric_tpu_torch.bccsp.cuda import CudaProvider
from fabric_tpu_torch.committer import Committer, PolicyRegistry, TxValidator
from fabric_tpu_torch.committer import collect_py, sbe
from fabric_tpu_torch.committer import txvalidator as port_tv
from fabric_tpu_torch.ledger import KVLedger
from fabric_tpu_torch.msp import MSP, CachedMSP, MSPConfig
from fabric_tpu_torch.policy import parse_policy
from fabric_tpu_torch.protocol import wire

from test_torch_committer import (CORPORA, POLICY, chain, history_of,
                                  make_tx, rw, seed_block, state_of)

V = int(ValidationCode.VALID)
# the stacks: the reference's classic tail, the port's classic tail on
# the C walker and on the Python mirror, the port's deep tail
KINDS = ("ref_classic", "port_classic", "port_python", "port_deep")


@pytest.fixture(scope="module", autouse=True)
def providers():
    return (ref_init(RefOpts(default="SW")),
            init_factories(FactoryOpts(default="SW")))


@pytest.fixture(scope="module")
def orgs():
    return DevOrg("Org1"), DevOrg("Org2")


def port_msps(orgs):
    return {o.mspid: CachedMSP(MSP(MSPConfig(
        **dataclasses.asdict(o.msp_config())))) for o in orgs}


def ref_msps(orgs):
    return {o.mspid: RefCachedMSP(o.msp()) for o in orgs}


def make_stack(kind, provider, orgs, policy=POLICY, **kw):
    """-> a committer of `kind` on an in-memory ledger."""
    if kind.startswith("ref"):
        policies = RefPolicies()
        policies.set_policy("cc", ref_parse_policy(policy))
        ledger = RefLedger("ch")
        return RefCommitter(ledger, RefValidator(
            "ch", ref_msps(orgs), provider, policies,
            sbe_lookup=ref_sbe.statedb_lookup(ledger.statedb), **kw))
    policies = PolicyRegistry()
    policies.set_policy("cc", parse_policy(policy))
    ledger = KVLedger("ch")
    lookup = None if kind == "port_deep" else sbe.statedb_lookup(
        ledger.statedb)
    v = TxValidator("ch", port_msps(orgs), provider, policies,
                    sbe_lookup=lookup, **kw)
    v.force_python_collect = kind == "port_python"
    return Committer(ledger, v)


def run_stack(committer, raws, port: bool):
    """Commit the raw blocks -> what the stacks must agree on."""
    blocks = []
    for raw in raws:
        block = wire.parse_block(raw) if port else Block.deserialize(raw)
        res = committer.store_block(block)
        blocks.append((res.final_flags.codes(),
                       bytes(block.metadata.items[META_TXFLAGS])))
    lg = committer.ledger
    return {"blocks": blocks, "hash": lg.commit_hash, "state": state_of(lg),
            "history": history_of(lg)}


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_corpus_classic_tail_matches_reference(providers, orgs, corpus):
    """Every corpus: the four stacks agree on final flags, metadata
    flags, state, history and commit hash."""
    raws = chain(CORPORA[corpus](orgs))
    ref_sw, port_sw = providers
    res = {k: run_stack(make_stack(k, ref_sw if k.startswith("ref")
                                   else port_sw, orgs), raws,
                        k.startswith("port"))
           for k in KINDS}
    for k in KINDS[1:]:
        for key in ("blocks", "hash", "state", "history"):
            assert res[k][key] == res["ref_classic"][key], (corpus, k, key)


# -- collect_py against the reference's and the port's C collect ---------


def fuzz_corpus(rng, orgs, stranger, n=30):
    """The generator of test_committer.py's three-way fuzz: intra-block
    duplicates, unknown-org creators, single-org endorsements,
    truncations, junk, bitflips, config txs, wrong channels."""
    org1, org2 = orgs
    raws = []
    for _ in range(n):
        kind = rng.randrange(10)
        if kind == 0 and raws:
            raws.append(rng.choice(raws))
            continue
        creator = (stranger.new_identity("ghost") if kind == 1 else
                   (org1 if rng.random() < 0.5 else org2).new_identity("c"))
        if kind == 6:
            raws.append(build.signed_envelope(
                "config", "ch", {"config": {"sequence": 1}},
                creator).serialize())
            continue
        ends = ([org1.new_identity("e1")] if kind == 2 else
                [org1.new_identity("e1"), org2.new_identity("e2")])
        chan = "other" if kind == 7 else "ch"
        ns_rw = [("cc", [KVWrite(f"k{rng.random()}", b"v")])]
        if kind == 8:              # a key-level policy write beside it
            ns_rw.append(("cc#meta", [KVWrite("km", b"POL"),
                                      KVWrite("kd", b"", True)]))
        rwset = TxRwSet(tuple(NsRwSet(ns, writes=tuple(ws))
                              for ns, ws in ns_rw))
        raw = build.endorser_tx(chan, "cc", "1.0", rwset, creator,
                                ends).serialize()
        if kind == 3 and len(raw) > 4:
            raw = raw[:rng.randrange(1, len(raw))]
        elif kind == 4:
            raw = rng.randbytes(rng.randrange(0, 48))
        elif kind == 5:
            mut = bytearray(raw)
            mut[rng.randrange(len(mut))] ^= 0xFF
            raw = bytes(mut)
        raws.append(raw)
    return raws


def _norm(rec):
    """A walker record with its lists as tuples (the C walker builds
    lists where the mirror builds tuples in places)."""
    if isinstance(rec, (list, tuple)):
        return tuple(_norm(x) for x in rec)
    return rec


@pytest.mark.parametrize("seed", [11, 22, 33])
def test_collect_py_matches_reference_and_c_walker(orgs, seed):
    """Record for record: the port's collect_py, the reference's, and
    the port's C collect on the same fuzzed envelopes."""
    rng = random.Random(seed)
    creator = orgs[0].new_identity("late")
    # two late errors too: an unknown type and a nil action list
    raws = fuzz_corpus(rng, orgs, DevOrg("OrgX")) + [
        build.signed_envelope(typ, "ch", body, creator).serialize()
        for typ, body in (("weird_type", {"x": b"y"}),
                          ("endorser_transaction", {"actions": []}))]
    port = collect_py.collect(raws, "ch")
    assert port == ref_collect_py.collect(raws, "ch")
    c = port_tv._fastcollect.collect(raws, "ch")
    assert [_norm(r) for r in c] == [_norm(r) for r in port]
    kinds = {type(r).__name__ if not isinstance(r, tuple) else len(r)
             for r in port}
    assert {"int", 2, 7} <= kinds            # errors, late errors, records


def test_three_way_fuzz_validator_matches_reference(providers, orgs):
    """Pipelined blocks of the fuzz through the port's three modes and
    the reference's deep and classic tails: equal flags and unique
    item counts."""
    ref_sw, port_sw = providers
    org1, org2 = orgs
    stranger = DevOrg("OrgX")
    led_nonce = b"oracle-nonce-0001"
    led_creator = org1.new_identity("led")
    led_txid = build.compute_txid(led_nonce, led_creator.serialize())
    led_raw = build.endorser_tx(
        "ch", "cc", "1.0", rw(writes=[KVWrite("led", b"1")]), led_creator,
        [org1.new_identity("e1"), org2.new_identity("e2")],
        nonce=led_nonce).serialize()
    pol = "OR('Org1.member', 'Org2.member')"

    def run(kind, b1raws, b2raws, dup_raw):
        if kind.startswith("ref"):
            policies = RefPolicies()
            policies.set_policy("cc", ref_parse_policy(pol))
            v = RefValidator("ch", ref_msps(orgs), ref_sw, policies,
                             ledger_has_txid=lambda t: t == led_txid,
                             sbe_lookup=(lambda ns, k: None)
                             if kind == "ref_classic" else None)
        else:
            policies = PolicyRegistry()
            policies.set_policy("cc", parse_policy(pol))
            v = TxValidator("ch", port_msps(orgs), port_sw, policies,
                            ledger_has_txid=lambda t: t == led_txid,
                            sbe_lookup=None if kind == "port_deep"
                            else (lambda ns, k: None))
            v.force_python_collect = kind == "port_python"
        b1 = Block(BlockHeader(5, b"p", b"d"), list(b1raws) + [dup_raw],
                   BlockMetadata())
        b2 = Block(BlockHeader(6, b"p", b"d"),
                   list(b2raws) + [dup_raw, led_raw], BlockMetadata())
        s1 = v.validate_begin(b1)
        s2 = v.validate_begin(b2)          # pipelined: b1 carry
        r1 = v.validate_finish(s1)
        r2 = v.validate_finish(s2)
        return (r1.flags.codes(), r2.flags.codes(), r1.n_unique_items,
                r2.n_unique_items)

    for seed in (11, 22):
        rng = random.Random(seed)
        dup_raw = build.endorser_tx(
            "ch", "cc", "1.0", rw(writes=[KVWrite("dup", b"1")]),
            org1.new_identity("dupc"),
            [org1.new_identity("e1"), org2.new_identity("e2")],
            nonce=bytes([seed]) * 20).serialize()
        b1raws = fuzz_corpus(rng, orgs, stranger)
        b2raws = fuzz_corpus(rng, orgs, stranger)
        outs = {k: run(k, b1raws, b2raws, dup_raw)
                for k in ("ref_deep", "ref_classic", "port_deep",
                          "port_classic", "port_python")}
        assert len(set(map(repr, outs.values()))) == 1, (seed, outs)
        ref = outs["ref_deep"]
        assert ref[0][len(b1raws)] == V
        assert ref[1][len(b2raws)] == ref[1][len(b2raws) + 1] == \
            int(ValidationCode.DUPLICATE_TXID)


# -- sub-block dispatch chunks and provider_source ------------------------


class CountingProvider:
    """Delegating provider that records every batch_verify_async."""

    def __init__(self, inner):
        self.inner = inner
        self.name = inner.name
        self.batches = []

    def batch_verify(self, items):
        return self.inner.batch_verify(list(items))

    def batch_verify_async(self, items):
        items = list(items)
        self.batches.append(len(items))
        return self.inner.batch_verify_async(items)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _mixed_block(orgs, n=11):
    """n txs, every third endorsed by Org1 alone, one bad payload."""
    org1, _ = orgs
    envs = [make_tx(orgs, rw(writes=[KVWrite(f"k{i:02d}", b"v")]),
                    endorsers=[org1.new_identity("e")] if i % 3 == 2
                    else None) for i in range(n)]
    raws = [e.serialize() for e in envs]
    raws[4] = raws[4][:40]
    return raws


@pytest.mark.parametrize("chunk", [1, 3, 4])
def test_dispatch_chunks_match_reference(providers, orgs, monkeypatch,
                                         chunk):
    """FABRIC_TPU_VALIDATE_CHUNK on both tails: the same flags, and the
    same batch_verify_async calls (count and sizes) as the reference."""
    monkeypatch.setenv("FABRIC_TPU_VALIDATE_CHUNK", str(chunk))
    ref_sw, port_sw = providers
    raws = _mixed_block(orgs)
    out = {}
    for kind in ("ref_classic", "ref_deep", "port_classic", "port_deep"):
        prov = CountingProvider(ref_sw if kind.startswith("ref")
                                else port_sw)
        classic = kind.endswith("classic")
        if kind.startswith("ref"):
            policies = RefPolicies()
            policies.set_policy("cc", ref_parse_policy(POLICY))
            v = RefValidator("ch", ref_msps(orgs), prov, policies,
                             sbe_lookup=(lambda ns, k: None)
                             if classic else None)
        else:
            policies = PolicyRegistry()
            policies.set_policy("cc", parse_policy(POLICY))
            v = TxValidator("ch", port_msps(orgs), prov, policies,
                            sbe_lookup=(lambda ns, k: None)
                            if classic else None)
        res = v.validate(Block(BlockHeader(3, b"p", b"d"), list(raws),
                               BlockMetadata()))
        out[kind] = (res.flags.codes(), prov.batches)
    assert out["port_classic"] == out["ref_classic"]
    assert out["port_deep"] == out["ref_deep"]
    assert out["port_classic"][0] == out["port_deep"][0]
    assert len(out["port_classic"][1]) > 1     # really chunked


@pytest.mark.parametrize("mode", ["provider", "none", "raises"])
@pytest.mark.parametrize("tail", ["classic", "deep"])
def test_provider_source_contract(providers, orgs, monkeypatch, mode, tail):
    """provider_source(channel_id, demand) is asked once per flush with
    the flush's item count; a source that raises or returns None falls
    back to the static provider.  Calls and the provider that verified
    each flush equal the reference's."""
    monkeypatch.setenv("FABRIC_TPU_VALIDATE_CHUNK", "4")
    ref_sw, port_sw = providers
    raws = _mixed_block(orgs)
    out = {}
    for side in ("ref", "port"):
        sw = ref_sw if side == "ref" else port_sw
        static, placed = CountingProvider(sw), CountingProvider(sw)
        calls = []

        def source(channel_id, demand, placed=placed, calls=calls):
            calls.append((channel_id, demand))
            if mode == "raises":
                raise RuntimeError("placement down")
            return placed if mode == "provider" else None

        lookup = (lambda ns, k: None) if tail == "classic" else None
        if side == "ref":
            policies = RefPolicies()
            policies.set_policy("cc", ref_parse_policy(POLICY))
            v = RefValidator("ch", ref_msps(orgs), static, policies,
                             sbe_lookup=lookup, provider_source=source)
        else:
            policies = PolicyRegistry()
            policies.set_policy("cc", parse_policy(POLICY))
            v = TxValidator("ch", port_msps(orgs), static, policies,
                            sbe_lookup=lookup, provider_source=source)
        res = v.validate(Block(BlockHeader(3, b"p", b"d"), list(raws),
                               BlockMetadata()))
        flush_demands = [d for _c, d in calls if d is not None]
        out[side] = (res.flags.codes(), flush_demands, static.batches,
                     placed.batches, {c for c, _d in calls})
    assert out["port"] == out["ref"]
    codes, demands, static_b, placed_b, chans = out["port"]
    assert chans == {"ch"} and demands
    if mode == "provider":
        assert placed_b == demands and static_b == []
    else:
        assert static_b == demands and placed_b == []


def test_slice_small_block_on_cuda_provider(providers, orgs):
    """One small block through the port's classic tail on the CUDA
    provider (KP3's and KP2's plain versions on the CPU) against the
    reference's classic tail: equal flags, state and commit hash."""
    ref_sw, _ = providers
    org1, org2 = orgs
    e1, e2 = org1.new_identity("e1"), org2.new_identity("e2")
    client = org1.new_identity("client")
    envs = [make_tx(orgs, rw(writes=[KVWrite(f"k{i:02d}", b"v")]),
                    endorsers=[e1, e2] if i != 3 else [e1], creator=client)
            for i in range(6)]
    bad = envs[5]
    envs[5] = type(bad)(bad.payload, bad.signature[:-2] + b"\x00\x01")
    raws = chain([seed_block(orgs, 2), envs])
    ref = run_stack(make_stack("ref_classic", ref_sw, orgs), raws, False)
    prov = CudaProvider(device="cpu", fast_key_threshold=4)
    port = run_stack(make_stack("port_classic", prov, orgs), raws, True)
    assert port == ref
    assert port["blocks"][1][0] == [V, V, V, int(
        ValidationCode.ENDORSEMENT_POLICY_FAILURE), V,
        int(ValidationCode.BAD_CREATOR_SIGNATURE)]
    assert prov.stats["fallbacks"] == 0
