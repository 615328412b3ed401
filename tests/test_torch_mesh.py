"""The port's multi-device lanes (fabric_tpu_torch.parallel.mesh, K9) on
meshes of CPU shards, make_mesh(["cpu"] * k) for k in 1, 2, 3, 8.

- The partition rules: the port's cases of tests/test_placement.py:33-58.
- The split and the gather, exactly: every lane's wrapper is replaced by
  a probe whose verdict is a function of each column's words (and slot),
  so a column sent to the wrong shard, a verdict gathered out of order,
  a replicated argument split or a split one replicated shows, and each
  shard's launches come from the probe's own count; at batch sizes 0, 1
  (seven empty shards on 8) and 13 (no k divides it).
- Real arithmetic: each sharded lane on 3 CPU shards (no batch here is
  a multiple of 3) against the unsharded port wrapper and the
  reference's unsharded JAX function, bit for bit, with the same count:
  here the fixed-key lanes (fabric_tpu.ops.p256_fixed.verify_words_rows,
  ed25519.verify_words_rows), in tests/test_torch_mesh_generic.py the
  generic ones, in tests/test_torch_mesh_provider.py KB8 and the
  provider on real arithmetic (three files, so that xdist runs them side
  by side).  On the CPU each shard runs a kernel's plain version,
  seconds a call whatever its size, so these batches are small and one
  shard count stands for the rest, which the probes above cover: 2
  signatures on the generic lanes, 4 under 2 keys on the fixed-key lanes
  (a key's run crosses a shard boundary), a green and a red pairing
  check.
- The provider on test_torch_bccsp.py's stubbed kernels: lane choice,
  scatter, stats, and the replicated bank's slot map, pins and spill
  under a mesh.
"""
import hashlib
import random

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)
import jax.numpy as jnp

from fabric_tpu.ops import ed25519 as ref_ed
from fabric_tpu.ops import ed25519_tables as ref_ed_tables
from fabric_tpu.ops import p256_fixed as ref_fixed
from fabric_tpu.ops import p256_tables as ref_tables
from fabric_tpu_torch import crypto
from fabric_tpu_torch.bccsp import SCHEME_P256, VerifyItem
from fabric_tpu_torch.bccsp.cuda import CudaProvider
from fabric_tpu_torch.ops import bn254, ed25519, ed25519_tables, p256
from fabric_tpu_torch.ops import p256_fixed, p256_tables
from fabric_tpu_torch.ops.device_bank import DeviceBank
from fabric_tpu_torch.parallel import mesh as M

from test_torch_bccsp import (ed_keys, ed_lanes, ed_signed,  # noqa: F401
                              even_r, even_ry, keypool, lanes, port, signed,
                              stubbed)

KS = (1, 2, 3, 8)
REAL_K = 3                     # the shard count of the real-arithmetic runs
CPU = torch.device("cpu")
ED_P = 2**255 - 19


def cpu_mesh(k):
    return M.make_mesh(["cpu"] * k)


# -- partition rules ---------------------------------------------------------

def test_lane_specs_cover_every_lane():
    assert set(M.LANE_ARGS) == {"p256", "p256-rows", "ed25519",
                                "ed25519-rows", "idemix-pair"}
    for lane, names in M.LANE_ARGS.items():
        specs = M.lane_specs(lane)
        assert len(specs) == len(names)
        for name, spec in zip(names, specs):
            if any(t in name for t in ("bank", "lines", "flags", "table")):
                assert spec == M.REPLICATED, (lane, name)
            elif name in ("row_key", "line_slot"):
                assert spec == M.Split(0, host=True), (lane, name)
            elif "sign" in name:
                assert spec == M.Split(0), (lane, name)
            else:
                assert spec == M.Split(-1), (lane, name)


def test_unmatched_arg_name_is_hard_error():
    with pytest.raises(ValueError, match="no partition rule"):
        M.match_partition_rules(M.PARTITION_RULES, ("mystery_arg",))


def test_sign_rows_takes_the_sign_rule():
    # the reference's (R, C) sign grids shard dim 0 of two; the port's
    # sign bits are (B,) whatever the lane
    assert M.match_partition_rules(M.PARTITION_RULES, ("r_sign_rows",)) \
        == (M.Split(0),)


@pytest.mark.parametrize("k", KS)
def test_shard_bounds_are_tensor_splits(k):
    for n in range(0, 30):
        sizes = [hi - lo for lo, hi in M.shard_bounds(n, k)]
        want = [len(t) for t in torch.tensor_split(torch.arange(n), k)]
        assert sizes == want
        assert M.shard_bounds(n, k)[-1][1] == n


def test_make_mesh_shards_and_distinct_devices():
    m = cpu_mesh(3)
    assert len(m) == 3 and m.devices == (CPU,) * 3
    assert m.streams == (None,) * 3 and m.distinct_devices == (CPU,)
    with pytest.raises(ValueError):
        M.make_mesh([])


def test_make_mesh_default_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        M.make_mesh(["cuda:0", "cuda:0"])


# -- the split and the gather, on probes -------------------------------------

WRAPPERS = {"p256": (p256, "p256_verify"),
            "p256-rows": (p256_fixed, "p256_verify_rows"),
            "ed25519": (ed25519, "ed25519_verify"),
            "ed25519-rows": (ed25519, "ed25519_verify_rows"),
            "idemix-pair": (bn254, "bn254_pairing_check")}
SHARDERS = {"p256": M.sharded_p256_verify,
            "p256-rows": M.sharded_p256_rows_verify,
            "ed25519": M.sharded_ed25519_verify,
            "ed25519-rows": M.sharded_ed25519_rows_verify,
            "idemix-pair": M.sharded_idemix_pair_verify}


def probe_verdicts(lane, args):
    """A verdict per column from every split argument: (8, b) words fold
    their eight words, (b,) vectors their entries."""
    acc = None
    for a, spec in zip(args, M.lane_specs(lane)):
        if spec == M.REPLICATED:
            continue
        v = a.to(torch.int64)
        v = v.sum(0) * 7 if v.dim() == 2 else v
        acc = v if acc is None else acc * 3 + v
    return acc % 5 < 3


def lane_inputs(lane, n, rng):
    """Random inputs of the lane's shapes and types, on the CPU."""
    out = []
    for name, spec in zip(M.LANE_ARGS[lane], M.lane_specs(lane)):
        if spec == M.REPLICATED:
            out.append(torch.from_numpy(rng.integers(0, 2**32, (3, 2),
                                                     dtype=np.uint32)))
        elif spec.axis == 0:
            out.append(torch.from_numpy(rng.integers(0, 9, n,
                                                     dtype=np.int32)))
        else:
            out.append(torch.from_numpy(rng.integers(0, 2**32, (8, n),
                                                     dtype=np.uint32)))
    return out


@pytest.mark.parametrize("n", [0, 1, 13])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("lane", list(M.LANE_ARGS))
def test_split_and_gather_exact(lane, k, n, monkeypatch):
    specs = M.lane_specs(lane)
    calls = []

    def probe(*args, **kwargs):
        for a, spec in zip(args, specs):
            if spec != M.REPLICATED:
                assert a.is_contiguous() and a.device == CPU
        calls.append((args, kwargs))
        probe.launches += 1
        return probe_verdicts(lane, args)

    probe.launches = 0
    mod, name = WRAPPERS[lane]
    monkeypatch.setattr(mod, name, probe)
    args = lane_inputs(lane, n, np.random.default_rng(1000 * k + n))
    # one replicated argument as a {device: replica} map, the rest as is
    rep = [i for i, s in enumerate(specs) if s == M.REPLICATED]
    args[rep[0]] = {CPU: args[rep[0]]}
    fn = SHARDERS[lane](cpu_mesh(k))
    verdicts, count = fn(*args)
    whole = [a[CPU] if isinstance(a, dict) else a for a in args]
    want = probe_verdicts(lane, whole) if n else torch.zeros(0, dtype=bool)
    assert verdicts.dtype == torch.bool and torch.equal(verdicts, want)
    assert int(count) == int(want.sum())
    sizes = [hi - lo for lo, hi in M.shard_bounds(n, k) if hi > lo]
    assert len(calls) == len(sizes)         # an empty shard launches nothing
    # launches a shard: what the wrapper's own count gained in its calls
    assert fn.shard_launches == [int(hi > lo) for lo, hi in
                                 M.shard_bounds(n, k)]
    for (cargs, kwargs), size in zip(calls, sizes):
        for a, b, spec in zip(cargs, whole, specs):
            if spec == M.REPLICATED:
                assert a is b               # the device's replica, whole
            else:
                assert a.shape[spec.axis] == size
        if lane.startswith("p256"):
            assert kwargs == {"require_low_s": True}


def test_mismatched_batch_sizes_raise():
    fn = M.sharded_p256_verify(cpu_mesh(2))
    w = torch.zeros((8, 3), dtype=torch.uint32)
    with pytest.raises(ValueError, match="batch sizes"):
        fn(w, w, w, w, torch.zeros((8, 4), dtype=torch.uint32),
           p256_tables.g_table(CPU))
    with pytest.raises(TypeError, match="arguments expected"):
        fn(w, w, w, w, w)


# -- real arithmetic ---------------------------------------------------------

def p256_items(n_keys, per_key, bad, seed):
    """(qx, qy, r, s, e) int rows, key-major; rows in `bad` get a wrong
    digest."""
    rng = random.Random(seed)
    rows = []
    for j in range(n_keys):
        key = crypto.p256_key_from_scalar(rng.randrange(1, p256.N))
        pub = crypto.p256_public_bytes(key)
        for _ in range(per_key):
            digest = hashlib.sha256(rng.randbytes(20)).digest()
            r, s = crypto.p256_sign_digest(key, digest)
            e = int.from_bytes(digest, "big") ^ (len(rows) in bad)
            rows.append((int.from_bytes(pub[1:33], "big"),
                         int.from_bytes(pub[33:], "big"), r,
                         min(s, p256.N - s), e))
    return rows


def ed_items(n_keys, per_key, bad, seed):
    """(pk, sig, msg) rows, key-major; rows in `bad` get another msg."""
    rng = random.Random(seed)
    rows = []
    for _ in range(n_keys):
        key = crypto.ed25519_key_from_seed(rng.randbytes(32))
        for _ in range(per_key):
            msg = rng.randbytes(30)
            sig = crypto.ed25519_sign(key, msg)
            rows.append((crypto.ed25519_public_bytes(key), sig,
                         msg + b"!" if len(rows) in bad else msg))
    return rows


def sharded_run(make, args):
    """(verdicts, count) of the lane over a mesh of REAL_K CPU shards."""
    v, c = make(cpu_mesh(REAL_K))(*args)
    return v.tolist(), int(c)


@pytest.fixture(scope="module")
def lane_p256_rows():
    """KP3: four signatures under two keys, key-major (slots 0, 0, 1, 1),
    the second with a wrong digest; the reference over one row of C = 1
    per signature."""
    rows = p256_items(2, 2, bad={1}, seed=4)
    keys = [(rows[0][0], rows[0][1]), (rows[2][0], rows[2][1])]
    slot = np.asarray([0, 0, 1, 1], np.int32)
    bank = torch.stack([torch.from_numpy(p256_tables.comb_table_for_point(
        *k)) for k in keys])
    ref_bank = np.stack([ref_tables.comb_table_for_point(*k)
                         for k in keys]).astype(np.float32)
    r, s, e = [p256.ints_to_words([row[c] for row in rows]) for c in (2, 3,
                                                                      4)]
    table = p256_tables.g_table(CPU)
    ref = ref_fixed.verify_words_rows(
        ref_bank, slot, r.reshape(8, 4, 1), s.reshape(8, 4, 1),
        e.reshape(8, 4, 1))
    port = p256_fixed.p256_verify_rows(
        *[torch.from_numpy(w) for w in (r, s, e)], torch.from_numpy(slot),
        bank, table)
    return {"labels": [True, False, True, True],
            "jax": np.asarray(ref).reshape(4).tolist(),
            "port": port.tolist(),
            "sharded": sharded_run(M.sharded_p256_rows_verify,
                                    [r, s, e, slot, {CPU: bank}, table])}


@pytest.fixture(scope="module")
def lane_ed25519_rows():
    """KE6: four signatures under two keys (slots 0, 0, 1, 1), the second
    over another message."""
    rows = ed_items(2, 2, bad={1}, seed=6)
    _, _, ry, r_sign, s, k = ed25519.pack_verify_inputs(
        *map(list, zip(*rows)))
    pks = [rows[0][0], rows[2][0]]
    slot = np.asarray([0, 0, 1, 1], np.int32)
    bank = torch.stack([torch.from_numpy(ed25519_tables.table_for_pubkey(pk))
                        for pk in pks])

    def ref_table(pk):
        x, y = ref_ed_tables.decompress_int(pk)
        return ref_ed_tables.comb_table_for_point((-x) % ED_P, y)

    ref_bank = np.stack([ref_table(pk) for pk in pks])
    table = ed25519_tables.b_table(CPU)
    ref = ref_ed.verify_words_rows(
        jnp.asarray(ref_bank), jnp.asarray(slot),
        jnp.asarray(ry.reshape(8, 4, 1)), jnp.asarray(r_sign.reshape(4, 1)),
        jnp.asarray(s.reshape(8, 4, 1)), jnp.asarray(k.reshape(8, 4, 1)))
    words = [torch.from_numpy(np.ascontiguousarray(a))
             for a in (ry, r_sign, s, k)]
    port = ed25519.ed25519_verify_rows(*words, torch.from_numpy(slot), bank,
                                       table)
    return {"labels": [True, False, True, True],
            "jax": np.asarray(ref).reshape(4).tolist(),
            "port": port.tolist(),
            "sharded": sharded_run(M.sharded_ed25519_rows_verify,
                                    [ry, r_sign, s, k, slot, {CPU: bank},
                                     table])}


def check_lane(got):
    """A lane's verdicts on REAL_K CPU shards equal the unsharded port
    wrapper's, the reference's (the labels for KB8) and the labels, bit
    for bit, and the count is their sum."""
    verdicts, count = got["sharded"]
    assert verdicts == got["port"] == got["jax"] == got["labels"]
    assert count == sum(got["labels"])


@pytest.mark.parametrize("lane", ["lane_p256_rows", "lane_ed25519_rows"])
def test_sharded_lane_matches_unsharded_and_reference(lane, request):
    check_lane(request.getfixturevalue(lane))


# -- the provider ------------------------------------------------------------

@pytest.mark.parametrize("k", KS)
def test_provider_on_mesh_scatters_every_lane(k, keypool, ed_keys, stubbed):
    """Hot and cold keys of both curves and malformed items in one batch,
    on stubbed kernels: verdicts scatter back to their items, every key's
    table is built once (not once per shard), the stats equal the
    single-device provider's, and the pins are released."""
    hot = signed(keypool[:2], 5, seed=60)
    cold = signed(keypool[2:9], 1, seed=61)
    e_hot, _ = ed_signed(ed_keys[:2], 5, seed=62)
    e_cold, _ = ed_signed(ed_keys[2:7], 1, seed=63)
    bad = [VerifyItem(SCHEME_P256, b"\x04" + b"\x00" * 10, b"\x30\x00",
                      b"x"), VerifyItem("rsa-4096", b"k", b"s", b"m")]
    items = cold[:3] + hot + e_cold + cold[3:] + bad + e_hot
    want = [(even_r([it]) if it.scheme == SCHEME_P256 else even_ry([it]))[0]
            if it not in bad else False for it in items]
    provs = {}
    for name, kw in (("single", {"device": "cpu"}),
                     ("mesh", {"mesh": cpu_mesh(k)})):
        stubbed.clear()
        prov = provs[name] = CudaProvider(fast_key_threshold=4, **kw)
        assert prov.batch_verify(items).tolist() == want
        provs[name + "_lanes"] = (lanes(stubbed), ed_lanes(stubbed))
    one, many = provs["single"], provs["mesh"]
    assert provs["mesh_lanes"] == provs["single_lanes"] == (
        (10, 7), (10, 5))
    assert many.stats == one.stats
    assert many.key_tables.stats == one.key_tables.stats
    assert many.key_tables.stats["builds"] == 2
    assert many.ed_key_tables.stats == one.ed_key_tables.stats
    assert not many.key_tables._pinned and not many.ed_key_tables._pinned


def test_mesh_spill_when_slots_pinned(keypool, stubbed):
    """Phase 4's spill drill under a 2-shard mesh: two slots, three hot
    keys; the third key's build finds both slots pinned and its
    signatures take KP2."""
    items = []
    for j, key in enumerate(keypool[:3]):
        items += signed([key], 6 - j, seed=70 + j)
    prov = CudaProvider(fast_key_threshold=4, max_cached_keys=2,
                        mesh=cpu_mesh(2))
    assert prov.batch_verify(items).tolist() == even_r(items)
    assert lanes(stubbed) == (6 + 5, 4)
    st = prov.key_tables.stats
    assert st["pinned_spills"] == 1 and st["builds"] == 2
    assert not prov.key_tables._pinned
    # a later batch of the third key evicts the least recent slot
    prov.batch_verify(signed([keypool[2]], 4, seed=73))
    assert st["evictions"] == 1 and st["builds"] == 3


def test_replicated_bank_one_slot_map():
    """devices repeated in a mesh give one replica each; a build writes
    every replica; the slot map, pins and stats are the single bank's."""
    def build(pk):
        return np.full((4, 2), pk[-1], np.uint32)

    bank = DeviceBank(2, (4, 2), build, devices=cpu_mesh(3).distinct_devices)
    single = DeviceBank(2, (4, 2), build, device="cpu")
    assert bank.devices == (CPU,) and set(bank.replicas()) == {CPU}
    for b in (bank, single):
        assert b.get_or_build(b"k1", pin=True) == 0
        assert b.get_or_build(b"k2") == 1
        assert b.get_or_build(b"k3") == 1       # evicts k2; k1 is pinned
        b.unpin([0])
    assert bank.stats == single.stats
    assert torch.equal(bank.array(CPU), single.array())
    with pytest.raises(ValueError):
        DeviceBank(2, (4, 2), build, device="cpu", devices=[CPU])
