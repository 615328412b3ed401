"""KV7's multi-device branch on the CPU: the plain versions of the
fold-range and finish kernels (fabric_tpu_torch/ops/block_validate.py)
and DeviceValidator over a device list, against the reference.

The reference's sharded program raises under the installed JAX (ROADMAP
C1), so the oracles are its single-device program (`local` through
`ref_program`, as in test_torch_block_validate.py), its single-device
ledger stack and the host stack (host gate + `validate_and_prepare_batch`
on both sides).  The reference's psums are sums over disjoint lane
shards, so the sharded result must equal the single-device one bit for
bit (integer codes: no tolerance).

(a) the plain fold of each shard's sig and read lanes, then the plain
    finish over the stacked partial masks and gathered read codes, over
    1, 2, 3, 4 and 8 shards on `ref_program`'s 200 seeded lane sets and
    every directed case of kv7_cases.py, shards without sig or read
    lanes included; the read codes also equal the kernel's, as the CPU
    model of block_validate.cu computes them (test_torch_kv7_walk.py);
(b) port ledger stacks with `DeviceValidator(devices=["cpu"] * k)`, k 2,
    3 and 4, on the corpora of test_torch_committer.py, against the
    port's and the reference's single-device stacks and the host stacks:
    flags, metadata flags, state, history, commit hash, demotions;
(c) the default-devices rule against the reference's `_get_mesh`, with
    `visible_devices` patched: the mesh is built, nothing launched."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from fabric_tpu.committer.device_validate import DeviceValidator as RefDV
from fabric_tpu.protocol.types import META_TXFLAGS
from fabric_tpu_torch.committer import Committer, PolicyRegistry, TxValidator
from fabric_tpu_torch.committer import device_validate as port_dv
from fabric_tpu_torch.committer.device_validate import DeviceValidator
from fabric_tpu_torch.ledger import KVLedger, LedgerConfig
from fabric_tpu_torch.msp import MSP, CachedMSP, MSPConfig
from fabric_tpu_torch.ops import block_validate as kv7
from fabric_tpu_torch.parallel.mesh import DeviceMesh, make_mesh, shard_bounds
from fabric_tpu_torch.policy import parse_policy
from fabric_tpu_torch.protocol import ValidationCode, wire

from kv7_cases import BLK, DIRECTED, lanes
from test_torch_block_validate import (random_lanes, ref_local,  # noqa: F401
                                       ref_program)
from test_torch_committer import (CORPORA, POLICY, REASONS, chain,
                                  history_of, orgs,  # noqa: F401
                                  providers, run_stack, seed_block,
                                  state_of)
from test_torch_kv7_walk import phase1, unpack

SHARDS = (1, 2, 3, 4, 8)
V = int(ValidationCode.VALID)
PHANTOM = int(ValidationCode.PHANTOM_READ_CONFLICT)


# -- (a) the plain fold and finish ------------------------------------------

def sharded_plain(ln, k, blk_num=BLK):
    """The plain fold of each of k shards, then the plain finish ->
    (gate, final, rcodes, empty shards)."""
    d = kv7.dims(ln)
    masks, rcodes, empty = [], [], 0
    for s_r, r_r in zip(shard_bounds(d["S"], k), shard_bounds(d["R"], k)):
        if s_r[0] == s_r[1] and r_r[0] == r_r[1]:
            empty += 1
            continue
        m, rc = kv7.block_validate_fold_plain(ln, blk_num, s_r, r_r)
        assert m.dtype == rc.dtype == torch.int32
        assert m.shape == (d["E"],) and rc.shape == (r_r[1] - r_r[0],)
        masks.append(m)
        rcodes.append(rc)
    masks = torch.stack(masks) if masks else torch.zeros(
        (0, d["E"]), dtype=torch.int32)
    rcodes = torch.cat(rcodes) if rcodes else torch.zeros(
        0, dtype=torch.int32)
    gate, final = kv7.block_validate_finish_plain(ln, blk_num, masks, rcodes)
    return gate.numpy(), final.numpy(), rcodes.tolist(), empty


def kernel_rcodes(ln, blk_num=BLK):
    """The read codes kv7_fold_kernel writes, from the CPU model of the
    kernel over pack's buffer."""
    buf, d = kv7.pack(ln)
    return phase1(unpack(buf, d), d, blk_num)[2]


_REF = {}


def ref_of(prog, key, ln):
    if key not in _REF:
        _REF[key] = ref_local(prog, ln)
    return _REF[key]


@pytest.mark.parametrize("k", SHARDS)
@pytest.mark.parametrize("chunk", range(4))
def test_sharded_plain_matches_reference_on_random_lanes(ref_program, chunk,
                                                         k):
    """50 seeded lane sets a case, 200 in all: the composition over k
    shards equals the reference's `local`, block_validate_plain and
    block_validate_sharded on a CPU mesh of k shards."""
    mesh = make_mesh(["cpu"] * k)
    n_conflicts = 0
    for seed in range(50 * chunk, 50 * (chunk + 1)):
        ln = random_lanes(np.random.default_rng(seed))
        rg, rf = ref_of(ref_program, seed, ln)
        g, f, rcodes, _empty = sharded_plain(ln, k)
        assert g.dtype == f.dtype == np.uint8
        assert np.array_equal(g, rg) and np.array_equal(f, rf), (seed, k)
        pg, pf = kv7.block_validate_plain(ln, BLK)
        assert np.array_equal(g, pg.numpy()) and np.array_equal(f, pf.numpy())
        sg, sf = kv7.block_validate_sharded(ln, BLK, mesh)
        assert np.array_equal(sg, g) and np.array_equal(sf, f)
        assert rcodes == kernel_rcodes(ln), seed
        n_conflicts += int((f == 11).sum())
    assert n_conflicts > 0


@pytest.mark.parametrize("k", SHARDS)
@pytest.mark.parametrize("case", sorted(DIRECTED))
def test_sharded_plain_matches_reference_on_directed_cases(ref_program, case,
                                                           k):
    spec, want = DIRECTED[case]
    ln = lanes(**spec)
    rg, rf = ref_of(ref_program, case, ln)
    g, f, rcodes, _empty = sharded_plain(ln, k)
    assert np.array_equal(g, rg) and np.array_equal(f, rf)
    assert f.tolist() == want
    assert rcodes == kernel_rcodes(ln)
    sg, sf = kv7.block_validate_sharded(ln, BLK, make_mesh(["cpu"] * k))
    assert np.array_equal(sg, g) and np.array_equal(sf, f)


def test_shards_without_sig_or_read_lanes():
    """Fewer sig and read lanes than shards: the empty shards fold
    nothing and the result stands; a shard with sig lanes and no read
    lanes, and one the other way round, each fold their half."""
    spec, want = DIRECTED["no_plan_keeps_pre"]     # 1 sig lane, 0 reads
    ln = lanes(**spec)
    g, f, rcodes, empty = sharded_plain(ln, 8)
    assert empty == 7 and rcodes == [] and f.tolist() == want
    spec, want = DIRECTED["r_has_zero"]            # 0 sig lanes, 2 reads
    ln = lanes(**spec)
    g, f, rcodes, empty = sharded_plain(ln, 4)
    assert empty == 2 and len(rcodes) == 2 and f.tolist() == want
    ln = next(ln for ln in (random_lanes(np.random.default_rng(seed))
                            for seed in range(100))
              if len(ln["sig_ent"]) > 2 and len(ln["r_tx"]) > 2)
    d = kv7.dims(ln)
    # one shard with the sig lanes only, one with the read lanes only
    m0, r0 = kv7.block_validate_fold_plain(ln, BLK, (0, d["S"]), (0, 0))
    m1, r1 = kv7.block_validate_fold_plain(ln, BLK, (0, 0), (0, d["R"]))
    assert r0.numel() == 0 and not m1.any()
    gate, final = kv7.block_validate_finish_plain(
        ln, BLK, torch.stack([m0, m1]), torch.cat([r0, r1]))
    pg, pf = kv7.block_validate_plain(ln, BLK)
    assert torch.equal(gate, pg) and torch.equal(final, pf)


def test_fold_and_finish_plain_refuse_bad_shapes():
    spec, _ = DIRECTED["two_writes_one_slot"]
    ln = lanes(**spec)
    d = kv7.dims(ln)
    with pytest.raises(ValueError, match="out of the block"):
        kv7.block_validate_fold_plain(ln, BLK, (0, 0), (0, d["R"] + 1))
    with pytest.raises(ValueError, match="out of the block"):
        kv7.block_validate_fold_plain(ln, BLK, (1, 0), (0, 0))
    m, rc = kv7.block_validate_fold_plain(ln, BLK, (0, d["S"]), (0, d["R"]))
    with pytest.raises(ValueError, match="partial_masks"):
        kv7.block_validate_finish_plain(ln, BLK, m, rc)
    with pytest.raises(ValueError, match="rcodes"):
        kv7.block_validate_finish_plain(ln, BLK, m[None], rc[:-1])
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        kv7.block_validate_sharded(ln, BLK, DeviceMesh(
            (torch.device("cpu"), torch.device("meta")), (None, None)))


def test_sharded_bytes_moved():
    """One card, repeated: the packed lanes once and the outputs, no
    gather; two cards: the packed lanes twice and the second shard's
    partial mask and read codes."""
    spec, _ = DIRECTED["hot_slot"]
    ln = lanes(**spec)
    _buf, d = kv7.pack(ln)
    one = DeviceMesh((torch.device("cuda", 0),) * 2, (None, None))
    two = DeviceMesh((torch.device("cuda", 0), torch.device("cuda", 1)),
                     (None, None))
    assert kv7.sharded_bytes_moved(d, one) == kv7.bytes_moved(d)
    r_hi = shard_bounds(d["R"], 2)[1]
    assert kv7.sharded_bytes_moved(d, two) == kv7.bytes_moved(d) + 4 * (
        kv7.packed_len(d) + d["E"] + r_hi[1] - r_hi[0])


# -- (b) DeviceValidator over a CPU mesh ------------------------------------

def mesh_stack(providers, orgs, k):
    """The port's device stack with DeviceValidator(devices=["cpu"] * k)
    -> (committer, device validator)."""
    _ref_sw, port_sw = providers
    msps = {o.mspid: CachedMSP(MSP(MSPConfig(
        **dataclasses.asdict(o.msp_config())))) for o in orgs}
    policies = PolicyRegistry()
    policies.set_policy("cc", parse_policy(POLICY))
    ledger = KVLedger("ch", LedgerConfig(device_validate=True))
    dv = DeviceValidator(ledger.statedb, "ch", devices=["cpu"] * k)
    assert dv.shards == k and len(dv.mesh) == k
    ledger.set_prepared_source(dv.take_prepared)
    return Committer(ledger, TxValidator(
        "ch", msps, port_sw, policies, device_validate=dv)), dv


def run_mesh(providers, orgs, raws, k):
    committer, dv = mesh_stack(providers, orgs, k)
    blocks = []
    for raw in raws:
        block = wire.parse_block(raw)
        res = committer.store_block(block)
        blocks.append((res.final_flags.codes(),
                       bytes(block.metadata.items[META_TXFLAGS])))
        if dv.last_timings.get("shards") is not None:
            assert dv.last_timings["shards"] == k
    lg = committer.ledger
    st = dv.stats
    assert st["validator_device_dispatches_total"] == \
        st["validator_device_blocks_total"]
    assert st["validator_device_stash_misses_total"] == 0
    return {"blocks": blocks, "hash": lg.commit_hash, "state": state_of(lg),
            "history": history_of(lg),
            "demotions": dict(st["validator_device_demotions_total"]),
            "device_blocks": st["validator_device_blocks_total"]}


_BASE = {}


def baselines(providers, orgs, name):
    """The four single-device and host stacks on a corpus, once."""
    if name not in _BASE:
        raws = chain(CORPORA[name](orgs))
        _BASE[name] = raws, {kind: run_stack(kind, providers, orgs, raws)
                             for kind in ("ref_host", "ref_dev",
                                          "port_host", "port_dev")}
    return _BASE[name]


# the corpora's device-validated blocks and demotions (each corpus's
# test in test_torch_committer.py)
WANT = {"ww_chain": (2, {}), "delete_then_read": (3, {}),
        "phantom_range": (2, {"range_query": 1}),
        "hash_collision": (0, {"hash_collision": 2}),
        "zero_and_full_conflict": (3, {}),
        "policy_and_signature_failures": (2, {}),
        "garbage_endorser_payload": (None, {}), "seeded_random": (4, {})}


@pytest.mark.parametrize("k", (2, 3, 4))
@pytest.mark.parametrize("name", sorted(CORPORA))
def test_mesh_stack_commits_what_single_device_and_host_commit(
        providers, orgs, name, k):
    raws, base = baselines(providers, orgs, name)
    got = run_mesh(providers, orgs, raws, k)
    for kind, res in base.items():
        for key in ("blocks", "hash", "state", "history"):
            assert got[key] == res[key], (kind, key)
    assert got["demotions"] == base["port_dev"]["demotions"] \
        == base["ref_dev"]["demotions"]
    device_blocks, demoted = WANT[name]
    want = dict.fromkeys(REASONS, 0)
    want.update(demoted)
    assert got["demotions"] == want
    assert got["device_blocks"] == base["port_dev"]["device_blocks"]
    if device_blocks is not None:
        assert got["device_blocks"] == device_blocks
    if name == "phantom_range":
        assert got["blocks"][1][0] == [V, PHANTOM]


@pytest.mark.parametrize("k", (2, 3, 4))
def test_mesh_stash_miss_falls_back(providers, orgs, k):
    """Flags tampered between validate and commit: the mesh validator's
    prepared batch is discarded and host MVCC runs, as on one device."""
    raw = chain([seed_block(orgs, 3)])[0]
    committer, dv = mesh_stack(providers, orgs, k)
    block = wire.parse_block(raw)
    res = committer.validator.validate(block)
    assert res.flags.codes() == [V] * 3
    assert dv.last_timings["shards"] == k
    block.metadata.items[META_TXFLAGS] = bytes([255] * 3)
    committer.ledger.commit(block)
    assert committer.ledger.get_state("cc", "k00") is None
    assert dv.stats["validator_device_stash_misses_total"] == 1
    assert dv.stats["validator_device_dispatches_total"] == 1


def test_mesh_error_propagates(providers, orgs, monkeypatch):
    """An error of a shard's fold leaves run(): no demotion, no move to
    one device or the host path."""
    raws = chain([seed_block(orgs, 2)])

    def boom(*a, **k):
        raise RuntimeError("block_validate fold launch failed: CUDA error 1")

    committer, dv = mesh_stack(providers, orgs, 2)
    monkeypatch.setattr(kv7, "block_validate_fold_plain", boom)
    with pytest.raises(RuntimeError, match="fold launch failed"):
        committer.store_block(wire.parse_block(raws[0]))
    assert dv.stats["validator_device_dispatches_total"] == 1
    assert dv.stats["validator_device_demotions_total"]["error"] == 0
    assert committer.ledger.height == 0


# -- (c) which devices ------------------------------------------------------

def fake_mesh(devices):
    """make_mesh without CUDA streams: the devices it would shard over."""
    return DeviceMesh(tuple(torch.device(d) for d in devices),
                      (None,) * len(devices))


def launches():
    return (kv7.block_validate_kernel.launches,
            kv7.block_validate_fold_kernel.launches)


@pytest.mark.parametrize("n", (1, 3, 4))
def test_default_devices_follow_the_reference_rule(monkeypatch, n):
    """devices=None, device=None: every visible card when their count is
    > 1 and a power of two (4), else the one resolved device (1, 3), as
    the reference's _get_mesh decides over n devices."""
    visible = [torch.device("cuda", i) for i in range(n)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(port_dv, "visible_devices", lambda: visible)
    monkeypatch.setattr(port_dv, "make_mesh", fake_mesh)
    before = launches()
    dv = DeviceValidator(None, "ch")
    peer = DeviceValidator(None, "ch", window=4096)   # node/peer.py's call
    ref = RefDV(None, "ch", devices=jax.devices()[:n])._get_mesh()
    for v in (dv, peer):
        if n == 4:
            assert v.mesh.devices == tuple(visible) and v.shards == 4
            assert v.device == visible[0]
        else:
            assert v.mesh is None and v.shards == 1
            assert v.device == torch.device("cuda")
    assert (ref is None) == (dv.mesh is None)
    if ref is not None:
        assert ref.devices.size == dv.shards
    assert launches() == before


@pytest.mark.parametrize("devices,shards", [
    (["cpu"], 1), (["cpu"] * 2, 2), (["cpu"] * 3, 3), (["cpu"] * 5, 5)])
def test_explicit_device_lists_of_any_length(devices, shards):
    dv = DeviceValidator(None, "ch", devices=devices)
    assert dv.shards == shards and dv.device == torch.device("cpu")
    assert (dv.mesh is None) == (shards == 1)


def test_device_arguments_refused(monkeypatch):
    with pytest.raises(ValueError, match="not both"):
        DeviceValidator(None, "ch", device="cpu", devices=["cpu"])
    with pytest.raises(ValueError, match="at least one device"):
        DeviceValidator(None, "ch", devices=[])
    monkeypatch.setattr(port_dv, "make_mesh", fake_mesh)
    with pytest.raises(ValueError, match="mixes device types"):
        DeviceValidator(None, "ch", devices=["cpu", "cuda:0"])


def test_no_cuda_default_raises():
    """Without a card and without a device named, the validator raises,
    as every entry point of the port does; it never moves to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        DeviceValidator(None, "ch")
