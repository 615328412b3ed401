"""KP1 at the reference's R and KF2 (fabric_tpu_torch.ops.field_variants)
against the function the JAX package's Pallas microbenchmarks check
themselves against: a chain of `bignum.Mont(P256, "p").mul` (R = 2^264),
on the scripts' own data (`np.random.default_rng(0)`, a = vals,
b = vals[::-1]), and against Python ints.  Values are compared mod p
(the reference's Mont keeps them in [0, 2p)); the port's outputs are
canonical and are compared exactly."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fabric_tpu.ops import bignum as bn
from fabric_tpu_torch import experiments as X
from fabric_tpu_torch.experiments import (proto_ilp, proto_pallas,
                                          proto_pallas2, proto_pallas4,
                                          proto_planes)
from fabric_tpu_torch.ops import field as F
from fabric_tpu_torch.ops import field_variants as FV

P = F.P
R264 = 1 << 264
MONT = bn.Mont(P, "p")
_mont_mul = jax.jit(MONT.mul)
# the presets with each K they take
PRESET_KS = [(p, k) for p, (_, ks) in FV.PRESETS.items() for k in ks]


def script_vals(n_lanes):
    """The scripts' first values: default_rng(0), 32 bytes big-endian, mod
    p, plus edge values."""
    vals = list(X.seeded_ints(n_lanes))
    return vals + [0, 1, P - 1, P - 2], vals[::-1] + [P - 1, 2, 1, 0]


def mont_chain(va, vb, k):
    """The reference's chain: k times x <- Mont.mul(x, b), jitted."""
    x = jnp.asarray(bn.ints_to_limbs(va))
    y = jnp.asarray(bn.ints_to_limbs(vb))
    for _ in range(k):
        x = _mont_mul(x, y)
    return [v % P for v in bn.limbs_to_ints(np.asarray(x))]


def chain_ints(va, vb, k):
    rinv = pow(R264, -1, P)
    return [x * pow(y * rinv % P, k, P) % P for x, y in zip(va, vb)]


@pytest.mark.parametrize("k", [0, 1, 2, 4])
def test_mul_chain_plain_r264_matches_mont_chain(k):
    va, vb = script_vals(16)
    out = F.mul_chain_plain(F.ints_to_words_le(va), F.ints_to_words_le(vb),
                            k, "p", r_log2=264)
    got = F.words_le_to_ints(out)
    assert got == mont_chain(va, vb, k)
    assert all(0 <= g < P for g in got)


@pytest.mark.parametrize("n", [192, 96])
def test_mul_chain_plain_r264_matches_ints_at_script_n(n):
    va, vb = script_vals(24)
    out = F.mul_chain_plain(F.ints_to_words_le(va), F.ints_to_words_le(vb),
                            n, "p", r_log2=264)
    assert F.words_le_to_ints(out) == chain_ints(va, vb, n)


@pytest.mark.parametrize("modulus", sorted(F.MODS))
def test_mul_chain_plain_r264_every_modulus(modulus):
    m = F.MODS[modulus].m
    va = [0, 1, m - 1, m, (1 << 256) - 1, 1 << 248, 12345]
    vb = [(1 << 256) - 1, m + 1, 3, m - 1, 1 << 255, 7, m]
    rinv = pow(R264, -1, m)
    for k in (0, 1, 3):
        out = F.mul_chain_plain(F.ints_to_words_le(va),
                                F.ints_to_words_le(vb), k, modulus, 264)
        assert F.words_le_to_ints(out) == [
            x * pow(y * rinv, k, m) % m for x, y in zip(va, vb)]


def test_kp1_at_reference_r_matches_proto_pallas_function():
    """KP1 (the wrapper, on CPU tensors) at r_log2=264 computes the function
    experiments/proto_pallas.py checks its kernel against: a Mont.mul chain
    of NMUL x NITER = 192 multiplies.  At the port's own R it does not."""
    va, vb = script_vals(16)
    a, b = F.ints_to_words_le(va), F.ints_to_words_le(vb)
    n = proto_pallas.NMUL * proto_pallas.NITER
    want = mont_chain(va, vb, n)
    assert F.words_le_to_ints(F.field_mul_chain(a, b, n, "p",
                                                r_log2=264)) == want
    at_256 = F.words_le_to_ints(F.field_mul_chain(a, b, n, "p"))
    assert at_256 != want
    rinv = pow(1 << 256, -1, P)
    assert at_256 == [x * pow(y * rinv, n, P) % P for x, y in zip(va, vb)]


def test_r_log2_rejected():
    a = F.ints_to_words_le([1, 2])
    for bad in (255, 0, 257):
        with pytest.raises(ValueError):
            F.mul_chain_plain(a, a, 1, "p", r_log2=bad)
        with pytest.raises(ValueError):
            F.field_mul_chain(a, a, 1, "p", r_log2=bad)


@pytest.mark.parametrize("preset,k", PRESET_KS)
def test_preset_wrapper_on_cpu_matches_ints(preset, k):
    v = FV.variant_of(preset, k)
    va, vb = script_vals(60)                  # 64 lanes: K divides them
    a, b = F.ints_to_words_le(va), F.ints_to_words_le(vb)
    if v.planes:
        a, b = FV.to_planes(a), FV.to_planes(b)
    n = 7
    out = FV.field_chain_variant(a, b, n, preset, k)
    assert out.dtype == torch.uint32 and out.shape == a.shape
    assert torch.equal(out, FV.variant_plain(a, b, n, preset, k))
    lanes = FV.from_planes(out) if v.planes else out
    assert F.words_le_to_ints(lanes) == chain_ints(va, vb, n)


def test_planes_round_trip_and_layout():
    va, _ = script_vals(12)
    x = F.ints_to_words_le(va)
    planes = FV.to_planes(x)
    assert planes.shape == (8, len(va)) and planes.dtype == torch.uint32
    assert torch.equal(FV.from_planes(planes), x)
    # word w of lane i sits at planes[w, i]
    for i in (0, 5, len(va) - 1):
        assert [int(planes[w, i]) for w in range(8)] == [
            (va[i] >> (32 * w)) & 0xFFFFFFFF for w in range(8)]


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_stacked_lane_order_matches_reference_reshape(k):
    """Chain k of thread j is lane k * (B / K) + j, as the reference's
    ints_to_limbs(vals).reshape(L, K, B // K)[:, k, j]."""
    B = 32
    vals = list(X.seeded_ints(B))
    ref = bn.ints_to_limbs(vals).reshape(bn.N_LIMBS, k, B // k)
    stacked = FV.stack_lanes(F.ints_to_words_le(vals), k)
    assert stacked.shape == (k, B // k, 8)
    for kk in range(k):
        for j in range(B // k):
            lane = F.words_le_to_ints(stacked[kk, j:j + 1])[0]
            assert lane == bn.limbs_to_ints(ref[:, kk, j:j + 1])[0]


def test_wrapper_rejects_bad_inputs():
    a = F.ints_to_words_le(list(range(1, 9)))
    with pytest.raises(ValueError):
        FV.field_chain_variant(a, a, 1, "nope")
    with pytest.raises(ValueError):
        FV.field_chain_variant(a, a, 1, "ilp")             # ilp needs k
    with pytest.raises(ValueError):
        FV.field_chain_variant(a, a, 1, "ilp", k=3)
    with pytest.raises(ValueError):
        FV.field_chain_variant(a, a, 1, "stacked", k=2)
    with pytest.raises(TypeError):
        FV.field_chain_variant(a.to(torch.int64), a, 1, "relaxed")
    with pytest.raises(ValueError):
        FV.field_chain_variant(a, a[:4], 1, "relaxed")
    with pytest.raises(ValueError):            # 4 does not divide 6
        FV.field_chain_variant(a[:6], a[:6], 1, "stacked")
    with pytest.raises(ValueError):            # planes want (8, B)
        FV.field_chain_variant(a[:3], a[:3], 1, "planes")
    with pytest.raises(ValueError):
        FV.field_chain_variant(a, a, 1, "relaxed", threads=64)
    with pytest.raises(ValueError):            # K = 8: 128 at most
        FV.field_chain_variant(a, a, 1, "ilp", k=8, threads=256)
    with pytest.raises(ValueError):
        FV.field_chain_variant(a, a, -1, "relaxed")
    with pytest.raises(ValueError):            # clock is CUDA only
        FV.field_chain_variant(a, a, 1, "relaxed",
                               clock=torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError):
        FV.field_chain_variant(a[:, :4].contiguous(), a[:, :4].contiguous(),
                               1, "relaxed")


def test_cuda_variant_table_matches_python():
    """kf2::variant's switch instantiates VARIANTS in their order."""
    src = (Path(FV.__file__).parent / "csrc"
           / "field_chain_variants.cu").read_text()
    cases = re.findall(r"case (\d+): \*k = (\d+); return pick<(\w+), (\d+), "
                       r"(\w+), (\w+)>\(clock\);\s*// (\w+)", src)
    assert len(cases) == len(FV.VARIANTS)
    for (idx, k, lazy, k2, planes, mn, name), v in zip(cases, FV.VARIANTS):
        assert int(idx) == FV.VARIANT_ID[v.name] and name == v.name
        assert int(k) == int(k2) == v.k
        assert (lazy, planes, mn) == tuple(
            str(x).lower() for x in (v.lazy, v.planes, v.min))
        assert v.max_threads == (128 if v.k >= 8 else 512)


def test_bound_matches_least_work_figures():
    """The least-work bound at 132 SMs and 1.98 GHz: 0.0241 ms for
    B = 16,384, n = 192; 0.0120 ms for n = 96; 0.397 ms for B = 270,336."""
    rate = 64 * 132 * 1.98e9
    for lanes, n, want in ((16384, 192, 0.0241), (16384, 96, 0.0120),
                           (270336, 192, 0.397)):
        ms, by = FV.bound_ms(lanes, n, rate, X.HBM_BYTES_PER_S)
        assert by == "operations"
        assert abs(ms - want) / want < 0.005


def test_plan_maps_tiles_to_threads():
    grid = [("ilp", k, tile) for tile, k in proto_ilp.GRID]
    got = X.plan(grid)
    assert got == [("ilp", 1, 128, (128,)), ("ilp", 4, 128, (128,)),
                   ("ilp", 8, 128, (128,)), ("ilp", 4, 256, (256,)),
                   ("ilp", 2, 256, (256,)), ("ilp", 4, 512, (512, 1024, 2048)),
                   ("ilp", 2, 128, ())]
    assert X.plan([("min", None, t) for t in proto_pallas4.TILES]) == [
        ("min", None, 512, proto_pallas4.TILES), ("min", None, 128, ())]


@pytest.mark.parametrize("module", [proto_pallas, proto_pallas2,
                                    proto_pallas4, proto_planes, proto_ilp])
def test_experiment_runs_on_cpu(module):
    """Each counterpart checks every configuration of its script's grid on
    the CPU (the plain versions) and reports no time there."""
    res = module.run(device="cpu", B=64)
    assert res["B"] == 64 and res["n"] == module.NMUL * module.NITER
    assert res["card"] == {"device": "cpu"}
    assert res["configs"]
    for row in res["configs"]:
        assert row["vs_plain"] == "equal on 64 lanes"
        assert row["vs_ints"] == "equal on 64 lanes"
        assert row["ms"] is None and row["sm_cycles_per_mul"] is None


def test_check_chain_raises_on_a_wrong_lane():
    ref = X.reference(64, 3, torch.device("cpu"))
    a, b = X.operands(64, torch.device("cpu"))
    out = F.mul_chain_plain(a, b, 3, "p", r_log2=264)
    X.check_chain(out, ref, "plain")
    bad = out.clone()
    bad[5, 0] = bad[5, 0] ^ 1
    with pytest.raises(RuntimeError):
        X.check_chain(bad, ref, "flipped")


def test_entry_points_need_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        proto_ilp.run()
