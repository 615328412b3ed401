"""The port's plain K8 (fabric_tpu_torch.ops.bn254, the plain version of
kernel KB8) against the reference's fabric_tpu.ops.bn254_batch, run
eagerly as tests/test_bn254_batch.py runs it, and against the host
arithmetic of fabric_tpu.idemix.bn254: the tower operations, 6-step
single and dual Miller-loop prefixes, the line constants carried across
(`from_jax_packed`), the split final exponentiation against the host's
split and against the square-and-multiply by (p^12 - 1)/r, and the full
plain pairing check on red and green checks.  KB8's least-work tower
(Fp2 squares, Karatsuba and complex squaring over Fp6, Granger-Scott
cyclotomic squares, the lines multiplied together first) op by op
against the reference's products and squares and the host's, and the
tower probe's plain version op by op against the host.  Tolerance:
exact equality everywhere (field values are compared as canonical
integers)."""
import random

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)

from fabric_tpu.idemix import bn254 as hb
from fabric_tpu.ops import bignum as bn
from fabric_tpu.ops import bn254_batch as bb
from fabric_tpu_torch.ops import bn254 as K
from fabric_tpu_torch.ops import field as F

P = hb.P
B = 2


def rand2(rng):
    return (rng.randrange(P), rng.randrange(P))


def rand12(rng):
    return tuple(rand2(rng) for _ in range(6))


# -- the port's layout ---------------------------------------------------------

def port_f2(vals):
    """[Fp2 tuples] -> (16, 2, B) Montgomery limbs."""
    t = torch.tensor([[F.int_to_limbs(K.mont(c)) for c in v] for v in vals],
                     dtype=torch.int64)
    return t.permute(2, 1, 0).contiguous()


def port_fp(vals):
    return F.ints_to_limbs([K.mont(v) for v in vals])


def f2_ints(t):
    """(16, 2, B) Montgomery limbs -> [Fp2 tuples]."""
    c0, c1 = (F.limbs_to_ints(K.fp.from_mont(t[:, c])) for c in (0, 1))
    return list(zip(c0, c1))


# -- the reference's layout ----------------------------------------------------

def ref_fp(vals):
    return np.asarray(bn.ints_to_limbs([v * bb.fpb.R % P for v in vals]),
                      np.int32)


def ref_f2(vals):
    return (ref_fp([v[0] for v in vals]), ref_fp([v[1] for v in vals]))


def ref_ints(a):
    """Reference lazy Montgomery limbs -> canonical ints per lane."""
    rinv = pow(bb.fpb.R, -1, P)
    red = np.asarray(bb.fpb.canon(bb.fpb.reduce_to_kp(a, 64, 2)))
    return [bn.limbs_to_int(red[:, b]) % P * rinv % P
            for b in range(red.shape[1])]


def ref_f2_ints(a):
    return list(zip(ref_ints(a[0]), ref_ints(a[1])))


def ref_f12_ints(f):
    cols = [ref_f2_ints(c) for c in f]
    return [tuple(col[b] for col in cols) for b in range(len(cols[0]))]


def host_replica(steps, pts):
    """The Miller loop over `steps` with host arithmetic, per point (for
    a dual loop: steps of aligned pairs and pairs of points)."""
    out = []
    for p in pts:
        f = hb.F12_ONE
        for st in steps:
            if st[0][0]:
                f = hb.f12_sqr(f)
            for (_, A, Bc), pt in zip(st, p):
                f = hb.f12_mul(f, hb._sparse013(pt[1], A, pt[0], Bc))
        out.append(f)
    return out


def test_tower_ops_match_reference_and_host():
    rng = random.Random(4)
    a2 = [rand2(rng) for _ in range(B)]
    b2 = [rand2(rng) for _ in range(B)]
    got = f2_ints(K.f2_mul(port_f2(a2), port_f2(b2)))
    assert got == [hb.f2_mul(x, y) for x, y in zip(a2, b2)]
    assert got == ref_f2_ints(bb.f2_mul(ref_f2(a2), ref_f2(b2)))
    got = f2_ints(K.f2_mul_xi(port_f2(a2)))
    assert got == [hb.f2_mul(x, hb.XI) for x in a2]
    assert got == ref_f2_ints(bb.f2_mul_xi(ref_f2(a2), 2))

    a12 = [rand12(rng) for _ in range(B)]
    b12 = [rand12(rng) for _ in range(B)]
    pa, pb = K.f12_from_ints(a12), K.f12_from_ints(b12)
    ra = tuple(ref_f2([v[k] for v in a12]) for k in range(6))
    rb = tuple(ref_f2([v[k] for v in b12]) for k in range(6))
    got = K.f12_to_ints(K.f12_mul_karatsuba(pa, pb))
    assert got == [hb.f12_mul(x, y) for x, y in zip(a12, b12)]
    assert got == ref_f12_ints(bb.f12_mul(ra, rb))
    got = K.f12_to_ints(K.f12_sqr_complex(pa))
    assert got == [hb.f12_sqr(x) for x in a12]
    assert got == ref_f12_ints(bb.f12_sqr(ra))

    # one sparse line into f against the dense host product of the same
    # element and the reference's sparse product
    y = [rng.randrange(P) for _ in range(B)]
    l1 = [rand2(rng) for _ in range(B)]
    l3 = [rand2(rng) for _ in range(B)]
    got = K.f12_to_ints(K.f12_mul_by_lines(pa, K._line_f12(
        port_fp(y), port_f2(l1), port_f2(l3))))
    dense = [((y[b], 0), l1[b], (0, 0), l3[b], (0, 0), (0, 0))
             for b in range(B)]
    assert got == [hb.f12_mul(x, d) for x, d in zip(a12, dense)]
    assert got == ref_f12_ints(bb.f12_mul_sparse013(
        ra, ref_fp(y), ref_f2(l1), ref_f2(l3)))

    # the pieces of the split final exponentiation the reference lacks
    assert K.f12_to_ints(K.f12_conj(pa)) == [hb.f12_conj(x) for x in a12]
    for power in (1, 2, 3):
        assert K.f12_to_ints(K.f12_frobenius(pa, power)) == [
            hb.f12_frobenius(x, power) for x in a12]
    assert K.f12_to_ints(K.f12_inv(pa)) == [hb.f12_inv(x) for x in a12]
    assert K.f12_to_ints(K.f12_inv(K.f12_from_ints([hb.F12_ONE]))) == \
        [hb.F12_ONE]


def host_easy(f):
    """The easy part of the final exponentiation on host ints: its
    result lies in the cyclotomic subgroup."""
    m = hb.f12_mul(hb.f12_conj(f), hb.f12_inv(f))
    return hb.f12_mul(hb.f12_frobenius(m, 2), m)


def sparse_host(y, a, b):
    return ((y, 0), a, (0, 0), b, (0, 0), (0, 0))


LEAST_WORK_OPS = ["f2_sqr", "f12_cyc_sqr", "lines_product",
                  "f12_mul_by_lines"]


@pytest.mark.parametrize("op", LEAST_WORK_OPS)
def test_least_work_tower_matches_reference_and_host(op):
    """The formulas of KB8's least-work tower that the test above does
    not take, against the host's ints and the reference's (eager)
    product or square of the same values; f12_cyc_sqr on inputs made
    cyclotomic by the easy part."""
    rng = random.Random(40 + LEAST_WORK_OPS.index(op))
    if op == "f2_sqr":
        a2 = [rand2(rng) for _ in range(B)]
        got = f2_ints(K.f2_sqr(port_f2(a2)))
        assert got == [hb.f2_sqr(x) for x in a2]
        assert got == ref_f2_ints(bb.f2_mul(ref_f2(a2), ref_f2(a2)))
        return
    a12 = [rand12(rng) for _ in range(B)]
    if op == "f12_cyc_sqr":
        pa = K.final_exp_easy(K.f12_from_ints(a12))
        a12 = [host_easy(x) for x in a12]
        assert K.f12_to_ints(pa) == a12
    else:
        pa = K.f12_from_ints(a12)
    ra = tuple(ref_f2([v[k] for v in a12]) for k in range(6))
    if op == "f12_cyc_sqr":
        got = K.f12_to_ints(K.f12_cyc_sqr(pa))
        want = [hb.f12_sqr(x) for x in a12]
        ref = bb.f12_sqr(ra)
    else:
        ys = [[rng.randrange(P) for _ in range(B)] for _ in range(2)]
        ab = [[rand2(rng) for _ in range(B)] for _ in range(4)]
        lines = K.lines_product(port_fp(ys[0]), port_f2(ab[0]),
                                port_f2(ab[1]), port_fp(ys[1]),
                                port_f2(ab[2]), port_f2(ab[3]))
        l1, l2 = ([sparse_host(ys[j][i], ab[2 * j][i], ab[2 * j + 1][i])
                   for i in range(B)] for j in (0, 1))
        if op == "lines_product":
            got = K.f12_to_ints(lines)
            assert all(v[5] == (0, 0) for v in got)
            want = [hb.f12_mul(x, y) for x, y in zip(l1, l2)]
            ra = tuple(ref_f2([v[k] for v in l1]) for k in range(6))
            ref = bb.f12_mul_sparse013(ra, ref_fp(ys[1]), ref_f2(ab[2]),
                                       ref_f2(ab[3]))
        else:
            got = K.f12_to_ints(K.f12_mul_by_lines(pa, lines))
            want = [hb.f12_mul(hb.f12_mul(x, y), z)
                    for x, y, z in zip(a12, l1, l2)]
            ref = bb.f12_mul_sparse013(
                bb.f12_mul_sparse013(ra, ref_fp(ys[0]), ref_f2(ab[0]),
                                     ref_f2(ab[1])),
                ref_fp(ys[1]), ref_f2(ab[2]), ref_f2(ab[3]))
    assert got == want
    assert got == ref_f12_ints(ref)


def test_cyc_sqr_is_wrong_outside_the_cyclotomic_subgroup():
    """Granger-Scott's square holds only in the cyclotomic subgroup, so
    the cyclotomic test above can tell it from a plain square."""
    rng = random.Random(47)
    a12 = [rand12(rng) for _ in range(B)]
    got = K.f12_to_ints(K.f12_cyc_sqr(K.f12_from_ints(a12)))
    assert all(g != hb.f12_sqr(x) for g, x in zip(got, a12))
    assert K.f12_to_ints(K.f12_sqr_complex(K.f12_from_ints(a12))) == [
        hb.f12_sqr(x) for x in a12]


def host_probe(op, a, b):
    """The host's value of a tower probe op on one input (pair)."""
    if op == "mul":
        return hb.f12_mul(a, b)
    if op in ("sqr", "cyc_sqr"):
        return hb.f12_sqr(a)
    if op == "mul_by_lines":
        l1 = sparse_host(b[0][0], b[1], b[3])
        l2 = sparse_host(b[0][1], b[2], b[4])
        return hb.f12_mul(hb.f12_mul(a, l1), l2)
    if op == "pow_u":
        return hb._pow_u(a)
    return hb._final_exp(a)


@pytest.mark.parametrize("op", K.PROBE_OPS)
def test_tower_probe_plain_matches_host(op):
    """The probe's wrapper on CPU words takes its plain version (no
    launch) and gives the host's value of each op; the cyclotomic ops
    (cyc_sqr, pow_u) on inputs made cyclotomic by the easy part."""
    rng = random.Random(60 + K.PROBE_OPS.index(op))
    a12 = [rand12(rng) for _ in range(B)]
    if op in ("cyc_sqr", "pow_u"):
        a12 = [host_easy(x) for x in a12]
    b12 = [rand12(rng) for _ in range(B)] if op in K.BINARY_OPS else None
    words = [None if v is None else K.f12_to_words(K.f12_from_ints(v))
             for v in (a12, b12)]
    assert words[0].shape == (6, 2, 8, B) and words[0].dtype == torch.uint32
    before = K.bn254_tower_probe.launches
    got = K.bn254_tower_probe(op, *words)
    assert K.bn254_tower_probe.launches == before
    assert K.f12_to_ints(K.words_to_f12(got)) == [
        host_probe(op, a, None if b12 is None else b12[i])
        for i, a in enumerate(a12)]


def test_tower_probe_rejects_what_the_kernel_does_not_take():
    w = K.f12_to_words(K.f12_one(3))
    with pytest.raises(ValueError, match="unknown tower op"):
        K.bn254_tower_probe("div", w)
    with pytest.raises(ValueError, match="takes 2 input"):
        K.bn254_tower_probe("mul", w)
    with pytest.raises(ValueError, match="takes 1 input"):
        K.bn254_tower_probe("sqr", w, w)
    with pytest.raises(ValueError, match="a must be"):
        K.bn254_tower_probe("sqr", w.to(torch.int64))
    with pytest.raises(ValueError, match="b must be"):
        K.bn254_tower_probe("mul", w, w[..., :2].contiguous())


def test_miller_prefix_matches_reference_and_host():
    """First 6 ate steps: the port, the reference's eager loop and a
    host replica agree."""
    rng = random.Random(9)
    steps = hb.ate_precompute(hb.G2_GEN)
    pk = K.pack_steps(steps)
    pts = [hb.g1_mul(rng.randrange(2, hb.R), hb.G1_GEN) for _ in range(B)]
    L = K.lines_to_limbs(torch.from_numpy(pk["lines"])[None])[:, 0]
    xm = port_fp([p[0] for p in pts])
    ym = port_fp([p[1] for p in pts])
    got = K.f12_to_ints(K.miller_loop(pk["flags"], L.unsqueeze(-1), xm, ym,
                                      n_steps=6))
    assert got == host_replica([(s,) for s in steps[:6]],
                               [(p,) for p in pts])
    ref = bb.miller_loop(bb.pack_steps(steps[:6]),
                         np.asarray(bn.ints_to_limbs([p[0] for p in pts]),
                                    np.int32),
                         np.asarray(bn.ints_to_limbs([p[1] for p in pts]),
                                    np.int32), eager=True)
    assert got == ref_f12_ints(ref)


def test_miller_dual_prefix_matches_reference_and_host():
    """The dual loop's prefix with per-lane issuer slots: lane b pairs
    P1 with its own issuer's w (slots 1 and 2) and P2 with g2."""
    rng = random.Random(21)
    ws = [hb.g2_mul(rng.randrange(2, hb.R), hb.G2_GEN) for _ in range(B)]
    s_g2 = hb.ate_precompute(hb.G2_GEN)
    s_w = [hb.ate_precompute(w) for w in ws]
    flags, lines = K.stack_lines([K.pack_steps(s) for s in [s_g2] + s_w])
    L = K.lines_to_limbs(torch.from_numpy(lines))
    slot = torch.tensor([1, 2], dtype=torch.int32)
    p1 = [hb.g1_mul(rng.randrange(2, hb.R), hb.G1_GEN) for _ in range(B)]
    p2 = [hb.g1_mul(rng.randrange(2, hb.R), hb.G1_GEN) for _ in range(B)]
    ms = [port_fp([p[c] for p in pts]) for pts in (p1, p2) for c in (0, 1)]
    got = K.f12_to_ints(K.miller_loop_dual(
        flags, K._lane_lines(L, slot), L[:, 0].unsqueeze(-1), *ms,
        n_steps=6))
    for b in range(B):
        assert got[b] == host_replica(
            list(zip(s_w[b][:6], s_g2[:6])), [(p1[b], p2[b])])[0]
    # the reference's dual loop takes one w per call: lane 0's
    limbs = [np.asarray(bn.ints_to_limbs([p[c] for p in pts]), np.int32)
             for pts in (p1, p2) for c in (0, 1)]
    ref = bb.miller_loop_dual(bb.pack_steps(s_w[0][:6]),
                              bb.pack_steps(s_g2[:6]), *limbs, eager=True)
    assert got[0] == ref_f12_ints(ref)[0]


def test_lines_carried_across_from_the_reference():
    rng = random.Random(3)
    for q in (hb.G2_GEN, hb.g2_mul(rng.randrange(2, hb.R), hb.G2_GEN)):
        steps = hb.ate_precompute(q)
        mine = K.pack_steps(steps)
        carried = K.from_jax_packed(bb.pack_steps(steps))
        assert np.array_equal(carried["flags"], mine["flags"])
        assert np.array_equal(carried["lines"], mine["lines"])
        assert mine["lines"].shape == (len(steps), 2, 2, 8)
        assert mine["flags"].sum() == 126 and len(steps) == 137
    bad = dict(mine, flags=mine["flags"].copy())
    bad["flags"][0] ^= 1
    with pytest.raises(ValueError, match="unaligned"):
        K.stack_lines([mine, bad])


def test_final_exp_matches_host_split_and_square_and_multiply():
    rng = random.Random(12)
    fs = [rand12(rng) for _ in range(B)]
    got = K.f12_to_ints(K.final_exp(K.f12_from_ints(fs)))
    assert got == [hb._final_exp(f) for f in fs]
    assert got == [hb.f12_pow_raw(f, (P ** 12 - 1) // hb.R) for f in fs]


@pytest.fixture(scope="module")
def checks():
    """Four checks under two issuers (slots 1 and 2): two valid (the
    first with x1 + p, a coordinate in [p, 2^256)), one naming the other
    issuer's slot, one whose Abar was made with x + 1."""
    rng = random.Random(31)
    xs = [rng.randrange(2, hb.R) for _ in range(2)]
    s_g2 = hb.ate_precompute(hb.G2_GEN)
    s_w = [hb.ate_precompute(hb.g2_mul(x, hb.G2_GEN)) for x in xs]
    flags, lines = K.stack_lines([K.pack_steps(s) for s in [s_g2] + s_w])
    rows, slots, labels = [], [], []
    for i, (j, s, bump) in enumerate([(0, 1, 0), (1, 2, 0), (0, 2, 0),
                                      (1, 2, 1)]):
        a = hb.g1_mul(rng.randrange(2, hb.R), hb.G1_GEN)
        abar = hb.g1_mul(xs[j] + bump, a)
        p2 = hb.g1_neg(abar)
        rows.append((a, p2))
        slots.append(s)
        labels.append(s == j + 1 and not bump)
    assert rows[0][0][0] + P < 1 << 256
    host = [hb.f12_mul(hb.ate_pairing_lines(p1, s_w[s - 1]),
                       hb.ate_pairing_lines(p2, s_g2)) == hb.F12_ONE
            for (p1, p2), s in zip(rows, slots)]
    cols = [[p[0][0] for p in rows], [p[0][1] for p in rows],
            [p[1][0] for p in rows], [p[1][1] for p in rows]]
    cols[0][0] += P
    return flags, lines, slots, cols, labels, host


def test_pairing_check_batch_red_green(checks):
    flags, lines, slots, cols, labels, host = checks
    assert host == labels == [True, True, False, False]
    before = K.bn254_pairing_check.launches
    got = K.bn254_pairing_check(
        torch.from_numpy(flags), torch.from_numpy(lines),
        torch.tensor(slots, dtype=torch.int32),
        *[torch.from_numpy(K.ints_to_words(c)) for c in cols])
    assert got.dtype == torch.bool and got.tolist() == labels
    assert K.bn254_pairing_check.launches == before   # CPU: plain, no launch


def test_pairing_batch_matches_ate_pairing_lines():
    rng = random.Random(17)
    steps = hb.ate_precompute(hb.g2_mul(rng.randrange(2, hb.R), hb.G2_GEN))
    pk = K.pack_steps(steps)
    pts = [hb.g1_mul(rng.randrange(2, hb.R), hb.G1_GEN) for _ in range(B)]
    got = K.pairing_batch(pk["flags"], torch.from_numpy(pk["lines"]),
                          torch.from_numpy(K.ints_to_words(
                              [p[0] for p in pts])),
                          torch.from_numpy(K.ints_to_words(
                              [p[1] for p in pts])))
    assert got == [hb.ate_pairing_lines(p, steps) for p in pts]


def test_wrapper_rejects_what_the_kernel_does_not_take(checks):
    flags, lines, slots, cols, _, _ = checks
    fl, ln = torch.from_numpy(flags), torch.from_numpy(lines)
    sl = torch.tensor(slots, dtype=torch.int32)
    w = [torch.from_numpy(K.ints_to_words(c)) for c in cols]
    call = K.bn254_pairing_check
    with pytest.raises(ValueError, match="slot out of range"):
        call(fl, ln, torch.tensor([0, 1, 2, 3], dtype=torch.int32), *w)
    with pytest.raises(ValueError, match="slot must be"):
        call(fl, ln, sl.to(torch.int64), *w)
    with pytest.raises(ValueError, match="lines must"):
        call(fl, ln[:, :, 0], sl, *w)
    with pytest.raises(ValueError, match="flags must"):
        call(fl[:-1], ln, sl, *w)
    with pytest.raises(ValueError, match="x1 must"):
        call(fl, ln, sl, w[0].to(torch.int64), *w[1:])
    with pytest.raises(ValueError, match="y2 must"):
        call(fl, ln, sl, *w[:3], w[3][:, :2])


def test_work_count():
    """fp_ops_per_check counts the least Fp multiplies of a check: the
    first Miller step only its two lines (22), each later step both
    lines into f (73) and a complex square (36) when flagged; then the
    split final exponentiation with compressed cyclotomic squares (12)
    in the |u|-powers and the Fp inverse batched over a launch; 18,068
    in all.  fp_ops_issued counts what KB8 issues: the same but for
    Granger-Scott's cyclotomic squares (18) and each thread's own tower
    inversion and Fermat chain, ~19,500 (50,650 on the schoolbook tower
    it replaced)."""
    flags = K.pack_steps(hb.ate_precompute(hb.G2_GEN))["flags"]
    assert (len(flags), int(flags[0]), int(flags.sum())) == (137, 1, 126)
    ops = K.fp_ops_per_check(flags)
    miller = 22 + 125 * 36 + 136 * 73
    pow_u = 62 * 12 + 2 * 54
    f12_inv = 2 * 12 + (3 * 2 + 9 * 3 + 4) + 2 * 18
    easy = f12_inv + 3 + 2 * 54 + 10
    hard = 3 * pow_u + 4 * 14 + 2 * 10 + 14 + 13 * 54 + 4 * 12
    assert ops == {("bn254", "mul"): 4 + miller + easy + hard}
    assert sum(ops.values()) == 18_068
    assert K.imads_per_check(flags) == 264 * ops[("bn254", "mul")]
    chain = (bin(P - 2)[3:].count("1"), (P - 2).bit_length() - 1)
    assert K.imads_per_launch() == 264 * chain[0] + 208 * chain[1]
    # what KB8 issues: Granger-Scott squares (9 Fp2 squares) in the
    # |u|-powers and the hard part; the inversion as 4 Fp6 products, 12
    # Fp2 products, 4 and its own Fermat chain
    issued = (4 + miller
              + (4 * 18 + 12 * 3 + 4 + sum(chain)) + 2 * 54 + 10
              + 3 * (62 * 18 + 2 * 54) + 4 * 14 + 2 * 10 + 14 + 13 * 54
              + 4 * 18)
    assert K.fp_ops_issued(flags) == issued == 19_514
    assert sum(ops.values()) <= K.fp_ops_issued(flags) <= 20_000
    assert K.PROBE_FP_OPS["final_exp"][1] == issued - 4 - miller
