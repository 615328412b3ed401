"""KI3's spread layouts (fabric_tpu_torch/ops/csrc/isa_probe.cu: quad,
4 columns of one row a thread, and g2, row_mul's column on 2 lanes) on
the CPU, before and without any build.

A numpy mirror of each spread kernel runs the probe thread by thread,
each model thread with its own registers, from the kernel's own index
map: `quad` (thread t -> row t / cols, columns (t % cols) 4 ..) and `g2`
(warp w, lane 2 q + k -> column 16 w + q, rows 11 k .. 11 k + 10).
Every __shfl_sync of the g2 kernel is an explicit exchange between the
model lanes of one warp (the source's shuffles are parsed and must equal
the model's).  The mirrors are held bit for bit against the port's plain
version (`probe_plain`) and against the JAX reference's bodies, restated
in test_torch_isa_probe.py and jitted on the CPU, for every probe with a
spread layout, ragged B and 0, 1 and 4 passes, on the script's small
values, on full-range int32 with where's edge values and on odd ones.
A shuffle one lane off must make the check fail, and so must a carry
of split (one thread a column at every B) taken after its row's update.  The launch plan
(`isa_probe.probe_plan`) is checked here too, and the per-launch timer:
its refusal without a card, and the launch counts it leaves as it found
them."""
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from fabric_tpu_torch import experiments as X
from fabric_tpu_torch.ops import isa_probe as IP

from test_torch_isa_probe import BODIES

L, REP = IP.L, IP.REP
SRC = (Path(IP.__file__).resolve().parent / "csrc" / "isa_probe.cu").read_text()
SPREAD_LAYOUTS = [(p, lay) for p in IP.PROBES for lay in IP.PROBE_LAYOUTS[p]
                  if lay != "column"]
BS = (1, 31, 1000)
ITERS = (0, 1, 4)


# ---------------------------------------------------------------------------
# inputs and references
# ---------------------------------------------------------------------------

def tile(probe: str, kind: str, B: int) -> np.ndarray:
    """The script's values (small), or full-range int32 with where's
    edge values in row 0, or those made odd (row_mul's products of the
    other two reach 0 within a pass, which hides a wrong factor; odd
    products never do).  The f32 probe takes the script's reals."""
    if probe == "f32":
        return np.random.default_rng(0).random((L, B)).astype(np.float32)
    if kind == "small":
        return np.random.default_rng(0).integers(0, 4096, (L, B)).astype(
            np.int32)
    x = np.random.default_rng(1).integers(-2**31, 2**31, (L, B),
                                          dtype=np.int64).astype(np.int32)
    edge = [2**31 - 1, 2**31 - 40, 100, 101, -5, -2**31]
    x[0, :min(B, 6)] = edge[:min(B, 6)]
    return x | 1 if kind == "odd" else x


def kinds(probe):
    return ("small",) if probe == "f32" else ("small", "full_range", "odd")


@functools.lru_cache(maxsize=None)
def jax_reference(probe: str, kind: str, B: int) -> dict:
    """{passes: the JAX reference body's output} for 0, 1 and 4 passes
    (int32: jitted as the script runs it, a fori_loop of passes; f32 op
    by op, since XLA's simplifier rewrites x * 1.5 - x under jit)."""
    x = tile(probe, kind, B)
    out = {}
    if probe == "f32":
        y = jnp.asarray(x)
        for n in range(max(ITERS) + 1):
            if n in ITERS:
                out[n] = np.asarray(y)
            for _ in range(REP):
                y = y * 1.5 - y
        return out
    body = BODIES[probe]
    run = jax.jit(lambda a, n: lax.fori_loop(0, n, lambda i, v: body(v), a))
    for n in ITERS:
        out[n] = np.asarray(run(jnp.asarray(x), n))
    return out


def bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.int32)


# ---------------------------------------------------------------------------
# the mirrors of the kernels
# ---------------------------------------------------------------------------

def ftz(f: np.ndarray) -> np.ndarray:
    """f32 below 2^-126 in magnitude -> zero of its sign (.ftz)."""
    f = f.astype(np.float32)
    return np.where(np.abs(f) < np.float32(2.0 ** -126), f * np.float32(0),
                    f).astype(np.float32)


def brev(x):
    """__brev: the 32 bits of x (an int or a uint32 array) reversed."""
    if isinstance(x, int):
        return int(f"{x & 0xFFFFFFFF:032b}"[::-1], 2)
    x = x.astype(np.uint32)
    out = np.zeros_like(x)
    for b in range(32):
        out |= ((x >> np.uint32(b)) & np.uint32(1)) << np.uint32(31 - b)
    return out


def step_row(probe: str, v: np.ndarray) -> np.ndarray:
    """One step of a body whose rows never mix, on int32 values."""
    if probe == "mul":
        return ((v.astype(np.uint32) * np.uint32(IP.C_MUL))
                & np.uint32(IP.MASK20)).view(np.int32)
    if probe == "shift_or":     # on the bit reverse y of x
        y = v.view(np.uint32)
        return (((y * np.uint32(2)) & np.uint32(brev(IP.MASK12))) | y).view(
            np.int32)
    f = ftz(v.view(np.float32))                      # f32 on the bits
    m = ftz(f * np.float32(IP.F_FACTOR))             # mul.rn.ftz
    return ftz(m - f).view(np.int32)                 # sub.rn.ftz


def quad_map(B: int):
    """The quad kernel's index map: thread t -> (row, first column), 4
    columns a thread, for t < 22 ceil(B / 4)."""
    cols = -(-B // IP.QUAD_PER)
    t = np.arange(L * cols)
    r = t // cols
    return t, r, (t - r * cols) * IP.QUAD_PER


def quad_model(probe: str, x: np.ndarray, iters: int) -> np.ndarray:
    """isa_probe_quad_kernel<PROBE>, every thread at once: each thread's
    values are its own entries of the arrays."""
    B = x.shape[1]
    xi = bits(x)
    out = np.full_like(xi, 0x5A5A5A5A)
    _, r, j0 = quad_map(B)
    for k in range(IP.QUAD_PER):
        j = j0 + k
        live = j < B
        jj = np.where(live, j, 0)
        if probe in ("rotate", "roll"):
            s = (64 * iters) % L
            src = (r + s) % L if probe == "rotate" else (r + L - s) % L
            out[r[live], j[live]] = xi[src[live], j[live]]
            continue
        v = np.where(live, xi[r, jj], 0).astype(np.int32)
        r0 = np.where(live, xi[0, jj], 0).astype(np.int32)
        if probe == "shift_or":
            v = brev(v.view(np.uint32)).view(np.int32)
        for _ in range(iters):
            if probe == "where":
                # row 0 at the pass's start; 64 selects as their net add
                d = np.where(r0 > IP.THRESHOLD, 0, REP).astype(np.uint32)
                v = (v.view(np.uint32) + d).view(np.int32)
                r0 = (r0.view(np.uint32) + d).view(np.int32)
            else:
                for _ in range(REP):
                    v = step_row(probe, v)
        if probe == "shift_or":
            v = brev(v.view(np.uint32)).view(np.int32)
        out[r[live], j[live]] = v[live]
    return out.view(x.dtype)


def shfl(vals: np.ndarray, src: np.ndarray) -> np.ndarray:
    """__shfl_sync(FULL, v, src): each lane of each warp reads lane src
    mod 32 of its warp (vals: (warps, 32); src: (32,))."""
    return vals[:, src % 32]


# the g2 kernel's shuffles, as the source writes them: (intrinsic, value,
# source lane)
MODEL_SHUFFLES = [("__shfl_sync", "v[0]", "base"),
                  ("__shfl_sync", "v[nidx]", "base + nowner")]


def g2_map(B: int):
    """The g2 kernel's map: (warps, lane q, lane k, column j, live) for
    lane = 2 q + k of warp w, column j = 16 w + q."""
    warps = -(-B // 16)
    lane = np.arange(32)
    q, k = lane // 2, lane % 2
    j = np.arange(warps)[:, None] * 16 + q[None, :]
    return warps, q, k, j, j < B


def g2_model(x: np.ndarray, iters: int, off: int = 0) -> np.ndarray:
    """isa_probe_row_mul_g2_kernel on model warps of 32 lanes, each lane
    with 11 registers; `off` moves every shuffle's source one lane (a
    fault)."""
    R = IP.G2_ROWS
    B = x.shape[1]
    warps, q, k, j, live = g2_map(B)
    base = q * 2
    xi = bits(x)
    rows = k[None, :, None] * R + np.arange(R)[None, None, :]
    jj = np.where(live, j, 0)[:, :, None]
    v = np.where(live[:, :, None], xi[rows % L, jj], 0).astype(np.int32)
    for _ in range(iters):
        # s: row i % 22 at step i's start, from its owner; each step
        # updates the register of row (i + 1) % 22 and sends the owner's
        # before it updates the others
        s = shfl(v[:, :, 0], base + off).view(np.uint32)
        for i in range(REP):
            nrow = (i + 1) % L
            nowner, nidx = nrow // R, nrow % R
            new = ((v.view(np.uint32) * s[:, :, None])
                   & np.uint32(IP.MASK20)).view(np.int32)
            v[:, :, nidx] = new[:, :, nidx]
            if i + 1 < REP:
                sn = shfl(v[:, :, nidx], base + nowner + off)
            rest = np.arange(R) != nidx
            v[:, :, rest] = new[:, :, rest]
            s = sn.view(np.uint32)
    out = np.full_like(xi, 0x5A5A5A5A)
    w_i, l_i = np.nonzero(live)
    for i in range(R):
        out[k[l_i] * R + i, j[w_i, l_i]] = v[w_i, l_i, i]
    return out.view(x.dtype)


def model(probe, x, iters, layout, **fault):
    if layout == "quad":
        return quad_model(probe, x, iters)
    assert (probe, layout) == ("row_mul", "g2")
    return g2_model(x, iters, **fault)


# ---------------------------------------------------------------------------
# the mirrors against probe_plain and the JAX reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", BS)
@pytest.mark.parametrize("probe,layout", SPREAD_LAYOUTS)
def test_layout_model_matches_plain(probe, layout, B):
    for kind in kinds(probe):
        x = tile(probe, kind, B)
        for iters in ITERS:
            want = IP.probe_plain(torch.from_numpy(x.copy()), probe, iters)
            got = model(probe, x, iters, layout)
            assert np.array_equal(bits(got), bits(want.numpy())), (
                kind, iters)


@pytest.mark.parametrize("B", (31, 1000))
@pytest.mark.parametrize("probe,layout", SPREAD_LAYOUTS)
def test_layout_model_matches_jax_reference(probe, layout, B):
    for kind in kinds(probe):
        x = tile(probe, kind, B)
        ref = jax_reference(probe, kind, B)
        for iters in ITERS:
            got = model(probe, x, iters, layout)
            assert np.array_equal(bits(got), bits(ref[iters])), (kind, iters)


def test_g2_model_catches_a_shuffle_one_lane_off():
    x = tile("row_mul", "odd", 100)
    want = IP.probe_plain(torch.from_numpy(x.copy()), "row_mul", 1).numpy()
    assert np.array_equal(model("row_mul", x, 1, "g2"), want)
    assert not np.array_equal(model("row_mul", x, 1, "g2", off=1), want)


def test_g2_kernel_shuffles_are_the_models():
    """The g2 kernel's shuffles, parsed from the source, are the model's;
    the quad kernel has none; the kernel's constants are the wrapper's."""
    body = SRC[SRC.index("isa_probe_row_mul_g2_kernel("):]
    body = body[:body.index("typedef void (*kernel_fn)")]
    found = re.findall(r"(__shfl(?:_up)?_sync)\(FULL, ([^,]+), ([^)]+)\)",
                       body)
    assert found == MODEL_SHUFFLES
    quad = SRC[SRC.index("isa_probe_quad_kernel("):SRC.index(
        "isa_probe_row_mul_g2_kernel(")]
    assert not re.search(r"__shfl\w*\(", quad)
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", SRC))
    assert int(consts["PER"]) == IP.QUAD_PER
    assert L // int(consts["G"]) == IP.G2_ROWS


def column_split_model(x: np.ndarray, iters: int,
                       late_carry: bool = False) -> np.ndarray:
    """split in the column kernel (`body<SPLIT>`), row by row as the
    kernel writes it: every carry c[r] = v[r] >> 12 of a step first, then
    the rows' updates; `late_carry` takes each carry from its row's
    updated value instead (a fault)."""
    v = x.astype(np.int32).copy()
    for _ in range(iters):
        for _ in range(REP // 4):
            c = v >> IP.SHIFT
            for r in range(L):
                if late_carry and r > 0:
                    c[r - 1] = v[r - 1] >> IP.SHIFT
                v[r] = (v[r] & np.int32(IP.MASK12)) + (c[r - 1] if r else 0)
    return v


def test_split_column_body_takes_every_carry_before_an_update():
    """split runs one thread a column at every B: its body takes the
    step's carries from the old values before any row updates (parsed
    from the source), which the model holds against probe_plain; a carry
    taken after its row's update must be caught."""
    body = SRC[SRC.index("PROBE == SPLIT"):SRC.index("PROBE == SHIFT_OR")]
    assert (body.index("c[r] = v[r] >> g.sh")
            < body.index("v[0] &= g.m12")
            < body.index("v[r] = (v[r] & g.m12) + c[r - 1]"))
    x = tile("split", "odd", 100)
    for iters in ITERS:
        want = IP.probe_plain(torch.from_numpy(x.copy()), "split",
                              iters).numpy()
        assert np.array_equal(column_split_model(x, iters), want)
    assert not np.array_equal(column_split_model(x, 1, late_carry=True),
                              IP.probe_plain(torch.from_numpy(x.copy()),
                                             "split", 1).numpy())


# ---------------------------------------------------------------------------
# the index maps and the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", BS + (2, 16384))
@pytest.mark.parametrize("layout", ["quad", "g2"])
def test_index_map_covers_each_element_once(layout, B):
    seen = np.zeros((L, B), dtype=np.int64)
    if layout == "quad":
        t, r, j0 = quad_map(B)
        assert len(t) == IP.layout_threads(layout, B)
        for k in range(IP.QUAD_PER):
            j = j0 + k
            np.add.at(seen, (r[j < B], j[j < B]), 1)
    else:
        R = IP.G2_ROWS
        warps, q, k, j, live = g2_map(B)
        assert 32 * warps == IP.layout_threads(layout, B)
        if B >= 16:      # a full warp: g2 uses every lane
            assert live[0].all()
        w_i, l_i = np.nonzero(live)
        for i in range(R):
            np.add.at(seen, (k[l_i] * R + i, j[w_i, l_i]), 1)
    assert (seen == 1).all()


def test_plan_rule():
    sms = 132
    fill = sms * 2048
    assert fill == 270336
    for probe in IP.PROBES:
        lay, threads, blocks = IP.probe_plan(probe, 16384, sms)
        assert lay == IP.SPREAD[probe]
        assert (lay == "column") == (probe == "split")
        assert threads == IP.layout_threads(lay, 16384)
        assert blocks == -(-threads // IP.BLOCK_THREADS)
        assert IP.probe_plan(probe, fill, sms) == (
            "column", fill, fill // IP.BLOCK_THREADS)
        assert IP.probe_plan(probe, fill - 1, sms)[0] == IP.SPREAD[probe]
        assert IP.PROBE_LAYOUTS[probe] == tuple(dict.fromkeys(
            ("column", IP.SPREAD[probe])))
        for lay in IP.PROBE_LAYOUTS[probe]:
            assert IP.probe_plan(probe, 16384, sms, lay)[0] == lay
            assert IP.probe_plan(probe, fill, sms, lay)[0] == lay
    assert IP.probe_plan("row_mul", 16384, sms, "g2")[1] == 2 * 16384
    assert IP.probe_plan("mul", 16384, sms, "quad")[1] == L * 4096
    assert IP.probe_plan("mul", 16385, sms, "quad")[1] == L * 4097
    for probe, bad in (("row_mul", "quad"), ("mul", "g2"), ("split", "g2"),
                       ("split", "quad"), ("mul", "pair"), ("mul", "nope")):
        with pytest.raises(ValueError):
            IP.probe_plan(probe, 16384, sms, bad)
    with pytest.raises(ValueError):
        IP.probe_plan("nope", 16384, sms)
    x = torch.zeros((L, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        IP.isa_probe(x, "split", layout="g2")
    with pytest.raises(ValueError):
        IP.kernel_symbol("rotate", "g2")
    assert torch.equal(IP.isa_probe(x, "row_mul", layout="g2"),
                       IP.probe_plain(x, "row_mul"))


def test_layout_enum_and_symbols_match_the_source():
    enum = re.search(r"enum \{ (COLUMN[A-Z_, 0-9]+) \};", SRC).group(1)
    names = [n.strip().lower() for n in enum.split(",")][:-1]
    assert names == list(IP.LAYOUTS)
    # every (probe, layout) the plan allows has an instantiation in
    # probe_fn, and its symbol names that kernel
    fn = SRC[SRC.index("kernel_fn probe_fn("):]
    fn = fn[:fn.index("long long layout_threads(")]
    wanted = set()
    for probe in IP.PROBES:
        for lay in IP.PROBE_LAYOUTS[probe]:
            sym = IP.kernel_symbol(probe, lay)
            p = IP.PROBE_ID[probe]
            up = probe.upper()
            if lay == "column":
                assert sym == f"isa_probe_kernelILi{p}E"
                wanted.add(f"isa_probe_kernel<{up}>")
            elif lay == "quad":
                assert sym == f"isa_probe_quad_kernelILi{p}E"
                wanted.add(f"isa_probe_quad_kernel<{up}>")
            else:
                assert sym == "isa_probe_row_mul_g2_kernel"
                wanted.add("isa_probe_row_mul_g2_kernel")
    # and nothing else is instantiated
    found = set(re.findall(r"return (isa_probe_\w+(?:<\w+>)?);", fn))
    assert found == wanted
    assert IP.values_per_thread("column") == L
    assert IP.values_per_thread("quad") == 4
    assert IP.values_per_thread("g2") == 11


def test_launch_ms_raises_without_a_card(monkeypatch):
    """The per-launch timer has no CPU fallback: without a card it
    raises before it calls fn."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        X.launch_ms(lambda: calls.append(1), launches=2, trials=1)
    assert calls == []


def test_launch_ms_leaves_every_launch_count_as_it_found_it(monkeypatch):
    """The per-launch timer's warm-up and captured calls count no launch
    of any wrapper, and it reports a replay's ms over its launches; the
    card's graph and events are stood in for on the CPU."""
    import contextlib

    class Graph:
        def replay(self):
            pass

    class Event:
        def __init__(self, enable_timing=False):
            pass

        def record(self):
            pass

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return 2.0

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(IP.isa_probe, "launches", 5)
    calls = []

    def fn():
        calls.append(1)
        IP.isa_probe.launches += 1

    assert X.launch_ms(fn, launches=4, trials=3) == 0.5
    assert len(calls) == 5                 # one warm-up, four captured
    assert IP.isa_probe.launches == 5

    def fails():
        IP.isa_probe.launches += 1
        raise RuntimeError("launch failed")

    with pytest.raises(RuntimeError, match="launch failed"):
        X.launch_ms(fails, launches=2, trials=1)
    assert IP.isa_probe.launches == 5
