"""KP2's field probe (`p256_field_probe_plan_launch` in
fabric_tpu_torch/ops/csrc/p256_verify.cu, wrapper `ops/p256.py`
`p256_field_probe`) on the CPU, before and without any build.

The launch plan (`p256.field_probe_plan`) is held to the kernel's own
index map: a Python mirror of it (blocks of the kernel's PROBE_THREADS,
a warp a tile of 32 lanes) must reach every lane exactly once, within
CUDA's launch limits.  A thread-by-thread mirror of the kernel's memory side
(16-byte chunks t and t + 32 of a tile, the padded shared-memory tile,
each lane's two chunks back out, the result out the same way), with the
tile's constants and slot function read from the source, runs on small
ragged n against Python ints; the slot function keeps a quarter-warp's
16-byte accesses on distinct bank groups."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fabric_tpu_torch.ops import field as F
from fabric_tpu_torch.ops import p256

SRC = (Path(F.__file__).resolve().parent / "csrc" / "p256_verify.cu") \
    .read_text()
R = 1 << 256
NS = [1, 31, 32, 33, 127, 129, 4_097, 65_536, 65_537, 270_336]
GRID_MAX = (1 << 31) - 1
SMEM_STATIC = 48 * 1024              # dynamic shared memory without opt-in


def _consts() -> dict:
    out = {}
    for name, expr in re.findall(r"constexpr int (PROBE_\w+) = ([^;]+);",
                                 SRC):
        for k, v in out.items():
            expr = expr.replace(k, str(v))
        out[name] = eval(expr.replace("/", "//"), {})
    return out


CONSTS = _consts()
THREADS = CONSTS["PROBE_THREADS"]
TILE_CHUNKS = CONSTS["PROBE_TILE_CHUNKS"]
PADDED = CONSTS["PROBE_PADDED"]
_SLOT = re.search(r"int probe_slot\(int c\) \{ return ([^;]+); \}",
                  SRC).group(1)


def slot(c: int) -> int:
    return eval(_SLOT, {"c": c})


def tiles_of(n, blocks) -> np.ndarray:
    """How often the kernel visits each tile of n lanes: warp w of the
    grid takes tile w, one lane a thread; warps past the last tile
    return."""
    seen = np.zeros(-(-n // 32), np.int64)
    for w in range(min(blocks * THREADS // 32, len(seen))):
        seen[w] += 1
    return seen


def smem_bytes(op: str) -> int:
    """Shared memory of a block: a tile of each operand a warp."""
    return (THREADS // 32) * (1 if op == "sqr_p" else 2) * PADDED * 16


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

def test_source_constants_and_instantiations():
    """The tile is 32 lanes of two 16-byte chunks, padded by one chunk in
    8; one kernel an op (`p256_field_probe_kernel<0..3>`, in op order)
    in blocks of PROBE_THREADS, the wrapper's block size; the C entry
    refuses a grid that does not cover every tile."""
    assert TILE_CHUNKS == 2 * p256.PROBE_TILE
    assert PADDED == TILE_CHUNKS + TILE_CHUNKS // 8
    assert THREADS == p256.FIELD_PROBE_THREADS
    assert re.findall(r"&p256_field_probe_kernel<(\d+)>", SRC) \
        == [str(k) for k in range(len(p256.FIELD_PROBE_OPS))]
    assert re.search(r"__launch_bounds__\(PROBE_THREADS\)\s*\n\s*"
                     r"p256_field_probe_kernel", SRC)
    assert "blocks * (PROBE_THREADS / 32) < (n + 31LL) / 32" in SRC


@pytest.mark.parametrize("n", NS)
def test_plan_covers_every_lane_once(n):
    blocks = p256.field_probe_plan(n)
    seen = tiles_of(n, blocks)
    assert len(seen) * 32 >= n > (len(seen) - 1) * 32
    assert (seen == 1).all(), np.flatnonzero(seen != 1)[:5]
    # the C entry's own check: the grid's warps cover every tile
    assert blocks * (THREADS // 32) >= -(-n // 32)
    # and no block is wholly past the last lane
    assert (blocks - 1) * THREADS < n


@pytest.mark.parametrize("n", NS + [(1 << 31) - 1])
def test_plan_within_cuda_limits(n):
    assert THREADS % 32 == 0 and 32 <= THREADS <= 1024
    assert 1 <= p256.field_probe_plan(n) <= GRID_MAX
    for op in p256.FIELD_PROBE_OPS:
        assert smem_bytes(op) <= SMEM_STATIC


def test_plan_of_no_lanes_has_no_blocks():
    assert p256.field_probe_plan(0) == 0
    assert not tiles_of(0, 0).size


def test_plan_rejects_bad_arguments():
    with pytest.raises(ValueError):
        p256.field_probe_plan(-1)


@pytest.mark.parametrize("op", p256.FIELD_PROBE_OPS)
def test_wrapper_no_lanes_no_launch(op):
    a = torch.empty((0, 8), dtype=torch.uint32)
    b = None if op == "sqr_p" else torch.empty((0, 8), dtype=torch.uint32)
    before = p256.p256_field_probe.launches
    out = p256.p256_field_probe(op, a, b)
    assert out.shape == (0, 8) and out.dtype == torch.uint32
    assert p256.p256_field_probe.launches == before


# ---------------------------------------------------------------------------
# The kernel's memory side, thread by thread
# ---------------------------------------------------------------------------

def test_slot_keeps_quarter_warps_on_distinct_bank_groups():
    """A 16-byte shared access is served a quarter-warp (8 threads) at a
    time; 8 chunks of 16 bytes cover the 32 banks once when their slots
    differ mod 8.  Stores: chunks t and t + 32; loads: 2t and 2t + 1."""
    assert len({slot(c) for c in range(TILE_CHUNKS)}) == TILE_CHUNKS
    assert max(slot(c) for c in range(TILE_CHUNKS)) < PADDED
    for q in range(4):
        ts = range(8 * q, 8 * q + 8)
        for pattern in (lambda t: t, lambda t: t + 32, lambda t: 2 * t,
                        lambda t: 2 * t + 1):
            assert len({slot(pattern(t)) % 8 for t in ts}) == 8


def kernel_model(op, va, vb, blocks):
    """The kernel, thread by thread, for one launch on lanes va (and vb)
    -> out as ints; fails on a chunk stored twice or never."""
    n = len(va)
    ops = 1 if op == "sqr_p" else 2
    m = p256.field_probe_modulus(op)
    rinv = pow(R, -1, m)

    def chunks(vals):
        w = F.ints_to_words_le(vals).numpy().reshape(-1, 4)
        return [tuple(int(x) for x in row) for row in w]
    A = chunks(va)
    B = chunks(vb) if ops == 2 else None
    out = [None] * (2 * n)
    for tile in range(blocks * THREADS // 32):       # a warp a tile
        if tile * 32 >= n:
            continue
        shared = [None] * (ops * PADDED)
        for h in range(2):
            for t in range(32):
                c = tile * TILE_CHUNKS + h * 32 + t
                if c < 2 * n:
                    shared[slot(h * 32 + t)] = A[c]
                    if ops == 2:
                        shared[PADDED + slot(h * 32 + t)] = B[c]
        for t in range(32):
            if tile * 32 + t >= n:
                continue

            def lane(off):
                lo = shared[off + slot(2 * t)]
                hi = shared[off + slot(2 * t + 1)]
                return sum(x << (32 * j) for j, x in enumerate(lo + hi))
            x = lane(0)
            y = x if ops == 1 else lane(PADDED)
            r = x * y * rinv % m
            words = [(r >> (32 * j)) & 0xFFFFFFFF for j in range(8)]
            shared[slot(2 * t)] = tuple(words[:4])
            shared[slot(2 * t + 1)] = tuple(words[4:])
        for h in range(2):
            for t in range(32):
                c = tile * TILE_CHUNKS + h * 32 + t
                if c < 2 * n:
                    assert out[c] is None, "a chunk stored twice"
                    out[c] = shared[slot(h * 32 + t)]
    assert None not in out, "a chunk never stored"
    return [sum(x << (32 * j) for j, x in enumerate(out[2 * i]
                                                    + out[2 * i + 1]))
            for i in range(n)]


@pytest.mark.parametrize("n", [1, 31, 33, 65, 129])
@pytest.mark.parametrize("op", p256.FIELD_PROBE_OPS)
def test_kernel_model_matches_ints_and_plain(op, n):
    """The plan's grid, against ints and the wrapper's CPU path."""
    rng = np.random.default_rng(n + 7 * p256.FIELD_PROBE_OPS.index(op))
    m = p256.field_probe_modulus(op)
    ea, eb = p256.field_probe_edges(op)

    def draw(bound):
        return int.from_bytes(rng.bytes(32), "big") % bound
    va = (ea + [draw(m if op == "sqr_p" else R) for _ in range(n)])[:n]
    vb = va if op == "sqr_p" else (eb + [draw(m) for _ in range(n)])[:n]
    want = [x * y * pow(R, -1, m) % m for x, y in zip(va, vb)]
    plain = p256.p256_field_probe(
        op, F.ints_to_words_le(va),
        None if op == "sqr_p" else F.ints_to_words_le(vb))
    assert F.words_le_to_ints(plain) == want
    assert kernel_model(op, va, vb, p256.field_probe_plan(n)) == want
