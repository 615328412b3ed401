"""KI3 (fabric_tpu_torch.ops.isa_probe): each probe's plain version bit
for bit against a jnp restatement of its reference body in
experiments/proto_pallas3.py (the script runs its benchmarks at import,
so it cannot be imported), on the script's (22, 128) tiles:
`default_rng(0).integers(0, 4096)` and, for the int32 bodies, full-range
int32 values too (the bodies wrap by design).

The int32 bodies run as the script runs them, jitted inside a
`lax.fori_loop` of passes; pltpu.roll is the script's own call (off the
TPU it lowers to jnp.roll).  The f32 body runs op by op: under jit XLA's
algebraic simplifier rewrites x * 1.5 - x, where the reference's kernel
rounds each operation.  XLA, like the TPU, flushes f32 subnormals, and
so does the port's probe."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental.pallas import tpu as pltpu

from fabric_tpu_torch.experiments import proto_pallas3
from fabric_tpu_torch.ops import isa_probe as IP

L, REP, LB, MASK = 22, 64, 12, 4095


# the script's bodies (proto_pallas3.py:53-101, :104-108), restated
def _chain_mul(x):
    for _ in range(REP):
        x = (x * 3) & 0xFFFFF
    return x


def _row_mul(x):
    for i in range(REP):
        x = x * x[i % L] & 0xFFFFF
    return x


def _concat_shift(x):
    for _ in range(REP):
        x = jnp.concatenate([x[1:], x[:1]], axis=0)
    return x


def _roll(x):
    for _ in range(REP):
        x = pltpu.roll(x, 1, 0)
    return x


def _where(x):
    m = x[0] > 100
    for _ in range(REP):
        x = jnp.where(m[None, :], x, x + 1)
    return x


def _split(x):
    for _ in range(REP // 4):
        c = x >> LB
        x = (x & MASK) + jnp.concatenate([jnp.zeros_like(c[:1]), c[:-1]],
                                         axis=0)
    return x


def _shmask(x):
    for _ in range(REP):
        x = (x >> 1) & MASK | x
    return x


BODIES = {"mul": _chain_mul, "row_mul": _row_mul, "rotate": _concat_shift,
          "roll": _roll, "where": _where, "split": _split,
          "shift_or": _shmask}
INT_PROBES = [p for p in IP.PROBES if p != "f32"]


def reference(probe, x, iters):
    if probe == "f32":
        y = jnp.asarray(x)
        for _ in range(iters * REP):
            y = y * 1.5 - y
        return np.asarray(y)
    body = BODIES[probe]
    run = jax.jit(lambda a: lax.fori_loop(0, iters, lambda i, v: body(v), a))
    return np.asarray(run(jnp.asarray(x)))


def script_tile(kind="small"):
    if kind == "small":
        return np.random.default_rng(0).integers(0, 4096, (L, 128)).astype(
            np.int32)
    x = np.random.default_rng(1).integers(-2**31, 2**31, (L, 128),
                                          dtype=np.int64).astype(np.int32)
    x[0, :6] = [2**31 - 1, 2**31 - 40, 100, 101, -5, -2**31]  # where's edge
    return x


@pytest.mark.parametrize("iters", [1, 4])
@pytest.mark.parametrize("kind", ["small", "full_range"])
@pytest.mark.parametrize("probe", INT_PROBES)
def test_int_probe_plain_matches_reference_body(probe, kind, iters):
    x = script_tile(kind)
    want = reference(probe, x, iters)
    got = IP.probe_plain(torch.from_numpy(x.copy()), probe, iters)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("iters", [1, 2, 4])
def test_f32_probe_plain_matches_reference_body(iters):
    x = np.random.default_rng(0).random((L, 128)).astype(np.float32)
    want = reference("f32", x, iters)
    got = IP.probe_plain(torch.from_numpy(x.copy()), "f32", iters)
    assert got.dtype == torch.float32
    # bit for bit: normal values after one pass, flushed zeros after four
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    if iters == 1:
        assert np.count_nonzero(want) == want.size
    if iters == 4:
        assert not np.any(want)


def test_roll_direction_is_jnp_roll():
    """pltpu.roll(x, 1, 0) moves row i to row i + 1, as jnp.roll does."""
    x = np.arange(L * 4, dtype=np.int32).reshape(L, 4)
    got = np.asarray(jax.jit(lambda a: pltpu.roll(a, 1, 0))(jnp.asarray(x)))
    assert np.array_equal(got, np.roll(x, 1, 0))
    once = IP.probe_plain(torch.from_numpy(x.copy()), "roll", 1).numpy()
    assert np.array_equal(once, np.roll(x, REP, 0))


@pytest.mark.parametrize("probe", IP.PROBES)
def test_wrapper_on_cpu_is_the_plain_version(probe):
    x = (torch.from_numpy(np.random.default_rng(0).random((L, 40)).astype(
        np.float32)) if probe == "f32" else
        torch.from_numpy(script_tile()[:, :40].copy()))
    assert torch.equal(IP.isa_probe(x, probe).view(torch.int32),
                       IP.probe_plain(x, probe).view(torch.int32))


def test_wrapper_rejects_bad_inputs():
    x = torch.zeros((L, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        IP.isa_probe(x, "nope")
    with pytest.raises(TypeError):
        IP.isa_probe(x, "f32")
    with pytest.raises(TypeError):
        IP.isa_probe(x.float(), "mul")
    with pytest.raises(ValueError):
        IP.isa_probe(torch.zeros((21, 8), dtype=torch.int32), "mul")
    with pytest.raises(ValueError):
        IP.isa_probe(torch.zeros((L, 8, 1), dtype=torch.int32), "mul")
    with pytest.raises(ValueError):
        IP.isa_probe(torch.zeros((8, L), dtype=torch.int32).T, "mul")
    with pytest.raises(ValueError):
        IP.isa_probe(x, "mul", iters=-1)


def test_cuda_probe_order_matches_python():
    src = (Path(IP.__file__).parent / "csrc" / "isa_probe.cu").read_text()
    enum = re.search(r"enum \{ ([A-Z_, 0-9]+) \};", src).group(1)
    names = [n.strip().lower() for n in enum.split(",")][:-1]
    assert names == list(IP.PROBES)
    assert IP.REPLACES["f32"] == "experiments/proto_pallas3.py:115"
    assert {IP.REPLACES[p] for p in INT_PROBES} == {
        "experiments/proto_pallas3.py:23"}


def test_bounds():
    issue, hbm = 128 * 132 * 1.98e9, 3.35e12
    ms, by = IP.bound_ms("rotate", 16384, 4, issue, hbm)
    assert by == "bytes" and ms == pytest.approx(2 * 4 * L * 16384 / hbm * 1e3)
    ms, by = IP.bound_ms("mul", 16384, 4, issue, hbm)
    assert by == "operations"
    assert ms == pytest.approx(L * 16384 * 4 * 2 * REP / issue * 1e3)
    assert IP.bound_ms("where", 16384, 4, issue, hbm)[1] == "bytes"


def test_experiment_runs_on_cpu():
    res = proto_pallas3.run(device="cpu", B=96)
    assert [r["probe"] for r in res["probes"]] == list(IP.PROBES)
    for row in res["probes"]:
        assert row["vs_plain"] == "bit-exact on 96 columns, 1 and 4 passes"
        assert row["ms"] is None
    x = proto_pallas3.probe_inputs(96, torch.device("cpu"))
    assert np.array_equal(x["int32"].numpy(), np.random.default_rng(
        0).integers(0, 4096, (L, 96)))
