"""KI3: the instruction-cost probes of the JAX package's
`experiments/proto_pallas3.py`, as one templated Hopper kernel
(`csrc/isa_probe.cu`).

The reference runs eight bodies over a (22, B) tile, REP = 64 steps each
(16 for the split round), 4 passes, and prints each one's ns per op and
lane-ops/s: seven int32 bodies (`proto_pallas3.py:23`, `bench.run`) and
one f32 body (`:115`, `bench_f32.run`).  Each probe here computes the same
values as its reference body on a (22, B) tensor; the plain versions are
torch on the same tensor.  One thread of the kernel holds one column.
"""

from __future__ import annotations

import ctypes
import struct

import torch

from . import _build

L = 22
REP = 64
ITERS = 4
PROBES = ("mul", "row_mul", "rotate", "roll", "where", "split",
          "shift_or", "f32")
PROBE_ID = {p: i for i, p in enumerate(PROBES)}
# the reference site of each probe
REPLACES = {p: "experiments/proto_pallas3.py:23" for p in PROBES}
REPLACES["f32"] = "experiments/proto_pallas3.py:115"
# steps of a pass (the reference's n_ops)
STEPS = {p: REP for p in PROBES}
STEPS["split"] = REP // 4
# the least instructions of one pass on one element: mul and row_mul a
# multiply and a mask a step (IMAD, LOP3), shift_or a shift and a
# three-input logic op (SHF, LOP3), split a mask and a shifted add (LOP3,
# LEA.HI) a step, f32 a multiply and a subtract (FMUL, FADD); where's 64
# selects of a pass fold into one select and one add; rotate and roll are
# register renames.  They issue at up to 128 a clock per SM (4 schedulers
# x 32 lanes), whatever the mix of int32 and f32 pipes.
LEAST_PER_PASS = {"mul": 2 * REP, "row_mul": 2 * REP, "rotate": 0,
                  "roll": 0, "where": 2, "split": 2 * (REP // 4),
                  "shift_or": 2 * REP, "f32": 2 * REP}
ISSUE_PER_SM_PER_CLOCK = 128
# the constants of the bodies, passed to the kernel as arguments
C_MUL, MASK20, MASK12, SHIFT, THRESHOLD = 3, 0xFFFFF, 4095, 12, 100
F_FACTOR = 1.5


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """f32 values below 2^-126 in magnitude -> zero of their sign, as the
    kernel's .ftz operations (and the reference's XLA and TPU) flush
    them."""
    return torch.where(x.abs() < 2.0 ** -126, x * 0, x)


def _wrap32(y: torch.Tensor) -> torch.Tensor:
    """int64 values -> the int32 values they wrap to, as int64."""
    return ((y + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def probe_plain(x: torch.Tensor, probe: str,
                iters: int = ITERS) -> torch.Tensor:
    """Plain version of a probe: `iters` passes of its body over the (22,
    B) tensor x (int32; float32 for "f32")."""
    _check(x, probe)
    if probe == "f32":
        x = _ftz(x)
        for _ in range(iters * REP):
            x = _ftz(_ftz(x * F_FACTOR) - x)
        return x
    y = x.to(torch.int64)
    for _ in range(iters):
        if probe == "mul":
            for _ in range(REP):
                y = (y * C_MUL) & MASK20
        elif probe == "row_mul":
            for i in range(REP):
                y = (y * y[i % L]) & MASK20
        elif probe == "rotate":
            y = torch.roll(y, -REP, 0)
        elif probe == "roll":
            y = torch.roll(y, REP, 0)
        elif probe == "where":
            m = y[0] > THRESHOLD
            for _ in range(REP):
                y = torch.where(m, y, _wrap32(y + 1))
        elif probe == "split":
            for _ in range(REP // 4):
                c = y >> SHIFT
                y = y & MASK12
                y[1:] += c[:-1]
        else:  # shift_or
            for _ in range(REP):
                y = ((y >> 1) & MASK12) | y
    return y.to(torch.int32)


def _check(x: torch.Tensor, probe: str) -> None:
    if probe not in PROBE_ID:
        raise ValueError(f"probe must be one of {PROBES}, got {probe!r}")
    want = torch.float32 if probe == "f32" else torch.int32
    if x.dtype != want:
        raise TypeError(f"probe {probe!r} takes {want}, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] != L:
        raise ValueError(f"x must have shape ({L}, B), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def isa_probe(x: torch.Tensor, probe: str, iters: int = ITERS) -> torch.Tensor:
    """KI3 wrapper.  CUDA tensors launch the probe's kernel; CPU tensors
    take `probe_plain`.  Raises on anything the kernel does not take, and
    when the launch fails."""
    _check(x, probe)
    if not 0 <= iters < (1 << 31):
        raise ValueError("iters out of range")
    if x.device.type == "cpu":
        return probe_plain(x, probe, iters)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = torch.empty_like(x)
    if x.shape[1] == 0:
        return out
    lib = _build.load("isa_probe")
    fc_bits = struct.unpack("<i", struct.pack("<f", F_FACTOR))[0]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.isa_probe_launch(
            ctypes.c_int(PROBE_ID[probe]), ctypes.c_void_p(x.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), ctypes.c_int(x.shape[1]),
            ctypes.c_int(iters), ctypes.c_int(C_MUL), ctypes.c_int(MASK20),
            ctypes.c_int(MASK12), ctypes.c_int(SHIFT),
            ctypes.c_int(THRESHOLD), ctypes.c_int(fc_bits),
            ctypes.c_void_p(stream))
    if rc:
        raise RuntimeError(f"isa_probe ({probe}) launch failed: "
                           f"CUDA error {rc}")
    isa_probe.launches += 1
    return out


isa_probe.launches = 0


def kernel_attrs(probe: str) -> dict:
    """Registers and local (stack) bytes a thread, and the most threads a
    block, of a probe's kernel, from cudaFuncGetAttributes."""
    lib = _build.load("isa_probe")
    buf = (ctypes.c_int * 3)()
    rc = lib.isa_probe_attrs(ctypes.c_int(PROBE_ID[probe]),
                             ctypes.cast(buf, ctypes.c_void_p))
    if rc:
        raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {rc}")
    return {"regs": buf[0], "frame_bytes": buf[1], "max_threads": buf[2]}


def kernel_symbol(probe: str) -> str:
    """The (Itanium-mangled) name fragment of a probe's kernel, as
    `cuobjdump -sass` prints it."""
    return f"isa_probe_kernelILi{PROBE_ID[probe]}E"


def bound_ms(probe: str, lanes: int, iters: int, issue_rate: float,
             rate_bytes: float) -> tuple:
    """The least time of a probe launch over (22, lanes) -> (ms,
    "operations" or "bytes"): LEAST_PER_PASS instructions an element-pass
    over the card's issue rate, against one read and one write of the tile
    over its memory rate."""
    ops_s = L * lanes * iters * LEAST_PER_PASS[probe] / issue_rate
    bytes_s = 2 * 4 * L * lanes / rate_bytes
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")
