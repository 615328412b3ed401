"""KI3: the instruction-cost probes of the JAX package's
`experiments/proto_pallas3.py`, as one templated Hopper kernel
(`csrc/isa_probe.cu`).

The reference runs eight bodies over a (22, B) tile, REP = 64 steps each
(16 for the split round), 4 passes, and prints each one's ns per op and
lane-ops/s: seven int32 bodies (`proto_pallas3.py:23`, `bench.run`) and
one f32 body (`:115`, `bench_f32.run`).  Each probe here computes the same
values as its reference body on a (22, B) tensor; the plain versions are
torch on the same tensor.  `probe_plan` picks the kernel's layout: one
thread a column where the columns fill the card, else the probe's work
spread over several threads a column (`SPREAD`), but for split.
"""

from __future__ import annotations

import ctypes
import struct

import torch

from . import _build
from .field import FILL_THREADS_PER_SM, sm_count

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
# three-input logic op (SHF, LOP3; in the quad kernel a multiply by 2 on
# the values' bit reverses, IMAD), split a mask and a shifted add (LOP3,
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

# the kernel's layouts (csrc/isa_probe.cu): one thread a column; one
# thread 4 neighbouring elements of a row (r, j) .. (r, j + 3); row_mul's
# column on 2 lanes of a warp, 11 rows a lane
LAYOUTS = ("column", "quad", "g2")
LAYOUT_ID = {lay: i for i, lay in enumerate(LAYOUTS)}
QUAD_PER = 4
G2_ROWS = L // 2
# the plan's layout below the fill, each probe's one spread layout: the
# rows of mul, shift_or and f32 never mix, where reads row 0 once a pass,
# rotate and roll move whole rows; row_mul's rows mix every step; split
# stays one thread a column (spread over lanes it was no faster on an
# H100: PERF.md §6)
SPREAD = {"mul": "quad", "row_mul": "g2", "rotate": "quad", "roll": "quad",
          "where": "quad", "split": "column", "shift_or": "quad",
          "f32": "quad"}
# the layouts each probe has a kernel for
PROBE_LAYOUTS = {p: tuple(dict.fromkeys(("column", SPREAD[p])))
                 for p in PROBES}
BLOCK_THREADS = 128


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


def _check_layout(probe: str, layout: str) -> None:
    if layout not in PROBE_LAYOUTS[probe]:
        raise ValueError(f"probe {probe!r} has layouts "
                         f"{PROBE_LAYOUTS[probe]}, got {layout!r}")


def layout_threads(layout: str, B: int) -> int:
    """Threads of a launch over B columns in a layout (the kernel's
    `layout_threads`)."""
    if layout == "column":
        return B
    if layout == "quad":
        return L * -(-B // QUAD_PER)
    return 32 * -(-B // 16)         # g2: 16 columns a warp


def probe_plan(probe: str, B: int, sms: int,
               layout: str | None = None) -> tuple:
    """Launch of a probe over (22, B) on a card of `sms` SMs -> (layout,
    threads, blocks of BLOCK_THREADS).  One thread a column where the
    columns fill the card's thread slots (SMs x 2,048), else the probe's
    spread layout (`SPREAD`; split's is one thread a column); `layout`
    forces one of the probe's (`PROBE_LAYOUTS`)."""
    if probe not in PROBE_ID:
        raise ValueError(f"probe must be one of {PROBES}, got {probe!r}")
    if layout is None:
        layout = ("column" if B >= sms * FILL_THREADS_PER_SM
                  else SPREAD[probe])
    _check_layout(probe, layout)
    threads = layout_threads(layout, B)
    return layout, threads, -(-threads // BLOCK_THREADS)


def isa_probe(x: torch.Tensor, probe: str, iters: int = ITERS,
              layout: str | None = None) -> torch.Tensor:
    """KI3 wrapper.  CUDA tensors launch the probe's kernel in the plan's
    layout, or in `layout` where given; CPU tensors take `probe_plain`
    (every layout computes its values).  Raises on anything the kernel
    does not take, and when the launch fails."""
    _check(x, probe)
    if layout is not None:
        _check_layout(probe, layout)
    if not 0 <= iters < (1 << 31):
        raise ValueError("iters out of range")
    if x.device.type == "cpu":
        return probe_plain(x, probe, iters)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = torch.empty_like(x)
    B = x.shape[1]
    if B == 0:
        return out
    layout = probe_plan(probe, B, sm_count(x.device), layout)[0]
    lib = _build.load("isa_probe")
    fc_bits = struct.unpack("<i", struct.pack("<f", F_FACTOR))[0]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.isa_probe_layout_launch(
            ctypes.c_int(PROBE_ID[probe]), ctypes.c_int(LAYOUT_ID[layout]),
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_int(B), ctypes.c_int(iters), ctypes.c_int(C_MUL),
            ctypes.c_int(MASK20), ctypes.c_int(MASK12), ctypes.c_int(SHIFT),
            ctypes.c_int(THRESHOLD), ctypes.c_int(fc_bits),
            ctypes.c_void_p(stream))
    if rc:
        raise RuntimeError(f"isa_probe ({probe}, {layout}) launch failed: "
                           f"CUDA error {rc}")
    isa_probe.launches += 1
    return out


isa_probe.launches = 0


def kernel_attrs(probe: str, layout: str = "column") -> dict:
    """Registers and local (stack) bytes a thread, and the most threads a
    block, of a probe's kernel in a layout, from cudaFuncGetAttributes."""
    _check_layout(probe, layout)
    lib = _build.load("isa_probe")
    buf = (ctypes.c_int * 3)()
    rc = lib.isa_probe_attrs(ctypes.c_int(PROBE_ID[probe]),
                             ctypes.c_int(LAYOUT_ID[layout]),
                             ctypes.cast(buf, ctypes.c_void_p))
    if rc:
        raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {rc}")
    return {"regs": buf[0], "frame_bytes": buf[1], "max_threads": buf[2]}


def kernel_symbol(probe: str, layout: str = "column") -> str:
    """The (Itanium-mangled) name fragment of a probe's kernel in a
    layout, as `cuobjdump -sass` and ptxas print it."""
    _check_layout(probe, layout)
    p = PROBE_ID[probe]
    if layout == "column":
        return f"isa_probe_kernelILi{p}E"
    if layout == "quad":
        return f"isa_probe_quad_kernelILi{p}E"
    return "isa_probe_row_mul_g2_kernel"


def values_per_thread(layout: str) -> int:
    """The elements of the tile one thread of a layout holds."""
    return {"column": L, "quad": QUAD_PER, "g2": G2_ROWS}[layout]


def body_form(probe: str, layout: str) -> str:
    """How a layout's kernel issues a probe's body: "brev" where shift_or
    runs on the values' bit reverses (the quad kernel: its right shift
    becomes a multiply by 2, IMAD, beside the LOP3), else "reference" (the
    reference body's operations)."""
    return "brev" if (probe, layout) == ("shift_or", "quad") else "reference"


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
