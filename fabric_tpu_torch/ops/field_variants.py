"""KF2: the CIOS-variant microbenchmarks of the JAX package's
`experiments/`, as one templated Hopper kernel
(`csrc/field_chain_variants.cu`).

Each reference script times a Pallas chain of n Montgomery multiplies mod
P-256's p on (22, B) 12-bit limbs and holds it against a `bignum.Mont`
chain, whose R is 2^264.  Every preset here computes that one function,
a * (b * 2^-264)^n mod p per lane, so all of them share one plain version,
`field.mul_chain_plain(a, b, n, "p", r_log2=264)`:

=========  ==================================  ===========================
preset     reference function                  kernel template
=========  ==================================  ===========================
relaxed    experiments/proto_pallas2.py:71     LAZY
stacked    experiments/proto_pallas2.py:127    LAZY, K = 4
min        experiments/proto_pallas4.py:70     LAZY + MIN
planes     experiments/proto_planes.py:74      LAZY + PLANES
ilp        experiments/proto_ilp.py:72         LAZY, K in (1, 2, 4, 8)
=========  ==================================  ===========================

The kernel's output is canonical (a LAZY chain is brought into [0, p)
once, at its end), so it equals the plain version limb for limb.  One
more entry, `exact` (no LAZY: every multiply reduces fully), is a control
rather than a counterpart of its own: KP1's chain inlined in registers,
which `experiments.proto_pallas` times beside KP1.

Layouts: element-major presets take (B, 8) uint32 little-endian limbs, as
KP1 does; `planes` takes (8, B) limb planes (`to_planes`/`from_planes`).
With K chains a thread carries lanes k * (B / K) + j (`stack_lanes`), the
lane order of the reference's `.reshape(L, K, B // K)`.

Each variant runs B / K thread groups of TPI threads (`variant_plan`,
`field.group_plan`): one thread where the B lanes fill the card, else
field_group.cuh's group multiply on 4 threads, each thread of the group
carrying the limbs of its K chains.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build
from . import field as F
from .field import IMADS, mul_chain_plain


@dataclass(frozen=True)
class Variant:
    name: str
    lazy: bool
    k: int
    planes: bool
    min: bool
    max_threads: int


# one template instantiation each; the index is the kernel's variant id
# (field_chain_variants.cu kf2::variant)
VARIANTS = (
    Variant("exact", False, 1, False, False, 512),
    Variant("lazy", True, 1, False, False, 512),
    Variant("lazy_k2", True, 2, False, False, 512),
    Variant("lazy_k4", True, 4, False, False, 512),
    Variant("lazy_k8", True, 8, False, False, 128),
    Variant("min", True, 1, False, True, 512),
    Variant("planes", True, 1, True, False, 512),
)
VARIANT_ID = {v.name: i for i, v in enumerate(VARIANTS)}

# preset -> (reference site, {K: variant name})
PRESETS = {
    "relaxed": ("experiments/proto_pallas2.py:71", {1: "lazy"}),
    "stacked": ("experiments/proto_pallas2.py:127", {4: "lazy_k4"}),
    "min": ("experiments/proto_pallas4.py:70", {1: "min"}),
    "planes": ("experiments/proto_planes.py:74", {1: "planes"}),
    "ilp": ("experiments/proto_ilp.py:72",
            {1: "lazy", 2: "lazy_k2", 4: "lazy_k4", 8: "lazy_k8"}),
    "exact": ("experiments/proto_pallas.py:94", {1: "exact"}),
}

THREADS = (128, 256, 512)
# least 32-bit multiply-adds of one multiply mod p (2 SM-cycles at 64 a
# clock); a lane moves a, b and the output, 32 bytes each
IMADS_PER_MUL = IMADS["p", "mul"]
BYTES_PER_LANE = 3 * 32


def variant_of(preset: str, k: int | None = None) -> Variant:
    """The variant a preset runs with K chains (its only K when None)."""
    if preset not in PRESETS:
        raise ValueError(f"preset must be one of {sorted(PRESETS)}, "
                         f"got {preset!r}")
    ks = PRESETS[preset][1]
    if k is None:
        if len(ks) != 1:
            raise ValueError(f"preset {preset!r} needs k, one of "
                             f"{sorted(ks)}")
        k = next(iter(ks))
    if k not in ks:
        raise ValueError(f"preset {preset!r} takes k in {sorted(ks)}, "
                         f"got {k!r}")
    return VARIANTS[VARIANT_ID[ks[k]]]


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

def to_planes(x: torch.Tensor) -> torch.Tensor:
    """(B, 8) uint32 lanes -> (8, B) limb planes."""
    return x.view(torch.int32).T.contiguous().view(torch.uint32)


def from_planes(x: torch.Tensor) -> torch.Tensor:
    """(8, B) limb planes -> (B, 8) uint32 lanes."""
    return x.view(torch.int32).T.contiguous().view(torch.uint32)


def stack_lanes(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, 8) lanes as the kernel's K chains: [k, j] is lane k * (B / K) +
    j, the column order of the reference's (22, B).reshape(22, K, B // K).
    A view: the kernel reads the same memory."""
    if x.shape[0] % k:
        raise ValueError(f"B = {x.shape[0]} is not a multiple of K = {k}")
    return x.view(k, x.shape[0] // k, 8)


# ---------------------------------------------------------------------------
# plain version and wrapper
# ---------------------------------------------------------------------------

def variant_plain(a: torch.Tensor, b: torch.Tensor, n: int,
                  preset: str, k: int | None = None) -> torch.Tensor:
    """Plain version of every preset: `mul_chain_plain` at r_log2 = 264 in
    the preset's layout."""
    v = variant_of(preset, k)
    if v.planes:
        return to_planes(mul_chain_plain(from_planes(a), from_planes(b), n,
                                         "p", r_log2=264))
    return mul_chain_plain(a, b, n, "p", r_log2=264)


def _check(a: torch.Tensor, b: torch.Tensor, v: Variant) -> int:
    """Checks the operands of variant v -> the lane count B."""
    for name, x in (("a", a), ("b", b)):
        if x.dtype != torch.uint32:
            raise TypeError(f"{name} must be uint32, got {x.dtype}")
        if x.dim() != 2 or x.shape[0 if v.planes else 1] != 8:
            raise ValueError(f"{name} must have shape "
                             f"{'(8, B)' if v.planes else '(B, 8)'}, "
                             f"got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.shape != b.shape:
        raise ValueError("a and b must have one shape")
    if a.device != b.device:
        raise ValueError("a and b must be on one device")
    if v.planes:
        return a.shape[1]
    stack_lanes(a, v.k)           # raises unless K divides B
    return a.shape[0]


def variant_plan(preset: str, k: int | None, lanes: int,
                 device: torch.device, threads: int | None = None,
                 tpi: int | None = None) -> tuple:
    """A preset's launch shape on a CUDA device for `lanes` lanes ->
    (tpi, threads a block, blocks): B / K groups (`field.group_plan`;
    `threads` fixes the block, None takes the plan's)."""
    v = variant_of(preset, k)
    return F.group_plan(lanes, F.sm_count(device), threads, tpi, v.k)


def field_chain_variant(a: torch.Tensor, b: torch.Tensor, n: int,
                        preset: str, k: int | None = None,
                        threads: int | None = None,
                        clock: torch.Tensor | None = None,
                        tpi: int | None = None) -> torch.Tensor:
    """KF2 wrapper: a * (b * 2^-264)^n mod p per lane in the preset's
    layout.  CUDA tensors launch the kernel at `variant_plan`'s shape:
    `threads` threads a block (None: the plan's), `tpi` threads a lane
    (one of field.TPIS; None: the plan's); CPU tensors take
    `variant_plain`.  `clock`, a CUDA int64
    tensor of two elements, launches the clock64 build instead, which
    writes there the SM cycles and the nanoseconds (globaltimer) of
    thread 0's chain.  Raises on anything the kernel does not take, and
    when the launch fails."""
    v = variant_of(preset, k)
    lanes = _check(a, b, v)
    if tpi is not None and tpi not in F.TPIS:
        raise ValueError(f"tpi must be one of {F.TPIS}, got {tpi!r}")
    if not 0 <= n < (1 << 31):
        raise ValueError("n out of range")
    if threads is not None and (threads not in THREADS
                                or threads > v.max_threads):
        raise ValueError(f"threads must be one of "
                         f"{[t for t in THREADS if t <= v.max_threads]} for "
                         f"{v.name}, got {threads!r}")
    if a.device.type == "cpu":
        if clock is not None:
            raise ValueError("clock needs the CUDA kernel")
        return variant_plain(a, b, n, preset, k)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if clock is not None and (clock.dtype != torch.int64
                              or clock.device != a.device
                              or clock.numel() < 2):
        raise ValueError("clock must be two int64s on a's device")
    out = torch.empty_like(a)
    if lanes == 0:
        return out
    tpi, threads, _ = variant_plan(preset, k, lanes, a.device, threads, tpi)
    lib = _build.load("field_chain_variants")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.field_chain_variant_group_launch(
            ctypes.c_int(VARIANT_ID[v.name]), ctypes.c_int(clock is not None),
            ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(b.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), ctypes.c_int(lanes),
            ctypes.c_int(n), ctypes.c_int(tpi), ctypes.c_int(threads),
            ctypes.c_void_p(0 if clock is None else clock.data_ptr()),
            ctypes.c_void_p(stream))
    if rc:
        raise RuntimeError(f"field_chain_variant ({v.name}) launch failed: "
                           f"CUDA error {rc}")
    field_chain_variant.launches += 1
    return out


field_chain_variant.launches = 0


def kernel_attrs(preset: str, k: int | None = None,
                 clock: bool = False, tpi: int = 1) -> dict:
    """Registers and local (stack) bytes a thread, and the most threads a
    block, of a preset's kernel at tpi threads a lane, from
    cudaFuncGetAttributes."""
    v = variant_of(preset, k)
    lib = _build.load("field_chain_variants")
    buf = (ctypes.c_int * 3)()
    rc = lib.field_chain_variant_attrs(
        ctypes.c_int(VARIANT_ID[v.name]), ctypes.c_int(clock),
        ctypes.c_int(tpi), ctypes.cast(buf, ctypes.c_void_p))
    if rc:
        raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {rc}")
    return {"regs": buf[0], "frame_bytes": buf[1], "max_threads": buf[2]}


def kernel_symbol(preset: str, k: int | None = None,
                  clock: bool = False, tpi: int = 1) -> str:
    """The (Itanium-mangled) name fragment of a preset's kernel at tpi
    threads a lane, as `cuobjdump -sass` and ptxas print it."""
    v = variant_of(preset, k)
    args = (f"ILb{int(v.lazy)}ELi{v.k}ELb{int(v.planes)}"
            f"ELb{int(v.min)}ELb{int(clock)}ELi{v.max_threads}E")
    if tpi == 1:
        return "kf2_kernel" + args
    return f"kf2_group_kernel{args[:-1]}ELi{tpi}E"


def bound_ms(lanes: int, n: int, rate_imads: float,
             rate_bytes: float) -> tuple:
    """The least time of a chain launch -> (ms, "operations" or "bytes"):
    n multiplies a lane at IMADS_PER_MUL each over the card's multiply-add
    rate, against BYTES_PER_LANE a lane over its memory rate."""
    ops_s = lanes * n * IMADS_PER_MUL / rate_imads
    bytes_s = lanes * BYTES_PER_LANE / rate_bytes
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")
