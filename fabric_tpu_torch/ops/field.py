"""K1: 256-bit Montgomery arithmetic mod P-256's p and n, mod
p25519 = 2^255 - 19 (Ed25519) and mod BN254's p (idemix), in PyTorch.

Counterpart of `fabric_tpu/ops/flatfield.py` (`FlatMod`) and the limb
codecs of `fabric_tpu/ops/bignum.py`.  The reference works on (22, B)
int32 tensors of 12-bit limbs with R = 2^264 and lazily reduced values,
a layout chosen so that products stay exact in int32 and f32 on the TPU.
The port changes the representation and keeps the values:

* The CUDA kernels (`csrc/p256_field.cuh`, `field_ptx.cuh`,
  `field_group.cuh`) hold 8 x 32-bit limbs per value with R = 2^256 and
  64-bit products.
* The plain PyTorch version here holds (16, B) int64 tensors of 16-bit
  little-endian limbs, also with R = 2^256, so a 16 x 16-bit product plus
  its carries stays exact in int64.  It runs the same CIOS Montgomery
  multiply as the kernel and keeps every value fully reduced (< m) after
  every operation, as the kernel does.

Both give the same Montgomery forms, so values cross between them
unchanged.  The plain version serves the CPU tests and is what a wrapper
runs for tensors on the CPU; `chip_smoke.py` holds each kernel against it
on the card.

KP1 (`field_mul_chain`) is the standalone launch of the device field
layer, and the Hopper counterpart of the Pallas field-multiply
microbenchmark `experiments/proto_pallas.py:run`.  It runs one lane on
TPI threads (`group_plan`): field_ptx.cuh's one-thread multiplies where
one thread a lane fills the card, field_group.cuh's group multiply
below that.  It is
a benchmark and a check of the field layer, not part of the provider's
path.  With `r_log2=264` it computes that benchmark's own function, a
chain of `bignum.Mont` multiplies (R = 2^264), on the port's R = 2^256:
b is scaled once by 2^248 (one multiply, b * 2^248 * 2^-256 = b * 2^-8),
after which every multiply of the chain equals one with R = 2^264.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from . import _build

LIMB_BITS = 16
LIMBS = 16                     # 16 x 16 = 256 bits
MASK = (1 << LIMB_BITS) - 1
R_BITS = 256

P = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
P25519 = 2**255 - 19
# BN254's p (AMCL's BN254, x = -(2^62 + 2^55 + 1)): 36x^4 + 36x^3 + 24x^2
# + 6x + 1, as fabric_tpu_torch/idemix/bn254.py derives it
BN254 = 0x2523648240000001BA344D80000000086121000000000013A700000000000013
# the R of the chain functions: the port's own, or the reference's
# bignum.Mont (22 x 12-bit limbs); R264_SCALE = 2^248 mod m maps one onto
# the other and is 2^248 itself, since every modulus here exceeds 2^248
R_LOG2S = (256, 264)
R264_SCALE = 1 << 248


# ---------------------------------------------------------------------------
# Limb codecs (bignum.int_to_limbs / words_be_to_limbs counterparts)
# ---------------------------------------------------------------------------

def int_to_limbs(x: int, n_limbs: int = LIMBS) -> list:
    """Python int (0 <= x < 2^(16*n_limbs)) -> little-endian 16-bit limbs."""
    if x < 0 or x >> (LIMB_BITS * n_limbs):
        raise ValueError("value out of range for the limb count")
    return [(x >> (LIMB_BITS * i)) & MASK for i in range(n_limbs)]


def ints_to_limbs(vals: Sequence[int], device="cpu") -> torch.Tensor:
    """B python ints -> (16, B) int64 limbs."""
    rows = [int_to_limbs(int(v)) for v in vals]
    return torch.tensor(rows, dtype=torch.int64,
                        device=device).reshape(len(rows), LIMBS).T.contiguous()


def limbs_to_ints(t: torch.Tensor) -> list:
    """(16, B) limbs (any signed magnitudes) -> B python ints."""
    cols = t.to("cpu", torch.int64).T.tolist()
    return [sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(col))
            for col in cols]


def words_be_to_limbs(words: torch.Tensor) -> torch.Tensor:
    """(8, *B) big-endian 32-bit words (uint32 or int64) -> (16, *B) int64
    limbs.  Word 0 is the most significant, as in SEC1 byte order."""
    w = words.to(torch.int64).flip(0)                      # little-endian
    return torch.stack([w & MASK, w >> LIMB_BITS], dim=1).reshape(
        (LIMBS,) + tuple(w.shape[1:]))


def words_le_to_limbs(words: torch.Tensor) -> torch.Tensor:
    """(B, 8) little-endian 32-bit limbs (KP1 layout) -> (16, B)."""
    w = words.to(torch.int64)
    return torch.stack([w & MASK, w >> LIMB_BITS], dim=2).reshape(
        w.shape[0], LIMBS).T


def limbs_to_words_le(t: torch.Tensor) -> torch.Tensor:
    """(16, B) canonical limbs -> (B, 8) uint32 little-endian words."""
    w = t[0::2] | (t[1::2] << LIMB_BITS)
    return w.T.contiguous().to(torch.uint32)


def ints_to_words_le(vals: Sequence[int], device="cpu") -> torch.Tensor:
    """B python ints (< 2^256) -> (B, 8) uint32 little-endian words."""
    rows = [[(int(v) >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
            for v in vals]
    return torch.tensor(rows, dtype=torch.int64,
                        device=device).reshape(len(rows), 8).to(torch.uint32)


def words_le_to_ints(words: torch.Tensor) -> list:
    rows = words.to("cpu", torch.int64).tolist()
    return [sum(int(v) << (32 * i) for i, v in enumerate(row))
            for row in rows]


# ---------------------------------------------------------------------------
# Exact carry handling on (16, *B) int64 limbs
# ---------------------------------------------------------------------------

def normalize(t: torch.Tensor) -> torch.Tensor:
    """Carry-propagate in place: limbs 0..14 into [0, 2^16), the top limb
    keeps the rest (negative iff the value is).  Arithmetic shifts make
    this exact for signed limbs too."""
    for j in range(LIMBS - 1):
        t[j + 1] += t[j] >> LIMB_BITS
        t[j] &= MASK
    return t


def _col(vals: list, like: torch.Tensor) -> torch.Tensor:
    """Constant limbs as a (16, 1, ...) column broadcastable against like."""
    return torch.tensor(vals, dtype=torch.int64, device=like.device).reshape(
        (LIMBS,) + (1,) * (like.dim() - 1))


def lt_const(x: torch.Tensor, c: int) -> torch.Tensor:
    """Canonical limbs (value < 2^256) < python int c -> (B,) bool."""
    d = normalize(x - _col(int_to_limbs(c), x))
    return d[LIMBS - 1] < 0


def add_const(x: torch.Tensor, c: int):
    """x + c for canonical x -> (low 256 bits as limbs, carry-out bool)."""
    s = normalize(x + _col(int_to_limbs(c), x))
    carry = s[LIMBS - 1] >> LIMB_BITS
    s[LIMBS - 1] &= MASK
    return s, carry != 0


def is_zero_limbs(x: torch.Tensor) -> torch.Tensor:
    return (x == 0).all(dim=0)


# ---------------------------------------------------------------------------
# Montgomery context (FlatMod counterpart), R = 2^256
# ---------------------------------------------------------------------------

class Mod:
    """Montgomery arithmetic for an odd modulus m < 2^256, R = 2^256.

    Every value is a (16, *B) int64 tensor of canonical limbs (< m) in
    and out, except where a docstring says otherwise."""

    def __init__(self, modulus: int, name: str = ""):
        if modulus % 2 == 0 or modulus >> R_BITS:
            raise ValueError("modulus must be odd and < 2^256")
        self.m = modulus
        # subtractions canon() needs for any 256-bit value: 1 for P-256's
        # p and n, 2 for p25519, 6 for BN254's p (~2^253.2)
        self.canon_subs = ((1 << R_BITS) - 1) // modulus
        self.name = name
        self.R = 1 << R_BITS
        self.n0inv = (-pow(modulus, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
        self.n0inv32 = (-pow(modulus, -1, 1 << 32)) % (1 << 32)
        self.m_limbs = int_to_limbs(modulus)
        self.r2_int = self.R * self.R % modulus
        self.one_int = self.R % modulus

    def const(self, x: int, like: torch.Tensor) -> torch.Tensor:
        """Canonical (16, 1, ...) column of the plain value x mod m."""
        return _col(int_to_limbs(x % self.m), like)

    def const_mont(self, x: int, like: torch.Tensor) -> torch.Tensor:
        return self.const(x * self.R, like)

    def one_bc(self, like: torch.Tensor) -> torch.Tensor:
        """Montgomery one (R mod m) broadcast to like's shape."""
        return self.const(self.one_int, like).expand_as(like).clone()

    # -- reduction -----------------------------------------------------------

    def _reduce_once(self, t: torch.Tensor) -> torch.Tensor:
        """Lazy (possibly signed) limbs of a value in [0, 2m) -> canonical."""
        normalize(t)
        d = normalize(t - _col(self.m_limbs, t))
        return torch.where(d[LIMBS - 1] < 0, t, d)

    def canon(self, a: torch.Tensor) -> torch.Tensor:
        """Any 256-bit value -> [0, m): `canon_subs` conditional
        subtractions, one when m > 2^255, two for p25519 (2^256 - 1 =
        2m + 37), six for BN254's p."""
        t = a.clone()
        for _ in range(self.canon_subs):
            t = self._reduce_once(t)
        return t

    # -- core multiply: CIOS, one 16-bit limb of a per step --------------------

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a * b * R^-1 mod m.  a may be any value < 2^256, b must be < m
        (then a*b < m*R and the CIOS result is < 2m before the final
        subtraction).  Both broadcast over their batch dimensions."""
        shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
        b = b.expand((LIMBS,) + shape)
        t = torch.zeros((2 * LIMBS,) + shape, dtype=torch.int64,
                        device=a.device)
        mcol = _col(self.m_limbs, t)
        for i in range(LIMBS):
            w = t[i:i + LIMBS]
            w.addcmul_(b, a[i])                    # += a_i * b
            q = ((t[i] & MASK) * self.n0inv) & MASK
            w.addcmul_(mcol, q)                    # += q * m; t_i = 0 mod 2^16
            t[i + 1] += t[i] >> LIMB_BITS
        return self._reduce_once(t[LIMBS:])

    def sqr(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul(a, a)

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._reduce_once(a + b)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._reduce_once(a - b + _col(self.m_limbs, a))

    def is_zero(self, a: torch.Tensor) -> torch.Tensor:
        return (a == 0).all(dim=0)

    def eq(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return (a == b).all(dim=0)

    @staticmethod
    def select(cond: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
        return torch.where(cond, a, b)

    # -- conversions / exponentiation ----------------------------------------

    def to_mont(self, a: torch.Tensor) -> torch.Tensor:
        """Any 256-bit value -> Montgomery form of (a mod m)."""
        return self.mul(a, _col(int_to_limbs(self.r2_int), a))

    def from_mont(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul(a, _col(int_to_limbs(1), a))

    def pow_const(self, a: torch.Tensor, e: int) -> torch.Tensor:
        """a^e (Montgomery in, Montgomery out) for a fixed e > 0:
        left-to-right binary square-and-multiply, as the kernel does."""
        if e <= 0:
            raise ValueError("exponent must be positive")
        acc = a
        for bit in bin(e)[3:]:
            acc = self.sqr(acc)
            if bit == "1":
                acc = self.mul(acc, a)
        return acc

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        """a^(m-2) (Fermat; m prime).  inv(0) = 0."""
        return self.pow_const(a, self.m - 2)


fp = Mod(P, "p256.p")
fn = Mod(N, "p256.n")
f25519 = Mod(P25519, "ed25519.p")
fbn = Mod(BN254, "bn254.p")
MODS = {"p": fp, "n": fn, "p25519": f25519, "bn254": fbn}
# the modulus index the CUDA field layer takes (p256_field.cuh MOD_*)
MOD_INDEX = {"p": 0, "n": 1, "p25519": 2, "bn254": 3}


# ---------------------------------------------------------------------------
# KP1: a chain of Montgomery multiplications per lane
# ---------------------------------------------------------------------------

def mul_chain_plain(a: torch.Tensor, b: torch.Tensor, k: int,
                    modulus: str = "p", r_log2: int = 256) -> torch.Tensor:
    """Plain version of KP1: for each lane, b <- b mod m, then k times
    t <- t * b * 2^-r_log2 mod m starting from t = a.  a, b: (B, 8) uint32
    little-endian 32-bit limbs (any 256-bit values).  Returns (B, 8)
    uint32, canonical."""
    _check_r(r_log2)
    f = MODS[modulus]
    t = words_le_to_limbs(a)
    bl = f.canon(words_le_to_limbs(b))
    if r_log2 == 264:
        bl = f.mul(bl, f.const(R264_SCALE, bl))
    for _ in range(k):
        t = f.mul(t, bl)
    if k == 0:
        t = f.canon(t)
    return limbs_to_words_le(t)


# ---------------------------------------------------------------------------
# Threads a lane (TPI) and block size of the chain kernels
# ---------------------------------------------------------------------------

FILL_THREADS_PER_SM = 2048     # an H100 SM's resident threads
# the instantiated TPIs: one thread, and field_group.cuh's group of 4.
# The header also takes 8, which no kernel instantiates: at the
# reference's 16,384 lanes 4 beat 8 for every modulus and preset but
# `planes` (a tie), and at SMs x 2,048 lanes one thread beats both, on
# an H100 (tools/field_ab.py, PERF.md §6).
TPIS = (1, 4)
# the plan's group.  At 16,384 lanes it is not the fastest launch for
# every kernel: one thread a lane beats it for KP1 (every modulus) and
# KF2's `min`, `planes` ties, and the group wins for `relaxed`, `stacked`
# and `ilp` (PERF.md §6; ROADMAP B11 queues a rule chosen per kernel).
GROUP_TPI = 4
BLOCK_THREADS = 128


def group_plan(lanes: int, sms: int, threads: int | None = None,
               tpi: int | None = None, k: int = 1) -> tuple:
    """Launch shape of a chain kernel for `lanes` lanes, K chains a
    thread (group), on a card of `sms` SMs -> (tpi, threads a block,
    blocks).

    TPI: one thread a lane where the lanes fill the card's thread slots
    (SMs x 2,048; K chains in one thread stand in for K threads), else a
    group of GROUP_TPI; `tpi` forces one of TPIS.  The block: `threads`
    where given, else at most BLOCK_THREADS, halved (down to one warp)
    while the grid would have fewer blocks than SMs."""
    if tpi is None:
        tpi = 1 if lanes >= sms * FILL_THREADS_PER_SM else GROUP_TPI
    if tpi not in TPIS:
        raise ValueError(f"tpi must be one of {TPIS}, got {tpi!r}")
    total = lanes // k * tpi
    if threads is None:
        threads = BLOCK_THREADS
        while threads > 32 and -(-total // threads) < sms:
            threads //= 2
    return tpi, threads, -(-total // threads)


def _check_r(r_log2: int) -> None:
    if r_log2 not in R_LOG2S:
        raise ValueError(f"r_log2 must be one of {R_LOG2S}, got {r_log2!r}")


def _check_words(name: str, x: torch.Tensor, shape) -> None:
    if x.dtype != torch.uint32:
        raise TypeError(f"{name} must be uint32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device (group_plan's card size)."""
    return _sms(device.index if device.index is not None
                else torch.cuda.current_device())


def kp1_symbol(modulus: str, tpi: int) -> str:
    """The (Itanium-mangled) name fragment of KP1's kernel for a modulus
    at tpi threads a lane, as `cuobjdump -sass` and ptxas print it."""
    m = MOD_INDEX[modulus]
    return (f"kp1_thread_kernelILi{m}E" if tpi == 1
            else f"kp1_group_kernelILi{m}ELi{tpi}E")


def kp1_plan(lanes: int, device: torch.device,
             tpi: int | None = None) -> tuple:
    """KP1's launch shape on a CUDA device -> (tpi, threads, blocks)."""
    return group_plan(lanes, sm_count(device), None, tpi)


def field_mul_chain(a: torch.Tensor, b: torch.Tensor, k: int,
                    modulus: str = "p", r_log2: int = 256,
                    tpi: int | None = None) -> torch.Tensor:
    """KP1 wrapper.  CUDA tensors launch the kernel at `kp1_plan`'s
    threads a lane (`tpi` forces one of TPIS); CPU tensors take
    `mul_chain_plain`.  Raises on anything the kernel does not take, and
    when the launch fails."""
    _check_r(r_log2)
    if modulus not in MODS:
        raise ValueError(f"modulus must be one of {sorted(MODS)}, "
                         f"got {modulus!r}")
    if a.dim() != 2 or a.shape[1] != 8:
        raise ValueError("a must have shape (B, 8)")
    _check_words("a", a, a.shape)
    _check_words("b", b, a.shape)
    if not 0 <= k < (1 << 31):
        raise ValueError("k out of range")
    if a.device != b.device:
        raise ValueError("a and b must be on one device")
    if tpi is not None and tpi not in TPIS:
        raise ValueError(f"tpi must be one of {TPIS}, got {tpi!r}")
    if a.device.type == "cpu":
        return mul_chain_plain(a, b, k, modulus, r_log2)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    out = torch.empty_like(a)
    if a.shape[0] == 0:
        return out
    tpi, threads, _ = kp1_plan(a.shape[0], a.device, tpi)
    lib = _build.load("field_chain")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.field_mul_chain_group_launch(
            ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(b.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), ctypes.c_int(a.shape[0]),
            ctypes.c_int(k), ctypes.c_int(MOD_INDEX[modulus]),
            ctypes.c_int(r_log2 == 264), ctypes.c_int(tpi),
            ctypes.c_int(threads), ctypes.c_void_p(stream))
    if rc:
        raise RuntimeError(f"field_mul_chain launch failed: CUDA error {rc}")
    field_mul_chain.launches += 1
    return out


field_mul_chain.launches = 0


# ---------------------------------------------------------------------------
# Work count for the kernels' bounds
# ---------------------------------------------------------------------------

# 32-bit multiply-adds that one Montgomery multiply or square needs, a
# 32 x 32 -> 64-bit product counting as two (low and high half).  A
# multiply needs its 64 limb products a_i * b_j, a square 36 (8 squares
# and 28 doubled cross products).  Mod p the reduction needs no
# multiplies: p's limbs are 0, 1 and 2^32 - 1, so q * p is shifts, adds
# and subtractions.  Mod n it needs 64 products q * n_j and 8 low
# products q = t_0 * (-n^-1 mod 2^32).  Mod p25519 = 2^255 - 19 the least
# reduction is not Montgomery's but the fold 2^256 = 38: the product's 8
# high limbs times 38 (8 products) and the fold of the last carry (1).
# Mod BN254's p, a generic prime, the reduction costs what it costs mod n.
# This is the least work, not what the kernels issue (the generic
# reduction's q m products mod n and BN254's p, no dedicated square).
IMADS = {("p", "mul"): 2 * 64, ("p", "sqr"): 2 * 36,
         ("n", "mul"): 2 * (64 + 64) + 8, ("n", "sqr"): 2 * (36 + 64) + 8,
         ("p25519", "mul"): 2 * (64 + 9), ("p25519", "sqr"): 2 * (36 + 9),
         ("bn254", "mul"): 2 * (64 + 64) + 8,
         ("bn254", "sqr"): 2 * (36 + 64) + 8}
