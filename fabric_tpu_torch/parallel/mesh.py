"""K9: device-list sharding of signature batches.

Counterpart of `fabric_tpu/parallel/mesh.py`.  The reference lays a
batch out on a 1-D `Mesh` over the 'batch' axis and lets `shard_map` run
each verify lane on every chip's shard, the valid count summed by
`psum` (its answer to Fabric's goroutine pool, validator.go:194-209).
The port has no SPMD compiler.  A `DeviceMesh` is a list of shards, each
a `torch.device` and, on CUDA, a `torch.cuda.Stream` of its own created
on that device.  A sharded lane

* splits the batch into contiguous near-equal shards (the sizes of
  `torch.tensor_split`: the first B mod k shards one longer);
* moves each shard's columns to its device and launches the port's
  existing wrapper for the lane (KP2, KP3, KE5, KE6, KB8) under the
  shard's stream, with that device's replica of every replicated
  argument, then records an event;
* makes the first shard's device's current stream wait on every shard's
  event, concatenates the verdicts there in order, and sums the shards'
  counts (the counterpart of `psum`).

A device may appear more than once: `["cuda:0"] * 2` is two shards on
one card, each on its own stream, and `["cpu"] * 8` is how the tests get
eight shards (on CPU shards the same code runs the kernels' plain
versions, one after another).  Nothing is padded: the reference pads
only because `shard_map` needs a multiple of the mesh size
(`pad_batch`), and an empty shard launches nothing.

Every argument's placement comes from one regex rule table, as in the
reference: REPLICATED (one copy per distinct device: table banks, G's
and B's tables, the idemix lines and flags) or a `Split` of the batch
along an axis, the last one of (8, B) word arrays and axis 0 of (B,)
vectors.  A slot vector stays on the host: the fixed-key wrappers check
its range there before they copy it to the device.  The reference's
`sign_rows` rule has no counterpart, because the port has no (R, C)
grids (ROADMAP C5).

Streams: every shard stream first waits on its device's current stream,
so it sees whatever the caller enqueued there (table writes, line
uploads).  A tensor read on a shard stream that was not allocated there
is marked with `record_stream`, so the caching allocator does not hand
its memory out again before the shard's kernels are done with it.

`allocate_devices` and `carve_submeshes` are copied from the reference
(pure Python); `parallel/placement.py` schedules channels onto the spans
they carve.
"""

from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device, visible_devices, with_index
from ..ops import bn254, ed25519, p256, p256_fixed

BATCH_AXIS = "batch"
REPLICATED = "replicated"


class Split(NamedTuple):
    """A split of the batch: entries lo:hi of shard i along `axis`;
    `host` keeps the shard on the CPU."""
    axis: int
    host: bool = False


# -- partition rules ---------------------------------------------------------
# First regex match wins.
PARTITION_RULES = (
    (r"(bank|lines|flags|table)", REPLICATED),
    (r"(row_key|slot)", Split(0, host=True)),
    (r"(sign|bits)", Split(0)),
    (r"(words|rows|limbs)", Split(-1)),
)

# argument names per lane, in the order of the port's wrapper; the
# reference's names, plus the port's replicated tables of G and B (the
# reference keeps them as constants inside its programs).  row_key is the
# port's slot per signature (the reference's slot per row of its grid).
LANE_ARGS = {
    "p256": ("qx_words", "qy_words", "r_words", "s_words", "e_words",
             "g_table"),
    "p256-rows": ("r_rows", "s_rows", "e_rows", "row_key", "table_bank",
                  "g_table"),
    "ed25519": ("ay_words", "a_sign", "ry_words", "r_sign", "s_words",
                "k_words", "b_table"),
    "ed25519-rows": ("ry_rows", "r_sign_rows", "s_rows", "k_rows",
                     "row_key", "table_bank", "b_table"),
    "idemix-pair": ("w_flags", "w_lines", "line_slot", "x1_limbs",
                    "y1_limbs", "x2_limbs", "y2_limbs"),
}


def match_partition_rules(rules, names):
    """Resolve each argument name to its placement via the first
    matching regex rule; unmatched names are a hard error (a batch input
    taken for a replicated one would verify the whole batch on every
    shard)."""
    specs = []
    for name in names:
        for pat, spec in rules:
            if re.search(pat, name):
                specs.append(spec)
                break
        else:
            raise ValueError(f"no partition rule matches arg {name!r}")
    return tuple(specs)


def lane_specs(lane: str):
    """The placements of a named verify lane's arguments."""
    return match_partition_rules(PARTITION_RULES, LANE_ARGS[lane])


# -- the mesh ----------------------------------------------------------------

@dataclass(frozen=True)
class DeviceMesh:
    """A 1-D mesh over the batch axis: shard i runs on devices[i], on
    streams[i] (a CUDA stream of its own on that device; None for a CPU
    shard)."""
    devices: tuple
    streams: tuple

    def __len__(self) -> int:
        return len(self.devices)

    @property
    def distinct_devices(self) -> tuple:
        """Each device once, in the order of first appearance: where the
        replicated arguments need a copy."""
        return tuple(dict.fromkeys(self.devices))


def make_mesh(devices=None) -> DeviceMesh:
    """1-D mesh over all visible CUDA devices (`visible_devices()`) or
    over the given list, repeats allowed; one new CUDA stream per CUDA
    shard."""
    devs = tuple(with_index(resolve_device(d)) for d in (
        visible_devices() if devices is None else devices))
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return DeviceMesh(devs, tuple(
        torch.cuda.Stream(device=d) if d.type == "cuda" else None
        for d in devs))


# -- sub-mesh carving (per-channel device placement) -------------------------

def allocate_devices(n_devices: int, weights) -> list:
    """Split `n_devices` into one power-of-two share per weight.

    Greedy doubling: every consumer starts at 1 device, then the most
    under-served one (highest weight per device) doubles while devices
    remain.  Power-of-two shares keep each channel's shard sizes stable
    across rebalances; deterministic tie-break by position.  Returns
    sizes summing to <= n_devices.
    """
    k = len(weights)
    if k == 0:
        return []
    if k > n_devices:
        raise ValueError(f"{k} consumers > {n_devices} devices")
    sizes = [1] * k
    free = n_devices - k
    while True:
        best, best_load = None, 0.0
        for i, w in enumerate(weights):
            if sizes[i] > free:
                continue
            load = max(float(w), 1e-9) / sizes[i]
            if load > best_load:
                best, best_load = i, load
        if best is None:
            return sizes
        free -= sizes[best]
        sizes[best] *= 2


def carve_submeshes(devices, weights) -> list:
    """Disjoint contiguous sub-meshes over `devices`, one per weight,
    sized by `allocate_devices`."""
    sizes = allocate_devices(len(devices), weights)
    out, lo = [], 0
    for sz in sizes:
        out.append(make_mesh(list(devices)[lo:lo + sz]))
        lo += sz
    return out


# -- the sharded lanes -------------------------------------------------------

def shard_bounds(n: int, k: int) -> list:
    """[(lo, hi)] of k contiguous shards of n items, `torch.tensor_split`'s
    sizes: the first n mod k shards one longer."""
    q, r = divmod(n, k)
    out, lo = [], 0
    for i in range(k):
        hi = lo + q + (i < r)
        out.append((lo, hi))
        lo = hi
    return out


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.ascontiguousarray(x))


def _to_shard(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A contiguous copy of x on dev, on dev's current stream (a shard
    stream here); from the host through pinned memory, one host copy."""
    if x.device.type == "cpu" and dev.type == "cuda":
        pinned = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        pinned.copy_(x)
        return pinned.to(dev, non_blocking=True)
    x = x.contiguous()
    return x if x.device == dev else x.to(dev)


def _on_shard(dev: torch.device, stream):
    """The context a shard launches in: its device and stream current
    (the wrappers launch on `torch.cuda.current_stream(dev)`); none for
    a CPU shard."""
    if stream is None:
        return contextlib.nullcontext()
    ctx = contextlib.ExitStack()
    ctx.enter_context(torch.cuda.device(dev))
    ctx.enter_context(torch.cuda.stream(stream))
    return ctx


def _sharded(mesh: DeviceMesh, lane: str, mod, name: str, **kwargs):
    """fn(*args) -> (verdicts (B,) bool, valid count) over `mesh` for the
    lane's arguments (`LANE_ARGS[lane]`); the lane's wrapper is
    `mod.name(*shard_args, **kwargs)` -> (b,) bool, looked up at each
    call.  A replicated argument is one tensor, copied to every other
    distinct device on each call, or a {device: tensor} map holding each
    device's replica.  fn.shard_launches[i] adds up what the wrapper's own
    launch count gained across shard i's calls."""
    names = LANE_ARGS[lane]
    specs = lane_specs(lane)

    def fn(*args):
        if len(args) != len(names):
            raise TypeError(f"{lane}: {len(names)} arguments expected "
                            f"({', '.join(names)}), got {len(args)}")
        args = [a if spec == REPLICATED and isinstance(a, dict)
                else _as_tensor(a) for a, spec in zip(args, specs)]
        sizes = {a.shape[spec.axis] for a, spec in zip(args, specs)
                 if spec != REPLICATED}
        if len(sizes) != 1:
            raise ValueError(f"{lane}: batch sizes differ: {sorted(sizes)}")
        n = sizes.pop()
        dev0 = mesh.devices[0]
        # each distinct device's replica of the replicated arguments,
        # copied on that device's current stream
        reps = {}
        for dev in mesh.distinct_devices:
            reps[dev] = [(a[dev] if isinstance(a, dict) else
                          _to_shard(a, dev)) if spec == REPLICATED else None
                         for a, spec in zip(args, specs)]
        for dev, stream in zip(mesh.devices, mesh.streams):
            if stream is not None:
                stream.wait_stream(torch.cuda.current_stream(dev))
        shards = []
        for i, ((lo, hi), dev, stream) in enumerate(zip(
                shard_bounds(n, len(mesh)), mesh.devices, mesh.streams)):
            if hi == lo:
                continue
            shard_args = [rep if spec == REPLICATED else
                          a.narrow(spec.axis % a.dim(), lo, hi - lo)
                          for a, spec, rep in zip(args, specs, reps[dev])]
            done = None
            with _on_shard(dev, stream):
                if stream is not None:
                    for a in shard_args:
                        if a.is_cuda:
                            a.record_stream(stream)
                launch = getattr(mod, name)
                before = getattr(launch, "launches", 0)
                out = launch(*[a if spec == REPLICATED or spec.host
                               else _to_shard(a, dev)
                               for a, spec in zip(shard_args, specs)],
                             **kwargs)
                fn.shard_launches[i] += getattr(launch, "launches", 0) - before
                count = out.sum(dtype=torch.int64)
                if stream is not None:
                    done = torch.cuda.Event()
                    done.record(stream)
            shards.append((out, count, done))
        if not shards:
            return (torch.zeros(0, dtype=torch.bool, device=dev0),
                    torch.zeros((), dtype=torch.int64, device=dev0))
        # the gather: dev0's current stream (and, for a shard on another
        # device, that device's current stream, which runs the copy)
        # waits on each shard's event before it reads the shard's output
        outs, counts = [], []
        for out, count, done in shards:
            if done is not None:
                readers = {dev0, out.device}
                for d in readers:
                    s = torch.cuda.current_stream(d)
                    s.wait_event(done)
                    out.record_stream(s)
                    count.record_stream(s)
            outs.append(out.to(dev0))
            counts.append(count.to(dev0))
        return torch.cat(outs), torch.stack(counts).sum()

    fn.shard_launches = [0] * len(mesh)
    return fn


def sharded_p256_verify(mesh: DeviceMesh, require_low_s: bool = True):
    """Sharded ECDSA-P256 batch verifier (KP2): fn(qx, qy, r, s, e,
    g_table) -> (verdicts (B,), valid_count); words (8, B) uint32."""
    return _sharded(mesh, "p256", p256, "p256_verify",
                    require_low_s=require_low_s)


def sharded_p256_rows_verify(mesh: DeviceMesh, require_low_s: bool = True):
    """Sharded multikey P-256 verifier over a replicated comb-table bank
    (KP3): fn(r, s, e, row_key, table_bank, g_table) -> (verdicts,
    valid_count); row_key (B,) int32 slots on the host."""
    return _sharded(mesh, "p256-rows", p256_fixed, "p256_verify_rows",
                    require_low_s=require_low_s)


def sharded_ed25519_rows_verify(mesh: DeviceMesh):
    """Sharded multikey Ed25519 verifier over a replicated bank of -A
    tables (KE6): fn(ry, r_sign, s, k, row_key, table_bank, b_table)."""
    return _sharded(mesh, "ed25519-rows", ed25519, "ed25519_verify_rows")


def sharded_ed25519_verify(mesh: DeviceMesh):
    """Sharded Ed25519 batch verifier (KE5): fn(ay, a_sign, ry, r_sign,
    s, k, b_table) -> (verdicts (B,), valid_count)."""
    return _sharded(mesh, "ed25519", ed25519, "ed25519_verify")


def sharded_idemix_pair_verify(mesh: DeviceMesh):
    """Sharded BN254 dual-pairing batch check (KB8): fn(flags, lines,
    line_slot, x1, y1, x2, y2) -> (verdicts (B,), valid_count); the line
    tensor and its flags replicate, the (8, B) coordinates and the (B,)
    slots shard."""
    return _sharded(mesh, "idemix-pair", bn254, "bn254_pairing_check")
