"""Warmup: build every kernel and extension, then run each lane once.

Counterpart of `fabric_tpu/node/warmup.py`.  The reference pre-compiles
its XLA programs into a persistent cache before a node serves its first
block.  The port's first-use cost is of another kind: `nvcc` builds each
kernel library (`ops/_build.py`) and `cc` the C parser and the CPython
extensions (`native/`), seconds each, and a lane's first launch loads
its library.  `warmup` pays all of it up front:

* on the card, builds every stale kernel library, one `nvcc` per
  source, all started together (`_build.build_all`), and loads each
  (`_build.load` of every name in `SIGNATURES`); on the CPU no kernel is
  built or loaded, since the lanes run their plain versions, and the
  result says so;
* builds and loads the C parser and the extensions where stale;
* runs each lane once through the factory's provider: KP2 (one-off
  keys), KP3 (keys whose tables it builds first through
  `key_tables.get_or_build`), KE5, KE6 (likewise, `ed_key_tables`), and
  KB8 through `idemix_pair_probe`;
* writes its manifest, the libraries with their seconds per build and
  the seconds per lane, into `build/kernels/warmup.json` (git-ignored).

The per-key table builds of the first real block are not paid here: its
keys are not known yet.

    python -m fabric_tpu_torch.node.warmup [--buckets 64] [--device cpu]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import random
import sys
import time
from pathlib import Path

SCHEMES = ("p256", "p256-rows", "ed25519", "ed25519-rows", "idemix")
MANIFEST = "warmup.json"


def gen_p256_sigs(n: int, n_keys: int, seed: int = 2026):
    """n low-S P-256 items under n_keys keys in turn (the keys, too, come
    from the seed)."""
    from .. import crypto
    from ..bccsp import SCHEME_P256, VerifyItem
    from ..ops import p256

    rng = random.Random(seed)
    keys = [crypto.p256_key_from_scalar(rng.randrange(1, p256.N))
            for _ in range(n_keys)]
    pubs = [crypto.p256_public_bytes(k) for k in keys]
    items = []
    for i in range(n):
        digest = hashlib.sha256(rng.randbytes(48)).digest()
        r, s = crypto.p256_sign_digest(keys[i % n_keys], digest)
        items.append(VerifyItem(SCHEME_P256, pubs[i % n_keys],
                                crypto.encode_dss_signature(
                                    r, min(s, p256.N - s)), digest))
    return items


def gen_ed25519_sigs(n: int, n_keys: int = 4, seed: int = 7):
    """n Ed25519 items over 48-byte messages under n_keys keys in turn."""
    from .. import crypto
    from ..bccsp import SCHEME_ED25519, VerifyItem

    rng = random.Random(seed)
    keys = [crypto.ed25519_key_from_seed(rng.randbytes(32))
            for _ in range(n_keys)]
    pubs = [crypto.ed25519_public_bytes(k) for k in keys]
    items = []
    for i in range(n):
        msg = rng.randbytes(48)
        items.append(VerifyItem(SCHEME_ED25519, pubs[i % n_keys],
                                crypto.ed25519_sign(keys[i % n_keys], msg),
                                msg))
    return items


def build_all(cuda: bool) -> dict:
    """Build what is stale and load everything -> {library: seconds of
    its build, 0 when it was up to date}; the kernel libraries only on
    the card."""
    from .. import native
    from ..ops import _build
    out = {}
    if cuda:
        for name, info in _build.build_all().items():
            out[name] = info["seconds"]
            _build.load(name)
    t0 = time.perf_counter()
    stale = native._stale("der", native.lib_path("der"))
    native.load("der")
    out["der"] = time.perf_counter() - t0 if stale else 0.0
    for ext in native.EXTENSIONS:
        t0 = time.perf_counter()
        stale = native._stale(ext, native.extension_path(ext))
        native.extension(ext)
        out[f"_{ext}"] = time.perf_counter() - t0 if stale else 0.0
    return out


def warm_lanes(provider, buckets, schemes) -> dict:
    """Each lane once per bucket through `provider` -> {lane@bucket:
    seconds}; raises if a lane's verdicts are not all True."""
    import numpy as np

    def run(label, items):
        t0 = time.perf_counter()
        got = provider.batch_verify(items)
        timings[label] = time.perf_counter() - t0
        if not np.asarray(got).all():
            raise RuntimeError(f"warmup: {label} rejected a valid signature")

    timings = {}
    for b in buckets:
        if "p256" in schemes:            # one-off keys: KP2
            run(f"p256@{b}", gen_p256_sigs(b, n_keys=b))
        if "p256-rows" in schemes:       # resident tables: KP3
            items = gen_p256_sigs(b, n_keys=2, seed=5)
            for it in items[:2]:
                provider.key_tables.get_or_build(it.pubkey)
            run(f"p256-rows@{b}", items)
        if "ed25519" in schemes:         # one-off keys: KE5
            run(f"ed25519@{b}", gen_ed25519_sigs(b, n_keys=b))
        if "ed25519-rows" in schemes:    # resident tables: KE6
            items = gen_ed25519_sigs(b, n_keys=2, seed=9)
            for it in items[:2]:
                provider.ed_key_tables.get_or_build(it.pubkey)
            run(f"ed25519-rows@{b}", items)
        if "idemix" in schemes:          # KB8, the probe's green checks
            fn, green, _red = provider.idemix_pair_probe(b)
            t0 = time.perf_counter()
            ok = bool(fn(*green).all())
            timings[f"idemix-pair@{b}"] = time.perf_counter() - t0
            if not ok:
                raise RuntimeError("warmup: the idemix probe's green "
                                   "checks failed")
    return timings


def warmup(buckets=(64,), schemes=SCHEMES, device=None,
           verbose: bool = True, manifest_dir=None) -> dict:
    """Build, load and run each lane once on `device` (default the card;
    raises without it; "cpu" builds no kernel) -> the manifest it wrote
    to `manifest_dir` (default `build/kernels/`)."""
    from ..bccsp.factory import FactoryOpts, init_factories
    from ..device import resolve_device
    from ..ops import _build

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    builds = build_all(cuda)
    build_s = time.perf_counter() - t0
    provider = init_factories(FactoryOpts(default="CUDA", device=device))
    lanes = warm_lanes(provider, buckets, schemes)
    manifest = {
        "device": str(dev),
        "builds_s": builds, "build_wall_s": build_s,
        "kernels": ("built and loaded" if cuda else
                    "none built: on the CPU the lanes run their plain "
                    "PyTorch versions"),
        "lanes_s": lanes, "buckets": list(buckets), "schemes": list(schemes),
        "completed_unix": time.time(),
    }
    d = Path(manifest_dir) if manifest_dir is not None else _build.BUILD_DIR
    d.mkdir(parents=True, exist_ok=True)
    (d / MANIFEST).write_text(json.dumps(manifest, indent=1))
    if verbose:
        print(json.dumps(manifest), flush=True)
    return manifest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fabric-tpu-torch-warmup")
    ap.add_argument("--buckets", default="64",
                    help="comma-separated batch sizes to run each lane at")
    ap.add_argument("--schemes", default=",".join(SCHEMES))
    ap.add_argument("--device", default=None,
                    help="default: the card; cpu runs the plain versions "
                         "and builds no kernel")
    args = ap.parse_args(argv)
    warmup([int(b) for b in args.buckets.split(",")],
           tuple(args.schemes.split(",")), device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
