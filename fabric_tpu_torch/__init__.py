"""PyTorch/CUDA port of the TPU-native permissioned ledger framework.

A second package beside `fabric_tpu/`, which stays the reference.  The
port keeps its own copy of every module it needs and never imports JAX
or `fabric_tpu`.  Its layout follows the reference's (`bccsp/`, `ops/`,
`crypto/`), so each module's counterpart sits at the same path there.

Slices 1 to 3 cover the BCCSP provider boundary: `bccsp.init_factories`
-> `CudaProvider.batch_verify_async` -> `resolve()`, down to the
hand-written Hopper kernels in `ops/csrc/` for both P-256 lanes and both
Ed25519 lanes.  Entry points run on the CUDA device unless
the caller passes `device="cpu"`, which selects each kernel's plain
PyTorch version.
"""
