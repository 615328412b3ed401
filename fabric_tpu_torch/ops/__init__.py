"""Device arithmetic: the field layer, P-256 and Edwards25519 curve
layers and the table banks, each kernel beside its plain PyTorch
version.  CUDA sources live in `csrc/` and are built on
first use by `_build`."""
