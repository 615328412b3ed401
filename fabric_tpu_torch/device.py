"""Device selection for the port's entry points.

Entry points run on the CUDA device unless the caller names another.
They never move to the CPU on their own: with no device given and no
CUDA present, they raise.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` (None means "cuda") as a torch.device; raises RuntimeError
    when a CUDA device is asked for and torch cannot see one."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fabric_tpu_torch needs a CUDA device (torch.cuda.is_available() "
            "is False); pass device='cpu' to run the plain PyTorch versions")
    return dev


def with_index(dev: torch.device) -> torch.device:
    """dev with its index: "cuda" is cuda:<the current device>, so that
    two names of one device compare equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def visible_devices() -> list:
    """Every CUDA device torch can see, [cuda:0 ... cuda:k-1] (the
    counterpart of `jax.devices()`); raises RuntimeError without CUDA,
    as `resolve_device` does.  A mesh of CPU shards is asked for by name
    (`parallel.mesh.make_mesh(["cpu"] * k)`)."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
