"""BCCSP factory: config-gated provider selection.

Counterpart of `fabric_tpu/bccsp/factory.py` (`FactoryOpts`,
`init_factories`, `get_default`, `set_default`, `get_placement`,
`provider_for_channel`).  The kinds are `SW` and `CUDA`.  `use_mesh`,
`placement` and `mesh_devices` follow the reference's rules: a mesh or
a placement scheduler is built only when more than one CUDA device is
visible (`device.visible_devices`), so on one card `use_mesh=True` gives
the single-device provider.  `degrade` differs from the reference's
auto rule, which wraps its device provider by default: here every kind
is fail-stop unless the caller asks for `degrade=True`, so a failed
launch raises instead of moving the batch to the host (ROADMAP C20).
Asked for, the provider (and, under placement, each span's provider)
is wrapped in `degrade.DegradingProvider` over a software fallback.
The reference's XLA compile cache has no counterpart (the kernel
build directory `build/kernels/` plays its part, filled by
`node/warmup.py`).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

from .provider import Provider
from .sw import SoftwareProvider

logger = logging.getLogger("fabric_tpu_torch.bccsp.factory")

_default: Optional[Provider] = None
_placement = None                # PlacementScheduler when opts.placement


@dataclass
class FactoryOpts:
    """The BCCSP config block (core.yaml `bccsp:` equivalent)."""
    default: str = "CUDA"            # "SW" | "CUDA"
    require_low_s: bool = True
    device: Optional[str] = None     # CUDA provider's device (None: "cuda")
    use_mesh: bool = False           # shard batches over all visible devices
    placement: bool = False          # per-channel device placement: carve
    #                                  the devices into spans sized by
    #                                  channel queue depth (parallel/placement)
    mesh_devices: Optional[int] = None   # cap the device count the mesh /
    #                                  placement scheduler may use (None: all)
    degrade: bool = False            # wrap in DegradingProvider (breaker
    #                                  + SW fallback on device sickness).
    #                                  Off: fail-stop, a device fault
    #                                  raises (the reference's auto rule
    #                                  turns it on for its device kind)


def init_factories(opts: Optional[FactoryOpts] = None) -> Provider:
    """Initialize the default provider (InitFactories equivalent)."""
    global _default, _placement
    opts = opts or FactoryOpts()
    kind = opts.default.upper()
    _placement = None
    if kind == "SW":
        _default = SoftwareProvider(require_low_s=opts.require_low_s)
    elif kind == "CUDA":
        from .cuda import CudaProvider
        devices = []
        if opts.use_mesh or opts.placement:
            from ..device import visible_devices
            devices = visible_devices()
            if opts.mesh_devices:
                devices = devices[:opts.mesh_devices]
        mesh = None
        if opts.use_mesh and len(devices) > 1:
            from ..parallel import mesh as meshmod
            mesh = meshmod.make_mesh(devices)
        _default = CudaProvider(require_low_s=opts.require_low_s,
                                device=None if mesh else opts.device,
                                mesh=mesh)
        if opts.placement and len(devices) > 1:
            from ..parallel.placement import PlacementScheduler
            low_s = opts.require_low_s

            def factory(m, device=None):
                return CudaProvider(require_low_s=low_s, mesh=m,
                                    device=device)
            wrap = None
            if opts.degrade:
                from .degrade import DegradingProvider

                def wrap(p):
                    return DegradingProvider(
                        p, SoftwareProvider(require_low_s=low_s))
            _placement = PlacementScheduler(devices=devices,
                                            provider_factory=factory,
                                            wrap=wrap)
    else:
        raise ValueError(f"unknown BCCSP provider {opts.default!r}")
    if opts.degrade:
        from .degrade import DegradingProvider
        _default = DegradingProvider(
            _default, SoftwareProvider(require_low_s=opts.require_low_s))
    logger.info("BCCSP default provider: %s", _default.name)
    return _default


def get_placement():
    """The PlacementScheduler, or None when placement is off / SW."""
    return _placement


def provider_for_channel(channel_id: str,
                         demand: Optional[int] = None) -> Optional[Provider]:
    """Per-channel provider from the placement scheduler, or None when
    placement is disabled (callers fall back to the default provider).
    `demand` is the caller's current queue depth: it sizes the channel's
    device span on the next carve."""
    if _placement is None:
        return None
    return _placement.provider_for(channel_id, demand=demand)


def get_default() -> Provider:
    """GetDefault equivalent: lazily initializes a CUDA provider."""
    if _default is None:
        init_factories()
    return _default


def set_default(p: Provider) -> None:
    global _default
    _default = p
