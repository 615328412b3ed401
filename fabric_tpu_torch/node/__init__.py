"""Runnable node processes (server binaries) for the framework.

Counterpart of `fabric_tpu/node`: the peer is `python -m
fabric_tpu_torch.node.peer <config.json>`, composed from the port's
library planes, with `node.provision` as the cryptogen/configtxgen
equivalent; also the warmup (`warmup`), the cluster trace collector
(`tracecollect`) and the orderer's identity loaders (`orderer`; the
runnable orderer comes with the port's ordering service).

`provision_orderers` is exported as the reference's package does, but
imported on first use: `node.provision` imports the config plane, whose
serde loads its native extension, and `node.warmup` (imported through
this package) must be the first to build the extensions it times.
"""

__all__ = ["provision_orderers"]


def __getattr__(name):
    if name == "provision_orderers":
        from .provision import provision_orderers
        return provision_orderers
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
