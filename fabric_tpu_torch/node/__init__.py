"""Node tooling of the port (counterpart of `fabric_tpu/node`): so far
its warmup, the orderer's identity loaders (`orderer`) and the peer's
deliver client (`peer`)."""
