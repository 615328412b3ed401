"""Node tooling of the port (counterpart of `fabric_tpu/node`): so far
its warmup."""
