"""The ops plane of the port (counterpart of `fabric_tpu/ops_plane`):
so far its profiling surface."""
