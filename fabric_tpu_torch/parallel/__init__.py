"""Multi-device lanes and per-channel placement (counterpart of
`fabric_tpu/parallel`)."""
