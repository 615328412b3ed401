"""Byzantine detection-and-containment plane of the port.

Counterpart of `fabric_tpu/byzantine`, so far only the two gossip
message types of its fraud-proof plane (`proofgossip`), which the
gossip node's dispatch names.  The witness log, the monitor, the
quarantine registry and `ProofGossip` come with a later slice; until
then no monitor is wired, and `gossip.state.GossipState.monitor` and
`.proofs` stay None.
"""
