"""Fraud-proof gossip: the message types.

Counterpart of `fabric_tpu/byzantine/proofgossip.py`, so far only its
two gossip message types, spelled as the reference spells them, which
`gossip/node.py` routes to a wired `ProofGossip` (none is wired until
`ProofGossip` itself is ported).
"""

MSG_FRAUD_PROOF = "gossip.fraud_proof"
MSG_PARDON = "gossip.pardon"
