"""Endorsement plane: proposals, simulation, endorsement signing.

Reference parity (SURVEY.md §3.3): core/endorser ProcessProposal
(endorser.go:296) — unpack + validate proposal, ACL check, simulate
against chaincode, endorse via the ESCC plugin — plus the client-side
proposal/transaction assembly from protoutil/txutils.go.

Counterpart of `fabric_tpu/endorser`, the same code on the port's
imports.
"""

from .proposal import (
    Proposal,
    ProposalResponse,
    ResponseMismatchError,
    assemble_transaction,
    signed_proposal,
)
from .endorser import Endorser, EndorserError

__all__ = ["Proposal", "ProposalResponse", "ResponseMismatchError",
           "assemble_transaction", "signed_proposal", "Endorser",
           "EndorserError"]
