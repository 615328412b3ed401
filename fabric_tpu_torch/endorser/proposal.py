"""Proposal wire types + client-side assembly.

Reference parity: peer.Proposal/SignedProposal/ProposalResponse
(protoutil/{proputils,txutils}.go).  The client signs a proposal, fans it
out to endorsers, checks all returned simulation payloads are identical,
and assembles the creator-signed transaction envelope
(protoutil.CreateSignedTx checks at txutils.go: all endorsements must be
over the same ProposalResponsePayload).

Counterpart of `fabric_tpu/endorser/proposal.py`, the same code on the
port's imports.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

from fabric_tpu_torch.protocol import Envelope, Transaction, TransactionAction
from fabric_tpu_torch.protocol.build import (
    compute_txid,
    make_header,
    new_nonce,
    proposal_hash,
    signed_envelope,
)
from fabric_tpu_torch.protocol.types import (
    ChaincodeAction,
    Endorsement,
    Header,
    TX_ENDORSER,
)
from fabric_tpu_torch.utils import serde


@dataclass(frozen=True)
class Proposal:
    """peer.Proposal: header + invocation spec."""
    header: Header
    chaincode_id: str
    fn: str
    args: Tuple[bytes, ...]

    def to_bytes(self) -> bytes:
        return serde.encode({
            "header": self.header.to_dict(),
            "chaincode_id": self.chaincode_id,
            "fn": self.fn,
            "args": list(self.args),
        })

    @staticmethod
    def from_bytes(raw: bytes) -> "Proposal":
        d = serde.decode(raw)
        return Proposal(Header.from_dict(d["header"]), d["chaincode_id"],
                        d["fn"], tuple(d["args"]))

    def hash(self) -> bytes:
        ch = self.header.channel_header
        return proposal_hash(ch.channel_id, ch.txid, self.chaincode_id,
                             [self.fn.encode(), *self.args])


@dataclass(frozen=True)
class SignedProposal:
    proposal_bytes: bytes
    signature: bytes

    def proposal(self) -> Proposal:
        return Proposal.from_bytes(self.proposal_bytes)


@dataclass(frozen=True)
class ProposalResponse:
    """peer.ProposalResponse: status + endorsed payload + endorsement."""
    status: int
    message: str
    payload: bytes                    # TransactionAction.endorsed_bytes()
    endorsement: Endorsement = None   # None when status != 200


class ResponseMismatchError(Exception):
    """Endorsers returned divergent simulation results."""


def signed_proposal(channel_id: str, chaincode_id: str, fn: str,
                    args: Sequence[bytes], signer,
                    nonce: bytes = None) -> SignedProposal:
    """Client step 1: build + sign a proposal (CreateChaincodeProposal)."""
    nonce = new_nonce() if nonce is None else nonce
    header = make_header(TX_ENDORSER, channel_id, signer.serialize(), nonce)
    prop = Proposal(header, chaincode_id, fn, tuple(args))
    raw = prop.to_bytes()
    return SignedProposal(raw, signer.sign(raw))


def assemble_transaction(sp: SignedProposal,
                         responses: Sequence[ProposalResponse],
                         signer) -> Envelope:
    """Client step 2 (protoutil.CreateSignedTx): all endorsement payloads
    must match bit-for-bit; the envelope reuses the proposal's nonce so
    txid stays bound to the original proposal."""
    prop = sp.proposal()
    bad = [r for r in responses if r.status != 200]
    if bad:
        # any failed response aborts client-side (CreateSignedTx rejects
        # non-200): submitting under-endorsed txs burns ordering work just
        # to fail policy at commit
        raise ResponseMismatchError(
            f"{len(bad)}/{len(responses)} endorsers failed: "
            f"{bad[0].message!r}")
    ok = list(responses)
    if not ok:
        raise ResponseMismatchError("no proposal responses")
    payloads = {r.payload for r in ok}
    if len(payloads) != 1:
        raise ResponseMismatchError(
            f"{len(payloads)} distinct simulation payloads across "
            f"{len(ok)} endorsements")
    payload = ok[0].payload
    d = serde.decode(payload)
    ta = TransactionAction(d["proposal_hash"],
                           ChaincodeAction.from_dict(d["action"]),
                           tuple(r.endorsement for r in ok))
    if ta.endorsed_bytes() != payload:
        raise ResponseMismatchError("endorsed payload does not round-trip")
    sh = prop.header.signature_header
    if signer.serialize() != sh.creator:
        raise ResponseMismatchError("assembler is not the proposal creator")
    tx = Transaction((ta,))
    return signed_envelope(TX_ENDORSER, prop.header.channel_header.channel_id,
                           tx.to_dict(), signer, nonce=sh.nonce)
