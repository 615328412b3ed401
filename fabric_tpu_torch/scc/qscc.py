"""qscc — ledger query system contract.

Reference parity: Fabric's core/scc/qscc/query.go — GetChainInfo,
GetBlockByNumber, GetBlockByHash, GetTransactionByID, with the read ACL
evaluated against the channel Readers policy before serving.

Counterpart of `fabric_tpu/scc/qscc.py`, the same code on the port's
imports; with an `acl` (the port's `policy.ACLProvider`) each query
checks its own `qscc/<Function>` resource.
"""

from __future__ import annotations

from typing import Dict, Optional

from fabric_tpu_torch.policy import SignedData


class QsccError(Exception):
    pass


class Qscc:
    """Bound to one channel's block store (+ optional ACL hooks)."""

    def __init__(self, channel_id: str, blockstore,
                 authorize=None, acl=None):
        self.channel_id = channel_id
        self.blockstore = blockstore
        # authorize: callable(SignedData|None) raising on deny — usually
        # ChainSupport.authorize_read (the Readers policy).  When an
        # aclmgmt provider is given instead, each method checks its OWN
        # named resource (core/scc/qscc/query.go per-function ACLs via
        # core/aclmgmt resources), so a config-tx ACL change retargets
        # individual queries.
        self.acl = acl
        self.authorize = authorize or (lambda sd: None)

    def _check(self, resource: str, signed) -> None:
        if self.acl is not None:
            self.acl.check(resource, signed)
        else:
            self.authorize(signed)

    def get_chain_info(self, signed: Optional[SignedData] = None) -> Dict:
        self._check("qscc/GetChainInfo", signed)
        info = self.blockstore.chain_info()
        return {"height": info.height,
                "current_hash": info.current_hash,
                "previous_hash": info.previous_hash}

    def get_block_by_number(self, number: int,
                            signed: Optional[SignedData] = None):
        self._check("qscc/GetBlockByNumber", signed)
        try:
            return self.blockstore.get_by_number(number)
        except Exception as exc:
            raise QsccError(f"block {number}: {exc}") from exc

    def get_block_by_hash(self, block_hash: bytes,
                          signed: Optional[SignedData] = None):
        self._check("qscc/GetBlockByHash", signed)
        try:
            return self.blockstore.get_by_hash(block_hash)
        except Exception as exc:
            raise QsccError(f"block by hash: {exc}") from exc

    def get_transaction_by_id(self, txid: str,
                              signed: Optional[SignedData] = None):
        self._check("qscc/GetTransactionByID", signed)
        try:
            block = self.blockstore.get_by_txid(txid)
        except Exception as exc:
            raise QsccError(f"transaction {txid!r}: {exc}") from exc
        from fabric_tpu_torch.protocol import Envelope
        for env_bytes in block.data:
            env = Envelope.deserialize(env_bytes)
            if env.header().channel_header.txid == txid:
                return env
        raise QsccError(f"transaction {txid!r} not found")
