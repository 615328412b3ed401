"""Broadcast ingestion: envelope -> filters -> consenter.

Reference parity: orderer/common/broadcast/broadcast.go —
Handle (:66) reads envelopes off the stream, ProcessMessage (:136)
classifies + runs msgprocessor filters, then calls processor.Order /
Configure (:176) on the channel's chain.  Streaming is a transport
concern here; `handle` takes one envelope and returns a response the
way each stream iteration does.

Counterpart of `fabric_tpu/orderer/broadcast.py`, whole, on the port's
imports: each envelope's creator goes through the channel processor's
signature filter, on the provider the channel was given.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

from fabric_tpu_torch.ops_plane import tracing
from fabric_tpu_torch.orderer.consensus import ChainHaltedError
from fabric_tpu_torch.orderer.msgprocessor import MsgClass, MsgProcessorError
from fabric_tpu_torch.orderer.raft import NotLeaderError
from fabric_tpu_torch.protocol import Envelope

STATUS_SUCCESS = 200
STATUS_BAD_REQUEST = 400
STATUS_FORBIDDEN = 403
STATUS_NOT_FOUND = 404
STATUS_UNAVAILABLE = 503


@dataclass(frozen=True)
class BroadcastResponse:
    status: int
    info: str = ""
    leader_hint: int = 0   # raft id of the current leader, when known


class BroadcastHandler:
    """broadcast.Handler bound to a registrar of channels."""

    def __init__(self, registrar):
        self.registrar = registrar

    def handle(self, env: Envelope,
               attest: Optional[str] = None,
               attestor=None) -> BroadcastResponse:
        resp = None
        with tracing.tracer.start_span("orderer.broadcast",
                                       require_parent=True) as span:
            resp = self._handle_inner(env, span, attest, attestor)
            if span.recording:
                span.set_attribute("status", resp.status)
                if resp.status != STATUS_SUCCESS:
                    span.status = "ERROR"
        return resp

    def _handle_inner(self, env: Envelope, span,
                      attest: Optional[str] = None,
                      attestor=None) -> BroadcastResponse:
        try:
            channel_id = env.header().channel_header.channel_id
        except Exception:
            return BroadcastResponse(STATUS_BAD_REQUEST,
                                     "undecodable envelope header")
        if span.recording:
            span.set_attribute("channel", channel_id)
        support = self.registrar.get(channel_id)
        if support is None:
            return BroadcastResponse(STATUS_NOT_FOUND,
                                     f"unknown channel {channel_id!r}")
        try:
            cls = support.processor.process(env, attest=attest,
                                            attestor=attestor)
        except MsgProcessorError as e:
            return BroadcastResponse(STATUS_FORBIDDEN, str(e))
        try:
            if cls is MsgClass.CONFIG:
                support.chain.configure(env)
            else:
                support.chain.order(env)
        except NotLeaderError as e:
            # SERVICE_UNAVAILABLE + leader hint so clients re-submit there
            return BroadcastResponse(STATUS_UNAVAILABLE, str(e),
                                     leader_hint=e.leader_id or 0)
        except ChainHaltedError as e:
            return BroadcastResponse(STATUS_UNAVAILABLE, str(e))
        return BroadcastResponse(STATUS_SUCCESS)

    def handle_batch(
            self, envs: Sequence[Envelope],
            tps: Optional[Sequence[str]] = None,
            attests: Optional[Sequence[str]] = None,
            attestor=None
    ) -> List[BroadcastResponse]:
        """Ingest a coalesced batch in one call (the gateway's admission
        queue ships these).  Envelopes are independent — each routes by
        its own channel header and gets its own response, exactly as if
        streamed one by one; the batching only amortizes the RPC round
        trip and handshake-authenticated framing.

        `tps`, when given, aligns a traceparent with each envelope: the
        gateway batches many client txs into one frame, so per-tx trace
        context rides next to the envelopes instead of on the frame.
        `attests` aligns the gateway's verdict attestations the same
        way (verify-once plane); `attestor` is the frame's handshake-
        verified sender identity — the msgprocessor only honours the
        attestations when that identity is in the channel's configured
        attestor set."""
        out = []
        for i, env in enumerate(envs):
            ctx = None
            if tps and i < len(tps) and tps[i]:
                ctx = tracing.tracer.context_from(tps[i])
            attest = attests[i] if attests and i < len(attests) else None
            with tracing.tracer.activate(ctx):
                out.append(self.handle(env, attest=attest,
                                       attestor=attestor))
        return out
