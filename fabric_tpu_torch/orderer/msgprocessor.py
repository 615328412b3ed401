"""Per-channel message admission filters for the ordering service.

Reference parity: orderer/common/msgprocessor/*.go —
  classify (normal vs config)         standardchannel.go ClassifyMsg
  EmptyRejectRule                     filter.go
  SizeFilter                          sizefilter.go
  SigFilter (submitter policy check)  sigfilter.go
  expiration check (cert expiry)      expiration.go
  maintenance filter (consensus-type
  migration guard)                    maintenancefilter.go

The sig filter is the orderer's per-envelope signature verify — on the
device path these checks are batchable (the broadcast handler may collect
VerifyItems across queued envelopes and dispatch once), but the admission
decision itself stays host-side and per-envelope.

Counterpart of `fabric_tpu/orderer/msgprocessor.py`, whole, on the port's
imports: the signature filter verifies through the provider it is given
(the CUDA provider's KP2/KP3/KE5/KE6 lanes, or SW).
"""

from __future__ import annotations

import datetime
import enum
from typing import Dict, Optional

from fabric_tpu_torch.msp import deserialize_from_msps
from fabric_tpu_torch.policy import PolicyEvaluator, SignaturePolicy, SignedData
from fabric_tpu_torch.protocol import Envelope
from fabric_tpu_torch.protocol.types import TX_CONFIG


class MsgClass(enum.Enum):
    NORMAL = "normal"
    CONFIG = "config"


class MsgProcessorError(Exception):
    """Envelope rejected by an admission filter."""


def classify(env: Envelope) -> MsgClass:
    """standardchannel.go ClassifyMsg — by channel-header type."""
    if env.header().channel_header.type == TX_CONFIG:
        return MsgClass.CONFIG
    return MsgClass.NORMAL


class StandardChannelProcessor:
    """Filter chain for one application channel (standardchannel.go).

    ProcessNormalMsg = empty-reject -> expiration -> size -> sig-filter.
    Config messages additionally go through the config plane's validation
    (channelconfig.validate_config_update) before ordering.
    """

    def __init__(self, channel_id: str, msps: Dict[str, object], provider,
                 writers_policy: SignaturePolicy,
                 absolute_max_bytes: int = 10 * 1024 * 1024,
                 now=None, bundle_source=None, verify_cache=None,
                 trust_attestations: bool = False, attestors=None,
                 attestor_trust=None):
        self.channel_id = channel_id
        self._static_msps = msps
        self._static_writers = writers_policy
        self._static_max_bytes = absolute_max_bytes
        self.provider = provider
        self.bundle_source = bundle_source
        # verify-once plane: when a VerdictCache is attached, the sig
        # filter's batch_verify consults/extends it (duplicate
        # submissions and retried batches stop re-verifying), and — with
        # trust_attestations (OFF by default: an explicit trust
        # decision) — an authorized gateway's verdict attestation seeds
        # it so the orderer's device verify is skipped entirely.  The
        # attestation digest itself is a public hash anyone can compute,
        # so it carries no authority: it is only honoured when ALL of
        # (a) the transport handshake authenticated the submitting
        # peer, (b) that peer's (mspid, cert sha256) is in the
        # configured attestor set — the integrity-protected channel
        # makes the vouch unforgeable by third parties — and (c) the
        # attested digest matches the item this orderer derives itself
        # from the envelope bytes it holds.
        self.verify_cache = verify_cache
        self.trust_attestations = bool(trust_attestations)
        self.attestors = self._normalize_attestors(attestors)
        # per-identity standing on top of the allowlist (verify_plane/
        # trust.py): an attestor whose digest ever mismatched is revoked
        # — still allowlisted, no longer honoured.  None = membership only.
        self.attestor_trust = attestor_trust
        self._now = now or (lambda: datetime.datetime.now(datetime.timezone.utc))

    # -- live config resolution (channelconfig bundle when attached) --------

    @property
    def msps(self):
        if self.bundle_source is not None:
            return self.bundle_source.current().msps
        return self._static_msps

    @property
    def writers_policy(self):
        if self.bundle_source is not None:
            b = self.bundle_source.current()
            return b.policy("Writers") or self._static_writers
        return self._static_writers

    @property
    def absolute_max_bytes(self):
        if self.bundle_source is not None:
            return self.bundle_source.current().batch.absolute_max_bytes
        return self._static_max_bytes

    @absolute_max_bytes.setter
    def absolute_max_bytes(self, v):
        self._static_max_bytes = v

    @staticmethod
    def _normalize_attestors(attestors) -> frozenset:
        """Attestor bindings -> frozenset of (mspid, cert sha256 hex).
        Accepts {"mspid":..., "cert_fp":...} dicts or (mspid, fp)
        pairs — the consenter-binding idiom: CN strings are forgeable
        by any org's CA, the certificate hash is not."""
        out = set()
        for a in attestors or ():
            if isinstance(a, dict):
                mspid, fp = a.get("mspid"), a.get("cert_fp")
            else:
                mspid, fp = a
            if mspid and fp:
                out.add((str(mspid), str(fp).lower()))
        return frozenset(out)

    @property
    def evaluator(self):
        provider = self.provider
        if self.verify_cache is not None:
            from fabric_tpu_torch.verify_plane import CachingProvider
            provider = CachingProvider(provider, self.verify_cache,
                                       site="orderer",
                                       scope=self.channel_id)
        return PolicyEvaluator(self.msps, provider)

    def process(self, env: Envelope, raw_size: Optional[int] = None,
                attest: Optional[str] = None,
                attestor=None) -> MsgClass:
        """Admit or raise. Returns the message class for routing.

        The envelope header is decoded ONCE here and threaded through the
        rules; `raw_size` lets the caller pass the on-the-wire byte count
        so the size filter need not re-serialize.
        """
        if not env.payload:
            raise MsgProcessorError("empty payload (EmptyRejectRule)")
        try:
            header = env.header()
        except Exception:
            raise MsgProcessorError("undecodable envelope header")
        ch, sh = header.channel_header, header.signature_header
        cls = (MsgClass.CONFIG if ch.type == TX_CONFIG else MsgClass.NORMAL)

        if ch.channel_id != self.channel_id:
            raise MsgProcessorError(
                f"envelope for channel {ch.channel_id!r} sent to "
                f"{self.channel_id!r}")
        self._expiration(sh.creator)
        if (raw_size if raw_size is not None
                else len(env.serialize())) > self.absolute_max_bytes:
            raise MsgProcessorError(
                f"message larger than AbsoluteMaxBytes "
                f"({self.absolute_max_bytes})")
        if self.verify_cache is not None:
            if self.bundle_source is not None:
                try:
                    self.verify_cache.set_epoch(
                        self.bundle_source.current().sequence,
                        scope=self.channel_id)
                except Exception:
                    pass
            if (attest and self.trust_attestations
                    and self._attestor_authorized(attestor)):
                self._accept_attestation(env, sh.creator, attest, attestor)
        self._sig_filter(env, sh.creator)
        if cls is MsgClass.CONFIG and self.bundle_source is not None:
            # config-plane validation BEFORE ordering (reference:
            # msgprocessor ProcessConfigUpdateMsg -> configtx validation);
            # malformed/unauthorized config updates are rejected here, not
            # written as config blocks.
            from fabric_tpu_torch.config import ConfigError, validate_config_update
            try:
                validate_config_update(self.bundle_source.current(), env,
                                       self.provider)
            except ConfigError as exc:
                raise MsgProcessorError(f"config update rejected: {exc}")
        return cls

    # -- individual rules ---------------------------------------------------

    def _attestor_authorized(self, attestor) -> bool:
        """Is this transport-authenticated identity allowed to vouch?

        The attestation digest is a public hash — any submitter can
        compute it over its own (possibly garbage) signature — so the
        authority comes entirely from WHO delivered it: the handshake-
        verified peer identity of the frame it rode in on, pinned here
        by (mspid, cert sha256) against the operator-configured
        attestor set.  No attestor set configured means nobody may
        vouch."""
        if attestor is None or not self.attestors:
            return False
        try:
            from fabric_tpu_torch.orderer.cluster import cert_fingerprint
            binding = (attestor.mspid, cert_fingerprint(attestor.cert))
        except Exception:
            return False
        if binding not in self.attestors:
            return False
        # allowlisted but revoked (a past digest mismatch) = not honoured
        return (self.attestor_trust is None
                or self.attestor_trust.allowed(binding))

    def _accept_attestation(self, env: Envelope, creator: bytes,
                            attest: str, attestor=None) -> None:
        """Seed the verdict cache from an AUTHORIZED gateway's verdict
        attestation (the caller already ran _attestor_authorized).

        The gateway already ran this creator signature on its device and
        sends the cache-key digest of the VerifyItem it verified.  This
        orderer re-derives the item from the envelope it actually holds
        — identity from ITS msps, payload/signature from the wire bytes
        — and only accepts the attestation when the digests are
        bit-identical, so a mismatched attestation can never vouch for
        different bytes than the ones being admitted.  A mismatch also
        revokes the vouching identity's standing (attestor_trust): an
        honest attestor cannot produce one, since the digest is a pure
        function of bytes both sides hold.  Policy evaluation, expiry,
        and config checks still run live below."""
        try:
            from fabric_tpu_torch.verify_plane import item_digest
            ident = deserialize_from_msps(self.msps, creator)
            if ident is None:
                return
            item = ident.verify_item(env.payload, env.signature)
            if item_digest(item).hex() != attest:
                self._note_attestor(attestor, ok=False)
                return
            self.verify_cache.put(item, True, scope=self.channel_id)
            self._note_attestor(attestor, ok=True)
            from fabric_tpu_torch.verify_plane.cache import _m
            _m()["attested"].add(1)
        except Exception:
            pass

    def _note_attestor(self, attestor, ok: bool) -> None:
        """Record an authorized attestor's outcome in the standing
        registry (no-op without one)."""
        if self.attestor_trust is None or attestor is None:
            return
        try:
            from fabric_tpu_torch.orderer.cluster import cert_fingerprint
            binding = (attestor.mspid, cert_fingerprint(attestor.cert))
            if ok:
                self.attestor_trust.note_accepted(binding)
            else:
                self.attestor_trust.note_mismatch(binding)
        except Exception:
            pass

    def _expiration(self, creator: bytes) -> None:
        """expiration.go — reject envelopes signed with an expired cert."""
        ident = deserialize_from_msps(self.msps, creator)
        if ident is None:
            raise MsgProcessorError("undeserializable creator identity")
        if ident.expires_at() is not None and ident.expires_at() < self._now():
            raise MsgProcessorError("creator certificate expired")

    def _sig_filter(self, env: Envelope, creator: bytes) -> None:
        """sigfilter.go — submitter must satisfy the channel Writers policy."""
        sd = SignedData(data=env.payload, identity=creator,
                        signature=env.signature)
        if not self.evaluator.evaluate_signed_data(self.writers_policy, [sd]):
            raise MsgProcessorError(
                "submitter does not satisfy channel Writers policy "
                "(SigFilter)")
