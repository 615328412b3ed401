"""Config transaction construction, validation, and application.

Reference parity: common/configtx/validator.go (ProposeConfigUpdate /
Validate), orderer/common/msgprocessor ProcessConfigUpdateMsg, and the
peer-side config-block consumption in core/peer (channel config updates
take effect at commit).

A config envelope's payload carries:
  {"config": <ChannelConfig serialized>, "last_update_sigs": [SignedData]}
The signatures are over the serialized new config (binding them to the
channel id and sequence inside it) and must satisfy the CURRENT bundle's
Admins policy; the sequence must be exactly current+1
(configtx/validator.go:1 sequence rule).

Counterpart of `fabric_tpu/config/configtx.py`, whole.  The Admins
signatures of an update go through `provider.batch_verify`: on the CUDA
provider, the P-256 lanes (KP3 for a key with a resident table, else
KP2).
"""

from __future__ import annotations

import time
from typing import List, Optional

from fabric_tpu_torch.policy import SignedData
from fabric_tpu_torch.protocol.build import compute_txid
from fabric_tpu_torch.protocol.types import (
    ChannelHeader,
    Envelope,
    Header,
    SignatureHeader,
    TX_CONFIG,
)
from fabric_tpu_torch.utils import serde

from .channelconfig import Bundle, ChannelConfig, ConfigError


def build_config_envelope(new_config: ChannelConfig, signers,
                          nonce: bytes = b"") -> Envelope:
    """Create a signed config envelope.

    signers: list of objects with .serialize() -> identity bytes and
    .sign(data) -> signature (msp SigningIdentity surface).  Every signer
    signs the serialized new config; their signatures ride in the payload
    for Admins-policy evaluation at validation time.
    """
    cfg_bytes = new_config.serialize()
    sigs = []
    for s in signers:
        sigs.append({"identity": s.serialize(), "signature": s.sign(cfg_bytes)})
    creator = signers[0].serialize() if signers else b""
    nonce = nonce or str(time.time_ns()).encode()
    txid = compute_txid(nonce, creator)
    header = Header(
        channel_header=ChannelHeader(TX_CONFIG, new_config.channel_id, txid,
                                     timestamp=int(time.time())),
        signature_header=SignatureHeader(creator=creator, nonce=nonce),
    )
    payload = {
        "header": header.to_dict(),
        "data": serde.encode({"config": cfg_bytes, "sigs": sigs}),
    }
    payload_bytes = serde.encode(payload)
    signature = signers[0].sign(payload_bytes) if signers else b""
    return Envelope(payload=payload_bytes, signature=signature)


def parse_config_envelope(env: Envelope) -> tuple:
    """-> (ChannelConfig, List[SignedData over the config bytes])."""
    body = serde.decode(env.payload_dict()["data"])
    cfg_bytes = body["config"]
    cfg = ChannelConfig.deserialize(cfg_bytes)
    sds = [SignedData(data=cfg_bytes, identity=s["identity"],
                      signature=s["signature"]) for s in body["sigs"]]
    return cfg, sds


def config_envelope_of(block) -> Optional[Envelope]:
    """The single config envelope of a config block, else None.

    THE definition of "is a config block": config blocks are always cut as
    single-envelope blocks (the chain's configure() isolates them; a config
    tx smuggled into a multi-tx block is flagged invalid by the validator).
    Shared by the committer and apply_config_block so the rule cannot
    drift.
    """
    from fabric_tpu_torch.protocol.wire import n_txs
    if n_txs(block) != 1:
        return None
    try:
        env = Envelope.deserialize(block.data[0])
    except Exception:
        return None          # malformed envelope: flagged by the validator
    try:
        is_config = env.header().channel_header.type == TX_CONFIG
    except Exception:
        return None
    return env if is_config else None


def validate_config_update(bundle: Bundle, env: Envelope, provider) -> ChannelConfig:
    """Admission + commit-time validation of a config envelope against the
    CURRENT bundle.  Returns the new ChannelConfig or raises ConfigError.

    Rules (configtx/validator.go):
      - channel id must match,
      - sequence must be exactly bundle.sequence + 1,
      - signature set must satisfy the current Admins policy,
      - the new config must build into a Bundle (MSPs must parse).
    """
    try:
        cfg, sds = parse_config_envelope(env)
    except Exception as exc:
        raise ConfigError(f"malformed config envelope: {exc}") from exc
    return validate_parsed_config_update(bundle, cfg, sds, provider)


def validate_parsed_config_update(bundle: Bundle, cfg: ChannelConfig,
                                  sds: List[SignedData],
                                  provider) -> ChannelConfig:
    """validate_config_update on an already-parsed envelope body."""
    if cfg.channel_id != bundle.channel_id:
        raise ConfigError(
            f"config for channel {cfg.channel_id!r} on {bundle.channel_id!r}")
    if cfg.sequence != bundle.sequence + 1:
        raise ConfigError(
            f"config sequence {cfg.sequence}, expected {bundle.sequence + 1}")
    if not bundle.evaluate_policy("Admins", sds, provider):
        raise ConfigError("config update not authorized by Admins policy")
    try:
        Bundle(cfg)
    except Exception as exc:
        raise ConfigError(f"config does not materialize: {exc}") from exc
    return cfg


def apply_config_block(source, block, provider) -> Optional[Bundle]:
    """Peer-side consumption: if the block carries a (valid) config tx,
    re-validate against the current bundle and swap the source.

    Returns the new Bundle when applied, else None.  Mirrors
    core/peer/peer.go channel-config update at commit: validation happened
    at ordering admission too, but commit-side re-validation keeps peers
    that weren't the ordering node honest.
    """
    env = config_envelope_of(block)
    if env is None:
        return None
    cfg = validate_config_update(source.current(), env, provider)
    new_bundle = Bundle(cfg)
    source.update(new_bundle)
    return new_bundle
