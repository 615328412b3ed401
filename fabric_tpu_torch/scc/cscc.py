"""cscc — configuration system contract.

Reference parity: Fabric's core/scc/cscc/configure.go —
GetChannels, GetConfigBlock/GetChannelConfig, JoinChain.  Joining wires a
new channel kernel (ledger + validator + committer surface) from a
genesis/config source, the role core/peer/peer.go CreateChannel plays.

Counterpart of `fabric_tpu/scc/cscc.py`, the same code on the port's
imports.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from fabric_tpu_torch.policy import SignedData


class CsccError(Exception):
    pass


class Cscc:
    """Peer-level channel directory."""

    def __init__(self, create_channel: Optional[Callable] = None):
        # create_channel(channel_id, channel_config) -> channel object
        self._create = create_channel
        self._channels: Dict[str, object] = {}

    def join_chain(self, channel_id: str, channel_config,
                   signed: Optional[SignedData] = None, **kw):
        if channel_id in self._channels:
            raise CsccError(f"already joined {channel_id!r}")
        if self._create is None:
            raise CsccError("no channel factory wired")
        ch = self._create(channel_id, channel_config, **kw)
        self._channels[channel_id] = ch
        return ch

    def register(self, channel_id: str, channel) -> None:
        """For channels created outside cscc (e.g. at node bootstrap)."""
        self._channels[channel_id] = channel

    def get_channels(self, signed: Optional[SignedData] = None) -> List[str]:
        return sorted(self._channels)

    def get(self, channel_id: str):
        return self._channels.get(channel_id)

    def get_channel_config(self, channel_id: str,
                           signed: Optional[SignedData] = None):
        ch = self._channels.get(channel_id)
        if ch is None:
            raise CsccError(f"unknown channel {channel_id!r}")
        src = getattr(ch, "bundle_source", None)
        if src is None:
            raise CsccError(f"channel {channel_id!r} has no config bundle")
        return src.current().config
