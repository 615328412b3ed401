"""Per-channel leader election over gossip membership.

Reference parity: gossip/election/election.go — peers gossip leadership
declarations; the peer with the smallest ID among the alive candidates
is leader (the reference compares peer IDs too).  The leader runs the
channel's deliver client (one orderer puller per org, blocks then fan
out via gossip) — wired in blocksprovider.

Deterministic: piggybacks on Discovery ticks; leadership is re-derived
from the current membership view each tick, and an explicit declaration
message lets followers yield faster than expiry alone.

Counterpart of `fabric_tpu/gossip/election.py`, the same code on the port's
imports.
"""

from __future__ import annotations

from typing import Callable, Optional

MSG_LEADERSHIP = "gossip.leadership"


class LeaderElection:
    def __init__(self, discovery, on_gain: Callable[[], None] = lambda: None,
                 on_lose: Callable[[], None] = lambda: None):
        self.discovery = discovery
        self.id = discovery.id
        self.on_gain = on_gain
        self.on_lose = on_lose
        self._is_leader = False

    def tick(self) -> None:
        """Re-derive leadership: smallest id among self + alive members."""
        candidates = [self.id] + self.discovery.alive_ids()
        leader = min(candidates)
        if leader == self.id and not self._is_leader:
            self._is_leader = True
            self._declare()
            self.on_gain()
        elif leader != self.id and self._is_leader:
            self._is_leader = False
            self.on_lose()

    def _declare(self) -> None:
        for to in self.discovery.alive_ids():
            self.discovery.endpoint.send(to, MSG_LEADERSHIP,
                                         {"leader": self.id})

    def handle(self, msg_type: str, frm: str, body: dict) -> None:
        if msg_type != MSG_LEADERSHIP:
            return
        if body.get("leader", "") < self.id and self._is_leader:
            self._is_leader = False  # yield to the smaller id immediately
            self.on_lose()

    @property
    def is_leader(self) -> bool:
        return self._is_leader
