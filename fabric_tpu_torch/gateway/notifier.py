"""Commit-status notifier: txid -> validation code, push not poll.

Rides the committer's post-commit listener hook (committer.py calls
fn(block, final_flags) after every ledger commit), decodes each
envelope's txid once, and wakes any blocked commit_status waiters.
This is the event plane the reference builds from peer/deliveryservice
block events + gateway/commit.go — here it is in-process because the
gateway is peer-co-located.

The history window is bounded: clients that ask about a txid committed
more than `window` txs ago fall back to the gateway's ledger lookup
path (blkstorage keeps the authoritative record forever).
"""

from __future__ import annotations

import logging
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from fabric_tpu_torch.ops_plane import tracing
from fabric_tpu_torch.protocol import Envelope

logger = logging.getLogger("fabric_tpu_torch.gateway")


class CommitNotifier:
    def __init__(self, channel_id: str, window: int = 4096):
        self.channel_id = channel_id
        self.window = int(window)
        self._lock = threading.Lock()
        # txid -> (validation code int, block number, block trace id|None)
        self._history: "OrderedDict[str, Tuple[int, int, Optional[str]]]" \
            = OrderedDict()
        self._waiters: Dict[str, List[threading.Event]] = {}

    # committer hook ----------------------------------------------------

    def on_block(self, block, flags) -> None:
        notified = []
        # listeners run inside committer.store_block's span, so the
        # ambient trace id here IS the block trace — remember it so
        # commit_status can link the request trace to the block trace
        block_trace = tracing.tracer.current_trace_id()
        with self._lock:
            for i, env_bytes in enumerate(block.data):
                try:
                    txid = Envelope.deserialize(
                        env_bytes).header().channel_header.txid
                except Exception:
                    continue
                if not txid:
                    continue
                self._history[txid] = (int(flags.flag(i)),
                                       int(block.header.number),
                                       block_trace)
                evs = self._waiters.pop(txid, None)
                if evs:
                    notified.extend(evs)
            while len(self._history) > self.window:
                self._history.popitem(last=False)
        for ev in notified:
            ev.set()

    # client side -------------------------------------------------------

    def peek(self, txid: str) -> Optional[Tuple[int, int, Optional[str]]]:
        with self._lock:
            return self._history.get(txid)

    def wait(self, txid: str,
             timeout: float) -> Optional[Tuple[int, int, Optional[str]]]:
        """Block until the txid commits or the timeout lapses."""
        ev = threading.Event()
        with self._lock:
            got = self._history.get(txid)
            if got is not None:
                return got
            self._waiters.setdefault(txid, []).append(ev)
        try:
            if not ev.wait(timeout):
                return None
            with self._lock:
                return self._history.get(txid)
        finally:
            with self._lock:
                evs = self._waiters.get(txid)
                if evs and ev in evs:
                    evs.remove(ev)
                    if not evs:
                        del self._waiters[txid]
