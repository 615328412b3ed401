"""Deterministic, seeded fault-injection plane for the comm layer.

The robustness analogue of the tracing plane: a process-global
`FaultPlan` that the RPC transport consults on every outbound frame and
every dial.  A plan holds an ordered list of `FaultRule`s — matched by
RPC method, remote endpoint, and frame kind — whose actions model the
failure modes a real network serves up:

  drop      the frame never leaves (the caller sees an RpcTimeout)
  delay     the frame is held for a fixed latency before sending
  dup       the frame is sent twice (duplicate delivery; downstream
            dedup — gateway txid window, committer replay guard — must
            absorb it)
  reorder   the frame is parked and released AFTER the next frame on
            the same channel (adjacent swap)
  error     the injection site raises RpcError (a loud transport fault)

plus connection-level faults: `sever(addr)` refuses new dials to an
endpoint and closes the live channels already dialed to it, and
`isolate(addrs)` does the same for a node group (the reachable half of
a network partition — in-process nodes share one address space, so the
partition is expressed as "this group is unreachable"; `heal()`
restores it).

Schedules: a rule may carry a `FaultSchedule` — a wall-time envelope
(ramp, burst, window) over elapsed plan time that MULTIPLIES the rule's
action probabilities, so a chaos drill can say "fault probability ramps
up over 10s" or "faults fire only during 3s bursts every 10s" and run
composably alongside always-on rules.  The envelope scales the
probability before the PRNG compare and never consumes extra draws, so
scheduled plans keep the draw-sequence determinism below.

Determinism: every probabilistic decision consumes one draw from ONE
seeded PRNG under the plan lock, in frame-send order.  A test that
replays the same workload single-threaded against the same seed sees
the same fault sequence; concurrent topologies stay statistically
reproducible (same fault mix and rates) which is what the convergence
assertions need.

Production cost: the hot path is a single module-attribute load
(`faults._PLAN is None`) per frame — no plan, no work.  `install()` is
for tests and chaos drills only.

Addressable targets: unary requests match their RPC method name
(kind="req"), deliver stream frames match method="deliver"
(kind="stream"), and multiplexed gossip casts are addressable by their
INNER message type via the transport's fault_label —
method="gossip.msg/<type>" (e.g. "gossip.msg/gossip.block",
"gossip.msg/gossip.pull_req"), kind="cast".  Snapshot state-transfer
chunks match method="state.snapshot_chunk" (kind="req"), so a chaos
drill can drop/delay/dup the transfer itself.

Observability: every fired fault bumps `fault_injected_total` in the
ops-plane registry, emits a `fault.<action>` span event into the
ambient trace (so /traces/<id> shows WHY a tx was slow under chaos),
and is counted in the plan's own snapshot, exported by `GET /faults`.

Counterpart of `fabric_tpu/comm/faults.py`, the same code on the port's
imports.
"""

from __future__ import annotations

import fnmatch
import logging
import random
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger("fabric_tpu_torch.comm.faults")

# THE hot-path gate: transport code checks `faults._PLAN is not None`
# (one attribute load) before doing anything else.
_PLAN: Optional["FaultPlan"] = None
_INSTALL_LOCK = threading.Lock()

# Every dial-side channel registers here (a WeakSet.add, off the frame
# hot path) so a plan installed LATER can still sever pre-existing
# connections.
_DIALED: "weakref.WeakSet" = weakref.WeakSet()
_DIALED_LOCK = threading.Lock()

ACTIONS = ("drop", "delay", "dup", "reorder", "error")


def register_channel(ch) -> None:
    with _DIALED_LOCK:
        _DIALED.add(ch)


def _addr_str(addr) -> str:
    if isinstance(addr, str):
        return addr
    try:
        host, port = addr[0], addr[1]
        return f"{host}:{port}"
    except Exception:
        return str(addr)


@dataclass
class FaultSchedule:
    """A wall-time envelope over elapsed plan time that multiplies a
    rule's action probabilities by `factor(t)` in [floor, 1]:

      constant   1.0 always (the implicit default when a rule has none)
      ramp       floor -> 1.0 linearly over `ramp_s` starting at
                 `start_s`, then hold (chaos that builds with the load
                 ramp instead of arriving full-strength at t=0)
      burst      1.0 for the first `duty` fraction of every `period_s`,
                 `floor` otherwise (fault bursts riding a load burst)
      window     1.0 inside [start_s, end_s), `floor` outside

    `end_s` bounds every kind; outside it the factor is `floor`.  Pure
    function of t, so a seeded plan with an injected clock replays the
    exact same fault sequence."""

    kind: str = "constant"       # constant | ramp | burst | window
    start_s: float = 0.0
    ramp_s: float = 10.0
    period_s: float = 10.0
    duty: float = 0.3
    end_s: Optional[float] = None
    floor: float = 0.0           # factor outside the active phase

    def factor(self, t: float) -> float:
        if t < self.start_s or (self.end_s is not None
                                and t >= self.end_s):
            return self.floor
        t = t - self.start_s
        if self.kind == "ramp":
            if self.ramp_s <= 0.0:
                return 1.0
            f = min(1.0, t / self.ramp_s)
            return self.floor + (1.0 - self.floor) * f
        if self.kind == "burst":
            if self.period_s <= 0.0:
                return 1.0
            phase = (t % self.period_s) / self.period_s
            return 1.0 if phase < self.duty else self.floor
        return 1.0                # constant / window (inside the window)

    def as_dict(self) -> dict:
        return {"kind": self.kind, "start_s": self.start_s,
                "ramp_s": self.ramp_s, "period_s": self.period_s,
                "duty": self.duty, "end_s": self.end_s,
                "floor": self.floor}


@dataclass
class FaultRule:
    """One match+action rule.  Probabilities are independent per action;
    at most one action fires per frame (first match in ACTIONS order
    wins, so a rule with drop=1.0 never also duplicates)."""

    method: str = "*"            # fnmatch pattern on the RPC method
    peer: Optional[str] = None   # fnmatch on "host:port" (None = any)
    kind: str = "*"              # "req" | "cast" | "resp" | "stream" | "*"
    src: str = "*"               # fnmatch on the dialing identity's
                                 # mspid ("*" = any, incl. untagged)
    drop: float = 0.0
    delay: float = 0.0           # probability of delaying
    delay_s: float = 0.01        # how long a delayed frame is held
    dup: float = 0.0
    reorder: float = 0.0
    error: float = 0.0
    max_fires: Optional[int] = None   # stop firing after N faults
    # wall-time envelope multiplying every probability (None = always on)
    schedule: Optional[FaultSchedule] = None
    fires: int = field(default=0, compare=False)

    def matches(self, method: str, peer: str, kind: str,
                src: str = "") -> bool:
        if self.max_fires is not None and self.fires >= self.max_fires:
            return False
        if not fnmatch.fnmatchcase(kind, self.kind):
            return False
        if not fnmatch.fnmatchcase(method, self.method):
            return False
        if self.peer is not None and not fnmatch.fnmatchcase(
                peer, self.peer):
            return False
        if self.src != "*" and not fnmatch.fnmatchcase(
                src or "", self.src):
            return False
        return True

    def as_dict(self) -> dict:
        return {"method": self.method, "peer": self.peer, "kind": self.kind,
                "src": self.src,
                "drop": self.drop, "delay": self.delay,
                "delay_s": self.delay_s, "dup": self.dup,
                "reorder": self.reorder, "error": self.error,
                "max_fires": self.max_fires,
                "schedule": (self.schedule.as_dict()
                             if self.schedule is not None else None),
                "fires": self.fires}


class FaultInjected(Exception):
    """Raised at an injection site for `error` faults.  Transport code
    re-raises it as RpcError so callers exercise their normal failure
    handling — the type exists so logs can tell injected faults from
    organic ones."""


class FaultPlan:
    """A seeded set of fault rules + connection-level faults.

    Build one, add rules (chainable), then `faults.install(plan)`:

        plan = (FaultPlan(seed=7)
                .rule(method="broadcast*", drop=0.2, delay=0.3,
                      delay_s=0.05, dup=0.2))
        faults.install(plan)
        ...
        faults.uninstall()
    """

    def __init__(self, seed: int = 0, name: str = "", clock=None):
        self.seed = int(seed)
        self.name = name or f"plan-{seed}"
        # schedule time base: elapsed wall time since install();
        # injectable so tests replay envelopes without sleeping
        self._clock = clock or time.time
        self._rand = random.Random(self.seed)
        self._lock = threading.Lock()
        self.rules: List[FaultRule] = []
        self._severed: set = set()              # "host:port" strings
        # per-channel parked frame for `reorder` (adjacent swap)
        self._held: Dict[int, Callable[[], None]] = {}
        self.fired: Dict[str, int] = {a: 0 for a in ACTIONS}
        self.fired["sever_refused"] = 0
        self.installed_at: Optional[float] = None

    # -- building -----------------------------------------------------------

    def rule(self, **kw) -> "FaultPlan":
        sched = kw.pop("schedule", None)
        if isinstance(sched, dict):
            sched = FaultSchedule(**sched)
        self.rules.append(FaultRule(schedule=sched, **kw))
        return self

    def links(self, matrix: Dict, schedule=None) -> "FaultPlan":
        """Compile a per-link latency/loss matrix into rules.

        `matrix` maps (src, dst) -> link properties, where `src` is an
        fnmatch pattern on the dialing identity's mspid, `dst` one on
        the remote "host:port", and the properties are:

          latency_s   one-way propagation delay added to EVERY frame
                      on the link (delay probability 1.0)
          loss        frame loss probability in [0, 1]
          jitter_s    reserved label, recorded but not yet modeled

        Direction matters — (A, B) and (B, A) are independent links, so
        asymmetric paths (fast A->B, slow trans-oceanic B->A) are one
        entry each.  Entries compile in sorted order so rule order (and
        with it the PRNG draw sequence) is independent of dict
        insertion order; an optional `schedule` envelope is attached to
        every link rule and — like all schedules — scales probabilities
        BEFORE the compare without consuming extra draws.
        """
        sched = schedule
        if isinstance(sched, dict):
            sched = FaultSchedule(**sched)
        for (src, dst) in sorted(matrix):
            props = dict(matrix[(src, dst)])
            latency = float(props.get("latency_s", 0.0))
            loss = float(props.get("loss", 0.0))
            self.rules.append(FaultRule(
                src=str(src), peer=str(dst),
                drop=loss,
                delay=1.0 if latency > 0.0 else 0.0,
                delay_s=latency,
                schedule=sched))
        return self

    # -- connection-level faults --------------------------------------------

    def sever(self, addr) -> "FaultPlan":
        """Refuse new dials to `addr` and cut live channels dialed to it."""
        a = _addr_str(addr)
        with self._lock:
            self._severed.add(a)
        with _DIALED_LOCK:
            victims = [ch for ch in _DIALED
                       if getattr(ch, "remote_addr_str", None) == a]
        for ch in victims:
            try:
                ch.close()
            except Exception:
                pass
        logger.info("fault plan %s: severed %s (%d live channels cut)",
                    self.name, a, len(victims))
        return self

    def isolate(self, addrs: Sequence) -> "FaultPlan":
        """Sever a node group: the reachable expression of a partition."""
        for a in addrs:
            self.sever(a)
        return self

    def heal(self, addr=None) -> "FaultPlan":
        """Clear severs (one endpoint, or all) and release parked frames."""
        with self._lock:
            if addr is None:
                self._severed.clear()
            else:
                self._severed.discard(_addr_str(addr))
            held = list(self._held.values())
            self._held.clear()
        for send in held:
            try:
                send()
            except Exception:
                pass
        return self

    def is_severed(self, addr) -> bool:
        with self._lock:
            return _addr_str(addr) in self._severed

    # -- the frame hook ------------------------------------------------------

    def apply(self, channel_key: int, method: str, peer, kind: str,
              send: Callable[[], None], src: str = "") -> None:
        """Decide and apply faults for one outbound frame.  `send` is a
        closure performing the actual transmission; it is called 0, 1 or
        2 times depending on the decision.  `src` is the dialing
        identity's mspid when the transport tagged the channel (link-
        matrix rules match on it; untagged frames only match src="*")."""
        peer_s = _addr_str(peer) if peer is not None else ""
        action = None
        delay_s = 0.0
        now = self._clock()
        elapsed = now - (self.installed_at
                         if self.installed_at is not None else now)
        with self._lock:
            for r in self.rules:
                if not r.matches(method, peer_s, kind, src):
                    continue
                # the wall-time envelope scales every probability; a
                # candidate action with p > 0 still consumes exactly one
                # draw even at factor 0, so the draw sequence is the
                # same in and out of the envelope's active phase
                factor = (r.schedule.factor(elapsed)
                          if r.schedule is not None else 1.0)
                # one PRNG draw per candidate action, in fixed order
                for a in ACTIONS:
                    p = getattr(r, a if a != "delay" else "delay")
                    if p > 0.0 and self._rand.random() < p * factor:
                        action = a
                        delay_s = r.delay_s
                        r.fires += 1
                        break
                if action is not None:
                    break
            if action is not None:
                self.fired[action] += 1
            # reorder bookkeeping happens under the lock
            if action == "reorder":
                prev = self._held.pop(channel_key, None)
                self._held[channel_key] = send
            elif self._held:
                prev = self._held.pop(channel_key, None)
            else:
                prev = None
        if action is not None:
            self._observe(action, method, peer_s)
        if action is None or action == "dup":
            send()
            if action == "dup":
                send()
        elif action == "drop":
            pass                      # the frame dies here
        elif action == "delay":
            time.sleep(delay_s)
            send()
        elif action == "error":
            if prev is not None:
                prev()
            raise FaultInjected(
                f"injected transport error on {method!r} -> {peer_s}")
        # action == "reorder": this frame stays parked; fall through
        if prev is not None and action != "error":
            prev()                    # released AFTER the newer frame

    def _observe(self, action: str, method: str, peer: str) -> None:
        try:
            from fabric_tpu_torch.ops_plane import registry, tracing
            registry.counter(
                "fault_injected_total",
                "frames faulted by the injection plane").add(
                    1, action=action, method=method)
            # annotate the ambient trace: /traces/<id> shows why a tx
            # crawled under chaos
            tracing.event("fault." + action, method=method, peer=peer)
        except Exception:
            pass                      # observability never breaks the plane

    # -- introspection (GET /faults) ----------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {"name": self.name, "seed": self.seed,
                    "installed_at": self.installed_at,
                    "rules": [r.as_dict() for r in self.rules],
                    "severed": sorted(self._severed),
                    "held_frames": len(self._held),
                    "fired": dict(self.fired)}


# -- process-global install ---------------------------------------------------


def install(plan: FaultPlan) -> FaultPlan:
    """Make `plan` the process-global fault plan (tests/chaos only)."""
    global _PLAN
    with _INSTALL_LOCK:
        plan.installed_at = plan._clock()   # schedule t=0 (time.time
        _PLAN = plan                        # unless a clock is injected)
    logger.warning("fault plan %s INSTALLED (seed=%d, %d rules)",
                   plan.name, plan.seed, len(plan.rules))
    return plan


def uninstall() -> None:
    global _PLAN
    with _INSTALL_LOCK:
        plan, _PLAN = _PLAN, None
    if plan is not None:
        # release parked frames so no call wedges past the drill
        plan.heal()
        logger.warning("fault plan %s removed; fired=%s",
                       plan.name, plan.fired)


def active() -> Optional[FaultPlan]:
    return _PLAN


# -- ops-plane surface --------------------------------------------------------


def register_routes(ops) -> None:
    """Mount `GET /faults` on an OperationsServer: the active plan's
    snapshot, or {"active": false} in production (no plan)."""

    def _faults(path: str, body: bytes):
        plan = _PLAN
        if plan is None:
            return 200, {"active": False}
        out = plan.snapshot()
        out["active"] = True
        return 200, out

    ops.register_route("GET", "/faults", _faults)
