"""SLO-driven admission control: the gateway's graceful-degradation
state machine.

The bounded admission queue (service.py) already refuses to buffer
unboundedly — but a bare queue-full rejection is a CLIFF: the gateway
accepts 100% of offered load right up to the instant it accepts
whatever fraction happens to fit, latency for everything already
admitted blows through its SLO, and clients learn about overload only
by timing out.  The multi-window burn-rate evaluator (ops_plane/slo.py)
computes a calibrated "how much trouble are we in" signal; this module
closes the loop between that signal and the front door.

`AdmissionController` folds three normalized signals into one severity
(1.0 = at threshold):

  burn      max short-window burn rate across the node's SLO
            objectives (the sustained-overload signal)
  queue     admission-queue occupancy against `queue_high_frac`
            (the right-now signal; EWMA-smoothed)
  latency   EWMA of orderer-ack latency against `latency_slo_s`
            (the downstream-backpressure signal)

and runs a hysteretic state machine over it:

  NORMAL              admit everything
  SHED_EVALUATE       reject read-only evaluates first — queries can
                      retry anywhere, submits carry endorsement work
                      already paid for
  SHED_PROBABILISTIC  also shed submits by a SEEDED coin whose weight
                      grows with severity (deterministic under test,
                      statistically fair in production)
  SHED_HARD           reject all client verbs

Escalation is immediate (overload does not wait); recovery steps DOWN
one state at a time, only after `dwell_s` in the current state AND
severity below `recover_ratio` x the state's entry threshold — the
hysteresis that prevents shed/admit flapping at the boundary.

A shed is a TYPED, RETRYABLE verdict, not an error string: the verb
returns `{"shed": true, "mode": ..., "retry_after_ms": ...}` with a
hint that grows with severity, and GatewayClient honors it with capped
jittered backoff (client.py).  Distinct from queue-full backpressure:
backpressure means "the batcher lost the race this instant", shed
means "the NODE is overloaded — stay away for a while".
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, List, Optional

from fabric_tpu_torch.ops_plane import registry
from fabric_tpu_torch.ops_plane.logging import jlog

import logging

logger = logging.getLogger("fabric_tpu_torch.gateway")

# state order IS escalation order; gauge value = index
STATES = ("NORMAL", "SHED_EVALUATE", "SHED_PROBABILISTIC", "SHED_HARD")
NORMAL, SHED_EVALUATE, SHED_PROBABILISTIC, SHED_HARD = range(4)

# the wire status a shed verdict rides under (HTTP 429 semantics)
SHED_STATUS = 429


class ShedDecision:
    """One rejected admission: what to tell the client."""

    __slots__ = ("mode", "retry_after_ms", "severity")

    def __init__(self, mode: str, retry_after_ms: int, severity: float):
        self.mode = mode
        self.retry_after_ms = int(retry_after_ms)
        self.severity = float(severity)

    def body(self) -> dict:
        # the RPC serde is float-free by design: severity rides as
        # integer thousandths
        return {"shed": True, "mode": self.mode,
                "retry_after_ms": self.retry_after_ms,
                "severity_milli": int(round(self.severity * 1000))}


class AdmissionController:
    """Severity -> state machine -> per-verb admit/shed verdicts.

    Pure host logic with injected signal sources and clock: the tests
    drive it through synthetic burn/queue/latency trajectories without
    a node, and the GatewayService wires the live ones.
    """

    def __init__(self, cfg: Optional[dict] = None, *,
                 burn_source: Optional[Callable[[], Optional[float]]] = None,
                 queue_source: Optional[Callable[[], float]] = None,
                 clock=None):
        cfg = dict(cfg or {})
        self.enabled = bool(cfg.get("enabled", False))
        # severity thresholds for entering each shed state (NORMAL has
        # none); defaults: evaluates shed at 1x threshold burn, submits
        # probabilistically from 2x, everything from 4x
        self.shed_evaluate_burn = float(cfg.get("shed_evaluate_burn", 1.0))
        self.shed_probabilistic_burn = float(
            cfg.get("shed_probabilistic_burn", 2.0))
        self.shed_hard_burn = float(cfg.get("shed_hard_burn", 4.0))
        if not (0.0 < self.shed_evaluate_burn
                <= self.shed_probabilistic_burn <= self.shed_hard_burn):
            raise ValueError("admission thresholds must satisfy 0 < "
                             "evaluate <= probabilistic <= hard")
        # queue occupancy mapping: queue_frac / queue_high_frac == 1.0
        # severity when the queue sits at the high-water mark
        self.queue_high_frac = float(cfg.get("queue_high_frac", 0.8))
        # ack-latency mapping: ewma / latency_slo_s
        self.latency_slo_s = float(cfg.get("latency_slo_s", 2.0))
        # hysteretic recovery
        self.recover_ratio = float(cfg.get("recover_ratio", 0.7))
        self.dwell_s = float(cfg.get("dwell_s", 1.0))
        # retry-after hint: base * (1 + severity), capped
        self.retry_after_base_ms = int(cfg.get("retry_after_base_ms", 200))
        self.retry_after_max_ms = int(cfg.get("retry_after_max_ms", 5000))
        # severity recompute rate limit (admit() sits on the submit path)
        self.eval_interval_s = float(cfg.get("eval_interval_s", 0.1))
        self.seed = int(cfg.get("seed", 0))

        self._burn_source = burn_source
        self._queue_source = queue_source
        self._clock = clock or time.monotonic
        self._rand = random.Random(self.seed)
        self._lock = threading.Lock()
        self._state = NORMAL
        self._since = self._clock()
        self._severity = 0.0
        self._next_eval = 0.0
        self._lat_ewma_s = 0.0
        self._lat_last = 0.0
        self._queue_ewma = 0.0
        self._transitions: List[dict] = []

        self._m_state = registry.gauge(
            "gateway_admission_state",
            "admission state (0 NORMAL .. 3 SHED_HARD)")
        self._m_severity = registry.gauge(
            "gateway_admission_severity",
            "combined admission severity (1.0 = at threshold)")
        self._m_shed = registry.counter(
            "gateway_shed_total", "admissions shed, by state and verb")
        self._m_offered = registry.counter(
            "gateway_offered_total",
            "verb calls offered to admission (admitted + shed)")
        self._m_state.set(0.0)

    # -- live signal feeds --------------------------------------------------

    def observe_latency(self, latency_s: float) -> None:
        """Feed one orderer-ack latency sample (batcher thread)."""
        with self._lock:
            self._lat_ewma_s = latency_s if self._lat_ewma_s == 0.0 else \
                0.8 * self._lat_ewma_s + 0.2 * latency_s
            self._lat_last = self._clock()

    def _signals(self) -> dict:
        burn = None
        if self._burn_source is not None:
            try:
                burn = self._burn_source()
            except Exception:
                burn = None
        qfrac = 0.0
        if self._queue_source is not None:
            try:
                qfrac = float(self._queue_source())
            except Exception:
                qfrac = 0.0
        return {"burn": burn, "queue_frac": qfrac,
                "latency_ewma_s": self._lat_ewma_s}

    # -- severity + state machine -------------------------------------------

    def _compute_severity(self, sig: dict, now: float) -> float:
        sev = 0.0
        if sig["burn"] is not None:
            sev = max(sev, float(sig["burn"]))
        if self.queue_high_frac > 0.0:
            # EWMA the queue signal: a single coalesced batch draining
            # must not read as instant recovery
            self._queue_ewma = (0.5 * self._queue_ewma
                                + 0.5 * sig["queue_frac"])
            sev = max(sev, self._queue_ewma / self.queue_high_frac)
        if self.latency_slo_s > 0.0 and sig["latency_ewma_s"] > 0.0:
            # the EWMA only refreshes when a batch completes; once shed
            # has stopped all traffic there are no more acks, and a
            # frozen overload-era reading would wedge the controller in
            # a shed state forever (no traffic -> no samples -> no
            # recovery -> no traffic).  Latency EVIDENCE goes stale:
            # halve it per dwell period since the last sample.
            half = max(self.dwell_s, 4 * self.eval_interval_s)
            age = max(0.0, now - self._lat_last)
            lat = sig["latency_ewma_s"] * 0.5 ** (age / half)
            sev = max(sev, lat / self.latency_slo_s)
        return sev

    def _target_state(self, sev: float) -> int:
        if sev >= self.shed_hard_burn:
            return SHED_HARD
        if sev >= self.shed_probabilistic_burn:
            return SHED_PROBABILISTIC
        if sev >= self.shed_evaluate_burn:
            return SHED_EVALUATE
        return NORMAL

    def _entry_threshold(self, state: int) -> float:
        return (0.0, self.shed_evaluate_burn,
                self.shed_probabilistic_burn,
                self.shed_hard_burn)[state]

    def _transition(self, new: int, now: float, sev: float) -> None:
        old, self._state = self._state, new
        self._since = now
        self._m_state.set(float(new))
        rec = {"at": time.time(), "from": STATES[old], "to": STATES[new],
               "severity": round(sev, 3)}
        self._transitions.append(rec)
        del self._transitions[:-32]
        jlog(logger, "gateway.admission_transition",
             level=logging.WARNING if new > old else logging.INFO,
             **rec)

    def evaluate_state(self, now: Optional[float] = None) -> int:
        """Recompute severity and run one state-machine step.  Called
        inline from admit() (rate-limited) and from tests directly."""
        now = self._clock() if now is None else now
        with self._lock:
            sev = self._compute_severity(self._signals(), now)
            self._severity = sev
            self._m_severity.set(sev)
            target = self._target_state(sev)
            if target > self._state:
                # escalation is immediate: overload does not dwell
                self._transition(target, now, sev)
            elif target < self._state:
                # hysteretic recovery: one step down at a time, only
                # after dwell_s AND clearly below this state's entry bar
                entry = self._entry_threshold(self._state)
                if (now - self._since >= self.dwell_s
                        and sev < entry * self.recover_ratio):
                    self._transition(self._state - 1, now, sev)
            return self._state

    def _maybe_evaluate(self, now: float) -> None:
        if now >= self._next_eval:
            self._next_eval = now + self.eval_interval_s
            self.evaluate_state(now)

    # -- the admit verdict ---------------------------------------------------

    def _retry_after_ms(self, sev: float) -> int:
        hint = self.retry_after_base_ms * (1.0 + sev)
        return int(min(hint, self.retry_after_max_ms))

    def _decision(self, state: int, sev: float) -> ShedDecision:
        return ShedDecision(STATES[state], self._retry_after_ms(sev), sev)

    def admit(self, verb: str) -> Optional[ShedDecision]:
        """None = admitted; a ShedDecision = rejected.  `verb` is
        "evaluate" | "submit" | "endorse"; endorse sheds with evaluate
        (both are pre-ordering work the client can take elsewhere)."""
        if not self.enabled:
            return None
        now = self._clock()
        self._maybe_evaluate(now)
        try:
            self._m_offered.add(1, verb=verb)
        except Exception:
            pass
        with self._lock:
            state, sev = self._state, self._severity
            if state == NORMAL:
                return None
            if state == SHED_HARD:
                decision = self._decision(state, sev)
            elif verb in ("evaluate", "endorse"):
                # evaluates shed first, in EVERY shed state
                decision = self._decision(state, sev)
            elif state == SHED_PROBABILISTIC:
                # seeded coin weighted by how far past the probabilistic
                # threshold severity has climbed: p ramps 0 -> 1 across
                # [shed_probabilistic_burn, shed_hard_burn]
                span = self.shed_hard_burn - self.shed_probabilistic_burn
                p = 1.0 if span <= 0.0 else min(
                    1.0, max(0.1, (sev - self.shed_probabilistic_burn)
                             / span))
                if self._rand.random() >= p:
                    return None
                decision = self._decision(state, sev)
            else:
                return None           # SHED_EVALUATE admits submits
        try:
            self._m_shed.add(1, mode=decision.mode, verb=verb)
        except Exception:
            pass
        return decision

    # -- test + ops surface ---------------------------------------------------

    def force_state(self, state: int) -> None:
        """Pin a state (tests/drills); the next evaluate_state() may
        move it again, so pair with a far-future eval or disabled
        sources."""
        with self._lock:
            self._transition(int(state), self._clock(), self._severity)

    @property
    def state(self) -> int:
        with self._lock:
            return self._state

    @property
    def state_name(self) -> str:
        return STATES[self.state]

    def snapshot(self) -> dict:
        with self._lock:
            sig = self._signals()
            return {"enabled": self.enabled,
                    "state": STATES[self._state],
                    "severity": round(self._severity, 4),
                    "signals": {
                        "burn": sig["burn"],
                        "queue_frac": round(sig["queue_frac"], 4),
                        "queue_ewma": round(self._queue_ewma, 4),
                        "latency_ewma_s": round(sig["latency_ewma_s"], 4)},
                    "thresholds": {
                        "shed_evaluate_burn": self.shed_evaluate_burn,
                        "shed_probabilistic_burn":
                            self.shed_probabilistic_burn,
                        "shed_hard_burn": self.shed_hard_burn,
                        "recover_ratio": self.recover_ratio,
                        "dwell_s": self.dwell_s},
                    "transitions": list(self._transitions)}
