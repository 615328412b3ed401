"""Open-loop arrival processes: WHEN transactions fire.

The whole point of an open-loop driver (vs examples/gateway_load.py's
closed loop) is that arrivals are a property of the WORLD, not of the
system under test: a generator that waits for completions before
issuing the next request self-throttles under saturation and can never
exhibit queueing collapse — the Fabric benchmarking literature (arxiv
1805.11390) is explicit that overload regimes only appear under
open-loop arrival schedules.  Every process here therefore produces a
deterministic, seeded schedule of ABSOLUTE fire offsets computed up
front; the `OpenLoopScheduler` then fires submissions at those
wall-clock instants regardless of whether earlier ones completed.

All processes are non-homogeneous Poisson processes generated by
Lewis-Shedler thinning against the profile's peak rate: candidate
arrivals are drawn at `max_rate` from one seeded PRNG and accepted with
probability rate(t)/max_rate.  Two draws per candidate, in time order,
from one `random.Random(seed)` — so a schedule is a pure function of
(profile params, seed, duration) and a test can assert it exactly
without ever sleeping.

  ConstantArrivals(rate)                    memoryless steady state
  DiurnalArrivals(base, amplitude, period)  sinusoid day/night swing
  SquareWaveArrivals(low, high, period, duty)  bursts with hard edges
  RampArrivals(start, end)                  ramp-to-saturation probe

Counterpart of `fabric_tpu/workload/arrivals.py`, whole; stdlib only.
"""

from __future__ import annotations

import math
import random
import threading
import time
from typing import Callable, List, Optional

__all__ = ["ArrivalProcess", "ConstantArrivals", "DiurnalArrivals",
           "SquareWaveArrivals", "RampArrivals", "TraceArrivals",
           "OpenLoopScheduler", "from_spec"]


class ArrivalProcess:
    """Base: a deterministic rate profile rate(t) thinned at max_rate."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    # subclasses override -------------------------------------------------
    def rate(self, t: float) -> float:
        raise NotImplementedError

    def max_rate(self) -> float:
        raise NotImplementedError

    # schedule generation -------------------------------------------------
    def schedule(self, duration_s: float) -> List[float]:
        """Absolute fire offsets in [0, duration_s), ascending.  Pure:
        same (params, seed, duration) -> byte-identical schedule."""
        lam = float(self.max_rate())
        if lam <= 0.0 or duration_s <= 0.0:
            return []
        rnd = random.Random(self.seed)
        out: List[float] = []
        t = 0.0
        while True:
            # candidate stream at the peak rate ...
            t += rnd.expovariate(lam)
            if t >= duration_s:
                return out
            # ... thinned to the instantaneous profile rate
            if rnd.random() * lam < self.rate(t):
                out.append(t)

    def mean_rate(self, duration_s: float, steps: int = 256) -> float:
        """Time-averaged profile rate (for offered-load reporting)."""
        if duration_s <= 0.0:
            return 0.0
        dt = duration_s / steps
        return sum(self.rate((i + 0.5) * dt) for i in range(steps)) / steps

    def describe(self) -> dict:
        return {"kind": type(self).__name__, "seed": self.seed,
                "max_rate": self.max_rate()}

    @staticmethod
    def from_trace(path: str, phase: Optional[str] = None
                   ) -> "TraceArrivals":
        """Replay a recorded arrival trace (jsonl, one fire per line).

        Accepts the runner's --save-trace format ({"phase": ..., "t":
        offset}) as well as bare-number lines; `phase` filters a
        multi-phase trace down to one phase's offsets.  Replays are the
        reproducibility end of the open-loop story: a schedule captured
        from one run (or converted from a production gateway log) re-
        fires at identical offsets, no PRNG involved."""
        import json
        offsets: List[float] = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                if isinstance(rec, dict):
                    if phase is not None and rec.get("phase") != phase:
                        continue
                    offsets.append(float(rec["t"]))
                else:
                    offsets.append(float(rec))
        return TraceArrivals(offsets, path=path)


class ConstantArrivals(ArrivalProcess):
    """Homogeneous Poisson: constant offered rate, memoryless gaps."""

    def __init__(self, rate: float, seed: int = 0):
        super().__init__(seed)
        self._rate = float(rate)

    def rate(self, t: float) -> float:
        return self._rate

    def max_rate(self) -> float:
        return self._rate


class DiurnalArrivals(ArrivalProcess):
    """Sinusoid swing around a base rate — the day/night profile.

    rate(t) = base * (1 + amplitude * sin(2*pi*t/period)), clamped at 0.
    amplitude in [0, 1]: 1.0 swings between 0 and 2*base.
    """

    def __init__(self, base_rate: float, amplitude: float = 0.5,
                 period_s: float = 60.0, seed: int = 0):
        super().__init__(seed)
        self.base_rate = float(base_rate)
        self.amplitude = min(max(float(amplitude), 0.0), 1.0)
        self.period_s = float(period_s)

    def rate(self, t: float) -> float:
        return max(0.0, self.base_rate * (
            1.0 + self.amplitude * math.sin(2.0 * math.pi * t
                                            / self.period_s)))

    def max_rate(self) -> float:
        return self.base_rate * (1.0 + self.amplitude)


class SquareWaveArrivals(ArrivalProcess):
    """Hard-edged bursts: `duty` fraction of each period at `high_rate`,
    the rest at `low_rate`.  The burst profile that exposes admission
    cliffs a sinusoid's gentle shoulder hides."""

    def __init__(self, low_rate: float, high_rate: float,
                 period_s: float = 10.0, duty: float = 0.3, seed: int = 0):
        super().__init__(seed)
        self.low_rate = float(low_rate)
        self.high_rate = float(high_rate)
        self.period_s = float(period_s)
        self.duty = min(max(float(duty), 0.0), 1.0)

    def rate(self, t: float) -> float:
        phase = (t % self.period_s) / self.period_s
        return self.high_rate if phase < self.duty else self.low_rate

    def max_rate(self) -> float:
        return max(self.low_rate, self.high_rate)


class RampArrivals(ArrivalProcess):
    """Linear ramp from start_rate to end_rate over ramp_s, then hold.

    The saturation probe: ramp past the measured capacity and watch
    where acceptance detaches from offer."""

    def __init__(self, start_rate: float, end_rate: float,
                 ramp_s: float = 10.0, seed: int = 0):
        super().__init__(seed)
        self.start_rate = float(start_rate)
        self.end_rate = float(end_rate)
        self.ramp_s = float(ramp_s)

    def rate(self, t: float) -> float:
        if self.ramp_s <= 0.0 or t >= self.ramp_s:
            return self.end_rate
        f = t / self.ramp_s
        return self.start_rate + f * (self.end_rate - self.start_rate)

    def max_rate(self) -> float:
        return max(self.start_rate, self.end_rate)


class TraceArrivals(ArrivalProcess):
    """A verbatim recorded schedule: fire offsets come from a trace,
    not a process.  `schedule(duration)` clips to the window; rate() is
    the empirical mean (reporting only — nothing is drawn)."""

    def __init__(self, offsets: List[float], path: str = "<trace>"):
        super().__init__(seed=0)
        self.offsets = sorted(float(t) for t in offsets)
        self.path = path

    def rate(self, t: float) -> float:
        if not self.offsets:
            return 0.0
        span = max(self.offsets[-1], 1e-9)
        return len(self.offsets) / span

    def max_rate(self) -> float:
        return self.rate(0.0)

    def schedule(self, duration_s: float) -> List[float]:
        return [t for t in self.offsets if 0.0 <= t < duration_s]

    def describe(self) -> dict:
        return {"kind": "TraceArrivals", "path": self.path,
                "n": len(self.offsets)}


_SPECS = {
    "constant": lambda a, seed: ConstantArrivals(
        float(a.get("rate", 10.0)), seed=seed),
    "diurnal": lambda a, seed: DiurnalArrivals(
        float(a.get("base_rate", 10.0)), float(a.get("amplitude", 0.5)),
        float(a.get("period_s", 60.0)), seed=seed),
    "burst": lambda a, seed: SquareWaveArrivals(
        float(a.get("low_rate", 5.0)), float(a.get("high_rate", 50.0)),
        float(a.get("period_s", 10.0)), float(a.get("duty", 0.3)),
        seed=seed),
    "ramp": lambda a, seed: RampArrivals(
        float(a.get("start_rate", 1.0)), float(a.get("end_rate", 50.0)),
        float(a.get("ramp_s", 10.0)), seed=seed),
    # {"kind": "trace", "path": "run.jsonl", "phase": "ramp"} — replay;
    # the seed is irrelevant by design (recorded offsets, no draws)
    "trace": lambda a, seed: ArrivalProcess.from_trace(
        str(a["path"]), phase=a.get("phase")),
}


def from_spec(spec: dict, seed: int = 0) -> ArrivalProcess:
    """{"kind": "ramp", "end_rate": 80, ...} -> ArrivalProcess."""
    kind = str(spec.get("kind", "constant"))
    if kind not in _SPECS:
        raise ValueError(f"unknown arrival kind {kind!r} "
                         f"(one of {sorted(_SPECS)})")
    return _SPECS[kind](spec, seed)


class OpenLoopScheduler:
    """Fires `fire(i, t_sched)` at each schedule offset on the wall
    clock, never waiting for completions.

    `fire` must not block (the runner hands work to a thread pool); if
    it stalls anyway, the scheduler keeps its own clock honest by
    counting how far behind schedule each fire happened (`max_skew_s`)
    instead of silently stretching the experiment — a driver that slips
    its schedule is a closed loop wearing an open-loop costume.
    """

    def __init__(self, schedule: List[float],
                 fire: Callable[[int, float], None],
                 clock=None, sleep=None):
        self.schedule = list(schedule)
        self.fire = fire
        self._clock = clock or time.monotonic
        self._sleep = sleep or time.sleep
        self.fired = 0
        self.max_skew_s = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def run(self) -> None:
        t0 = self._clock()
        for i, offset in enumerate(self.schedule):
            if self._stop.is_set():
                break
            while True:
                lag = (t0 + offset) - self._clock()
                if lag <= 0.0 or self._stop.is_set():
                    break
                self._sleep(min(lag, 0.05))
            if self._stop.is_set():
                break
            skew = self._clock() - (t0 + offset)
            if skew > self.max_skew_s:
                self.max_skew_s = skew
            self.fire(i, offset)
            self.fired += 1

    def start(self) -> "OpenLoopScheduler":
        self._thread = threading.Thread(target=self.run,
                                        name="openloop-arrivals",
                                        daemon=True)
        self._thread.start()
        return self

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def stop(self) -> None:
        self._stop.set()
