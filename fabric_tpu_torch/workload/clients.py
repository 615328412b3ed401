"""Client population: millions of client IDENTITIES over few SOCKETS.

A million-user deployment does not mean a million TCP connections —
SDKs pool and multiplex — but it does mean a million independent
client *behaviours*: distinct submitter ids, skewed per-client issue
rates, and correlated pathologies (everyone reconnecting at once after
a load balancer blip, everyone arriving cold at market open).  This
module models exactly that split:

  ClientPopulation(population, sockets)  maps a Zipf-skewed draw over
      `population` client ids onto `sockets` pooled GatewayClient
      connections (client_id % sockets), so per-client bookkeeping
      scales with the population while the OS fd table scales with the
      pool.

Scenarios (both seeded, both composable with any arrival process):

  reconnect_storm(fraction)   close that fraction of pooled sockets at
      once; the next op on each redials, modelling the post-blip dial
      stampede that turns a hiccup into an outage.
  stampede_schedule(n, window_s)  a cold-start burst: n arrivals
      crammed into the first window_s (uniform, seeded) — prepend to
      any schedule for the market-open profile.
  ThinkTimeModel              per-client open-loop think time: each
      client id gets its own seeded exponential/lognormal delay stream,
      so a client's successive ops are spaced like a human's (bursts
      and pauses), not like a Poisson process's — the per-client burst
      structure is what cross-block conflict drills need to look real.

Counterpart of `fabric_tpu/workload/clients.py`, whole, on the port's
imports.
"""

from __future__ import annotations

import math
import random
import threading
from typing import Callable, Dict, List, Optional

from fabric_tpu_torch.workload.keyspace import ZipfSampler

__all__ = ["ClientPopulation", "ThinkTimeModel"]


class ThinkTimeModel:
    """Seeded per-client think-time delays.

    Scenario-dict spec (WorkloadRunner phase key `think`):
        {"kind": "exponential", "mean_s": 0.5}
        {"kind": "lognormal", "median_s": 0.3, "sigma": 1.0}

    Each client id owns an independent `random.Random` stream derived
    from (seed, client_id), so the k-th think delay of client c is a
    pure function of (spec, seed, c, k): re-running a scenario replays
    the exact same per-client burst pattern regardless of how other
    clients' draws interleave."""

    KINDS = ("exponential", "lognormal")

    def __init__(self, kind: str = "exponential", mean_s: float = 0.5,
                 median_s: float = 0.3, sigma: float = 1.0,
                 seed: int = 0):
        if kind not in self.KINDS:
            raise ValueError(f"unknown think-time kind {kind!r} "
                             f"(one of {self.KINDS})")
        self.kind = kind
        self.mean_s = float(mean_s)
        self.median_s = float(median_s)
        self.sigma = float(sigma)
        self.seed = int(seed)
        self._streams: Dict[int, random.Random] = {}

    @classmethod
    def from_spec(cls, spec: dict, seed: int = 0) -> "ThinkTimeModel":
        kind = str(spec.get("kind", "exponential"))
        return cls(kind=kind,
                   mean_s=float(spec.get("mean_s", 0.5)),
                   median_s=float(spec.get("median_s", 0.3)),
                   sigma=float(spec.get("sigma", 1.0)),
                   seed=seed)

    def _stream(self, client_id: int) -> random.Random:
        rng = self._streams.get(client_id)
        if rng is None:
            rng = self._streams[client_id] = random.Random(
                (self.seed * 1_000_003) ^ (int(client_id) * 2_654_435_761))
        return rng

    def delay(self, client_id: int) -> float:
        """The client's next think delay (seconds, >= 0)."""
        rng = self._stream(client_id)
        if self.kind == "exponential":
            return rng.expovariate(1.0 / self.mean_s) \
                if self.mean_s > 0 else 0.0
        # lognormal parameterized by its median: exp(mu) = median_s
        mu = math.log(self.median_s) if self.median_s > 0 else 0.0
        return rng.lognormvariate(mu, self.sigma)

    def describe(self) -> dict:
        d = {"kind": self.kind, "seed": self.seed}
        if self.kind == "exponential":
            d["mean_s"] = self.mean_s
        else:
            d.update(median_s=self.median_s, sigma=self.sigma)
        return d


class _ClientStats:
    __slots__ = ("ops", "sheds", "retries", "errors")

    def __init__(self):
        self.ops = 0
        self.sheds = 0
        self.retries = 0
        self.errors = 0


class ClientPopulation:
    """A seeded population of client ids multiplexed over a socket pool.

    `factory(slot)` builds one pooled connection (a GatewayClient, or
    any object with .close()); slots dial lazily on first use unless
    `warm()` is called (the cold-start stampede dials them all at
    once).  Thread-safe: the arrival scheduler's pool workers draw
    client ids and resolve sockets concurrently.
    """

    def __init__(self, population: int, sockets: int,
                 factory: Callable[[int], object],
                 skew_s: float = 1.0, seed: int = 0):
        if population < 1 or sockets < 1:
            raise ValueError("population and sockets must be >= 1")
        self.population = int(population)
        self.sockets = int(sockets)
        self.factory = factory
        # per-client issue-rate skew: heavy users exist in every real
        # population, and they are the ones whose dedup/shed behaviour
        # matters (same identity retrying through the same socket)
        self._sampler = ZipfSampler(self.population, skew_s, seed=seed)
        self._rand = random.Random(seed * 31 + 7)
        self._lock = threading.Lock()
        self._conns: Dict[int, object] = {}
        self.stats: Dict[int, _ClientStats] = {}
        self.dials = 0
        self.reconnects = 0

    # -- id / socket resolution -------------------------------------------

    def next_client(self) -> int:
        """Draw a client id (1-based rank; 1 = heaviest user)."""
        return self._sampler.rank()

    def slot_of(self, client_id: int) -> int:
        return (client_id - 1) % self.sockets

    def conn_for(self, client_id: int):
        """The pooled connection this client id multiplexes over,
        dialing the slot on first use."""
        slot = self.slot_of(client_id)
        with self._lock:
            conn = self._conns.get(slot)
            if conn is None:
                conn = self.factory(slot)
                self._conns[slot] = conn
                self.dials += 1
            return conn

    def warm(self) -> int:
        """Dial every slot NOW — the cold-start stampede's opening move
        (and the fixture step for latency runs that should not charge
        the first arrivals for dials)."""
        for slot in range(self.sockets):
            with self._lock:
                if slot in self._conns:
                    continue
                self._conns[slot] = self.factory(slot)
                self.dials += 1
            # actually establish the socket (a GatewayClient dials
            # lazily on first call — "warm" must mean connected)
            warm = getattr(self._conns[slot], "warm", None)
            if warm is not None:
                warm()
        return self.sockets

    # -- per-client bookkeeping -------------------------------------------

    def record(self, client_id: int, *, sheds: int = 0, retries: int = 0,
               error: bool = False) -> None:
        with self._lock:
            st = self.stats.get(client_id)
            if st is None:
                st = self.stats[client_id] = _ClientStats()
            st.ops += 1
            st.sheds += sheds
            st.retries += retries
            if error:
                st.errors += 1

    def totals(self) -> dict:
        with self._lock:
            ops = sum(s.ops for s in self.stats.values())
            sheds = sum(s.sheds for s in self.stats.values())
            retries = sum(s.retries for s in self.stats.values())
            errors = sum(s.errors for s in self.stats.values())
            shed_clients = sum(1 for s in self.stats.values() if s.sheds)
            return {"population": self.population,
                    "sockets": self.sockets,
                    "active_clients": len(self.stats),
                    "ops": ops, "sheds": sheds, "retries": retries,
                    "errors": errors,
                    "clients_shed": shed_clients,
                    "client_shed_frac": (shed_clients / len(self.stats)
                                         if self.stats else 0.0),
                    "dials": self.dials, "reconnects": self.reconnects}

    # -- scenarios ---------------------------------------------------------

    def reconnect_storm(self, fraction: float = 1.0) -> int:
        """Close `fraction` of the live pooled sockets simultaneously
        (seeded choice).  The next op on each slot redials — so a storm
        at time T turns into a dial burst riding on top of whatever the
        arrival process is already offering."""
        with self._lock:
            live = sorted(self._conns)
            n = max(1, int(len(live) * min(max(fraction, 0.0), 1.0))) \
                if live else 0
            victims = self._rand.sample(live, n) if n else []
            conns = [self._conns.pop(s) for s in victims]
            self.reconnects += len(conns)
        for c in conns:
            try:
                c.close()
            except Exception:
                pass
        return len(conns)

    def stampede_schedule(self, n: int, window_s: float = 1.0) -> List[float]:
        """n cold-start arrivals crammed uniformly into the first
        window_s — prepend to an arrival schedule for the market-open /
        post-outage reconnect profile."""
        return sorted(self._rand.uniform(0.0, window_s) for _ in range(n))

    def close(self) -> None:
        with self._lock:
            conns, self._conns = list(self._conns.values()), {}
        for c in conns:
            try:
                c.close()
            except Exception:
                pass
