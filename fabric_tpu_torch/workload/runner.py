"""WorkloadRunner: open-loop phases -> per-phase offered/accepted/
committed accounting.

Glues the three generator pieces together: an arrival process says WHEN
(arrivals.py), a traffic mix says WHAT (keyspace.py), a client
population says WHO (clients.py).  Each phase runs one arrival schedule
open-loop — the scheduler thread fires every arrival at its wall-clock
instant and hands the op to a worker pool, so a saturated system under
test shows up as driver backlog + shed + sojourn blowup, never as a
quietly stretched schedule.

Accounting is per phase and three-tiered, the shape the overload
analysis needs:

  offered     arrivals the schedule generated (property of the world)
  accepted    submissions the gateway admitted (post-shed, post-
              backpressure); sojourn percentiles (p50/p99/p999) are
              measured on these, scheduler-arrival -> orderer ack
  committed   transactions the committer recorded VALID; MVCC and
              phantom losers are counted as conflicts (the conflict
              dial's empirical readout)

Two execution modes per op:

  inline      endorse -> assemble -> submit in the worker (the full
              client lifecycle; endorsement itself is sheddable)
  pool        envelopes pre-endorsed up front via `prepare(op)`; the
              open-loop phase then exercises ONLY the admission/order
              path — the mode overload probes use, since software P-256
              endorsement would otherwise rate-limit the driver itself

Counterpart of `fabric_tpu/workload/runner.py`, whole, on the port's
imports.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, Dict, List, Optional

from fabric_tpu_torch.comm import RpcError
from fabric_tpu_torch.endorser.proposal import assemble_transaction
from fabric_tpu_torch.gateway.client import GatewayError, GatewayShedError
from fabric_tpu_torch.protocol.txflags import ValidationCode
from fabric_tpu_torch.workload.arrivals import OpenLoopScheduler, from_spec
from fabric_tpu_torch.workload.clients import ClientPopulation, ThinkTimeModel
from fabric_tpu_torch.workload.keyspace import Op, TrafficMix

logger = logging.getLogger("fabric_tpu_torch.workload")

__all__ = ["WorkloadRunner", "PhaseStats", "pct"]

_CONFLICT_CODES = {int(ValidationCode.MVCC_READ_CONFLICT),
                   int(ValidationCode.PHANTOM_READ_CONFLICT)}


def pct(xs: List[float], q: float) -> Optional[float]:
    if not xs:
        return None
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def _lat_ms(xs: List[float]) -> Optional[dict]:
    if not xs:
        return None
    return {"p50": round(pct(xs, 0.50) * 1e3, 2),
            "p99": round(pct(xs, 0.99) * 1e3, 2),
            "p999": round(pct(xs, 0.999) * 1e3, 2),
            "max": round(max(xs) * 1e3, 2), "n": len(xs)}


class PhaseStats:
    """One phase's counters; workers update under the lock."""

    def __init__(self, name: str, duration_s: float, offered: int):
        self.name = name
        self.duration_s = float(duration_s)
        self.offered = int(offered)
        self.lock = threading.Lock()
        self.fired = 0
        self.accepted = 0
        self.shed = 0
        self.backpressure = 0
        self.dedup = 0
        self.errors = 0
        self.committed = 0
        self.conflicts = 0
        self.other_codes: Dict[str, int] = {}
        self.sojourns: List[float] = []      # arrival -> orderer ack
        self.commit_lat: List[float] = []    # arrival -> validation code
        self.evaluated = 0
        self.wall_s = 0.0
        self.max_skew_s = 0.0
        self.backlog_max = 0
        # per-client think-time shaping (phase key `think`): arrivals
        # pushed past the raw schedule by the owning client's delay
        self.think: Optional[dict] = None
        self.think_delayed = 0
        self.think_added_s = 0.0

    def report(self) -> dict:
        wall = max(self.wall_s, 1e-9)
        dur = max(self.duration_s, 1e-9)
        out = {
            "name": self.name, "duration_s": self.duration_s,
            "wall_s": round(self.wall_s, 3),
            "offered": self.offered,
            "offered_rate": round(self.offered / dur, 2),
            "fired": self.fired,
            "max_skew_s": round(self.max_skew_s, 4),
            "driver_backlog_max": self.backlog_max,
            "accepted": self.accepted,
            "accepted_rate": round(self.accepted / wall, 2),
            "evaluated": self.evaluated,
            "shed": self.shed,
            "shed_frac": round(self.shed / self.fired, 4)
            if self.fired else 0.0,
            "backpressure": self.backpressure,
            "dedup": self.dedup, "errors": self.errors,
            "committed": self.committed,
            "committed_rate": round(self.committed / wall, 2),
            "conflicts": self.conflicts,
            "conflict_frac": round(
                self.conflicts / (self.committed + self.conflicts), 4)
            if (self.committed + self.conflicts) else 0.0,
            "sojourn_ms": _lat_ms(self.sojourns),
            "commit_ms": _lat_ms(self.commit_lat),
        }
        if self.other_codes:
            out["other_codes"] = dict(self.other_codes)
        if self.think is not None:
            out["think"] = dict(self.think,
                                delayed=self.think_delayed,
                                added_s=round(self.think_added_s, 3))
        return out


class _Job:
    __slots__ = ("stats", "op", "env", "client_id", "t_arr", "track")

    def __init__(self, stats, op, env, client_id, t_arr, track):
        self.stats = stats
        self.op = op
        self.env = env
        self.client_id = client_id
        self.t_arr = t_arr
        self.track = track


class WorkloadRunner:
    """Run phases of open-loop load against one gateway peer.

    phases: [{"name": "ramp", "duration_s": 10,
              "arrivals": {"kind": "ramp", "end_rate": 80, ...}}, ...]
            a phase may carry an explicit "schedule": [offsets] instead
            of an arrivals spec (cold-start stampedes are hand-built).
    prepare: optional op -> Envelope hook; set -> pool mode (envelopes
            pre-endorsed before each phase starts firing).
    signer: needed for inline mode's assemble_transaction.
    """

    def __init__(self, clients: ClientPopulation, mix: TrafficMix,
                 phases: List[dict], *, signer=None,
                 prepare: Optional[Callable[[Op], object]] = None,
                 workers: int = 8, seed: int = 0,
                 submit_timeout_s: float = 15.0,
                 commit_timeout_s: float = 30.0,
                 track_commits: bool = True,
                 commit_every: int = 1,
                 drain_timeout_s: float = 45.0,
                 save_trace: Optional[str] = None):
        self.clients = clients
        self.mix = mix
        self.phases = list(phases)
        self.signer = signer
        self.prepare = prepare
        self.workers = int(workers)
        self.seed = int(seed)
        self.submit_timeout_s = float(submit_timeout_s)
        self.commit_timeout_s = float(commit_timeout_s)
        self.track_commits = bool(track_commits)
        # a commit_status wait parks a worker for the full commit
        # latency; tracking every k-th tx keeps the committed-rate
        # estimate honest without the tracker itself throttling the
        # open loop at overload rates
        self.commit_every = max(1, int(commit_every))
        self.drain_timeout_s = float(drain_timeout_s)
        # jsonl arrival trace: one {"phase", "i", "t"} line per fire
        # offset, replayable via {"kind": "trace", "path": ...}
        self.save_trace = save_trace
        self._jobs: "queue.Queue" = queue.Queue()
        self._outstanding = 0
        self._out_lock = threading.Lock()
        self._out_cv = threading.Condition(self._out_lock)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self.phase_stats: List[PhaseStats] = []

    # -- op -> gateway call -------------------------------------------------

    @staticmethod
    def _call_shape(op: Op):
        """(fn, args) for an op against the built-in asset contract:
        writes are read-modify-write `bump`s (MVCC-conflictable), reads
        evaluate the same, ranges `scan` (phantom-conflictable)."""
        if op.kind == "range":
            return "scan", [op.key.encode(), (op.end_key
                                              or op.key).encode()]
        return "bump", [op.key.encode()]

    def _build_inline(self, gw, op: Op):
        fn, args = self._call_shape(op)
        sp, responses = gw.endorse(op.chaincode, fn, args,
                                   channel=op.channel)
        # the envelope signature must come from the proposal's creator:
        # mixed-identity populations carry per-connection signers
        return assemble_transaction(
            sp, responses, getattr(gw, "signer", None) or self.signer)

    def _execute(self, job: _Job) -> None:
        st = job.stats
        op = job.op
        gw = self.clients.conn_for(job.client_id)
        try:
            if op.kind == "read":
                # read path: evaluate only, nothing ordered
                fn, args = self._call_shape(op)
                gw.evaluate(op.chaincode, fn, args, channel=op.channel)
                now = time.monotonic()
                with st.lock:
                    st.evaluated += 1
                    st.sojourns.append(now - job.t_arr)
                self.clients.record(job.client_id)
                return
            env = job.env if job.env is not None \
                else self._build_inline(gw, op)
            out = gw.submit_envelope(env, timeout_s=self.submit_timeout_s)
            t_ack = time.monotonic()
            with st.lock:
                st.accepted += 1
                st.sojourns.append(t_ack - job.t_arr)
                if out.get("deduped"):
                    st.dedup += 1
            self.clients.record(job.client_id)
            if not job.track:
                return
            txid = env.header().channel_header.txid
            code, _ = gw.commit_status(txid, channel=op.channel,
                                       timeout_s=self.commit_timeout_s)
            t_commit = time.monotonic()
            with st.lock:
                st.commit_lat.append(t_commit - job.t_arr)
                if code == int(ValidationCode.VALID):
                    st.committed += 1
                elif code in _CONFLICT_CODES:
                    st.conflicts += 1
                else:
                    try:
                        name = ValidationCode(code).name
                    except ValueError:
                        name = str(code)
                    st.other_codes[name] = st.other_codes.get(name, 0) + 1
        except GatewayShedError:
            with st.lock:
                st.shed += 1
            self.clients.record(job.client_id, sheds=1)
        except GatewayError as exc:
            if exc.status == int(ValidationCode.MVCC_READ_CONFLICT) or \
                    exc.status in _CONFLICT_CODES:
                # submit_transaction-style conflict surfaced as an error
                with st.lock:
                    st.conflicts += 1
                self.clients.record(job.client_id)
            else:
                with st.lock:
                    st.errors += 1
                self.clients.record(job.client_id, error=True)
        except RpcError as exc:
            field = "backpressure" if "backpressure" in str(exc) \
                else "errors"
            with st.lock:
                setattr(st, field, getattr(st, field) + 1)
            self.clients.record(job.client_id,
                                error=(field == "errors"))
        except Exception:
            logger.exception("workload op failed")
            with st.lock:
                st.errors += 1
            self.clients.record(job.client_id, error=True)

    # -- worker pool --------------------------------------------------------

    def _worker(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                return
            try:
                self._execute(job)
            finally:
                with self._out_cv:
                    self._outstanding -= 1
                    if self._outstanding == 0:
                        self._out_cv.notify_all()

    def _start_pool(self) -> None:
        self._threads = [
            threading.Thread(target=self._worker,
                             name=f"workload-{i}", daemon=True)
            for i in range(self.workers)]
        for t in self._threads:
            t.start()

    def _stop_pool(self) -> None:
        for _ in self._threads:
            self._jobs.put(None)
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []

    def _drain(self, timeout_s: float) -> bool:
        deadline = time.monotonic() + timeout_s
        with self._out_cv:
            while self._outstanding > 0:
                left = deadline - time.monotonic()
                if left <= 0.0:
                    return False
                self._out_cv.wait(min(left, 0.25))
        return True

    # -- phases -------------------------------------------------------------

    def _run_phase(self, phase: dict, index: int) -> PhaseStats:
        name = str(phase.get("name", f"phase{index}"))
        if "schedule" in phase:
            schedule = [float(t) for t in phase["schedule"]]
            duration = float(phase.get(
                "duration_s", schedule[-1] if schedule else 0.0))
        else:
            duration = float(phase["duration_s"])
            proc = from_spec(phase["arrivals"],
                             seed=self.seed * 101 + index)
            schedule = proc.schedule(duration)
        stats = PhaseStats(name, duration, len(schedule))
        self.phase_stats.append(stats)
        if self.save_trace:
            import json as _json
            with open(self.save_trace, "a") as tf:
                for i, t in enumerate(schedule):
                    tf.write(_json.dumps(
                        {"phase": name, "i": i, "t": round(t, 6)}) + "\n")

        # pool mode: pre-endorse one envelope per scheduled arrival so
        # the open-loop phase pays ONLY admission+ordering per fire
        ops = [self.mix.next_op() for _ in schedule]
        envs: List[Optional[object]] = [None] * len(schedule)
        if self.prepare is not None:
            for i, op in enumerate(ops):
                if op.kind == "read":
                    continue
                while True:
                    try:
                        envs[i] = self.prepare(op)
                        break
                    except GatewayShedError as exc:
                        # pool building between phases rides out shed
                        # windows (endorsement sheds in every shed
                        # state): it is pre-load work, not part of the
                        # measured phase, so honoring the hint here
                        # never skews a phase's numbers
                        time.sleep(min(
                            max(exc.retry_after_ms, 50) / 1000.0, 1.0))

        # per-client open-loop think time (phase key `think`): pre-draw
        # the owning client per arrival, then push each client's ops at
        # least its think delay apart — the arrival process still sets
        # the AGGREGATE offered load, but each client's stream turns
        # bursty-with-pauses the way real submitters are.  The re-sort
        # keeps (offset, op, env, client) association intact.
        clients_for: Optional[List[int]] = None
        if phase.get("think"):
            model = ThinkTimeModel.from_spec(
                phase["think"], seed=self.seed * 211 + index)
            clients_for = [self.clients.next_client() for _ in schedule]
            last_at: Dict[int, float] = {}
            adjusted: List[float] = []
            for i, t in enumerate(schedule):
                c = clients_for[i]
                t2 = t
                prev = last_at.get(c)
                if prev is not None:
                    t2 = max(t, prev + model.delay(c))
                    if t2 > t:
                        stats.think_delayed += 1
                        stats.think_added_s += t2 - t
                last_at[c] = t2
                adjusted.append(t2)
            order = sorted(range(len(schedule)),
                           key=lambda i: (adjusted[i], i))
            schedule = [adjusted[i] for i in order]
            ops = [ops[i] for i in order]
            envs = [envs[i] for i in order]
            clients_for = [clients_for[i] for i in order]
            stats.think = model.describe()

        t_start = time.monotonic()

        def fire(i: int, offset: float) -> None:
            track = self.track_commits and i % self.commit_every == 0
            client = (clients_for[i] if clients_for is not None
                      else self.clients.next_client())
            job = _Job(stats, ops[i], envs[i],
                       client, time.monotonic(),
                       track)
            with self._out_cv:
                self._outstanding += 1
            backlog = self._jobs.qsize()
            if backlog > stats.backlog_max:
                stats.backlog_max = backlog
            self._jobs.put(job)
            stats.fired += 1

        sched = OpenLoopScheduler(schedule, fire)
        sched.run()                      # blocks for the phase duration
        if not self._drain(self.drain_timeout_s):
            logger.warning("phase %s: drain timed out with %d "
                           "outstanding ops", name, self._outstanding)
        stats.wall_s = time.monotonic() - t_start
        stats.max_skew_s = sched.max_skew_s
        return stats

    def run(self) -> dict:
        self._start_pool()
        try:
            for i, phase in enumerate(self.phases):
                self._run_phase(phase, i)
        finally:
            self._stop_pool()
        return self.report()

    # -- reporting ----------------------------------------------------------

    def report(self) -> dict:
        phases = [s.report() for s in self.phase_stats]
        tot = {k: sum(p[k] for p in phases) for k in
               ("offered", "fired", "accepted", "evaluated", "shed",
                "backpressure", "dedup", "errors", "committed",
                "conflicts")}
        wall = sum(p["wall_s"] for p in phases)
        all_sojourn = [x for s in self.phase_stats for x in s.sojourns]
        all_commit = [x for s in self.phase_stats for x in s.commit_lat]
        tot.update({
            "wall_s": round(wall, 3),
            "offered_rate": round(tot["offered"] / wall, 2)
            if wall else 0.0,
            "accepted_rate": round(tot["accepted"] / wall, 2)
            if wall else 0.0,
            "committed_rate": round(tot["committed"] / wall, 2)
            if wall else 0.0,
            "shed_frac": round(tot["shed"] / tot["fired"], 4)
            if tot["fired"] else 0.0,
            "conflict_frac": round(
                tot["conflicts"] / (tot["committed"] + tot["conflicts"]),
                4) if (tot["committed"] + tot["conflicts"]) else 0.0,
            "sojourn_ms": _lat_ms(all_sojourn),
            "commit_ms": _lat_ms(all_commit)})
        return {"seed": self.seed, "workers": self.workers,
                "commit_every": self.commit_every,
                "mode": "pool" if self.prepare is not None else "inline",
                "mix": self.mix.describe(),
                "clients": self.clients.totals(),
                "phases": phases, "totals": tot}
