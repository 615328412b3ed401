"""CLI: boot an in-process network, run a named open-loop scenario,
print the JSON report.

    python -m fabric_tpu_torch.workload \
        --scenario ramp --rate 40 --duration 12 --zipf-s 1.1

Scenario catalog (all seeded; --rate R is the nominal offered rate):

  poisson          constant-rate Poisson at R for the whole run
  diurnal          sinusoid day/night swing around R
  burst            square-wave: R/5 baseline, 2R bursts
  ramp             ramp 0 -> 2R, hold at 2R, then recover at R/5 —
                   the saturation probe (watch shed states + hysteresis)
  stampede         cold-start: half the run's arrivals crammed into the
                   first second, then steady R
  reconnect-storm  steady R with every pooled socket cut mid-run

The booted peer runs with admission ENABLED (aggressive thresholds so
short runs exhibit shedding) and a tight SLO evaluator.  The report
carries the runner's per-phase offered/accepted/committed rates and
sojourn percentiles plus the gateway's admission snapshot (state
transitions included) and client-perceived shed counters.

Counterpart of `fabric_tpu/workload/__main__.py` on the port's imports.
One deliberate difference: `--bccsp {CUDA,SW}` (default CUDA) is the
factory's default and is written into every booted node's config, and
is passed to catalog scenarios; the reference hard-codes SW.  The CUDA
provider is fail-stop: without a card the run raises before any node
starts.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import threading
import time
from typing import Optional

from fabric_tpu_torch.bccsp.factory import FactoryOpts, init_factories
from fabric_tpu_torch.config import BatchConfig
from fabric_tpu_torch.endorser.proposal import assemble_transaction
from fabric_tpu_torch.gateway import GatewayClient
from fabric_tpu_torch.node.orderer import OrdererNode, load_signing_identity
from fabric_tpu_torch.node.peer import PeerNode
from fabric_tpu_torch.node.provision import provision_network
from fabric_tpu_torch.workload.clients import ClientPopulation
from fabric_tpu_torch.workload.keyspace import TrafficMix
from fabric_tpu_torch.workload.runner import WorkloadRunner


def build_phases(scenario: str, rate: float, duration: float,
                 seed: int) -> list:
    """Scenario name -> phase list for the WorkloadRunner."""
    r = float(rate)
    d = float(duration)
    if scenario == "poisson":
        return [{"name": "steady", "duration_s": d,
                 "arrivals": {"kind": "constant", "rate": r}}]
    if scenario == "diurnal":
        return [{"name": "diurnal", "duration_s": d,
                 "arrivals": {"kind": "diurnal", "base_rate": r,
                              "amplitude": 0.8, "period_s": d / 2.0}}]
    if scenario == "burst":
        return [{"name": "bursts", "duration_s": d,
                 "arrivals": {"kind": "burst", "low_rate": r / 5.0,
                              "high_rate": 2.0 * r,
                              "period_s": max(d / 3.0, 2.0),
                              "duty": 0.3}}]
    if scenario == "ramp":
        ramp_d = d * 0.5
        hold_d = d * 0.25
        rec_d = d * 0.25
        return [
            {"name": "ramp", "duration_s": ramp_d,
             "arrivals": {"kind": "ramp", "start_rate": max(r / 10.0, 1.0),
                          "end_rate": 2.0 * r, "ramp_s": ramp_d}},
            {"name": "hold_2x", "duration_s": hold_d,
             "arrivals": {"kind": "constant", "rate": 2.0 * r}},
            {"name": "recover", "duration_s": rec_d,
             "arrivals": {"kind": "constant", "rate": r / 5.0}},
        ]
    if scenario == "stampede":
        import random as _random
        n = max(4, int(r * d / 2.0))
        rnd = _random.Random(seed * 53 + 1)
        front = sorted(rnd.uniform(0.0, 1.0) for _ in range(n))
        return [
            {"name": "stampede", "duration_s": 1.0, "schedule": front},
            {"name": "tail", "duration_s": max(d - 1.0, 1.0),
             "arrivals": {"kind": "constant", "rate": r}},
        ]
    if scenario == "reconnect-storm":
        return [{"name": "steady+storm", "duration_s": d,
                 "arrivals": {"kind": "constant", "rate": r}}]
    raise SystemExit(f"unknown scenario {scenario!r}")


def boot(base: str, n_orderers: int, admission: dict, slo: dict,
         max_queue: int, gateway: Optional[dict] = None,
         bccsp: str = "CUDA"):
    paths = provision_network(
        base, n_orderers=n_orderers, peer_orgs=["Org1"], peers_per_org=1,
        batch=BatchConfig(max_message_count=32, timeout_s=0.05))
    orderers, peers = [], []
    for p in paths["orderers"]:
        with open(p) as f:
            cfg = json.load(f)
        cfg["ops_port"] = 0
        cfg["bccsp"] = bccsp
        orderers.append(OrdererNode(cfg, data_dir=cfg["data_dir"]).start())
    for p in paths["peers"]:
        with open(p) as f:
            cfg = json.load(f)
        gw_cfg = {"linger_s": 0.005, "max_batch": 64,
                  "max_queue": max_queue,
                  "admission": admission}
        gw_cfg.update(gateway or {})
        cfg["gateway"] = gw_cfg
        cfg["slo"] = slo
        cfg["ops_port"] = 0
        cfg["bccsp"] = bccsp
        peers.append(PeerNode(cfg, data_dir=cfg["data_dir"]).start())
    deadline = time.time() + 60
    while time.time() < deadline:
        if any(o.support.chain.node.role == "leader" for o in orderers):
            return paths, orderers, peers
        time.sleep(0.2)
    raise SystemExit("no raft leader elected")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fabric_tpu_torch.workload",
        description="open-loop workload scenarios against an in-process "
                    "network")
    from fabric_tpu_torch.workload import scenarios as _scenarios
    ap.add_argument("--scenario", default="ramp",
                    choices=["poisson", "diurnal", "burst", "ramp",
                             "stampede", "reconnect-storm"]
                    + _scenarios.list_scenarios(),
                    help="load-shape scenarios run a single peer under "
                         "admission pressure; catalog scenarios "
                         f"({', '.join(_scenarios.list_scenarios())}) "
                         "run full adversarial topologies with in-run "
                         "SLO assertions")
    ap.add_argument("--rate", type=float, default=30.0,
                    help="nominal offered rate (tx/s)")
    ap.add_argument("--duration", type=float, default=12.0,
                    help="total run seconds")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--keys", type=int, default=256,
                    help="keyspace size per channel")
    ap.add_argument("--zipf-s", type=float, default=1.1,
                    help="key skew (0 = uniform)")
    ap.add_argument("--reads", type=float, default=0.2,
                    help="read fraction of the op blend")
    ap.add_argument("--ranges", type=float, default=0.05,
                    help="range-scan fraction of the op blend")
    ap.add_argument("--population", type=int, default=10000,
                    help="simulated client identities")
    ap.add_argument("--sockets", type=int, default=8,
                    help="pooled gateway connections")
    ap.add_argument("--workers", type=int, default=16,
                    help="driver worker threads")
    ap.add_argument("--orderers", type=int, default=1)
    ap.add_argument("--max-queue", type=int, default=128,
                    help="gateway admission queue bound")
    ap.add_argument("--inline", action="store_true",
                    help="endorse per arrival instead of pre-endorsing "
                         "an envelope pool")
    ap.add_argument("--no-commits", action="store_true",
                    help="skip per-tx commit tracking")
    ap.add_argument("--commit-every", type=int, default=1,
                    help="track commit status for every k-th tx only "
                         "(keeps the driver open-loop at high rates)")
    ap.add_argument("--json-out", help="write the report here too")
    ap.add_argument("--save-trace",
                    help="append every fired arrival offset to this "
                         "jsonl file (replay later with a "
                         '{"kind": "trace", "path": ...} arrival spec)')
    ap.add_argument("--bccsp", choices=["CUDA", "SW"], default="CUDA",
                    help="provider of the factory's default and of every "
                         "node: the card (fail-stop) or the host")
    ap.add_argument("--strict", action="store_true",
                    help="catalog scenarios: exit non-zero when an "
                         "in-run SLO assertion fails")
    args = ap.parse_args(argv)

    if args.scenario in _scenarios.SCENARIOS:
        try:
            report = _scenarios.run_scenario(
                args.scenario, seed=args.seed,
                report_path=args.json_out, strict=args.strict,
                bccsp=args.bccsp)
        except _scenarios.ScenarioFailure as exc:
            print(f"SLO FAILED: {exc}", file=sys.stderr)
            return 1
        print(json.dumps(report, indent=2, default=str))
        slo = report.get("slo", {})
        print(f"slo: {'PASS' if slo.get('pass') else 'FAIL'} "
              f"({slo.get('checks', 0)} checks)", file=sys.stderr)
        return 0

    init_factories(FactoryOpts(default=args.bccsp))
    # aggressive admission thresholds: a dozen-second run must traverse
    # the shed ladder, so queue pressure maps steeply into severity
    admission = {"enabled": True, "queue_high_frac": 0.5,
                 "latency_slo_s": 1.5, "dwell_s": 1.0,
                 "recover_ratio": 0.7, "eval_interval_s": 0.05,
                 "seed": args.seed}
    slo = {"sample_interval_s": 1.0, "short_window_s": 5.0,
           "long_window_s": 15.0}
    report: dict = {"scenario": args.scenario, "rate": args.rate,
                    "duration_s": args.duration, "seed": args.seed}
    with tempfile.TemporaryDirectory() as base:
        print(f"booting {args.orderers} orderer(s) + 1 peer ...",
              file=sys.stderr)
        paths, orderers, peers = boot(base, args.orderers, admission, slo,
                                      args.max_queue, bccsp=args.bccsp)
        peer = peers[0]
        with open(paths["clients"]["Org1"]) as f:
            cc = json.load(f)
        signer = load_signing_identity(
            cc["mspid"], cc["cert_pem"].encode(), cc["key_pem"].encode())

        mix = TrafficMix([{
            "channel": "ch", "chaincode": "assets", "weight": 1.0,
            "keys": args.keys, "zipf_s": args.zipf_s,
            "blend": {"read": args.reads,
                      "write": max(0.0, 1.0 - args.reads - args.ranges),
                      "range": args.ranges}}], seed=args.seed)
        clients = ClientPopulation(
            args.population, args.sockets,
            factory=lambda slot: GatewayClient(
                peer.rpc.addr, signer, peer.msps, channel_id="ch",
                seed=args.seed * 1000 + slot),
            seed=args.seed)
        clients.warm()

        prepare = None
        if not args.inline:
            # pre-endorse through a dedicated client with shed retries
            # OFF so pool building never races the load it precedes
            prep_gw = GatewayClient(peer.rpc.addr, signer, peer.msps,
                                    channel_id="ch", shed_retry_max=0)

            def prepare(op):
                fn, call_args = WorkloadRunner._call_shape(op)
                sp, responses = prep_gw.endorse(
                    op.chaincode, fn, call_args, channel=op.channel)
                return assemble_transaction(sp, responses, signer)

        phases = build_phases(args.scenario, args.rate, args.duration,
                              args.seed)
        runner = WorkloadRunner(
            clients, mix, phases, signer=signer, prepare=prepare,
            workers=args.workers, seed=args.seed,
            track_commits=not args.no_commits,
            commit_every=args.commit_every,
            save_trace=args.save_trace)

        storm = None
        if args.scenario == "reconnect-storm":
            storm = threading.Timer(
                args.duration / 2.0,
                lambda: print(f"reconnect storm: cut "
                              f"{clients.reconnect_storm(1.0)} sockets",
                              file=sys.stderr))
            storm.daemon = True
            storm.start()

        print(f"running {args.scenario} "
              f"(~{args.rate:.0f} tx/s x {args.duration:.0f}s, "
              f"zipf_s={args.zipf_s}) ...", file=sys.stderr)
        try:
            report.update(runner.run())
        finally:
            if storm is not None:
                storm.cancel()
            gw = peer.gateway
            if gw is not None:
                report["admission"] = gw.admission.snapshot()
            clients.close()
            if prepare is not None:
                prep_gw.close()
            for n in peers + orderers:
                try:
                    n.stop()
                except Exception:
                    pass
    out = json.dumps(report, indent=2, default=str)
    print(out)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
