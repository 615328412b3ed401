"""The port's workload plane (fabric_tpu_torch.workload: arrivals,
keyspace, clients, runner, the scenario catalog and its CLI) against
the reference's (fabric_tpu.workload), on the CPU.

* The reference's own tests: every test function of
  tests/test_workload.py on both packages (tests/ref_scenarios.py).
* Differentials, inputs made from a seed, held equal exactly:
  `from_spec` schedules for every arrival kind (`trace` included),
  `ZipfSampler` draws, `TrafficMix`'s first 2,000 ops as (channel,
  chaincode, kind, keys), `ThinkTimeModel` delays per client,
  `build_plan` for every catalog scenario rule by rule, `build_phases`
  for each of the CLI's six load shapes, `SCENARIOS` as dicts, and
  `WorkloadRunner` over a stub `ClientPopulation` factory (no network):
  per-phase offered, fired, accepted, evaluated, shed, backpressure,
  dedup, errors, committed, conflicts and other codes, the think-time
  delays, and the client totals (times left out).
* Live: the port's `run_scenario("membership-churn", bccsp="SW",
  strict=True)` passes its 5 checks with every node on SW, and its
  report's spec, check kinds and keys equal a reference run's; the CLI's
  `burst` load shape on SW returns 0 with the reference CLI's report
  keys and phase names.  Every wait inside a run has its own bound (the
  scenario's drills 30 s each, its convergence check 90 s, the runner's
  drain 45 s, its submits 15 s and commit-status waits 30 s).
* The default provider is the card, fail-stop: on this host, with no
  card, `run_scenario` and the CLI without `bccsp` raise before any node
  starts.
* The other twelve catalog scenarios live on the port on SW, marked
  `slow` like tests/test_torch_network.py's drills (not in tier-1).
"""
import importlib
import json
import random
import threading

import pytest

from ref_scenarios import PKGS, run_scenario, scenario_module, scenario_names

REF, PORT = PKGS
SEED = 7
KINDS = ("constant", "diurnal", "burst", "ramp", "trace")
SHAPES = ("poisson", "diurnal", "burst", "ramp", "stampede",
          "reconnect-storm")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.workload.{name}")


RUNS = [(t, p) for t in scenario_names("test_workload") for p in PKGS]


@pytest.mark.parametrize("name,pkg", RUNS, ids=[f"{t}-{p}" for t, p in RUNS])
def test_reference_scenario(name, pkg, request):
    run_scenario(scenario_module("test_workload", pkg), name, request)


# ---------------------------------------------------------------------------
# differentials
# ---------------------------------------------------------------------------

def arrival_spec(kind: str, rng: random.Random, tmp_path) -> dict:
    if kind == "constant":
        return {"kind": kind, "rate": rng.uniform(5, 200)}
    if kind == "diurnal":
        return {"kind": kind, "base_rate": rng.uniform(5, 100),
                "amplitude": rng.uniform(0, 1.2),
                "period_s": rng.uniform(1, 30)}
    if kind == "burst":
        return {"kind": kind, "low_rate": rng.uniform(0, 20),
                "high_rate": rng.uniform(20, 300),
                "period_s": rng.uniform(1, 10), "duty": rng.uniform(0, 1)}
    if kind == "ramp":
        return {"kind": kind, "start_rate": rng.uniform(0, 10),
                "end_rate": rng.uniform(10, 250),
                "ramp_s": rng.uniform(0, 12)}
    path = tmp_path / "trace.jsonl"
    with open(path, "w") as f:
        for i in range(400):
            t = round(rng.uniform(0, 20), 6)
            rec = ({"phase": rng.choice(["a", "b"]), "i": i, "t": t}
                   if i % 3 else t)
            f.write(json.dumps(rec) + "\n")
        f.write("\n")
    return {"kind": kind, "path": str(path),
            "phase": rng.choice([None, "a"])}


@pytest.mark.parametrize("kind", KINDS)
def test_from_spec_schedules_equal(kind, tmp_path):
    rng = random.Random(f"{SEED}-{kind}")
    for trial in range(4):
        spec = arrival_spec(kind, rng, tmp_path)
        seed = rng.randrange(10 ** 6)
        procs = [mod(p, "arrivals").from_spec(spec, seed=seed)
                 for p in PKGS]
        for duration in (0.0, 3.5, 15.0):
            ref, port = (p.schedule(duration) for p in procs)
            assert port == ref, (spec, duration)
        assert procs[1].describe() == procs[0].describe()
        assert procs[1].mean_rate(9.0) == procs[0].mean_rate(9.0)
        assert type(procs[1]).__name__ == type(procs[0]).__name__
    assert any(procs[1].schedule(15.0) for _ in [0])


def test_zipf_draws_equal():
    rng = random.Random(SEED)
    for _ in range(6):
        n, s, seed = rng.randrange(1, 5000), rng.uniform(0, 2), rng.random()
        a, b = (mod(p, "keyspace").ZipfSampler(n, s, seed=seed)
                for p in PKGS)
        assert [b.rank() for _ in range(3000)] \
            == [a.rank() for _ in range(3000)]
        assert [b.key() for _ in range(50)] == [a.key() for _ in range(50)]
        ranks = [1, n, max(1, n // 2)]
        assert [b.pmf(r) for r in ranks] == [a.pmf(r) for r in ranks]
        assert mod(PORT, "keyspace").expected_collision_p(n, s) \
            == mod(REF, "keyspace").expected_collision_p(n, s)


def test_traffic_mix_first_2000_ops_equal():
    channels = [
        {"channel": "ch", "chaincode": "assets", "weight": 3.0,
         "keys": 256, "zipf_s": 1.1,
         "blend": {"read": 0.2, "write": 0.7, "range": 0.1}},
        {"channel": "ch2", "chaincode": "cc2", "weight": 1.0, "keys": 64,
         "zipf_s": 0.0, "blend": {"write": 1.0}},
        {"channel": "ch3", "chaincode": "assets", "weight": 0.5,
         "keys": 4096, "zipf_s": 1.6,
         "blend": {"read": 0.5, "range": 0.5}}]
    a, b = (mod(p, "keyspace").TrafficMix(channels, seed=SEED)
            for p in PKGS)

    def shape(op):
        return (op.channel, op.chaincode, op.kind, op.key, op.end_key)
    assert [shape(op) for op in b.ops(2000)] \
        == [shape(op) for op in a.ops(2000)]
    assert b.describe() == a.describe()
    assert b.conflict_dial() == a.conflict_dial()


@pytest.mark.parametrize("spec", [
    {"kind": "exponential", "mean_s": 0.4},
    {"kind": "exponential", "mean_s": 0.0},
    {"kind": "lognormal", "median_s": 0.3, "sigma": 1.2},
    {"kind": "lognormal", "median_s": 0.0, "sigma": 0.5}])
def test_think_time_delays_per_client_equal(spec):
    a, b = (mod(p, "clients").ThinkTimeModel.from_spec(spec, seed=SEED)
            for p in PKGS)
    rng = random.Random(SEED)
    order = [rng.randrange(1, 40) for _ in range(3000)]
    assert [b.delay(c) for c in order] == [a.delay(c) for c in order]
    assert b.describe() == a.describe()


def test_scenario_catalog_equal():
    ref, port = (mod(p, "scenarios") for p in PKGS)
    assert port.SCENARIOS == ref.SCENARIOS
    assert len(port.SCENARIOS) == 13
    assert port.list_scenarios() == ref.list_scenarios()


@pytest.mark.parametrize("name", sorted(
    importlib.import_module("fabric_tpu.workload.scenarios").SCENARIOS))
def test_build_plan_equal_rule_by_rule(name):
    ref, port = (mod(p, "scenarios") for p in PKGS)
    for seed in (SEED, 11):
        a = ref.build_plan(ref.SCENARIOS[name], seed)
        b = port.build_plan(port.SCENARIOS[name], seed)
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert (b.seed, b.name) == (a.seed, a.name)
        assert [r.as_dict() for r in b.rules] \
            == [r.as_dict() for r in a.rules]


@pytest.mark.parametrize("shape", SHAPES)
def test_build_phases_equal(shape):
    ref, port = (importlib.import_module(f"{p}.workload.__main__")
                 for p in PKGS)
    for rate, duration, seed in ((30.0, 12.0, SEED), (7.5, 3.0, 3),
                                 (200.0, 1.0, 99)):
        assert port.build_phases(shape, rate, duration, seed) \
            == ref.build_phases(shape, rate, duration, seed)


class _Env:
    """A stand-in envelope: its txid is its pool index."""

    def __init__(self, n: int):
        self.n = n
        self.txid = str(n)

    def header(self):
        return self

    @property
    def channel_header(self):
        return self


def stub_gateway(pkg: str):
    """A `ClientPopulation` factory of package `pkg` whose connections
    answer from the envelope's index alone: sheds, backpressure, MVCC
    refusals, errors, dedups and commit codes, in a fixed pattern."""
    gwmod = importlib.import_module(f"{pkg}.gateway.client")
    rpc = importlib.import_module(f"{pkg}.comm")

    class Gateway:
        def __init__(self, slot):
            self.slot = slot

        def warm(self):
            pass

        def evaluate(self, chaincode, fn, args, channel=None):
            return b""

        def submit_envelope(self, env, timeout_s=None):
            n = env.n
            if n % 11 == 3:
                raise gwmod.GatewayShedError("shed", mode="probabilistic",
                                             retry_after_ms=5)
            if n % 13 == 5:
                raise rpc.RpcError("backpressure: gateway queue full")
            if n % 17 == 7:
                raise gwmod.GatewayError("mvcc", status=11)
            if n % 19 == 2:
                raise gwmod.GatewayError("refused", status=500)
            if n % 29 == 4:
                raise rpc.RpcError("connection reset")
            return {"deduped": n % 23 == 0}

        def commit_status(self, txid, channel=None, timeout_s=None):
            return [0, 0, 0, 11, 12, 10][int(txid) % 6], None

        def close(self):
            pass
    return Gateway


PHASES = [
    {"name": "steady", "duration_s": 0.6,
     "arrivals": {"kind": "constant", "rate": 120.0}},
    {"name": "bursty", "duration_s": 0.5,
     "arrivals": {"kind": "burst", "low_rate": 20.0, "high_rate": 200.0,
                  "period_s": 0.25, "duty": 0.4},
     "think": {"kind": "exponential", "mean_s": 0.01}},
    {"name": "stampede", "duration_s": 0.3,
     "schedule": [i / 100.0 for i in range(25)]},
]


def run_stub(pkg: str) -> dict:
    clients = importlib.import_module(f"{pkg}.workload.clients")
    keyspace = importlib.import_module(f"{pkg}.workload.keyspace")
    runner = importlib.import_module(f"{pkg}.workload.runner")
    pop = clients.ClientPopulation(500, 6, factory=stub_gateway(pkg),
                                   seed=SEED)
    pop.warm()
    mix = keyspace.TrafficMix([{
        "channel": "ch", "chaincode": "assets", "weight": 1.0, "keys": 64,
        "zipf_s": 1.0, "blend": {"read": 0.15, "write": 0.85}}], seed=SEED)
    made = []

    def prepare(op):
        made.append(op.key)
        return _Env(len(made) - 1)
    r = runner.WorkloadRunner(pop, mix, PHASES, prepare=prepare, workers=4,
                              seed=SEED, commit_every=2,
                              drain_timeout_s=20.0)
    return r.run()


COUNTS = ("name", "duration_s", "offered", "offered_rate", "fired",
          "accepted", "evaluated", "shed", "shed_frac", "backpressure",
          "dedup", "errors", "committed", "conflicts", "conflict_frac",
          "other_codes")


def test_runner_over_stub_clients_counts_equal():
    ref, port = run_stub(REF), run_stub(PORT)

    def counts(rep):
        out = []
        for ph in rep["phases"]:
            row = {k: ph.get(k) for k in COUNTS}
            if "think" in ph:
                row["think"] = {k: v for k, v in ph["think"].items()
                                if k != "added_s"}
            row["latencies_n"] = [(ph[k] or {}).get("n")
                                  for k in ("sojourn_ms", "commit_ms")]
            out.append(row)
        return out
    assert counts(port) == counts(ref)
    for key in ("seed", "workers", "commit_every", "mode", "mix",
                "clients"):
        assert port[key] == ref[key], key
    tot = {k: v for k, v in port["totals"].items()
           if not k.endswith(("rate", "_ms", "wall_s"))}
    assert tot == {k: v for k, v in ref["totals"].items()
                   if not k.endswith(("rate", "_ms", "wall_s"))}
    # every outcome of the stub's pattern was taken
    assert all(port["totals"][k] for k in ("shed", "backpressure", "dedup",
                                           "errors", "committed",
                                           "conflicts", "evaluated"))
    assert port["phases"][1]["think"]["delayed"] > 0


# ---------------------------------------------------------------------------
# live runs
# ---------------------------------------------------------------------------

def _built_nodes(monkeypatch) -> list:
    """Every node the port's ChaosNet builds, as it builds it."""
    from fabric_tpu_torch.testing import chaos
    built, real = [], chaos.ChaosNet._build

    def _build(self, name):
        node = real(self, name)
        built.append((name, node))
        return node
    monkeypatch.setattr(chaos.ChaosNet, "_build", _build)
    return built


def test_membership_churn_on_sw(tmp_path, monkeypatch):
    built = _built_nodes(monkeypatch)
    port = mod(PORT, "scenarios").run_scenario(
        "membership-churn", seed=SEED, base_dir=str(tmp_path / "port"),
        report_path=str(tmp_path / "port.json"), strict=True, bccsp="SW")
    assert port["slo"] == {"pass": True, "checks": 5, "violations": []}
    churn = port["membership_churn"]
    assert churn["done"] and "error" not in churn
    assert all(churn[k] for k in ("added_joined", "leader_transferred",
                                  "removed_isolated",
                                  "removed_self_evicted"))
    names = {n for n, _ in built}
    assert names == {"orderer1", "orderer2", "orderer3", "orderer4",
                     "peerOrg1_0", "peerOrg2_0"}
    assert all(node.provider.name == "sw" for _, node in built)
    assert port["totals"]["committed"] >= 1
    ref = mod(REF, "scenarios").run_scenario(
        "membership-churn", seed=SEED, base_dir=str(tmp_path / "ref"),
        report_path=str(tmp_path / "ref.json"), strict=True)
    assert ref["slo"]["pass"]
    assert port["spec"] == ref["spec"]
    assert [e["kind"] for e in port["spec"]["expect"]] \
        == [e["kind"] for e in ref["spec"]["expect"]]
    assert port["slo"]["checks"] == ref["slo"]["checks"]
    assert sorted(port) == sorted(ref)
    assert sorted(port["membership_churn"]) == sorted(ref["membership_churn"])
    with open(tmp_path / "port.json") as f:
        assert json.load(f)["slo"]["pass"]


def _cli(pkg: str, argv: list, capsys) -> tuple:
    main = importlib.import_module(f"{pkg}.workload.__main__").main
    rc = main(argv)
    out = capsys.readouterr().out
    return rc, json.loads(out)


def test_cli_burst_on_sw(tmp_path, capsys):
    base = ["--scenario", "burst", "--rate", "10", "--duration", "3",
            "--seed", str(SEED)]
    rc, port = _cli(PORT, base + ["--bccsp", "SW", "--json-out",
                                  str(tmp_path / "port.json")], capsys)
    assert rc == 0
    rc_ref, ref = _cli(REF, base + ["--json-out", str(tmp_path / "ref.json")],
                       capsys)
    assert rc_ref == 0
    assert sorted(port) == sorted(ref)
    assert [p["name"] for p in port["phases"]] \
        == [p["name"] for p in ref["phases"]] == ["bursts"]
    assert port["phases"][0]["offered"] == ref["phases"][0]["offered"]
    assert sorted(port["admission"]) == sorted(ref["admission"])
    assert port["totals"]["offered"] > 0
    with open(tmp_path / "port.json") as f:
        assert json.load(f) == port


def test_the_default_provider_is_the_card_and_fails_stop(tmp_path):
    import torch
    assert not torch.cuda.is_available()
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="CUDA"):
        mod(PORT, "scenarios").run_scenario(
            "membership-churn", base_dir=str(tmp_path / "sc"))
    assert not (tmp_path / "sc").exists()
    main = importlib.import_module(f"{PORT}.workload.__main__").main
    out = tmp_path / "burst.json"
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--scenario", "burst", "--rate", "10", "--duration", "3",
              "--json-out", str(out)])
    assert not out.exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--scenario", "membership-churn"])
    assert set(threading.enumerate()) <= before


OTHERS = sorted(set(importlib.import_module(
    "fabric_tpu.workload.scenarios").SCENARIOS) - {"membership-churn"})


@pytest.mark.slow
@pytest.mark.parametrize("name", OTHERS)
def test_catalog_scenario_on_sw(name, tmp_path):
    rep = mod(PORT, "scenarios").run_scenario(
        name, seed=SEED, base_dir=str(tmp_path / "net"),
        report_path=str(tmp_path / "report.json"), strict=True, bccsp="SW")
    assert rep["slo"]["pass"] and rep["slo"]["checks"] >= 1
