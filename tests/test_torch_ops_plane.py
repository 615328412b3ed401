"""The port's ops plane (fabric_tpu_torch.ops_plane) against the
reference's (fabric_tpu.ops_plane), on the CPU.

Two kinds of test:

* The scenarios of the reference's own tests, run on both packages:
  every test function of tests/test_ops_plane.py, test_sampler.py,
  test_timeseries.py and test_incidents.py is executed once against
  each package, from its source with the package's imports pointing at
  that package (`fabric_tpu.` -> `fabric_tpu_torch.`, the `node.top`
  dashboard included: each package's `top` scrapes its own server).
  Fixtures are the test's own (`tmp_path`, `caplog`).  The one scenario that is not the
  module's own on the port, the device capture behind /debug/profile
  (a jax.profiler trace directory in the reference, a torch.profiler
  trace here), runs on the reference only; its port counterpart is
  `test_profiling_routes_capture_cpu_trace` below, and the CUDA one is
  in tests/test_torch_cuda.py.
* Differentials: the same inputs through both packages, the outputs
  held equal: exposition text, the ops server's routes, SLO burn over a
  scripted clock, Theil-Sen slopes and the leak gate, the sampler's
  folds, the incident bundles' layout, span trees in the flight
  recorder; and the port's own `resources` (no device gauge while CUDA
  is not in use, `provenance()` "cpu-virtual" on the CPU).

Tolerance: exact equality (times and host-specific values, named where
they are left out, excepted)."""
import ast
import copy
import importlib
import inspect
import json
import re
import sys
import types
import urllib.error
import urllib.request
from pathlib import Path

import pytest

PKGS = ("fabric_tpu", "fabric_tpu_torch")
REF_FILES = ("test_ops_plane", "test_sampler", "test_timeseries",
             "test_incidents")
# scenarios whose subject is not the port module's own behaviour
REF_ONLY = {("test_ops_plane", "test_profiling_routes")}
TESTS_DIR = Path(__file__).resolve().parent


def _test_names(name: str) -> list:
    tree = ast.parse((TESTS_DIR / f"{name}.py").read_text())
    return [n.name for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")]


CASES = [(f, t) for f in REF_FILES for t in _test_names(f)]
_modules: dict = {}


def scenario_module(name: str, pkg: str):
    """tests/<name>.py executed as a module whose `fabric_tpu.` imports
    name `pkg`."""
    key = (name, pkg)
    if key not in _modules:
        path = TESTS_DIR / f"{name}.py"
        src = path.read_text()
        if pkg != "fabric_tpu":
            src = re.sub(r"\bfabric_tpu\.", f"{pkg}.", src)
        mod = types.ModuleType(f"_{pkg}_{name}")
        mod.__file__ = str(path)
        exec(compile(src, str(path), "exec"), mod.__dict__)
        _modules[key] = mod
    return _modules[key]


RUNS = [(case, pkg) for case in CASES for pkg in PKGS
        if pkg == "fabric_tpu" or case not in REF_ONLY]


def _series_state(reg) -> dict:
    """Every metric's series (its private dicts) -> {metric: copies}."""
    return {m: {k: copy.deepcopy(v) for k, v in vars(m).items()
                if isinstance(v, dict)}
            for m in reg.metrics().values()}


def _restore_series(reg, state: dict) -> None:
    """Put every metric's series back as `state` holds them; a metric
    first made after `state` was taken keeps its object (modules hold
    it) with its series emptied."""
    for m in reg.metrics().values():
        saved = state.get(m)
        with m._lock:
            for k, v in vars(m).items():
                if isinstance(v, dict):
                    setattr(m, k, saved[k] if saved is not None else {})


@pytest.mark.parametrize("case,pkg", RUNS,
                         ids=[f"{f}::{t}-{p}" for (f, t), p in RUNS])
def test_reference_scenario(case, pkg, request):
    """The scenario runs against its package's process-wide registry;
    its series are put back afterwards, so the reference's own test
    files see the registry as they would without this module (their
    counts, e.g. committed_blocks_total{channel="met"}, are exact)."""
    fn = getattr(scenario_module(case[0], pkg), case[1])
    reg = ops(pkg).registry
    state = _series_state(reg)
    try:
        fn(**{a: request.getfixturevalue(a)
              for a in inspect.signature(fn).parameters})
    finally:
        _restore_series(reg, state)


# ---------------------------------------------------------------------------
# differentials
# ---------------------------------------------------------------------------

def ops(pkg):
    return importlib.import_module(f"{pkg}.ops_plane")


def both(scenario):
    """scenario(ops plane package) on each package -> the two results,
    asserted equal."""
    ref, port = (scenario(ops(p)) for p in PKGS)
    assert port == ref
    return port


def _drive_registry(O):
    reg = O.MetricsRegistry()
    reg.counter("txs_total", "transactions").add(3, channel="ch")
    reg.counter("txs_total").add(2, channel="ch")
    reg.counter("esc_total").add(1, path='a\\b"c\nd')
    reg.gauge("height", "block height").set(7, channel="ch")
    reg.gauge("height").add(-2, channel="other")
    h = reg.histogram("latency_seconds", buckets=(0.1, 1.0, float("inf")))
    for v in (0.05, 0.1, 0.5, 1.0, 5.0):
        h.observe(v, stage="collect")
        h.observe(v / 10)
    return reg


def test_exposition_text_equal():
    text = both(lambda O: _drive_registry(O).expose_text())
    assert 'txs_total{channel="ch"} 5.0' in text


def test_registry_reads_equal():
    def reads(O):
        reg = _drive_registry(O)
        c, g = reg.counter("txs_total"), reg.gauge("height")
        h = reg.histogram("latency_seconds")
        return (c.total(), c.total_by("channel"), c.breakdown("channel"),
                g.values(), g.mean_by("channel"), h.state(),
                h.state_by("stage"), sorted(reg.metrics()))
    both(reads)


def _get(addr, path):
    try:
        with urllib.request.urlopen(
                f"http://{addr[0]}:{addr[1]}{path}", timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_server_routes_equal():
    """/metrics, /healthz (passing, failing, lifecycle), /logspec, an
    extension route and an unknown path give the same status and body
    on both servers; /version names each package."""
    def routes(O):
        srv = O.OperationsServer(metrics=_drive_registry(O)).start()
        try:
            out = [_get(srv.addr, p) for p in ("/metrics", "/healthz",
                                               "/logspec", "/nope")]
            srv.lifecycle_fn = lambda: "draining"
            srv.register_checker("raft", lambda: (_ for _ in ()).throw(
                RuntimeError("no leader")))
            srv.register_route("GET", "/ext", lambda p, b: (200, {"p": p}))
            out += [_get(srv.addr, p) for p in ("/healthz", "/ext?x=1")]
            code, body = _get(srv.addr, "/version")
            out.append((code, json.loads(body)["version"].split("/")[1]))
            return out
        finally:
            srv.stop()
    out = both(routes)
    assert out[4][0] == 503 and out[-1] == (200, "0.2")


def _slo_script(O, objectives, feed):
    """An SloEvaluator on a fresh registry, sampled and evaluated once a
    scripted second for 24 s while `feed(reg, t)` moves the inputs ->
    every evaluation's (name, state, burns, values) and the alert
    history without its times."""
    reg = O.MetricsRegistry()
    ev = O.SloEvaluator({"sample_interval_s": 1.0, "short_window_s": 4.0,
                         "long_window_s": 8.0, "objectives": objectives},
                        registry=reg)
    trail = []
    for i in range(24):
        t = float(i)
        feed(reg, t)
        ev.sample(t)
        trail.append(sorted(
            (s["name"], s["state"], s["burn_short"], s["burn_long"],
             s["value_short"], s["value_long"]) for s in ev.evaluate(t)))
    hist = [{k: v for k, v in a.items() if not k.endswith("_at")}
            for a in ev.alerts_snapshot()["history"]]
    return trail, hist


def test_slo_burn_equal():
    def feed(reg, t):
        reg.gauge("gateway_orderer_breaker_open").set(
            1.0 if 6 <= t < 14 else 0.0, orderer="a")
        reg.counter("provider_device_sigs_total").add(
            500.0 if t < 10 else 5.0)
        h = reg.histogram("validation_duration_seconds",
                          buckets=(0.1, 1.0, 5.0, float("inf")))
        h.observe(3.0 if t >= 12 else 0.05, channel="ch")
        reg.gauge("pipeline_collect_under_verify_frac").set(
            0.1 if t >= 16 else 0.9, channel="ch")

    def run(O):
        return _slo_script(O, {"verify_throughput_floor":
                               {"threshold": 100.0},
                               "commit_p99_s": {"threshold": 1.0}}, feed)
    trail, hist = both(run)
    assert {s[1] for s in trail[-1]} >= {"alerting"} and hist


def test_theil_sen_and_leak_gate_equal():
    import random

    def run(O):
        rng = random.Random(7)
        ts = [float(i) for i in range(120)]
        flat = [100.0 + rng.gauss(0, 1) for _ in ts]
        leak = [100.0 + 0.5 * t + rng.gauss(0, 1) for t in ts]
        saw = [100.0 + (t % 20) for t in ts]
        step = [100.0 + (50.0 if t > 60 else 0.0) for t in ts]
        fits = [O.theil_sen(list(zip(ts, ys)))
                for ys in (flat, leak, saw, step)]
        verdicts = [O.assess_leak(list(zip(ts, ys))) for ys in
                    (flat, leak, saw, step)]
        return fits, verdicts
    both(run)


def test_timeseries_store_equal():
    def run(O):
        reg = O.MetricsRegistry()
        st = O.TimeSeriesStore({"interval_s": 1.0}, registry=reg,
                               clock=lambda: 0.0)
        for i in range(90):
            reg.counter("committed_txs_total").add(10.0 + i % 3,
                                                   channel="ch")
            reg.gauge("ledger_height").set(float(i), channel="ch")
            reg.histogram("validation_duration_seconds").observe(
                0.01 * (i % 7), channel="ch")
            st.sample(now=float(i))
        return {name: st.history(name, window_s=60.0, now=89.0)
                for name in st.names()}
    out = both(run)
    assert out


def test_sampler_folds_equal():
    def run(O):
        sampler = importlib.import_module(f"{O.__name__}.sampler")
        p = sampler.SamplingProfiler(
            {"hz": 10.0, "window_s": 10.0, "windows": 3,
             "coarse_window_s": 60.0, "coarse_windows": 2,
             "max_depth": 3}, registry=O.MetricsRegistry())
        stacks = [["main;a.f;a.g;a.h", "worker-3;b.h"], ["main;a.f"]]
        out = []
        for k in range(40):
            p._collect_stacks = lambda k=k: list(stacks[k % 2])
            p.sample_once(now=1000.0 + k * 2.0)
        for window in (10.0, 60.0, 600.0):
            prof = p.profile(window_s=window, now=1080.0)
            out.append((prof["samples"], prof["folded"],
                        p.top_table(prof["folded"], 5),
                        p.folded_text(prof["folded"])))
        return out
    both(run)


def test_incident_bundles_equal(tmp_path):
    """The same alerts into each package's IncidentRecorder: the same
    bundles, files and manifests (time fields and the bundle directory
    left out)."""
    def run(O):
        inc = importlib.import_module(f"{O.__name__}.incidents")
        reg = O.MetricsRegistry()
        reg.counter("gateway_shed_total").add(3)
        root = tmp_path / O.__name__
        clock = iter(float(1000 + 10 * i) for i in range(1000))
        rec = inc.IncidentRecorder(
            {"dir": str(root), "sync": True, "cooldown_s": 30.0,
             "keep": 2}, registry=reg, clock=lambda: next(clock),
            node_name="node")
        rec.add_source("ok", lambda: {"x": 1})
        rec.add_source("broken", lambda: 1 / 0)
        ids = []
        try:
            for obj in ("shed_rate", "commit_p99_s", "shed_rate",
                        "overlap_floor", "shed_rate", "shed_rate"):
                ids.append(rec.on_alert_fired(obj, {
                    "objective": obj, "metric": "gateway_shed_total",
                    "kind": "max", "threshold": 1.0, "value": 7.5,
                    "burn_short": 7.5, "burn_long": 3.1,
                    "state": "firing", "fired_at": 1000.0}))
        finally:
            rec.stop()
        out = []
        for b in sorted(p.name for p in root.iterdir()):
            files = sorted(str(f.relative_to(root / b))
                           for f in (root / b).rglob("*") if f.is_file())
            out.append((b, files, inc.verify_bundle(str(root / b))))
        return ids, out, reg.counter("incidents_suppressed_total").total()
    ids, out, suppressed = both(run)
    assert None in ids and suppressed >= 1
    assert len(out) == 2 and all(v["ok"] for _b, _f, v in out)


def test_span_tree_and_chrome_export_equal():
    """A scripted block trace (root, children, a retroactive span, an
    event, a link, an error) through each package's Tracer: the
    recorder's spans (names, parents by name, attributes, status) and
    the Chrome export's event names and args, without times and ids."""
    def run(O):
        t = O.Tracer().configure({"enabled": True, "sample_rate": 1.0})
        with t.start_span("spec") as spec:
            spec_id = spec.context.trace_id
        with t.start_span("committer.store_block",
                          attributes={"block": 2}) as root:
            tid = root.context.trace_id
            with t.start_span("bccsp.batch_verify", require_parent=True,
                              attributes={"batch_size": 3}):
                pass
            t.record_span("validator.collect", 1.0, 2.0,
                          attributes={"links": [spec_id]})
            t.event("history.checkpoint", gen=1)
            try:
                with t.start_span("ledger.fail"):
                    raise RuntimeError("boom")
            except RuntimeError:
                pass
        t.start_span("orphan", require_parent=True).end()
        rec = t.recorder.get(tid)
        names = {s["span_id"]: s["name"] for s in rec["spans"]}
        spans = sorted((s["name"], names.get(s["parent_id"]), s["status"],
                        json.dumps({k: v for k, v in s["attributes"].items()
                                    if k != "links"}, sort_keys=True))
                       for s in rec["spans"])
        chrome = t.export_chrome(tid)
        events = sorted((e["name"], e["ph"], sorted(e.get("args", {})))
                        for e in chrome["traceEvents"] if e["ph"] == "X")
        return spans, events, chrome["otherData"]["n_traces_merged"], \
            sorted(t.span_stats())
    spans, events, merged, _ = both(run)
    assert merged == 2
    assert ("bccsp.batch_verify", "committer.store_block", "OK",
            '{"batch_size": 3}') in spans


def test_jlog_record_equal(caplog):
    import logging

    def run(O):
        log = logging.getLogger(f"{O.__name__}.test")
        caplog.clear()
        with caplog.at_level(logging.INFO, logger=log.name):
            O.jlog(log, "committer.replayed_block", channel="ch", block=3,
                   skipped=None, exc=ValueError("x"))
        doc = json.loads(caplog.records[-1].message)
        doc.pop("ts")
        return doc
    assert both(run) == {"event": "committer.replayed_block",
                         "channel": "ch", "block": 3,
                         "error": "ValueError('x')"}


# ---------------------------------------------------------------------------
# the port's own modules
# ---------------------------------------------------------------------------

def test_resources_no_device_gauge_without_cuda():
    """While CUDA is not in use the collector reads no device memory
    (and never initialises a device); provenance() says cpu-virtual."""
    import torch
    from fabric_tpu_torch.ops_plane import (MetricsRegistry,
                                            ResourceCollector, provenance)
    reg = MetricsRegistry()
    snap = ResourceCollector({"interval_s": 60.0}, registry=reg).collect()
    assert "cuda_allocated_bytes" not in snap
    assert "cuda_allocated_bytes" not in reg.expose_text()
    assert not torch.cuda.is_initialized()
    prov = provenance()
    assert prov["platform"] == "cpu-virtual"
    assert prov["device_kind"] == "unknown" and prov["n_devices"] == 0
    assert set(prov) == set(ops("fabric_tpu").provenance())


def test_resources_device_gauge_reads_torch_cuda(monkeypatch):
    """With CUDA reported in use, the gauge is memory_allocated summed
    over the devices, and provenance() names the card (a stand-in
    torch.cuda here; the card's own in tests/test_torch_cuda.py)."""
    import torch
    from fabric_tpu_torch.ops_plane import (MetricsRegistry,
                                            ResourceCollector, provenance)
    cuda = types.SimpleNamespace(
        is_available=lambda: True, is_initialized=lambda: True,
        device_count=lambda: 2, get_device_name=lambda i: "Card X",
        memory_allocated=lambda d: 1000 * (d + 1))
    monkeypatch.setattr(torch, "cuda", cuda)
    reg = MetricsRegistry()
    snap = ResourceCollector({"interval_s": 60.0}, registry=reg).collect()
    assert snap["cuda_allocated_bytes"] == 3000.0
    assert "cuda_allocated_bytes 3000.0" in reg.expose_text()
    assert provenance()["platform"] == "gpu"
    assert provenance()["device_kind"] == "Card X"
    assert provenance()["n_devices"] == 2
    off = ResourceCollector({"device_memory": False},
                            registry=MetricsRegistry()).collect()
    assert "cuda_allocated_bytes" not in off


def test_resources_native_arena_after_block_path_loads():
    """The arena-pool gauges appear once the block path has loaded the
    port's `_fastparse` (the collector never builds it itself)."""
    from fabric_tpu_torch.ops_plane import MetricsRegistry, ResourceCollector
    from fabric_tpu_torch.protocol import wire  # noqa: F401 (loads it)
    assert "fabric_tpu_torch.native._fastparse" in sys.modules
    snap = ResourceCollector({}, registry=MetricsRegistry()).collect()
    assert "native_arena_pool_free" in snap


def test_profiling_routes_capture_cpu_trace(tmp_path):
    """The port's /debug/pprof returns pstats and /debug/profile a
    torch.profiler Chrome trace (CPU activity here)."""
    from fabric_tpu_torch.ops_plane import OperationsServer
    from fabric_tpu_torch.ops_plane.profiling import register_routes
    srv = OperationsServer("127.0.0.1", 0)
    register_routes(srv, enabled=True, device="cpu")
    srv.start()
    try:
        url = "http://%s:%d" % srv.addr
        for path, key in (("/debug/pprof?seconds=0.2", "pstats"),
                          ("/debug/profile?seconds=0.2", "trace")):
            req = urllib.request.Request(url + path, method="POST")
            body = json.loads(urllib.request.urlopen(req, timeout=120).read())
            assert body.get(key), body
        assert Path(body["trace"]).is_file()
        assert body["device"] == "cpu"
    finally:
        srv.stop()
