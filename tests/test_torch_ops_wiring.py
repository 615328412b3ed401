"""The ops plane wired into the port's layers, against the reference's,
on the CPU.

One seeded stream (tests/test_torch_early_abort.py's 300 txs in three
blocks, MVCC conflicts and early aborts included) goes through both
packages' stacks with each package's tracer on at a sample rate of 1.0:
the reference on `SoftwareProvider`, the port on
`CudaProvider(device="cpu", fast_key_threshold=1)` (KP3's plain
version).  Three stacks, each a scenario run once a module:

* `kv7_durable`: the KV7 tail (the port's `DeviceValidator` on KV7's
  plain version, the reference's pinned to one device, ROADMAP C1) on a
  durable ledger (4 state shards, a checkpoint every 2 blocks), early
  abort on; then a snapshot export, every chunk served, and an install;
* `deep_window`: the deep host tail through `PipelinedCommitter` at W=4
  (each submit under a root span, as a deliver loop would open one);
* `classic_cache`: the classic tail with a `VerdictCache`, block 2's
  items filled by a `SpeculativeVerifier` first, the wavefront
  scheduler on (`parallel_commit`).

For each, the two packages must give: the same flags, state, history
and commit hashes; the same series names and label sets moved in their
registries; the same counter values, histogram observation counts and
deterministic gauges (`ledger_height`, `state_shard_keys`, ...); and
the same traces in their flight recorders (span names, parents,
attributes without times and trace ids).  What differs by design is
left out and named: the provider's own series and span attributes
(the reference's stacks run on SW; the lane series are compared with
`JaxTpuProvider`'s on a few dozen signatures below, slots excepted:
ROADMAP C5), and on the window the values that depend on thread timing
(early/deferred splits, cross-block edges, window depth).  Also: the
placement's decisions with the dispatch-queue gauge live, and the
mid-window counter.  Tolerance: exact equality."""
import importlib
import os
import random
import types

import numpy as np
import pytest

from fabric_tpu.msp.ca import DevOrg

from test_torch_parallel_commit import (chain, flagged, history_rows,
                                        msps_of, state_rows)

PKGS = ("ref", "port")
POLICY = "AND('Org1.member', 'Org2.member')"
# gauges whose last value a run determines
EXACT_GAUGES = ("ledger_height", "state_shard_keys", "state_checkpoint_height",
                "commit_workers_effective", "speculative_coverage_frac",
                "commit_window_depth")
# span attributes that are times or trace ids
TIMES = ("block_until_ready_s", "seconds", "links")
# series and span attributes whose values depend on thread timing on a
# commit window (names and label sets are still compared)
WINDOW_TIMING = {"commit_window_txs_total", "commit_graph_edges_total",
                 "commit_window_depth", "commit_window_overlap_frac",
                 "commit_graph_wave_width", "commit_graph_apply_batch_size"}
WINDOW_SPAN_TIMING = ("early", "deferred", "window_depth")


def load(name: str):
    root = "fabric_tpu" if name == "ref" else "fabric_tpu_torch"

    def mod(m):
        return importlib.import_module(f"{root}.{m}")
    factory = mod("bccsp.factory")
    return types.SimpleNamespace(
        name=name, proto=mod("protocol"), ledger=mod("ledger"),
        committer=mod("committer"), msp=mod("msp"), policy=mod("policy"),
        sbe=mod("committer.sbe"), pc=mod("committer.parallel_commit"),
        vp=mod("verify_plane"), snapshot=mod("ledger.snapshot"),
        dv=mod("committer.device_validate"), ops=mod("ops_plane"),
        placement=mod("parallel.placement"),
        wire=mod("protocol.wire") if name == "port" else None,
        sw=factory.init_factories(factory.FactoryOpts(default="SW")))


@pytest.fixture(scope="module")
def pk():
    return {name: load(name) for name in PKGS}


@pytest.fixture(scope="module")
def stream():
    """The 300-tx stream, block 2 reading the versions block 1 left ->
    (orgs, hash-chained raws)."""
    from test_torch_early_abort import stream_300
    orgs = (DevOrg("Org1"), DevOrg("Org2"))
    blocks, transfers = stream_300(orgs)
    R = load("ref")
    lg = R.ledger.KVLedger("ch", R.ledger.LedgerConfig())
    for raw in chain(blocks):
        lg.commit(flagged(R, raw))
    db = lg.statedb
    blocks = blocks + [transfers(lambda k: db.get("cc", k).version, b"2")]
    return orgs, chain(blocks)


@pytest.fixture(scope="module")
def cuda_cpu():
    from fabric_tpu_torch.bccsp.cuda import CudaProvider
    return CudaProvider(device="cpu", fast_key_threshold=1)


# ---------------------------------------------------------------------------
# what the ops plane saw
# ---------------------------------------------------------------------------

def series(P) -> dict:
    """name -> (kind, {label set: value}): counters' and gauges' values,
    histograms' observation counts."""
    out = {}
    for name, m in P.ops.registry.metrics().items():
        with m._lock:
            if isinstance(m, P.ops.Histogram):
                out[name] = ("histogram", dict(m._n))
            elif isinstance(m, P.ops.Counter):
                out[name] = ("counter", dict(m._values))
            else:
                out[name] = ("gauge", dict(m._values))
    return out


def moved(before: dict, after: dict) -> dict:
    """The series a run moved: counters' and histograms' deltas, gauges'
    values (every gauge is cleared when a run starts)."""
    out = {}
    for name, (kind, vals) in after.items():
        old = before.get(name, (kind, {}))[1]
        if kind == "gauge":
            ch = dict(vals)
        else:
            ch = {k: v - old.get(k, 0) for k, v in vals.items()
                  if v != old.get(k, 0)}
        if ch:
            out[name] = (kind, ch)
    return out


class Observe:
    """Context: the package's gauges cleared and its tracer on (sample
    rate 1.0, recorder empty) -> .moved (`moved`) and .traces, each
    recorded trace as sorted (name, parent's name, attributes) rows."""

    def __init__(self, P):
        self.P = P

    def __enter__(self):
        ops = self.P.ops
        for m in ops.registry.metrics().values():
            if isinstance(m, ops.Gauge):
                with m._lock:
                    m._values.clear()
        self.before = series(self.P)
        self.was = (ops.tracer.enabled, ops.tracer.sample_rate)
        ops.tracer.reset()
        ops.tracer.configure({"enabled": True, "sample_rate": 1.0})
        return self

    def __exit__(self, *exc):
        ops = self.P.ops
        self.moved = moved(self.before, series(self.P))
        rec = ops.tracer.recorder
        traces = []
        for summary in rec.list()["recent"]:
            spans = rec.get(summary["trace_id"])["spans"]
            names = {s["span_id"]: s["name"] for s in spans}
            rows = []
            for s in spans:
                attrs = {k: v for k, v in s["attributes"].items()
                         if k not in TIMES}
                if s["attributes"].get("links"):
                    attrs["n_links"] = len(s["attributes"]["links"])
                rows.append((s["name"], names.get(s["parent_id"]), attrs))
            traces.append(sorted(rows, key=repr))
        self.traces = sorted(traces, key=repr)
        ops.tracer.reset()
        ops.tracer.enabled, ops.tracer.sample_rate = self.was
        return False


def provider_blind(traces):
    """The traces without what only the provider determines: the
    bccsp.batch_verify span keeps its name, parent and batch size."""
    out = []
    for rows in traces:
        out.append([(n, p, {"batch_size": a["batch_size"]}
                     if n == "bccsp.batch_verify" else a)
                    for n, p, a in rows])
    return out


def comparable(moved_series, timing=()):
    """(names and label sets of every non-provider series moved, values
    of those whose value a run determines)."""
    shape, values = {}, {}
    for name, (kind, vals) in moved_series.items():
        if name.startswith("provider_"):
            continue
        shape[name] = (kind, sorted(vals))
        if name in timing:
            continue
        if kind == "gauge" and name not in EXACT_GAUGES:
            continue
        values[name] = vals
    return shape, values


# ---------------------------------------------------------------------------
# the stacks
# ---------------------------------------------------------------------------

def stack(P, orgs, provider, tail="deep", cache=None, early_abort=False,
          **ledger_kw):
    """Committer -> TxValidator (`tail`: deep, classic or kv7) ->
    KVLedger(**ledger_kw) -> (committer, device validator or None)."""
    policies = P.committer.PolicyRegistry()
    policies.set_policy("cc", P.policy.parse_policy(POLICY))
    kv7 = tail == "kv7"
    ledger = P.ledger.KVLedger("ch", P.ledger.LedgerConfig(
        device_validate=kv7, **ledger_kw))
    dv = None
    if kv7 and P.name == "port":
        dv = P.dv.DeviceValidator(ledger.statedb, "ch", device="cpu")
    elif kv7:
        import jax
        dv = P.dv.DeviceValidator(ledger.statedb, "ch",
                                  devices=[jax.devices()[0]])
    if dv is not None:
        ledger.set_prepared_source(dv.take_prepared)
    overlay = ledger.pending_overlay if ledger_kw.get("commit_window") \
        else None
    ea = (P.pc.EarlyAbortAnalyzer(ledger.statedb, "ch",
                                  overlay_source=overlay)
          if early_abort else None)
    v = P.committer.TxValidator(
        "ch", msps_of(P, orgs), provider, policies, early_abort=ea,
        device_validate=dv, verify_cache=cache,
        sbe_lookup=(P.sbe.statedb_lookup(ledger.statedb)
                    if tail == "classic" else None))
    return P.committer.Committer(ledger, v), dv


def block_of(P, raw):
    return P.wire.parse_block(raw) if P.wire else P.proto.Block.deserialize(
        raw)


def rows_of(res, lg):
    return (res.final_flags.codes(), state_rows(lg), history_rows(lg),
            lg.commit_hash)


def run_serial(P, com, raws):
    out = []
    for raw in raws:
        out.append(rows_of(com.store_block(block_of(P, raw)), com.ledger))
    return out


def kv7_durable(P, provider, orgs, raws, root):
    com, dv = stack(P, orgs, provider, "kv7", early_abort=True,
                    root=os.path.join(root, "src"), state_shards=4,
                    snapshot_every=2)
    out = run_serial(P, com, raws)
    lg = com.ledger
    with P.ops.tracer.start_span("snapshot"):
        meta = P.snapshot.export_meta(lg)
        payloads = {"state": [], "history": []}
        for ent in meta["files"]:
            buf = bytearray()
            while True:
                resp = P.snapshot.serve_chunk(lg, ent["db"], ent["gen"],
                                              ent["file"], len(buf))
                buf += resp["data"]
                if resp["eof"]:
                    break
            payloads[ent["db"]].append(bytes(buf))
        P.snapshot.install(os.path.join(root, "dst"), "ch", meta, payloads)
    dst = P.ledger.KVLedger("ch", P.ledger.LedgerConfig(
        root=os.path.join(root, "dst"), state_shards=4))
    out.append((dst.height, dst.commit_hash, meta["height"]))
    out.append({k: v for k, v in dv.stats[
        "validator_device_demotions_total"].items() if v}
        if P.name == "port" else None)
    return out


def deep_window(P, provider, orgs, raws):
    com, _ = stack(P, orgs, provider, "deep", commit_window=4)
    rows = []

    def listener(block, final):
        lg = com.ledger
        rows.append((final.codes(), state_rows(lg), history_rows(lg),
                     lg.commit_hash))
    com.add_commit_listener(listener)
    pipe = P.committer.PipelinedCommitter(com)
    try:
        futs = []
        for raw in raws:
            with P.ops.tracer.start_span("pipeline.submit"):
                futs.append(pipe.submit(block_of(P, raw)))
        [f.result(timeout=600) for f in futs]
        pipe.drain(timeout=60)
    finally:
        pipe.close()
    st = com.ledger._commit_window.stats()
    return rows, {k: st[k] for k in ("admitted", "retired")}, \
        st["early_txs"] + st["deferred_txs"]


def classic_cache(P, provider, orgs, raws):
    cache = P.vp.VerdictCache(65536, owner="peer0")
    com, _ = stack(P, orgs, provider, "classic", cache=cache,
                   parallel_commit=True, commit_workers=4)
    out = run_serial(P, com, raws[:2])
    msps = com.validator.msps
    spec = P.vp.SpeculativeVerifier(cache, lambda: provider,
                                    lambda cid: msps)
    spec.stamp(list(P.proto.Block.deserialize(raws[2]).data),
               ["ch"] * 100)
    queued = []                 # the worker's one batch (its _loop)
    while spec._queue:
        queued += spec._queue.popleft()[1]
    spec._verify_batch(queued, stage="overlap", scope="ch")
    out += run_serial(P, com, raws[2:])
    return out, cache.coverage.frac()


SCENARIOS = {
    "kv7_durable": lambda P, prov, orgs, raws, tmp: kv7_durable(
        P, prov, orgs, raws, os.path.join(tmp, P.name)),
    "deep_window": lambda P, prov, orgs, raws, tmp: deep_window(
        P, prov, orgs, raws),
    "classic_cache": lambda P, prov, orgs, raws, tmp: classic_cache(
        P, prov, orgs, raws),
}


@pytest.fixture(scope="module")
def observed(pk, stream, cuda_cpu, tmp_path_factory):
    """{scenario: {package: (result, Observe)}}, each scenario run once
    on each package."""
    orgs, raws = stream
    tmp = str(tmp_path_factory.mktemp("wiring"))
    out = {}
    for name, run in SCENARIOS.items():
        out[name] = {}
        for pkg in PKGS:
            P = pk[pkg]
            prov = P.sw if pkg == "ref" else cuda_cpu
            with Observe(P) as seen:
                result = run(P, prov, orgs, raws, os.path.join(tmp, name))
            out[name][pkg] = (result, seen)
    return out


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_results_equal_to_reference(observed, scenario):
    """Flags, state, history and commit hashes (and the scenario's own
    counts) are the reference's with the plane wired in."""
    got = observed[scenario]
    ref, port = got["ref"][0], got["port"][0]
    if scenario == "kv7_durable":
        assert port[-1] == {}           # KV7 never demoted
        port, ref = port[:-1], ref[:-1]
    assert port == ref


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_series_names_and_labels_equal(observed, scenario):
    timing = WINDOW_TIMING if scenario == "deep_window" else ()
    shapes = [comparable(observed[scenario][p][1].moved, timing)[0]
              for p in PKGS]
    assert shapes[1] == shapes[0]
    assert "ledger_height" in shapes[0]


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_series_values_equal(observed, scenario):
    """Counter values, histogram observation counts and deterministic
    gauges."""
    timing = WINDOW_TIMING if scenario == "deep_window" else ()
    values = [comparable(observed[scenario][p][1].moved, timing)[1]
              for p in PKGS]
    assert values[1] == values[0]
    height = values[0]["ledger_height"]
    assert height == {(("channel", "ch"),): 3}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_traces_equal(observed, scenario):
    """Every trace: span names, parents and attributes (times, trace ids
    and the provider's own attributes left out; on the window, the
    admit's timing-dependent counts)."""
    traces = []
    for p in PKGS:
        t = provider_blind(observed[scenario][p][1].traces)
        if scenario == "deep_window":
            t = [[(n, par, {k: "?" if k in WINDOW_SPAN_TIMING else v
                            for k, v in a.items()})
                  for n, par, a in rows] for rows in t]
        traces.append(t)
    assert traces[1] == traces[0]
    assert traces[0]


# the spans each scenario's block traces must hold, under their parents
EXPECTED = {
    "kv7_durable": {
        ("committer.store_block", None), ("validator.collect",
                                          "committer.store_block"),
        ("bccsp.batch_verify", "committer.store_block"),
        ("validator.dispatch_wait", "committer.store_block"),
        ("validator.gate", "committer.store_block"),
        ("ledger.block_commit", "committer.store_block"),
        ("ledger.state_commit", "committer.store_block"),
        ("ledger.history_commit", "committer.store_block"),
        ("committer.notify", "committer.store_block"),
        ("history.checkpoint", "committer.store_block"),
        ("state.checkpoint", "committer.store_block"),
        ("state.snapshot_export", "snapshot"),
        ("state.snapshot_install", "snapshot")},
    "deep_window": {
        ("validator.collect", "pipeline.submit"),
        ("bccsp.batch_verify", "pipeline.submit"),
        ("mvcc.window.admit", "pipeline.submit")},
    "classic_cache": {
        ("verify_plane.speculative", None),
        ("bccsp.batch_verify", "verify_plane.speculative"),
        ("mvcc.graph", "committer.store_block"),
        ("validator.collect", "committer.store_block")},
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_expected_spans_present(observed, scenario):
    seen = {(n, par) for rows in observed[scenario]["port"][1].traces
            for n, par, _a in rows}
    assert EXPECTED[scenario] <= seen, EXPECTED[scenario] - seen


def test_speculative_links_and_coverage(observed):
    """Block 2's validator.collect links the speculative trace whose
    verdicts it consumed, and every unique item of it was cached."""
    for p in PKGS:
        (_rows, coverage), seen = observed["classic_cache"][p]
        collects = [a for rows in seen.traces for n, _par, a in rows
                    if n == "validator.collect" and a["block"] == 2]
        assert collects and collects[0]["n_links"] >= 1
        assert collects[0]["cache_hits"] > 0
        assert collects[0].get("cache_misses", 0) == 0
    ref, port = (observed["classic_cache"][p][1].moved[
        "speculative_coverage_frac"] for p in PKGS)
    assert port == ref


def test_window_series_match_the_window(observed):
    """On the window, what depends on timing is held to the run's own
    CommitWindow: blocks admitted, txs early + deferred."""
    for p in PKGS:
        (_rows, st, txs), seen = observed["deep_window"][p]
        mv = seen.moved
        assert mv["commit_window_admitted_total"][1] == {
            (("channel", "ch"),): st["admitted"]}
        assert sum(mv["commit_window_txs_total"][1].values()) == txs
        admits = [a for rows in seen.traces for n, _par, a in rows
                  if n == "mvcc.window.admit"]
        assert len(admits) == st["admitted"] == 3
        assert sum(a["early"] + a["deferred"] for a in admits) == txs


def test_port_provider_series_on_the_stacks(observed):
    """The port's stacks ran KP3 (plain) only: the rows lane on "cpu",
    slots equal to items, the queue drained, every item resolved."""
    for scenario in SCENARIOS:
        mv = observed[scenario]["port"][1].moved
        slots = mv["provider_lane_slots_total"][1]
        assert set(slots) == {(("device", "cpu"), ("lane", "rows"))}
        assert "provider_pad_slots_total" not in mv     # no pad slot
        assert mv["provider_dispatch_queue_depth"][1] == {(): 0.0}
        items = sum(slots.values())
        assert mv["provider_device_sigs_total"][1][()] >= items > 0


# ---------------------------------------------------------------------------
# the provider's lanes against JaxTpuProvider's
# ---------------------------------------------------------------------------

def lane_items():
    """30 P-256 items: 12 and 12 under two keys, 6 under a third, one
    wrong digest a key."""
    import hashlib
    from fabric_tpu.bccsp.provider import SCHEME_P256, VerifyItem
    from fabric_tpu.bccsp.sw import SoftwareProvider
    sw = SoftwareProvider()
    rng = random.Random(16)
    keys = [sw.key_gen(SCHEME_P256) for _ in range(3)]
    items = []
    for i in range(30):
        k = keys[0] if i < 12 else keys[1] if i < 24 else keys[2]
        d = hashlib.sha256(rng.randbytes(8)).digest()
        sig = sw.sign(k, d)
        if i in (3, 15, 27):
            d = hashlib.sha256(b"wrong").digest()
        items.append(VerifyItem(SCHEME_P256, k.public_bytes(), sig, d))
    return items


def test_lane_series_match_jaxtpu(pk):
    """fast_key_threshold 8: the two 12-signature keys take the fixed-key
    lane (KP3; the reference's rows), the third the generic one (KP2;
    generic).  Series names, label names and lane values, fill histogram
    counts, provider_device_sigs_total and the span's counts equal; the
    device label is each package's own name of the device and the slots
    differ by design (the reference pads to buckets; on the CPU's plain
    path the port's slots are the items)."""
    from fabric_tpu.bccsp.jaxtpu import JaxTpuProvider
    from fabric_tpu_torch.bccsp import VerifyItem as PortItem
    from fabric_tpu_torch.bccsp.cuda import CudaProvider
    items = lane_items()
    provs = {"ref": JaxTpuProvider(fast_key_threshold=8),
             "port": CudaProvider(device="cpu", fast_key_threshold=8)}
    got = {}
    for p in PKGS:
        P = pk[p]
        batch = items if p == "ref" else [PortItem(*it) for it in items]
        with Observe(P) as seen:
            with P.ops.tracer.start_span("lanes"):
                verdicts = np.asarray(provs[p].batch_verify(batch))
        got[p] = (verdicts, seen)
    np.testing.assert_array_equal(got["port"][0], got["ref"][0])
    assert got["port"][0].sum() == 27
    mv = {p: {k: v for k, v in got[p][1].moved.items()
              if k.startswith("provider_")} for p in PKGS}

    def shape(P):
        """Each provider series' label sets on these two lanes (or with
        no lane label), the device label's value masked."""
        out = {}
        for name, (kind, vals) in series(P).items():
            if name.startswith("provider_"):
                out[name] = (kind, sorted(
                    tuple((k, "<dev>" if k == "device" else v)
                          for k, v in labels) for labels in vals
                    if dict(labels).get("lane", "rows") in ("rows",
                                                            "generic")))
        return out
    assert shape(pk["port"]) == shape(pk["ref"])
    assert set(mv["port"]) == set(mv["ref"]) - {"provider_pad_slots_total"}
    for p in PKGS:
        assert mv[p]["provider_device_sigs_total"][1] == {(): 30.0}
        assert mv[p]["provider_dispatch_queue_depth"][1] == {(): 0.0}
    assert mv["port"]["provider_lane_fill"] == mv["ref"]["provider_lane_fill"]
    slots = mv["port"]["provider_lane_slots_total"][1]
    assert slots == {(("device", "cpu"), ("lane", "rows")): 24.0,
                     (("device", "cpu"), ("lane", "generic")): 6.0}
    spans = [provider_attrs(got[p][1].traces) for p in PKGS]
    assert spans[1] == spans[0] == [{
        "batch_size": 30, "device_sigs": 30, "dispatches": 2,
        "fast_key_sigs": 24, "table_builds": 2}]


def provider_attrs(traces):
    return [{k: v for k, v in a.items() if k != "provider"}
            for rows in traces for n, _p, a in rows
            if n == "bccsp.batch_verify"]


def test_lane_slots_on_a_mesh_charge_each_shard():
    """Under a mesh of three CPU shards each device's share is its
    shards' items (shard_bounds), charged to its own label, as the
    reference's _per_device_slots charges each chip's tile."""
    import torch
    from fabric_tpu_torch.bccsp import cuda
    from fabric_tpu_torch.parallel import mesh
    prov = cuda.CudaProvider.__new__(cuda.CudaProvider)
    prov.mesh = mesh.make_mesh(["cpu"] * 3)
    assert prov._per_device_slots("p256-rows", 10) == [("cpu", 10, 10)]
    prov.mesh = mesh.DeviceMesh(
        (torch.device("cpu"), torch.device("meta"), torch.device("cpu")),
        (None, None, None))
    assert prov._per_device_slots("ed25519", 10) == [("cpu", 7, 7),
                                                     ("meta", 3, 3)]
    prov.mesh = None
    prov.device = torch.device("cpu")
    assert prov._per_device_slots("p256", 5) == [("cpu", 5, 5)]


def test_grid_slots_follow_the_kernels_launch_geometry():
    """A launch's slots on CUDA are blocks x items a block, the block
    sizes being the launch functions' in ops/csrc."""
    import re
    from pathlib import Path

    import torch
    from fabric_tpu_torch.bccsp import cuda
    csrc = Path(cuda.__file__).resolve().parents[1] / "ops" / "csrc"
    per_thread = {"p256": ("p256_verify.cu", "threads", 1),
                  "p256-rows": ("p256_verify_rows.cu", "THREADS", 1),
                  "ed25519": ("ed25519_verify.cu", "THREADS", 4),
                  "ed25519-rows": ("ed25519_verify_rows.cu", "THREADS", 4),
                  "idemix-pair": (None, None, 1)}
    from fabric_tpu_torch.ops import bn254
    for kind, (src, name, threads_a_item) in per_thread.items():
        if src is None:
            threads = bn254.THREADS
        else:
            text = (csrc / src).read_text()
            threads = int(re.search(
                rf"\b{name}\s*=\s*(\d+)", text).group(1))
        assert cuda.GRID_ITEMS[kind] == threads // threads_a_item, kind
    dev = torch.device("cuda")
    assert cuda.grid_slots("p256", 129, dev) == 256
    assert cuda.grid_slots("ed25519", 33, dev) == 64
    assert cuda.grid_slots("ed25519", 33, torch.device("cpu")) == 33


# ---------------------------------------------------------------------------
# placement and the mid-window counter
# ---------------------------------------------------------------------------

class FakeProvider:
    def __init__(self, mesh, device=None):
        self.mesh, self.device = mesh, device


def test_placement_decisions_with_the_queue_gauge_live(pk):
    """The same seeded demand sequence through both packages' schedulers
    while each package's provider_dispatch_queue_depth moves the same
    way: the same snapshots after every report, and the same
    placement_channel_devices gauge."""
    import torch
    rng = random.Random(16)
    script = [(rng.choice("abc"), rng.choice([0, 10, 100, 1000, 5000]),
               rng.choice([0.0, 0.0, 50.0, 900.0])) for _ in range(300)]
    snaps = {}
    for p in PKGS:
        P = pk[p]
        g = P.ops.registry.gauge(
            "provider_dispatch_queue_depth",
            "device dispatches enqueued, not yet resolved")
        clock = [0.0]
        if p == "ref":
            import jax
            devs = [jax.devices()[0]] * 8
            sched = P.placement.PlacementScheduler(
                devices=devs, provider_factory=lambda m: FakeProvider(m),
                idle_halflife_s=10.0, clock=lambda: clock[0])
        else:
            sched = P.placement.PlacementScheduler(
                devices=[torch.device("cpu")] * 8,
                provider_factory=FakeProvider, idle_halflife_s=10.0,
                clock=lambda: clock[0])
        out = []
        try:
            for ch, demand, backlog in script:
                g.set(backlog)
                clock[0] += 1.0
                sched.provider_for(ch, demand=demand or None)
                snap = sched.snapshot()
                out.append(({c: (v["devices"], v["span_start"],
                                 v["demand_ewma"])
                             for c, v in snap["channels"].items()},
                            snap["rebalances"]))
            gauge = P.ops.registry.gauge("placement_channel_devices")
            out.append(sorted(gauge.values().items()))
        finally:
            g.set(0.0)
        snaps[p] = out
    assert snaps["port"] == snaps["ref"]
    assert snaps["port"][-2][1] > 1


def test_midwindow_counter_counts_blocks_behind_a_pending_overlay(pk):
    """A block validated while the window's overlay is not empty counts
    one validator_midwindow_blocks_total, in both packages."""
    for p in PKGS:
        P = pk[p]

        class Overlay:
            empty = False

        class Abort:
            overlay_source = staticmethod(lambda: Overlay())

            @staticmethod
            def doomed(block, overlay=None):
                return {}

        v = P.committer.TxValidator("mw", {}, P.sw,
                                    P.committer.PolicyRegistry(),
                                    early_abort=Abort())
        c = P.ops.registry.counter("validator_midwindow_blocks_total")
        before = c.value(channel="mw")
        assert v._doomed_txs(object()) is None
        assert c.value(channel="mw") == before + 1
