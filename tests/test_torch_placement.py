"""The port's per-channel placement (fabric_tpu_torch.parallel.placement,
and allocate_devices / carve_submeshes of parallel/mesh.py) against the
reference's, and the factory's mesh and placement options.

- The cases of tests/test_placement.py:62-249 against the port's copies
  (the per-device slot attribution and padding cases have no counterpart:
  the port has no lane telemetry and pads nothing, ROADMAP C5 and C).
- allocate_devices and the scheduler's snapshots against the reference's
  on seeded random weights and demand sequences.
- FactoryOpts.use_mesh / placement / mesh_devices with visible_devices
  patched to eight CPU devices and to one: a mesh or a scheduler only
  with more than one device.

Pure host bookkeeping: no kernel runs.
"""
import random

import pytest
import torch

from fabric_tpu.parallel import mesh as ref_mesh
from fabric_tpu.parallel.placement import PlacementScheduler as RefScheduler
from fabric_tpu_torch import device as devmod
from fabric_tpu_torch.bccsp import FactoryOpts, factory, init_factories
from fabric_tpu_torch.bccsp.cuda import CudaProvider
from fabric_tpu_torch.parallel import mesh as M
from fabric_tpu_torch.parallel.placement import PlacementScheduler

CPU = torch.device("cpu")


class FakeProvider:
    def __init__(self, mesh, device=None):
        self.mesh = mesh
        self.device = device


def _scheduler(n=8, **kw):
    return PlacementScheduler(devices=[CPU] * n,
                              provider_factory=FakeProvider, **kw)


# -- allocation --------------------------------------------------------------

def test_allocate_single_consumer_gets_everything():
    assert M.allocate_devices(8, [1.0]) == [8]


def test_allocate_even_three_way():
    assert M.allocate_devices(8, [1, 1, 1]) == [4, 2, 2]


def test_allocate_skew_absorbs_leftovers():
    assert M.allocate_devices(8, [10, 1]) == [4, 4]


def test_allocate_non_power_of_two_pool():
    assert M.allocate_devices(7, [5, 1, 1]) == [4, 2, 1]


def test_allocate_sizes_are_powers_of_two_and_fit():
    for n in (4, 7, 8, 16):
        for w in ([1], [3, 1], [1, 1, 1, 1], [9, 3, 1]):
            sizes = M.allocate_devices(n, w)
            assert sum(sizes) <= n
            assert all(s & (s - 1) == 0 for s in sizes), sizes


def test_allocate_more_consumers_than_devices_raises():
    with pytest.raises(ValueError):
        M.allocate_devices(2, [1, 1, 1])


def test_allocate_matches_reference_on_seeded_weights():
    rng = random.Random(2024)
    for _ in range(300):
        n = rng.randrange(1, 17)
        weights = [rng.choice([0, 0.5, 1, 3, 10, 1000]) * rng.random()
                   for _ in range(rng.randrange(0, n + 1))]
        assert M.allocate_devices(n, weights) == \
            ref_mesh.allocate_devices(n, weights)


def test_carve_submeshes_disjoint_contiguous(monkeypatch):
    # make_mesh gets the span of device positions each sub-mesh covers
    monkeypatch.setattr(M, "make_mesh", list)
    rng = random.Random(5)
    for _ in range(50):
        weights = [rng.random() * 10 for _ in range(rng.randrange(1, 9))]
        spans = M.carve_submeshes(list(range(8)), weights)
        seen = [i for span in spans for i in span]
        assert len(seen) == len(set(seen))        # disjoint
        assert seen == list(range(len(seen)))     # contiguous, in order
        assert [len(s) for s in spans] == ref_mesh.allocate_devices(
            8, weights)


def test_carve_submeshes_are_meshes():
    meshes = M.carve_submeshes([CPU] * 8, [1, 1, 1])
    assert [len(m) for m in meshes] == [4, 2, 2]
    assert all(isinstance(m, M.DeviceMesh) for m in meshes)


# -- scheduler ---------------------------------------------------------------

def test_scheduler_single_channel_owns_all_devices():
    ps = _scheduler()
    p = ps.provider_for("ch")
    assert ps.snapshot()["channels"]["ch"]["devices"] == 8
    assert len(p.mesh) == 8 and p.device is None


def test_scheduler_registration_recarves_and_caches_providers():
    ps = _scheduler()
    p1 = ps.provider_for("a", demand=100)
    p2 = ps.provider_for("b", demand=100)
    assert ps.snapshot()["channels"]["a"]["devices"] == 4
    assert ps.snapshot()["channels"]["b"]["devices"] == 4
    assert p1 is not p2
    # same span -> same cached provider instance
    assert ps.provider_for("a", demand=100) is ps.provider_for(
        "a", demand=100)


def test_scheduler_hysteresis_ignores_small_drift():
    ps = _scheduler()
    for ch in ("a", "b", "c"):
        ps.provider_for(ch, demand=100)
    r0 = ps.rebalances
    for _ in range(10):
        ps.provider_for("a", demand=120)     # < rebalance_ratio drift
    assert ps.rebalances == r0


def test_scheduler_drift_without_allocation_change_skips_recarve():
    ps = _scheduler()
    ps.provider_for("a", demand=100)
    ps.provider_for("b", demand=100)
    r0 = ps.rebalances
    # 30x skew still allocates [4, 4] on 8 devices: no carve
    for _ in range(20):
        ps.provider_for("a", demand=3000)
    assert ps.rebalances == r0


def test_scheduler_demand_skew_resizes_spans():
    ps = _scheduler()
    for ch in ("a", "b", "c"):
        ps.provider_for(ch, demand=100)
    assert ps.snapshot()["channels"]["a"]["devices"] == 4
    r0 = ps.rebalances
    for _ in range(20):
        ps.provider_for("b", demand=3000)
    snap = ps.snapshot()
    assert ps.rebalances > r0
    assert snap["channels"]["b"]["devices"] == 4
    assert snap["channels"]["a"]["devices"] == 2


def test_scheduler_spans_disjoint_after_rebalance():
    ps = _scheduler()
    for ch in ("a", "b", "c"):
        ps.provider_for(ch, demand=100)
    for _ in range(20):
        ps.provider_for("b", demand=5000)
    spans = sorted((v["span_start"], v["devices"])
                   for v in ps.snapshot()["channels"].values())
    lo = 0
    for start, size in spans:
        assert start == lo
        lo = start + size
    assert lo <= 8


def test_scheduler_idle_channel_decays_and_releases_span():
    clock = [0.0]
    ps = _scheduler(idle_halflife_s=10.0, clock=lambda: clock[0])
    for _ in range(20):
        ps.provider_for("a", demand=100)
        ps.provider_for("b", demand=100)
        ps.provider_for("quiet", demand=3000)
    assert ps.snapshot()["channels"]["quiet"]["devices"] == 4
    for _ in range(10):
        clock[0] += 10.0
        ps.provider_for("a", demand=100)
        ps.provider_for("b", demand=100)
    snap = ps.snapshot()
    assert snap["channels"]["quiet"]["demand_ewma"] < 100.0
    assert snap["channels"]["quiet"]["devices"] == 2
    assert snap["channels"]["a"]["devices"] == 4


def test_scheduler_decay_is_idempotent_within_a_halflife():
    clock = [0.0]
    ps = _scheduler(idle_halflife_s=10.0, clock=lambda: clock[0])
    ps.provider_for("a", demand=100)
    ps.provider_for("b", demand=100)
    clock[0] += 15.0
    for _ in range(50):
        ps.provider_for("a", demand=100)
    assert ps.snapshot()["channels"]["b"]["demand_ewma"] == \
        pytest.approx(50.0)


def test_scheduler_decay_disabled_with_nonpositive_halflife():
    clock = [0.0]
    ps = _scheduler(idle_halflife_s=0.0, clock=lambda: clock[0])
    ps.provider_for("a", demand=100)
    ps.provider_for("b", demand=100)
    clock[0] += 1e6
    ps.provider_for("a", demand=100)
    assert ps.snapshot()["channels"]["b"]["demand_ewma"] == \
        pytest.approx(100.0)


def test_scheduler_wrap_applied_once_per_span():
    wrapped = []

    def wrap(p):
        wrapped.append(p)
        return ("wrapped", p)

    ps = _scheduler(wrap=wrap)
    w1 = ps.provider_for("ch")
    w2 = ps.provider_for("ch")
    assert w1 == w2 and w1[0] == "wrapped"
    assert len(wrapped) == 1


def test_single_device_span_pins_device():
    devices = [torch.device("cpu"), torch.device("meta")]
    ps = PlacementScheduler(devices=devices, provider_factory=FakeProvider)
    ps.provider_for("a", demand=1)
    for _ in range(20):
        ps.provider_for("b", demand=1)
    ps.provider_for("a", demand=1)   # materialize a's span provider too
    # both channels at 1 device each: span providers have no mesh and
    # are pinned to the device of their span
    got = {ch: ps._providers[(v["span_start"], v["devices"])]
           for ch, v in ps.snapshot()["channels"].items()}
    assert all(v["devices"] == 1 for v in ps.snapshot()["channels"].values())
    assert {p.device for p in got.values()} == set(devices)
    assert all(p.mesh is None for p in got.values())


def test_scheduler_demand_backlog_reads_zero():
    # the reference folds its ops plane's provider_dispatch_queue_depth
    # into each demand sample; the port has no ops plane yet (A3.7)
    assert PlacementScheduler._queue_backlog() == 0.0
    ps = _scheduler()
    ps.provider_for("a", demand=100)
    assert ps.snapshot()["channels"]["a"]["demand_ewma"] == 100.0


class RefFakeDev:
    def __init__(self, i):
        self.platform = "cpu"
        self.id = i


class RefFakeProvider:
    def __init__(self, mesh):
        self.mesh = mesh
        self.device_labels = ("cpu:0",)


@pytest.mark.parametrize("seed", range(6))
def test_scheduler_snapshots_match_reference(seed, monkeypatch):
    """The same seeded sequence of flushes (channel, demand, clock step)
    gives the same carve, EWMAs, rebalances and span cache (the
    reference's dispatch backlog held at 0, as the port reads it)."""
    monkeypatch.setattr(RefScheduler, "_queue_backlog",
                        staticmethod(lambda: 0.0))
    rng = random.Random(seed)
    clock = [0.0]
    kw = dict(idle_halflife_s=10.0, clock=lambda: clock[0])
    ref = RefScheduler(devices=[RefFakeDev(i) for i in range(8)],
                       provider_factory=RefFakeProvider, **kw)
    ps = _scheduler(**kw)
    channels = ["ch%d" % i for i in range(rng.randrange(1, 6))]
    for _ in range(200):
        ch = rng.choice(channels)
        demand = rng.choice([None, 0, 1, 50, 100, 400, 3000])
        clock[0] += rng.choice([0.0, 0.5, 3.0, 12.0])
        ref.provider_for(ch, demand=demand)
        ps.provider_for(ch, demand=demand)
        assert ps.snapshot() == ref.snapshot()


# -- factory wiring ----------------------------------------------------------

def test_factory_placement_disabled_returns_none():
    init_factories(FactoryOpts(default="SW"))
    assert factory.get_placement() is None
    assert factory.provider_for_channel("ch") is None


@pytest.fixture
def eight_cpus(monkeypatch):
    devs = [CPU] * 8
    monkeypatch.setattr(devmod, "visible_devices", lambda: list(devs))
    monkeypatch.setattr(M, "visible_devices", lambda: list(devs))
    return devs


def test_factory_use_mesh_over_visible_devices(eight_cpus):
    p = init_factories(FactoryOpts(use_mesh=True))
    assert isinstance(p, CudaProvider) and len(p.mesh) == 8
    assert p.key_tables.devices == (CPU,)
    assert factory.get_placement() is None
    p = init_factories(FactoryOpts(use_mesh=True, mesh_devices=3))
    assert len(p.mesh) == 3
    p = init_factories(FactoryOpts(device="cpu"))
    assert p.mesh is None
    assert len(M.make_mesh()) == 8


def test_factory_placement_over_visible_devices(eight_cpus):
    p = init_factories(FactoryOpts(placement=True, device="cpu"))
    assert p.mesh is None
    ps = factory.get_placement()
    assert isinstance(ps, PlacementScheduler) and len(ps.devices) == 8
    a = factory.provider_for_channel("a", demand=100)
    assert isinstance(a, CudaProvider) and len(a.mesh) == 8
    factory.provider_for_channel("b", demand=100)
    a = factory.provider_for_channel("a", demand=100)
    assert len(a.mesh) == 4
    init_factories(FactoryOpts(placement=True, mesh_devices=2,
                               device="cpu"))
    assert len(factory.get_placement().devices) == 2


def test_factory_one_device_builds_no_mesh_or_scheduler(monkeypatch):
    """On one card use_mesh and placement give today's single-device
    provider."""
    monkeypatch.setattr(devmod, "visible_devices", lambda: [CPU])
    p = init_factories(FactoryOpts(use_mesh=True, placement=True,
                                   device="cpu"))
    assert isinstance(p, CudaProvider) and p.mesh is None
    assert p.device == CPU
    assert factory.get_placement() is None
    assert factory.provider_for_channel("ch") is None


def test_factory_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_factories(FactoryOpts(use_mesh=True))
    with pytest.raises(RuntimeError, match="CUDA"):
        devmod.visible_devices()
