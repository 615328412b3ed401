"""The port's degrading BCCSP wrapper (fabric_tpu_torch.bccsp.degrade) and
the factory's `degrade` option against the reference's, on the CPU.

- One failure script runs through both packages' `DegradingProvider`
  over a scripted primary: a good batch, a raise on enqueue, a raise on
  resolve (the breaker trips: threshold 2), a batch while tripped (SW
  only), a failed probe after the cooldown (re-trip, longer cooldown),
  a probe that fails at enqueue, and a good probe (restored).  The
  reference's watch on a primary's silent fallbacks is not ported (the
  port's primary raises), so the script has no silent step; the port's
  wrapper counts every batch and item its SW fallback verified.
  Time is a fake clock patched into both modules.  After each step the
  two packages agree on the state, `backend`, which side verified, the
  verdicts (equal to SW's), the `bccsp_degraded` gauge and the
  `bccsp_breaker_transitions_total` series by (to, reason).
- The factory's rule: CUDA (on `device="cpu"`) bare and fail-stop by
  default (the reference wraps its device kind by default), wrapped
  over a `CudaProvider` with `degrade=True`; SW bare, explicit True on
  SW wrapped; under placement with `degrade=True` each span's provider
  wrapped once.
- The wrapper over `CudaProvider(device="cpu")` stays HEALTHY on a
  small corpus with verdicts equal to SW's, `fallbacks` 0 and nothing
  verified by its fallback.

Tolerance: exact equality."""
import types

import numpy as np
import pytest
import torch

from fabric_tpu.msp.ca import DevOrg

from intake_world import PKGS, load


@pytest.fixture(scope="module")
def pk():
    return {name: load(name) for name in PKGS}


def corpus(P, n=6):
    """n P-256 items of one identity (signed through the reference's SW
    default), every third with a wrong digest, as package P's items."""
    from fabric_tpu.bccsp.factory import FactoryOpts, init_factories
    init_factories(FactoryOpts(default="SW"))
    ident = DevOrg("Org1").new_identity("signer")
    items = []
    for i in range(n):
        msg = b"msg-%d" % i
        item = ident.verify_item(msg, ident.sign(msg))
        items.append(P.bccsp.VerifyItem(
            item.scheme, item.pubkey, item.signature,
            item.payload if i % 3 else b"\x00" * 32))
    return items


class Scripted:
    """A primary provider that obeys a script, one entry a batch:
    "ok", "enqueue" (raise when enqueued) or "resolve" (raise when
    resolved)."""

    name = "cuda"

    def __init__(self, sw):
        self.sw = sw
        self.script = []
        self.calls = 0
        self.stats = {"fallbacks": 0}

    def batch_verify_async(self, items):
        self.calls += 1
        what = self.script.pop(0)
        if what == "enqueue":
            raise RuntimeError("device lost")
        out = self.sw.batch_verify(items)

        def resolve():
            if what == "resolve":
                raise RuntimeError("sync failed")
            return out
        return resolve

    def batch_verify(self, items):
        return self.batch_verify_async(items)()


STEPS = (
    # (script entry or None for "not reached", clock advance in s)
    ("ok", 0.0),
    ("enqueue", 0.0),
    ("resolve", 0.0),         # second consecutive failure: trips
    (None, 0.5),              # inside the 1-s cooldown: SW only
    ("resolve", 1.0),         # the probe fails: re-trips, cooldown 2 s
    (None, 1.0),              # still cooling
    ("enqueue", 1.5),         # the probe fails at enqueue: cooldown 4 s
    ("ok", 5.0),              # a good probe: restored
    ("ok", 0.0),
)


def _series(P):
    reg = P.ops.registry
    gauge = reg.gauge("bccsp_degraded", "").value()
    trans = reg.counter("bccsp_breaker_transitions_total", "")
    keys = [(to, why) for to in ("degraded", "healthy")
            for why in ("enqueue:RuntimeError", "resolve:RuntimeError",
                        "restored")]
    return gauge, {k: trans.value(to=k[0], reason=k[1]) for k in keys}


def run_script(P, monkeypatch, items):
    clock = [1000.0]
    monkeypatch.setattr(P.degrade, "time", types.SimpleNamespace(
        monotonic=lambda: clock[0]))
    sw = P.sw.SoftwareProvider()
    primary = Scripted(sw)
    wrap = P.degrade.DegradingProvider(primary, sw)
    _, s0 = _series(P)
    want = sw.batch_verify(items).tolist()
    trace = []
    for entry, advance in STEPS:
        clock[0] += advance
        calls = primary.calls
        if entry is not None:
            primary.script.append(entry)
        got = wrap.batch_verify(items).tolist()
        assert got == want
        assert primary.script == []
        g, s = _series(P)
        trace.append((entry, wrap.degraded, wrap.backend,
                      primary.calls - calls, g,
                      {k: v - s0[k] for k, v in s.items() if v != s0[k]}))
    # host-side verbs and unknown attributes go to the primary
    assert wrap.stats is primary.stats and wrap.name == "cuda"
    return trace, wrap


def test_failure_script_matches_reference(pk, monkeypatch):
    items = corpus(pk["port"])
    port, wrap = run_script(pk["port"], monkeypatch, items)
    ref, _ = run_script(pk["ref"], monkeypatch, corpus(pk["ref"]))
    assert port == ref
    # every batch but the primary's three good ones went to SW, counted
    assert (wrap.fallback_batches, wrap.fallback_items) == (6,
                                                            6 * len(items))
    states = [(t[0], t[1], t[2], t[3]) for t in port]
    assert states == [
        ("ok", False, "cuda", 1), ("enqueue", False, "cuda", 1),
        ("resolve", True, "sw(degraded)", 1),
        (None, True, "sw(degraded)", 0),
        ("resolve", True, "sw(degraded)", 1),
        (None, True, "sw(degraded)", 0),
        ("enqueue", True, "sw(degraded)", 1),
        ("ok", False, "cuda", 1), ("ok", False, "cuda", 1)]
    assert port[2][4] == 1.0 and port[-1][4] == 0.0
    assert port[-1][5] == {("degraded", "resolve:RuntimeError"): 1.0,
                           ("healthy", "restored"): 1.0}


def test_factory_auto_rule(pk, monkeypatch):
    P = pk["port"]
    F = P.factory
    from fabric_tpu_torch.bccsp.cuda import CudaProvider
    # fail-stop by default: the bare CUDA provider
    p = F.init_factories(F.FactoryOpts(default="CUDA", device="cpu"))
    assert type(p) is CudaProvider and F.get_default() is p
    p = F.init_factories(F.FactoryOpts(default="CUDA", device="cpu",
                                       degrade=True))
    assert isinstance(p, P.degrade.DegradingProvider)
    assert isinstance(p.primary, CudaProvider)
    assert isinstance(p.sw, P.sw.SoftwareProvider)
    assert p.backend == "cuda" and not p.degraded and F.get_default() is p
    assert p.device.type == "cpu" and p.key_tables is p.primary.key_tables
    assert (p.fallback_batches, p.fallback_items) == (0, 0)
    p = F.init_factories(F.FactoryOpts(default="SW"))
    assert type(p) is P.sw.SoftwareProvider
    p = F.init_factories(F.FactoryOpts(default="SW", degrade=True))
    assert isinstance(p, P.degrade.DegradingProvider)
    assert type(p.primary) is P.sw.SoftwareProvider
    # the reference's auto rule (None: on for its device kind) against
    # the port's fail-stop default
    R = pk["ref"].factory
    assert R.FactoryOpts().degrade is None and F.FactoryOpts().degrade is False
    assert type(R.init_factories(R.FactoryOpts(default="SW"))) is \
        pk["ref"].sw.SoftwareProvider


def test_factory_wraps_each_placement_span(pk, monkeypatch):
    from fabric_tpu_torch import device as devmod
    from fabric_tpu_torch.bccsp.cuda import CudaProvider
    from fabric_tpu_torch.parallel import mesh as M
    P = pk["port"]
    F = P.factory
    cpus = [torch.device("cpu")] * 4
    monkeypatch.setattr(devmod, "visible_devices", lambda: list(cpus))
    monkeypatch.setattr(M, "visible_devices", lambda: list(cpus))
    F.init_factories(F.FactoryOpts(placement=True, device="cpu",
                                   degrade=True))
    a = F.provider_for_channel("a", demand=10)
    assert isinstance(a, P.degrade.DegradingProvider)
    assert isinstance(a.primary, CudaProvider) and len(a.mesh) == 4
    assert F.provider_for_channel("a", demand=10) is a      # wrapped once
    F.init_factories(F.FactoryOpts(placement=True, device="cpu"))
    assert type(F.provider_for_channel("a", demand=10)) is CudaProvider
    F.init_factories(F.FactoryOpts(default="SW"))


def test_wrapper_over_cuda_provider_stays_healthy(pk):
    """The CUDA provider (plain kernels on the CPU) under the wrapper:
    one batch, verdicts equal to SW's, the breaker untouched."""
    from fabric_tpu_torch.bccsp.cuda import CudaProvider
    P = pk["port"]
    items = corpus(P, n=9)
    wrap = P.degrade.DegradingProvider(CudaProvider(device="cpu"),
                                       P.sw.SoftwareProvider())
    _, s0 = _series(P)
    got = wrap.batch_verify(items)
    np.testing.assert_array_equal(got, P.sw.SoftwareProvider().batch_verify(
        items))
    assert not wrap.degraded and wrap.backend == "cuda"
    assert wrap.primary.stats["fallbacks"] == 0
    assert wrap.primary.stats["device_sigs"] == 9
    assert (wrap.fallback_batches, wrap.fallback_items) == (0, 0)
    assert _series(P)[1] == s0
