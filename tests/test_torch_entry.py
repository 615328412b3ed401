"""The port's driver entry (fabric_tpu_torch.entry), warmup
(node/warmup.py) and profiling surface (ops_plane/profiling.py) on the
CPU.

- entry(): KP2's wrapper (its plain version here) on the reference
  entry()'s words and on its own, against the reference's verdicts on
  the same words (__graft_entry__.entry, eager JAX).
- dryrun_multichip(8, device="cpu"): every check of the reference's dry
  run on eight CPU shards, the window probe included, at small sizes
  (each shard's plain call takes seconds here, so `_sizes` is patched):
  one item a lane (seven empty shards), two blocks of three signatures
  in the window (the sixth is the corrupted one).
- warmup on the CPU at a tiny bucket: every lane once, no kernel built,
  and it says so; the C extensions are built or found.
- capture_host_profile, and capture_device_trace on the CPU, where it
  records CPU activity only; without CUDA the default device raises.
"""
import json

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)

import __graft_entry__ as ref_entry
from fabric_tpu_torch import entry as E
from fabric_tpu_torch.node import warmup as W
from fabric_tpu_torch.ops import _build
from fabric_tpu_torch.ops_plane import profiling as P
from fabric_tpu_torch.parallel import mesh as M


def test_entry_matches_reference_entry():
    fn, args = E.entry(device="cpu")
    assert len(args) == 5 and all(tuple(a.shape) == (8, 128) for a in args)
    assert all(a.dtype == torch.uint32 for a in args)
    jfn, jargs = ref_entry.entry()
    # one batch: the reference's 128 words, then the port's, with two
    # corrupted columns
    words = [np.concatenate([np.asarray(j), a.numpy()], 1)
             for j, a in zip(jargs, args)]
    words[4][:, 3] ^= 1
    words[2][:, 200] ^= 4
    got = fn(*[torch.from_numpy(np.ascontiguousarray(w))
               for w in words]).numpy()
    want = np.asarray(jfn(*words))
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 254 and not got[3] and not got[200]


def test_entry_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        E.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        E.dryrun_multichip(2)


def test_dryrun_multichip_on_eight_cpu_shards(capsys, monkeypatch):
    made = []
    make = M.make_mesh

    def spy(devices=None):
        made.append(devices)
        return make(devices)

    monkeypatch.setattr(M, "make_mesh", spy)
    assert E._sizes(8) == (16, 64, E.WINDOW_BLOCKS, E.WINDOW_SIGS)
    monkeypatch.setattr(E, "_sizes", lambda n: (1, 1, 2, 3))
    rec = E.dryrun_multichip(8, device="cpu")
    assert made[0] == [torch.device("cpu")] * 8
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert json.loads(line[-1]) == {"multichip_window": rec}
    assert rec["shards"] == 8 and rec["shards_per_device"] == {"cpu": 8}
    assert rec["card"] is None and "sharded_sigs_per_sec" not in rec
    blocks, expect = E._window_blocks(2, 3)
    assert not expect.all()                 # the corruption pattern shows


def test_warmup_on_cpu_builds_no_kernel(tmp_path, monkeypatch):
    def no_nvcc(*a, **k):
        raise AssertionError("warmup started nvcc on the CPU")

    monkeypatch.setattr(_build, "_start", no_nvcc)
    monkeypatch.setattr(_build, "load", no_nvcc)
    man = W.warmup([2], device="cpu", verbose=False, manifest_dir=tmp_path)
    assert json.loads((tmp_path / W.MANIFEST).read_text()) == man
    assert man["device"] == "cpu"
    assert man["kernels"].startswith("none built")
    assert set(man["builds_s"]) == {"der", "_ftlv", "_fastparse",
                                    "_fastcollect"}
    assert set(man["lanes_s"]) == {"p256@2", "p256-rows@2", "ed25519@2",
                                   "ed25519-rows@2", "idemix-pair@2"}


def test_warmup_lanes_take_their_kernels(monkeypatch):
    """Each warm lane reaches the wrapper it is for (stubbed here, each
    answering True), through the factory's provider."""
    from fabric_tpu_torch.bccsp.cuda import CudaProvider
    from fabric_tpu_torch.ops import bn254, ed25519, p256, p256_fixed
    seen = []

    def stub(name):
        def fn(*args, **kwargs):
            seen.append(name)
            return torch.ones(args[0].shape[-1], dtype=torch.bool)
        return fn

    for mod, name in ((p256, "p256_verify"), (p256_fixed, "p256_verify_rows"),
                      (ed25519, "ed25519_verify"),
                      (ed25519, "ed25519_verify_rows")):
        monkeypatch.setattr(mod, name, stub(name))
    monkeypatch.setattr(bn254, "bn254_pairing_check",
                        lambda *a: torch.ones(a[3].shape[1], dtype=bool))
    timings = W.warm_lanes(CudaProvider(device="cpu"), [3], W.SCHEMES)
    assert seen == ["p256_verify", "p256_verify_rows", "ed25519_verify",
                    "ed25519_verify_rows"]
    assert list(timings) == ["p256@3", "p256-rows@3", "ed25519@3",
                             "ed25519-rows@3", "idemix-pair@3"]


def test_gen_sigs_are_valid_and_seeded():
    from fabric_tpu_torch.bccsp.sw import SoftwareProvider
    a = W.gen_p256_sigs(6, 3, seed=1)
    # the keys and digests come from the seed (ECDSA's nonce may not)
    assert [(it.pubkey, it.payload) for it in a] == [
        (it.pubkey, it.payload) for it in W.gen_p256_sigs(6, 3, seed=1)]
    assert len({it.pubkey for it in a}) == 3
    e = W.gen_ed25519_sigs(5, 2)
    assert SoftwareProvider().batch_verify(a + e).all()


def test_capture_host_profile():
    out = P.capture_host_profile(0.05, top=5)
    assert out["seconds"] == 0.05 and "function calls" in out["pstats"]


def test_capture_device_trace_on_cpu(tmp_path):
    calls = []
    out = P.capture_device_trace(0.05, str(tmp_path), device="cpu",
                                 work=lambda: calls.append(
                                     torch.ones(3).sum()))
    assert len(calls) == 1
    assert out["device"] == "cpu" and out["device_events"] == 0
    assert out["kernels"] == [] and out["trace"].startswith(str(tmp_path))
    trace = json.loads(open(out["trace"]).read())
    assert "traceEvents" in trace


def test_capture_device_trace_default_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.capture_device_trace(0.01)


def test_one_capture_at_a_time():
    assert P._lock.acquire(blocking=False)
    try:
        assert "error" in P.capture_host_profile(0.01)
        assert "error" in P.capture_device_trace(0.01, device="cpu")
    finally:
        P._lock.release()
