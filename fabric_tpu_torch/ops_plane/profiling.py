"""Profiling surface: device trace and host profile capture.

Counterpart of `fabric_tpu/ops_plane/profiling.py:34-79`.  The reference
captures a `jax.profiler` trace (the XLA/TPU timeline) and a cProfile of
the host over the same kind of window.  Here:

  * device: `torch.profiler` with CPU and CUDA activity, written as one
    Chrome trace (`chrome://tracing`, Perfetto), around a window of time
    or around the work it is given;
  * host: cProfile over the window, returned as pstats text (copied).

In a process with the port's kernels loaded, CUPTI records nothing for
the first 25-47 ms of a `torch.profiler` session (ROADMAP C, "Repaired",
measured on an H100): work launched then is lost from the trace.  So a
CUDA capture first launches a marker kernel for `MARKER_S` in a range of
its own, and fails unless the trace holds that range on the device.

`register_routes` installs both on an `OperationsServer`, as the
reference's does: POST /debug/profile?seconds=N (device) and POST
/debug/pprof?seconds=N (host).
"""

from __future__ import annotations

import cProfile
import io
import os
import pstats
import tempfile
import threading
import time

import torch

from ..device import resolve_device

MARKER_S = 0.5                 # the marker's time at the start of a session
MARKER = "warm-up marker"      # its range's label

_lock = threading.Lock()


def marker_warmup(label: str, device=None) -> None:
    """Inside a running profiler session: launch a marker kernel on
    `device` (default CUDA) for MARKER_S, synchronising after each, in a
    range named `label`, so that CUPTI is recording before the work the
    session is for."""
    from torch.profiler import record_function
    mark = torch.zeros(1, device=resolve_device(device))
    with record_function(label):
        t_end = time.perf_counter() + MARKER_S
        while time.perf_counter() < t_end:
            mark.add_(1)
            torch.cuda.synchronize()
            time.sleep(0.002)


def capture_device_trace(seconds: float, out_dir: str = None,
                         device=None, work=None) -> dict:
    """Capture a `torch.profiler` trace for `seconds` on `device`
    (default CUDA; raises without it; "cpu" records CPU activity only),
    after calling `work()`, if given, inside the window in this thread;
    returns metadata: the trace file, the device events' count and the
    names of the kernels that ran, or {"error": ...} while another
    capture is in progress.

    The trace is written under out_dir (default: a fresh directory in the
    system tmpdir) as `trace.json`.  A CUDA capture starts with the
    marker warm-up (`marker_warmup`) and raises RuntimeError if the
    marker is missing from the device's timeline.  Kernels that other
    threads launch during the window are not reliably among the
    session's events (on an H100: a session started in the thread that
    imported torch missed another thread's kernels, and a first session
    started in another thread logged "External init callback must run in
    same thread as registerClient"), so pass the work to be traced as
    `work`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    out_dir = out_dir or tempfile.mkdtemp(prefix="fabric_tpu_torch_trace_")
    if not _lock.acquire(blocking=False):
        return {"error": "a capture is already in progress"}
    try:
        activities = [ProfilerActivity.CPU]
        if cuda:
            activities.append(ProfilerActivity.CUDA)
        label = "trace:" + MARKER
        with profile(activities=activities) as prof:
            if cuda:
                marker_warmup(label, dev)
            if work is not None:
                work()
                if cuda:
                    torch.cuda.synchronize(dev)
            time.sleep(seconds)
        events = prof.events()
        on_device = [e for e in events if e.device_type == DeviceType.CUDA]
        if cuda and not any(e.name == label for e in on_device):
            raise RuntimeError("capture_device_trace: the marker was not "
                               "recorded: the profiler was not yet "
                               "recording")
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "trace.json")
        prof.export_chrome_trace(path)
    finally:
        _lock.release()
    return {"trace": path, "seconds": seconds, "device": str(dev),
            "device_events": len(on_device),
            "kernels": sorted({e.name for e in on_device
                               if not e.name.startswith("trace:")}),
            "files": [path]}


def capture_host_profile(seconds: float, top: int = 40) -> dict:
    """cProfile the whole process for `seconds`; returns pstats text.

    Captures all Python work in the window (the Go pprof CPU-profile
    shape).  Profiles only Python frames: device time shows as blocking
    calls into torch."""
    if not _lock.acquire(blocking=False):
        return {"error": "a capture is already in progress"}
    prof = cProfile.Profile()
    try:
        prof.enable()
        time.sleep(seconds)
    finally:
        prof.disable()
        _lock.release()
    buf = io.StringIO()
    stats = pstats.Stats(prof, stream=buf)
    stats.sort_stats("cumulative").print_stats(top)
    return {"seconds": seconds, "pstats": buf.getvalue()}


def register_routes(ops, enabled: bool = True, device=None) -> None:
    """Install /debug/profile (device) and /debug/pprof (host) on an
    OperationsServer.  Gated by config like the reference's
    peer.profile.enabled — profiling endpoints stall the serving
    process and must be opt-in.  `device` is the profiled device
    (default CUDA), as for `capture_device_trace`."""
    if not enabled:
        return

    def _seconds(path: str, default: float = 3.0) -> float:
        if "?" in path:
            for kv in path.split("?", 1)[1].split("&"):
                if kv.startswith("seconds="):
                    try:
                        return min(60.0, max(0.1, float(kv[8:])))
                    except ValueError:
                        pass
        return default

    def device_route(path: str, body: bytes):
        return 200, capture_device_trace(_seconds(path), device=device)

    def host(path: str, body: bytes):
        return 200, capture_host_profile(_seconds(path))

    ops.register_route("POST", "/debug/profile", device_route)
    ops.register_route("POST", "/debug/pprof", host)
