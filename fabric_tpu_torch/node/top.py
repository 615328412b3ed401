"""Cluster `top`: a refreshing per-node view of the pipeline economics.

    python -m fabric_tpu_torch.node.top --targets 127.0.0.1:9443,127.0.0.1:9444
    python -m fabric_tpu_torch.node.top --targets ... --interval 2
    python -m fabric_tpu_torch.node.top --targets ... --once      # one frame
    python -m fabric_tpu_torch.node.top --targets ... --sort occ  # order rows
    python -m fabric_tpu_torch.node.top --targets ... --watch-alerts
                                   # stream SLO fired/cleared transitions

Polls each node's ops surface — `/metrics` (Prometheus text),
`/spans/stats`, `/slo`, `/faults`, `/healthz` — and renders one row per
node: ledger height, throughput, validation stage p50/p99, device batch
occupancy, live collect-under-verify overlap, breaker/fault state and
SLO verdicts.  Read-only: the dashboard only issues GETs against the
control-plane HTTP server, so watching a node never perturbs the data
path.  Everything is stdlib (urllib + a small exposition parser); any
endpoint a node doesn't serve degrades to a blank cell, so mixed
topologies (peers + orderers) render fine.

Counterpart of `fabric_tpu/node/top.py`, whole: it reads the series the
port's nodes serve (`provider_lane_slots_total` by `device`, e.g.
`cuda:0`; `validator_device_demotions_total`; ...).
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
import urllib.request
from typing import Dict, List, Optional, Tuple

_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')
_UNESCAPE = {"\\\\": "\\", '\\"': '"', "\\n": "\n"}


def _unescape(v: str) -> str:
    if "\\" not in v:
        return v
    return re.sub(r'\\[\\"n]', lambda m: _UNESCAPE[m.group(0)], v)


def parse_metrics(text: str) -> Dict[str, List[Tuple[dict, float]]]:
    """Prometheus text exposition -> {name: [(labels, value), ...]}."""
    out: Dict[str, List[Tuple[dict, float]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            head, val = line.rsplit(None, 1)
            if "{" in head:
                name, rest = head.split("{", 1)
                labels = {k: _unescape(v) for k, v in
                          _LABEL_RE.findall(rest.rsplit("}", 1)[0])}
            else:
                name, labels = head, {}
            out.setdefault(name, []).append((labels, float(val)))
        except Exception:
            continue
    return out


def _get_json(addr: str, path: str, timeout: float = 2.0):
    with urllib.request.urlopen(f"http://{addr}{path}",
                                timeout=timeout) as r:
        return json.loads(r.read())


def _get_text(addr: str, path: str, timeout: float = 2.0) -> str:
    with urllib.request.urlopen(f"http://{addr}{path}",
                                timeout=timeout) as r:
        return r.read().decode()


def _quantile_ms(buckets: Dict[str, float], q: float) -> Optional[float]:
    """p-quantile (ms) from /spans/stats per-bin bucket counts."""
    bins = []
    for k, c in buckets.items():
        ub = float("inf") if k == "+Inf" else float(k)
        bins.append((ub, c))
    bins.sort()
    n = sum(c for _, c in bins)
    if n == 0:
        return None
    target = q * n
    cum = 0
    last_finite = 0.0
    for ub, c in bins:
        if ub != float("inf"):
            last_finite = ub
        cum += c
        if cum >= target:
            return (ub if ub != float("inf") else last_finite) * 1e3
    return last_finite * 1e3


def _sum(series, label_filter=None) -> float:
    total = 0.0
    for labels, v in series or ():
        if label_filter is None or all(labels.get(k) == val
                                       for k, val in label_filter.items()):
            total += v
    return total


def collect_node(addr: str, timeout: float = 2.0) -> dict:
    """One node's dashboard row (raw values; render() formats)."""
    row: dict = {"addr": addr, "up": False}
    try:
        metrics = parse_metrics(_get_text(addr, "/metrics", timeout))
        row["up"] = True
    except Exception as exc:
        row["error"] = str(exc)[:60]
        return row
    row["height"] = max((v for _, v in metrics.get("ledger_height", ())),
                        default=None)
    row["txs"] = _sum(metrics.get("committed_txs_total"))
    row["blocks"] = _sum(metrics.get("committed_blocks_total"))
    pad = _sum(metrics.get("provider_pad_slots_total"))
    slots = _sum(metrics.get("provider_lane_slots_total"))
    row["occupancy"] = (1.0 - pad / slots) if slots else None
    # per-device occupancy from the device-labeled slot counters (the
    # sharded provider attributes real/pad slots per chip)
    devices: Dict[str, List[float]] = {}
    for labels, v in metrics.get("provider_lane_slots_total", ()) or ():
        d = labels.get("device")
        if d:
            devices.setdefault(d, [0.0, 0.0])[0] += v
    for labels, v in metrics.get("provider_pad_slots_total", ()) or ():
        d = labels.get("device")
        if d:
            devices.setdefault(d, [0.0, 0.0])[1] += v
    row["devices"] = {
        d: (1.0 - p / s) if s else None for d, (s, p) in devices.items()}
    ov = [v for _, v in
          metrics.get("pipeline_collect_under_verify_frac", ())]
    row["overlap"] = (sum(ov) / len(ov)) if ov else None
    # fused device validation: demotions to the host path by reason,
    # policy_width (the k<=8 truth-table cap) called out; the per-
    # channel split lives on GET /state
    dem = metrics.get("validator_device_demotions_total", ()) or ()
    if dem:
        by_reason: Dict[str, float] = {}
        for labels, v in dem:
            r = labels.get("reason", "?")
            by_reason[r] = by_reason.get(r, 0.0) + v
        row["devval_demotions"] = by_reason
        row["devval_policy_width"] = by_reason.get("policy_width", 0.0)
    else:
        row["devval_demotions"] = None
        row["devval_policy_width"] = None
    row["queue_depth"] = _sum(metrics.get("provider_dispatch_queue_depth"))
    row["breakers_open"] = _sum(metrics.get("gateway_orderer_breaker_open"))
    row["faults_fired"] = _sum(metrics.get("fault_injected_total"))
    # admission plane: current shed state + lifetime shed count
    row["shed_total"] = _sum(metrics.get("gateway_shed_total"))
    adm = [v for _, v in metrics.get("gateway_admission_state", ()) or ()]
    row["admission_state"] = max(adm) if adm else None
    # byzantine plane: quarantined identities by reason + scored offenses
    byz_series = metrics.get("byzantine_quarantines_total")
    row["byz_quarantines"] = (_sum(byz_series)
                              if byz_series is not None else None)
    row["byz_reasons"] = sorted(
        {labels.get("reason", "?") for labels, v in byz_series or ()
         if v})
    row["byz_offenses"] = _sum(metrics.get("byzantine_offenses_total"))
    # pardon plane (r18): lifetime pardons + the live decaying standing
    # score, read from /byzantine (the counters alone can't show decay —
    # a counter never goes down, but standing scores do)
    try:
        byz = _get_json(addr, "/byzantine", timeout)
        row["byz_pardons"] = byz.get("pardons")
        row["byz_score"] = sum(
            int(ent.get("score", 0) or 0)
            for ent in (byz.get("identities") or {}).values())
    except Exception:
        row["byz_pardons"] = None
        row["byz_score"] = None
    # verify-once plane: cache hit rate over all lookups, and the
    # rolling fraction of committed verify items whose verdicts were
    # speculatively cached before the block arrived
    vh = _sum(metrics.get("verify_cache_hits_total"))
    vm = _sum(metrics.get("verify_cache_misses_total"))
    row["vcache"] = vh / (vh + vm) if (vh + vm) else None
    spec = [v for _, v in metrics.get("speculative_coverage_frac", ())]
    row["spec"] = (sum(spec) / len(spec)) if spec else None
    # state plane: shard count + total keys from the per-shard gauge,
    # last crash-consistent checkpoint height from the checkpoint gauge
    shard_series = metrics.get("state_shard_keys", ()) or ()
    shards = {labels.get("shard") for labels, _ in shard_series}
    row["state_shards"] = len(shards) or None
    row["state_keys"] = (_sum(metrics.get("state_shard_keys"))
                         if shard_series else None)
    ck = [v for _, v in metrics.get("state_checkpoint_height", ()) or ()]
    row["ckpt_height"] = max(ck) if ck else None
    # resource telemetry (ops_plane/resources.py): present only on
    # nodes with the `resources` sub-dict enabled; blank cell otherwise
    rss = [v for _, v in metrics.get("process_resident_memory_bytes",
                                     ()) or ()]
    row["rss"] = max(rss) if rss else None
    fds = [v for _, v in metrics.get("process_open_fds", ()) or ()]
    row["fds"] = max(fds) if fds else None

    try:
        doc = _get_json(addr, "/spans/stats", timeout)
        stats = doc.get("spans", {})    # {enabled, sample_rate, spans}
    except Exception:
        stats = {}
    for col, span in (("collect", "validator.collect"),
                      ("dispatch", "validator.dispatch_wait"),
                      ("gate", "validator.gate"),
                      ("commit", "committer.store_block")):
        st = stats.get(span)
        row[col] = ((_quantile_ms(st["buckets"], 0.5),
                     _quantile_ms(st["buckets"], 0.99))
                    if st and st.get("buckets") else None)

    try:
        slo = _get_json(addr, "/slo", timeout)
        objs = slo.get("objectives", [])
        row["slo_total"] = len(objs)
        row["slo_alerting"] = sorted(
            o["name"] for o in objs if o.get("state") == "alerting")
    except Exception:
        row["slo_total"] = None
        row["slo_alerting"] = []

    try:
        f = _get_json(addr, "/faults", timeout)
        row["fault_plan"] = f.get("name") if f.get("active") else None
    except Exception:
        row["fault_plan"] = None
    # incident capture (r19): bundle count + last bundle's objective;
    # blank on nodes running with `incidents` disabled
    try:
        inc = _get_json(addr, "/incidents", timeout)
        row["inc_count"] = inc.get("count")
        incidents = inc.get("incidents") or []
        last = incidents[-1] if incidents else {}
        row["inc_last"] = last.get("objective")
        row["inc_partial"] = bool(last.get("partial"))
    except Exception:
        row["inc_count"] = None
        row["inc_last"] = None
        row["inc_partial"] = False
    try:
        hz = _get_json(addr, "/healthz", timeout)
    except Exception as exc:
        # /healthz answers 503 with a JSON body while degraded
        body = getattr(exc, "read", lambda: b"")()
        try:
            hz = json.loads(body)
        except Exception:
            hz = {}
    row["health"] = hz.get("status", "?")
    # fleet lifecycle (r18): serving / draining / drained, surfaced on
    # /healthz by nodes that expose drain() — blank on older nodes
    row["lifecycle"] = hz.get("lifecycle")
    return row


def _fmt_pair(p) -> str:
    if not p or p[0] is None:
        return "-"
    return f"{p[0]:.0f}/{p[1]:.0f}"


def _fmt_pct(v) -> str:
    return "-" if v is None else f"{v * 100:.0f}%"


def _rate(row: dict, prev: dict) -> Optional[float]:
    if not prev or row.get("txs") is None or prev.get("txs") is None:
        return None
    dt = row["_t"] - prev["_t"]
    return (row["txs"] - prev["txs"]) / dt if dt > 0 else None


def _fmt_devices(devs) -> str:
    """Compact per-device occupancy: `8×91-97%` (count × min-max), or
    `-` when the node has no device-labeled slot series yet."""
    vals = sorted(v for v in (devs or {}).values() if v is not None)
    if not vals:
        return "-"
    lo, hi = vals[0] * 100, vals[-1] * 100
    if round(lo) == round(hi):
        return f"{len(vals)}×{hi:.0f}%"
    return f"{len(vals)}×{lo:.0f}-{hi:.0f}%"


_COLS = ("NODE", "HT", "TX/S", "COLLECT", "DISP", "GATE", "COMMIT",
         "OCC", "DEV", "DEVVAL", "OVLP", "VCACHE", "SPEC", "STATE",
         "RES", "QD", "BRKR", "SHED", "FAULTS", "BYZ", "LIFE", "INC",
         "SLO", "HEALTH")
_WIDTHS = (21, 6, 8, 9, 9, 9, 9, 5, 10, 9, 5, 6, 5, 11, 9, 4, 5, 9, 7,
           12, 8, 10, 12, 8)

# gateway_admission_state gauge value -> short cell tag
_ADM_SHORT = {0: "ok", 1: "EVAL", 2: "PROB", 3: "HARD"}


def _fmt_shed(row: dict) -> str:
    """`<state>/<shed count>`: `ok/0` while admitting, `PROB/1234` mid-
    shed; `-` when the node runs no gateway (orderers)."""
    st = row.get("admission_state")
    shed = row.get("shed_total") or 0.0
    if st is None and not shed:
        return "-"
    name = _ADM_SHORT.get(int(st or 0), "?")
    return f"{name}/{shed:.0f}"


def _fmt_byz(row: dict) -> str:
    """`<quarantined>[reason,..]/<offense score>~<standing>+<pardons>p`:
    `0` is the healthy steady state (the byzantine plane is live and has
    convicted nobody); `~N` is the LIVE decaying standing score summed
    over known identities (offense counters only ever rise — the `~`
    tail is what actually shrinks as clean windows elapse); `+Np` counts
    pardons granted (offense quarantines restored after a clean window);
    `-` means the node exports no byzantine series (plane disabled)."""
    q = row.get("byz_quarantines")
    if q is None:
        return "-"
    cell = f"{q:.0f}"
    reasons = row.get("byz_reasons") or []
    if reasons:
        cell += "[" + ",".join(r[:5] for r in reasons) + "]"
    off = row.get("byz_offenses") or 0.0
    if off:
        cell += f"/{off:.0f}"
    score = row.get("byz_score")
    if score:
        cell += f"~{score:.0f}"
    pardons = row.get("byz_pardons")
    if pardons:
        cell += f"+{pardons:.0f}p"
    return cell


def _fmt_inc(row: dict) -> str:
    """`<bundles>[last objective]` with a `!` suffix when the newest
    bundle is partial (a peer was unreachable during fan-out); `-` on
    nodes without the incident recorder, `0` when armed but quiet."""
    n = row.get("inc_count")
    if n is None:
        return "-"
    cell = f"{n:.0f}"
    last = row.get("inc_last")
    if last:
        cell += f"[{str(last)[:6]}]"
    if row.get("inc_partial"):
        cell += "!"
    return cell


def _fmt_life(row: dict) -> str:
    """Fleet lifecycle cell: serving / draining / drained (from
    /healthz); `-` on nodes without a drain-capable ops plane."""
    lc = row.get("lifecycle")
    if not lc:
        return "-"
    return str(lc)


def _fmt_state(row: dict) -> str:
    """`<shards>sh/<keys>@<ckpt height>`: sharded-state keyspace size +
    last durable checkpoint height; `-` before any shard gauge lands."""
    n = row.get("state_shards")
    if not n:
        return "-"
    keys = row.get("state_keys") or 0.0
    k = f"{keys / 1000.0:.0f}k" if keys >= 1000 else f"{keys:.0f}"
    ck = row.get("ckpt_height")
    return f"{n}sh/{k}" + ("" if ck is None else f"@{ck:.0f}")


def _fmt_devval(row: dict) -> str:
    """`<demotions>[pw:N]`: fused-device-validation demotions to the
    host path, with the policy_width share (blocks demoted by the k<=8
    truth-table cap — the cap's real-world demotion rate) called out;
    `-` until the plane demotes (or on nodes running host MVCC only)."""
    dem = row.get("devval_demotions")
    if dem is None:
        return "-"
    cell = f"{sum(dem.values()):.0f}"
    pw = dem.get("policy_width", 0.0)
    if pw:
        cell += f"[pw:{pw:.0f}]"
    return cell


def _fmt_res(row: dict) -> str:
    """`<RSS MB>M/<fd count>`: the resource collector's footprint cell;
    `-` on nodes that run with `resources` disabled."""
    rss, fds = row.get("rss"), row.get("fds")
    if rss is None and fds is None:
        return "-"
    cell = "?" if rss is None else f"{rss / 1048576.0:.0f}M"
    return cell + ("" if fds is None else f"/{fds:.0f}")


_SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


def _sparkline(values, width: int = 16) -> str:
    """Unicode sparkline over the last `width` points, scaled to the
    window's own min/max (shape, not absolute level)."""
    vals = [float(v) for v in values if v is not None][-width:]
    if not vals:
        return "-"
    lo, hi = min(vals), max(vals)
    if hi - lo < 1e-12:
        return _SPARK_BLOCKS[0] * len(vals)
    top = len(_SPARK_BLOCKS) - 1
    return "".join(_SPARK_BLOCKS[round((v - lo) / (hi - lo) * top)]
                   for v in vals)


def collect_spark(addr: str, name: str, window_s: float = 120.0,
                  timeout: float = 2.0) -> Optional[List[float]]:
    """One node's history points for a series (`/metrics/history`);
    None when the node has no store or series (cell renders `-`)."""
    try:
        doc = _get_json(
            addr, f"/metrics/history?name={name}&window={window_s}",
            timeout)
    except Exception:
        return None
    return [p[1] for p in doc.get("points", ())]

# --sort column -> row key; None values sort last, numeric descending
# (the interesting rows — hottest, furthest ahead, most alerting — rise)
_SORT_KEYS = {
    "node": "addr", "ht": "height", "tx/s": "rate", "occ": "occupancy",
    "ovlp": "overlap", "qd": "queue_depth", "brkr": "breakers_open",
    "faults": "faults_fired", "slo": "slo_alerting", "height": "height",
    "rate": "rate", "occupancy": "occupancy", "dev": "devices",
    "vcache": "vcache", "spec": "spec", "shed": "shed_total",
    "state": "state_keys", "byz": "byz_quarantines", "res": "rss",
    "life": "lifecycle", "devval": "devval_policy_width",
    "inc": "inc_count",
}


def sort_rows(rows: List[dict], column: str) -> List[dict]:
    key = _SORT_KEYS.get(column.lower())
    if key is None:
        raise SystemExit(f"--sort: unknown column {column!r} "
                         f"(one of {', '.join(sorted(_SORT_KEYS))})")
    if key == "addr":
        return sorted(rows, key=lambda r: r["addr"])

    def rank(r):
        v = r.get(key)
        if key == "slo_alerting":
            v = len(v) if v is not None else None
        elif key == "devices":
            vals = [x for x in (v or {}).values() if x is not None]
            v = min(vals) if vals else None
        elif key == "lifecycle":
            # nodes leaving the fleet rise to the top
            v = {"drained": 2.0, "draining": 1.0, "serving": 0.0}.get(v)
        if not isinstance(v, (int, float)):
            return (1, 0.0)
        return (0, -float(v))
    return sorted(rows, key=rank)


def render(rows: List[dict], spark_name: Optional[str] = None) -> str:
    """Fixed-width table; stage cells are `p50/p99` in ms.  With
    `spark_name` an extra trailing column renders each node's history
    sparkline for that series (rows carry it as r["spark"])."""
    cols, widths = _COLS, _WIDTHS
    if spark_name:
        cols = cols + (spark_name[:18].upper(),)
        widths = widths + (18,)
    lines = ["  ".join(c.ljust(w) for c, w in zip(cols, widths))]
    for r in rows:
        if not r.get("up"):
            lines.append(f"{r['addr']:<21}  DOWN  {r.get('error', '')}")
            continue
        alerting = r.get("slo_alerting") or []
        if r.get("slo_total") is None:
            slo = "-"
        elif alerting:
            slo = "ALERT:" + ",".join(alerting)
        else:
            slo = f"ok({r['slo_total']})"
        faults = f"{r['faults_fired']:.0f}"
        if r.get("fault_plan"):
            faults += f"[{r['fault_plan']}]"
        cells = (
            r["addr"],
            "-" if r["height"] is None else f"{r['height']:.0f}",
            "-" if r.get("rate") is None else f"{r['rate']:.1f}",
            _fmt_pair(r.get("collect")), _fmt_pair(r.get("dispatch")),
            _fmt_pair(r.get("gate")), _fmt_pair(r.get("commit")),
            _fmt_pct(r.get("occupancy")), _fmt_devices(r.get("devices")),
            _fmt_devval(r),
            _fmt_pct(r.get("overlap")),
            _fmt_pct(r.get("vcache")), _fmt_pct(r.get("spec")),
            _fmt_state(r), _fmt_res(r),
            f"{r.get('queue_depth', 0):.0f}",
            f"{r.get('breakers_open', 0):.0f}",
            _fmt_shed(r),
            faults, _fmt_byz(r), _fmt_life(r), _fmt_inc(r), slo,
            str(r.get("health", "?")))
        if spark_name:
            cells = cells + (r.get("spark") or "-",)
        lines.append("  ".join(str(c).ljust(w)
                               for c, w in zip(cells, widths)))
    return "\n".join(lines)


def watch_alerts(targets: List[str], timeout: float, interval: float,
                 once: bool = False) -> int:
    """Stream SLO alert transitions: one timestamped line per
    (node, objective) fired/cleared edge instead of a refreshing table —
    tail-able, grep-able, and safe to pipe into an incident log."""
    active: Dict[Tuple[str, str], bool] = {}
    first = True
    while True:
        now = time.strftime("%H:%M:%S")
        for t in targets:
            try:
                objs = _get_json(t, "/slo", timeout).get("objectives", [])
            except Exception as exc:
                key = (t, "__reach__")
                if not active.get(key):
                    print(f"{now}  {t}  UNREACHABLE  {str(exc)[:60]}")
                    active[key] = True
                continue
            if active.pop((t, "__reach__"), None):
                print(f"{now}  {t}  REACHABLE")
            for o in objs:
                key = (t, o.get("name", "?"))
                alerting = o.get("state") == "alerting"
                was = active.get(key, False)
                if alerting and not was:
                    print(f"{now}  {t}  FIRED    {key[1]}  "
                          f"burn={o.get('burn_rate', '?')}")
                elif was and not alerting:
                    print(f"{now}  {t}  CLEARED  {key[1]}")
                elif alerting and first and once:
                    pass
                active[key] = alerting
        if first:
            live = sorted(k for k, v in active.items()
                          if v and k[1] != "__reach__")
            if not live:
                print(f"{now}  no active alerts on {len(targets)} node(s)")
            first = False
        if once:
            return 0
        sys.stdout.flush()
        time.sleep(interval)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fabric_tpu_torch.node.top",
        description="cluster dashboard over the ops plane")
    ap.add_argument("--targets", required=True,
                    help="comma-separated host:port ops addresses")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh interval in seconds")
    ap.add_argument("--once", action="store_true",
                    help="render a single frame and exit")
    ap.add_argument("--sort", metavar="COLUMN",
                    help="order rows by a column (e.g. occ, tx/s, qd, "
                         "slo); numeric descending, missing values last")
    ap.add_argument("--watch-alerts", action="store_true",
                    help="stream SLO fired/cleared transition lines "
                         "instead of the table")
    ap.add_argument("--spark", metavar="NAME",
                    help="extra column: unicode sparkline of this "
                         "series from each node's /metrics/history "
                         "(e.g. process_resident_memory_bytes)")
    ap.add_argument("--spark-window", type=float, default=120.0,
                    help="history window (s) behind --spark")
    ap.add_argument("--timeout", type=float, default=2.0)
    args = ap.parse_args(argv)
    targets = [t.strip() for t in args.targets.split(",") if t.strip()]
    if args.sort:
        sort_rows([], args.sort)        # validate the column name up front
    try:
        if args.watch_alerts:
            return watch_alerts(targets, args.timeout, args.interval,
                                once=args.once)
        prev: Dict[str, dict] = {}
        while True:
            rows = []
            for t in targets:
                row = collect_node(t, args.timeout)
                row["_t"] = time.monotonic()
                row["rate"] = _rate(row, prev.get(t, {}))
                if args.spark and row.get("up"):
                    row["spark"] = _sparkline(
                        collect_spark(t, args.spark, args.spark_window,
                                      args.timeout) or ())
                prev[t] = row
                rows.append(row)
            if args.sort:
                rows = sort_rows(rows, args.sort)
            frame = (time.strftime("%H:%M:%S")
                     + f"  fabric-tpu top — {len(targets)} node(s)\n"
                     + render(rows, spark_name=args.spark))
            if args.once:
                print(frame)
                return 0
            sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
