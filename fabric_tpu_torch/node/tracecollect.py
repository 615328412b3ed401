"""Cross-node trace assembly: one Chrome trace spanning the cluster.

A transaction's spans are scattered: the gateway peer records the
request trace, the orderer records its `orderer.deliver` children, the
committing peers record block traces linked from the request's
`commit_wait` span.  Each node's `GET /traces/<id>` only exports what
its own flight recorder holds — this module fans out to every
configured ops endpoint, follows links TRANSITIVELY across nodes (node
A's spans can link a trace that only node B recorded), and merges the
results into one Perfetto-loadable export:

  * every node renders as its own process row (`pid` + process_name
    metadata), its threads as lanes under it;
  * span timestamps are already wall-anchored microseconds
    (`tracing._WALL_ANCHOR`), so cross-process ordering is as honest
    as the hosts' clocks — fine on one box, NTP-bounded across boxes;
  * the closure is bounded by `max_traces`, and like export_chrome the
    cut is never silent (`truncated: true` + the same counter).

Wired as `GET /traces/<id>?cluster=1` on peers and orderers via
`tracing.register_routes(..., cluster_fn=...)`; the peer list comes
from the node's `cluster_trace` config sub-dict
(`{"peers": ["127.0.0.1:9443", ...]}`) and may include the node's own
endpoint (self-fetches are served locally, not over HTTP).

Counterpart of `fabric_tpu/node/tracecollect.py`, the same code on the
port's imports.
"""

from __future__ import annotations

import json
import logging
import urllib.request
from typing import Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger("fabric_tpu_torch.node.tracecollect")

__all__ = ["collect_cluster_trace", "fetch_export"]

# per-node tid namespace: node i's thread k renders as i*_TID_STRIDE+k
_TID_STRIDE = 1000


def fetch_export(endpoint: str, trace_id: str,
                 timeout_s: float = 2.0) -> Optional[dict]:
    """One node's single-trace export (`follow=0` — the cluster walk
    follows links itself); None on any transport/HTTP failure (a dead
    peer must not sink the whole assembly)."""
    url = f"http://{endpoint}/traces/{trace_id}?follow=0"
    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as r:
            return json.loads(r.read())
    except Exception:
        return None


def collect_cluster_trace(trace_id: str, endpoints: Sequence[str],
                          local_tracer=None, local_name: str = "local",
                          timeout_s: float = 2.0,
                          max_traces: int = 16) -> Optional[dict]:
    """Fan out, merge, follow links transitively; one Chrome export.

    `endpoints` are "host:port" ops addresses (peers AND orderers);
    `local_tracer` serves this node's own spans in-process so the list
    may freely include — or omit — the node itself.  Returns None only
    when NO node knows the root trace id.
    """
    from fabric_tpu_torch.ops_plane.metrics import registry as _metrics_registry

    nodes: List[Tuple[str, object]] = []
    if local_tracer is not None:
        nodes.append((local_name,
                      lambda tid: local_tracer.export_chrome(
                          tid, follow_links=False)))
    for ep in endpoints:
        ep = str(ep)
        nodes.append((ep, lambda tid, _ep=ep: fetch_export(
            _ep, tid, timeout_s=timeout_s)))

    events: List[dict] = []
    seen_spans: set = set()
    node_spans: Dict[str, int] = {}
    pids: Dict[str, int] = {}
    fetched: set = set()
    pending: List[str] = [str(trace_id)]
    found_traces: set = set()
    truncated = False

    while pending:
        if len(fetched) >= max_traces:
            truncated = True
            break
        tid = pending.pop(0)
        fetched.add(tid)
        for name, fetch in nodes:
            exp = fetch(tid)
            if not exp:
                continue
            pid = pids.setdefault(name, len(pids) + 1)
            for ev in exp.get("traceEvents", ()):
                args = ev.get("args") or {}
                if ev.get("ph") == "M":
                    continue        # per-node thread names re-emitted below
                key = (name, args.get("trace_id"), args.get("span_id"))
                if args.get("span_id") is not None and key in seen_spans:
                    continue
                seen_spans.add(key)
                found_traces.add(args.get("trace_id") or tid)
                merged = dict(ev)
                merged["pid"] = pid
                merged["tid"] = (pid * _TID_STRIDE
                                 + int(ev.get("tid", 0)))
                merged.setdefault("args", {})
                merged["args"] = dict(args, node=name)
                events.append(merged)
                node_spans[name] = node_spans.get(name, 0) + 1
                for linked in args.get("links", ()) or ():
                    if linked not in fetched and linked not in pending:
                        pending.append(linked)
            # thread lanes, namespaced per node
            for ev in exp.get("traceEvents", ()):
                if ev.get("ph") == "M" and ev.get("name") == "thread_name":
                    events.append({
                        "name": "thread_name", "ph": "M", "pid": pid,
                        "tid": pid * _TID_STRIDE + int(ev.get("tid", 0)),
                        "args": dict(ev.get("args") or {})})
    if pending:
        truncated = True
    if truncated:
        _metrics_registry.counter(
            "tracing_export_links_truncated_total",
            "export_chrome link closures cut at max_traces").add()

    if not node_spans:
        return None
    # one process row per node; dedupe the metadata events
    meta_seen: set = set()
    deduped: List[dict] = []
    for ev in events:
        if ev.get("ph") == "M":
            key = (ev["pid"], ev.get("tid"), ev["name"],
                   tuple(sorted((ev.get("args") or {}).items())))
            if key in meta_seen:
                continue
            meta_seen.add(key)
        deduped.append(ev)
    for name, pid in pids.items():
        if name in node_spans:
            deduped.append({"name": "process_name", "ph": "M",
                            "pid": pid, "args": {"name": name}})
    deduped.sort(key=lambda e: (e.get("ph") != "M", e.get("ts", 0)))
    return {
        "traceEvents": deduped,
        "displayTimeUnit": "ms",
        "otherData": {
            "trace_id": str(trace_id),
            "cluster": True,
            "nodes": node_spans,
            "n_nodes": len(node_spans),
            "n_traces_merged": len(found_traces),
            "truncated": truncated,
        },
    }
