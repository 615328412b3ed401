"""Structured one-line JSON logging, correlated with traces.

`jlog(log, "gateway.broadcast_failed", level=logging.ERROR, txid=...,
channel=...)` emits a single-line JSON record carrying the event name,
wall time, the ambient trace_id (when a span is active on the calling
thread) and any keyword fields.  One line per event keeps the records
grep-able and ingestible without a log-parsing stack, and the trace_id
field makes a failure log line jump straight to its flight-recorder
trace (`GET /traces/<trace_id>`).
"""

from __future__ import annotations

import json
import logging
import time
from typing import Optional

from . import tracing


def jlog(log: logging.Logger, event: str, *, level: int = logging.INFO,
         exc: Optional[BaseException] = None, **fields) -> None:
    """Emit one structured JSON log line; never raises."""
    try:
        rec = {"event": event, "ts": round(time.time(), 6)}
        trace_id = tracing.tracer.current_trace_id()
        if trace_id:
            rec["trace_id"] = trace_id
        if exc is not None:
            rec["error"] = repr(exc)
        for k, v in fields.items():
            if v is not None:
                rec[k] = v
        log.log(level, json.dumps(rec, default=str, sort_keys=True))
    except Exception:
        pass
