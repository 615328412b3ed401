"""The ops plane of the port (counterpart of `fabric_tpu/ops_plane`):
metrics registry, Prometheus exposition, health checks, span tracing,
structured logs, SLOs, time series, resource telemetry, the sampling
profiler, incident bundles and device/host profile capture.

A process-local metrics registry with counters/gauges/histograms,
Prometheus text-format exposition, pluggable health checkers, and a tiny
ops HTTP server (`/metrics`, `/healthz`, `/logspec`, `/version`).  Every
module is stdlib-only but `profiling` (torch.profiler) and `resources`
(reads `torch.cuda` only when CUDA is already initialised).
"""

from .metrics import Counter, Gauge, Histogram, MetricsRegistry, registry
from .server import OperationsServer
from .tracing import (FlightRecorder, Span, SpanContext, Tracer, tracer,
                      configure as configure_tracing,
                      register_routes as register_trace_routes)
from .logging import jlog
from .slo import (SloEvaluator,
                  register_routes as register_slo_routes)
from .timeseries import (TimeSeriesStore, theil_sen, assess_leak,
                         evaluate_leak_gate,
                         register_routes as register_history_routes)
from .resources import (ResourceCollector, provenance,
                        register_routes as register_resource_routes)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
           "OperationsServer", "FlightRecorder", "Span", "SpanContext",
           "Tracer", "tracer", "configure_tracing", "register_trace_routes",
           "jlog", "SloEvaluator", "register_slo_routes",
           "TimeSeriesStore", "theil_sen", "assess_leak",
           "evaluate_leak_gate", "register_history_routes",
           "ResourceCollector", "provenance", "register_resource_routes"]
