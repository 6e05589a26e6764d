"""Observability: tracing spans and metrics (pure stdlib, no torch).

* :mod:`repro_torch.obs.trace` — span/instant/flow events in per-thread
  ring buffers, exportable as Chrome/Perfetto ``trace_event`` JSON
  (:mod:`repro_torch.obs.export`).  Disabled by default.
* :mod:`repro_torch.obs.metrics` — counters, gauges and latency
  histograms in a :class:`MetricsRegistry`.
* :mod:`repro_torch.obs.profile` — per-plan cost reports (modeled stream
  bytes and time, a measured matvec's roofline share) and a
  ``torch.profiler`` trace wrapper; it imports torch only inside its
  functions, and is not imported here.
"""
from repro_torch.obs.trace import (                         # noqa: F401
    TRACER, Tracer, enable, disable, is_enabled, clear,
    span, instant, event, flow_start, flow_step, flow_end,
    capture_context, attach_context)
from repro_torch.obs.metrics import (                       # noqa: F401
    REGISTRY, MetricsRegistry, Counter, Gauge, Histogram,
    prometheus_text, DEFAULT_LATENCY_BUCKETS)
from repro_torch.obs.export import (                        # noqa: F401
    export_chrome_trace, write_chrome_trace, validate_chrome_trace)
