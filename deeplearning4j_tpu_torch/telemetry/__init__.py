"""Telemetry core of the port (counterpart of deeplearning4j_tpu/telemetry):
metric names, label names, span names and env gates are the JAX package's,
letter for letter, so one dashboard and one set of SLO rules read both.

  context    TraceContext — one trace_id per request, propagated through
             contextvars, with an explicit attach/detach (``activate``)
             for thread handoffs; the Tracer stamps the active ids onto
             every span and instant.
  metrics    MetricsRegistry — process-global counters, gauges and
             histograms with labels, rendered as Prometheus text
             (``render_prometheus``); pure stdlib.
  trace      Tracer — spans over a bounded ring buffer
             (``DL4J_TPU_TELEMETRY_BUFFER``), exported as Chrome trace
             JSON; ``traced`` decorates a function.
  slo        SLO burn-rate engine — fast and slow window burn rates over
             the registry; an episode writes one flight bundle with the
             offending trace ids. The Router's canary gate.
  flight     the flight recorder — atomic postmortem bundles under
             ``DL4J_TPU_FLIGHT_DIR`` (rotated by ``DL4J_TPU_FLIGHT_KEEP``)
             that either package's ``load_bundle`` reads.
  export     telemetry frames — sequence-numbered cumulative metrics and
             trace deltas, the unit the collector merges.
  aggregate  FleetCollector — exactly-once merge of frames from many
             sources (drop, duplicate and late counted), spool
             directories, the merged Chrome trace and a federated SLO
             engine; the Autoscaler registers its replicas here.
  health     HealthMonitor — the stall watchdog every fit heartbeats
             (``fit_health``), straggler skew, the prefetch queue's
             accounting and ``input_verdict()``; ``healthz()`` is the
             ``/healthz`` payload (ui/server.py).

Spans, instants, SLO engines, collectors and bundles are gated by
``DL4J_TPU_TELEMETRY``: with the gate off, ``tracer().span()`` is a shared
no-op singleton and nothing is allocated per call. Metrics at cold
resilience sites (retries, breaker transitions, chaos injections,
membership transitions) are always live.

The endpoints are ui/server.py's UIServer and the CLI is cli.py. Not
ported yet (ROADMAP A.11): introspection and the profiler (item 3), the
tuner with its knob registry (item 4).
"""
from deeplearning4j_tpu_torch.telemetry.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    counter,
    gauge,
    histogram,
    registry,
    render_prometheus,
)
from deeplearning4j_tpu_torch.telemetry.trace import (  # noqa: F401
    TELEMETRY_GATE,
    NULL_SPAN,
    SpanRecord,
    Tracer,
    configure,
    traced,
    tracer,
)
from deeplearning4j_tpu_torch.telemetry.context import (  # noqa: F401
    TraceContext,
    activate,
    attach,
    current,
    current_trace_id,
    detach,
    new_trace,
)
from deeplearning4j_tpu_torch.telemetry.slo import (  # noqa: F401
    Selector,
    SloEngine,
    SloRule,
    default_rules,
    tenant_rules,
    version_rules,
)
from deeplearning4j_tpu_torch.telemetry.health import (  # noqa: F401
    HealthMonitor,
    fit_health,
    healthz,
    input_verdict,
    observe_membership_transition,
)
from deeplearning4j_tpu_torch.telemetry.flight import (  # noqa: F401
    dump as flight_dump,
    install_faulthandler,
    list_bundles,
    load_bundle,
    summarize,
)
from deeplearning4j_tpu_torch.telemetry.export import (  # noqa: F401
    FRAME_VERSION,
    FrameExporter,
    exporter,
)
from deeplearning4j_tpu_torch.telemetry.aggregate import (  # noqa: F401
    FleetCollector,
    collector,
    deregister_replica,
    register_local_host,
    register_replica,
)
