"""``repro_torch.obs`` — opt-in telemetry: metrics, tracing, convergence
records (the port's copy of ``repro/obs``).

Zero-overhead-when-disabled observability for the search engine, the serve
layer, and the verifiers:

* :class:`MetricRegistry` — labeled counters / gauges / histograms
  (:mod:`repro_torch.obs.metrics`);
* :class:`Tracer` — span-scoped, schema-versioned JSONL events
  (``search`` -> ``generation`` -> ``batch_eval`` -> ``costmodel`` span
  nesting plus ``island.migration`` / ``serve.job`` / ``verify.*`` points;
  :mod:`repro_torch.obs.trace`);
* :class:`TelemetryCollector` — the hook surface instrumented layers call
  (:mod:`repro_torch.obs.collect`);
* :mod:`repro_torch.obs.clock` — the engine's single wall-clock seam
  (enforced by ``python -m repro_torch lint``'s ``clock-seam`` rule).

Activation is explicit: ``SearchSpec(telemetry=True)``, the ``--trace``
CLI flag, or ``REPRO_TRACE=path.jsonl`` in the environment.  Off is the
default and is dead cheap — instrumented modules hold ``None`` and skip
with one attribute check per *batch*, never per offspring — and enabling
telemetry changes no search result: store keys and fixed-seed RNG draw
sequences are bit-identical either way (pinned by tests).

``python -m repro_torch trace <file.jsonl>`` aggregates raw traces
(:mod:`repro_torch.obs.traceview`); ``python -m repro_torch report
--telemetry`` renders the summary artifacts embed (:mod:`repro_torch.obs.report`).

This package is stdlib-only and imports nothing from the engine, so
boundary-pinned checkers (``repro_torch.analysis.verify``) may use it freely.
"""
from repro_torch.obs import clock
from repro_torch.obs.collect import (SUMMARY_SCHEMA, TRACE_ENV,
                                     TelemetryCollector, trace_path_from_env)
from repro_torch.obs.metrics import (NULL_REGISTRY, Counter, Gauge,
                                     Histogram, MetricRegistry, NullRegistry)
from repro_torch.obs.trace import (NULL_TRACER, SCHEMA_VERSION, NullTracer,
                                   Tracer, validate_event)

__all__ = [
    "clock",
    "Counter", "Gauge", "Histogram", "MetricRegistry", "NullRegistry",
    "NULL_REGISTRY",
    "Tracer", "NullTracer", "NULL_TRACER", "SCHEMA_VERSION",
    "validate_event",
    "TelemetryCollector", "TRACE_ENV", "SUMMARY_SCHEMA",
    "trace_path_from_env",
]
