"""The telemetry collector instrumented layers talk to.

One :class:`TelemetryCollector` spans one activity (a search, a serve
batch, a verify sweep): it owns a :class:`~repro_torch.obs.metrics.MetricRegistry`
and an optional :class:`~repro_torch.obs.trace.Tracer`, and exposes the narrow
recording hooks each layer calls:

* ``record_batch`` / ``note_group_costed`` — ``costmodel.Evaluator``, once
  per *batch* (never per offspring): states scored, novel genomes, invalid
  (schedulability-rejected) count, engine backend, novel groups costed.
  Emits nested ``batch_eval``/``costmodel`` spans.
* ``begin_search`` / ``on_step`` / ``end_search`` — ``SearchSession``:
  per-generation convergence records (best/mean/std, rejection rate,
  group-cache hit rate) drained from the batch window at each observer
  tick, plus the ``search`` -> ``generation`` span scaffolding.  Exactly
  one ``generation`` span is emitted per observer tick, so a traced run's
  generation-span count equals ``len(artifact.history)`` on the ga backend.
* ``record_migration`` — ``IslandBackend``: ``island.migration`` points.
* ``record_job`` / ``record_serve_batch`` — ``serve.BatchScheduler``:
  dedup/store-hit/miss counters, per-worker wall time, ``serve.job``
  points.
* ``record_certificate`` — ``analysis.verify``: lower-bound gap metrics.

Recording NEVER feeds back into the search: no RNG is consumed, no
stopping decision reads collector state, and the accumulators are plain
floats/ints — fixed-seed trajectories with telemetry on are bit-identical
to telemetry off (pinned by ``tests/test_obs_search.py``).
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional

from repro_torch.obs import clock
from repro_torch.obs.metrics import Counter, MetricRegistry
from repro_torch.obs.trace import NULL_TRACER, Tracer

#: environment variable naming the JSONL trace file (any CLI command)
TRACE_ENV = "REPRO_TRACE"

#: artifact ``telemetry`` summary schema version
SUMMARY_SCHEMA = 1


def trace_path_from_env() -> Optional[str]:
    """The ``REPRO_TRACE`` trace file path, or None when unset/empty."""
    return os.environ.get(TRACE_ENV) or None


def _r6(x: float) -> float:
    return round(x, 6)


class TelemetryCollector:
    """Metrics + trace sink for one instrumented activity."""

    def __init__(self, tracer: Optional[Tracer] = None,
                 registry: Optional[MetricRegistry] = None):
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._own_tracer = tracer is not None
        self.registry = registry if registry is not None else MetricRegistry()
        #: per-observer-tick convergence records (in tick order)
        self.generations: List[Dict[str, Any]] = []
        self._ev = None                   # bound Evaluator (counter source)
        # instruments are fetched once: the recording path touches only
        # slot attributes, no per-event registry lookups
        reg = self.registry
        self._c_batches = reg.counter("eval.batches")
        self._c_states = reg.counter("eval.states")
        self._c_unique = reg.counter("eval.unique")
        self._c_invalid = reg.counter("eval.invalid")
        self._c_novel_groups = reg.counter("costmodel.novel_groups")
        self._h_batch_size = reg.histogram("eval.batch_size")
        self._h_batch_s = reg.histogram("eval.batch_s")
        self._engine_counters: Dict[str, Counter] = {}
        # batch window accumulators, drained at each observer tick
        self._w_states = 0
        self._w_unique = 0
        self._w_invalid = 0
        self._w_sum = 0.0
        self._w_sumsq = 0.0
        self._w_novel_groups = 0
        self._cost_s = 0.0               # novel-group costing time, this batch
        self._seen_groups = (0, 0)       # evaluator (hits, misses) at last tick
        self._search_id: Optional[int] = None
        self._gen_id: Optional[int] = None

    @classmethod
    def from_env(cls) -> Optional["TelemetryCollector"]:
        """A collector tracing to ``$REPRO_TRACE``, or None when unset —
        the one-liner CLI commands use to opt whole invocations in."""
        path = trace_path_from_env()
        if not path:
            return None
        return cls(tracer=Tracer(path))

    def close(self) -> None:
        """Close an owned tracer (collectors built with an explicit or
        env-derived Tracer own its file handle)."""
        if self._own_tracer:
            self.tracer.close()

    # ---- evaluator hooks (batch granularity only) -------------------------------
    def bind_evaluator(self, ev) -> None:
        """Remember the evaluator whose group-cache counters feed the
        per-generation hit-rate deltas."""
        self._ev = ev
        self._seen_groups = (getattr(ev, "group_hits", 0),
                             getattr(ev, "group_misses", 0))

    def note_group_costed(self, dur_s: float) -> None:
        """One novel group was costed (``Evaluator._group_cost`` miss)."""
        self._cost_s += dur_s

    def record_batch(self, n_states: int, n_unique: int,
                     fits: List[float], engine: str,
                     t0: float, dur_s: float, novel_groups: int) -> None:
        """One evaluator batch completed.  ``fits`` are the scored
        fitnesses (0.0 = schedulability-rejected / over-capacity)."""
        inv = 0
        s = 0.0
        ss = 0.0
        for f in fits:
            if f <= 0.0:
                inv += 1
            s += f
            ss += f * f
        self._w_states += n_states
        self._w_unique += n_unique
        self._w_invalid += inv
        self._w_sum += s
        self._w_sumsq += ss
        self._w_novel_groups += novel_groups
        self._c_batches.inc()
        self._c_states.inc(n_states)
        self._c_unique.inc(n_unique)
        self._c_invalid.inc(inv)
        self._c_novel_groups.inc(novel_groups)
        self._h_batch_size.observe(n_states)
        self._h_batch_s.observe(dur_s)
        ec = self._engine_counters.get(engine)
        if ec is None:
            ec = self.registry.counter("eval.batches_by_engine",
                                       engine=engine)
            self._engine_counters[engine] = ec
        ec.inc()
        cost_s, self._cost_s = self._cost_s, 0.0
        tr = self.tracer
        if tr.enabled:
            bid = tr.alloc_id()
            parent = tr.current()
            if novel_groups:
                tr.emit_span("costmodel", t0=t0, dur_s=cost_s, parent=bid,
                             attrs={"novel_groups": novel_groups})
            tr.emit_span("batch_eval", t0=t0, dur_s=dur_s, span_id=bid,
                         parent=parent,
                         attrs={"n_states": n_states, "n_unique": n_unique,
                                "invalid": inv,
                                "novel_groups": novel_groups,
                                "engine": engine})

    # ---- search session hooks ---------------------------------------------------
    def begin_search(self, attrs: Dict[str, Any]) -> None:
        """Open the ``search`` span and the first generation window."""
        self._search_attrs = dict(attrs)
        self._t0_wall = clock.now()
        self._t0_perf = clock.perf_counter()
        tr = self.tracer
        if tr.enabled:
            self._search_id = tr.alloc_id()
            tr.push(self._search_id)
            self._gen_id = tr.alloc_id()
            tr.push(self._gen_id)        # batch spans nest under it
        self._gen_t0w = self._t0_wall
        self._gen_t0p = self._t0_perf

    def on_step(self, step: int, best: float, evals: int,
                offspring: int) -> None:
        """One backend observer tick: drain the batch window into a
        convergence record and close/reopen the generation span."""
        ev = self._ev
        hit_rate = 0.0
        if ev is not None:
            h0, m0 = self._seen_groups
            h1 = getattr(ev, "group_hits", 0)
            m1 = getattr(ev, "group_misses", 0)
            dh, dm = h1 - h0, m1 - m0
            hit_rate = dh / (dh + dm) if (dh + dm) else 0.0
            self._seen_groups = (h1, m1)
        n = self._w_states
        mean = self._w_sum / n if n else 0.0
        var = self._w_sumsq / n - mean * mean if n else 0.0
        rec = {
            "step": step,
            "best": best,
            "mean": mean,
            "std": math.sqrt(var) if var > 0 else 0.0,
            "evaluations": evals,        # cumulative unique genomes
            "offspring": offspring,      # cumulative submitted genomes
            "batch_states": n,           # states scored this window
            "batch_unique": self._w_unique,
            "rejection_rate": self._w_invalid / n if n else 0.0,
            "group_hit_rate": hit_rate,
            "novel_groups": self._w_novel_groups,
        }
        self.generations.append(rec)
        tr = self.tracer
        if tr.enabled:
            now_w, now_p = clock.now(), clock.perf_counter()
            tr.pop()
            tr.emit_span("generation", t0=self._gen_t0w,
                         dur_s=now_p - self._gen_t0p, span_id=self._gen_id,
                         parent=self._search_id,
                         attrs={k: (_r6(v) if isinstance(v, float) else v)
                                for k, v in rec.items()})
            self._gen_id = tr.alloc_id()
            tr.push(self._gen_id)
            self._gen_t0w, self._gen_t0p = now_w, now_p
        self._w_states = self._w_unique = self._w_invalid = 0
        self._w_sum = self._w_sumsq = 0.0
        self._w_novel_groups = 0

    def end_search(self, cache_stats: Optional[Dict[str, Any]] = None
                   ) -> None:
        """Close the ``search`` span; the dangling post-final-tick
        generation window is discarded unemitted, so generation-span count
        == observer-tick count."""
        tr = self.tracer
        if not tr.enabled:
            return
        tr.pop()                         # dangling generation id: not emitted
        tr.point("metrics.snapshot", attrs=self.registry.snapshot())
        tr.pop()
        tr.emit_span(
            "search", t0=self._t0_wall,
            dur_s=clock.perf_counter() - self._t0_perf,
            span_id=self._search_id, parent=None,
            attrs={**self._search_attrs, "steps": len(self.generations),
                   **({"cache": dict(cache_stats)} if cache_stats else {})})
        self._search_id = None

    def progress_records(self) -> List[Dict[str, Any]]:
        """JSON-safe snapshot of the per-generation convergence records, in
        tick order — what the daemon (``repro_torch.serve.daemon``) serves
        from ``GET /jobs/<id>`` while a search is still running.  Floats are
        rounded like trace attributes; the snapshot copies the record list
        first so a concurrent ``on_step`` append never tears the
        serialization."""
        return [{k: (_r6(v) if isinstance(v, float) else v)
                 for k, v in rec.items()}
                for rec in list(self.generations)]

    def summary(self, cache_stats: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
        """The compact per-run summary artifacts embed (``repro report
        --telemetry`` renders it with no trace file): parallel
        per-generation arrays + final cache stats + the metric snapshot."""
        g = self.generations
        return {
            "schema": SUMMARY_SCHEMA,
            "steps": len(g),
            "best": [_r6(r["best"]) for r in g],
            "mean": [_r6(r["mean"]) for r in g],
            "std": [_r6(r["std"]) for r in g],
            "rejection_rate": [_r6(r["rejection_rate"]) for r in g],
            "group_hit_rate": [_r6(r["group_hit_rate"]) for r in g],
            "unique_states": [r["evaluations"] for r in g],
            "offspring": [r["offspring"] for r in g],
            "cache": dict(cache_stats or {}),
            "metrics": self.registry.snapshot(),
        }

    # ---- island backend hook ----------------------------------------------------
    def record_migration(self, gen: int, best: float, islands: int,
                         migration: bool) -> None:
        """One island sync barrier; ``migration``: elites moved (vs an
        observation-only barrier)."""
        self.registry.counter("island.barriers").inc()
        if migration:
            self.registry.counter("island.migrations").inc()
            self.tracer.point("island.migration", attrs={
                "gen": gen, "best": _r6(best), "islands": islands})

    # ---- serve hooks ------------------------------------------------------------
    def record_job(self, job) -> None:
        """One resolved :class:`repro_torch.serve.scheduler.Job`."""
        outcome = job.outcome or "failed"
        self.registry.counter("serve.jobs", outcome=outcome).inc()
        if job.deduped:
            self.registry.counter("serve.deduped_in_flight").inc()
        attrs: Dict[str, Any] = {
            "id": job.id, "status": job.status, "outcome": job.outcome,
            "deduped": job.deduped, "workload": job.spec.workload,
            "key": job.key[:12] if job.key else None, "error": job.error}
        if job.outcome == "searched" and job.artifact is not None:
            wall = job.artifact.wall_s   # the worker's in-search wall time
            self.registry.histogram("serve.job_wall_s").observe(wall)
            attrs["wall_s"] = _r6(wall)
        self.tracer.point("serve.job", attrs=attrs)

    def record_serve_batch(self, stats: Dict[str, int], store_hits: int,
                           store_misses: int, t0: float,
                           dur_s: float) -> None:
        """One drained scheduler batch (``BatchScheduler.run``)."""
        # serve.batch.* namespace: the per-job counters above own serve.*
        # (serve.deduped_in_flight is a Counter; stats carries the same key)
        for k, v in stats.items():
            self.registry.gauge(f"serve.batch.{k}").set(v)
        self.registry.counter("serve.store_hits").inc(store_hits)
        self.registry.counter("serve.store_misses").inc(store_misses)
        if self.tracer.enabled:
            self.tracer.emit_span(
                "serve.batch", t0=t0, dur_s=dur_s, parent=None,
                attrs={**stats, "store_hits": store_hits,
                       "store_misses": store_misses})

    # ---- verify hook ------------------------------------------------------------
    def record_certificate(self, label: str, cert, ok: bool) -> None:
        """One verified artifact's lower-bound certificate gaps."""
        self.registry.histogram("verify.gap_vs_schedule").observe(
            cert.gap_vs_schedule)
        self.registry.histogram("verify.gap_vs_graph").observe(
            cert.gap_vs_graph)
        self.registry.counter("verify.artifacts",
                              ok="true" if ok else "false").inc()
        self.tracer.point("verify.certificate", attrs={
            "label": label, "ok": bool(ok),
            "traffic_words": cert.traffic_words,
            "schedule_lb_words": cert.schedule_lb_words,
            "graph_lb_words": cert.graph_lb_words,
            "gap_vs_schedule": _r6(cert.gap_vs_schedule),
            "gap_vs_graph": _r6(cert.gap_vs_graph)})
