"""Search sessions: resolve a spec, drive a backend, produce an artifact.

    spec    = SearchSpec(workload="mobilenet_v3", accelerator="simba")
    session = SearchSession(spec)
    artifact = session.run(progress=print)      # -> ScheduleArtifact

The session owns the live objects (graph, evaluator, problem, backend
result) so in-process callers can inspect caches or render schedules, while
the returned artifact is the durable, serializable product.  Budget and
patience from the spec are enforced here through the backend observer hook,
so individual backends stay oblivious to stopping policy.

The port's copy of ``repro/search/session.py``.  Both entry points take a
``device``: ``None`` means CUDA (and raises when no card is present),
``"cpu"`` runs the population engine's plain PyTorch label pass.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

from repro_torch.core.graph import LayerGraph
from repro_torch.core.problem import FusionProblem
from repro_torch.costmodel.accelerator import Accelerator
from repro_torch.costmodel.energy import DEFAULT_ENERGY, EnergyModel
from repro_torch.costmodel.evaluator import NATIVE_OBJECTIVES, Evaluator
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import (TelemetryCollector, Tracer, clock,
                             trace_path_from_env)

from repro_torch.search.artifact import ScheduleArtifact, make_artifact
from repro_torch.search.backends import BackendError
from repro_torch.search.registry import (BACKENDS, OBJECTIVES,
                                         build_accelerator, build_costmodel,
                                         build_workload)
from repro_torch.search.spec import SearchSpec


class Progress(NamedTuple):
    """One progress tick from the running backend."""
    step: int                 # generation / chunk index (backend-defined)
    best_fitness: float
    evaluations: int          # unique genomes scored
    offspring_evaluated: int  # total genomes submitted


class _CustomObjectiveProblem(FusionProblem):
    """Fusion problem scored by a registry objective the evaluator does not
    know natively: costs still come from the memoized group cache, but the
    metric is the registered ``(ScheduleCost) -> float`` function."""

    def __init__(self, graph, evaluator, objective: str, spacemap=None):
        super().__init__(graph, evaluator, objective, spacemap=spacemap)
        self._metric = OBJECTIVES.get(objective)
        self._baseline = self._metric(evaluator.layerwise())

    def fitness(self, genome) -> float:
        cost = self.evaluator.evaluate(genome)
        if cost is None:
            return 0.0
        new = self._metric(cost)
        return self._baseline / new if new > 0 else 0.0

    def fitness_batch(self, genomes):
        return [self.fitness(g) for g in genomes]

    fitness_batch_unique = fitness_batch   # evaluator can't score this metric


class SearchSession:
    """One search: spec -> (resolved objects) -> backend run -> artifact."""

    def __init__(self, spec: SearchSpec, *, graph: Optional[LayerGraph] = None,
                 accelerator: Optional[Accelerator] = None,
                 em: Optional[EnergyModel] = None,
                 embed_ir: Optional[bool] = None,
                 trace_path: Optional[str] = None,
                 obs: Optional[TelemetryCollector] = None,
                 device: DeviceLike = None):
        self.spec = spec
        device = resolve_device(device)   # no card and no device: raise now
        # JSONL span destination (CLI --trace); REPRO_TRACE is the env
        # fallback, checked at run() so tests can set it per-run
        self.trace_path = trace_path
        # externally-owned collector (repro_torch.serve.daemon): the session
        # attaches it for the run so callers can stream per-generation
        # records live, but does NOT embed its summary in the artifact
        # unless the spec itself asks for telemetry — daemon-produced
        # artifacts stay byte-compatible with direct SearchSession runs
        self._external_obs = obs
        self.telemetry: Optional[TelemetryCollector] = None
        # artifacts for workloads with no registry entry (file: documents,
        # direct graphs recorded as ir:<fingerprint>) embed the canonical
        # GraphIR so they stay reproducible anywhere; registry workloads
        # can opt in (embed_ir=True / CLI --embed-ir)
        self.embed_ir = bool(embed_ir) if embed_ir is not None else \
            spec.workload.startswith(("file:", "ir:"))
        # resolve everything eagerly so bad names fail at session creation,
        # not generations into a search
        if "seed" in spec.backend_config or "observer" in spec.backend_config:
            raise BackendError(
                "set the seed via SearchSpec.seed (CLI: --seed) and progress "
                "hooks via run(progress=...), not backend_config")
        ga_cfg = spec.backend_config.get("ga_config")
        ga_obj = ga_cfg.get("objective", spec.objective) \
            if isinstance(ga_cfg, dict) else \
            getattr(ga_cfg, "objective", spec.objective)
        if ga_obj != spec.objective:
            # run_ga_problem never reads GAConfig.objective (the problem
            # carries the spec's); a divergent value would be silently
            # ignored, so refuse it instead
            raise BackendError(
                f"ga_config objective {ga_obj!r} conflicts with "
                f"SearchSpec.objective {spec.objective!r}")
        self.backend = BACKENDS.get(spec.backend)()
        OBJECTIVES.get(spec.objective)
        costmodel_factory = build_costmodel(spec.costmodel)
        self.graph = graph if graph is not None else \
            build_workload(spec.workload, **spec.workload_kwargs)
        self.accelerator = accelerator if accelerator is not None else \
            build_accelerator(spec.accelerator)
        self.evaluator = Evaluator(self.graph, self.accelerator,
                                   em or DEFAULT_ENERGY,
                                   costmodel=costmodel_factory,
                                   device=device)
        # static fusion-space analysis (opt-in): frozen genes + regions,
        # derived independently of the engine (repro_torch.analysis.spacemap)
        self.spacemap = None
        if spec.spacemap:
            from repro_torch.analysis.spacemap import build_spacemap
            self.spacemap = build_spacemap(self.graph, spec.costmodel,
                                           spec.accelerator)
        if spec.objective in NATIVE_OBJECTIVES:
            self.problem = FusionProblem(self.graph, self.evaluator,
                                         spec.objective,
                                         spacemap=self.spacemap)
        else:
            self.problem = _CustomObjectiveProblem(self.graph, self.evaluator,
                                                   spec.objective,
                                                   spacemap=self.spacemap)
        self.result = None                 # GAResult after run()
        self.artifact: Optional[ScheduleArtifact] = None

    @classmethod
    def from_objects(cls, graph: LayerGraph, accelerator: Accelerator,
                     spec: Optional[SearchSpec] = None, *,
                     em: Optional[EnergyModel] = None,
                     device: DeviceLike = None,
                     **spec_kwargs) -> "SearchSession":
        """Session over pre-built objects (graphs not in the registry).

        The fabricated spec records the workload as ``ir:<fingerprint>``
        — not the graph's bare name, which may collide with (or be absent
        from) the registry — and the artifact embeds the graph's IR, so
        the result is reproducible without the code that built it."""
        if spec is None:
            from repro_torch.search.artifact import graph_fingerprint
            spec = SearchSpec(workload=f"ir:{graph_fingerprint(graph)}",
                              accelerator=accelerator.name, **spec_kwargs)
        return cls(spec, graph=graph, accelerator=accelerator, em=em,
                   device=device)

    # ---- running ---------------------------------------------------------------
    def _telemetry_setup(self) -> Tuple[Optional[TelemetryCollector],
                                        Optional[Tracer]]:
        """Build and attach the collector when telemetry is on; (None, None)
        otherwise — the disabled path allocates nothing.  An external
        collector (``obs=``) is attached as-is: the session never owns its
        tracer and tracing env/args are ignored for the run."""
        tracer: Optional[Tracer] = None
        if self._external_obs is not None:
            collector = self._external_obs
        else:
            path = self.trace_path or trace_path_from_env()
            if not (self.spec.telemetry or path):
                return None, None
            tracer = Tracer(path) if path else None
            collector = TelemetryCollector(tracer=tracer)
        self.evaluator.attach_telemetry(collector)
        # island workers reach the collector via the problem they fork with
        self.problem.obs = collector
        collector.begin_search({
            "workload": self.spec.workload,
            "accelerator": self.spec.accelerator,
            "objective": self.spec.objective,
            "backend": self.spec.backend,
            "costmodel": self.spec.costmodel,
            "seed": self.spec.seed,
        })
        self.telemetry = collector
        return collector, tracer

    def _observer(self, progress: Optional[Callable[[Progress], None]],
                  collector: Optional[TelemetryCollector] = None):
        spec = self.spec
        state = {"best": -1.0, "stale": 0}

        def observe(step: int, best: float, evals: int, offspring: int
                    ) -> bool:
            # telemetry ticks first so a progress callback already sees the
            # generation's record; it only records — the stop decision below
            # never reads it, so budget/patience behave identically on/off
            if collector is not None:
                collector.on_step(step, best, evals, offspring)
            if progress is not None:
                progress(Progress(step, best, evals, offspring))
            stop = False
            if spec.budget is not None and offspring >= spec.budget:
                stop = True
            if spec.patience is not None:
                if best > state["best"] + 1e-15:
                    state["best"], state["stale"] = best, 0
                else:
                    state["stale"] += 1
                    if state["stale"] >= spec.patience:
                        stop = True
            return stop

        return observe

    def run(self, progress: Optional[Callable[[Progress], None]] = None
            ) -> ScheduleArtifact:
        """Drive the backend to completion and package the artifact."""
        collector, tracer = self._telemetry_setup()
        t0 = clock.perf_counter()
        try:
            self.result = self.backend.run(
                self.problem, seed=self.spec.seed,
                observer=self._observer(progress, collector),
                **self.spec.backend_config)
        finally:
            # detach even on failure so the evaluator/problem never leak a
            # collector into a later run on the same session objects
            if collector is not None:
                self.evaluator.attach_telemetry(None)
                self.problem.obs = None
        wall_s = clock.perf_counter() - t0
        best_cost = self.evaluator.evaluate(self.result.best_state)
        assert best_cost is not None, \
            "backend returned an invalid best state"
        breakdowns = self.evaluator.breakdowns(self.result.best_state)
        telemetry = None
        if collector is not None:
            stats = self.evaluator.cache_stats()
            collector.end_search(stats)
            if tracer is not None:
                tracer.close()
            # external collectors record for their owner (the daemon); the
            # artifact embeds a summary only when the spec opted in, so a
            # daemon-run artifact is byte-identical to a direct run's
            if self._external_obs is None or self.spec.telemetry:
                telemetry = collector.summary(stats)
        self.artifact = make_artifact(
            self.spec, self.graph, self.result,
            baseline=self.evaluator.layerwise(), best=best_cost,
            wall_s=wall_s, backend_stats=self.evaluator.cache_stats(),
            group_breakdowns=breakdowns, embed_ir=self.embed_ir,
            spacemap=self.spacemap.summary() if self.spacemap else None,
            telemetry=telemetry)
        return self.artifact

    # ---- compatibility ----------------------------------------------------------
    def schedule_result(self):
        """The pre-facade :class:`repro_torch.core.schedule.ScheduleResult`
        view (kept for report rendering)."""
        from repro_torch.core.schedule import ScheduleResult
        assert self.result is not None and self.artifact is not None, \
            "run() the session first"
        return ScheduleResult(
            workload=self.graph.name, accelerator=self.accelerator.name,
            baseline=self.artifact.baseline, best=self.artifact.best,
            best_state=self.result.best_state, ga=self.result)


def search(workload: str, accelerator: str = "simba", *,
           objective: str = "edp", backend: str = "ga",
           costmodel: str = "default", seed: int = 0,
           budget: Optional[int] = None, patience: Optional[int] = None,
           spacemap: bool = False, telemetry: bool = False,
           backend_config: Optional[dict] = None,
           workload_kwargs: Optional[dict] = None,
           progress: Optional[Callable[[Progress], None]] = None,
           device: DeviceLike = None) -> ScheduleArtifact:
    """One-call facade: build the spec, run the session, return the
    artifact.  Use :class:`SearchSession` directly when you need the live
    evaluator/result objects afterwards.  ``device=None`` runs the
    population engine on CUDA and raises without a card; ``"cpu"`` runs
    its plain PyTorch version."""
    spec = SearchSpec(workload=workload, accelerator=accelerator,
                      objective=objective, backend=backend,
                      costmodel=costmodel,
                      backend_config=backend_config or {},
                      workload_kwargs=workload_kwargs or {},
                      seed=seed, budget=budget, patience=patience,
                      spacemap=spacemap, telemetry=telemetry)
    return SearchSession(spec, device=device).run(progress=progress)
