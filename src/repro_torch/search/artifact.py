"""Durable search results: the winning genome + costs, JSON-round-trippable.

A :class:`ScheduleArtifact` is what a search session produces and what a
scheduler service would store/serve: the spec that ran, the winning
edge-bitmask genome, a structural fingerprint of the graph it was searched
on, baseline/best costs, and the convergence history.  Reports and
improvement ratios come straight from the artifact — no re-search — and
re-binding the genome onto a rebuilt graph is refused unless the graph's
fingerprint matches (a stale genome on a changed graph is silently wrong,
so it is an error instead).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.obs import clock

from repro_torch.core.fusion import FusionState
from repro_torch.core.graph import LayerGraph
from repro_torch.core.schedule import ImprovementRatios
from repro_torch.costmodel.base import CostBreakdown
from repro_torch.costmodel.evaluator import ScheduleCost

from repro_torch.search.spec import SearchSpec

ARTIFACT_VERSION = 1


class FingerprintMismatch(ValueError):
    """The artifact's genome belongs to a structurally different graph."""


def graph_fingerprint(graph: LayerGraph) -> str:
    """Stable hash of the graph *structure* the genome indexes — the
    sha256 of the graph's canonical :class:`repro_torch.ir.GraphIR` byte form
    (layer geometry and input lists in insertion order, which fixes the
    edge-bit order of :class:`repro_torch.core.graph.CompiledGraph`).  Defined
    over the serialized IR, so a graph and its exported-then-reimported
    twin fingerprint identically."""
    from repro_torch.ir import GraphIR                   # lazy: keeps import light
    return GraphIR.from_graph(graph).fingerprint()


def _cost_to_dict(cost: ScheduleCost) -> Dict[str, Any]:
    return dataclasses.asdict(cost)


def _cost_from_dict(d: Dict[str, Any],
                    warnings: Optional[List[str]] = None) -> ScheduleCost:
    known = {f.name for f in dataclasses.fields(ScheduleCost)}
    extra = sorted(set(d) - known)
    if extra:
        # forward-compat: a newer writer's additions degrade to a warning
        if warnings is not None:
            warnings.append(f"ignoring unknown ScheduleCost fields {extra}")
        d = {k: v for k, v in d.items() if k in known}
    try:
        return ScheduleCost(**d)
    except TypeError as e:
        # missing required fields: baseline/best are load-bearing, so this
        # IS corrupt — but surface it as the artifact-error type callers
        # (CLI included) already handle, not a raw TypeError
        raise ValueError(f"malformed ScheduleCost record: {e}") from None


@dataclass
class ScheduleArtifact(ImprovementRatios):
    """A finished search, storable / diffable / re-loadable without
    re-searching."""

    spec: SearchSpec
    graph_fingerprint: str
    n_edges: int
    genome_mask: int
    best_fitness: float
    baseline: ScheduleCost
    best: ScheduleCost
    fused_edges: List[List[str]] = field(default_factory=list)
    history: List[float] = field(default_factory=list)
    evaluations: int = 0
    offspring_evaluated: int = 0
    wall_s: float = 0.0
    backend_stats: Dict[str, Any] = field(default_factory=dict)
    #: per-group CostBreakdown of the winning schedule (group order),
    #: so reports can show where energy/cycles go without re-costing
    group_breakdowns: List[CostBreakdown] = field(default_factory=list)
    #: the searched graph's :class:`repro_torch.ir.GraphIR` dict — embedded for
    #: every workload without a registry entry (``file:``/``ir:`` specs)
    #: so the artifact rebuilds/re-binds with no originating code at all
    graph_ir: Optional[Dict[str, Any]] = None
    #: static fusion-space summary of the reference's
    #: ``SearchSpec(spacemap=True)`` runs (not ported: the port never
    #: writes one, but loads and re-saves it)
    spacemap: Optional[Dict[str, Any]] = None
    #: compact search-telemetry summary (``SearchSpec(telemetry=True)`` or
    #: traced runs): convergence curve, rejection / cache-hit rates per
    #: generation, final metric snapshot — what ``python -m repro_torch
    #: report --telemetry`` renders without the raw trace
    #: (:meth:`repro_torch.obs.collect.TelemetryCollector.summary`)
    telemetry: Optional[Dict[str, Any]] = None
    created_unix: int = 0
    version: int = ARTIFACT_VERSION
    #: non-fatal schema degradations seen while loading (pre-cost-breakdown
    #: writers, unknown fields, malformed breakdown rows); never serialized
    load_warnings: List[str] = field(default_factory=list)

    def summary(self) -> Dict[str, Any]:
        return {
            "workload": self.spec.workload,
            "accelerator": self.spec.accelerator,
            "backend": self.spec.backend,
            "costmodel": self.spec.costmodel,
            "seed": self.spec.seed,
            "energy_x": round(self.energy_improvement, 3),
            "edp_x": round(self.edp_improvement, 3),
            "cycles_x": round(self.cycles_improvement, 3),
            "dram_x": round(self.dram_improvement, 3),
            "groups": self.best.n_groups,
            "act_dram_writes_base": self.baseline.act_write_events,
            "act_dram_writes_best": self.best.act_write_events,
            "best_fitness": self.best_fitness,
            "evaluations": self.evaluations,
        }

    # ---- genome re-binding -----------------------------------------------------
    def state(self, graph: LayerGraph) -> FusionState:
        """Re-bind the winning genome onto ``graph``; refuses structurally
        different graphs (the bitmask would index the wrong edges)."""
        fp = graph_fingerprint(graph)
        if fp != self.graph_fingerprint:
            fmt = fp.split(":", 1)[0]
            if self.graph_fingerprint.split(":", 1)[0] != fmt:
                raise FingerprintMismatch(
                    f"artifact carries a {self.graph_fingerprint.split(':', 1)[0]!r}-"
                    f"format fingerprint but this build computes {fmt!r} "
                    f"(the fingerprint moved to the canonical repro_torch.ir "
                    f"form); the stored genome cannot be safely re-bound "
                    f"— re-run the search to regenerate the artifact")
            raise FingerprintMismatch(
                f"artifact genome was searched on graph "
                f"{self.graph_fingerprint} but {graph.name!r} hashes to {fp}; "
                f"rebuild the workload exactly as specified "
                f"({self.spec.workload!r}, kwargs={self.spec.workload_kwargs})")
        return FusionState.from_mask(graph, self.genome_mask)

    def rebuild_graph(self) -> LayerGraph:
        """Rebuild the searched graph: from the embedded IR when present
        (no registry / file needed), else from the workload spec."""
        if self.graph_ir is not None:
            from repro_torch.ir import GraphIR
            return GraphIR.from_dict(self.graph_ir).build()
        if self.spec.workload.startswith("ir:"):
            raise ValueError(
                f"artifact names embedded-IR workload "
                f"{self.spec.workload!r} but carries no graph_ir — it was "
                f"stripped or written by a session that did not embed it")
        from repro_torch.search.registry import build_workload
        return build_workload(self.spec.workload, **self.spec.workload_kwargs)

    def rebuild_state(self) -> FusionState:
        return self.state(self.rebuild_graph())

    # ---- serialization ----------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = {
            "version": self.version,
            "created_unix": self.created_unix,
            "spec": self.spec.to_dict(),
            "graph_fingerprint": self.graph_fingerprint,
            "n_edges": self.n_edges,
            "genome_mask": hex(self.genome_mask),
            "fused_edges": self.fused_edges,
            "best_fitness": self.best_fitness,
            "baseline": _cost_to_dict(self.baseline),
            "best": _cost_to_dict(self.best),
            "history": self.history,
            "evaluations": self.evaluations,
            "offspring_evaluated": self.offspring_evaluated,
            "wall_s": self.wall_s,
            "backend_stats": self.backend_stats,
            "group_breakdowns": [bd.to_dict()
                                 for bd in self.group_breakdowns],
        }
        if self.graph_ir is not None:     # only self-contained artifacts
            d["graph_ir"] = self.graph_ir
        if self.spacemap is not None:     # only spacemap=True searches
            d["spacemap"] = self.spacemap
        if self.telemetry is not None:    # only telemetry-enabled searches
            d["telemetry"] = self.telemetry
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ScheduleArtifact":
        if d.get("version") != ARTIFACT_VERSION:
            raise ValueError(
                f"unsupported artifact version {d.get('version')!r} "
                f"(this build reads version {ARTIFACT_VERSION})")
        # auxiliary reporting data degrades to warnings, never to a crash:
        # artifacts written before the CostModel protocol carry no per-group
        # breakdowns, and a malformed row should not make the genome and
        # costs (the load-bearing content) unreadable
        warnings: List[str] = []
        if "group_breakdowns" not in d:
            warnings.append(
                "artifact predates per-group cost breakdowns (older "
                "writer); breakdown table unavailable — re-run the search "
                "to regenerate it")
        breakdowns = []
        for i, b in enumerate(d.get("group_breakdowns", [])):
            try:
                breakdowns.append(CostBreakdown.from_dict(b))
            except (KeyError, TypeError, AttributeError) as e:
                warnings.append(
                    f"dropping malformed group breakdown row {i}: "
                    f"{type(e).__name__}: {e}")
        try:
            return cls._from_dict_checked(d, warnings, breakdowns)
        except KeyError as e:
            # a truncated artifact missing a whole required object is
            # corrupt, but callers (CLI included) handle ValueError
            raise ValueError(
                f"artifact missing required field {e.args[0]!r}") from None

    @classmethod
    def _from_dict_checked(cls, d, warnings, breakdowns
                           ) -> "ScheduleArtifact":
        return cls(
            spec=SearchSpec.from_dict(d["spec"]),
            graph_fingerprint=d["graph_fingerprint"],
            n_edges=d["n_edges"],
            genome_mask=int(d["genome_mask"], 16),
            best_fitness=d["best_fitness"],
            baseline=_cost_from_dict(d["baseline"], warnings),
            best=_cost_from_dict(d["best"], warnings),
            fused_edges=[list(e) for e in d.get("fused_edges", [])],
            history=d.get("history", []),
            evaluations=d.get("evaluations", 0),
            offspring_evaluated=d.get("offspring_evaluated", 0),
            wall_s=d.get("wall_s", 0.0),
            backend_stats=d.get("backend_stats", {}),
            group_breakdowns=breakdowns,
            graph_ir=d.get("graph_ir"),
            spacemap=d.get("spacemap"),
            telemetry=d.get("telemetry"),
            created_unix=d.get("created_unix", 0),
            load_warnings=warnings,
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "ScheduleArtifact":
        return cls.from_dict(json.loads(text))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "ScheduleArtifact":
        with open(path) as f:
            return cls.from_json(f.read())


def make_artifact(spec: SearchSpec, graph: LayerGraph, result,
                  baseline: ScheduleCost, best: ScheduleCost,
                  wall_s: float = 0.0,
                  backend_stats: Optional[Dict[str, Any]] = None,
                  group_breakdowns: Optional[List[CostBreakdown]] = None,
                  embed_ir: bool = False,
                  telemetry: Optional[Dict[str, Any]] = None
                  ) -> ScheduleArtifact:
    """Package a finished backend run (``result``: GAResult over fusion
    genomes) into a durable artifact.  ``embed_ir`` snapshots the graph's
    exact :class:`repro_torch.ir.GraphIR` into the artifact (self-contained:
    report/rebind need no registry)."""
    state: FusionState = result.best_state
    return ScheduleArtifact(
        spec=spec,
        graph_fingerprint=graph_fingerprint(graph),
        n_edges=graph.compiled().m,
        genome_mask=state.mask,
        fused_edges=sorted([u, v] for u, v in state.fused),
        best_fitness=result.best_fitness,
        baseline=baseline,
        best=best,
        history=list(result.history),
        evaluations=result.evaluations,
        offspring_evaluated=result.offspring_evaluated,
        wall_s=wall_s,
        backend_stats=dict(backend_stats or {}),
        group_breakdowns=list(group_breakdowns or []),
        graph_ir=graph.to_ir().to_dict() if embed_ir else None,
        telemetry=telemetry,
        created_unix=clock.unix_time(),
    )
