"""String-keyed registries: workloads, accelerators, objectives, backends,
cost models (the port's copy of ``repro/search/registry.py``, populated
with the zoo workloads, the catalog accelerators, the native objectives
and the ``default`` and ``tpu`` cost models).

Every extension point of the search facade is a named registry entry, so a
new workload / accelerator / objective / search strategy / cost backend is
one decorated function — not another entry-point script:

    from repro_torch.search import register_workload

    @register_workload("tiny_cnn")
    def tiny_cnn() -> LayerGraph: ...

    search("tiny_cnn", "simba", backend="ga")

Workload entries implement the parametric :class:`repro_torch.workloads.base.
Workload` protocol (param schema + ``build``); bare callables are wrapped
automatically.  Everywhere a workload name is accepted, three spec forms
resolve:

* ``name`` or ``name@key=value,key=value`` — a registry entry, with
  params validated/coerced against its schema (``mobilenet_v3@hw=160``);
* ``file:model.json`` — a :mod:`repro_torch.ir` GraphIR document imported
  through the canonicalization pipeline (no registration needed);
* ``ir:<fingerprint>`` — IR embedded in a search artifact; resolvable
  only through the artifact that carries it.

Accelerator specs additionally support the paper's Fig. 11 iso-capacity
repartitioning inline: ``eyeriss@act+64`` moves 64 KiB of weight buffer to
the activation buffer of the registered ``eyeriss`` template (``-`` moves it
back), so buffer-sweep experiments need no pre-registered variant per point.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterator, List, Optional, Tuple, TypeVar

from repro_torch.workloads.base import (Workload, WorkloadParamError, as_workload)

T = TypeVar("T")


class RegistryError(LookupError):
    """Unknown name, or a duplicate registration without ``replace=True``."""


class Registry:
    """A named string -> object table with decorator registration."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, object] = {}

    def register(self, name: str, obj: Optional[T] = None, *,
                 replace: bool = False):
        """Register ``obj`` under ``name``; with ``obj`` omitted, returns a
        decorator (``@REGISTRY.register("name")``)."""
        def _add(o: T) -> T:
            if not replace and name in self._entries:
                raise RegistryError(
                    f"{self.kind} {name!r} is already registered "
                    f"(pass replace=True to override)")
            self._entries[name] = o
            return o
        return _add if obj is None else _add(obj)

    def get(self, name: str):
        try:
            return self._entries[name]
        except KeyError:
            raise RegistryError(
                f"unknown {self.kind} {name!r}; valid: "
                + ", ".join(self.names())) from None

    def names(self) -> List[str]:
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(self.names())

    def __len__(self) -> int:
        return len(self._entries)


WORKLOADS = Registry("workload")
ACCELERATORS = Registry("accelerator")
OBJECTIVES = Registry("objective")
BACKENDS = Registry("backend")
COSTMODELS = Registry("costmodel")


def register_workload(name: str, obj=None, *, replace: bool = False):
    """Register a workload: a :class:`~repro_torch.workloads.base.Workload`
    (class or instance) or a plain ``(**kwargs) -> LayerGraph`` builder,
    which is wrapped in a schema-deriving
    :class:`~repro_torch.workloads.base.FunctionWorkload`.  Decorator when
    ``obj`` is omitted (returns the original object)."""
    def _add(o):
        WORKLOADS.register(name, as_workload(o, name), replace=replace)
        return o
    return _add if obj is None else _add(obj)


def register_accelerator(name: str, obj=None, *, replace: bool = False):
    """Register a ``() -> Accelerator`` template factory (decorator when
    ``obj`` is omitted)."""
    return ACCELERATORS.register(name, obj, replace=replace)


def register_objective(name: str, obj=None, *, replace: bool = False):
    """Register a ``(ScheduleCost) -> float`` metric (lower is better;
    fitness is baseline_metric / candidate_metric).  Decorator when
    ``obj`` is omitted."""
    return OBJECTIVES.register(name, obj, replace=replace)


def register_backend(name: str, obj=None, *, replace: bool = False):
    """Register a :class:`repro_torch.search.backends.SearchBackend` subclass
    (instantiated per session).  Decorator when ``obj`` is omitted."""
    return BACKENDS.register(name, obj, replace=replace)


def register_costmodel(name: str, obj=None, *, replace: bool = False):
    """Register a :class:`repro_torch.costmodel.base.CostModel` factory —
    typically the class itself — called as
    ``factory(graph, accelerator, energy_model) -> CostModel`` once per
    search session.  Decorator when ``obj`` is omitted."""
    return COSTMODELS.register(name, obj, replace=replace)


_WL_SPEC = re.compile(r"^(?P<name>[^@]+)@(?P<params>.+)$")


def parse_workload_spec(spec: str) -> Tuple[str, Dict[str, str]]:
    """Split ``name[@key=value,key=value...]`` into (name, raw params);
    values stay strings — the workload's schema coerces them."""
    m = _WL_SPEC.match(spec)
    if m is None:
        if "@" in spec:
            raise WorkloadParamError(
                f"malformed workload spec {spec!r}; expected "
                f"name@key=value[,key=value...]")
        return spec, {}
    params: Dict[str, str] = {}
    for item in m.group("params").split(","):
        key, sep, value = item.partition("=")
        key, value = key.strip(), value.strip()
        if not sep or not key or not value:
            raise WorkloadParamError(
                f"malformed param {item!r} in workload spec {spec!r}; "
                f"expected key=value")
        if key in params:
            raise WorkloadParamError(
                f"duplicate param {key!r} in workload spec {spec!r}")
        params[key] = value
    return m.group("name"), params


def get_workload(name: str) -> Workload:
    """Resolve a registered workload to the protocol object (wrapping
    legacy bare-callable entries on the fly)."""
    return as_workload(WORKLOADS.get(name), name)


def build_workload(spec: str, **kwargs):
    """Build a workload's :class:`LayerGraph` from any spec form:
    registry ``name[@key=value,...]`` (params schema-checked) or a
    ``file:model.json`` GraphIR document.  ``kwargs`` merge with (and
    must not collide with) spec-string params."""
    if spec.startswith("file:"):
        if kwargs:
            raise WorkloadParamError(
                f"file: workload specs take no params "
                f"(got {sorted(kwargs)}); edit the IR document instead")
        from repro_torch.ir import load
        from repro_torch.workloads.base import GraphIRWorkload
        return GraphIRWorkload(load(spec[len("file:"):])).build()
    if spec.startswith("ir:"):
        raise RegistryError(
            f"workload spec {spec!r} names IR embedded in a search "
            f"artifact; it has no registry entry — rebuild it from the "
            f"artifact (ScheduleArtifact.rebuild_graph / repro report)")
    name, raw = parse_workload_spec(spec)
    workload = get_workload(name)
    overlap = sorted(set(raw) & set(kwargs))
    if overlap:
        raise WorkloadParamError(
            f"param(s) {overlap} given both in spec {spec!r} and in "
            f"workload_kwargs; pick one place")
    return workload.build(**{**raw, **kwargs})


def workload_schemas() -> Dict[str, Dict[str, Any]]:
    """Machine-readable registry view: every workload's doc line + param
    schema (what ``repro list --json`` emits)."""
    return {name: get_workload(name).describe() for name in WORKLOADS}


def build_costmodel(name: str):
    """Resolve a registered cost-model factory (not yet bound to a graph/
    accelerator — the session binds it)."""
    return COSTMODELS.get(name)


_REPART = re.compile(r"^(?P<base>[\w.-]+)@act(?P<delta>[+-]\d+)$")


def build_accelerator(spec: str):
    """Resolve an accelerator spec: a registered template name, optionally
    with a Fig.-11 repartition suffix (``eyeriss@act+64``)."""
    m = _REPART.match(spec)
    if m is None:
        return ACCELERATORS.get(spec)()
    acc = ACCELERATORS.get(m.group("base"))()
    return acc.repartition(int(m.group("delta")))


def _install_builtins() -> None:
    """Populate the registries from the paper's tables (idempotent)."""
    from repro_torch.costmodel.default import DefaultCostModel
    from repro_torch.costmodel.evaluator import NATIVE_OBJECTIVES
    from repro_torch.costmodel.tpu_fusion import TpuFusionCostModel
    from repro_torch.hw.catalog import ALL_SPECS
    from repro_torch.workloads import WORKLOADS as _ZOO

    for wname, builder in _ZOO.items():
        if wname not in WORKLOADS:
            WORKLOADS.register(wname, as_workload(builder, wname))
    for aname, spec in ALL_SPECS.items():
        if aname not in ACCELERATORS:
            # the hierarchical description is the source of truth; the
            # registry serves the flat view the mappers consume
            # (repartition variants derive from it via the @act suffix)
            ACCELERATORS.register(aname, (lambda s: s.to_accelerator)(spec))
    for obj in NATIVE_OBJECTIVES:
        if obj not in OBJECTIVES:
            OBJECTIVES.register(
                obj, (lambda o: lambda cost: cost.metric(o))(obj))
    for cm in (DefaultCostModel, TpuFusionCostModel):
        if cm.name not in COSTMODELS:
            COSTMODELS.register(cm.name, cm)


_install_builtins()
