"""``repro_torch.search`` — the reference's search facade (``repro.search``)
on PyTorch, its population engine's group-label pass a CUDA kernel.

    from repro_torch.search import search
    artifact = search("mobilenet_v3", "simba", backend="ga")   # on CUDA
    artifact = search("mobilenet_v3", "simba", backend="ga",
                      device="cpu")      # the plain PyTorch label pass
    print(artifact.summary())          # energy_x / edp_x / groups / ...
    artifact.save("schedule.json")     # the reference's artifact schema

or, declaratively:

    spec = SearchSpec(workload="resnet50", accelerator="eyeriss@act+64",
                      backend="hill_climb", seed=1)
    artifact = SearchSession(spec).run(progress=print)

Backends: ``ga`` (paper Alg. 1), ``random``, ``hill_climb``,
``exhaustive``; cost model ``default``; workloads the CNN zoo; accelerators
the ``repro_torch.hw`` catalog.  A fixed seed gives the reference's
artifact: the same genome, fitness and evaluation counts.  Not ported yet:
the ``island`` backend, ``spacemap=True``, telemetry, the ``tpu`` cost
model, ``file:`` GraphIR workloads, the CLI, the daemon and the store.
"""
from repro_torch.search.artifact import (FingerprintMismatch,
                                         ScheduleArtifact, graph_fingerprint)
from repro_torch.search.backends import (BackendError, ExhaustiveBackend,
                                         GABackend, HillClimbBackend,
                                         RandomBackend, SearchBackend)
from repro_torch.search.registry import (ACCELERATORS, BACKENDS, COSTMODELS,
                                         OBJECTIVES, WORKLOADS, Registry,
                                         RegistryError, build_accelerator,
                                         build_costmodel, build_workload,
                                         get_workload, parse_workload_spec,
                                         register_accelerator,
                                         register_backend,
                                         register_costmodel,
                                         register_objective,
                                         register_workload, workload_schemas)
from repro_torch.search.session import Progress, SearchSession, search
from repro_torch.search.spec import SearchSpec
from repro_torch.workloads.base import (FunctionWorkload, Param, Workload,
                                        WorkloadParamError)

__all__ = [
    "ACCELERATORS", "BACKENDS", "COSTMODELS", "OBJECTIVES", "WORKLOADS",
    "BackendError", "ExhaustiveBackend", "FingerprintMismatch",
    "FunctionWorkload", "GABackend", "HillClimbBackend", "Param",
    "Progress", "RandomBackend", "Registry", "RegistryError",
    "ScheduleArtifact", "SearchBackend", "SearchSession", "SearchSpec",
    "Workload", "WorkloadParamError", "build_accelerator",
    "build_costmodel", "build_workload", "get_workload",
    "graph_fingerprint", "parse_workload_spec", "register_accelerator",
    "register_backend", "register_costmodel", "register_objective",
    "register_workload", "search", "workload_schemas",
]
