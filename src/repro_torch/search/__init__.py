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

Backends: ``ga`` (paper Alg. 1), ``island`` (N GA populations with ring
migration of elites; processes started with ``spawn`` on CUDA, ``fork`` on
the CPU, threads inside a daemonic worker), ``random``, ``hill_climb``,
``exhaustive``; cost model ``default``; workloads the CNN zoo; accelerators
the ``repro_torch.hw`` catalog.  A fixed seed gives the reference's
artifact: the same genome, fitness and evaluation counts.  Telemetry
(``telemetry=True``, ``SearchSession(trace_path=...)``, ``REPRO_TRACE``)
embeds the reference's summary and never changes a result.

The island and CLI flow (every search's label pass on the card unless
``--device cpu``):

    artifact = search("mobilenet_v3", "simba", backend="island",
                      backend_config={"islands": 4, "migrate_every": 20})

    python -m repro_torch search --workload mobilenet_v3 --backend island \
        --backend-config '{"islands": 4}' --telemetry --out a.json
    python -m repro_torch report a.json --telemetry   # + the certificate
    python -m repro_torch serve --store S --requests jobs.json --workers 2
    python -m repro_torch submit --store S --workload mobilenet_v3 ...
    python -m repro_torch verify --store S

The store (``repro_torch.serve.ArtifactStore``) keys artifacts exactly as
the reference's does, so each package's store serves the other's objects.
``spacemap=True`` searches the statically reduced space (and ``exhaustive``
composes it per region), and ``file:model.json`` workloads import GraphIR
documents.  ``costmodel="tpu"`` prices schedules on the modelled TPU
roofline (``repro_torch.costmodel.tpu_fusion``), and
``repro_torch.search.tpu.search_tpu_schedule`` searches TPU training
schedules of the ten model configs with the same backends.
"""
from repro_torch.search.artifact import (FingerprintMismatch,
                                         ScheduleArtifact, graph_fingerprint)
from repro_torch.search.backends import (BackendError, ExhaustiveBackend,
                                         GABackend, HillClimbBackend,
                                         RandomBackend, SearchBackend)
from repro_torch.search.island import IslandBackend, island_seed
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
    "FunctionWorkload", "GABackend", "HillClimbBackend", "IslandBackend",
    "Param",
    "Progress", "RandomBackend", "Registry", "RegistryError",
    "ScheduleArtifact", "SearchBackend", "SearchSession", "SearchSpec",
    "Workload", "WorkloadParamError", "build_accelerator",
    "build_costmodel", "build_workload", "get_workload",
    "graph_fingerprint", "island_seed", "parse_workload_spec",
    "register_accelerator",
    "register_backend", "register_costmodel", "register_objective",
    "register_workload", "search", "workload_schemas",
]
