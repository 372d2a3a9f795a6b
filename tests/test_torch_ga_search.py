"""The port's search facade on the CPU against the reference's.

``repro_torch.search.search(..., device="cpu")`` must give the artifact of
``repro.search.search(...)`` with the same arguments, for the ``ga``,
``random``, ``hill_climb`` and ``exhaustive`` backends: the same genome,
fitness, history, evaluation counts, costs, per-group breakdowns, graph
fingerprint and spec.  Left out of the comparison, and only these:
``created_unix`` and ``wall_s`` (clocks), and in ``backend_stats`` the
engine's timings (``batch_time_s``, ``batch_evals_per_sec``) and its name
(``pop_backend``: ``torch`` here, ``numpy`` in the reference).  The golden
constants ``chip_smoke.py`` holds the card's runs to are the reference's.
"""
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from repro.search import ScheduleArtifact as RefArtifact
from repro.search import search as ref_search
from repro_torch.search import (ScheduleArtifact, SearchSession,
                                SearchSpec, search)

ROOT = Path(__file__).resolve().parents[1]
CLOCKS = ("created_unix", "wall_s")
ENGINE_STATS = ("batch_time_s", "batch_evals_per_sec", "pop_backend")


def _comparable(art) -> dict:
    d = json.loads(json.dumps(art.to_dict()))
    for key in CLOCKS:
        del d[key]
    for key in ENGINE_STATS:
        del d["backend_stats"][key]
    return d


CASES = {
    "ga_fast_seed0": dict(workload="mobilenet_v3", accelerator="simba",
                          backend="ga", seed=0,
                          backend_config={"preset": "fast",
                                          "generations": 8}),
    "ga_fast_seed1": dict(workload="resnet50", accelerator="eyeriss",
                          backend="ga", seed=1, objective="energy",
                          backend_config={"preset": "fast",
                                          "generations": 8}),
    "random": dict(workload="resnet50", accelerator="eyeriss",
                   backend="random", seed=0,
                   backend_config={"evaluations": 3000}),
    "hill_climb": dict(workload="mobilenet_v3", accelerator="simba",
                       backend="hill_climb", seed=0, objective="cycles",
                       backend_config={"max_steps": 6}),
    "exhaustive": dict(workload="unet", accelerator="simba",
                       backend="exhaustive", seed=0, objective="dram",
                       workload_kwargs={"depth": 1}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_artifact_equals_reference(name):
    kw = CASES[name]
    ref = ref_search(**kw)
    got = search(**kw, device="cpu")
    assert got.backend_stats["pop_backend"] == "torch"
    assert ref.backend_stats["pop_backend"] == "numpy"
    assert got.backend_stats["pop_batches"] > 0
    assert _comparable(got) == _comparable(ref)
    assert got.summary() == ref.summary()


def test_reference_artifact_loads_and_rebinds():
    ref = ref_search("resnet50", "simba", backend="ga", seed=2,
                     backend_config={"preset": "fast", "generations": 4})
    art = ScheduleArtifact.from_json(ref.to_json())
    assert art.load_warnings == []
    assert art.rebuild_state().mask == ref.genome_mask
    assert art.to_json() == ref.to_json()
    # and the other way round: the port's artifact in the reference
    mine = search("resnet50", "simba", backend="ga", seed=2, device="cpu",
                  backend_config={"preset": "fast", "generations": 4})
    back = RefArtifact.from_json(mine.to_json())
    assert back.rebuild_state().mask == mine.genome_mask == ref.genome_mask


def test_direct_graph_session_embeds_the_reference_ir():
    """A graph outside the registry: the spec names it by fingerprint, the
    artifact embeds its IR, both as the reference writes them."""
    from repro.search import SearchSession as RefSession
    from repro.workloads import vgg16 as ref_vgg16
    from repro_torch.costmodel import SIMBA
    from repro.costmodel import SIMBA as REF_SIMBA
    from repro_torch.workloads import vgg16
    kw = dict(backend="ga", backend_config={"preset": "fast",
                                            "generations": 3})
    ref = RefSession.from_objects(ref_vgg16(), REF_SIMBA, **kw)
    mine = SearchSession.from_objects(vgg16(), SIMBA, device="cpu", **kw)
    assert mine.spec.to_dict() == ref.spec.to_dict()
    assert mine.spec.workload.startswith("ir:")
    assert _comparable(mine.run()) == _comparable(ref.run())
    assert mine.artifact.graph_ir == ref.artifact.graph_ir


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("run", ["paper_ga", "random"])
def test_chip_smoke_golden_constants_are_the_references(run):
    """The paper's GA (mobilenet_v3, simba, preset paper, seed 0) and the
    random backend (resnet50, eyeriss, 100000 evaluations): the reference's
    genome, fitness and evaluations are the golden constants the card's
    runs are held to, and the port's CPU path gives them too."""
    cs = _chip_smoke()
    spec, golden = cs.GA_RUNS[run]["spec"], cs.GA_RUNS[run]["golden"]
    ref = ref_search(**spec)
    got = {"genome_mask": ref.genome_mask, "best_fitness": ref.best_fitness,
           "evaluations": ref.evaluations}
    assert got == golden
    mine = search(**spec, device="cpu")
    assert _comparable(mine) == _comparable(ref)


# telemetry, the island backend, spacemap and file: workloads are ported
# (tests/test_torch_obs.py, test_torch_island.py, test_torch_spacemap.py,
# test_torch_ir_passes.py), and so is the tpu cost model: with each of them
# it gives the reference's artifact
@pytest.mark.parametrize("what", [
    dict(spacemap=True), dict(spacemap=True, backend="exhaustive"),
    dict(spacemap=True, backend="island"),
    dict(), dict(workload="file:model.json")])
def test_unported_parts_are_refused(what, tmp_path, monkeypatch):
    """Once refused naming ROADMAP A2; now each search under the ``tpu``
    cost model equals the reference's (island: in processes, as the
    reference runs them; exhaustive: unet at depth 1, whose space is
    small: under the VMEM budget vgg16's spacemap freezes nothing)."""
    monkeypatch.chdir(tmp_path)
    from repro.ir import save as ref_save
    from repro.workloads import vgg16 as ref_vgg16
    ref_save(ref_vgg16(), "model.json")
    kw = dict(workload="vgg16", accelerator="simba", backend="ga",
              costmodel="tpu", seed=0,
              backend_config={"preset": "fast", "generations": 4})
    kw.update(what)
    if kw["backend"] == "island":
        kw["backend_config"] = {"islands": 2, "migrate_every": 2,
                                "preset": "fast", "generations": 4}
    if kw["backend"] == "exhaustive":
        kw.update(workload="unet", backend_config={},
                  workload_kwargs={"depth": 1})
    ref = ref_search(**kw)
    got = SearchSession(SearchSpec(**kw), device="cpu").run()
    assert got.spec.costmodel == "tpu"
    assert _comparable(got) == _comparable(ref)