"""The port's ``island`` backend on the CPU against the reference's.

``repro_torch.search.search(..., backend="island", device="cpu")`` must give
the artifact of ``repro.search.search(...)`` with the same arguments: islands
1, 2 and 4, ``migrate_every`` 3 and 20, process islands (``fork`` on the CPU)
and thread islands, and once with the start method pointed at ``spawn`` (the
one the card uses), which sends each island its problem pickled.  Compared
as ``tests/test_torch_ga_search.py`` compares: clocks, engine timings and the
engine's name left out.  Thread islands are held to the reference's
*process* islands (thread islands share one evaluator, so its cache counters
in ``backend_stats`` differ by design; the reference's own thread mode races
in that evaluator's engine, ROADMAP C, and is not run here).

Then the reference's own island tests (``tests/test_island.py``), run
against the port; the thread race (many threads on one evaluator against a
sequential run, which fails without ``Evaluator._lock``); and
``chip_smoke.py``'s ``ISLAND_RUNS`` against the reference's runs.  Every
test that starts island processes lowers ``SYNC_TIMEOUT_S``, so a hung
child fails the test instead of stalling the run.
"""
import functools
import importlib.util
import json
import multiprocessing
import queue
import random
import threading
import time
from pathlib import Path

import pytest

import repro_torch.search.island as island
from repro.search import search as ref_search
from repro.search.island import _sync_gens as ref_sync_gens
from repro.search.island import island_seed as ref_island_seed
from repro_torch.core.fusion import FusionState
from repro_torch.core.ga import GAConfig, run_ga_problem
from repro_torch.core.problem import FusionProblem
from repro_torch.costmodel import SIMBA
from repro_torch.costmodel.evaluator import Evaluator
from repro_torch.search import (BackendError, SearchSession, SearchSpec,
                                build_accelerator, build_workload, search)
from repro_torch.search.island import (IslandBackend, _Chan, _sync_gens,
                                       inject_migrants, island_seed)
from repro_torch.workloads import vgg16

ROOT = Path(__file__).resolve().parents[1]
CLOCKS = ("created_unix", "wall_s")
ENGINE_STATS = ("batch_time_s", "batch_evals_per_sec", "pop_backend")
FAST = {"preset": "fast", "generations": 12}


@pytest.fixture(autouse=True)
def short_sync_timeout(monkeypatch):
    monkeypatch.setattr(island, "SYNC_TIMEOUT_S", 60.0)


def _comparable(art, stats=True) -> dict:
    d = json.loads(json.dumps(art.to_dict()))
    for key in CLOCKS:
        del d[key]
    if stats:
        for key in ENGINE_STATS:
            del d["backend_stats"][key]
    else:
        del d["backend_stats"]
    return d


def _search(backend, seed=3, **extra):
    return search("vgg16", "simba", backend=backend, seed=seed,
                  device="cpu", backend_config={**FAST, **extra})


# ---- the reference's artifacts ----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_island(islands, migrate_every):
    return ref_search("mobilenet_v3", "simba", backend="island", seed=0,
                      backend_config={"preset": "fast", "generations": 24,
                                      "islands": islands,
                                      "migrate_every": migrate_every,
                                      "workers": "process"})


@pytest.mark.parametrize("workers", ["process", "thread"])
@pytest.mark.parametrize("migrate_every", [3, 20])
@pytest.mark.parametrize("islands", [1, 2, 4])
def test_island_artifact_equals_reference(islands, migrate_every, workers):
    ref = _ref_island(islands, migrate_every)
    session = SearchSession(SearchSpec(
        workload="mobilenet_v3", accelerator="simba", backend="island",
        seed=0, backend_config={"preset": "fast", "generations": 24,
                                "islands": islands,
                                "migrate_every": migrate_every,
                                "workers": workers}), device="cpu")
    got = session.run()
    assert got.backend_stats["pop_backend"] == "torch"
    same_stats = workers == "process" or islands == 1
    mine = _comparable(got, same_stats)
    mine["spec"]["backend_config"]["workers"] = "process"   # as ref's spec
    assert mine == _comparable(ref, same_stats)
    want = None if islands == 1 else "fork" if workers == "process" \
        else "thread"
    assert session.backend.start_method == want
    assert len(session.backend.island_info) == (0 if islands == 1
                                                else islands)
    for info in session.backend.island_info:
        assert info["first_gen_s"] > 0
        if workers == "process":     # each forked island owns its engine
            eng = info["engine"]
            assert eng["backend"] == "torch" and eng["batches"] > 0
            assert eng["label_launches"] == 0         # the CPU: no kernel
        else:
            assert info["engine"] is None


def test_islands_one_is_the_ga_backend_exactly():
    ga = ref_search("mobilenet_v3", "simba", backend="ga", seed=0,
                    backend_config={"preset": "fast", "generations": 24})
    got = search("mobilenet_v3", "simba", backend="island", seed=0,
                 device="cpu", backend_config={"preset": "fast",
                                               "generations": 24,
                                               "islands": 1})
    want = _comparable(ga)
    want["spec"]["backend"] = "island"
    want["spec"]["backend_config"]["islands"] = 1
    assert _comparable(got) == want


def test_spawned_islands_give_the_reference_artifact(monkeypatch):
    """The card's start method, on the CPU: each island is a fresh
    interpreter that receives the problem pickled (no device tables, no
    collector) and rebuilds its engine."""
    monkeypatch.setattr(island, "_start_method", lambda device: "spawn")
    session = SearchSession(SearchSpec(
        workload="mobilenet_v3", accelerator="simba", backend="island",
        seed=0, telemetry=True,
        backend_config={"preset": "fast", "generations": 24, "islands": 2,
                        "migrate_every": 3, "workers": "process"}),
        device="cpu")
    got = session.run()
    assert session.backend.start_method == "spawn"
    ref = _ref_island(2, 3)
    assert _comparable(got) == {**_comparable(ref),
                                "telemetry": _comparable(got)["telemetry"],
                                "spec": _comparable(got)["spec"]}
    assert got.spec.to_dict() == {**ref.spec.to_dict(), "telemetry": True}
    for info in session.backend.island_info:
        assert info["engine"]["backend"] == "torch"
        assert info["engine"]["batches"] > 0


def test_pickled_problem_leaves_device_tables_and_collector_behind():
    import pickle

    from repro_torch.obs import TelemetryCollector
    session = SearchSession(SearchSpec(workload="vgg16", backend="island"),
                            device="cpu")
    problem = session.problem
    problem.prewarm()
    problem.evaluator.population().t.label_tables(problem.evaluator.device)
    problem.obs = TelemetryCollector()
    problem.evaluator.attach_telemetry(problem.obs)
    back = pickle.loads(pickle.dumps(problem))
    assert not hasattr(back, "obs") and back.evaluator._obs is None
    assert back.evaluator.population().t._label_tables == {}
    assert back.evaluator.device.type == "cpu"
    state = problem.initial().mutate(random.Random(0))
    assert back.fitness(state) == problem.fitness(state)


# ---- the reference's island tests, on the port ------------------------------------

def test_islands_one_bit_identical_to_ga():
    a = _search("ga")
    b = _search("island", islands=1)
    assert b.genome_mask == a.genome_mask
    assert b.best_fitness == a.best_fitness
    assert b.history == a.history
    assert b.best == a.best
    assert b.baseline == a.baseline
    assert b.evaluations == a.evaluations
    assert b.offspring_evaluated == a.offspring_evaluated


def test_islands_four_fixed_seed_fitness_at_least_ga():
    a = _search("ga")
    b = _search("island", islands=4, migrate_every=4)
    assert b.best_fitness >= a.best_fitness
    assert b.offspring_evaluated > 3 * a.offspring_evaluated


def test_migration_determinism_across_runs():
    a = _search("island", islands=3, migrate_every=3)
    b = _search("island", islands=3, migrate_every=3)
    assert a.genome_mask == b.genome_mask
    assert a.best_fitness == b.best_fitness
    assert a.history == b.history


@functools.lru_cache(maxsize=None)
def _process_run():
    return _search("island", islands=3, migrate_every=3)


@pytest.mark.parametrize("rep", range(20))
def test_thread_workers_match_process_workers(rep):
    """The reference's test, twenty times: its thread mode failed
    sporadically in the driver's runs (the engine race); the port's batch
    lock makes every repetition give the process islands' result."""
    a = _process_run()
    b = _search("island", islands=3, migrate_every=3, workers="thread")
    assert a.genome_mask == b.genome_mask
    assert a.history == b.history


def test_island_seed_derivation():
    assert island_seed(7, 0) == 7
    seeds = [island_seed(7, i) for i in range(8)]
    assert len(set(seeds)) == 8
    assert seeds == [island_seed(7, i) for i in range(8)]
    assert island_seed(8, 3) != island_seed(7, 3)
    assert seeds == [ref_island_seed(7, i) for i in range(8)]


def test_island_config_validation():
    for bad in (dict(islands=0), dict(migrate_every=0), dict(workers="gpu"),
                dict(islands=2, nonsense=1)):
        with pytest.raises(BackendError):
            _search("island", **bad)


def test_island_rejects_seed_carrying_ga_config():
    with pytest.raises(BackendError, match="per-island seeds"):
        search("vgg16", "simba", backend="island", device="cpu",
               backend_config={"islands": 2,
                               "ga_config": {"generations": 4, "seed": 5}})
    art = search("vgg16", "simba", backend="island", seed=3, device="cpu",
                 backend_config={"islands": 2, "migrate_every": 2,
                                 "ga_config": {"generations": 4,
                                               "population": 20,
                                               "top_n": 4,
                                               "mutations_per_gen": 20,
                                               "random_survivors": 3}})
    assert art.best_fitness >= 1.0


def test_failed_island_releases_the_healthy_ones():
    dead_inbox = queue.Queue()
    dead_inbox.put(("error", "boom"))
    dead = _Chan(inbox=dead_inbox, outbox=queue.Queue())
    healthy_out = queue.Queue()
    healthy = _Chan(inbox=queue.Queue(), outbox=healthy_out)
    with pytest.raises(BackendError, match="island 0 failed: boom"):
        IslandBackend._drive(problem=None, chans=[dead, healthy],
                             sync_gens=[1], migrate_every=2, observer=None)
    assert healthy_out.get_nowait() == ("stop", [])


def test_chan_turns_dead_peer_into_timeout_error():
    ctx = multiprocessing.get_context("fork")
    parent, child = ctx.Pipe(duplex=True)
    child.close()
    with pytest.raises(TimeoutError, match="died"):
        _Chan(conn=parent).recv(timeout=5)


def test_chan_reads_the_sync_timeout_at_call_time(monkeypatch):
    monkeypatch.setattr(island, "SYNC_TIMEOUT_S", 0.05)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not sync"):
        _Chan(inbox=queue.Queue(), outbox=queue.Queue()).recv()
    assert time.monotonic() - t0 < 5


class _Exploding(FusionProblem):
    def fitness_batch(self, genomes):
        raise RuntimeError("cost service down")


@pytest.mark.parametrize("spawn", [False, True])
def test_erroring_problem_surfaces_promptly_as_backend_error(spawn,
                                                             monkeypatch):
    if spawn:
        monkeypatch.setattr(island, "_start_method", lambda device: "spawn")
    g = vgg16()
    problem = _Exploding(g, Evaluator(g, SIMBA, device="cpu"))
    t0 = time.monotonic()
    with pytest.raises(BackendError, match="island .* failed"):
        IslandBackend().run(problem, seed=0, islands=2, migrate_every=2,
                            preset="fast", generations=6)
    assert time.monotonic() - t0 < 60


def test_spawned_island_without_a_card_is_a_backend_error(monkeypatch):
    """A CUDA evaluator's islands rebuild their problem in the child, which
    resolves its own device: with no card that raises there, and the parent
    reports it rather than running the plain label pass."""
    import torch

    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "library", lambda name: None)  # no nvcc here
    g = vgg16()
    ev = Evaluator(g, SIMBA, device="cpu")
    ev.device = torch.device("cuda")       # as a card's run has it
    with pytest.raises(BackendError, match="island 0 failed: RuntimeError: "
                                           "no CUDA device"):
        IslandBackend().run(FusionProblem(g, ev), seed=0, islands=2,
                            migrate_every=2, preset="fast", generations=4)


def test_island_budget_stops_at_sync():
    full = _search("island", islands=2, migrate_every=2)
    capped = search("vgg16", "simba", backend="island", seed=3, budget=1,
                    device="cpu",
                    backend_config={**FAST, "islands": 2, "migrate_every": 2})
    assert len(capped.history) < len(full.history)


def test_island_budget_enforced_even_without_migrations():
    capped = search("vgg16", "simba", backend="island", seed=3, budget=1,
                    device="cpu",
                    backend_config={"preset": "fast", "generations": 25,
                                    "islands": 2, "migrate_every": 1000})
    assert len(capped.history) <= 10


@pytest.mark.parametrize("gens,every,want", [
    (10, 3, [2, 5, 8]), (9, 3, [2, 5]), (10, 20, []), (40, 20, [9, 19, 29]),
    (4, 1, [0, 1, 2])])
def test_sync_gens_match_the_reference(gens, every, want):
    assert _sync_gens(gens, every) == want == ref_sync_gens(gens, every)


def test_inject_migrants_replaces_worst_keeps_best():
    g = vgg16()
    problem = FusionProblem(g, Evaluator(g, SIMBA, device="cpu"))
    res = run_ga_problem(problem, GAConfig.fast(generations=2, seed=0))
    pool = [(problem.fitness(res.best_state), res.best_state),
            (0.5, problem.initial())]
    better = run_ga_problem(problem, GAConfig.fast(generations=4, seed=9))
    enc = problem.encode_genome(better.best_state)
    out = inject_migrants(problem, pool, [(better.best_fitness, enc)])
    assert len(out) == 2
    keys = {problem.key(s) for _, s in out}
    assert problem.key(res.best_state) in keys
    assert problem.key(better.best_state) in keys
    again = inject_migrants(problem, out, [(better.best_fitness, enc)])
    assert {problem.key(s) for _, s in again} == keys


def test_encode_decode_genome_round_trip():
    g = vgg16()
    problem = FusionProblem(g, Evaluator(g, SIMBA, device="cpu"))
    state = problem.initial().mutate(random.Random(0))
    enc = problem.encode_genome(state)
    assert isinstance(enc, int)
    back = problem.decode_genome(enc)
    assert back.mask == state.mask and back.graph is g


# ---- the thread race --------------------------------------------------------------

def _random_batches(graph, seed, n_batches=6, size=96, density=0.3):
    rng = random.Random(seed)
    m = graph.compiled().m
    return [[FusionState.from_mask(graph, sum(
        1 << i for i in range(m) if rng.random() < density))
        for _ in range(size)] for _ in range(n_batches)]


@pytest.mark.parametrize("seed", [0, 1, 3, 4])
def test_threads_sharing_one_evaluator_match_a_sequential_run(seed):
    """Eight threads score their own random batches of MobileNet-v3 genomes
    through ONE evaluator at once (what thread islands do), each batch full
    of novel groups; the results must be a sequential evaluator's.  Without
    the evaluator's batch lock these seeds raise IndexError in the engine's
    group table (rows handed out by _new_row while another thread's
    _grow/_commit_rows replaces the arrays)."""
    graph = build_workload("mobilenet_v3")
    acc = build_accelerator("simba")
    work = [_random_batches(graph, seed * 100 + t) for t in range(8)]
    seq = Evaluator(graph, acc, device="cpu")
    want = [[seq.fitness_batch_unique(b) for b in w] for w in work]
    shared = Evaluator(graph, acc, device="cpu")
    got, errors = [None] * len(work), []
    start = threading.Barrier(len(work))

    def run(t):
        try:
            start.wait()
            got[t] = [shared.fitness_batch_unique(b) for b in work[t]]
        except Exception as e:                   # noqa: BLE001 — reported
            errors.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=run, args=(t,))
               for t in range(len(work))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert errors == []
    assert got == want


# ---- chip_smoke.py's golden island runs -------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("islands", [1, 2, 4])
def test_chip_smoke_island_runs_are_the_references(islands):
    """``ISLAND_RUNS``, the constants phase 7 holds the card's spawned
    islands to, are the reference's results; the port's CPU path (forked
    islands) gives them too."""
    cs = _chip_smoke()
    kw = dict(cs.ISLAND_SPEC, backend_config=cs.island_config(islands))
    ref = ref_search(**kw)
    got = {"genome_mask": ref.genome_mask, "best_fitness": ref.best_fitness,
           "history_len": len(ref.history), "evaluations": ref.evaluations,
           "offspring_evaluated": ref.offspring_evaluated}
    assert got == cs.ISLAND_RUNS[islands]
    mine = search(**kw, device="cpu")
    assert _comparable(mine) == _comparable(ref)
