"""The port's static fusion-space analysis (``repro_torch.analysis.
spacemap``) on the CPU, against the reference's.

The first part is ``tests/test_spacemap.py`` with the port's modules, every
search on ``device="cpu"``: static verdicts are sound against brute force,
regions confine every group, the per-region exhaustive composition is
exact, search operators respect the freeze, artifacts round-trip the
summary through ``verify``, and the checker stays engine-isolated.  The
``tpu`` cost model's composition case also holds the map and both
artifacts to the reference's.  The second part holds the
port to the reference on the same inputs: ``build_spacemap(...).to_dict()``
for every zoo workload on every catalog accelerator, fixed-seed
``spacemap=True`` artifacts (GA, island, per-region exhaustive), the
verifier's verdicts on tampered, stripped and frozen-bit artifacts, and the
golden constants ``chip_smoke.py``'s phase 8 holds the card's runs to.
"""
import dataclasses
import os
import random
import subprocess
import sys

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.analysis import SpaceMap, build_spacemap, verify_artifact
from repro_torch.analysis.verify import _GraphView
from repro_torch.core.fusion import FusionState
from repro_torch.core.graph import Layer, LayerGraph
from repro_torch.search import (OBJECTIVES, BackendError, ScheduleArtifact,
                                SearchSession, SearchSpec, build_accelerator,
                                register_objective, search)

# ---- graphs ----------------------------------------------------------------------
# simba's activation buffer is 32768 words: the `small` layers below
# (8ch, 16x16 maps) can all fuse freely, the `big` layers (64ch, 64x64
# maps, 3-row windows) provably cannot pair up — so hand-built graphs hit
# all three verdicts and factorize into >1 region.


def small_chain(n=4):
    g = LayerGraph("small_chain")
    prev = g.add(Layer(name="input", kind="input", m=8, p=16, q=16))
    for i in range(n):
        prev = g.add(Layer(name=f"c{i}", kind="conv", c=8, h=16, w=16,
                           m=8, p=16, q=16, r=3, s=3, padding=(1, 1)),
                     [prev])
    return g


def skip_graph():
    g = LayerGraph("skip_graph")
    i = g.add(Layer(name="input", kind="input", m=8, p=16, q=16))
    a = g.add(Layer(name="a", kind="conv", c=8, h=16, w=16, m=8, p=16,
                    q=16, r=3, s=3, padding=(1, 1)), [i])
    b = g.add(Layer(name="b", kind="conv", c=8, h=16, w=16, m=8, p=16,
                    q=16, r=3, s=3, padding=(1, 1)), [a])
    g.add(Layer(name="add", kind="add", c=8, h=16, w=16, m=8, p=16, q=16),
          [a, b])
    return g


def big_chain(n=3):
    """Every conv-conv pair over-fills the buffer: bits 1..n-1 freeze."""
    g = LayerGraph("big_chain")
    prev = g.add(Layer(name="input", kind="input", m=64, p=64, q=64))
    for i in range(n):
        prev = g.add(Layer(name=f"c{i}", kind="conv", c=64, h=64, w=64,
                           m=64, p=64, q=64, r=3, s=3, padding=(1, 1)),
                     [prev])
    return g


def mixed():
    """Small fusable head, big frozen tail: one frozen gene splits the
    graph into two regions."""
    g = LayerGraph("mixed")
    prev = g.add(Layer(name="input", kind="input", m=8, p=16, q=16))
    for i in range(3):
        prev = g.add(Layer(name=f"s{i}", kind="conv", c=8, h=16, w=16,
                           m=8, p=16, q=16, r=3, s=3, padding=(1, 1)),
                     [prev])
    prev = g.add(Layer(name="up", kind="conv", c=8, h=16, w=16, m=64,
                       p=64, q=64, r=3, s=3, padding=(1, 1)), [prev])
    for i in range(2):
        prev = g.add(Layer(name=f"b{i}", kind="conv", c=64, h=64, w=64,
                           m=64, p=64, q=64, r=3, s=3, padding=(1, 1)),
                     [prev])
    return g


def session_for(graph, *, backend="exhaustive", spacemap=True, **spec_kwargs):
    return SearchSession.from_objects(
        graph, build_accelerator("simba"), backend=backend,
        spacemap=spacemap, device="cpu", **spec_kwargs)


# ---- classification sanity -------------------------------------------------------


def test_hand_built_graphs_hit_all_three_verdicts():
    sm = build_spacemap(mixed(), "default", "simba")
    assert sm.frozen_indices == (5,)             # b0 -> b1 cannot pair
    assert [[r.lo, r.hi] for r in sm.regions] == [[0, 5], [6, 6]]
    assert sm.genome_length == sm.n_edges - 1 == 5
    sm = build_spacemap(big_chain(), "default", "simba")
    assert sm.frozen_indices == (1, 2)
    assert len(sm.regions) == 3
    sm = build_spacemap(small_chain(), "default", "simba")
    assert sm.frozen_indices == ()               # everything fits
    assert {v.verdict for v in sm.verdicts} == {"free"}


def test_unknown_costmodel_degrades_to_a_noop_map():
    sm = build_spacemap(big_chain(), "nosuchmodel", "simba")
    assert sm.capacity_words is None
    assert sm.frozen_indices == ()
    assert all(v.verdict == "undecided" for v in sm.verdicts)
    assert len(sm.regions) == 1                  # whole graph, one region


# ---- soundness against brute force (hypothesis) ----------------------------------


@st.composite
def random_dags(draw):
    """Small random conv chains, channels/spatial drawn so both the
    frozen and the free verdict occur across examples, plus an optional
    skip edge (a residual add over the last two convs)."""
    ch = draw(st.sampled_from([4, 8, 64]))
    hw = draw(st.sampled_from([16, 64]))
    n = draw(st.integers(min_value=2, max_value=4))
    with_skip = draw(st.booleans())
    g = LayerGraph(f"rand_c{ch}_s{hw}_n{n}_{int(with_skip)}")
    prev = g.add(Layer(name="input", kind="input", m=ch, p=hw, q=hw))
    convs = []
    for i in range(n):
        prev = g.add(Layer(name=f"c{i}", kind="conv", c=ch, h=hw, w=hw,
                           m=ch, p=hw, q=hw, r=3, s=3, padding=(1, 1)),
                     [prev])
        convs.append(prev)
    if with_skip and n >= 2:
        g.add(Layer(name="add", kind="add", c=ch, h=hw, w=hw, m=ch, p=hw,
                    q=hw), [convs[-2], convs[-1]])
    return g


@settings(max_examples=20, deadline=None)
@given(graph=random_dags())
def test_forced_off_illegal_and_free_legal_under_brute_force(graph):
    session = session_for(graph)
    sm, view = session.spacemap, _GraphView(graph)
    frozen = sm.frozen_mask
    # forced_off is sound: EVERY genome containing a frozen bit is invalid
    for mask in range(1 << view.m):
        if mask & frozen:
            assert session.problem.fitness(
                FusionState.from_mask(graph, mask)) == 0.0
    # free is sound: every subset of free bits whose condensation the
    # independent checker calls acyclic evaluates to a real cost
    free_bits = [v.index for v in sm.free]
    for sub in range(1 << len(free_bits)):
        mask = 0
        for j, i in enumerate(free_bits):
            if (sub >> j) & 1:
                mask |= 1 << i
        if view.condensation_acyclic(view.groups_of(mask)):
            state = FusionState.from_mask(graph, mask)
            assert session.evaluator.evaluate(state) is not None, \
                f"free-bit genome {mask:#x} scored invalid"


@settings(max_examples=20, deadline=None)
@given(graph=random_dags())
def test_regions_confine_every_group(graph):
    sm = build_spacemap(graph, "default", "simba")
    view = _GraphView(graph)
    spans = [(r.lo, r.hi) for r in sm.regions]
    for mask in range(1 << view.m):
        if mask & sm.frozen_mask:
            continue
        for members in view.groups_of(mask):
            lo, hi = min(members), max(members)
            assert any(rl <= lo and hi <= rh for rl, rh in spans), \
                f"group {members} of genome {mask:#x} straddles a cut"


# ---- per-region exhaustive == global brute force ---------------------------------


@pytest.mark.parametrize("objective", ["edp", "energy", "cycles", "dram"])
@pytest.mark.parametrize("builder", [small_chain, skip_graph, big_chain,
                                     mixed])
def test_per_region_composition_matches_flat_brute_force(builder, objective):
    graph = builder()
    flat = session_for(graph, spacemap=False, objective=objective)
    flat_art = flat.run()
    fact = session_for(graph, spacemap=True, objective=objective)
    fact_art = fact.run()
    assert fact_art.best_fitness == pytest.approx(
        flat_art.best_fitness, rel=1e-12)
    assert fact.result.best_state.mask & fact.spacemap.frozen_mask == 0
    # factorization never scores more states than the flat enumeration
    assert fact_art.evaluations <= flat_art.evaluations


def test_per_region_composition_matches_flat_on_tpu_costmodel():
    """tests/test_spacemap.py:196 on the port (once refused naming ROADMAP
    A2): under the ``tpu`` cost model the factorized search finds the flat
    one's fitness, and the map and both artifacts are the reference's."""
    from repro.analysis import build_spacemap as ref_build_spacemap
    from repro.search import SearchSession as RefSession
    from repro.search import build_accelerator as ref_build_accelerator
    graph = mixed()
    flat = session_for(graph, spacemap=False, costmodel="tpu").run()
    fact = session_for(graph, spacemap=True, costmodel="tpu").run()
    assert fact.best_fitness == pytest.approx(flat.best_fitness, rel=1e-12)
    ref_graph = rs.ScheduleArtifact.from_json(fact.to_json()).rebuild_graph()
    sm = build_spacemap(graph, "tpu", "simba")
    ref_sm = ref_build_spacemap(ref_graph, "tpu", "simba")
    assert sm.to_dict() == ref_sm.to_dict()
    for spacemap, mine in ((False, flat), (True, fact)):
        ref = RefSession.from_objects(
            ref_graph, ref_build_accelerator("simba"), backend="exhaustive",
            spacemap=spacemap, costmodel="tpu").run()
        assert (mine.genome_mask, mine.best_fitness, mine.evaluations) == \
            (ref.genome_mask, ref.best_fitness, ref.evaluations)


def test_vgg16_solved_exactly_by_region_composition():
    """ROADMAP 5(b): the paper's 2^21 VGG-16 space, exactly — a few dozen
    evaluations instead of two million (fixed-seed pin)."""
    session = SearchSession(SearchSpec(
        workload="vgg16", backend="exhaustive", spacemap=True),
        device="cpu")
    art = session.run()
    sm = session.spacemap
    assert sm.raw_space_size() == 1 << 21
    assert sm.frozen_indices == (1, 4, 7, 8, 11, 12, 15, 16)
    assert len(sm.regions) == 9
    assert art.evaluations == 37
    assert session.result.best_state.mask == 0x1A4225
    assert art.best_fitness == pytest.approx(1.0273429656033972, rel=1e-12)
    report = verify_artifact(art)
    assert report.ok, report.describe()
    assert report.check("spacemap").ok


def test_fixed_seed_ga_with_spacemap_is_no_worse_than_baseline():
    def ga(spacemap):
        return search("vgg16", "simba", backend="ga", seed=0,
                      spacemap=spacemap, device="cpu",
                      backend_config={"preset": "fast", "generations": 8})
    base, frozen = ga(False), ga(True)
    assert frozen.best_fitness >= base.best_fitness
    # fixed-seed pins for BOTH trajectories: the spacemap path draws over
    # the active bits only, so it has its own pin rather than bit-identity
    assert base.best_fitness == pytest.approx(1.027324133811833, rel=1e-12)
    assert frozen.best_fitness == pytest.approx(1.0273429656033972,
                                                rel=1e-12)


# ---- exhaustive guards -----------------------------------------------------------


def test_guard_reports_largest_region_when_factorized_space_too_big():
    with pytest.raises(BackendError, match="largest spacemap region"):
        search("unet", backend="exhaustive", spacemap=True, device="cpu")


def test_guard_explains_why_custom_objectives_do_not_compose():
    name = "test_spacemap_cycles_objective"
    if name not in OBJECTIVES:
        @register_objective(name)
        def cycles_metric(cost):
            return cost.cycles
    with pytest.raises(BackendError,
                       match="not group-additive") as excinfo:
        search("unet", backend="exhaustive", objective=name, spacemap=True,
               device="cpu")
    assert "a spacemap factorizes this into" in str(excinfo.value)


# ---- operator masking ------------------------------------------------------------


def test_search_operators_never_set_frozen_bits():
    session = session_for(mixed(), backend="ga")
    problem, sm = session.problem, session.spacemap
    frozen = sm.frozen_mask
    assert frozen                                # the test needs teeth
    rng = random.Random(0)
    pop = [problem.random_genome(rng) for _ in range(16)]
    for _ in range(200):
        child = problem.mutate(
            problem.crossover(rng.choice(pop), rng.choice(pop), rng), rng)
        assert child.mask & frozen == 0
        pop.append(child)
    assert all(g.mask & frozen == 0 for g in pop)
    for nb in problem.neighbors(problem.initial()):
        assert nb.mask & frozen == 0
    assert problem.space_size() == 1 << len(sm.active_indices)
    masks = {g.mask for g in problem.enumerate()}
    assert len(masks) == problem.space_size()    # no duplicates, full cover
    assert all(m & frozen == 0 for m in masks)


def test_fully_decided_spacemap_leaves_operators_noops():
    """Zero active bits (every gene frozen): mutate must return the
    genome unchanged instead of looping forever, sampling and enumeration
    collapse to the single layerwise genome."""
    from repro_torch.core.problem import FusionProblem
    graph = big_chain(2)
    session = session_for(graph, backend="ga")
    sm = build_spacemap(graph, "default", "simba")
    all_off = SpaceMap(
        graph_name=sm.graph_name, costmodel=sm.costmodel,
        accelerator=sm.accelerator, n_edges=sm.n_edges,
        capacity_words=sm.capacity_words, capacity_how=sm.capacity_how,
        verdicts=[dataclasses.replace(v, verdict="forced_off")
                  for v in sm.verdicts], regions=[])
    assert all_off.genome_length == 0
    problem = FusionProblem(graph, session.evaluator, "edp",
                            spacemap=all_off)
    g = problem.initial()
    assert problem.mutate(g, random.Random(0)).mask == g.mask
    assert problem.random_genome(random.Random(1)).mask == 0
    assert [s.mask for s in problem.enumerate()] == [0]
    assert problem.space_size() == 1


# ---- spec / artifact serialization -----------------------------------------------


def test_spec_spacemap_default_stays_off_the_wire():
    d = SearchSpec(workload="vgg16").to_dict()
    assert "spacemap" not in d                   # store keys unchanged
    assert SearchSpec.from_dict(d).spacemap is False
    d = SearchSpec(workload="vgg16", spacemap=True).to_dict()
    assert d["spacemap"] is True
    assert SearchSpec.from_dict(d).spacemap is True


def _spacemap_artifact():
    session = session_for(mixed())
    return session, session.run()


def test_artifact_roundtrips_spacemap_summary_and_verifies():
    session, art = _spacemap_artifact()
    assert art.spacemap == session.spacemap.summary()
    rt = ScheduleArtifact.from_json(art.to_json())
    assert rt.spacemap == art.spacemap
    report = verify_artifact(rt)
    assert report.ok, report.describe()
    assert "re-derived identically" in report.check("spacemap").detail


def test_spacemap_off_artifacts_carry_no_summary_or_check():
    session = session_for(mixed(), spacemap=False)
    art = session.run()
    assert art.spacemap is None
    assert "spacemap" not in art.to_dict()
    assert verify_artifact(art).check("spacemap") is None


def test_genome_setting_a_frozen_bit_fails_verification():
    session, art = _spacemap_artifact()
    bit = session.spacemap.frozen_indices[0]
    bad = dataclasses.replace(art,
                              genome_mask=art.genome_mask | (1 << bit))
    check = verify_artifact(bad).check("spacemap")
    assert not check.ok
    assert "forced-off" in check.detail


def test_tampered_spacemap_summary_fails_verification():
    _, art = _spacemap_artifact()
    forged = dict(art.spacemap)
    forged["forced_off"] = []
    check = verify_artifact(
        dataclasses.replace(art, spacemap=forged)).check("spacemap")
    assert not check.ok
    assert "disagrees" in check.detail


def test_stripped_spacemap_summary_fails_verification():
    _, art = _spacemap_artifact()
    check = verify_artifact(
        dataclasses.replace(art, spacemap=None)).check("spacemap")
    assert not check.ok
    assert "carries no" in check.detail


# ---- engine isolation ------------------------------------------------------------


def test_spacemap_imports_neither_fusion_nor_evaluator():
    """The acceptance pin (same rule ``repro lint`` enforces through the
    pyproject boundary table): the analyzer that prunes the engine's
    search space shares no code with the engine it prunes.  Source-level
    — ``repro.core``'s package init eagerly re-exports ``fusion``, so
    *transitive* loading is unavoidable; what is banned is this module
    naming either engine module in any import statement, lazy included."""
    import repro_torch.analysis.spacemap as spacemap
    with open(spacemap.__file__) as f:
        src = f.read()
    imports = [ln for ln in src.splitlines()
               if ln.lstrip().startswith(("import ", "from "))]
    for ln in imports:
        assert "core.fusion" not in ln, ln
        assert "core import fusion" not in ln, ln
        assert "costmodel.evaluator" not in ln, ln
        assert "costmodel import evaluator" not in ln, ln


def test_spacemap_boundary_pin_survives_a_clean_interpreter():
    """`repro analyze` must work where only the analysis surface is
    imported: a fresh interpreter builds a spacemap and re-derives the
    same summary the in-process analyzer produced."""
    code = (
        "import json, sys\n"
        "from repro_torch.analysis.spacemap import build_spacemap\n"
        "from repro_torch.search.registry import build_workload\n"
        "sm = build_spacemap(build_workload('vgg16'), 'default', 'simba')\n"
        "json.dump(sm.summary(), sys.stdout)\n")
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env["PYTHONPATH"] = os.path.abspath(src)
    out = subprocess.run([sys.executable, "-c", code], check=True, env=env,
                         capture_output=True, text=True)
    import json
    from repro_torch.search.registry import build_workload
    expect = build_spacemap(build_workload("vgg16"), "default",
                            "simba").summary()
    assert json.loads(out.stdout) == expect


# ---- against the reference --------------------------------------------------------

import hashlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

import repro.analysis as ra  # noqa: E402
import repro.search as rs  # noqa: E402
from repro.hw.catalog import ALL_SPECS as REF_SPECS  # noqa: E402
from repro.workloads import WORKLOADS as REF_ZOO  # noqa: E402
from repro_torch.hw.catalog import ALL_SPECS  # noqa: E402
from repro_torch.search.registry import build_workload  # noqa: E402
from repro_torch.workloads import WORKLOADS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _comparable(art) -> dict:
    d = json.loads(json.dumps(art.to_dict()))
    for key in ("created_unix", "wall_s"):
        del d[key]
    for key in ("batch_time_s", "batch_evals_per_sec", "pop_backend"):
        d["backend_stats"].pop(key, None)
    return d


@pytest.mark.parametrize("workload", sorted(REF_ZOO))
def test_spacemap_equals_the_references_on_every_catalog_accelerator(
        workload):
    assert sorted(WORKLOADS) == sorted(REF_ZOO)
    assert sorted(ALL_SPECS) == sorted(REF_SPECS)
    graph = build_workload(workload)
    ref_graph = rs.build_workload(workload)
    for accel in sorted(REF_SPECS) + ["eyeriss@act+64"]:
        mine = build_spacemap(graph, "default", accel)
        ref = ra.build_spacemap(ref_graph, "default", accel)
        assert mine.to_dict() == ref.to_dict(), accel
        assert mine.summary() == ref.summary()
        assert mine.describe() == ref.describe()


SPACEMAP_CASES = {
    "ga": dict(workload="mobilenet_v3", accelerator="simba", backend="ga",
               seed=1, backend_config={"preset": "fast", "generations": 8}),
    "ga_energy": dict(workload="resnet50", accelerator="eyeriss",
                      backend="ga", seed=0, objective="energy",
                      backend_config={"preset": "fast", "generations": 6}),
    "random": dict(workload="mobilenet_v3", accelerator="simba",
                   backend="random", backend_config={"evaluations": 1500}),
    "hill_climb": dict(workload="resnet50", accelerator="simba",
                       backend="hill_climb",
                       backend_config={"max_steps": 4}),
    "island": dict(workload="mobilenet_v3", accelerator="simba",
                   backend="island",
                   backend_config={"islands": 2, "preset": "fast",
                                   "generations": 6}),
    "exhaustive_vgg16": dict(workload="vgg16", accelerator="simba",
                             backend="exhaustive"),
    "exhaustive_dram": dict(workload="vgg16", accelerator="eyeriss",
                            backend="exhaustive", objective="dram"),
}


@pytest.mark.parametrize("name", list(SPACEMAP_CASES))
def test_spacemap_artifact_equals_the_references(name):
    kw = dict(SPACEMAP_CASES[name], spacemap=True)
    ref = rs.search(**kw)
    mine = search(**kw, device="cpu")
    assert mine.spacemap is not None
    assert _comparable(mine) == _comparable(ref)
    assert verify_artifact(mine).ok


@pytest.mark.parametrize("builder", [mixed, big_chain, skip_graph])
def test_per_region_composition_equals_the_references(builder):
    from repro.ir import GraphIR as RefIR
    graph = builder()
    ref_graph = RefIR.from_dict(graph.to_ir().to_dict()).build()
    ref = rs.SearchSession.from_objects(
        ref_graph, rs.build_accelerator("simba"), backend="exhaustive",
        spacemap=True).run()
    mine = session_for(graph).run()
    assert _comparable(mine) == _comparable(ref)


def _tampered(make_artifact, spacemap_of):
    """The reference's three bad artifacts: a frozen bit set in the genome,
    a forged summary, a stripped one."""
    art = make_artifact()
    bit = spacemap_of(art)["forced_off"][0]
    forged = dict(art.spacemap, forced_off=[])
    return {"clean": art,
            "frozen_bit": dataclasses.replace(
                art, genome_mask=art.genome_mask | (1 << bit)),
            "tampered": dataclasses.replace(art, spacemap=forged),
            "stripped": dataclasses.replace(art, spacemap=None)}


def test_verifier_verdicts_equal_the_references_on_bad_artifacts():
    kw = dict(workload="mobilenet_v3", accelerator="simba", backend="ga",
              spacemap=True, backend_config={"preset": "fast",
                                             "generations": 4})
    mine = _tampered(lambda: search(**kw, device="cpu"),
                     lambda a: a.spacemap)
    ref = _tampered(lambda: rs.search(**kw), lambda a: a.spacemap)
    for case in mine:
        got, want = verify_artifact(mine[case]), ra.verify_artifact(ref[case])
        assert [c.to_dict() for c in got.checks] == \
            [c.to_dict() for c in want.checks], case
        assert got.ok == want.ok == (case == "clean")
        if case != "clean":
            assert not got.check("spacemap").ok


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("run", ["spacemap_ga", "per_region"])
def test_chip_smoke_spacemap_runs_are_the_references(run):
    """Phase 8's spacemap GA (the paper GA with ``spacemap=True``) and
    per-region exhaustive run (vgg16): the reference's genome, fitness and
    evaluations are the golden constants, and the port's CPU path gives
    them too."""
    cs = _chip_smoke()
    spec, golden = cs.SPACEMAP_RUNS[run]["spec"], cs.SPACEMAP_RUNS[run][
        "golden"]
    ref = rs.search(**spec)
    assert {"genome_mask": ref.genome_mask, "best_fitness": ref.best_fitness,
            "evaluations": ref.evaluations} == golden
    assert _comparable(search(**spec, device="cpu")) == _comparable(ref)


def test_chip_smoke_analyze_golden_is_the_references():
    cs = _chip_smoke()
    g = cs.ANALYZE_GOLDEN
    ref = ra.build_spacemap(rs.build_workload(g["workload"]), "default",
                            g["accelerator"])
    doc = json.dumps(ref.to_dict(), indent=2, sort_keys=True)
    assert hashlib.sha256(doc.encode()).hexdigest() == g["sha256"]
    assert (len(ref.frozen_indices), len(ref.regions)) == \
        (g["frozen"], g["regions"])
