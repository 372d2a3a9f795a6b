"""The port's verifier and reports (``repro_torch.analysis``,
``repro_torch.core.report``) against the reference's.

``verify_artifact`` and ``verify_store`` must give the reference's verdicts:
the same check rows (name, verdict, detail) and the same lower-bound
certificate, on artifacts from both packages, clean and with every
corruption of ``tests/test_analysis_verify.py`` (genome bits, embedded IR,
costs, group counts, an unschedulable forged genome, store objects edited
under their key or torn).  Then that file's artifact-mode tests on the port
(the verifier still imports neither ``core.fusion`` nor
``costmodel.evaluator``), the parts the port refuses (a spacemap summary,
the ``tpu`` cost model), and ``tests/test_report.py``'s schedule report,
whose text must equal the reference's.
"""
import dataclasses
import json

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.analysis as RA
import repro.search as rs
import repro.serve as rv
from repro.core.graph import Layer as RefLayer
from repro.core.graph import LayerGraph as RefGraph
from repro_torch.analysis import verify_artifact, verify_store
from repro_torch.analysis.bounds import (graph_bound, group_bound,
                                         onchip_words_for)
from repro_torch.analysis.verify import _GraphView
from repro_torch.core.fusion import FusionState
from repro_torch.core.graph import Layer, LayerGraph
from repro_torch.search import (RegistryError, ScheduleArtifact,
                                SearchSession, build_accelerator, search)
from repro_torch.search.artifact import graph_fingerprint
from repro_torch.serve import ArtifactStore


def chain(G, n=4, name="chain"):
    g = G.LayerGraph(name)
    prev = g.add(G.Layer(name="input", kind="input", m=8, p=16, q=16))
    for i in range(n):
        prev = g.add(G.Layer(name=f"c{i}", kind="conv", c=8, h=16, w=16,
                             m=8, p=16, q=16, r=3, s=3, padding=(1, 1)),
                     [prev])
    return g


def residual(G, name="residual"):
    g = G.LayerGraph(name)
    i = g.add(G.Layer(name="input", kind="input", m=8, p=16, q=16))
    a = g.add(G.Layer(name="a", kind="conv", c=8, h=16, w=16, m=8, p=16,
                      q=16, r=3, s=3, padding=(1, 1)), [i])
    b = g.add(G.Layer(name="b", kind="conv", c=8, h=16, w=16, m=8, p=16,
                      q=16, r=3, s=3, padding=(1, 1)), [a])
    g.add(G.Layer(name="add", kind="add", c=8, h=16, w=16, m=8, p=16, q=16),
          [a, b])
    return g


def diamond(G):
    g = G.LayerGraph("diamond")
    a = g.add(G.Layer(name="a", kind="conv", c=4, h=8, w=8, m=4, p=8, q=8,
                      r=1, s=1))
    b = g.add(G.Layer(name="b", kind="conv", c=4, h=8, w=8, m=4, p=8, q=8,
                      r=1, s=1), [a])
    c = g.add(G.Layer(name="c", kind="conv", c=4, h=8, w=8, m=4, p=8, q=8,
                      r=1, s=1), [a])
    g.add(G.Layer(name="d", kind="add", c=4, h=8, w=8, m=4, p=8, q=8),
          [b, c])
    return g


class PORT:
    Layer, LayerGraph = Layer, LayerGraph


class REF:
    Layer, LayerGraph = RefLayer, RefGraph


def run_search(graph, backend="ga", **cfg):
    return SearchSession.from_objects(
        graph, build_accelerator("simba"), backend=backend,
        backend_config=cfg, budget=200, device="cpu").run()


def ref_run_search(graph, backend="ga", **cfg):
    return rs.SearchSession.from_objects(
        graph, rs.build_accelerator("simba"), backend=backend,
        backend_config=cfg, budget=200).run()


def verdicts(report) -> dict:
    """Everything a report says: every check row and the certificate."""
    return json.loads(json.dumps(report.to_dict()))


def both_verify(artifact, **kw) -> dict:
    """The port's verdict on ``artifact``, asserted equal to the
    reference's on the same bytes."""
    got = verdicts(verify_artifact(artifact, **kw))
    ref_art = rs.ScheduleArtifact.from_json(artifact.to_json())
    assert got == verdicts(RA.verify_artifact(ref_art, **kw))
    return got


_CLEAN = {}


def clean():
    """One clean embedded-IR artifact from the port (as the reference's
    file makes one)."""
    if "port" not in _CLEAN:
        art = run_search(residual(PORT, "clean_res"), "ga", preset="fast",
                         generations=6)
        assert art.graph_ir is not None
        _CLEAN["port"] = art
    return _CLEAN["port"]


# ---- verdicts against the reference ----------------------------------------------

@pytest.mark.parametrize("backend,cfg", [
    ("ga", {"preset": "fast", "generations": 6}),
    ("island", {"islands": 2}),
    ("exhaustive", {}),
])
@pytest.mark.parametrize("maker", ["port", "ref"])
def test_clean_artifacts_from_both_packages_verify_alike(backend, cfg,
                                                         maker):
    if maker == "port":
        art = run_search(residual(PORT, f"res_{backend}"), backend, **cfg)
    else:
        art = ScheduleArtifact.from_json(ref_run_search(
            residual(REF, f"res_{backend}"), backend, **cfg).to_json())
    v = both_verify(art)
    assert v["ok"], v
    cert = v["certificate"]
    assert cert["gap_vs_schedule"] >= 0 and cert["gap_vs_graph"] >= 0
    assert cert["schedule_lb_words"] >= cert["graph_lb_words"]


@pytest.mark.parametrize("workload,accel", [
    ("mobilenet_v3", "simba"), ("mobilenet_v3", "eyeriss"),
    ("vgg16", "simba@act-32")])
def test_zoo_artifacts_verify_as_the_references(workload, accel):
    kw = dict(budget=150, backend_config={"preset": "fast"})
    mine = search(workload, accel, device="cpu", **kw)
    ref = rs.search(workload, accel, **kw)
    v = both_verify(mine)
    assert v == verdicts(RA.verify_artifact(ref))
    assert v["ok"] and v["certificate"]["gap_vs_graph"] >= 0


def _mutate_ir(artifact, **node_updates):
    ir = dict(artifact.graph_ir)
    ir["nodes"] = [dict(n) for n in ir["nodes"]]
    ir["nodes"][1].update(node_updates)
    return dataclasses.replace(artifact, graph_ir=ir)


def _forged_unschedulable(base):
    graph = diamond(PORT)
    cg = graph.compiled()
    fused = {("a", "b"), ("b", "d")}
    mask = sum(1 << i for i, e in enumerate(cg.edge_pairs) if e in fused)
    return dataclasses.replace(
        base,
        spec=base.spec.replace(workload=f"ir:{graph_fingerprint(graph)}"),
        graph_fingerprint=graph_fingerprint(graph),
        graph_ir=graph.to_ir().to_dict(), n_edges=cg.m, genome_mask=mask,
        fused_edges=sorted([u, v] for u, v in fused), group_breakdowns=[])


CORRUPTIONS = {
    "flipped_bit": (lambda a: dataclasses.replace(
        a, genome_mask=a.genome_mask ^ 1), "fused-edges"),
    "out_of_range": (lambda a: dataclasses.replace(
        a, genome_mask=1 << a.n_edges), "edges"),
    "ir_geometry": (lambda a: _mutate_ir(a, m=999), "fingerprint"),
    "ir_unparseable": (lambda a: _mutate_ir(a, kind="warp"), "graph-source"),
    "ir_stripped": (lambda a: dataclasses.replace(a, graph_ir=None),
                    "graph-source"),
    "legacy_fingerprint": (lambda a: dataclasses.replace(
        a, graph_fingerprint="sha256:" + "0" * 64,
        spec=a.spec.replace(workload="ir:sha256:" + "0" * 64)),
        "fingerprint"),
    "inflated_cost": (lambda a: dataclasses.replace(
        a, best=dataclasses.replace(
            a.best, dram_read_words=a.best.dram_read_words * 3)),
        "cost-consistency"),
    "deflated_cost": (lambda a: dataclasses.replace(
        a, group_breakdowns=[], best=dataclasses.replace(
            a.best, dram_read_words=1, dram_write_words=0)), "bounds"),
    "wrong_group_count": (lambda a: dataclasses.replace(
        a, best=dataclasses.replace(a.best, n_groups=a.best.n_groups + 1)),
        "groups"),
    "unschedulable": (_forged_unschedulable, "schedulable"),
}


@pytest.mark.parametrize("name", list(CORRUPTIONS))
def test_corrupted_artifacts_get_the_references_verdict(name):
    corrupt, failing = CORRUPTIONS[name]
    v = both_verify(corrupt(clean()))
    assert not v["ok"]
    row = next(c for c in v["checks"] if c["name"] == failing)
    assert not row["ok"], v


@settings(max_examples=20, deadline=None)
@given(bit=st.integers(min_value=0, max_value=1 << 30))
def test_flipping_any_genome_bit_is_rejected(bit):
    art = clean()
    flipped = dataclasses.replace(
        art, genome_mask=art.genome_mask ^ (1 << (bit % art.n_edges)))
    report = verify_artifact(flipped)
    assert not report.ok
    assert not report.check("fused-edges").ok, report.describe()


def test_specific_diagnostics():
    assert "hashes to" in verify_artifact(_mutate_ir(
        clean(), m=999)).check("fingerprint").detail
    assert "embedded" in verify_artifact(dataclasses.replace(
        clean(), graph_ir=None)).check("graph-source").detail
    legacy = CORRUPTIONS["legacy_fingerprint"][0](clean())
    detail = verify_artifact(legacy).check("fingerprint").detail
    assert "'sha256'" in detail and "regenerate" in detail
    assert "BELOW" in verify_artifact(CORRUPTIONS["deflated_cost"][0](
        clean())).check("bounds").detail
    assert "cycle" in verify_artifact(_forged_unschedulable(
        clean())).check("schedulable").detail


def _store_results(root, package):
    verify = verify_store if package == "port" else RA.verify_store
    return {key: verdicts(rep) for key, rep in verify(root)}


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_verify_store_gives_the_references_verdicts(tmp_path, writer):
    root = str(tmp_path / "st")
    if writer == "port":
        store = ArtifactStore(root)
        key = store.put(run_search(chain(PORT, 3, "store_chain")))
    else:
        store = rv.ArtifactStore(root)
        key = store.put(ref_run_search(chain(REF, 3, "store_chain")))
    got = _store_results(root, "port")
    assert got == _store_results(root, "ref")
    assert got[key]["ok"]
    path = store.path_for(key)
    with open(path) as f:
        d = json.load(f)
    d["spec"]["seed"] = 999                  # the content address moves
    with open(path, "w") as f:
        json.dump(d, f)
    got = _store_results(root, "port")
    assert got == _store_results(root, "ref")
    row = next(c for c in got[key]["checks"] if c["name"] == "store-key")
    assert not got[key]["ok"] and not row["ok"]
    with open(path, "w") as f:
        f.write("{ not json")
    (key2, report), = verify_store(root)
    assert key2 == key and not report.ok
    assert report.checks[0].name == "store-object"
    assert "corrupt" in report.checks[0].detail


# ---- the verifier's own rules -----------------------------------------------------

def test_legality_path_imports_neither_fusion_nor_evaluator():
    import repro_torch.analysis.bounds as bounds
    import repro_torch.analysis.verify as verify
    for mod in (verify, bounds):
        with open(mod.__file__) as f:
            src = f.read()
        imports = [ln for ln in src.splitlines()
                   if ln.lstrip().startswith(("import ", "from "))]
        for ln in imports:
            assert "core.fusion" not in ln, f"{mod.__name__}: {ln}"
            assert "core import fusion" not in ln, f"{mod.__name__}: {ln}"
            assert "costmodel.evaluator" not in ln, f"{mod.__name__}: {ln}"
            assert "costmodel import evaluator" not in ln, \
                f"{mod.__name__}: {ln}"


@settings(max_examples=40, deadline=None)
@given(mask=st.integers(min_value=0, max_value=(1 << 6) - 1),
       which=st.sampled_from(["chain", "residual", "diamond"]))
def test_view_agrees_with_engine_on_random_genomes(mask, which):
    graph = {"chain": chain, "residual": residual, "diamond": diamond}[
        which](PORT)
    m = graph.compiled().m
    mask &= (1 << m) - 1
    view = _GraphView(graph)
    state = FusionState.from_mask(graph, mask)
    assert view.m == m
    derived = [{view.names[i] for i in g} for g in view.groups_of(mask)]
    engine = [set(g) for g in state.groups()]
    assert sorted(map(sorted, derived)) == sorted(map(sorted, engine))
    assert view.condensation_acyclic(view.groups_of(mask)) \
        == state.is_schedulable()


def test_footprint_matches_receptive_module():
    from repro_torch.core.receptive import group_footprint_words
    graph = chain(PORT, 5)
    view = _GraphView(graph)
    members = [view.id_of[n] for n in ("c0", "c1", "c2")]
    for t in (1, 2, 7):
        assert view.footprint_words(members, t) \
            == group_footprint_words(graph, ["c0", "c1", "c2"], t)


def test_bounds_equal_the_references():
    from repro.analysis import bounds as rb
    g, rg = chain(PORT, 2), chain(REF, 2)
    S = 10 ** 6
    for members in (["c0"], ["c0", "c1"], ["input", "c0", "c1"]):
        assert dataclasses.asdict(group_bound(g, members, S)) == \
            dataclasses.asdict(rb.group_bound(rg, members, S))
    assert dataclasses.asdict(graph_bound(g, S)) == \
        dataclasses.asdict(rb.graph_bound(rg, S))
    c0, c1 = g.layers["c0"], g.layers["c1"]
    assert group_bound(g, ["c0"], S).floor_words == \
        c0.weight_size + c0.input_size + c0.output_size
    assert group_bound(g, ["c0", "c1"], S).floor_words == \
        c0.weight_size + c1.weight_size + c0.input_size + c1.output_size
    assert graph_bound(g, S).floor_words == \
        g.total_weights + c1.output_size
    for accel in ("simba", "eyeriss@act+64"):
        assert onchip_words_for("default", accel) == \
            rb.onchip_words_for("default", accel) > 0
    assert onchip_words_for("mystery", "simba") is None


# ---- what the port refuses --------------------------------------------------------

def test_tpu_costmodel_is_refused_not_verified():
    with pytest.raises(RegistryError, match="tpu cost model is not ported"):
        onchip_words_for("tpu", "simba")
    art = dataclasses.replace(clean(), spec=clean().spec.replace(
        costmodel="tpu"))
    with pytest.raises(RegistryError, match="tpu cost model is not ported"):
        verify_artifact(art)


def test_spacemap_artifact_is_refused_not_verified():
    ref = rs.search("unet", "simba", backend="exhaustive", spacemap=True,
                    workload_kwargs={"depth": 1})
    art = ScheduleArtifact.from_json(ref.to_json())
    assert art.spacemap is not None
    with pytest.raises(RegistryError, match="spacemap"):
        verify_artifact(art)


# ---- the schedule report (tests/test_report.py) -----------------------------------

@pytest.mark.parametrize("gens,seed,max_rows", [(10, 0, 0), (5, 1, 4)])
def test_schedule_report_equals_the_references(gens, seed, max_rows):
    from repro.core import GAConfig as RefGAConfig
    from repro.core import optimize
    from repro.core.report import schedule_report as ref_report
    from repro.costmodel import SIMBA as REF_SIMBA
    from repro.workloads import mobilenet_v3_large as ref_mobilenet
    from repro_torch.core.ga import GAConfig
    from repro_torch.core.report import schedule_report
    from repro_torch.costmodel import SIMBA
    from repro_torch.workloads import mobilenet_v3_large
    session = SearchSession.from_objects(
        mobilenet_v3_large(), SIMBA, backend="ga", seed=seed, device="cpu",
        backend_config={"ga_config": GAConfig.fast(generations=gens,
                                                   seed=seed)})
    session.run()
    res = session.schedule_result()
    text = schedule_report(res, SIMBA, max_rows=max_rows)
    ref = optimize(ref_mobilenet(), REF_SIMBA,
                   RefGAConfig.fast(generations=gens, seed=seed))
    assert text == ref_report(ref, REF_SIMBA, max_rows=max_rows)
    assert res.summary() == ref.summary()
    assert "edp x" in text and f"groups={res.best.n_groups}" in text
    if max_rows:
        assert "more groups" in text
    else:
        assert len(text.splitlines()) == res.best.n_groups + 3


def test_breakdown_report_equals_the_references():
    from repro.core.report import breakdown_report as ref_breakdown
    from repro_torch.core.report import breakdown_report
    art = search("mobilenet_v3", "simba", device="cpu", budget=150,
                 backend_config={"preset": "fast"})
    ref = rs.ScheduleArtifact.from_json(art.to_json())
    for rows in (0, 10):
        assert breakdown_report(art.group_breakdowns, max_rows=rows) == \
            ref_breakdown(ref.group_breakdowns, max_rows=rows)
    assert breakdown_report([]) == ref_breakdown([])
