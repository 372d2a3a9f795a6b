"""The port's graph IR import pipeline (``repro_torch.ir``: ``passes.py``,
``load``/``loads``/``save``) and ``file:`` workloads on the CPU, against
the reference's.

The first part is the part of ``tests/test_ir.py`` that covers them (its
``TestFromJax`` tracer has no counterpart in the port), with the port's
modules and every search on ``device="cpu"``.  The second part holds the
port to the reference on the same inputs: canonical JSON and fingerprints
of the reference's IR fixtures and of hand-shuffled documents, ``export``
of every zoo workload byte-equal to ``python -m repro export``'s, a
``file:`` search's artifact equal to the reference's and to the zoo run's
genome, fitness and evaluations, and the ``file:`` golden constants of
``chip_smoke.py``'s phase 8.
"""
import json

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import repro_torch.ir as ir
from repro_torch.core.graph import Layer, LayerGraph
from repro_torch.costmodel import SIMBA
from repro_torch.ir import GraphIR, IRError, canonicalize
from repro_torch.search import (SearchSession, WorkloadParamError,
                                build_workload, graph_fingerprint)
from repro_torch.workloads import mobilenet_v3_large, resnet50, unet, vgg16


def small_chain(n=5, c0=3, hw=16) -> LayerGraph:
    g = LayerGraph("small_chain")
    prev = g.add(Layer(name="input", kind="input", m=c0, p=hw, q=hw))
    c = c0
    for i in range(n):
        prev = g.add(Layer(name=f"conv{i}", kind="conv", c=c, h=hw, w=hw,
                           m=8, p=hw, q=hw, r=3, s=3, padding=(1, 1)),
                     [prev])
        c = 8
    return g


@pytest.mark.parametrize("builder,kw", [
    (vgg16, {"hw": 64}), (unet, {"hw": 64}),
    (mobilenet_v3_large, {}), (resnet50, {}),
])
def test_zoo_round_trip_preserves_structure_and_fingerprint(builder, kw):
    g = builder(**kw)
    text = g.to_ir().to_json()
    g2 = ir.loads(text).build()
    assert graph_fingerprint(g2) == graph_fingerprint(g)
    assert g2.compiled().edge_pairs == g.compiled().edge_pairs
    assert [tuple(sorted(l.__dict__.items())) for l in g2.layers.values()] \
        == [tuple(sorted(l.__dict__.items())) for l in g.layers.values()]
    # export of a canonical graph is byte-stable (file: round-trips clean)
    assert ir.loads(text).build().to_ir().to_json() == text


def test_from_ir_accepts_json_dict_and_object():
    g = small_chain()
    gir = g.to_ir()
    for form in (gir, gir.to_dict(), gir.to_json()):
        assert graph_fingerprint(LayerGraph.from_ir(form)) \
            == graph_fingerprint(g)


_KINDS = ("conv", "dwconv", "fc", "pool", "add", "concat", "upsample",
          "global_pool", "mul", "input")


@st.composite
def graph_irs(draw):
    """Arbitrary (not necessarily shape-consistent) DAGs in node order —
    the serialization layer must round-trip anything structurally sane."""
    n = draw(st.integers(min_value=1, max_value=8))
    nodes = []
    for i in range(n):
        n_in = 0 if i == 0 else draw(st.integers(min_value=0, max_value=2))
        inputs = sorted({f"n{draw(st.integers(min_value=0, max_value=i - 1))}"
                         for _ in range(n_in)}) if i else []
        node = {"name": f"n{i}", "kind": draw(st.sampled_from(_KINDS)),
                "inputs": inputs}
        if draw(st.booleans()):
            node["c"] = draw(st.integers(min_value=0, max_value=512))
            node["h"] = draw(st.integers(min_value=0, max_value=64))
        if draw(st.booleans()):
            node["stride"] = [draw(st.integers(min_value=1, max_value=3))] * 2
        nodes.append(node)
    return GraphIR(name="rand", nodes=nodes, outputs=[f"n{n - 1}"])


@settings(max_examples=40, suppress_health_check=[HealthCheck.too_slow])
@given(graph_irs())
def test_hypothesis_serialize_parse_serialize_bit_stable(gir):
    text = gir.to_json()
    again = GraphIR.from_json(text)
    assert again.to_json() == text
    assert again.fingerprint() == gir.fingerprint()
    assert GraphIR.from_json(again.to_json()).canonical_json() \
        == gir.canonical_json()


def test_ir_rejects_unknown_fields_and_bad_version():
    g = small_chain(2)
    d = g.to_ir().to_dict()
    with pytest.raises(IRError, match="ir_version"):
        GraphIR.from_dict({**d, "ir_version": 99})
    with pytest.raises(IRError, match="unknown GraphIR fields"):
        GraphIR.from_dict({**d, "turbo": 1})
    bad = {**d, "nodes": [{**d["nodes"][0], "flux": 3}]}
    with pytest.raises(IRError, match="unknown fields"):
        GraphIR.from_dict(bad).build()
    with pytest.raises(IRError, match="expected an object"):
        GraphIR.from_dict({**d, "nodes": [3]})
    with pytest.raises(IRError, match="not valid JSON"):
        GraphIR.from_json("{nope")


def test_topo_sort_is_stable_and_fixes_order():
    g = small_chain(4)
    gir = g.to_ir()
    assert ir.topo_sort(gir).nodes == gir.nodes      # already sorted: no-op
    shuffled = GraphIR(name=gir.name, nodes=list(reversed(gir.nodes)),
                       outputs=gir.outputs)
    sorted_ir = ir.topo_sort(shuffled)
    assert [n["name"] for n in sorted_ir.nodes] \
        == [n["name"] for n in gir.nodes]
    # and the unsorted form cannot build directly
    with pytest.raises(IRError, match="topo-sort"):
        shuffled.build()


def test_topo_sort_rejects_cycles_and_unknown_inputs():
    nodes = [{"name": "a", "kind": "conv", "inputs": ["b"]},
             {"name": "b", "kind": "conv", "inputs": ["a"]}]
    with pytest.raises(IRError, match="cycle"):
        ir.topo_sort(GraphIR(name="x", nodes=nodes))
    with pytest.raises(IRError, match="unknown input"):
        ir.topo_sort(GraphIR(name="x", nodes=[
            {"name": "a", "kind": "conv", "inputs": ["ghost"]}]))
    with pytest.raises(IRError, match="duplicate"):
        ir.topo_sort(GraphIR(name="x", nodes=[
            {"name": "a", "kind": "conv", "inputs": []},
            {"name": "a", "kind": "conv", "inputs": []}]))


def test_fold_noops_removes_identity_glue():
    g = small_chain(2)
    gir = g.to_ir()
    # splice an identity pool between conv0 and conv1
    id_pool = {"name": "noop", "kind": "pool", "inputs": ["conv0"],
               "c": 8, "h": 16, "w": 16, "m": 8, "p": 16, "q": 16,
               "r": 1, "s": 1, "stride": [1, 1]}
    nodes = []
    for n in gir.nodes:
        nodes.append(dict(n))
        if n["name"] == "conv0":
            nodes.append(id_pool)
    nodes[-1]["inputs"] = ["noop"]
    spliced = GraphIR(name="g", nodes=nodes, outputs=["conv1"])
    folded = canonicalize(spliced)
    assert [n["name"] for n in folded.nodes] \
        == [n["name"] for n in gir.nodes]
    assert folded.build().preds("conv1") == ["conv0"]
    # a real pool (k=2) is NOT folded
    real = dict(id_pool, r=2, s=2, stride=[2, 2], p=8, q=8)
    kept = canonicalize(GraphIR(name="g", nodes=[
        *(dict(n) for n in gir.nodes[:2]), real], outputs=["noop"]))
    assert "noop" in [n["name"] for n in kept.nodes]


def test_eliminate_dead_drops_unreachable_branch():
    g = small_chain(3)
    gir = g.to_ir()
    dead = {"name": "dead_conv", "kind": "conv", "inputs": ["conv0"],
            "c": 8, "h": 16, "w": 16, "m": 4, "p": 16, "q": 16,
            "r": 1, "s": 1}
    spliced = GraphIR(name=gir.name, nodes=[*gir.nodes, dead],
                      outputs=["conv2"])
    pruned = canonicalize(spliced)
    assert "dead_conv" not in [n["name"] for n in pruned.nodes]
    assert pruned.fingerprint() == gir.fingerprint()
    # without declared outputs every sink survives
    assert "dead_conv" in [
        n["name"] for n in
        canonicalize(GraphIR(name=gir.name, nodes=[*gir.nodes,
                                                   dead])).nodes]


def test_eliminate_dead_rejects_unknown_output_names():
    """A typo'd output must raise, not silently prune the branch (or the
    whole graph) it was meant to keep alive."""
    gir = small_chain(3).to_ir()
    with pytest.raises(IRError, match="conv2_typo"):
        canonicalize(GraphIR(name=gir.name, nodes=gir.nodes,
                             outputs=["conv2_typo"]))
    with pytest.raises(IRError, match="aux_typo"):
        ir.loads(GraphIR(name=gir.name, nodes=gir.nodes,
                         outputs=["conv2", "aux_typo"]).to_json())


def test_non_sink_outputs_survive_round_trip():
    """Multi-head models declare an intermediate node as an output; the
    build->export round-trip must keep it (and the fingerprint) intact."""
    gir = small_chain(3).to_ir()
    multi = canonicalize(GraphIR(name=gir.name, nodes=gir.nodes,
                                 outputs=["conv1", "conv2"]))
    assert multi.outputs == ["conv1", "conv2"]
    g = multi.build()
    assert g.outputs == ["conv1", "conv2"]
    again = g.to_ir()
    assert again.outputs == ["conv1", "conv2"]
    assert again.fingerprint() == multi.fingerprint()
    assert ir.loads(multi.to_json()).build().to_ir().to_json() \
        == multi.to_json()
    # and the declared-output set is part of the identity
    assert multi.fingerprint() != gir.fingerprint()


def test_store_key_is_content_addressed_for_file_specs(tmp_path):
    """The same IR document under two filenames is one store object: the
    second submit must be a cache hit, not a second search."""
    from repro_torch.search import SearchSpec
    from repro_torch.serve import ArtifactStore, BatchScheduler
    a, b = tmp_path / "a.json", tmp_path / "sub" / "b.json"
    b.parent.mkdir()
    ir.save(small_chain(), str(a))
    b.write_text(a.read_text())
    store = ArtifactStore(str(tmp_path / "store"))
    cfg = {"evaluations": 5}
    sched = BatchScheduler(store, device="cpu")
    sched.submit(SearchSpec(workload=f"file:{a}", backend="random",
                            backend_config=cfg))
    out1 = sched.run()
    assert out1.jobs[0].outcome == "searched"
    sched2 = BatchScheduler(store, device="cpu")
    sched2.submit(SearchSpec(workload=f"file:{b}", backend="random",
                             backend_config=cfg))
    out2 = sched2.run()
    assert out2.jobs[0].outcome == "cache_hit"
    assert out2.jobs[0].key == out1.jobs[0].key
    assert len(store) == 1
    # and within ONE batch: two paths, same content -> one search
    store2 = ArtifactStore(str(tmp_path / "store2"))
    sched3 = BatchScheduler(store2, device="cpu")
    for path in (a, b):
        sched3.submit(SearchSpec(workload=f"file:{path}",
                                 backend="random", backend_config=cfg))
    out3 = sched3.run()
    assert [j.outcome for j in out3.jobs] == ["searched", "cache_hit"]
    assert sched3.searches_run == 1 and len(store2) == 1


def test_canonicalize_idempotent_on_zoo():
    gir = vgg16(hw=64).to_ir()
    once = canonicalize(gir)
    assert once.canonical_json() == gir.canonical_json()
    assert canonicalize(once).canonical_json() == once.canonical_json()


def test_validate_rejects_channel_mismatch():
    nodes = [{"name": "input", "kind": "input", "m": 3, "p": 8, "q": 8},
             {"name": "c1", "kind": "conv", "inputs": ["input"],
              "c": 3, "h": 8, "w": 8, "m": 8, "p": 8, "q": 8},
             {"name": "c2", "kind": "conv", "inputs": ["c1"],
              "c": 99, "h": 8, "w": 8, "m": 8, "p": 8, "q": 8}]
    with pytest.raises(IRError, match="channel mismatch"):
        canonicalize(GraphIR(name="bad", nodes=nodes))


def test_search_on_reimported_zoo_graph_is_bit_identical():
    """Export->reimport must leave the searched structure untouched: a
    fixed-seed GA over the reimported graph returns the same genome,
    history, and fitness bit-for-bit."""
    g = vgg16(hw=64)
    g2 = ir.loads(g.to_ir().to_json()).build()
    runs = []
    for graph in (g, g2):
        art = SearchSession.from_objects(
            graph, SIMBA, backend="ga", seed=0,
            backend_config={"preset": "fast", "generations": 5},
            device="cpu").run()
        runs.append(art)
    a, b = runs
    assert a.genome_mask == b.genome_mask
    assert a.best_fitness == b.best_fitness
    assert a.history == b.history
    assert a.graph_fingerprint == b.graph_fingerprint
    assert a.spec == b.spec            # ir:<fp> specs agree too


def test_build_workload_file_spec(tmp_path):
    path = tmp_path / "m.json"
    ir.save(small_chain(), str(path))
    g = build_workload(f"file:{path}")
    assert graph_fingerprint(g) == graph_fingerprint(small_chain())
    with pytest.raises(WorkloadParamError, match="no params"):
        build_workload(f"file:{path}", hw=3)
    with pytest.raises(IRError, match="cannot read"):
        build_workload(f"file:{tmp_path / 'ghost.json'}")


def test_file_spec_artifact_embeds_ir_automatically(tmp_path):
    path = tmp_path / "m.json"
    ir.save(small_chain(), str(path))
    from repro_torch.search import search
    art = search(f"file:{path}", "simba", backend="random",
                 backend_config={"evaluations": 5}, device="cpu")
    assert art.graph_ir is not None
    path.unlink()                          # file gone: artifact still works
    assert art.rebuild_state().mask == art.genome_mask


def test_cli_export_file_search_report(tmp_path):
    from repro_torch.__main__ import main
    model = tmp_path / "vgg64.json"
    art = tmp_path / "a.json"
    assert main(["export", "--workload", "vgg16@hw=64",
                 "--out", str(model)]) == 0
    assert main(["search", "--workload", f"file:{model}",
                 "--backend", "random", "--backend-config",
                 '{"evaluations": 10}', "--out", str(art),
                 "--device", "cpu"]) == 0
    assert main(["report", str(art), "--schedule"]) == 0
    # export round-trips byte-identically through file:
    rt = tmp_path / "rt.json"
    assert main(["export", "--workload", f"file:{model}",
                 "--out", str(rt)]) == 0
    assert rt.read_text() == model.read_text()
    # bad spec strings exit 2 with the schema in the message
    assert main(["export", "--workload", "vgg16@res=64",
                 "--out", str(model)]) == 2


# ---- against the reference --------------------------------------------------------

import importlib.util  # noqa: E402
import random  # noqa: E402
from pathlib import Path  # noqa: E402

import repro.ir as rir  # noqa: E402
import repro.search as rs  # noqa: E402
from repro.__main__ import main as ref_main  # noqa: E402
from repro_torch.__main__ import main  # noqa: E402
from repro_torch.search import search  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ZOO = ["vgg16", "unet", "mobilenet_v3", "resnet50"]


def _comparable(art) -> dict:
    d = json.loads(json.dumps(art.to_dict()))
    for key in ("created_unix", "wall_s"):
        del d[key]
    for key in ("batch_time_s", "batch_evals_per_sec", "pop_backend"):
        d["backend_stats"].pop(key, None)
    return d


def _shuffled(workload: str, seed: int) -> str:
    """A zoo graph's document with its nodes in a seeded random order and
    every node's fields in reverse order: what a hand-written file may
    look like."""
    d = json.loads(rs.build_workload(workload).to_ir().to_json())
    nodes = [dict(reversed(list(n.items()))) for n in d["nodes"]]
    random.Random(seed).shuffle(nodes)
    return json.dumps({**d, "nodes": nodes})


def _fixture_docs() -> dict:
    """The documents tests/test_ir.py builds (identity glue, a dead
    branch, declared intermediate outputs, a real pool), from the
    reference's own graph, and shuffled zoo documents."""
    gir = small_chain(3).to_ir()
    nodes = [dict(n) for n in json.loads(gir.to_json())["nodes"]]
    noop = {"name": "noop", "kind": "pool", "inputs": ["conv0"], "c": 8,
            "h": 16, "w": 16, "m": 8, "p": 16, "q": 16, "r": 1, "s": 1,
            "stride": [1, 1]}
    spliced = [*nodes[:2], noop, dict(nodes[2], inputs=["noop"]),
               nodes[3]]
    dead = {"name": "dead_conv", "kind": "conv", "inputs": ["conv0"],
            "c": 8, "h": 16, "w": 16, "m": 4, "p": 16, "q": 16, "r": 1,
            "s": 1}
    real = dict(noop, r=2, s=2, stride=[2, 2], p=8, q=8)
    docs = {
        "noop": {"name": "g", "nodes": spliced, "outputs": ["conv2"]},
        "dead": {"name": "g", "nodes": [*nodes, dead],
                 "outputs": ["conv2"]},
        "dead_no_outputs": {"name": "g", "nodes": [*nodes, dead]},
        "multi_output": {"name": "g", "nodes": nodes,
                         "outputs": ["conv1", "conv2"]},
        "real_pool": {"name": "g", "nodes": [*nodes[:2], real],
                      "outputs": ["noop"]},
        "reversed": {"name": "g", "nodes": nodes[::-1]},
    }
    docs = {k: json.dumps({"ir_version": 1, **v}) for k, v in docs.items()}
    for w in ZOO:
        docs[f"{w}_shuffled"] = _shuffled(w, seed=len(w))
    return docs


DOCS = _fixture_docs()


@pytest.mark.parametrize("name", list(DOCS))
def test_canonicalize_equals_the_references(name):
    mine, ref = ir.loads(DOCS[name]), rir.loads(DOCS[name])
    assert mine.canonical_json() == ref.canonical_json()
    assert mine.fingerprint() == ref.fingerprint()
    assert mine.to_json() == ref.to_json()
    assert ir.loads(mine.to_json()).canonical_json() == \
        mine.canonical_json()                       # idempotent
    if name.endswith("_shuffled"):    # the zoo graph's layers and edges,
        zoo = rs.build_workload(name[:-len("_shuffled")])  # a topo order
        g = mine.build()
        assert sorted(g.edges) == sorted(zoo.edges)
        assert sorted(g.layers) == sorted(zoo.layers)


@pytest.mark.parametrize("doc", [
    {"name": "x", "nodes": [{"name": "a", "kind": "conv", "inputs": ["b"]},
                            {"name": "b", "kind": "conv",
                             "inputs": ["a"]}]},
    {"name": "x", "nodes": [{"name": "a", "kind": "conv",
                             "inputs": ["ghost"]}]},
    {"name": "x", "nodes": [{"name": "input", "kind": "input", "m": 3,
                             "p": 8, "q": 8},
                            {"name": "c1", "kind": "conv", "c": 3, "h": 8,
                             "w": 8, "m": 8, "p": 8, "q": 8,
                             "inputs": ["input"]},
                            {"name": "c2", "kind": "conv", "c": 99, "h": 8,
                             "w": 8, "m": 8, "p": 8, "q": 8,
                             "inputs": ["c1"]}]},
    {"name": "x", "nodes": [{"name": "a", "kind": "input", "m": 3}],
     "outputs": ["typo"]},
], ids=["cycle", "unknown_input", "channel_mismatch", "unknown_output"])
def test_rejected_documents_raise_the_references_errors(doc):
    text = json.dumps({"ir_version": 1, **doc})
    with pytest.raises(rir.IRError) as want:
        rir.loads(text)
    with pytest.raises(IRError) as got:
        ir.loads(text)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("workload", ZOO + ["mobilenet_v3@hw=160",
                                            "unet@hw=64,depth=2"])
def test_export_equals_the_references_byte_for_byte(workload, tmp_path,
                                                    capsys):
    assert main(["export", "--workload", workload, "--out",
                 str(tmp_path / "mine.json")]) == 0
    mine_out = capsys.readouterr().out
    assert ref_main(["export", "--workload", workload, "--out",
                     str(tmp_path / "ref.json")]) == 0
    ref_out = capsys.readouterr().out
    assert (tmp_path / "mine.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()
    assert mine_out.split("\n")[0].replace("mine.json", "ref.json") == \
        ref_out.split("\n")[0]
    # and the exported document imports back byte-identically (file:)
    assert main(["export", "--workload", f"file:{tmp_path / 'mine.json'}",
                 "--out", str(tmp_path / "rt.json")]) == 0
    assert (tmp_path / "rt.json").read_bytes() == \
        (tmp_path / "mine.json").read_bytes()


def test_file_search_equals_the_reference_and_the_zoo_run(tmp_path):
    path = tmp_path / "m.json"
    assert main(["export", "--workload", "mobilenet_v3", "--out",
                 str(path)]) == 0
    kw = dict(accelerator="simba", backend="ga", seed=3,
              backend_config={"preset": "fast", "generations": 8})
    mine = search(f"file:{path}", **kw, device="cpu")
    ref = rs.search(f"file:{path}", **kw)
    zoo = search("mobilenet_v3", **kw, device="cpu")
    assert _comparable(mine) == _comparable(ref)
    assert mine.graph_ir is not None          # file: embeds its IR
    for field in ("genome_mask", "best_fitness", "evaluations",
                  "graph_fingerprint", "history"):
        assert getattr(mine, field) == getattr(zoo, field), field


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_file_run_golden_is_the_references(tmp_path):
    """Phase 8 exports mobilenet_v3 and searches the document with the
    paper GA's spec: the reference's fingerprint of the zoo graph, and the
    reference's ``file:`` run giving phase 6's paper GA golden result, are
    what the card's run is held to; the port's CPU path gives them too."""
    cs = _chip_smoke()
    run = cs.GA_RUNS[cs.FILE_RUN["run"]]
    assert rs.graph_fingerprint(rs.build_workload(run["spec"]["workload"])) \
        == cs.FILE_RUN["fingerprint"]
    path = tmp_path / "m.json"
    rir.save(rs.build_workload(run["spec"]["workload"]), str(path))
    spec = dict(run["spec"], workload=f"file:{path}")
    ref = rs.search(**spec)
    got = {"genome_mask": ref.genome_mask, "best_fitness": ref.best_fitness,
           "evaluations": ref.evaluations}
    assert got == run["golden"]
    assert ref.graph_fingerprint == cs.FILE_RUN["fingerprint"]
    assert _comparable(search(**spec, device="cpu")) == _comparable(ref)
