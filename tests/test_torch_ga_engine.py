"""The port's population engine (CPU) against the reference's, exactly.

``repro_torch.core.population.PopulationEvaluator`` on the CPU (its label
pass the plain PyTorch version of ``csrc/ga_labels.cu``) must give the
``group_labels``, ``schedulable_masks`` and ``fitness_masks`` (all four
objectives, float64 equality) of the reference's numpy engine on the same
graphs and genome masks, mirroring ``tests/test_population_engine.py``:
random DAGs and MobileNet-v3, the multi-group cycle residue, group spans
over 52, the python rows path of graphs over 1024 nodes, ``MIN_BATCH``
routing, the scalar path (``pop_engine="off"``) and a fixed-seed GA run.
"""
import random

import numpy as np
import pytest
import torch

import repro.core.graph as rg
import repro_torch.core.graph as tg
from repro.core.fusion import FusionState as RefState
from repro.costmodel import SIMBA as REF_SIMBA
from repro.costmodel import Evaluator as RefEvaluator
from repro_torch.core.fusion import FusionState
from repro_torch.core.population import MIN_BATCH
from repro_torch.costmodel import SIMBA, Evaluator
from repro_torch.kernels.ga_labels.ops import ga_labels

OBJECTIVES = ("edp", "energy", "cycles", "dram")


def _conv(G, name, c, hw, m, k=3):
    return G.Layer(name=name, kind="conv", c=c, h=hw, w=hw, m=m, p=hw, q=hw,
                   r=k, s=k, padding=(k // 2, k // 2))


def _add(G, name, hw=8):
    return G.Layer(name=name, kind="add", c=4, h=hw, w=hw, m=4, p=hw, q=hw)


def _random_dag(G, seed):
    rng = random.Random(seed)
    hw, ch = 8, 4
    g = G.LayerGraph("rand")
    names = [g.add(G.Layer(name="in", kind="input", m=ch, p=hw, q=hw))]
    for i in range(rng.randint(4, 9)):
        prev = names[-1]
        extra = rng.randint(0, len(names) - 1)
        cname = g.add(_conv(G, f"c{i}", ch, hw, ch, rng.choice([1, 3])),
                      [prev])
        if names[extra] != prev and rng.random() < 0.5:
            cname = g.add(_add(G, f"a{i}"), [cname, names[extra]])
        names.append(cname)
    return g


def _chain(G, n, hw):
    g = G.LayerGraph(f"chain{n}")
    prev = g.add(G.Layer(name="in", kind="input", m=4, p=hw, q=hw))
    for i in range(n):
        prev = g.add(_conv(G, f"c{i}", 4, hw, 4, k=1), [prev])
    return g


def _residue(G):
    """The reference test's two fused groups whose condensation cycles
    although each is cycle-free alone."""
    g = G.LayerGraph("residue")
    l0 = g.add(G.Layer(name="n0", kind="input", m=4, p=8, q=8))
    l1 = g.add(_conv(G, "n1", 4, 8, 4), [l0])
    l2 = g.add(_conv(G, "n2", 4, 8, 4), [l0])
    l3 = g.add(_conv(G, "n3", 4, 8, 4), [l1])
    g.add(_add(G, "n4"), [l1, l2])
    g.add(_add(G, "n5"), [l2, l3])
    return g


def _mobilenet(G):
    if G is rg:
        from repro.workloads import mobilenet_v3_large
    else:
        from repro_torch.workloads import mobilenet_v3_large
    return mobilenet_v3_large()


def _masks(name, m, cg):
    rng = random.Random(len(name))
    if name == "residue":
        fuse = lambda *es: sum(1 << cg.edge_id[e] for e in es)  # noqa: E731
        cyc = fuse(("n1", "n4"), ("n2", "n5"), ("n3", "n5"))
        return [cyc, fuse(("n1", "n4")), 0, cyc] * 5
    if name == "chain_small":
        return list(range(1 << m))
    masks = [rng.getrandbits(m) for _ in range(30)]
    return masks + masks[:8] + [0, (1 << m) - 1]


GRAPHS = {
    **{f"random{s}": (lambda G, s=s: _random_dag(G, s)) for s in range(4)},
    "mobilenet_v3": _mobilenet,
    "residue": _residue,
    "chain_small": lambda G: _chain(G, 5, 8),
    "span_over_52": lambda G: _chain(G, 60, 64),
    "rows_path_1040": lambda G: _chain(G, 1040, 4),
}


@pytest.mark.parametrize("name", list(GRAPHS))
def test_engine_matches_reference_engine(name):
    ref_g, g = GRAPHS[name](rg), GRAPHS[name](tg)
    cg = g.compiled()
    masks = _masks(name, cg.m, cg)
    ref = RefEvaluator(ref_g, REF_SIMBA).population(backend="numpy")
    pe = Evaluator(g, SIMBA, device="cpu").population()
    assert np.array_equal(pe.group_labels(masks), ref.group_labels(masks))
    assert np.array_equal(pe.schedulable_masks(masks),
                          ref.schedulable_masks(masks))
    for obj in OBJECTIVES:
        assert np.array_equal(pe.fitness_masks(masks, obj),
                              ref.fitness_masks(masks, obj))
    st, rst = pe.stats(), ref.stats()
    assert st["backend"] == "torch" and st["label_launches"] == 0
    for key in ("batches", "states_scored", "group_table_rows",
                "residue_checks"):
        assert st[key] == rst[key]
    if name == "residue":
        assert st["residue_checks"] > 0
    # the canonical scalar path agrees, as in the reference
    if cg.n <= 100:
        scalar = Evaluator(g, SIMBA, device="cpu")
        fits = pe.fitness_masks(masks, "edp")
        for mk, f in zip(masks, fits):
            assert f == scalar._fitness_fast(FusionState.from_mask(g, mk),
                                             "edp")


def test_labels_match_the_scalar_states_on_mobilenet():
    g = _mobilenet(tg)
    cg = g.compiled()
    rng = random.Random(11)
    masks = [rng.getrandbits(cg.m) for _ in range(40)]
    lab = Evaluator(g, SIMBA, device="cpu").population().group_labels(masks)
    for i, mk in enumerate(masks):
        want = list(range(cg.n))
        for gm in FusionState.from_mask(g, mk).group_masks():
            for u in range(cg.n):
                if gm >> u & 1:
                    want[u] = (gm & -gm).bit_length() - 1
        assert lab[i].tolist() == want


def test_small_batches_use_scalar_path():
    g = _mobilenet(tg)
    ev = Evaluator(g, SIMBA, device="cpu")
    states = [FusionState.from_mask(g, 1 << i) for i in range(MIN_BATCH - 1)]
    fits = ev.fitness_batch(states, "edp")
    assert ev.cache_stats()["pop_batches"] == 0      # engine never engaged
    ref_g = _mobilenet(rg)
    ref = RefEvaluator(ref_g, REF_SIMBA)
    assert fits == ref.fitness_batch(
        [RefState.from_mask(ref_g, 1 << i) for i in range(MIN_BATCH - 1)],
        "edp")
    ev.fitness_batch([FusionState.from_mask(g, 1 << i)
                      for i in range(MIN_BATCH)], "edp")
    assert ev.cache_stats()["pop_batches"] == 1
    assert ev.cache_stats()["pop_backend"] == "torch"


def test_engine_off_and_device_choice():
    g = _mobilenet(tg)
    assert Evaluator(g, SIMBA, device="cpu", pop_engine="off"
                     ).cache_stats()["pop_backend"] == "off"
    with pytest.raises(ValueError, match="pop_engine"):
        Evaluator(g, SIMBA, device="cpu", pop_engine="numpy")


def test_engine_label_pass_goes_through_the_wrapper(monkeypatch):
    """Every batch runs the label pass once, through ``ga_labels``, with
    the graph's tables on the engine's device."""
    calls = []

    def spy(bits, tables):
        calls.append((tuple(bits.shape), bits.dtype, tables.n))
        return ga_labels(bits, tables)

    spy.launches = 0                  # the wrapper's count (CUDA only)
    import repro_torch.core.population as pop
    monkeypatch.setattr(pop, "ga_labels", spy)
    g = _mobilenet(tg)
    cg = g.compiled()
    pe = Evaluator(g, SIMBA, device="cpu").population()
    masks = list(range(1, 41))
    pe.fitness_masks(masks, "edp")
    pe.fitness_masks(masks[:20], "energy")
    assert calls == [((40, cg.m), torch.uint8, cg.n),
                     ((20, cg.m), torch.uint8, cg.n)]


@pytest.mark.parametrize("engine", [None, "off"])
def test_fixed_seed_ga_matches_reference(engine):
    """A short GA on mobilenet_v3: the engine and the scalar path give the
    reference's genome, fitness trajectory and counts (the reference test
    pins 0x10080410000c0004005c4a, 1.2808320767908055)."""
    from repro_torch.core import FusionProblem, GAConfig, run_ga_problem
    g = _mobilenet(tg)
    ev = Evaluator(g, SIMBA, device="cpu", pop_engine=engine)
    res = run_ga_problem(FusionProblem(g, ev, "edp"),
                         GAConfig.paper(seed=0, generations=10))
    assert hex(res.best_state.mask) == "0x10080410000c0004005c4a"
    assert res.best_fitness == 1.2808320767908055
    stats = ev.cache_stats()
    assert stats["pop_backend"] == (engine or "torch")
    assert (stats["pop_batches"] > 0) == (engine is None)
