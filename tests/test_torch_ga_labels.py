"""The port's group-label pass against the reference's, bit for bit.

``repro_torch.kernels.ga_labels.ref.ga_labels_ref`` (the plain PyTorch
version of ``csrc/ga_labels.cu``, and the CPU path of the wrapper) must give
exactly the labels of the reference's numpy engine
(``repro.core.population.PopulationEvaluator._labels_np``) and of its
jitted-JAX label pass (``_build_jax_labels``, jax on the CPU), on the same
genome bits made from a seed with numpy: random DAGs, the zoo graphs
(``vgg16`` has no extra edges), a 60-node chain (group spans over 52),
the reference's 1040-node chain and ``chip_smoke.py``'s 1040-node chain
with skips, each at fused-bit densities 0.1 and 0.5 plus an all-zero and an
all-one row.  The CUDA kernel itself is held against this plain version on
the card by ``chip_smoke.py``.
"""
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core.graph import Layer, LayerGraph
from repro.core.population import (PopulationEvaluator, StaticTables,
                                   _build_jax_labels)
from repro.workloads import build_workload
from repro_torch.kernels.ga_labels.ops import ga_labels
from repro_torch.kernels.ga_labels.ref import ga_labels_ref, label_tables


def _conv(name, c, hw, m, k=3):
    return Layer(name=name, kind="conv", c=c, h=hw, w=hw, m=m, p=hw, q=hw,
                 r=k, s=k, padding=(k // 2, k // 2))


def _random_dag(seed):
    """A random conv DAG of chains and joins, as the reference engine's
    tests draw them (``tests/test_population_engine.py``)."""
    rng = random.Random(seed)
    hw, ch = 8, 4
    g = LayerGraph("rand")
    names = [g.add(Layer(name="in", kind="input", m=ch, p=hw, q=hw))]
    for i in range(rng.randint(4, 12)):
        prev = names[-1]
        extra = rng.randint(0, len(names) - 1)
        cname = g.add(_conv(f"c{i}", ch, hw, ch, rng.choice([1, 3])), [prev])
        if names[extra] != prev and rng.random() < 0.5:
            cname = g.add(Layer(name=f"a{i}", kind="add", c=ch, h=hw, w=hw,
                                m=ch, p=hw, q=hw), [cname, names[extra]])
        names.append(cname)
    return g


def _chain(n, hw=4):
    g = LayerGraph(f"chain{n}")
    prev = g.add(Layer(name="in", kind="input", m=2, p=hw, q=hw))
    for i in range(n):
        prev = g.add(_conv(f"c{i}", 2, hw, 2, k=1), [prev])
    return g


def _chain_with_skips(n, seed):
    """``chip_smoke.chain_with_skips``: a chain with a skip edge (u -> u +
    2..8) from about every third node, as a bare compiled graph."""
    rng = np.random.default_rng(seed)
    edges = {(u, u + 1) for u in range(n - 1)}
    for u in range(0, n - 2, 3):
        edges.add((u, min(n - 1, u + int(rng.integers(2, 9)))))
    eu, ev = zip(*sorted(edges))
    succ = [[] for _ in range(n)]
    for u, v in zip(eu, ev):
        succ[u].append(v)
    return SimpleNamespace(n=n, m=len(eu), eu=eu, ev=ev,
                           succ_ids=tuple(map(tuple, succ)))


def _compiled(name):
    if name.startswith("random"):
        return _random_dag(int(name[6:])).compiled()
    if name == "chain60":
        return _chain(60, hw=64).compiled()
    if name == "chain1040":
        return _chain(1040).compiled()
    if name == "chain1040_skips":
        return _chain_with_skips(1040, seed=5)
    return build_workload(name).compiled()


def _bits(m, rows, seed):
    """rows random genomes at each density 0.1 and 0.5, then an all-zero
    and an all-one row: (2 * rows + 2, m) uint8."""
    rng = np.random.default_rng(seed)
    parts = [(rng.random((rows, m)) < d) for d in (0.1, 0.5)]
    parts += [np.zeros((1, m), bool), np.ones((1, m), bool)]
    return np.concatenate(parts).astype(np.uint8)


GRAPHS = [f"random{s}" for s in range(6)] + [
    "mobilenet_v3", "resnet50", "vgg16", "unet", "chain60", "chain1040",
    "chain1040_skips"]


@pytest.mark.parametrize("name", GRAPHS)
def test_labels_equal_reference_numpy_and_jax(name):
    cg = _compiled(name)
    rows = 8 if cg.n > 500 else 40
    bits = _bits(cg.m, rows, seed=len(name))
    t = StaticTables(cg)
    # the numpy engine's label pass reads only the graph's static tables
    ref_np = PopulationEvaluator._labels_np(SimpleNamespace(t=t), bits
                                            ).reshape(bits.shape[0], cg.n)
    ref_jax = _build_jax_labels(t)(bits)
    assert ref_jax is not None
    tb = label_tables(cg.eu, cg.ev, cg.n, "cpu")
    got = ga_labels_ref(torch.from_numpy(bits), tb)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), ref_np)
    assert np.array_equal(got.numpy().ravel(), ref_jax)
    # the wrapper on a CPU tensor is the plain version, as int32
    out = ga_labels(torch.from_numpy(bits), tb)
    assert out.dtype == torch.int32 and torch.equal(out.long(), got)
    # every node's label is its group's minimum member, which labels itself
    lab = got.numpy()
    assert (lab <= np.arange(cg.n)).all()
    assert np.array_equal(np.take_along_axis(lab, lab, 1), lab)
    assert (lab[-2] == np.arange(cg.n)).all()     # nothing fused


@pytest.mark.parametrize("name", ["mobilenet_v3", "resnet50", "vgg16"])
def test_label_tables_split_edges_as_the_reference(name):
    cg = _compiled(name)
    t = StaticTables(cg)
    tb = label_tables(cg.eu, cg.ev, cg.n, "cpu")
    assert (tb.n, tb.m) == (cg.n, cg.m)
    for field in ("chain_nodes", "chain_eids", "extra_eids", "xu", "xv"):
        got = getattr(tb, field)
        assert got.dtype == torch.int32 and got.is_contiguous()
        assert np.array_equal(got.numpy(), getattr(t, field))
    assert (tb.xu.numel() == 0) == (name == "vgg16")


def test_wrapper_refuses_devices_it_has_no_kernel_for():
    cg = _compiled("resnet50")
    tb = label_tables(cg.eu, cg.ev, cg.n, "cpu")
    bits = torch.zeros(4, cg.m, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ga_labels(bits, tb)


def _groups(cg, row) -> np.ndarray:
    """Min-member labels of the connected components of a row's fused
    edges (union-find)."""
    par = list(range(cg.n))

    def find(x):
        while par[x] != x:
            par[x] = par[par[x]]
            x = par[x]
        return x

    for k in np.nonzero(row)[0]:
        a, b = find(cg.eu[k]), find(cg.ev[k])
        par[max(a, b)] = min(a, b)
    return np.array([find(x) for x in range(cg.n)])


@pytest.mark.parametrize("name", ["mobilenet_v3", "resnet50", "unet",
                                  "vgg16"])
def test_zoo_labels_are_the_groups(name):
    """On the zoo graphs the reference's labels (and so the port's) are
    each group's minimum member: 2002 genomes a graph."""
    cg = _compiled(name)
    bits = _bits(cg.m, 1000, seed=3)
    tb = label_tables(cg.eu, cg.ev, cg.n, "cpu")
    got = ga_labels_ref(torch.from_numpy(bits), tb).numpy()
    for r in range(bits.shape[0]):
        assert np.array_equal(got[r], _groups(cg, bits[r]))


def test_labels_follow_the_reference_where_it_splits_a_group():
    """The reference's rounds can hook a label that is no longer a root and
    cut its link, so on some genomes of a chain with dense skips its labels
    split a group that a fused chain edge joins (not the connected
    components; ROADMAP queue C).  The port gives the reference's labels
    there too: the rows are found here, not assumed."""
    cg = _chain_with_skips(1040, seed=5)
    bits = _bits(cg.m, 1000, seed=7)          # ~1% of rows at 0.5 split
    ref = PopulationEvaluator._labels_np(SimpleNamespace(t=StaticTables(cg)),
                                         bits).reshape(bits.shape[0], cg.n)
    eu, ev = np.asarray(cg.eu), np.asarray(cg.ev)
    split = [r for r in range(bits.shape[0])
             if (ref[r, eu[bits[r] == 1]] != ref[r, ev[bits[r] == 1]]).any()]
    assert split, "no row shows the reference's split groups"
    assert all(not np.array_equal(ref[r], _groups(cg, bits[r]))
               for r in split)
    tb = label_tables(cg.eu, cg.ev, cg.n, "cpu")
    got = ga_labels_ref(torch.from_numpy(bits), tb).numpy()
    assert np.array_equal(got, ref)
