"""Randomized topological sort (paper §III-C).

The paper uses a topological sort inside the GA to enforce dependency order of
fused subgraphs and of layers within a subgraph; because not every topological
order is unique it selects a *random* valid order ("we select a random primary
graph and its corresponding elements of the subgraph to process").  We
implement Kahn's algorithm with an RNG-driven tie-break so the GA samples the
order space, plus a deterministic mode for tests.
"""
from __future__ import annotations

import random
from typing import Dict, Hashable, Iterable, List, Mapping, Optional, Sequence, Tuple


class CycleError(ValueError):
    pass


def topological_sort_edges(
    nodes: Sequence[Hashable],
    edges: Iterable[Tuple[Hashable, Hashable]],
    rng: Optional[random.Random] = None,
) -> List[Hashable]:
    """Kahn's algorithm over explicit (u, v) edges restricted to ``nodes``.

    With ``rng`` given, ready-set ties are broken uniformly at random; without,
    insertion order is kept (deterministic).
    Raises :class:`CycleError` if the subgraph has a cycle.
    """
    nodeset = set(nodes)
    indeg: Dict[Hashable, int] = {n: 0 for n in nodes}
    succ: Dict[Hashable, List[Hashable]] = {n: [] for n in nodes}
    for u, v in edges:
        if u in nodeset and v in nodeset:
            succ[u].append(v)
            indeg[v] += 1

    ready = [n for n in nodes if indeg[n] == 0]
    order: List[Hashable] = []
    while ready:
        i = rng.randrange(len(ready)) if rng is not None else 0
        n = ready.pop(i)
        order.append(n)
        for v in succ[n]:
            indeg[v] -= 1
            if indeg[v] == 0:
                ready.append(v)
    if len(order) != len(nodeset):
        raise CycleError(f"cycle among {sorted(nodeset - set(order))!r}")
    return order


def acyclic_indices(succ: Sequence[Sequence[int]]) -> bool:
    """Kahn cycle check over integer nodes ``0..len(succ)-1``.

    ``succ[u]`` lists successors of ``u``; parallel (duplicate) edges are
    allowed — they inflate in-degrees symmetrically, so the check stays exact.
    This is the allocation-light path used by the incremental fusion engine's
    condensation test (no dicts, no string hashing).
    """
    n = len(succ)
    indeg = [0] * n
    for vs in succ:
        for v in vs:
            indeg[v] += 1
    stack = [i for i in range(n) if indeg[i] == 0]
    seen = 0
    while stack:
        u = stack.pop()
        seen += 1
        for v in succ[u]:
            indeg[v] -= 1
            if indeg[v] == 0:
                stack.append(v)
    return seen == n


def member_order_ids(succ_ids: Sequence[Sequence[int]], ids: Sequence[int]
                     ) -> List[int]:
    """Deterministic Kahn order of the subgraph induced by ``ids`` (ascending
    node ids), over precompiled integer adjacency.

    Delegates to :func:`topological_sort_edges` with ``rng=None`` — the exact
    ready-queue discipline and tie-breaks — so float accumulations done in
    this order are bit-identical to the string-based reference path (the
    callee filters the edge stream to the node set itself).
    """
    return topological_sort_edges(
        ids, ((u, v) for u in ids for v in succ_ids[u]))


def topological_sort(graph, rng: Optional[random.Random] = None) -> List[str]:
    """Topological order of a :class:`repro_torch.core.graph.LayerGraph`."""
    return topological_sort_edges(graph.names, graph.edges, rng)


def is_topological(order: Sequence[Hashable],
                   edges: Iterable[Tuple[Hashable, Hashable]]) -> bool:
    pos = {n: i for i, n in enumerate(order)}
    return all(pos[u] < pos[v] for u, v in edges if u in pos and v in pos)
