"""Import-time canonicalization passes over :class:`~repro_torch.ir.graph_ir.GraphIR`.

Imported graphs (hand-written JSON, JAX traces) arrive in whatever shape
their author produced: nodes out of topological order, identity glue the
tracer could not fold, subgraphs feeding nothing.  The pipeline
normalizes all of that *before* the graph reaches a search:

    canonicalize = topo_sort -> fold_noops -> eliminate_dead -> validate

Each pass is ``GraphIR -> GraphIR`` (pure; input unmodified) and the
pipeline is idempotent — canonicalizing a canonical graph is a no-op, so
zoo graphs (already topological, glue-free, fully live) round-trip
through export/import with byte-identical canonical JSON and therefore
unchanged fingerprints.

These passes run in the *importer*, never in the fingerprint:
:meth:`GraphIR.fingerprint` hashes the exact structure a search indexes
its genome against (see ``repro_torch.ir.graph_ir``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Set

from repro_torch.ir.graph_ir import GraphIR, IRError


def topo_sort(ir: GraphIR) -> GraphIR:
    """Stable topological reorder (producers before consumers).

    Ready nodes are emitted in original-index order, so an already-sorted
    graph comes back in the same order.  Raises :class:`IRError` on
    duplicate names, unknown inputs, or cycles.
    """
    names = [n.get("name") for n in ir.nodes]
    seen: Dict[str, int] = {}
    for i, nm in enumerate(names):
        if not isinstance(nm, str) or not nm:
            raise IRError(f"node {i}: missing/empty 'name'")
        if nm in seen:
            raise IRError(f"duplicate node name {nm!r} (nodes {seen[nm]} "
                          f"and {i})")
        seen[nm] = i
    indeg: List[int] = []
    succs: List[List[int]] = [[] for _ in ir.nodes]
    for i, node in enumerate(ir.nodes):
        preds = node.get("inputs", [])
        for p in preds:
            if p not in seen:
                raise IRError(
                    f"node {i} ({names[i]!r}): unknown input {p!r}")
            succs[seen[p]].append(i)
        indeg.append(len(preds))
    import heapq
    ready = [i for i, d in enumerate(indeg) if d == 0]
    heapq.heapify(ready)
    order: List[int] = []
    while ready:
        i = heapq.heappop(ready)
        order.append(i)
        for j in succs[i]:
            indeg[j] -= 1
            if indeg[j] == 0:
                heapq.heappush(ready, j)
    if len(order) != len(ir.nodes):
        stuck = sorted(set(range(len(ir.nodes))) - set(order))
        raise IRError(f"graph {ir.name!r} has a cycle through nodes "
                      f"{[names[i] for i in stuck]}")
    return GraphIR(name=ir.name, nodes=[dict(ir.nodes[i]) for i in order],
                   outputs=list(ir.outputs), version=ir.version)


def _is_noop(node: Dict[str, Any]) -> bool:
    """Identity glue: a single-input pool/upsample/concat whose output
    tensor equals its input tensor (k=1, stride 1, same geometry)."""
    if len(node.get("inputs", [])) != 1:
        return False
    kind = node.get("kind")
    if kind not in ("pool", "upsample", "concat"):
        return False
    g = lambda k, d: node.get(k, d)                    # noqa: E731
    same_shape = (g("m", 0) == g("c", 0) and g("p", 0) == g("h", 0)
                  and g("q", 0) == g("w", 0))
    if kind == "pool":
        return (same_shape and g("r", 1) == 1 and g("s", 1) == 1
                and tuple(g("stride", (1, 1))) == (1, 1))
    return same_shape


def fold_noops(ir: GraphIR) -> GraphIR:
    """Remove identity glue nodes, rewiring consumers (and outputs) to the
    folded node's producer.  A no-op that is itself a declared output is
    kept — folding it would rename the model's result."""
    alias: Dict[str, str] = {}
    outputs = set(ir.outputs)
    kept: List[Dict[str, Any]] = []
    for node in ir.nodes:
        if _is_noop(node) and node["name"] not in outputs:
            src = node["inputs"][0]
            alias[node["name"]] = alias.get(src, src)
            continue
        node = dict(node)
        node["inputs"] = [alias.get(p, p) for p in node.get("inputs", [])]
        kept.append(node)
    return GraphIR(name=ir.name, nodes=kept,
                   outputs=[alias.get(o, o) for o in ir.outputs],
                   version=ir.version)


def eliminate_dead(ir: GraphIR) -> GraphIR:
    """Drop nodes with no path to an output (liveness roots: the declared
    ``outputs``, or every sink when none are declared).  The surviving
    outputs list is normalized to node order; every surviving sink is an
    output, though an output need not be a sink (multi-head models)."""
    idx = {n["name"]: i for i, n in enumerate(ir.nodes)}
    unknown = [o for o in ir.outputs if o not in idx]
    if unknown:
        # a typo'd output must not silently prune the branch (or the
        # whole graph) it was meant to keep alive
        raise IRError(f"graph {ir.name!r}: outputs name unknown nodes "
                      f"{unknown}; known: {sorted(idx)[:10]}...")
    roots = ir.outputs or [
        n["name"] for n in ir.nodes
        if not any(n["name"] in m.get("inputs", []) for m in ir.nodes)]
    live: Set[str] = set()
    stack = list(roots)
    while stack:
        nm = stack.pop()
        if nm in live:
            continue
        live.add(nm)
        stack.extend(ir.nodes[idx[nm]].get("inputs", []))
    nodes = [dict(n) for n in ir.nodes if n["name"] in live]
    root_set = {o for o in roots if o in live}
    return GraphIR(name=ir.name, nodes=nodes,
                   outputs=[n["name"] for n in nodes
                            if n["name"] in root_set],
                   version=ir.version)


def validate(ir: GraphIR) -> GraphIR:
    """Build + shape-check the graph (layer kinds, channel agreement along
    edges — :meth:`LayerGraph.validate`); returns ``ir`` unchanged."""
    try:
        ir.build().validate()
    except IRError:
        raise
    except ValueError as e:
        raise IRError(f"graph {ir.name!r} failed validation: {e}") from None
    return ir


#: the import pipeline, in order
PIPELINE = (topo_sort, fold_noops, eliminate_dead, validate)


def canonicalize(ir: GraphIR) -> GraphIR:
    """Run the full import pipeline; the result builds, validates, and is
    a fixed point of every pass."""
    for p in PIPELINE:
        ir = p(ir)
    return ir
