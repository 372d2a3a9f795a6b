"""``repro_torch.ir`` — the serializable graph IR and its import pipeline
(the port's copy of ``repro/ir``; its tracer reads PyTorch programs).

A CNN is a *document* — a versioned, JSON-serializable :class:`GraphIR`
that anything can produce and everything downstream (search, cost,
serving, artifacts) consumes:

    import repro_torch.ir as ir

    graph = ir.load("model.json").build()          # file -> LayerGraph
    ir.save(graph, "model.json")                   # LayerGraph -> file

    gir = ir.from_torch(model, (x,), name="my_cnn")  # code -> IR

    # or through the facade, with no Python at all:
    #   python -m repro_torch search --workload file:model.json --accel simba

Pieces:

* :class:`GraphIR` (``graph_ir.py``) — the schema: ordered node records
  mirroring :class:`repro_torch.core.graph.Layer`, each naming its inputs,
  plus declared outputs.  ``canonical_json()``/``fingerprint()`` define
  the byte-stable identity every artifact and store key uses, byte-equal
  to the reference's.
* ``passes.py`` — the import pipeline (:func:`canonicalize` =
  topo-sort -> fold no-op glue -> dead-node elimination -> validate),
  idempotent, applied to everything entering from outside.
* ``trace.py`` — :func:`~repro_torch.ir.trace.from_torch`, the counterpart
  of the reference's ``from_jax``: a ``torch.fx`` walker mapping conv2d /
  linear / pooling / elementwise ops onto the same Layer kinds and node
  names.

``load``/``loads`` canonicalize; ``GraphIR.from_graph`` (and
``LayerGraph.to_ir``) are exact and run no passes — fingerprints always
describe the structure a genome actually indexes.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple, Union

from repro_torch.core.graph import LayerGraph

from repro_torch.ir.graph_ir import IR_VERSION, GraphIR, IRError
from repro_torch.ir.passes import (PIPELINE, canonicalize, eliminate_dead,
                                   fold_noops, topo_sort, validate)


def loads(text: str) -> GraphIR:
    """Parse GraphIR JSON and run the import pipeline (canonicalized,
    validated — ready to ``build()``)."""
    return canonicalize(GraphIR.from_json(text))


def load(path: str) -> GraphIR:
    """Read a GraphIR JSON file and run the import pipeline."""
    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        raise IRError(f"cannot read workload IR {path!r}: {e}") from None
    try:
        return loads(text)
    except IRError as e:
        raise IRError(f"{path}: {e}") from None


def save(obj: Union[GraphIR, LayerGraph], path: str) -> None:
    """Write a graph (or IR) as GraphIR JSON (human-indented form)."""
    ir = GraphIR.from_graph(obj) if isinstance(obj, LayerGraph) else obj
    with open(path, "w") as f:
        f.write(ir.to_json())


def fingerprint(obj: Union[GraphIR, LayerGraph]) -> str:
    """The canonical structural fingerprint (see
    :meth:`GraphIR.fingerprint`)."""
    ir = GraphIR.from_graph(obj) if isinstance(obj, LayerGraph) else obj
    return ir.fingerprint()


def from_torch(module: Callable[..., Any], example_inputs: Tuple[Any, ...],
               *, name: str = "traced_cnn") -> GraphIR:
    """Trace a PyTorch module or function into canonical GraphIR (see
    :mod:`repro_torch.ir.trace`; imports ``torch.fx`` lazily)."""
    from repro_torch.ir.trace import from_torch as _from_torch
    return _from_torch(module, example_inputs, name=name)


__all__ = [
    "GraphIR", "IRError", "IR_VERSION", "PIPELINE", "canonicalize",
    "eliminate_dead", "fingerprint", "fold_noops", "from_torch", "load",
    "loads", "save", "topo_sort", "validate",
]
