"""`GraphIR` — the serializable, versioned graph interchange format.

A :class:`GraphIR` is the JSON-stable twin of
:class:`repro_torch.core.graph.LayerGraph`: a list of node records (one per
:class:`~repro_torch.core.graph.Layer`, each naming its input nodes in order)
plus the graph's declared outputs.  It is the canonical format everything
speaks at the boundary:

* zoo builders export it (``LayerGraph.to_ir()``), files import it
  (:func:`repro_torch.ir.load`; the reference's JAX tracer has no
  counterpart here yet);
* the search facade fingerprints it — the graph fingerprint embedded in
  every :class:`~repro_torch.search.artifact.ScheduleArtifact` is the sha256 of
  :meth:`GraphIR.canonical_json`;
* artifacts may embed it, making them reproducible without the
  originating registry (``workload: "file:model.json"`` / ``"ir:..."``).

Two serializations, one schema:

* :meth:`to_json` — human-facing file form (indented; every field
  explicit so files diff cleanly);
* :meth:`canonical_json` — compact, sorted-keys, fully-explicit byte
  form.  **This is the fingerprint domain**: it serializes the graph's
  exact structure (node order, input order, geometry), so two graphs
  share a fingerprint iff their compiled edge spaces are identical and a
  genome bitmask can be safely re-bound between them.  The
  *transforming* canonicalization passes (no-op folding, dead-node
  elimination — ``repro_torch.ir.passes``) run at import time, before a graph
  ever reaches a search, never inside the fingerprint.

Hand-written files may omit node fields (defaults apply) and list nodes
in any producer-before-consumer-violating order; :func:`repro_torch.ir.load`
runs the import pipeline that normalizes all of that.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence

from repro_torch.core.graph import Layer, LayerGraph

IR_VERSION = 1

#: node-record keys, beyond ``inputs``, that mirror :class:`Layer` fields
_LAYER_KEYS = tuple(f.name for f in dataclasses.fields(Layer))
_NODE_KEYS = _LAYER_KEYS + ("inputs",)
_PAIR_KEYS = ("stride", "padding", "dilation")


class IRError(ValueError):
    """Malformed IR: unknown fields, bad version, or an unbuildable graph."""


def _layer_to_node(layer: Layer, inputs: Sequence[str]) -> Dict[str, Any]:
    d = dataclasses.asdict(layer)
    for k in _PAIR_KEYS:
        d[k] = list(d[k])
    d["inputs"] = list(inputs)
    return d


def _node_to_layer(node: Dict[str, Any], idx: int) -> Layer:
    if not isinstance(node, dict):
        raise IRError(f"node {idx}: expected an object, got {type(node).__name__}")
    unknown = sorted(set(node) - set(_NODE_KEYS))
    if unknown:
        raise IRError(
            f"node {idx} ({node.get('name', '?')!r}): unknown fields "
            f"{unknown}; valid: {sorted(_NODE_KEYS)}")
    for k in ("name", "kind"):
        if k not in node:
            raise IRError(f"node {idx}: missing required field {k!r}")
    kw = {k: node[k] for k in _LAYER_KEYS if k in node}
    for k in _PAIR_KEYS:
        if k in kw:
            v = kw[k]
            if not (isinstance(v, (list, tuple)) and len(v) == 2):
                raise IRError(
                    f"node {idx} ({node['name']!r}): {k} must be a "
                    f"2-element list, got {v!r}")
            kw[k] = (int(v[0]), int(v[1]))
    try:
        return Layer(**kw)
    except (ValueError, TypeError) as e:
        raise IRError(f"node {idx} ({node['name']!r}): {e}") from None


@dataclass
class GraphIR:
    """A serializable layer graph: ordered node records + declared outputs.

    ``nodes`` are plain dicts (the JSON shape); ``outputs`` lists the node
    names whose tensors the model produces — the liveness roots for
    dead-node elimination (empty = every sink is an output).
    """

    name: str
    nodes: List[Dict[str, Any]] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)
    version: int = IR_VERSION

    # ---- conversion -----------------------------------------------------------
    @classmethod
    def from_graph(cls, graph: LayerGraph) -> "GraphIR":
        """Exact IR of ``graph`` (insertion order, full geometry); outputs
        are the graph's declared ``outputs`` when set (multi-head models
        keep non-sink outputs through round-trips), else its sinks."""
        nodes = [_layer_to_node(graph.layers[nm], graph.preds(nm))
                 for nm in graph.layers]
        outputs = list(getattr(graph, "outputs", None) or
                       (nm for nm in graph.layers if not graph.succs(nm)))
        return cls(name=graph.name, nodes=nodes, outputs=outputs)

    def build(self) -> LayerGraph:
        """Materialize a :class:`LayerGraph` (nodes must already be in
        producer-before-consumer order — :func:`repro_torch.ir.load` guarantees
        it; raises :class:`IRError` otherwise)."""
        g = LayerGraph(self.name)
        for i, node in enumerate(self.nodes):
            layer = _node_to_layer(node, i)
            try:
                g.add(layer, node.get("inputs", []))
            except ValueError as e:
                raise IRError(
                    f"node {i} ({layer.name!r}): {e} — run "
                    f"repro_torch.ir.canonicalize() (or load()) to topo-sort "
                    f"imported IR first") from None
        missing = [o for o in self.outputs if o not in g.layers]
        if missing:
            raise IRError(f"outputs name unknown nodes {missing}")
        if self.outputs:
            g.outputs = list(self.outputs)
        return g

    # ---- serialization --------------------------------------------------------
    def to_dict(self, *, explicit: bool = True) -> Dict[str, Any]:
        """JSON-ready dict.  ``explicit=True`` (the default, and the only
        form this module ever writes) fills every node field so the dict
        is canonical-ready; parsers still accept sparse hand-written
        nodes via :meth:`from_dict`."""
        nodes = self.nodes
        if explicit:
            nodes = [_layer_to_node(_node_to_layer(n, i),
                                    n.get("inputs", []))
                     for i, n in enumerate(nodes)]
        return {
            "ir_version": self.version,
            "name": self.name,
            "nodes": nodes,
            "outputs": list(self.outputs),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "GraphIR":
        if not isinstance(d, dict):
            raise IRError(f"expected a JSON object, got {type(d).__name__}")
        unknown = sorted(set(d) - {"ir_version", "name", "nodes", "outputs"})
        if unknown:
            raise IRError(f"unknown GraphIR fields {unknown}; valid: "
                          f"['ir_version', 'name', 'nodes', 'outputs']")
        v = d.get("ir_version")
        if v != IR_VERSION:
            raise IRError(f"unsupported ir_version {v!r} "
                          f"(this build reads version {IR_VERSION})")
        if "name" not in d or "nodes" not in d:
            raise IRError("GraphIR requires 'name' and 'nodes'")
        if not isinstance(d["nodes"], list):
            raise IRError("'nodes' must be a list of node objects")
        bad = next((i for i, n in enumerate(d["nodes"])
                    if not isinstance(n, dict)), None)
        if bad is not None:
            raise IRError(f"node {bad}: expected an object, got "
                          f"{type(d['nodes'][bad]).__name__}")
        return cls(name=d["name"], nodes=[dict(n) for n in d["nodes"]],
                   outputs=list(d.get("outputs", [])), version=v)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "GraphIR":
        try:
            payload = json.loads(text)
        except json.JSONDecodeError as e:
            raise IRError(f"not valid JSON: {e}") from None
        return cls.from_dict(payload)

    # ---- identity -------------------------------------------------------------
    def canonical_json(self) -> str:
        """The canonical byte form: compact, sorted keys, every node field
        explicit.  Equal strings <=> identical searched structure."""
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    #: fingerprint-format tag: ``ir1`` = sha256 over the version-1
    #: canonical IR JSON.  Pre-``repro_torch.ir`` artifacts carry ``sha256:``
    #: fingerprints (a different payload) — the tag makes the formats
    #: distinguishable so stale artifacts fail with a clear error instead
    #: of a generic mismatch.
    FINGERPRINT_FORMAT = "ir1"

    def fingerprint(self) -> str:
        """sha256 over :meth:`canonical_json` (tagged with
        :attr:`FINGERPRINT_FORMAT`) — *the* graph fingerprint artifacts
        embed and the schedule store keys on."""
        return self.FINGERPRINT_FORMAT + ":" + hashlib.sha256(
            self.canonical_json().encode()).hexdigest()

    def __repr__(self) -> str:
        return (f"GraphIR({self.name!r}, {len(self.nodes)} nodes, "
                f"{len(self.outputs)} outputs)")
