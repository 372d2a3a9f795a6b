"""Layer-graph IR for CNN workloads (paper §II, §III-A).

A model is a DAG of :class:`Layer` nodes.  Edges carry activation tensors; the
fusion scheduler (``repro_torch.core.fusion``) decides, per edge, whether that tensor
stays on-chip (*fused*) or round-trips DRAM (*split*).

Tensor-size conventions follow the paper's notation (Fig. 1):
  input  C x H x W, weights M x C x R x S, output M x P x Q.
All sizes are in *words* (16-bit by default, matching the paper's edge setting).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

# Layer kinds that carry weights / MACs.
_COMPUTE_KINDS = ("conv", "dwconv", "fc")
# Kinds that only reshape/merge activations (no weights, negligible MACs).
_GLUE_KINDS = ("input", "add", "concat", "pool", "upsample", "global_pool", "mul")


@dataclass(frozen=True)
class Layer:
    """One node of the computation graph.

    For ``conv``-like kinds the full (C,H,W) -> (M,P,Q) geometry is kept so the
    receptive-field backtrace (paper §III-B, Fig. 5) can size fused tiles.
    """

    name: str
    kind: str                      # conv | dwconv | fc | pool | add | concat | ...
    c: int = 0                     # input channels  (C)
    h: int = 0                     # input height    (H)
    w: int = 0                     # input width     (W)
    m: int = 0                     # output channels (M)
    p: int = 0                     # output height   (P)
    q: int = 0                     # output width    (Q)
    r: int = 1                     # filter height   (R)
    s: int = 1                     # filter width    (S)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    dilation: Tuple[int, int] = (1, 1)
    groups: int = 1

    def __post_init__(self):
        if self.kind not in _COMPUTE_KINDS + _GLUE_KINDS:
            raise ValueError(f"unknown layer kind {self.kind!r} for {self.name!r}")

    # ---- tensor sizes (words) -------------------------------------------------
    @property
    def input_size(self) -> int:
        return self.c * self.h * self.w

    @property
    def output_size(self) -> int:
        return self.m * self.p * self.q

    @property
    def weight_size(self) -> int:
        if self.kind == "conv":
            return self.m * (self.c // self.groups) * self.r * self.s
        if self.kind == "dwconv":
            return self.m * self.r * self.s            # depthwise: one filter/channel
        if self.kind == "fc":
            return self.m * self.c
        return 0

    @property
    def macs(self) -> int:
        if self.kind == "conv":
            return self.m * self.p * self.q * (self.c // self.groups) * self.r * self.s
        if self.kind == "dwconv":
            return self.m * self.p * self.q * self.r * self.s
        if self.kind == "fc":
            return self.m * self.c
        if self.kind in ("add", "mul"):
            return self.output_size                    # 1 op per element
        return 0

    @property
    def has_weights(self) -> bool:
        return self.weight_size > 0


class CompiledGraph:
    """A :class:`LayerGraph` frozen into integer arrays for the GA hot path.

    Node ids are positions in insertion order (a valid topological order by
    construction); edge ids are positions in ``LayerGraph.edges`` order.  All
    adjacency is precomputed so fusion-state operations never rebuild
    ``graph.edges``/``preds``/``succs`` or hash strings.
    """

    __slots__ = ("graph", "n", "m", "names", "id_of", "layers", "edge_pairs",
                 "edge_id", "eu", "ev", "succ_ids", "pred_ids", "inc",
                 "out_size", "weight_size", "macs", "p")

    def __init__(self, graph: "LayerGraph"):
        self.graph = graph
        names = tuple(graph.layers)
        self.names = names
        self.n = len(names)
        self.id_of = {nm: i for i, nm in enumerate(names)}
        self.layers = tuple(graph.layers[nm] for nm in names)
        # dedupe parallel edges (e.g. an `add` consuming the same producer
        # twice): the genome is a *set* of fused pairs, so duplicates must
        # share one bit or one logical genome would have several masks
        pairs = tuple(dict.fromkeys(
            (u, v) for u, vs in graph._succ.items() for v in vs))
        self.edge_pairs = pairs
        self.m = len(pairs)
        self.edge_id = {e: i for i, e in enumerate(pairs)}
        self.eu = tuple(self.id_of[u] for u, _ in pairs)
        self.ev = tuple(self.id_of[v] for _, v in pairs)
        self.succ_ids = tuple(tuple(self.id_of[v] for v in graph._succ[nm])
                              for nm in names)
        self.pred_ids = tuple(tuple(self.id_of[v] for v in graph._pred[nm])
                              for nm in names)
        inc: List[List[Tuple[int, int]]] = [[] for _ in range(self.n)]
        for i in range(self.m):
            inc[self.eu[i]].append((i, self.ev[i]))
            inc[self.ev[i]].append((i, self.eu[i]))
        self.inc = tuple(tuple(xs) for xs in inc)
        self.out_size = tuple(l.output_size for l in self.layers)
        self.weight_size = tuple(l.weight_size for l in self.layers)
        self.macs = tuple(l.macs for l in self.layers)
        self.p = tuple(l.p for l in self.layers)


class LayerGraph:
    """A DAG of layers.  Node order of ``layers`` is a valid topological order
    by construction (builders add producers before consumers)."""

    def __init__(self, name: str):
        self.name = name
        self.layers: Dict[str, Layer] = {}
        self._succ: Dict[str, List[str]] = {}
        self._pred: Dict[str, List[str]] = {}
        self._compiled: "CompiledGraph" = None
        #: declared model outputs (None = every sink).  Carried so graphs
        #: built from IR with non-sink outputs (multi-head models) keep
        #: them through a to_ir() round-trip instead of collapsing to
        #: sinks and changing the fingerprint.
        self.outputs: "List[str]" = None

    # ---- construction ---------------------------------------------------------
    def add(self, layer: Layer, inputs: Sequence[str] = ()) -> str:
        if layer.name in self.layers:
            raise ValueError(f"duplicate layer {layer.name!r}")
        for src in inputs:
            if src not in self.layers:
                raise ValueError(f"unknown producer {src!r} for {layer.name!r}")
        self.layers[layer.name] = layer
        self._succ[layer.name] = []
        self._pred[layer.name] = list(inputs)
        for src in inputs:
            self._succ[src].append(layer.name)
        self._compiled = None                        # adjacency changed
        return layer.name

    def compiled(self) -> CompiledGraph:
        """Frozen integer-array view; rebuilt lazily after any :meth:`add`."""
        if self._compiled is None:
            self._compiled = CompiledGraph(self)
        return self._compiled

    # ---- queries ---------------------------------------------------------------
    def preds(self, name: str) -> List[str]:
        return self._pred[name]

    def succs(self, name: str) -> List[str]:
        return self._succ[name]

    @property
    def edges(self) -> List[Tuple[str, str]]:
        return [(u, v) for u, vs in self._succ.items() for v in vs]

    @property
    def names(self) -> List[str]:
        return list(self.layers)

    def compute_layers(self) -> List[str]:
        return [n for n, l in self.layers.items() if l.kind in _COMPUTE_KINDS]

    @property
    def total_macs(self) -> int:
        return sum(l.macs for l in self.layers.values())

    @property
    def total_weights(self) -> int:
        return sum(l.weight_size for l in self.layers.values())

    # ---- IR interchange --------------------------------------------------------
    def to_ir(self):
        """This graph as serializable :class:`repro_torch.ir.GraphIR` (exact:
        node order, input order, and geometry are preserved verbatim)."""
        from repro_torch.ir import GraphIR                 # lazy: ir imports us
        return GraphIR.from_graph(self)

    @staticmethod
    def from_ir(ir) -> "LayerGraph":
        """Materialize a :class:`repro_torch.ir.GraphIR` (accepts the IR object,
        its dict form, or its JSON text)."""
        from repro_torch.ir import GraphIR
        if isinstance(ir, str):
            ir = GraphIR.from_json(ir)
        elif isinstance(ir, dict):
            ir = GraphIR.from_dict(ir)
        return ir.build()

    def validate(self) -> None:
        """Check DAG-ness and tensor-shape agreement along every edge."""
        from repro_torch.core.toposort import topological_sort  # local import, no cycle

        topological_sort(self)                       # raises on cycles
        for u, v in self.edges:
            lu, lv = self.layers[u], self.layers[v]
            if lu.kind == "input" or lv.kind in ("add", "concat", "mul"):
                continue                              # glue nodes checked loosely
            if lu.m and lv.c and lv.kind in _COMPUTE_KINDS and len(self._pred[v]) == 1:
                ok = lv.c in (lu.m, lu.m * max(lu.p, 1) * max(lu.q, 1))
                if not ok:                     # fc consumers flatten (m*p*q)
                    raise ValueError(
                        f"channel mismatch {u}({lu.m}) -> {v}({lv.c}) in {self.name}")

    def __repr__(self):
        return (f"LayerGraph({self.name!r}, {len(self.layers)} layers, "
                f"{self.total_macs/1e6:.1f} MMACs, {self.total_weights/1e6:.2f} MWords)")
