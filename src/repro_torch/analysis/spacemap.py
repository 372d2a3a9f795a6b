"""Static fusion-space analysis: freeze decided genes, factorize regions.

The GA (and every other backend) searches the full ``2^E`` edge-bitmask
space, yet many fusion edges are *statically decidable* from the graph
geometry and the machine's activation capacity alone — before any search:

``forced_off``
    No grouping containing this edge fits the activation buffer.  Proved
    with a per-edge footprint **lower bound** valid for *every* group the
    edge could belong to (see :func:`edge_footprint_lb`), evaluated with
    the verifier's own receptive-field recurrence
    (:class:`repro_torch.analysis.verify._GraphView`), not the engine's.  A
    forced-off gene can be frozen out of the genome: any genome setting
    it scores fitness 0 under any objective.
``free``
    Fusing can never break capacity (the *maximal* possible group
    footprint in the edge's region fits the buffer) and the edge's
    boundary-tensor saving upper bound is positive — flipping the gene
    on is always capacity-legal and potentially profitable.
``undecided``
    Everything else: the search must decide.

On top of the classification the DAG factorizes into **independent
regions**: node ids are topological by construction and every edge runs
from a lower id to a higher id, so a position ``p`` with *no* fusable
edge ``(u, v)`` satisfying ``u < p <= v`` is a frontier no fused group
can span — every legal schedule spills the tensors crossing it.  Groups
are therefore confined to regions, all cross-frontier condensation edges
point rightward (no cycle can cross a cut), and the evaluator's cost is
the layerwise baseline plus per-group corrections — additive across
regions.  Hence: a genome is valid iff each region's restriction is
valid, and exhaustive search may enumerate ``2^{k_r}`` masks per region
and compose winners instead of ``2^{sum k_r}`` globally (ROADMAP open
item 5(b): VGG-16's raw 2^21 space factorizes into per-region spaces of
at most 2^3 here).

Isolation pin (same as :mod:`repro_torch.analysis.verify`, enforced by the
``import-boundary`` lint rule and ``tests/test_spacemap.py``): this
module imports **neither** ``repro_torch.core.fusion`` **nor**
``repro_torch.costmodel.evaluator`` — the classifier that prunes the engine's
search space shares no code with the engine it prunes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.analysis.verify import _act_capacity, _GraphView
from repro_torch.core.graph import LayerGraph

#: the three per-edge verdicts
CLASSES = ("forced_off", "free", "undecided")


@dataclass(frozen=True)
class EdgeVerdict:
    """One edge's static classification with its numeric evidence."""

    index: int                      # genome bit position
    producer: str
    consumer: str
    verdict: str                    # one of CLASSES
    #: sound lower bound on any containing group's t=1 footprint (words);
    #: 0 when the edge can form a non-tiled (single-MAC) pair
    footprint_lb_words: int
    #: upper bound on the DRAM words fusing this edge could save
    saving_ub_words: int

    def to_dict(self) -> Dict[str, Any]:
        return {
            "index": self.index,
            "producer": self.producer,
            "consumer": self.consumer,
            "verdict": self.verdict,
            "footprint_lb_words": self.footprint_lb_words,
            "saving_ub_words": self.saving_ub_words,
        }


@dataclass(frozen=True)
class Region:
    """A maximal node-id interval no fusable edge crosses out of."""

    index: int
    lo: int                         # first node id (inclusive)
    hi: int                         # last node id (inclusive)
    nodes: Tuple[str, ...]
    edge_indices: Tuple[int, ...]   # fusable genome bits confined here

    @property
    def size(self) -> int:
        return 1 << len(self.edge_indices)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "index": self.index,
            "lo": self.lo,
            "hi": self.hi,
            "nodes": list(self.nodes),
            "edge_indices": list(self.edge_indices),
        }


@dataclass
class SpaceMap:
    """The static search-space map for one (graph, costmodel, accelerator).

    ``frozen`` genes (the forced-off bits) are excluded from mutation /
    crossover / enumeration when a search opts in via
    ``SearchSpec(spacemap=True)``; ``regions`` partition the remaining
    genes into independently-enumerable intervals.
    """

    graph_name: str
    costmodel: str
    accelerator: str
    n_edges: int
    capacity_words: Optional[int]   # None: unknown costmodel, nothing frozen
    capacity_how: str
    verdicts: List[EdgeVerdict] = field(default_factory=list)
    regions: List[Region] = field(default_factory=list)

    # ---- derived views ---------------------------------------------------------
    @property
    def forced_off(self) -> List[EdgeVerdict]:
        return [v for v in self.verdicts if v.verdict == "forced_off"]

    @property
    def free(self) -> List[EdgeVerdict]:
        return [v for v in self.verdicts if v.verdict == "free"]

    @property
    def undecided(self) -> List[EdgeVerdict]:
        return [v for v in self.verdicts if v.verdict == "undecided"]

    @property
    def frozen_indices(self) -> Tuple[int, ...]:
        """Genome bits provably useless to search (ascending)."""
        return tuple(v.index for v in self.forced_off)

    @property
    def frozen_mask(self) -> int:
        m = 0
        for i in self.frozen_indices:
            m |= 1 << i
        return m

    @property
    def active_indices(self) -> Tuple[int, ...]:
        """Genome bits the search still decides (ascending)."""
        frozen = set(self.frozen_indices)
        return tuple(i for i in range(self.n_edges) if i not in frozen)

    @property
    def genome_length(self) -> int:
        return len(self.active_indices)

    def raw_space_size(self) -> int:
        return 1 << self.n_edges

    def masked_space_size(self) -> int:
        """Genomes left after freezing forced-off bits."""
        return 1 << self.genome_length

    def factorized_states(self) -> int:
        """States an exhaustive per-region enumeration actually scores:
        ``sum_r 2^{k_r}`` instead of ``prod_r 2^{k_r}``."""
        return sum(r.size for r in self.regions)

    def largest_region_size(self) -> int:
        return max((r.size for r in self.regions), default=1)

    # ---- serialization ---------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        """The compact artifact-embeddable form ``repro verify``
        re-derives and compares (no per-edge rows: those re-derive)."""
        return {
            "n_edges": self.n_edges,
            "capacity_words": self.capacity_words,
            "forced_off": [v.index for v in self.forced_off],
            "free": [v.index for v in self.free],
            "regions": [[r.lo, r.hi] for r in self.regions],
            "genome_length": self.genome_length,
            "factorized_states": self.factorized_states(),
        }

    def to_dict(self) -> Dict[str, Any]:
        return {
            "graph": self.graph_name,
            "costmodel": self.costmodel,
            "accelerator": self.accelerator,
            "capacity_words": self.capacity_words,
            "capacity_how": self.capacity_how,
            "edges": [v.to_dict() for v in self.verdicts],
            "regions": [r.to_dict() for r in self.regions],
            "summary": self.summary(),
        }

    def describe(self) -> str:
        """The ``repro analyze`` table: per-edge verdicts, regions,
        genome-length reduction, exact/GA search-space sizes."""
        lines: List[str] = []
        lines.append(f"spacemap: {self.graph_name} on {self.accelerator} "
                     f"(costmodel {self.costmodel})")
        lines.append(f"capacity: {self.capacity_how}")
        w = max((len(f"{v.producer} -> {v.consumer}")
                 for v in self.verdicts), default=10)
        lines.append(f"  {'bit':>3}  {'edge':<{w}}  {'verdict':<10}  "
                     f"{'footprint_lb':>12}  {'saving_ub':>10}")
        for v in self.verdicts:
            lines.append(
                f"  {v.index:>3}  "
                f"{v.producer + ' -> ' + v.consumer:<{w}}  "
                f"{v.verdict:<10}  {v.footprint_lb_words:>12}  "
                f"{v.saving_ub_words:>10}")
        n = len(self.verdicts)
        lines.append(
            f"edges: {n} total — {len(self.forced_off)} forced_off, "
            f"{len(self.free)} free, {len(self.undecided)} undecided")
        lines.append(
            f"genome: {self.n_edges} -> {self.genome_length} bits "
            f"({len(self.frozen_indices)} frozen)")
        lines.append(f"regions: {len(self.regions)} independent")
        for r in self.regions:
            span = f"{r.nodes[0]} .. {r.nodes[-1]}" if len(r.nodes) > 1 \
                else r.nodes[0]
            lines.append(f"  region {r.index}: nodes [{r.lo}..{r.hi}] "
                         f"({span}), {len(r.edge_indices)} free bits, "
                         f"2^{len(r.edge_indices)} states")
        lines.append(
            f"search space: 2^{self.n_edges} raw = {self.raw_space_size()}"
            f" -> 2^{self.genome_length} masked = "
            f"{self.masked_space_size()} -> {self.factorized_states()} "
            f"states enumerated per-region (largest region "
            f"{self.largest_region_size()})")
        return "\n".join(lines)


# ---- the static classifier -------------------------------------------------------


def _rows_in_clamped(view: _GraphView, i: int, rows_out: int) -> int:
    """Input rows node ``i``'s layer needs for ``rows_out`` output rows,
    via the verifier's recurrence (already clamps to full height)."""
    return view._rows_in(view.layers[i], rows_out)


def edge_footprint_lb(view: _GraphView, bit: int) -> int:
    """Sound lower bound (words) on the t=1 footprint of **any** group
    containing fused edge ``bit`` = ``(u, v)``.

    Three nonnegative contributions every containing group pays:

    * ``v`` holds at least one output row (``rows[v] >= 1``);
    * ``u`` holds at least ``v``'s one-row input window — ``v`` is always
      an in-group consumer of ``u``, and the recurrence's ``need`` is a
      max over in-group consumers, so ``rows[u] >= min(rows_in(v, 1),
      p_u)`` whatever else the group contains;
    * any predecessor ``p`` of ``u`` whose *only* graph consumer is ``u``
      is either an in-group member (held at >= ``u``'s window) or an
      external input staged at exactly ``u``'s window (``u`` is then its
      first — only — in-group consumer), so its window contribution is
      mandatory either way.

    Deeper ancestors are *not* counted: a node outside the group with its
    consumer also outside contributes nothing, so only the first
    off-group hop is guaranteed.  The bound is therefore conservative —
    exactly what freezing a gene requires.
    """
    u, v = view.edges[bit]
    lu, lv = view.layers[u], view.layers[v]
    total = 0
    if lv.output_size:
        total += lv.m * lv.q * min(1, lv.p or 1)
    rin_v = _rows_in_clamped(view, v, 1)
    ru = min(rin_v, lu.p) if lu.p else rin_v
    if lu.output_size:
        total += lu.m * lu.q * ru
    win_u = _rows_in_clamped(view, u, ru)
    for p in view.preds[u]:
        lp = view.layers[p]
        if view.succs[p] == [u] and lp.output_size:
            total += lp.m * lp.q * min(win_u, lp.p or win_u)
    return total


def _region_footprint_ub(view: _GraphView, nodes: List[int]) -> int:
    """Upper bound (words) on the t=1 footprint of any group formed
    inside ``nodes``: every member holds at most its full output map and
    every staged external input at most its producer's full map."""
    nset = set(nodes)
    total = 0
    staged = set()
    for i in nodes:
        li = view.layers[i]
        if li.output_size:
            total += li.m * li.q * li.p
        for p in view.preds[i]:
            if p in nset or p in staged:
                continue
            staged.add(p)
            lp = view.layers[p]
            if lp.output_size:
                total += lp.m * lp.q * lp.p
    return total


def edge_saving_ub(view: _GraphView, bit: int) -> int:
    """Upper bound on DRAM words fusing edge ``(u, v)`` can save: the
    producer's boundary tensor stops crossing DRAM (one write plus one
    read per consumer); an ``input`` placeholder's tensor saves the
    consumer's staged read instead."""
    u, v = view.edges[bit]
    lu = view.layers[u]
    if view.costed(u):
        if not lu.output_size:
            return 0
        return lu.output_size * (1 + len(view.succs[u]))
    return view.layers[v].input_size


def _cut_positions(view: _GraphView, fusable: List[int]) -> List[int]:
    """Positions ``p`` (between node ``p-1`` and ``p``) no fusable edge
    spans: ``0`` and ``n`` are always cuts; interior cuts are where every
    crossing edge is frozen (or absent), so no group can straddle them."""
    crossed = [False] * (view.n + 1)
    for i in fusable:
        u, v = view.edges[i]
        for p in range(u + 1, v + 1):
            crossed[p] = True
    return [p for p in range(view.n + 1)
            if p == 0 or p == view.n or not crossed[p]]


def build_spacemap(graph: LayerGraph, costmodel: str = "default",
                   accelerator: str = "simba") -> SpaceMap:
    """Derive the :class:`SpaceMap` for ``graph`` on ``accelerator``
    under ``costmodel``'s capacity rule.

    Unknown costmodels (no static capacity semantics) degrade safely:
    nothing is frozen, nothing is ``free``, and the whole graph is one
    region — the map is then a no-op for search.
    """
    view = _GraphView(graph)
    cap, cap_how = _act_capacity(costmodel, accelerator)

    verdicts: List[EdgeVerdict] = []
    for bit, (u, v) in enumerate(view.edges):
        lb = 0
        saving = edge_saving_ub(view, bit)
        verdict = "undecided"
        if cap is not None:
            # only a pair of MAC-carrying endpoints makes every containing
            # group "multi" (hence footprint-checked by both cost models);
            # otherwise the bare pair itself is legal and nothing freezes
            if view.layers[u].macs and view.layers[v].macs:
                lb = edge_footprint_lb(view, bit)
                if lb > cap:
                    verdict = "forced_off"
        verdicts.append(EdgeVerdict(
            index=bit, producer=view.names[u], consumer=view.names[v],
            verdict=verdict, footprint_lb_words=lb, saving_ub_words=saving))

    fusable = [v.index for v in verdicts if v.verdict != "forced_off"]
    cuts = _cut_positions(view, fusable)
    regions: List[Region] = []
    for ri in range(len(cuts) - 1):
        lo, hi = cuts[ri], cuts[ri + 1] - 1
        edge_idx = tuple(i for i in fusable
                         if lo <= view.edges[i][0] and view.edges[i][1] <= hi)
        regions.append(Region(
            index=ri, lo=lo, hi=hi,
            nodes=tuple(view.names[lo:hi + 1]), edge_indices=edge_idx))

    # "free": capacity can never bite anywhere in the edge's region (the
    # maximal group there fits) and fusing has a positive saving bound
    if cap is not None:
        region_of: Dict[int, Region] = {}
        for r in regions:
            for i in r.edge_indices:
                region_of[i] = r
        ub_cache: Dict[int, int] = {}
        for k, v in enumerate(verdicts):
            if v.verdict != "undecided":
                continue
            r = region_of[v.index]
            if r.index not in ub_cache:
                ub_cache[r.index] = _region_footprint_ub(
                    view, list(range(r.lo, r.hi + 1)))
            if ub_cache[r.index] <= cap and v.saving_ub_words > 0:
                verdicts[k] = EdgeVerdict(
                    index=v.index, producer=v.producer, consumer=v.consumer,
                    verdict="free",
                    footprint_lb_words=v.footprint_lb_words,
                    saving_ub_words=v.saving_ub_words)

    return SpaceMap(
        graph_name=graph.name, costmodel=costmodel, accelerator=accelerator,
        n_edges=view.m, capacity_words=cap, capacity_how=cap_how,
        verdicts=verdicts, regions=regions)
