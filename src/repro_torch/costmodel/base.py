"""The cost-backend protocol: :class:`CostModel` + :class:`CostBreakdown`.

The paper's headline numbers come from holding the *search* fixed and
swapping the *cost side* (machines, mappers).  This module pins that axis
down the same way ``repro_torch.core.problem`` pinned the search side: a
:class:`CostModel` is bound to one (graph, accelerator, energy-model)
triple and answers "what does this fused group cost?" — everything else
(memoization, baseline-plus-corrections batching, fitness) lives in the
model-agnostic :class:`repro_torch.costmodel.evaluator.Evaluator`.

Implementations (registered with ``@repro_torch.search.register_costmodel``):

* ``default`` — :class:`repro_torch.costmodel.default.DefaultCostModel`, the
  paper's mini-Timeloop mapper (dataflow utilization, buffer-capacity
  tiling, LPDDR4 traffic);
* ``tpu``     — :class:`repro_torch.costmodel.tpu_fusion.TpuFusionCostModel`,
  the TPU retarget's three-term roofline over the same fusion genomes.

A group's answer is a declarative :class:`CostBreakdown` — named totals
plus per-component energy terms — rather than an ad-hoc positional tuple,
so artifacts can store per-group breakdowns and ``repro report`` can show
where energy/cycles go without re-running the model.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import (Any, Dict, FrozenSet, List, Mapping, Optional, Sequence,
                    Tuple, Union)

from repro_torch.core.graph import Layer, LayerGraph
from repro_torch.costmodel.accelerator import Accelerator
from repro_torch.costmodel.energy import DEFAULT_ENERGY, EnergyModel
from repro_torch.costmodel.mapper import LayerCost

#: a group's identity: member node-bitmask (fast engine) or frozenset of
#: layer names (reference engine) — see ``repro_torch.core.fusion``
GroupKey = Union[int, FrozenSet[str]]

#: scalar totals tuple consumed by the evaluator's hot caches:
#: (energy_pj, cycles, dram_read_words, dram_write_words,
#:  act_write_events, macs) — or None when the group is infeasible
GroupTotals = Optional[Tuple[float, float, int, int, int, int]]


@dataclass(frozen=True)
class CostBreakdown:
    """Declarative cost of one scheduled group.

    ``energy_terms`` names the components summed into ``energy_pj``
    (``mac``/``rf``/``act_buf``/``weight_buf``/``noc``/``dram`` for the
    default model); ``compute_cycles``/``dram_cycles`` keep both sides of
    the overlap visible (``cycles`` is their max, paper §IV).
    ``tile_rows``/``weight_passes`` record the mapping decisions that
    produced the numbers (0/1 for single-layer groups).
    """

    energy_pj: float
    compute_cycles: float
    dram_cycles: float
    dram_read_words: int
    dram_write_words: int
    act_write_events: int
    macs: int
    members: Tuple[str, ...] = ()
    tile_rows: int = 0
    weight_passes: int = 1
    utilization: float = 1.0
    energy_terms: Mapping[str, float] = field(default_factory=dict)

    @property
    def cycles(self) -> float:
        # compute/DRAM overlap across the group pipeline (paper §IV)
        return max(self.compute_cycles, self.dram_cycles)

    @property
    def edp(self) -> float:
        return self.energy_pj * self.cycles

    def totals(self) -> Tuple[float, float, int, int, int, int]:
        """The evaluator's scalar cache record."""
        return (self.energy_pj, self.cycles, self.dram_read_words,
                self.dram_write_words, self.act_write_events, self.macs)

    # ---- serialization (artifact storage) --------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "members": list(self.members),
            "energy_pj": self.energy_pj,
            "compute_cycles": self.compute_cycles,
            "dram_cycles": self.dram_cycles,
            "dram_read_words": self.dram_read_words,
            "dram_write_words": self.dram_write_words,
            "act_write_events": self.act_write_events,
            "macs": self.macs,
            "tile_rows": self.tile_rows,
            "weight_passes": self.weight_passes,
            "utilization": self.utilization,
            "energy_terms": dict(self.energy_terms),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CostBreakdown":
        return cls(
            energy_pj=d["energy_pj"],
            compute_cycles=d["compute_cycles"],
            dram_cycles=d["dram_cycles"],
            dram_read_words=d["dram_read_words"],
            dram_write_words=d["dram_write_words"],
            act_write_events=d["act_write_events"],
            macs=d["macs"],
            members=tuple(d.get("members", ())),
            tile_rows=d.get("tile_rows", 0),
            weight_passes=d.get("weight_passes", 1),
            utilization=d.get("utilization", 1.0),
            energy_terms=dict(d.get("energy_terms", {})),
        )


class CostModel:
    """Cost-backend contract: bound to one (graph, accelerator, energy
    model) triple, answers per-layer and per-group cost queries.

    Subclasses must implement :meth:`cost_layer` and :meth:`cost_group`;
    :meth:`batch` has a generic default that models with vectorized
    internals (or remote cost services) may override.  ``cost_group``
    returning ``None`` marks the group infeasible on this machine (the
    paper's "mapping where intermediate storage exceeds capacity is
    discarded as invalid") — the evaluator turns that into fitness 0.
    """

    #: registry name (``repro_torch.search.register_costmodel``)
    name: str = "costmodel"

    def __init__(self, graph: LayerGraph, acc: Accelerator,
                 em: EnergyModel = DEFAULT_ENERGY):
        self.graph = graph
        self.cg = graph.compiled()
        self.acc = acc
        self.em = em

    @property
    def clock_hz(self) -> float:
        """Clock converting the model's cycle counts to seconds."""
        return self.acc.clock_mhz * 1e6

    # ---- required surface -------------------------------------------------------
    def cost_layer(self, layer: Layer, *, inputs_offchip: bool = True,
                   outputs_offchip: bool = True,
                   weight_stream_passes: int = 1) -> LayerCost:
        """Cost one layer under explicit DRAM-boundary flags (the fusion
        scheduler's lever)."""
        raise NotImplementedError

    def cost_group(self, key: GroupKey) -> Optional[CostBreakdown]:
        """Cost one fused group (``None`` = infeasible on this machine).

        ``key`` identifies the member set: an int node-bitmask from the
        incremental engine or a frozenset of layer names from the
        reference engine.  Both must be supported and must produce
        bit-identical numbers (``tests/test_fusion_equivalence.py``).
        """
        raise NotImplementedError

    # ---- optional surface -------------------------------------------------------
    def batch(self, keys: Sequence[GroupKey]
              ) -> List[Optional[CostBreakdown]]:
        """Cost many groups at once; override when the model can amortize
        (vectorized math, one RPC to a cost service, ...)."""
        return [self.cost_group(k) for k in keys]

    # ---- shared helpers ---------------------------------------------------------
    def member_names(self, key: GroupKey) -> List[str]:
        """Group members in topological order, for either key form."""
        from repro_torch.core.fusion import iter_bits
        from repro_torch.core.toposort import member_order_ids, \
            topological_sort_edges
        if isinstance(key, int):
            order = member_order_ids(self.cg.succ_ids, list(iter_bits(key)))
            return [self.cg.names[i] for i in order]
        return topological_sort_edges(
            [n for n in self.graph.names if n in key], self.graph.edges)
