"""The paper's cost backend: the mini-Timeloop mapper behind the
:class:`~repro_torch.costmodel.base.CostModel` protocol.

This is the group-costing logic that used to live inside
``Evaluator._compute_group_cost_*`` — hoisted verbatim so that (a) the
evaluator is cost-model-agnostic and (b) other backends (TPU roofline,
future calibrated Timeloop runs) plug in behind the same two methods.
Both key forms (node-bitmask / frozenset of names) run the same float
operations in the same order, so costs agree bit-for-bit with each other
*and* with the pre-protocol evaluator (pinned by
``tests/test_fusion_equivalence.py`` and the fixed-seed search pin in
``tests/test_search_api.py``).

Group costing (multi-member groups, paper §IV):

1. largest output-tile height ``t`` whose line-buffer footprint fits the
   activation buffer (``repro_torch.core.receptive``); no feasible ``t`` =>
   infeasible (``None``);
2. if aggregate group weights exceed the weight buffer, weights re-stream
   from DRAM once per tile pass;
3. member layers are costed with intra-group edges kept on-chip; compute
   and DRAM time overlap within the group.
"""
from __future__ import annotations

import math
from typing import FrozenSet, Optional

from repro_torch.core.fusion import iter_bits
from repro_torch.core.graph import Layer
from repro_torch.core.receptive import max_tile_rows
from repro_torch.core.toposort import member_order_ids, topological_sort_edges
from repro_torch.costmodel.base import CostBreakdown, CostModel, GroupKey
from repro_torch.costmodel.mapper import LayerCost, map_layer


class DefaultCostModel(CostModel):
    """Paper §II-A/§IV: dataflow-aware mapping + Accelergy-style energy."""

    name = "default"

    # ---- protocol ---------------------------------------------------------------
    def cost_layer(self, layer: Layer, *, inputs_offchip: bool = True,
                   outputs_offchip: bool = True,
                   weight_stream_passes: int = 1) -> LayerCost:
        return map_layer(layer, self.acc, self.em,
                         inputs_offchip=inputs_offchip,
                         outputs_offchip=outputs_offchip,
                         weight_stream_passes=weight_stream_passes)

    def cost_group(self, key: GroupKey) -> Optional[CostBreakdown]:
        if isinstance(key, int):
            return self._cost_group_mask(key)
        return self._cost_group_members(key)

    def _map_layer_memo(self, i: int, inputs_off: bool, outputs_off: bool,
                        weight_passes: int) -> LayerCost:
        """Per-(layer, boundary flags, weight passes) mapper memo.  A layer's
        mapping depends only on these; across the thousands of groups a
        search costs, the same few hundred combinations recur.  Cached
        :class:`LayerCost` objects are returned as-is — callers only read
        them (``LayerCost.__iadd__`` mutates the accumulator, not its
        operand)."""
        memo = self.__dict__.get("_layer_memo")
        if memo is None:
            memo = self._layer_memo = {}
        k = (i, inputs_off, outputs_off, weight_passes)
        lc = memo.get(k)
        if lc is None:
            lc = memo[k] = map_layer(self.cg.layers[i], self.acc, self.em,
                                     inputs_offchip=inputs_off,
                                     outputs_offchip=outputs_off,
                                     weight_stream_passes=weight_passes)
        return lc

    # ---- internals --------------------------------------------------------------
    def _cost_group_mask(self, gmask: int) -> Optional[CostBreakdown]:
        """Fast path: members given as a node bitmask, order and membership
        tests all on integers."""
        cg = self.cg
        order = member_order_ids(cg.succ_ids, list(iter_bits(gmask)))
        multi = sum(1 for i in order if cg.macs[i]) > 1

        weight_passes = 1
        tile_rows = 0
        if multi and len(order) > 1:
            names_order = [cg.names[i] for i in order]
            t = max_tile_rows(self.graph, names_order, self.acc.act_buf_words)
            if t == 0:
                return None                              # over-capacity: invalid
            tile_rows = t
            group_w = sum(cg.weight_size[i] for i in order)
            if group_w > self.acc.weight_buf_words:
                sink_p = max((cg.p[i] or 1) for i in order)
                weight_passes = math.ceil(sink_p / t)

        total = LayerCost()
        compute_cycles = 0.0
        dram_cycles = 0.0
        util_macs = 0.0
        for i in order:
            preds = cg.pred_ids[i]
            inputs_off = (not preds) or \
                any(not (gmask >> p) & 1 for p in preds)
            succs = cg.succ_ids[i]
            outputs_off = (not succs) or \
                any(not (gmask >> v) & 1 for v in succs)
            lc = self._map_layer_memo(i, inputs_off, outputs_off,
                                      weight_passes if multi else 1)
            total += lc
            compute_cycles += lc.compute_cycles
            dram_cycles += lc.dram_cycles
            util_macs += lc.utilization * lc.macs
        return self._breakdown(total, compute_cycles, dram_cycles, util_macs,
                               members=tuple(cg.names[i] for i in order),
                               tile_rows=tile_rows,
                               weight_passes=weight_passes)

    def _cost_group_members(self, members: FrozenSet[str]
                            ) -> Optional[CostBreakdown]:
        """Reference path: members as a frozenset of layer names (used by
        ``ReferenceFusionState``; kept operation-for-operation identical to
        the fast path so both produce bit-equal costs)."""
        g = self.graph
        order = topological_sort_edges(
            [n for n in g.names if n in members], g.edges)
        multi = len([n for n in order if g.layers[n].macs]) > 1

        weight_passes = 1
        tile_rows = 0
        if multi and len(order) > 1:
            t = max_tile_rows(g, order, self.acc.act_buf_words)
            if t == 0:
                return None                              # over-capacity: invalid
            tile_rows = t
            group_w = sum(g.layers[n].weight_size for n in order)
            if group_w > self.acc.weight_buf_words:
                sink_p = max((g.layers[n].p or 1) for n in order)
                weight_passes = math.ceil(sink_p / t)

        total = LayerCost()
        compute_cycles = 0.0
        dram_cycles = 0.0
        util_macs = 0.0
        for name in order:
            layer = g.layers[name]
            inputs_off = self._inputs_offchip(name, members)
            outputs_off = self._outputs_offchip(name, members)
            lc = map_layer(layer, self.acc, self.em,
                           inputs_offchip=inputs_off,
                           outputs_offchip=outputs_off,
                           weight_stream_passes=weight_passes if multi else 1)
            total += lc
            compute_cycles += lc.compute_cycles
            dram_cycles += lc.dram_cycles
            util_macs += lc.utilization * lc.macs
        return self._breakdown(total, compute_cycles, dram_cycles, util_macs,
                               members=tuple(order), tile_rows=tile_rows,
                               weight_passes=weight_passes)

    @staticmethod
    def _breakdown(total: LayerCost, compute_cycles: float,
                   dram_cycles: float, util_macs: float, *, members,
                   tile_rows: int, weight_passes: int) -> CostBreakdown:
        return CostBreakdown(
            energy_pj=total.energy_pj,
            compute_cycles=compute_cycles,
            dram_cycles=dram_cycles,
            dram_read_words=total.dram_read_words,
            dram_write_words=total.dram_write_words,
            act_write_events=total.act_write_events,
            macs=total.macs,
            members=members,
            tile_rows=tile_rows,
            weight_passes=weight_passes,
            utilization=(util_macs / total.macs if total.macs else 1.0),
            energy_terms=dict(total.energy_terms))

    def _inputs_offchip(self, name: str, members: FrozenSet[str]) -> bool:
        preds = self.graph.preds(name)
        if not preds:
            return True                                  # graph input from DRAM
        return any(p not in members for p in preds)

    def _outputs_offchip(self, name: str, members: FrozenSet[str]) -> bool:
        succ = self.graph.succs(name)
        if not succ:
            return True                                  # model output
        return any(v not in members for v in succ)
