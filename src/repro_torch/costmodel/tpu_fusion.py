"""TPU roofline cost backend for fusion schedules (``--costmodel tpu``).

The port's copy of ``repro/costmodel/tpu_fusion.py``.  The TPU retarget
used to live in its own silo: an analytical model
(``repro_torch.costmodel.tpu_model``) over :class:`TpuSchedule` genomes
only.
This module ports its *costing style* — a flat roofline (compute vs HBM
time, system-level pJ/FLOP + pJ/byte energy, same constants) — onto the
:class:`~repro_torch.costmodel.base.CostModel` protocol, so the paper's fusion
genomes can be priced on a TPU-class chip through the identical search
path: ``python -m repro_torch search --workload mobilenet_v3 --costmodel
tpu``.  The machine is the modelled TPU target (the reference's ``HW``,
VMEM and clock parameters, copied so results equal the reference's), not
the card: a search on the card runs only its label pass there.

Semantics of fusion on TPU (the analogue of paper §IV):

* weights always stream from HBM (no persistent on-chip weight buffer);
* a *split* edge round-trips its activation tensor through HBM; a *fused*
  edge keeps it in VMEM;
* a multi-layer group is feasible iff a line-buffer tile of its members
  fits the VMEM activation budget (same receptive-field footprint math as
  the edge machines, different capacity);
* no dataflow utilization modelling: the MXU is systolic and the
  system-level pJ/FLOP constant already folds array data movement in,
  exactly as ``tpu_model.estimate`` does for transformers.

The spatial `Accelerator` the evaluator passes in is ignored except as a
provenance name — the machine here is the HW roofline (peak FLOP/s, HBM
bandwidth, VMEM capacity).
"""
from __future__ import annotations

from typing import FrozenSet, Optional

from repro_torch.core.graph import Layer, LayerGraph
from repro_torch.core.receptive import max_tile_rows
from repro_torch.costmodel.accelerator import Accelerator
from repro_torch.costmodel.base import CostBreakdown, CostModel, GroupKey
from repro_torch.costmodel.energy import DEFAULT_ENERGY, EnergyModel
from repro_torch.costmodel.mapper import LayerCost
from repro_torch.costmodel.tpu_model import E_FLOP_J, E_HBM_J_PER_BYTE
from repro_torch.roofline.analysis import HW

#: VMEM bytes of the modelled TPU core, half budgeted to fused-tile line
#: buffers (mirroring the edge machines' act/weight split); the
#: reference's parameter
VMEM_BYTES = 16 * 1024 * 1024
TPU_CLOCK_MHZ = 940.0              # the modelled target's clock


class TpuFusionCostModel(CostModel):
    """Three-term roofline pricing of fusion groups on a TPU-class chip."""

    name = "tpu"

    def __init__(self, graph: LayerGraph, acc: Accelerator,
                 em: EnergyModel = DEFAULT_ENERGY, *, hw: HW = HW(),
                 vmem_bytes: float = VMEM_BYTES,
                 clock_mhz: float = TPU_CLOCK_MHZ):
        super().__init__(graph, acc, em)
        self.hw = hw
        self.clock_mhz = clock_mhz
        self.word_bytes = 2                              # bf16
        # peak MACs/cycle and HBM words/cycle at the chosen clock
        self.macs_per_cycle = hw.peak_flops / 2.0 / (clock_mhz * 1e6)
        self.hbm_words_per_cycle = \
            hw.hbm_bw / self.word_bytes / (clock_mhz * 1e6)
        self.act_budget_words = int(vmem_bytes / 2) // self.word_bytes

    @property
    def clock_hz(self) -> float:
        return self.clock_mhz * 1e6

    # ---- protocol ---------------------------------------------------------------
    def cost_layer(self, layer: Layer, *, inputs_offchip: bool = True,
                   outputs_offchip: bool = True,
                   weight_stream_passes: int = 1) -> LayerCost:
        cost = LayerCost(macs=layer.macs)
        if layer.macs == 0 and layer.kind in ("input",):
            return cost
        dram_r = layer.weight_size * max(weight_stream_passes, 1)
        if inputs_offchip:
            dram_r += layer.input_size
        dram_w = 0
        if outputs_offchip and layer.output_size:
            dram_w = layer.output_size
            cost.act_write_events = 1
        cost.dram_read_words = dram_r
        cost.dram_write_words = dram_w
        flops = 2.0 * layer.macs
        hbm_bytes = (dram_r + dram_w) * self.word_bytes
        terms = {
            "flops": flops * E_FLOP_J * 1e12,
            "hbm": hbm_bytes * E_HBM_J_PER_BYTE * 1e12,
        }
        cost.energy_pj = terms["flops"] + terms["hbm"]
        cost.energy_terms = terms
        cost.compute_cycles = layer.macs / self.macs_per_cycle
        cost.dram_cycles = (dram_r + dram_w) / self.hbm_words_per_cycle
        return cost

    def cost_group(self, key: GroupKey) -> Optional[CostBreakdown]:
        order = self.member_names(key)       # topo order, either key form
        members = set(order)
        g = self.graph
        multi = len([n for n in order if g.layers[n].macs]) > 1
        tile_rows = 0
        if multi and len(order) > 1:
            t = max_tile_rows(g, order, self.act_budget_words)
            if t == 0:
                return None                  # tile exceeds VMEM: infeasible
            tile_rows = t

        total = LayerCost()
        compute_cycles = 0.0
        dram_cycles = 0.0
        for name in order:
            preds = g.preds(name)
            inputs_off = (not preds) or any(p not in members for p in preds)
            succs = g.succs(name)
            outputs_off = (not succs) or any(v not in members for v in succs)
            lc = self.cost_layer(g.layers[name],
                                 inputs_offchip=inputs_off,
                                 outputs_offchip=outputs_off)
            total += lc
            compute_cycles += lc.compute_cycles
            dram_cycles += lc.dram_cycles
        return CostBreakdown(
            energy_pj=total.energy_pj,
            compute_cycles=compute_cycles,
            dram_cycles=dram_cycles,
            dram_read_words=total.dram_read_words,
            dram_write_words=total.dram_write_words,
            act_write_events=total.act_write_events,
            macs=total.macs,
            members=tuple(order),
            tile_rows=tile_rows,
            weight_passes=1,                 # TPU weights always stream
            energy_terms=dict(total.energy_terms))
