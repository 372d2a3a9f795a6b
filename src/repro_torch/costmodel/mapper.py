"""Mini-Timeloop: per-layer mapping cost (paper §II-A).

Timeloop searches full loop-nest mapspaces; we keep the decisions that move
the paper's needle — DRAM traffic under buffer-capacity constraints, spatial
utilization of the PE array, and dataflow-specific on-chip reuse — in a small
closed-form model:

* **DRAM traffic**: weights / inputs stream once when resident; when neither
  operand fits its buffer the mapper picks the cheaper of weight-outer
  (inputs re-streamed per weight tile) vs input-outer loop order.
* **Spatial utilization**: per-dataflow lane mapping with ceil-division
  padding waste (SIMBA parallelizes M x C across PEs x vector lanes; Eyeriss
  row-stationary maps filter rows x output rows, packing multiple filters
  vertically when R < PE rows — its 14x12 array under-utilizes on some
  shapes, which the paper calls out in Fig. 11).
* **On-chip reuse**: per-dataflow amortization of buffer reads (broadcast for
  weight-stationary, row reuse for row-stationary); RF traffic is 3 accesses
  per MAC.

Cycles = max(compute, DRAM) — Timeloop schedules overlap computation with
communication (paper §IV), so the slower of the two binds.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.graph import Layer
from repro_torch.costmodel.accelerator import Accelerator
from repro_torch.costmodel.energy import DEFAULT_ENERGY, EnergyModel


def _util_dim(n: int, lanes: int) -> float:
    """Fraction of ``lanes`` kept busy by a dimension of size n (ceil waste)."""
    if n <= 0 or lanes <= 0:
        return 1.0
    return n / (math.ceil(n / lanes) * lanes)


def _util_weight_stationary(layer: Layer, acc: Accelerator) -> float:
    # SIMBA: M across PEs, C across per-PE vector MAC lanes.
    cg = max(layer.c // layer.groups, 1)
    return _util_dim(layer.m, acc.pe_count) * _util_dim(cg, acc.macs_per_pe)


def _util_row_stationary(layer: Layer, acc: Accelerator) -> float:
    # Eyeriss row-stationary: filter rows vertical (packing multiple
    # filters when R < pe_y), output columns horizontal.
    r = max(layer.r, 1)
    if r <= acc.pe_y:
        u_v = r * (acc.pe_y // r) / acc.pe_y
    else:
        u_v = _util_dim(r, acc.pe_y)
    q = max(layer.q, 1)
    return u_v * _util_dim(q, acc.pe_x)


def resolve_dataflow(layer: Layer, acc: Accelerator) -> str:
    """The concrete dataflow executing ``layer`` on ``acc``.

    Fixed-dataflow machines return their dataflow unchanged; a FlexNN-style
    ``flexible`` array (arXiv 2403.09026) reconfigures per layer, so the
    mapper picks whichever fixed dataflow utilizes the array better on this
    shape (weight-stationary wins ties — it is the cheaper reconfiguration
    target on SIMBA-class datapaths)."""
    if acc.dataflow != "flexible":
        return acc.dataflow
    if _util_weight_stationary(layer, acc) >= _util_row_stationary(layer, acc):
        return "weight_stationary"
    return "row_stationary"


def spatial_utilization(layer: Layer, acc: Accelerator,
                        dataflow: Optional[str] = None) -> float:
    """Fraction of the PE array ``layer`` keeps busy.  ``dataflow`` lets a
    caller that already resolved a flexible machine's per-layer choice
    (``map_layer``) skip re-resolving it."""
    if layer.kind not in ("conv", "dwconv", "fc"):
        return 1.0
    if dataflow is None:
        dataflow = resolve_dataflow(layer, acc)
    if dataflow == "weight_stationary":
        u = _util_weight_stationary(layer, acc)
    else:
        u = _util_row_stationary(layer, acc)
    return max(u, 1.0 / acc.peak_macs_per_cycle)


@dataclass
class LayerCost:
    """Cost of one layer under one mapping.  Energies in pJ, time in cycles.

    ``energy_terms`` names the components summed into ``energy_pj`` (for
    :class:`repro_torch.costmodel.base.CostBreakdown` reporting); accumulation
    via ``+=`` merges them term-wise.
    """
    energy_pj: float = 0.0
    compute_cycles: float = 0.0
    dram_cycles: float = 0.0
    dram_read_words: int = 0
    dram_write_words: int = 0
    act_write_events: int = 0     # distinct activation tensors written to DRAM
    macs: int = 0
    utilization: float = 1.0
    energy_terms: dict = field(default_factory=dict)

    @property
    def cycles(self) -> float:
        # compute/communication overlap (see module docstring)
        return max(self.compute_cycles, self.dram_cycles)

    def __iadd__(self, other: "LayerCost") -> "LayerCost":
        self.energy_pj += other.energy_pj
        self.compute_cycles += other.compute_cycles
        self.dram_cycles += other.dram_cycles
        self.dram_read_words += other.dram_read_words
        self.dram_write_words += other.dram_write_words
        self.act_write_events += other.act_write_events
        self.macs += other.macs
        for k, v in other.energy_terms.items():
            self.energy_terms[k] = self.energy_terms.get(k, 0.0) + v
        return self


def map_layer(layer: Layer, acc: Accelerator,
              em: EnergyModel = DEFAULT_ENERGY, *,
              inputs_offchip: bool = True,
              outputs_offchip: bool = True,
              weight_stream_passes: int = 1) -> LayerCost:
    """Cost one layer.

    ``inputs_offchip`` / ``outputs_offchip``: whether this layer's input /
    output activations cross the DRAM boundary (the fusion scheduler's lever).
    ``weight_stream_passes``: >1 when the layer executes inside a fused group
    whose aggregate weights exceed the weight buffer, forcing a re-stream per
    output tile pass (paper §IV: such weights "must always be loaded from
    DRAM").
    """
    cost = LayerCost(macs=layer.macs)
    I, O, W = layer.input_size, layer.output_size, layer.weight_size
    e_ab = em.e_sram(acc.act_buf_kib)
    e_wb = em.e_sram(acc.weight_buf_kib)

    if layer.macs == 0 and layer.kind in ("input",):
        return cost

    # ---- DRAM traffic --------------------------------------------------------------
    dram_r = 0
    dram_w = 0
    if layer.has_weights:
        w_fits = W <= acc.weight_buf_words
        i_fits = I <= acc.act_buf_words
        if w_fits or i_fits:
            w_dram = W
            i_dram = I
        else:
            n_w = math.ceil(W / acc.weight_buf_words)
            n_i = math.ceil(I / acc.act_buf_words)
            # weight-outer vs input-outer loop order; keep the cheaper.
            if W + I * n_w <= I + W * n_i:
                w_dram, i_dram = W, I * n_w
            else:
                w_dram, i_dram = W * n_i, I
        w_dram *= max(weight_stream_passes, 1)
        dram_r += w_dram
    else:
        i_dram = I
    if inputs_offchip:
        dram_r += i_dram
    if outputs_offchip and O:
        dram_w += O
        cost.act_write_events = 1
    cost.dram_read_words = dram_r
    cost.dram_write_words = dram_w

    # ---- on-chip traffic -------------------------------------------------------------
    df = resolve_dataflow(layer, acc)       # once per call; flexible machines
    cg = max(layer.c // max(layer.groups, 1), 1)
    if df == "weight_stationary":
        in_amort = min(max(layer.m // max(layer.groups, 1), 1), acc.macs_per_pe)
        w_amort = min(max(layer.p * layer.q, 1), 1024)
    else:
        in_amort = min(max(layer.r, 1), acc.pe_y)
        w_amort = min(max(layer.q, 1), 256)
    act_reads = layer.macs / max(in_amort, 1)
    # fill (only when staged from DRAM; a fused producer already paid the
    # write with its own output-collect term) + output collect
    act_writes = (I if inputs_offchip else 0) + O
    wbuf_reads = layer.macs / max(w_amort, 1)
    wbuf_writes = W * max(weight_stream_passes, 1)

    terms = {
        "mac": layer.macs * em.e_mac,
        "rf": 3.0 * layer.macs * em.e_rf,                 # in, w, psum regs
        "act_buf": (act_reads + act_writes) * e_ab,
        "weight_buf": (wbuf_reads + wbuf_writes) * e_wb,
        "noc": (act_reads + wbuf_reads) * 0.5 * em.e_noc,  # array distribution
        "dram": (dram_r + dram_w) * em.e_dram,
    }
    # summed term-by-term in the historical expression order: energy_pj is
    # bit-identical to the pre-breakdown single-expression sum
    cost.energy_pj = (terms["mac"] + terms["rf"] + terms["act_buf"]
                      + terms["weight_buf"] + terms["noc"] + terms["dram"])
    cost.energy_terms = terms

    # ---- time ------------------------------------------------------------------------
    util = spatial_utilization(layer, acc, df)
    cost.utilization = util
    if layer.macs:
        cost.compute_cycles = layer.macs / (acc.peak_macs_per_cycle * util)
    cost.dram_cycles = (dram_r + dram_w) / acc.dram_words_per_cycle
    return cost
