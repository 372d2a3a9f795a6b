"""The machine catalog: paper Table I plus beyond-paper machines, all
expressed as hierarchical :class:`~repro_torch.hw.spec.HardwareSpec` descriptions.

Table I (at the paper's system setting — 200 MHz, LPDDR4 @ 128 GB/s,
16-bit words; Eyeriss carries the paper's modified 512 KiB weight buffer):

* ``eyeriss``   — 14x12 row-stationary array;
* ``simba``     — 4x4 weight-stationary PEs x 64 MAC lanes (one chiplet);
* ``simba2x2``  — 2x2 chiplets (8x8 PEs) with 4x the buffering.

Beyond Table I:

* ``simba4x4``  — 4x4 chiplets (16x16 PEs), the next scaling step of the
  paper's Fig. 10 simba2x2 point: 16x compute/buffers of one chiplet;
* ``flexnn``    — a FlexNN-style dataflow-flexible array (arXiv
  2403.09026): same datapath budget class as SIMBA, but the mapper picks
  row- vs weight-stationary per layer, recovering utilization on shapes
  that starve a fixed dataflow (depthwise convs on SIMBA, pointwise convs
  on Eyeriss).

``ALL_SPECS`` feeds the accelerator registry (``repro_torch.search.registry``),
so every machine here — and any you register — composes with every
workload, cost model, and search backend.
"""
from __future__ import annotations

import math
from typing import Dict

from repro_torch.hw.spec import ComputeArray, HardwareSpec, MemLevel


def _edge_machine(name: str, *, pe_x: int, pe_y: int, macs_per_pe: int,
                  act_kib: float, weight_kib: float, dataflow: str,
                  clock_mhz: float = 200.0,
                  dram_gbps: float = 128.0) -> HardwareSpec:
    """The paper's system template: LPDDR4 DRAM over split act/weight
    SRAMs over per-PE register files (energies derive from capacity)."""
    return HardwareSpec(
        name=name,
        compute=ComputeArray(pe_x=pe_x, pe_y=pe_y, macs_per_pe=macs_per_pe),
        levels=(
            MemLevel("dram", math.inf, bandwidth_gbps=dram_gbps),
            MemLevel("weight_buf", weight_kib),
            MemLevel("act_buf", act_kib),
            MemLevel("rf", 0.5),           # per-PE scratchpad, ~1 KiB class
        ),
        dataflow=dataflow,
        clock_mhz=clock_mhz)


# ---- paper Table I ----------------------------------------------------------------
EYERISS_HW = _edge_machine("eyeriss", pe_x=14, pe_y=12, macs_per_pe=1,
                           act_kib=128, weight_kib=512,
                           dataflow="row_stationary")
SIMBA_HW = _edge_machine("simba", pe_x=4, pe_y=4, macs_per_pe=64,
                         act_kib=64, weight_kib=512,
                         dataflow="weight_stationary")
SIMBA2X2_HW = _edge_machine("simba2x2", pe_x=8, pe_y=8, macs_per_pe=64,
                            act_kib=256, weight_kib=2048,
                            dataflow="weight_stationary")

# ---- beyond Table I ---------------------------------------------------------------
SIMBA4X4_HW = _edge_machine("simba4x4", pe_x=16, pe_y=16, macs_per_pe=64,
                            act_kib=1024, weight_kib=8192,
                            dataflow="weight_stationary")
FLEXNN_HW = _edge_machine("flexnn", pe_x=8, pe_y=8, macs_per_pe=16,
                          act_kib=128, weight_kib=512,
                          dataflow="flexible")

ALL_SPECS: Dict[str, HardwareSpec] = {
    s.name: s for s in (EYERISS_HW, SIMBA_HW, SIMBA2X2_HW,
                        SIMBA4X4_HW, FLEXNN_HW)
}


def get_spec(name: str) -> HardwareSpec:
    try:
        return ALL_SPECS[name]
    except KeyError:
        raise KeyError(
            f"unknown hardware spec {name!r}; valid: "
            + ", ".join(sorted(ALL_SPECS))) from None
