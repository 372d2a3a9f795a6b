"""Accelergy-style per-access energy model (paper §II-A, refs [8],[10]).

Constants are per 16-bit word / per MAC, in pJ, at a 45nm-class node:

* ``e_mac``  — 16-bit multiply-accumulate, ~0.5-1 pJ (Horowitz, ISSCC'14).
* ``e_rf``   — PE-local scratchpad (<1 KiB register file), ~0.5 pJ/word
  (Eyeriss JSSC'17 normalized RF access = 1x MAC).
* ``e_noc``  — array interconnect hop/broadcast, ~2x RF (Eyeriss NoC = 2x).
* ``e_sram(cap)`` — shared buffer access.  Larger SRAMs are *banked*, so
  per-access energy grows sublinearly with capacity; Accelergy/CACTI-class
  models land near cap^0.25 at constant width (a monolithic array would be
  ~sqrt).  Anchored so 64 KiB ~ 1.2 pJ, 1 MiB ~ 2.4 pJ/word.
* ``e_dram`` — LPDDR4, ~4-8 pJ/bit -> ~100 pJ per 16-bit word
  (Eyeriss JSSC'17 uses DRAM = 200x MAC; we land in the same regime).

Absolute joules differ from a calibrated Accelergy run; the reproduction
targets *ratios* between schedules, which are governed by the DRAM:SRAM:RF
ratios — all of which sit at their published relative magnitudes here.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class EnergyModel:
    e_mac: float = 0.56          # pJ / MAC
    e_rf: float = 0.48           # pJ / word (PE scratchpad)
    e_noc: float = 1.0           # pJ / word (array broadcast / hop)
    e_dram: float = 100.0        # pJ / word (LPDDR4)
    sram_anchor_pj: float = 1.2  # pJ / word at 64 KiB
    sram_anchor_kib: float = 64.0

    sram_exponent: float = 0.25    # banked-SRAM capacity scaling

    def e_sram(self, capacity_kib: float) -> float:
        """Per-word access energy of an on-chip SRAM of ``capacity_kib``."""
        if capacity_kib <= 0:
            return self.e_rf
        return max(0.6, self.sram_anchor_pj *
                   (capacity_kib / self.sram_anchor_kib) ** self.sram_exponent)


DEFAULT_ENERGY = EnergyModel()
