"""Accelerator templates (paper Table I).

Eyeriss-like (row-stationary), SIMBA-like and SIMBA-2x2-like
(weight-stationary) spatial arrays, all at the paper's system setting:
200 MHz nominal clock, LPDDR4 at 128 GB/s, 16-bit words.

Note the paper *modifies* Eyeriss with a 512 KiB weight buffer ("equal to that
of a single SIMBA chiplet, to store multiple layers simultaneously") — that is
the configuration encoded here.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class Accelerator:
    name: str
    pe_x: int
    pe_y: int
    macs_per_pe: int
    act_buf_kib: int
    weight_buf_kib: int
    dataflow: str     # "row_stationary" | "weight_stationary" | "flexible"
    clock_mhz: float = 200.0
    dram_gbps: float = 128.0
    word_bytes: int = 2

    # ---- derived ---------------------------------------------------------------
    @property
    def pe_count(self) -> int:
        return self.pe_x * self.pe_y

    @property
    def peak_macs_per_cycle(self) -> int:
        return self.pe_count * self.macs_per_pe

    @property
    def act_buf_words(self) -> int:
        return self.act_buf_kib * 1024 // self.word_bytes

    @property
    def weight_buf_words(self) -> int:
        return self.weight_buf_kib * 1024 // self.word_bytes

    @property
    def dram_words_per_cycle(self) -> float:
        return self.dram_gbps * 1e9 / (self.clock_mhz * 1e6) / self.word_bytes

    def repartition(self, act_delta_kib: int) -> "Accelerator":
        """Iso-capacity buffer repartitioning (paper Fig. 11): move
        ``act_delta_kib`` KiB from the weight buffer to the activation buffer
        (negative = the other way).  Total on-chip capacity is preserved by
        construction; a delta that drives either buffer non-positive is a
        meaningless machine and is refused."""
        act = self.act_buf_kib + act_delta_kib
        wgt = self.weight_buf_kib - act_delta_kib
        if act <= 0 or wgt <= 0:
            raise ValueError(
                f"repartition({act_delta_kib:+d}) of {self.name!r} leaves "
                f"act={act} KiB / weight={wgt} KiB; both buffers must stay "
                f"positive (valid deltas: "
                f"{1 - self.act_buf_kib}..{self.weight_buf_kib - 1})")
        return replace(
            self,
            name=f"{self.name}_act{act}k",
            act_buf_kib=act,
            weight_buf_kib=wgt,
        )


# Paper Table I ------------------------------------------------------------------
EYERISS = Accelerator("eyeriss", pe_x=14, pe_y=12, macs_per_pe=1,
                      act_buf_kib=128, weight_buf_kib=512,
                      dataflow="row_stationary")
SIMBA = Accelerator("simba", pe_x=4, pe_y=4, macs_per_pe=64,
                    act_buf_kib=64, weight_buf_kib=512,
                    dataflow="weight_stationary")
SIMBA2X2 = Accelerator("simba2x2", pe_x=8, pe_y=8, macs_per_pe=64,
                       act_buf_kib=256, weight_buf_kib=2048,
                       dataflow="weight_stationary")

ARCHS = {a.name: a for a in (EYERISS, SIMBA, SIMBA2X2)}
