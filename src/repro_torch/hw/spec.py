"""Hierarchical hardware descriptions: memory levels + compute array.

The paper's Table I machines (and anything else the search should target)
are described structurally instead of as a flat 9-field dataclass: a
:class:`HardwareSpec` is a compute array (spatial dims, MAC lanes, dataflow)
plus an ordered hierarchy of :class:`MemLevel` entries (capacity, bandwidth,
per-access energy).  The cost side consumes the flat
:class:`repro_torch.costmodel.accelerator.Accelerator` view produced by
:meth:`HardwareSpec.to_accelerator`, so describing a machine here changes
*nothing* about how Table-I machines are costed — it changes how they are
*expressed*, which is what makes adding one a registration instead of a
fork (see ``repro_torch.hw.catalog`` and the README's 20-line example).

Conventions:

* levels are ordered outermost -> innermost (``dram`` first);
* the fusion cost model requires three named levels: ``dram`` (off-chip,
  bandwidth-limited), ``act_buf`` and ``weight_buf`` (on-chip SRAMs whose
  capacities gate fused-tile feasibility and weight residency);
* ``energy_pj_per_word=None`` on an SRAM level means "derive from capacity"
  via the Accelergy-style banked-SRAM curve in
  :class:`repro_torch.costmodel.energy.EnergyModel` — exactly what the flat
  machines did, so Table I round-trips bit-for-bit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Tuple

from repro_torch.costmodel.accelerator import Accelerator

#: dataflows the mapper understands; ``flexible`` (FlexNN-style, arXiv
#: 2403.09026) lets the mapper pick the better-utilizing fixed dataflow
#: per layer.
DATAFLOWS = ("row_stationary", "weight_stationary", "flexible")

#: level names the fusion cost model requires (others are carried along
#: for documentation / future cost models but not consumed today)
REQUIRED_LEVELS = ("dram", "act_buf", "weight_buf")


class HardwareError(ValueError):
    """An inconsistent or incomplete hardware description."""


@dataclass(frozen=True)
class MemLevel:
    """One storage level of the hierarchy.

    ``capacity_kib`` is ``math.inf`` for off-chip DRAM; ``bandwidth_gbps``
    is 0 for on-chip levels that never bind (the array consumes them at
    wire speed); ``energy_pj_per_word=None`` derives the per-access energy
    from capacity (Accelergy-style banked-SRAM curve).
    """

    name: str
    capacity_kib: float
    bandwidth_gbps: float = 0.0
    energy_pj_per_word: Optional[float] = None

    def __post_init__(self) -> None:
        if not self.name:
            raise HardwareError("memory level needs a name")
        if not (self.capacity_kib > 0):          # also rejects NaN
            raise HardwareError(
                f"level {self.name!r}: capacity must be positive, "
                f"got {self.capacity_kib}")
        if self.bandwidth_gbps < 0:
            raise HardwareError(
                f"level {self.name!r}: bandwidth cannot be negative")
        if self.energy_pj_per_word is not None \
                and self.energy_pj_per_word <= 0:
            raise HardwareError(
                f"level {self.name!r}: per-access energy must be positive")


@dataclass(frozen=True)
class ComputeArray:
    """The spatial PE array: ``pe_x`` x ``pe_y`` PEs, each with
    ``macs_per_pe`` vector MAC lanes."""

    pe_x: int
    pe_y: int
    macs_per_pe: int = 1

    def __post_init__(self) -> None:
        for f in ("pe_x", "pe_y", "macs_per_pe"):
            if getattr(self, f) <= 0:
                raise HardwareError(f"ComputeArray.{f} must be positive")

    @property
    def pe_count(self) -> int:
        return self.pe_x * self.pe_y

    @property
    def peak_macs_per_cycle(self) -> int:
        return self.pe_count * self.macs_per_pe


@dataclass(frozen=True)
class HardwareSpec:
    """A whole machine: compute array + memory hierarchy + dataflow."""

    name: str
    compute: ComputeArray
    levels: Tuple[MemLevel, ...]
    dataflow: str
    clock_mhz: float = 200.0
    word_bytes: int = 2

    def __post_init__(self) -> None:
        object.__setattr__(self, "levels", tuple(self.levels))
        if self.dataflow not in DATAFLOWS:
            raise HardwareError(
                f"{self.name!r}: unknown dataflow {self.dataflow!r}; "
                f"valid: {', '.join(DATAFLOWS)}")
        if self.clock_mhz <= 0:
            raise HardwareError(f"{self.name!r}: clock must be positive")
        if self.word_bytes <= 0:
            raise HardwareError(f"{self.name!r}: word_bytes must be positive")
        seen = set()
        for lv in self.levels:
            if lv.name in seen:
                raise HardwareError(
                    f"{self.name!r}: duplicate memory level {lv.name!r}")
            seen.add(lv.name)
        missing = [n for n in REQUIRED_LEVELS if n not in seen]
        if missing:
            raise HardwareError(
                f"{self.name!r}: missing required memory level(s) "
                f"{', '.join(missing)} (have: {', '.join(sorted(seen))})")
        if not math.isinf(self.level("dram").capacity_kib) \
                and self.level("dram").capacity_kib < \
                self.level("act_buf").capacity_kib:
            raise HardwareError(
                f"{self.name!r}: dram smaller than the activation buffer")
        if self.level("dram").bandwidth_gbps <= 0:
            raise HardwareError(
                f"{self.name!r}: dram needs a positive bandwidth_gbps")

    # ---- lookups ---------------------------------------------------------------
    def level(self, name: str) -> MemLevel:
        for lv in self.levels:
            if lv.name == name:
                return lv
        raise HardwareError(
            f"{self.name!r} has no memory level {name!r}; have: "
            + ", ".join(lv.name for lv in self.levels))

    def has_level(self, name: str) -> bool:
        return any(lv.name == name for lv in self.levels)

    @property
    def onchip_capacity_kib(self) -> float:
        """Total on-chip buffer capacity (every finite-capacity level)."""
        return sum(lv.capacity_kib for lv in self.levels
                   if not math.isinf(lv.capacity_kib))

    # ---- derived views ---------------------------------------------------------
    def _whole_kib(self, level_name: str) -> int:
        """A buffer capacity as whole KiB (the flat view's unit); a
        fractional or sub-1-KiB value would silently truncate — refuse it
        instead (0-KiB buffers divide by zero in the mapper)."""
        cap = self.level(level_name).capacity_kib
        if cap != int(cap) or cap < 1:
            raise HardwareError(
                f"{self.name!r}: level {level_name!r} capacity must be a "
                f"whole KiB >= 1 for the flat accelerator view, got {cap}")
        return int(cap)

    def to_accelerator(self) -> Accelerator:
        """The flat view the mapper/evaluator consume.  Table-I specs
        produce exactly the legacy constants, so costs are unchanged."""
        dram = self.level("dram")
        return Accelerator(
            name=self.name,
            pe_x=self.compute.pe_x, pe_y=self.compute.pe_y,
            macs_per_pe=self.compute.macs_per_pe,
            act_buf_kib=self._whole_kib("act_buf"),
            weight_buf_kib=self._whole_kib("weight_buf"),
            dataflow=self.dataflow,
            clock_mhz=self.clock_mhz,
            dram_gbps=dram.bandwidth_gbps,
            word_bytes=self.word_bytes)

    # ---- transformations -------------------------------------------------------
    def repartition(self, act_delta_kib: float) -> "HardwareSpec":
        """Iso-capacity repartitioning (paper Fig. 11): move
        ``act_delta_kib`` KiB of weight buffer into the activation buffer
        (negative = the other way).  Total on-chip capacity is preserved;
        a partition that drives either buffer non-positive is refused
        (``MemLevel`` validation)."""
        act = self.level("act_buf")
        new_levels = tuple(
            replace(lv, capacity_kib=lv.capacity_kib + act_delta_kib)
            if lv.name == "act_buf" else
            replace(lv, capacity_kib=lv.capacity_kib - act_delta_kib)
            if lv.name == "weight_buf" else lv
            for lv in self.levels)
        return replace(
            self,
            name=f"{self.name}_act{int(act.capacity_kib + act_delta_kib)}k",
            levels=new_levels)

    def describe(self) -> str:
        """Human-readable one-machine summary (``repro list`` detail)."""
        rows = [f"{self.name}: {self.compute.pe_x}x{self.compute.pe_y} PEs "
                f"x {self.compute.macs_per_pe} MAC lanes, "
                f"{self.dataflow}, {self.clock_mhz:g} MHz"]
        for lv in self.levels:
            cap = ("inf" if math.isinf(lv.capacity_kib)
                   else f"{lv.capacity_kib:g} KiB")
            bw = f", {lv.bandwidth_gbps:g} GB/s" if lv.bandwidth_gbps else ""
            rows.append(f"  {lv.name:<11} {cap}{bw}")
        return "\n".join(rows)

    # ---- serialization ---------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "compute": {"pe_x": self.compute.pe_x,
                        "pe_y": self.compute.pe_y,
                        "macs_per_pe": self.compute.macs_per_pe},
            "levels": [{"name": lv.name,
                        "capacity_kib": (None if math.isinf(lv.capacity_kib)
                                         else lv.capacity_kib),
                        "bandwidth_gbps": lv.bandwidth_gbps,
                        "energy_pj_per_word": lv.energy_pj_per_word}
                       for lv in self.levels],
            "dataflow": self.dataflow,
            "clock_mhz": self.clock_mhz,
            "word_bytes": self.word_bytes,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "HardwareSpec":
        return cls(
            name=d["name"],
            compute=ComputeArray(**d["compute"]),
            levels=tuple(
                MemLevel(name=lv["name"],
                         capacity_kib=(math.inf
                                       if lv.get("capacity_kib") is None
                                       else lv["capacity_kib"]),
                         bandwidth_gbps=lv.get("bandwidth_gbps", 0.0),
                         energy_pj_per_word=lv.get("energy_pj_per_word"))
                for lv in d["levels"]),
            dataflow=d["dataflow"],
            clock_mhz=d.get("clock_mhz", 200.0),
            word_bytes=d.get("word_bytes", 2))
