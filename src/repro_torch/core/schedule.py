"""Improvement ratios over the layerwise baseline (the paper's reporting
unit), as the artifact needs them.

The part of the reference's ``repro/core/schedule.py`` that the search
facade uses: ``ScheduleResult`` and the ``optimize`` shim are not ported.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # lazy at runtime: costmodel imports core.fusion
    from repro_torch.costmodel.evaluator import ScheduleCost


class ImprovementRatios:
    """Baseline/best improvement ratios (the paper's reporting unit), shared
    by ``repro_torch.search.ScheduleArtifact`` — it exposes
    ``baseline``/``best`` :class:`ScheduleCost` attributes."""

    baseline: ScheduleCost
    best: ScheduleCost

    @property
    def energy_improvement(self) -> float:
        return self.baseline.energy_pj / self.best.energy_pj

    @property
    def edp_improvement(self) -> float:
        return self.baseline.edp / self.best.edp

    @property
    def cycles_improvement(self) -> float:
        return self.baseline.cycles / self.best.cycles

    @property
    def dram_improvement(self) -> float:
        b = self.baseline.dram_read_words + self.baseline.dram_write_words
        n = self.best.dram_read_words + self.best.dram_write_words
        return b / max(n, 1)
