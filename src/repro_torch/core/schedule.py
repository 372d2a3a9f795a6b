"""Improvement ratios over the layerwise baseline (the paper's reporting
unit) and the :class:`ScheduleResult` view of a finished search.

The port's copy of ``repro/core/schedule.py``: ``ScheduleResult`` is what
``SearchSession.schedule_result()`` returns and what the schedule report
(``core/report.py``, ``python -m repro_torch report --schedule``) renders.
The reference's pre-facade ``optimize`` shim is not ported: new code calls
:func:`repro_torch.search.search` / :class:`repro_torch.search.SearchSession`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from typing import TYPE_CHECKING

from repro_torch.core.fusion import FusionState
from repro_torch.core.ga import GAResult

if TYPE_CHECKING:  # lazy at runtime: costmodel imports core.fusion
    from repro_torch.costmodel.evaluator import ScheduleCost


class ImprovementRatios:
    """Baseline/best improvement ratios (the paper's reporting unit), shared
    by :class:`ScheduleResult` and ``repro_torch.search.ScheduleArtifact`` —
    both expose ``baseline``/``best`` :class:`ScheduleCost` attributes."""

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


@dataclass
class ScheduleResult(ImprovementRatios):
    workload: str
    accelerator: str
    baseline: ScheduleCost              # layerwise
    best: ScheduleCost                  # GA-optimized
    best_state: FusionState
    ga: GAResult

    def summary(self) -> Dict[str, float]:
        return {
            "workload": self.workload,
            "accelerator": self.accelerator,
            "energy_x": round(self.energy_improvement, 3),
            "edp_x": round(self.edp_improvement, 3),
            "cycles_x": round(self.cycles_improvement, 3),
            "dram_x": round(self.dram_improvement, 3),
            "groups": self.best.n_groups,
            "act_dram_writes_base": self.baseline.act_write_events,
            "act_dram_writes_best": self.best.act_write_events,
            "ga_evaluations": self.ga.evaluations,
        }
