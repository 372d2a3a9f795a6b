"""The paper's GA re-targeted at TPU training schedules (beyond-paper).

The port's copy of ``repro/core/tpu_ga.py``.  Same Alg. 1 skeleton, but
the genome is a :class:`repro_torch.costmodel.tpu_model.TpuSchedule` — remat policy (the TPU
analogue of the paper's fuse/split decision: *which activations stay
"on-chip"/cheap vs round-trip HBM*), microbatch count (receptive-field-style
working-set sizing), gradient compression (cross-pod DRAM<->DCI traffic),
and sharding mode.

This module is a thin compatibility shim: the genome lives in
``repro_torch.search.tpu.TpuScheduleProblem`` and the selection loop is the
shared ``repro_torch.core.ga.run_ga_problem``.  New callers should use
``repro_torch.search.tpu.search_tpu_schedule``, which also accepts the
``random`` / ``hill_climb`` / ``exhaustive`` backends.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.ga import GAConfig
from repro_torch.costmodel.tpu_model import TpuCost, TpuSchedule
from repro_torch.roofline.analysis import HW


@dataclass
class TpuGAResult:
    best: TpuSchedule
    best_cost: TpuCost
    baseline: TpuSchedule
    baseline_cost: TpuCost
    history: List[float] = field(default_factory=list)
    evaluations: int = 0

    @property
    def edp_improvement(self) -> float:
        return self.baseline_cost.edp / self.best_cost.edp

    @property
    def step_improvement(self) -> float:
        return self.baseline_cost.step_s / self.best_cost.step_s


def optimize_tpu_schedule(cfg: ModelConfig, shape: ShapeConfig, *,
                          chips: int = 256, data_par: int = 16,
                          model_par: int = 16, hw: HW = HW(),
                          objective: str = "edp",
                          ga: GAConfig = GAConfig.fast(generations=30),
                          hbm_capacity: Optional[float] = None
                          ) -> TpuGAResult:
    """Compatibility shim over
    :func:`repro_torch.search.tpu.search_tpu_schedule` (GA backend)."""
    from repro_torch.search.tpu import search_tpu_schedule
    return search_tpu_schedule(
        cfg, shape, chips=chips, data_par=data_par, model_par=model_par,
        hw=hw, objective=objective, ga=ga, hbm_capacity=hbm_capacity)
