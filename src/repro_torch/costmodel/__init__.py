"""The paper's cost layer, ported from ``repro.costmodel``: the ``default``
mini-Timeloop mapper and the ``tpu`` roofline of the modelled TPU target."""
from repro_torch.costmodel.accelerator import (ARCHS, EYERISS, SIMBA,
                                               SIMBA2X2, Accelerator)
from repro_torch.costmodel.base import CostBreakdown, CostModel, GroupKey
from repro_torch.costmodel.default import DefaultCostModel
from repro_torch.costmodel.energy import DEFAULT_ENERGY, EnergyModel
from repro_torch.costmodel.evaluator import Evaluator, ScheduleCost
from repro_torch.costmodel.mapper import (LayerCost, map_layer,
                                          resolve_dataflow,
                                          spatial_utilization)
from repro_torch.costmodel.tpu_fusion import TpuFusionCostModel

__all__ = ["ARCHS", "EYERISS", "SIMBA", "SIMBA2X2", "Accelerator",
           "CostBreakdown", "CostModel", "DEFAULT_ENERGY",
           "DefaultCostModel", "EnergyModel", "Evaluator", "GroupKey",
           "LayerCost", "ScheduleCost", "TpuFusionCostModel", "map_layer",
           "resolve_dataflow", "spatial_utilization"]
