"""``repro_torch.hw`` — hierarchical hardware descriptions for the cost layer.

A machine is a :class:`HardwareSpec` (compute array + memory levels +
dataflow) instead of a flat dataclass; the catalog expresses paper Table I,
the Fig.-11 repartition variants, and beyond-paper machines (``simba4x4``,
the dataflow-flexible ``flexnn``) in it.  ``HardwareSpec.to_accelerator()``
yields the flat view the mappers consume — Table-I specs produce exactly
the legacy constants, so costs are bit-for-bit unchanged.
"""
from repro_torch.hw.catalog import (ALL_SPECS, EYERISS_HW, FLEXNN_HW, SIMBA2X2_HW,
                              SIMBA4X4_HW, SIMBA_HW, get_spec)
from repro_torch.hw.spec import (DATAFLOWS, ComputeArray, HardwareError,
                           HardwareSpec, MemLevel)

__all__ = [
    "ALL_SPECS", "ComputeArray", "DATAFLOWS", "EYERISS_HW", "FLEXNN_HW",
    "HardwareError", "HardwareSpec", "MemLevel", "SIMBA2X2_HW", "SIMBA4X4_HW",
    "SIMBA_HW", "get_spec",
]
