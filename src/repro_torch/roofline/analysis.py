"""Three-term roofline from a compiled dry-run artifact.

    compute    = HLO_FLOPs   / (chips x peak_FLOP/s)
    memory     = HLO_bytes   / (chips x HBM_bw)
    collective = coll_bytes  / (chips x link_bw)

``cost_analysis()`` supplies FLOPs and bytes.  Collective bytes are *not*
there — we parse the optimized HLO text and sum the result-shape bytes of
every all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute op (per-chip traffic, since SPMD HLO shapes are
per-device).  The hardware constants (:class:`HW`) are the modelled TPU
target's parameters, copied from the reference's ``HW`` so the port's
results equal its results; they are not the card's.

The port's copy of ``repro/roofline/analysis.py``.  The port cannot make a
dry-run artifact (that lowers the reference's steps with JAX), so
:func:`roofline_from_artifact` reads one made elsewhere, or a dict of the
same form.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Optional

# bytes per element for HLO dtypes we may meet
_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# e.g.:  %all-reduce.5 = bf16[16,512,128]{2,1,0} all-reduce(...)
_OP_RE = re.compile(
    r"=\s*(?:\(([^)]*)\)|(\w+)\[([\d,]*)\][^ ]*)\s+(" +
    "|".join(_COLLECTIVES) + r")[.\s(]")
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


@dataclass(frozen=True)
class HW:
    """Per-chip peaks of the modelled TPU target (the reference's ``HW``)."""
    peak_flops: float = 197e12        # bf16 FLOP/s
    hbm_bw: float = 819e9             # bytes/s
    ici_bw: float = 50e9              # bytes/s/link
    hbm_bytes: float = 16e9           # capacity


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Result-shape bytes per collective kind (per-device traffic proxy)."""
    out: Dict[str, int] = {k: 0 for k in _COLLECTIVES}
    out["count"] = 0
    for m in _OP_RE.finditer(hlo_text):
        tuple_part, dtype, dims, kind = m.groups()
        if tuple_part is not None:
            total = sum(_shape_bytes(dt, dm)
                        for dt, dm in _SHAPE_RE.findall(tuple_part))
        else:
            total = _shape_bytes(dtype, dims)
        out[kind] += total
        out["count"] += 1
    return out


@dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes_hbm: float
    bytes_coll: float
    chips: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Perfect-overlap lower bound: the max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """How much of the bound step time is the dominant (useful) term —
        1.0 means perfectly bound by the dominant resource."""
        t = self.step_time_s
        return self.compute_s / t if t > 0 else 0.0


def roofline_from_artifact(art: Dict, hw: HW = HW()) -> RooflineTerms:
    """``art``: one dry-run artifact (the reference's ``launch/dryrun.py``).

    cost_analysis numbers on SPMD-partitioned modules are per-device; the
    collective parse is per-device too, so no extra division by chips —
    ``chips`` is retained for reporting.
    """
    chips = art["chips"]
    flops = float(art["cost"].get("flops", 0.0))
    bts = float(art["cost"].get("bytes accessed", 0.0))
    coll = float(sum(v for k, v in art["collectives"].items()
                     if k != "count"))
    return RooflineTerms(
        compute_s=flops / hw.peak_flops,
        memory_s=bts / hw.hbm_bw,
        collective_s=coll / hw.ici_bw,
        flops=flops, bytes_hbm=bts, bytes_coll=coll, chips=chips)
