"""Static analysis over schedules (the port's copy of the parts of
``repro.analysis`` that ``verify`` and ``report`` run).

* :mod:`repro_torch.analysis.verify` — re-derives an artifact's groups,
  schedulability, footprints, and cost consistency from its bytes alone
  (no ``core.fusion``, no evaluator) and attaches a Chen-et-al DRAM-
  traffic lower-bound :class:`~repro_torch.analysis.verify.Certificate`;
* :mod:`repro_torch.analysis.bounds` — the communication lower bounds the
  certificate is built from (per-group, per-schedule, whole-graph).

Not ported yet (ROADMAP A2): the static fusion-space analysis
(``spacemap.py``, ``analyze``) and the determinism lint (``lint.py``).
"""
from repro_torch.analysis.bounds import (TrafficBound, graph_bound,
                                         group_bound, onchip_words_for,
                                         schedule_bound)
from repro_torch.analysis.verify import (Certificate, Check,
                                         VerificationReport, verify_artifact,
                                         verify_store)

__all__ = [
    "Certificate", "Check", "TrafficBound", "VerificationReport",
    "graph_bound", "group_bound", "onchip_words_for", "schedule_bound",
    "verify_artifact", "verify_store",
]
