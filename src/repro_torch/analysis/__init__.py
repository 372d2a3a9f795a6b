"""Static analysis over schedules and the engine itself (the port's copy
of ``repro.analysis``).

* :mod:`repro_torch.analysis.verify` — re-derives an artifact's groups,
  schedulability, footprints, and cost consistency from its bytes alone
  (no ``core.fusion``, no evaluator) and attaches a Chen-et-al DRAM-
  traffic lower-bound :class:`~repro_torch.analysis.verify.Certificate`;
* :mod:`repro_torch.analysis.bounds` — the communication lower bounds the
  certificate is built from (per-group, per-schedule, whole-graph);
* :mod:`repro_torch.analysis.lint` — AST determinism + import-boundary
  lint over the port's engine packages (``python -m repro_torch lint``;
  allowlist, clock seam and boundary table in
  ``src/repro_torch/lint.toml``);
* :mod:`repro_torch.analysis.spacemap` — static fusion-space analysis
  (``python -m repro_torch analyze``): classifies every genome bit as
  ``forced_off`` / ``free`` / ``undecided`` and factorizes the space into
  independently-searchable regions, again sharing no code with the engine
  it prunes.
"""
from repro_torch.analysis.bounds import (TrafficBound, graph_bound,
                                         group_bound, onchip_words_for,
                                         schedule_bound)
from repro_torch.analysis.lint import Finding, lint_file, run_lint
from repro_torch.analysis.spacemap import (EdgeVerdict, Region, SpaceMap,
                                           build_spacemap)
from repro_torch.analysis.verify import (Certificate, Check,
                                         VerificationReport, verify_artifact,
                                         verify_store)

__all__ = [
    "Certificate", "Check", "EdgeVerdict", "Finding", "Region", "SpaceMap",
    "TrafficBound", "VerificationReport", "build_spacemap", "graph_bound",
    "group_bound", "lint_file", "onchip_words_for", "run_lint",
    "schedule_bound", "verify_artifact", "verify_store",
]
