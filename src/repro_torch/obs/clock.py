"""The engine's single wall-clock seam.

Every instrumented module (``search.session``, ``search.artifact``,
``serve.scheduler``, ``costmodel.evaluator``, ``core.population``, and
``repro_torch.obs`` itself) reads time through these three functions instead
of calling ``time.*`` directly, as the reference's do (there the
determinism linter's ``clock-seam`` rule enforces it), so every wall-time
read in the engine is auditable from a single seam.

Wall time here is *metadata only* (trace timestamps, artifact provenance);
it never feeds fingerprints, store keys, costs, or RNG.
"""
from __future__ import annotations

import time as _time


def unix_time() -> int:
    """Whole-second wall time (artifact ``created_unix``, report stamps)."""
    return int(_time.time())


def now() -> float:
    """Float wall time, for trace event timestamps."""
    return _time.time()


def perf_counter() -> float:
    """Monotonic high-resolution timer, for span durations and throughput."""
    return _time.perf_counter()
