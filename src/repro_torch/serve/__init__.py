"""``repro_torch.serve`` — the batch scheduling service over the search
facade (the port's copy of the parts of ``repro.serve`` the CLI runs).

* :mod:`repro_torch.serve.store` — an on-disk, content-addressed
  :class:`ArtifactStore`: finished :class:`~repro_torch.search.
  ScheduleArtifact`\\ s keyed by (graph fingerprint, canonical
  :class:`~repro_torch.search.SearchSpec` hash), written atomically; the
  keys equal the reference's bit for bit, so either package's store serves
  the other's objects;
* :mod:`repro_torch.serve.scheduler` — a :class:`BatchScheduler` that
  dedups in-flight identical specs, serves store hits without searching,
  and fans misses out across a worker pool (``spawn`` on CUDA, ``fork`` on
  the CPU);
* the CLI verbs ``python -m repro_torch serve --requests jobs.json`` and
  ``python -m repro_torch submit`` (see ``repro_torch.__main__``).

    from repro_torch.serve import ArtifactStore, BatchScheduler
    store = ArtifactStore("schedules/")
    sched = BatchScheduler(store, workers=4)        # device=None: CUDA
    for spec in specs:
        sched.submit(spec)
    outcome = sched.run()       # outcome.stats: searched / cache_hits / ...

Not ported yet (ROADMAP A2): the daemon and its HTTP API, the persistent
job queue, warm starts and ``store gc``.
"""
from repro_torch.serve.scheduler import BatchScheduler, Job, ServeOutcome
from repro_torch.serve.store import (ArtifactStore, StoreError, artifact_key,
                                     spec_hash)

__all__ = [
    "ArtifactStore", "BatchScheduler", "Job", "ServeOutcome", "StoreError",
    "artifact_key", "spec_hash",
]
