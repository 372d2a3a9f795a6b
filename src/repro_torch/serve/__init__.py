"""``repro_torch.serve`` — the scheduling service over the search facade
(the port's copy of ``repro.serve``).

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
* :mod:`repro_torch.serve.daemon` — the always-on service: HTTP/JSON API
  over a crash-safe persistent priority queue
  (:mod:`repro_torch.serve.queue`, whose journal either package replays)
  with opt-in warm-started searches (:mod:`repro_torch.serve.warmstart`);
  its worker threads search on the card by default;
* :mod:`repro_torch.serve.gc` — LRU-by-access store eviction that never
  touches objects pinned by queued/running jobs;
* the CLI verbs ``serve --requests jobs.json``, ``submit``, ``daemon``,
  ``jobs`` and ``store gc`` of ``python -m repro_torch`` (see
  ``repro_torch.__main__``).

    from repro_torch.serve import ArtifactStore, BatchScheduler
    store = ArtifactStore("schedules/")
    sched = BatchScheduler(store, workers=4)        # device=None: CUDA
    for spec in specs:
        sched.submit(spec)
    outcome = sched.run()       # outcome.stats: searched / cache_hits / ...
"""
from repro_torch.serve.daemon import DaemonError, JobCancelled, ScheduleDaemon
from repro_torch.serve.gc import GCResult, collect_garbage, live_keys_for_store
from repro_torch.serve.queue import JobQueue, QueuedJob, QueueError
from repro_torch.serve.scheduler import BatchScheduler, Job, ServeOutcome
from repro_torch.serve.store import (ArtifactStore, StoreError, artifact_key,
                                     spec_hash)
from repro_torch.serve.warmstart import WarmStartSeed, find_warm_start

__all__ = [
    "ArtifactStore", "BatchScheduler", "Job", "ServeOutcome", "StoreError",
    "artifact_key", "spec_hash",
    "ScheduleDaemon", "DaemonError", "JobCancelled",
    "JobQueue", "QueuedJob", "QueueError",
    "GCResult", "collect_garbage", "live_keys_for_store",
    "WarmStartSeed", "find_warm_start",
]
