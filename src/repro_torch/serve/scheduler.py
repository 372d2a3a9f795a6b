"""Batch scheduling over the search facade: dedupe, serve, or search.

A :class:`BatchScheduler` accepts :class:`~repro_torch.search.spec.SearchSpec`
requests and resolves each one the cheapest way available:

1. **in-flight dedup** — identical specs submitted in the same batch
   collapse onto one search (canonical spec hash), the rest are served
   its result;
2. **store hit** — a request whose (graph fingerprint, spec) key is
   already in the :class:`~repro_torch.serve.store.ArtifactStore` is served
   from disk with *zero* new evaluations (no evaluator is even built);
3. **search** — remaining unique misses fan out across a worker pool
   (``multiprocessing`` workers; inline when ``workers <= 1``) and
   their artifacts are stored for every later identical request.

The CLI speaks this layer: ``python -m repro_torch serve --requests
jobs.json`` drains a batch, ``python -m repro_torch submit`` is the
single-request path.

The port's copy of ``repro/serve/scheduler.py``.  ``device`` runs every
search's label pass: CUDA (``None``, the default; raises without a card)
or ``"cpu"``.  The pool starts its workers with ``spawn`` on CUDA (a
process that has touched CUDA cannot use it in a forked child) and with
``fork`` on the CPU, as the island backend does; each worker runs with one
intra-op thread.  Pool workers are daemonic, so island searches inside
them run their islands as threads.

Job specs name workloads in any ``repro_torch.search.registry`` spec form
(registry names with inline params, ``mobilenet_v3@hw=160``); the port
fails ``file:`` GraphIR jobs with the error naming the missing import
pipeline.  (``ir:<fingerprint>`` specs are artifact-bound and fail the job
with the error explaining where to rebuild from.)
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import clock
from repro_torch.search.artifact import ScheduleArtifact, graph_fingerprint
from repro_torch.search.island import _start_method
from repro_torch.search.registry import build_workload
from repro_torch.search.session import SearchSession
from repro_torch.search.spec import SearchSpec

from repro_torch.serve.store import ArtifactStore, artifact_key, spec_hash


@dataclass
class Job:
    """One submitted request and how it was resolved."""

    id: int
    spec: SearchSpec
    status: str = "pending"            # pending | done | failed
    outcome: Optional[str] = None      # cache_hit | searched | None (failed)
    deduped: bool = False              # collapsed onto an identical in-flight job
    key: Optional[str] = None          # store key once resolved
    error: Optional[str] = None
    artifact: Optional[ScheduleArtifact] = None

    def describe(self) -> str:
        what = f"{self.spec.workload}/{self.spec.accelerator} " \
               f"[{self.spec.backend}, seed {self.spec.seed}]"
        if self.status == "failed":
            return f"job {self.id}: {what} -> FAILED: {self.error}"
        how = self.outcome + (" (deduped in-flight)" if self.deduped else "")
        s = self.artifact.summary() if self.artifact is not None else {}
        tail = f"  edp x{s['edp_x']}" if s else ""
        return f"job {self.id}: {what} -> {how}{tail}  key={self.key[:12]}"

    def to_dict(self) -> Dict:
        return {
            "id": self.id,
            "spec": self.spec.to_dict(),
            "status": self.status,
            "outcome": self.outcome,
            "deduped": self.deduped,
            "key": self.key,
            "error": self.error,
            "summary": self.artifact.summary()
            if self.artifact is not None else None,
        }


@dataclass
class ServeOutcome:
    """A drained batch: every job plus the service counters."""

    jobs: List[Job] = field(default_factory=list)
    stats: Dict[str, int] = field(default_factory=dict)

    def to_dict(self) -> Dict:
        return {"jobs": [j.to_dict() for j in self.jobs],
                "stats": self.stats}


def load_requests(path: str) -> List[SearchSpec]:
    """Read a jobs file: a JSON list of SearchSpec dicts, or an object with
    a ``jobs`` list (both shapes round-trip ``SearchSpec.to_dict``)."""
    with open(path) as f:
        payload = json.load(f)
    if isinstance(payload, dict):
        payload = payload.get("jobs")
    if not isinstance(payload, list):
        raise ValueError(
            f"{path}: expected a JSON list of SearchSpec objects "
            f"(or {{\"jobs\": [...]}})")
    return [SearchSpec.from_dict(d) for d in payload]


def _search_worker(job: tuple) -> tuple:
    """Worker-pool entry: run one search (``job`` is the spec dict and the
    device), return the artifact as a plain dict (picklable regardless of
    genome/backends involved)."""
    spec_dict, device = job
    try:
        spec = SearchSpec.from_dict(spec_dict)
        artifact = SearchSession(spec, device=device).run()
        return ("ok", artifact.to_dict())
    except Exception as e:                       # noqa: BLE001 — job isolation
        return ("err", f"{type(e).__name__}: {e}")


def _pool_init() -> None:
    """Each pool worker: one intra-op thread (a forked child of a process
    that has run torch ops can hang in OpenMP otherwise; the pool is the
    parallelism)."""
    import torch
    torch.set_num_threads(1)


class BatchScheduler:
    """Queue identical-spec-deduping scheduler over one
    :class:`ArtifactStore`.

    ``workers``: search processes for cache misses (``<= 1`` = run misses
    inline in submission order — fully deterministic, no subprocesses).
    ``device``: where every search's label pass runs, as in
    :class:`~repro_torch.search.SearchSession` (``None`` = CUDA, raising
    here without a card; ``"cpu"``).
    ``obs``: an optional :class:`repro_torch.obs.TelemetryCollector`; when set,
    every drained job emits a ``serve.job`` event and the batch closes with
    a ``serve.batch`` span plus store hit/miss counters.  Purely
    observational — job resolution is identical with or without it.
    """

    def __init__(self, store: ArtifactStore, *, workers: int = 1, obs=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.store = store
        self.workers = int(workers)
        self.obs = obs
        self.jobs: List[Job] = []
        self.searches_run = 0
        self._inflight: Dict[str, Job] = {}      # spec hash -> primary job

    # ---- intake -----------------------------------------------------------------
    def submit(self, spec: SearchSpec) -> Job:
        """Enqueue one request; an identical pending spec collapses onto
        the earlier job (served together at :meth:`run`)."""
        job = Job(id=len(self.jobs), spec=spec)
        primary = self._inflight.get(spec_hash(spec))
        if primary is not None:
            job.deduped = True
        else:
            self._inflight[spec_hash(spec)] = job
        self.jobs.append(job)
        return job

    # ---- draining ---------------------------------------------------------------
    def run(self, progress: Optional[Callable[[Job], None]] = None
            ) -> ServeOutcome:
        """Resolve every pending job: store hits served, unique misses
        searched (worker pool), duplicates attached to their primary."""
        col = self.obs
        if col is not None:
            t0w, t0p = clock.now(), clock.perf_counter()
        store_hits = store_misses = 0
        pending = [j for j in self.jobs if j.status == "pending"]
        primaries = [j for j in pending if not j.deduped]
        to_search: List[Job] = []
        fingerprints: Dict[int, str] = {}
        for job in primaries:
            try:
                graph = build_workload(job.spec.workload,
                                       **job.spec.workload_kwargs)
                fingerprints[job.id] = graph_fingerprint(graph)
                # a corrupt store object (StoreError) fails THIS job only:
                # the rest of the batch must still resolve
                hit = self.store.get(fingerprints[job.id], job.spec)
            except Exception as e:               # noqa: BLE001 — job isolation
                self._fail(job, f"{type(e).__name__}: {e}")
                continue
            if hit is not None:
                store_hits += 1
                self._serve(job, hit, "cache_hit")
            else:
                store_misses += 1
                to_search.append(job)
        # second dedup level, by normalized store key: specs whose raw
        # hashes differ but that address the same object (the same IR
        # document under two file: paths) collapse onto one search
        unique: List[Job] = []
        key_primary: Dict[str, Job] = {}
        key_dups: List[tuple] = []
        for job in to_search:
            key = artifact_key(fingerprints[job.id], job.spec)
            if key in key_primary:
                key_dups.append((job, key_primary[key]))
            else:
                key_primary[key] = job
                unique.append(job)
        self._run_searches(unique, fingerprints)
        for job, primary in key_dups:
            if primary.status == "failed":
                self._fail(job, primary.error)
            else:
                self._serve(job, primary.artifact, "cache_hit")
        # duplicates inherit their primary's resolution as a served hit
        for job in pending:
            if not job.deduped:
                continue
            primary = self._inflight[spec_hash(job.spec)]
            if primary.status == "failed":
                self._fail(job, primary.error)
            else:
                self._serve(job, primary.artifact, "cache_hit")
        for job in pending:
            self._inflight.pop(spec_hash(job.spec), None)
            if col is not None:
                col.record_job(job)
            if progress is not None:
                progress(job)
        stats = self.stats()
        if col is not None:
            col.record_serve_batch(stats, store_hits, store_misses, t0w,
                                   clock.perf_counter() - t0p)
        return ServeOutcome(jobs=list(self.jobs), stats=stats)

    def _run_searches(self, jobs: List[Job],
                      fingerprints: Dict[int, str]) -> None:
        if not jobs:
            return
        results = self._map_searches([(j.spec.to_dict(), self.device)
                                      for j in jobs])
        for job, (status, payload) in zip(jobs, results):
            self.searches_run += 1
            if status != "ok":
                self._fail(job, payload)
                continue
            artifact = ScheduleArtifact.from_dict(payload)
            if artifact.graph_fingerprint != fingerprints[job.id]:
                # registry mutated between fingerprinting and searching;
                # storing under the stale key would serve wrong schedules
                self._fail(job, "graph fingerprint changed during search")
                continue
            self._serve(job, artifact, "searched", put=True)

    def _map_searches(self, jobs: List[tuple]) -> List[tuple]:
        if self.workers <= 1 or len(jobs) == 1:
            return [_search_worker(j) for j in jobs]
        import multiprocessing
        try:
            ctx = multiprocessing.get_context(_start_method(self.device))
        except ValueError:                 # no such method on this platform
            return [_search_worker(j) for j in jobs]
        n = min(self.workers, len(jobs))
        with ctx.Pool(processes=n, initializer=_pool_init) as pool:
            return pool.map(_search_worker, jobs)

    def _serve(self, job: Job, artifact: ScheduleArtifact, outcome: str,
               put: bool = False) -> None:
        job.artifact = artifact
        job.key = self.store.put(artifact) if put else \
            artifact_key(artifact.graph_fingerprint, artifact.spec)
        job.outcome = outcome
        job.status = "done"

    def _fail(self, job: Job, error: str) -> None:
        job.status = "failed"
        job.error = error

    # ---- stats ------------------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        # session counters only: enumerating the store (len(self.store))
        # is O(objects) on disk — callers that want it can pay for it once
        done = [j for j in self.jobs if j.status != "pending"]
        return {
            "jobs": len(done),
            "searched": sum(j.outcome == "searched" for j in done),
            "cache_hits": sum(j.outcome == "cache_hit" for j in done),
            "deduped_in_flight": sum(j.deduped for j in done),
            "failed": sum(j.status == "failed" for j in done),
        }
