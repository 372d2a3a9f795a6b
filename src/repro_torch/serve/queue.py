"""Crash-safe persistent priority queue for the scheduling daemon.

A :class:`JobQueue` is the daemon's durable state: every submission,
start, and resolution is one JSON line appended (and flushed) to
``queue.jsonl`` inside the store directory, and a restart rebuilds the
whole queue by replaying the journal — jobs that were queued *or running*
when the process died come back as queued, terminal jobs keep their
resolution, and job ids keep counting from where they left off.  The
journal is the only file the queue touches; nothing is rewritten in
place, so a crash mid-append at worst loses the final partial line
(tolerated and reported at replay).

Semantics mirror :class:`repro_torch.serve.scheduler.BatchScheduler`:

* **priorities** — higher runs first; ties run in submission order;
* **dedup by normalized store key** — a submission whose
  :func:`~repro_torch.serve.store.artifact_key` matches a queued/running job
  attaches to it and inherits its resolution (one search serves both);
* **terminal states** — ``done`` (outcome ``cache_hit``/``searched``),
  ``failed`` (error string), ``cancelled``.

The queue is thread-safe (one lock, one condition) but persistence-only:
cooperative cancellation of *running* searches (stop flags, observer
ticks) lives in :mod:`repro_torch.serve.daemon`, which journals the final
``cancelled`` event here once the search actually unwinds.
"""
from __future__ import annotations

import heapq
import json
import os
import threading
from dataclasses import dataclass, field
from typing import IO, Any, Dict, List, Optional, Set, Tuple

from repro_torch.obs import clock

#: journal line schema version
QUEUE_VERSION = 1

#: journal file name inside the store directory
QUEUE_FILE = "queue.jsonl"

_TERMINAL = ("done", "failed", "cancelled")


class QueueError(ValueError):
    """The journal is unusable (bad version / schema)."""


@dataclass
class QueuedJob:
    """One submitted job as the journal knows it."""

    id: int
    spec_dict: Dict[str, Any]
    priority: int = 0
    warm_start: bool = False
    key: Optional[str] = None          # normalized store key (dedup identity)
    state: str = "queued"              # queued|running|done|failed|cancelled
    outcome: Optional[str] = None      # cache_hit | searched | None
    error: Optional[str] = None
    attached_to: Optional[int] = None  # deduped onto this primary job id
    submitted_unix: int = 0

    @property
    def terminal(self) -> bool:
        return self.state in _TERMINAL

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id, "spec": dict(self.spec_dict),
            "priority": self.priority, "warm_start": self.warm_start,
            "key": self.key, "state": self.state, "outcome": self.outcome,
            "error": self.error, "attached_to": self.attached_to,
            "submitted_unix": self.submitted_unix,
        }


@dataclass
class ReplayReport:
    """What a journal replay found (surfaced in daemon startup logs)."""

    jobs: int = 0
    requeued: int = 0            # queued/running at crash -> queued again
    terminal: int = 0
    warnings: List[str] = field(default_factory=list)


class JobQueue:
    """Journal-backed priority queue (see module docstring)."""

    def __init__(self, root: str, *, name: str = QUEUE_FILE):
        self.path = os.path.join(root, name)
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self.jobs: Dict[int, QueuedJob] = {}
        # (-priority, submission seq, id): heapq pops highest priority,
        # oldest first; cancelled/attached entries are skipped lazily
        self._heap: List[Tuple[int, int, int]] = []
        self._seq = 0
        self._next_id = 0
        self._closed = False
        self.replay = self._replay()
        os.makedirs(root, exist_ok=True)
        self._journal: IO[str] = open(self.path, "a", encoding="utf-8")

    # ---- journal ----------------------------------------------------------------
    def _append(self, event: str, **fields: Any) -> None:
        if self._journal.closed:
            return                       # post-close resolution: see close()
        rec = {"v": QUEUE_VERSION, "event": event, **fields,
               "t": clock.unix_time()}
        self._journal.write(json.dumps(rec, sort_keys=True,
                                       separators=(",", ":")) + "\n")
        self._journal.flush()
        os.fsync(self._journal.fileno())

    def _replay(self) -> ReplayReport:
        report = ReplayReport()
        try:
            with open(self.path, encoding="utf-8") as f:
                lines = f.readlines()
        except FileNotFoundError:
            return report
        for n, line in enumerate(lines, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                # a torn trailing line is the expected crash artifact; a
                # torn line mid-journal means later events were lost too —
                # either way replay keeps everything that parsed
                report.warnings.append(f"line {n}: unparsable, skipped")
                continue
            if rec.get("v") != QUEUE_VERSION:
                raise QueueError(
                    f"{self.path} line {n}: journal version "
                    f"{rec.get('v')!r}; this build reads {QUEUE_VERSION}")
            event = rec.get("event")
            if event == "submit":
                jid = int(rec["id"])
                self.jobs[jid] = QueuedJob(
                    id=jid, spec_dict=rec["spec"],
                    priority=int(rec.get("priority", 0)),
                    warm_start=bool(rec.get("warm_start", False)),
                    key=rec.get("key"),
                    attached_to=rec.get("attached_to"),
                    submitted_unix=int(rec.get("t", 0)))
                self._next_id = max(self._next_id, jid + 1)
            else:
                job = self.jobs.get(int(rec.get("id", -1)))
                if job is None:
                    report.warnings.append(
                        f"line {n}: {event} for unknown job, skipped")
                    continue
                if event == "start":
                    job.state = "running"
                elif event == "done":
                    job.state = "done"
                    job.outcome = rec.get("outcome")
                    job.key = rec.get("key", job.key)
                elif event == "failed":
                    job.state = "failed"
                    job.error = rec.get("error")
                elif event == "cancelled":
                    job.state = "cancelled"
                else:
                    report.warnings.append(
                        f"line {n}: unknown event {event!r}, skipped")
        # anything not terminal goes back on the heap: a job that was
        # *running* at the crash re-runs from scratch (searches are pure
        # functions of their spec, so a re-run is safe)
        for job in sorted(self.jobs.values(), key=lambda j: j.id):
            report.jobs += 1
            if job.terminal:
                report.terminal += 1
                continue
            if job.attached_to is not None:
                job.state = "queued"
                continue                 # resolved through its primary
            job.state = "queued"
            report.requeued += 1
            self._push(job)
        return report

    def _push(self, job: QueuedJob) -> None:
        heapq.heappush(self._heap, (-job.priority, self._seq, job.id))
        self._seq += 1

    # ---- intake -----------------------------------------------------------------
    def submit(self, spec_dict: Dict[str, Any], *, priority: int = 0,
               warm_start: bool = False, key: Optional[str] = None,
               resolved: Optional[Tuple[str, str]] = None) -> QueuedJob:
        """Journal and enqueue one job.

        ``key`` is the normalized store key; when a queued/running job
        already carries it, the new job *attaches* to that primary instead
        of entering the heap (dedup — one search resolves both).
        ``resolved=(outcome, key)`` submits an already-resolved job (a
        store hit served at intake with zero evaluations): the submit and
        done events are journaled atomically under the lock, so no worker
        can ever pick it up.
        """
        with self._cond:
            if self._closed:
                raise QueueError("queue is closed")
            job = QueuedJob(id=self._next_id, spec_dict=dict(spec_dict),
                            priority=int(priority),
                            warm_start=bool(warm_start), key=key,
                            submitted_unix=clock.unix_time())
            self._next_id += 1
            primary = None
            if resolved is None and key is not None:
                primary = self._primary_for(key, exclude=job.id)
            if primary is not None:
                job.attached_to = primary.id
            self.jobs[job.id] = job
            self._append("submit", id=job.id, spec=job.spec_dict,
                         priority=job.priority, warm_start=job.warm_start,
                         key=job.key, attached_to=job.attached_to)
            if resolved is not None:
                outcome, rkey = resolved
                job.state, job.outcome, job.key = "done", outcome, rkey
                self._append("done", id=job.id, outcome=outcome, key=rkey)
            elif job.attached_to is None:
                self._push(job)
                self._cond.notify()
            return job

    def _primary_for(self, key: str, exclude: int) -> Optional[QueuedJob]:
        for job in self.jobs.values():
            if (job.id != exclude and job.key == key and not job.terminal
                    and job.attached_to is None):
                return job
        return None

    # ---- worker side ------------------------------------------------------------
    def next_job(self, timeout: Optional[float] = None
                 ) -> Optional[QueuedJob]:
        """Block until a job is runnable (or the queue closes -> None);
        marks it running and journals the start."""
        with self._cond:
            while True:
                while self._heap:
                    _, _, jid = heapq.heappop(self._heap)
                    job = self.jobs[jid]
                    if job.state != "queued" or job.attached_to is not None:
                        continue         # cancelled/attached while queued
                    job.state = "running"
                    self._append("start", id=job.id)
                    return job
                if self._closed:
                    return None
                if not self._cond.wait(timeout=timeout):
                    return None

    # ---- resolution -------------------------------------------------------------
    def resolve_done(self, job_id: int, outcome: str, key: str) -> None:
        """Terminal success; attached jobs resolve as served hits."""
        with self._cond:
            job = self.jobs[job_id]
            job.state, job.outcome, job.key = "done", outcome, key
            self._append("done", id=job_id, outcome=outcome, key=key)
            for dup in self._attached(job_id):
                dup.state, dup.outcome, dup.key = "done", "cache_hit", key
                self._append("done", id=dup.id, outcome="cache_hit", key=key)

    def resolve_failed(self, job_id: int, error: str) -> None:
        """Terminal failure; attached jobs fail with the same error (the
        :class:`~repro_torch.serve.scheduler.BatchScheduler` contract)."""
        with self._cond:
            job = self.jobs[job_id]
            job.state, job.error = "failed", str(error)
            self._append("failed", id=job_id, error=job.error)
            for dup in self._attached(job_id):
                dup.state, dup.error = "failed", job.error
                self._append("failed", id=dup.id, error=job.error)

    def resolve_cancelled(self, job_id: int) -> None:
        """Terminal cancellation of a job the daemon's stop flag unwound;
        attached jobs re-enter the heap (their request still stands)."""
        with self._cond:
            job = self.jobs[job_id]
            job.state = "cancelled"
            self._append("cancelled", id=job_id)
            for dup in self._attached(job_id):
                dup.attached_to = None
                self._push(dup)
            self._cond.notify_all()

    def _attached(self, job_id: int) -> List[QueuedJob]:
        return [j for j in self.jobs.values()
                if j.attached_to == job_id and not j.terminal]

    def cancel(self, job_id: int) -> str:
        """Cancel a job: ``"cancelled"`` if it was still queued/attached
        (journaled immediately), ``"running"`` if the caller must abort the
        in-flight search first, ``"terminal"`` if already resolved."""
        with self._cond:
            job = self.jobs.get(job_id)
            if job is None:
                raise KeyError(job_id)
            if job.terminal:
                return "terminal"
            if job.state == "running":
                return "running"
            # queued or attached: nothing is executing, cancel outright
            # (heap entry is skipped lazily by next_job)
            job.state = "cancelled"
            job.attached_to = None
            self._append("cancelled", id=job_id)
            return "cancelled"

    # ---- views ------------------------------------------------------------------
    def get(self, job_id: int) -> QueuedJob:
        with self._lock:
            return self.jobs[job_id]

    def list_jobs(self) -> List[QueuedJob]:
        with self._lock:
            return [self.jobs[i] for i in sorted(self.jobs)]

    def live_keys(self) -> Set[str]:
        """Store keys referenced by non-terminal jobs — objects GC must
        never evict (:mod:`repro_torch.serve.gc`)."""
        with self._lock:
            return {j.key for j in self.jobs.values()
                    if j.key is not None and not j.terminal}

    def counts(self) -> Dict[str, int]:
        with self._lock:
            out = {s: 0 for s in
                   ("queued", "running", "done", "failed", "cancelled")}
            for j in self.jobs.values():
                out[j.state] = out.get(j.state, 0) + 1
            return out

    # ---- lifecycle --------------------------------------------------------------
    def stop_intake(self) -> None:
        """Refuse new submissions and wake every blocked :meth:`next_job`
        (-> None).  The journal stays open so in-flight resolutions still
        land; call :meth:`close` once the workers have drained."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()

    def close(self) -> None:
        """Stop intake (if not already) and close the journal.  Any
        resolution arriving after this is dropped from the journal — the
        job simply re-runs on the next restart, which is the same contract
        a crash gives."""
        self.stop_intake()
        with self._cond:
            if not self._journal.closed:
                self._journal.close()
