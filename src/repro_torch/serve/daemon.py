"""`python -m repro_torch daemon` — the always-on scheduling service (the
port's copy of ``repro/serve/daemon.py``).

A :class:`ScheduleDaemon` turns the batch serve layer into a long-running
service: an HTTP/JSON API (stdlib :class:`ThreadingHTTPServer`, no new
dependencies) in front of the content-addressed
:class:`~repro_torch.serve.store.ArtifactStore`, a crash-safe persistent
:class:`~repro_torch.serve.queue.JobQueue` (JSONL journal in the store dir,
replayed on restart), and a pool of worker threads draining the queue.

API (all JSON)::

    POST   /jobs             {"spec": {...SearchSpec...},
                              "priority": 0, "warm_start": false}
                             -> {"id": N, "state": ..., ...}
    GET    /jobs             -> {"jobs": [...]}
    GET    /jobs/<id>        -> job state + live per-generation convergence
    DELETE /jobs/<id>        -> cancel (cooperative abort when running)
    GET    /metrics          -> MetricRegistry snapshot + queue/store stats
    GET    /artifacts/<key>  -> raw stored ScheduleArtifact JSON
    GET    /healthz          -> {"ok": true}

Resolution per job mirrors :class:`~repro_torch.serve.scheduler.BatchScheduler`:
a store hit is served at submission with **zero** new evaluations; an
identical in-flight request (same normalized store key) attaches to the
running search; only genuine misses search.  ``warm_start=True`` (opt-in,
per job) additionally seeds the GA population from the store's nearest
cached winner (:mod:`repro_torch.serve.warmstart`) — the default path is
untouched, so all fixed-seed pins and store keys stay bit-identical.

Every search runs its population engine's label pass on ``device``: the
card by default (``csrc/ga_labels.cu``), and a daemon made with no card and
no ``device`` raises at construction rather than searching on the CPU
(``device="cpu"`` asks for the plain PyTorch version).  On the card the
daemon loads the label library before it starts its workers, so two
workers never build it at once; the workers then launch the kernel from
their own threads on the one CUDA context (the launch counters are
thread-safe).  An island job spawns its island processes from its worker
thread (``spawn`` on CUDA).

Cancellation of a *running* job is cooperative: the daemon sets the job's
stop flag, and the search's observer tick raises :class:`JobCancelled`
at the next generation boundary.  A daemon shutdown mid-search leaves the
job non-terminal in the journal, so the restart re-runs it — the same
contract a crash gives.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import MetricRegistry, TelemetryCollector, clock
from repro_torch.search.artifact import graph_fingerprint
from repro_torch.search.registry import build_workload
from repro_torch.search.session import Progress, SearchSession
from repro_torch.search.spec import SearchSpec

from repro_torch.serve.queue import JobQueue, QueuedJob
from repro_torch.serve.store import ArtifactStore, StoreError, artifact_key
from repro_torch.serve.warmstart import adapt_mask, find_warm_start


class JobCancelled(Exception):
    """Raised inside a search's observer tick to unwind a cancelled job."""


class DaemonError(ValueError):
    """A request the daemon must refuse (bad spec, unknown workload)."""


def _hex_key(s: str) -> bool:
    return bool(s) and all(c in "0123456789abcdef" for c in s)


class ScheduleDaemon:
    """The service: queue + store + worker pool + HTTP front end.
    ``device`` is where every search's label pass runs (``None``: the
    card, and an error without one)."""

    def __init__(self, store_dir: str, *, host: str = "127.0.0.1",
                 port: int = 0, workers: int = 1,
                 device: DeviceLike = None):
        self.device = resolve_device(device)   # no card and no device: raise
        self.store = ArtifactStore(store_dir)
        self.queue = JobQueue(store_dir)
        self.registry = MetricRegistry()
        self.workers = int(workers)
        self.searches_run = 0
        self.store_hits = 0
        self._fp_cache: Dict[Tuple[str, str], str] = {}
        self._stops: Dict[int, threading.Event] = {}
        self._collectors: Dict[int, TelemetryCollector] = {}
        self._lock = threading.Lock()
        self._shutdown = threading.Event()
        self._threads: list = []
        handler = _make_handler(self)
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.httpd.daemon_threads = True
        self.host, self.port = self.httpd.server_address[:2]

    # ---- lifecycle --------------------------------------------------------------
    def start(self) -> None:
        """Spawn the HTTP listener and the worker pool (non-blocking).  On
        the card the label library is loaded first, here, once."""
        if self.device.type == "cuda":
            from repro_torch.kernels.ga_labels.ops import card
            card(self.device)              # builds and loads ga_labels
        t = threading.Thread(target=self.httpd.serve_forever,
                             name="repro-daemon-http", daemon=True)
        t.start()
        self._threads.append(t)
        for i in range(self.workers):
            w = threading.Thread(target=self._worker_loop,
                                 name=f"repro-daemon-worker-{i}", daemon=True)
            w.start()
            self._threads.append(w)

    def request_shutdown(self) -> None:
        """Signal-handler-safe shutdown trigger (SIGTERM/SIGINT)."""
        self._shutdown.set()

    def wait(self) -> None:
        """Block until shutdown is requested, then stop cleanly: refuse
        new work, abort in-flight searches (left non-terminal in the
        journal -> re-run on restart), stop HTTP, close the journal."""
        self._shutdown.wait()
        self.stop()

    def stop(self) -> None:
        self._shutdown.set()
        self.queue.stop_intake()
        with self._lock:
            for ev in self._stops.values():
                ev.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=10.0)
        self.queue.close()

    # ---- submission -------------------------------------------------------------
    def _fingerprint(self, spec: SearchSpec) -> str:
        """Graph fingerprint for the spec's workload, memoized per
        (workload, kwargs) so a flood of same-workload jobs builds the
        graph once."""
        ck = (spec.workload, json.dumps(spec.workload_kwargs,
                                        sort_keys=True, default=str))
        fp = self._fp_cache.get(ck)
        if fp is None:
            graph = build_workload(spec.workload, **spec.workload_kwargs)
            fp = graph_fingerprint(graph)
            self._fp_cache[ck] = fp
        return fp

    def submit(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Resolve one POST /jobs: store hit served instantly (zero new
        evaluations), in-flight duplicate attached, miss enqueued."""
        if not isinstance(payload, dict) or "spec" not in payload:
            raise DaemonError('body must be {"spec": {...}, ...}')
        try:
            spec = SearchSpec.from_dict(payload["spec"])
        except Exception as e:           # noqa: BLE001 — surface as 400
            raise DaemonError(f"bad spec: {type(e).__name__}: {e}") from None
        priority = int(payload.get("priority", 0))
        warm = bool(payload.get("warm_start", False))
        try:
            fp = self._fingerprint(spec)
        except Exception as e:           # noqa: BLE001 — surface as 400
            raise DaemonError(
                f"cannot build workload {spec.workload!r}: "
                f"{type(e).__name__}: {e}") from None
        key = artifact_key(fp, spec)
        try:
            hit = self.store.get(fp, spec)
        except StoreError:
            # corrupt stored object: treat as a miss; the re-search puts a
            # fresh object under the same key, healing the store
            hit = None
        if hit is not None:
            self.store_hits += 1
            self.registry.counter("daemon.jobs", outcome="cache_hit").inc()
            job = self.queue.submit(spec.to_dict(), priority=priority,
                                    warm_start=warm, key=key,
                                    resolved=("cache_hit", key))
            return self.job_view(job)
        job = self.queue.submit(spec.to_dict(), priority=priority,
                                warm_start=warm, key=key)
        if job.attached_to is not None:
            self.registry.counter("daemon.jobs", outcome="deduped").inc()
        else:
            with self._lock:
                self._stops[job.id] = threading.Event()
        return self.job_view(job)

    # ---- worker -----------------------------------------------------------------
    def _worker_loop(self) -> None:
        while True:
            job = self.queue.next_job()
            if job is None:
                return                   # queue closed: daemon stopping
            self._run_job(job)

    def _run_job(self, job: QueuedJob) -> None:
        with self._lock:
            stop = self._stops.setdefault(job.id, threading.Event())
        if stop.is_set() and not self._shutdown.is_set():
            self.queue.resolve_cancelled(job.id)
            return
        t0 = clock.perf_counter()
        try:
            spec = SearchSpec.from_dict(job.spec_dict)
            fp = self._fingerprint(spec)
            # a twin job (or an earlier daemon run) may have stored this
            # key while we sat queued: re-check before paying a search
            try:
                hit = self.store.get(fp, spec)
            except StoreError:
                hit = None
            if hit is not None:
                self.store_hits += 1
                self.registry.counter("daemon.jobs",
                                      outcome="cache_hit").inc()
                self.queue.resolve_done(job.id, "cache_hit",
                                        artifact_key(fp, spec))
                return
            collector = TelemetryCollector(registry=self.registry)
            session = SearchSession(spec, obs=collector, device=self.device)
            if job.warm_start:
                seed = find_warm_start(self.store, fp, spec)
                if seed is not None:
                    mask = adapt_mask(seed.mask, session.problem.cg.m)
                    session.problem.seed_genomes = (
                        session.problem.decode_genome(mask),)
            with self._lock:
                self._collectors[job.id] = collector

            def tick(p: Progress) -> None:
                if stop.is_set():
                    raise JobCancelled()

            artifact = session.run(progress=tick)
            key = self.store.put(artifact)
            self.searches_run += 1
            self.registry.counter("daemon.jobs", outcome="searched").inc()
            self.registry.histogram("daemon.job_wall_s").observe(
                clock.perf_counter() - t0)
            self.queue.resolve_done(job.id, "searched", key)
        except JobCancelled:
            if self._shutdown.is_set():
                # shutdown abort: leave the job non-terminal so the journal
                # replay re-queues it — identical to the crash contract
                return
            self.registry.counter("daemon.jobs", outcome="cancelled").inc()
            self.queue.resolve_cancelled(job.id)
        except Exception as e:           # noqa: BLE001 — job isolation
            self.registry.counter("daemon.jobs", outcome="failed").inc()
            self.queue.resolve_failed(job.id, f"{type(e).__name__}: {e}")

    # ---- cancellation -----------------------------------------------------------
    def cancel(self, job_id: int) -> Dict[str, Any]:
        status = self.queue.cancel(job_id)   # KeyError -> 404 upstream
        if status == "running":
            with self._lock:
                ev = self._stops.setdefault(job_id, threading.Event())
            ev.set()
            return {"id": job_id, "state": "cancelling"}
        if status == "terminal":
            job = self.queue.get(job_id)
            return {"id": job_id, "state": job.state,
                    "error": "job already resolved"}
        self.registry.counter("daemon.jobs", outcome="cancelled").inc()
        return {"id": job_id, "state": "cancelled"}

    # ---- views ------------------------------------------------------------------
    def job_view(self, job: QueuedJob, *, progress: bool = False
                 ) -> Dict[str, Any]:
        d = job.to_dict()
        d["deduped"] = job.attached_to is not None
        if progress:
            with self._lock:
                col = self._collectors.get(job.id)
            if col is None and job.attached_to is not None:
                with self._lock:
                    col = self._collectors.get(job.attached_to)
            d["progress"] = col.progress_records() if col is not None else []
            if job.state == "done" and job.key is not None:
                try:
                    art = self.store.load_key(job.key)
                except StoreError:
                    art = None
                if art is not None:
                    d["summary"] = art.summary()
        return d

    def metrics_view(self) -> Dict[str, Any]:
        return {
            "metrics": self.registry.snapshot(),
            "jobs": self.queue.counts(),
            "store": self.store.stats(),
            "daemon": {"searches_run": self.searches_run,
                       "store_hits": self.store_hits,
                       "workers": self.workers},
        }


def _make_handler(svc: ScheduleDaemon) -> type:
    """Bind the request handler class to one daemon instance."""

    class Handler(BaseHTTPRequestHandler):
        server_version = "repro-daemon/1"
        protocol_version = "HTTP/1.1"

        def log_message(self, format: str, *args: Any) -> None:
            pass                         # the journal is the record

        # ---- plumbing ----------------------------------------------------
        def _send(self, code: int, obj: Dict[str, Any]) -> None:
            body = json.dumps(obj, sort_keys=True).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, msg: str) -> None:
            self._send(code, {"error": msg})

        def _body(self) -> Dict[str, Any]:
            n = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(n) if n else b""
            if not raw:
                return {}
            obj = json.loads(raw)
            if not isinstance(obj, dict):
                raise ValueError("body must be a JSON object")
            return obj

        def _job_id(self, path: str) -> Optional[int]:
            tail = path[len("/jobs/"):]
            return int(tail) if tail.isdigit() else None

        # ---- methods -----------------------------------------------------
        def do_GET(self) -> None:        # noqa: N802 — http.server contract
            path = self.path.split("?", 1)[0].rstrip("/") or "/"
            try:
                if path == "/healthz":
                    self._send(200, {"ok": True})
                elif path == "/metrics":
                    self._send(200, svc.metrics_view())
                elif path == "/jobs":
                    self._send(200, {"jobs": [svc.job_view(j) for j in
                                              svc.queue.list_jobs()]})
                elif path.startswith("/jobs/"):
                    jid = self._job_id(path)
                    if jid is None or jid not in svc.queue.jobs:
                        self._error(404, "no such job")
                        return
                    self._send(200, svc.job_view(svc.queue.get(jid),
                                                 progress=True))
                elif path.startswith("/artifacts/"):
                    key = path[len("/artifacts/"):]
                    if not _hex_key(key):
                        self._error(404, "bad artifact key")
                        return
                    try:
                        art = svc.store.load_key(key)
                    except StoreError as e:
                        self._error(500, str(e))
                        return
                    if art is None:
                        self._error(404, "no such artifact")
                        return
                    self._send(200, art.to_dict())
                else:
                    self._error(404, "unknown path")
            except Exception as e:       # noqa: BLE001 — request isolation
                self._error(500, f"{type(e).__name__}: {e}")

        def do_POST(self) -> None:       # noqa: N802 — http.server contract
            path = self.path.split("?", 1)[0].rstrip("/")
            if path != "/jobs":
                self._error(404, "unknown path")
                return
            try:
                payload = self._body()
            except ValueError as e:
                self._error(400, f"bad JSON body: {e}")
                return
            try:
                self._send(201, svc.submit(payload))
            except DaemonError as e:
                self._error(400, str(e))
            except Exception as e:       # noqa: BLE001 — request isolation
                self._error(500, f"{type(e).__name__}: {e}")

        def do_DELETE(self) -> None:     # noqa: N802 — http.server contract
            path = self.path.split("?", 1)[0].rstrip("/")
            if not path.startswith("/jobs/"):
                self._error(404, "unknown path")
                return
            jid = self._job_id(path)
            if jid is None:
                self._error(404, "no such job")
                return
            try:
                out = self.cancel_view(jid)
            except KeyError:
                self._error(404, "no such job")
                return
            code = 409 if out.get("error") else 200
            self._send(code, out)

        def cancel_view(self, jid: int) -> Dict[str, Any]:
            return svc.cancel(jid)

    return Handler
