"""Island-model parallel GA: N independent Alg.-1 populations with ring
migration of elites (the ``island`` search backend).

Each island runs the paper's GA (:func:`repro_torch.core.ga.run_ga_problem`) on
its own process with a deterministically derived seed; every
``migrate_every`` generations the islands synchronize and island ``i``'s
top ``migrants`` genomes replace the worst pool entries of island
``(i+1) % islands`` (a ring).  Because migration is synchronous and
consumes no RNG, a fixed-seed island run is exactly reproducible — and at
``islands=1`` the backend *is* the ``ga`` backend: it delegates straight
to ``run_ga_problem`` with the same config and seed, so results are
bit-identical (pinned by ``tests/test_island.py``).

Workers default to ``multiprocessing`` processes; only integer genome
masks and fitness floats cross process boundaries at the barriers, via
``SearchProblem.encode_genome``/``decode_genome``.  The port's copy of
``repro/search/island.py`` picks the start method by device
(:func:`_start_method`):

* **CUDA** (the evaluator's label pass on the card, or a process that has
  already initialised CUDA): ``spawn``.  A process that has touched CUDA
  cannot use it in a forked child, so each island starts a fresh
  interpreter and receives the search problem pickled: no CUDA tensor
  crosses (the engine's device tables and any telemetry collector stay
  behind, ``__getstate__``), the child resolves its own device and its
  engine launches ``csrc/ga_labels.cu`` itself.  A child that finds no card
  raises, and the parent surfaces that as a :class:`BackendError`.  The
  parent loads the label kernel's library before spawning, so the islands
  do not all build it.
* **CPU**: ``fork``, as the reference (the problem and its caches are
  inherited copy-on-write).

Every island process sets ``torch.set_num_threads(1)`` first (forking
after torch has run ops can hang a child in OpenMP, and the islands are
the parallelism).  Where no process may be started — this process is a
daemonic pool worker (a ``BatchScheduler`` search worker) — the backend
falls back to threads: identical semantics and results, no parallel
speedup.  Thread islands share one evaluator, whose batch lock
(``Evaluator._lock``) serialises the engine's group table; the reference
races there.

Session budget/patience apply at sync barriers: the parent aggregates
island stats there and broadcasts stop.  Barriers happen every
``migrate_every`` generations *and at least* every ``OBSERVE_EVERY_MAX``
(observation-only — no migrants move), so early-stop granularity is
``min(migrate_every, OBSERVE_EVERY_MAX)`` generations rather than one,
and a huge ``migrate_every`` can never disable the budget entirely.
Note the unit shift this implies for patience: a session "step" here is
one *barrier*, not one generation (``SearchSpec.patience`` counts
backend-defined steps — same convention as random/exhaustive's chunks),
so ``patience=5`` tolerates up to ``5 * min(migrate_every,
OBSERVE_EVERY_MAX)`` stale generations per island.
"""
from __future__ import annotations

import hashlib
import pickle
import queue
import threading
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.ga import GAConfig, GAResult, run_ga_problem
from repro_torch.core.problem import SearchProblem
from repro_torch.obs import clock

from repro_torch.search.backends import (GABackend, Observer, SearchBackend,
                                         BackendError)
from repro_torch.search.registry import register_backend

#: parent <-> island handshake timeout (seconds); a worker that dies mid-run
#: surfaces as a BackendError instead of a silent deadlock
SYNC_TIMEOUT_S = 600.0

#: ceiling on generations between parent observations: even when
#: ``migrate_every`` is large (or larger than the run), islands still
#: barrier at least this often so session budget/patience can stop them
#: (observation-only syncs exchange no migrants — trajectories unchanged)
OBSERVE_EVERY_MAX = 10


def island_seed(seed: int, island: int) -> int:
    """Deterministic per-island seed: island 0 keeps the caller's seed (so
    island 0 reproduces the ``ga`` backend's RNG stream exactly); the rest
    draw 64 bits from sha256 over (seed, island)."""
    if island == 0:
        return seed
    h = hashlib.sha256(f"island:{seed}:{island}".encode()).digest()
    return int.from_bytes(h[:8], "big")


def inject_migrants(problem: SearchProblem,
                    pool: List[Tuple[float, object]],
                    immigrants: List[Tuple[float, object]]
                    ) -> List[Tuple[float, object]]:
    """Replace the pool's worst entries with decoded immigrants (dropping
    any already present by genome key).  Deterministic: sorts by fitness
    only, consumes no RNG, and never evicts the pool's best."""
    present = {problem.key(g) for _, g in pool}
    fresh = []
    for f, enc in immigrants:
        g = problem.decode_genome(enc)
        k = problem.key(g)
        if k not in present:
            present.add(k)
            fresh.append((f, g))
    if not fresh:
        return pool
    ranked = sorted(pool, key=lambda fs: -fs[0])
    return ranked[:max(len(ranked) - len(fresh), 1)] + fresh


class _Chan:
    """Duplex channel a worker shares with the parent: a multiprocessing
    Pipe connection or (thread fallback) a pair of queues."""

    def __init__(self, conn=None, inbox=None, outbox=None):
        self._conn = conn
        self._inbox = inbox
        self._outbox = outbox

    def send(self, msg) -> None:
        if self._conn is not None:
            self._conn.send(msg)
        else:
            self._outbox.put(msg)

    def recv(self, timeout: Optional[float] = None):
        if timeout is None:                 # read at call time (tests lower it)
            timeout = SYNC_TIMEOUT_S
        if self._conn is not None:
            # poll() also returns True when the peer hard-died (closed
            # pipe); recv() then raises EOFError — normalize both ends of
            # "the worker is gone" onto TimeoutError for recv_all
            if not self._conn.poll(timeout):
                raise TimeoutError("island worker did not sync in time")
            try:
                return self._conn.recv()
            except (EOFError, OSError):
                raise TimeoutError(
                    "island worker died (connection closed) — killed by "
                    "the OS (OOM?) or crashed outside Python") from None
        try:
            return self._inbox.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError("island worker did not sync in time") from None


def _sync_gens(generations: int, migrate_every: int) -> List[int]:
    """Generations at which all islands barrier with the parent: every
    ``migrate_every``-th (elite exchange) plus at least every
    ``OBSERVE_EVERY_MAX``-th (observation only: budget/patience checks,
    no migrants), except on the very last generation (the final
    cross-island max already sees every island's best, and stopping there
    stops nothing)."""
    cadence = min(migrate_every, OBSERVE_EVERY_MAX)
    return [g for g in range(generations)
            if ((g + 1) % migrate_every == 0 or (g + 1) % cadence == 0)
            and g + 1 < generations]


def _island_worker(problem: SearchProblem, config: GAConfig,
                   sync_gens: List[int], migration_gens: List[int],
                   migrants: int, chan: _Chan,
                   report_engine: bool = False) -> None:
    """One island: run the full GA, pausing at each sync generation to trade
    elites through the parent; ends with a ("done", ...) result message,
    whose last field is this island's :func:`_island_info` (its engine
    stats only when ``report_engine``: a process island owns its engine,
    thread islands share the parent's)."""
    sync_set = set(sync_gens)
    migration_set = set(migration_gens)
    stop = [False]
    first_gen = []                       # wall time the first generation ended

    stats = [0.0, 0, 0]                  # best / evals / offspring so far

    def migrate(gen, pool):
        if gen not in sync_set:
            return None
        # elites ride the sync message only when this barrier actually
        # migrates; observation-only barriers ship stats alone (the parent
        # would discard the elites anyway, so payloads stay minimal and
        # results are unchanged)
        if gen in migration_set:
            elite = sorted(pool, key=lambda fs: -fs[0])[:migrants]
            payload = [(f, problem.encode_genome(g)) for f, g in elite]
        else:
            payload = []
        # best is current; evals/offspring lag one generation (the observer
        # updates them after migration) — budget checks are coarse anyway
        chan.send(("sync", gen, payload,
                   (max(f for f, _ in pool), stats[1], stats[2])))
        cmd, immigrants = chan.recv()
        if cmd == "stop":
            stop[0] = True
        return inject_migrants(problem, pool, immigrants)

    def observe(gen, best, evals, offspring):
        if not first_gen:
            first_gen.append(clock.now())
        stats[0], stats[1], stats[2] = best, evals, offspring
        return stop[0]

    try:
        res = run_ga_problem(problem, config, observe, migrate=migrate)
        chan.send(("done", problem.encode_genome(res.best_state),
                   res.best_fitness, res.history, res.evaluations,
                   res.offspring_evaluated,
                   _island_info(problem, report_engine,
                                first_gen[0] if first_gen else None)))
    except BaseException as e:                      # surface, don't deadlock
        chan.send(("error", f"{type(e).__name__}: {e}"))
        raise


def _island_info(problem, report_engine: bool,
                 first_gen_unix: Optional[float]) -> Dict[str, Any]:
    """What an island reports besides its GA result (kept on the backend,
    never written into the artifact): when its first generation ended, and
    its population engine's stats (backend, batches, label launches)."""
    engine = None
    if report_engine:
        from repro_torch.kernels.ga_labels.ops import ga_labels
        pop = getattr(getattr(problem, "evaluator", None), "_pop", None)
        if pop is not None:
            engine = {**pop.stats(),
                      "label_variants": dict(ga_labels.variant_launches)}
    return {"first_gen_unix": first_gen_unix, "engine": engine}


def _island_process(problem, config: GAConfig, sync_gens: List[int],
                    migration_gens: List[int], migrants: int,
                    chan: _Chan) -> None:
    """Entry of an island process.  One intra-op thread first (as PyTorch's
    DataLoader workers do).  Under ``spawn`` the problem arrives pickled and
    is rebuilt here, so a failure to rebuild it (no card for a CUDA
    evaluator) goes back to the parent as an error message."""
    import torch

    from repro_torch.kernels.ga_labels.ops import ga_labels
    torch.set_num_threads(1)
    # this process's launches only (a forked child inherits the parent's)
    ga_labels.variant_launches = dict.fromkeys(ga_labels.variant_launches, 0)
    if isinstance(problem, bytes):
        try:
            problem = pickle.loads(problem)
        except BaseException as e:
            chan.send(("error", f"{type(e).__name__}: {e}"))
            raise
    _island_worker(problem, config, sync_gens, migration_gens, migrants,
                   chan, report_engine=True)


def _start_method(device) -> str:
    """``spawn`` for a CUDA evaluator, or once this process has initialised
    CUDA (its forked child could not use the card, and forking a live CUDA
    context is not safe); ``fork`` on the CPU, as the reference."""
    import torch
    if getattr(device, "type", None) == "cuda" or torch.cuda.is_initialized():
        return "spawn"
    return "fork"


def _process_context(device):
    """The multiprocessing context of :func:`_start_method`, or None when
    island processes cannot be started here: that method does not exist on
    this platform, or this process is itself a daemonic pool worker (e.g. a
    BatchScheduler search worker) — daemons may not have children, so
    islands degrade to threads."""
    import multiprocessing
    if multiprocessing.current_process().daemon:
        return None
    try:
        return multiprocessing.get_context(_start_method(device))
    except ValueError:
        return None


@register_backend("island")
class IslandBackend(SearchBackend):
    """Island-model parallel GA (ring migration of elites).

    Config keys: ``islands`` (parallel populations, default 4),
    ``migrate_every`` (generations between elite exchanges, default 20),
    ``migrants`` (elites shipped around the ring per exchange, default 2),
    ``workers`` (``"process"`` | ``"thread"``, default ``"process"``:
    ``spawn`` on CUDA, ``fork`` on the CPU, with a thread fallback where no
    process may be started) — plus every ``ga`` backend
    key (``preset``, ``generations``, ``population``, ``top_n``,
    ``mutations_per_gen``, ``random_survivors``, ``crossover_rate``,
    ``ga_config``), which configures each island identically.  Island ``i``
    searches with the deterministic seed ``island_seed(seed, i)``; at
    ``islands=1`` the run is bit-identical to the ``ga`` backend.

    After a run, ``start_method`` names how the islands ran (``spawn``,
    ``fork``, ``thread``, or None at ``islands=1``) and ``island_info``
    holds one dict per island (``first_gen_s``: seconds from starting the
    islands to the end of its first generation; ``engine``: a process
    island's engine stats, None for threads).  Neither enters the artifact.
    """

    name = "island"

    def __init__(self) -> None:
        self.start_method: Optional[str] = None
        self.island_info: List[Dict[str, Any]] = []

    def run(self, problem: SearchProblem, *, seed: int = 0,
            observer: Optional[Observer] = None, **config) -> GAResult:
        islands = int(config.pop("islands", 4))
        migrate_every = int(config.pop("migrate_every", 20))
        migrants = int(config.pop("migrants", 2))
        workers = config.pop("workers", "process")
        if islands < 1:
            raise BackendError(f"islands must be >= 1, got {islands}")
        if migrate_every < 1:
            raise BackendError(
                f"migrate_every must be >= 1, got {migrate_every}")
        if migrants < 1:
            raise BackendError(f"migrants must be >= 1, got {migrants}")
        if workers not in ("process", "thread"):
            raise BackendError(
                f"unknown workers mode {workers!r}; valid: process, thread")
        gc = config.get("ga_config")
        if islands > 1 and (isinstance(gc, GAConfig) or
                            (isinstance(gc, dict) and "seed" in gc)):
            # a ga_config seed wins inside make_config (ga-backend
            # semantics), which would collapse every island onto one seed
            # — N identical searches, migration a no-op
            raise BackendError(
                "island derives per-island seeds from SearchSpec.seed; "
                "pass ga_config as a dict without a seed (a live GAConfig "
                "always carries one)")
        configs = [GABackend.make_config(island_seed(seed, i), **dict(config))
                   for i in range(islands)]
        self.start_method, self.island_info = None, []
        if islands == 1:
            # the degenerate archipelago IS the ga backend — delegate so
            # fixed-seed results are bit-identical (no migration machinery)
            return run_ga_problem(problem, configs[0], observer)
        sync_gens = _sync_gens(configs[0].generations, migrate_every)
        migration_gens = [g for g in sync_gens
                          if (g + 1) % migrate_every == 0]
        device = getattr(getattr(problem, "evaluator", None), "device", None)
        ctx = _process_context(device) if workers == "process" else None
        # build every read-only shared structure BEFORE starting the
        # islands so workers inherit (fork) or receive (spawn) the compiled
        # graph, baseline costs, and population-engine tables instead of
        # each rebuilding them
        prewarm = getattr(problem, "prewarm", None)
        if prewarm is not None:
            prewarm()
        if getattr(device, "type", None) == "cuda":
            from repro_torch.kernels import _build
            _build.library("ga_labels")        # built once, here
        self.start_method = "thread" if ctx is None else \
            ctx.get_start_method()
        t0 = clock.now()
        chans, workers_alive = self._spawn(problem, configs, sync_gens,
                                           migration_gens, migrants, ctx)
        try:
            result, infos = self._drive(problem, chans, sync_gens,
                                        migrate_every, observer)
        finally:
            for w in workers_alive:
                w.join(timeout=30)
                if ctx is not None and w.is_alive():
                    w.terminate()          # hung past its barrier: stop it
        self.island_info = [
            {"first_gen_s": None if info["first_gen_unix"] is None
             else info["first_gen_unix"] - t0, "engine": info["engine"]}
            for info in infos]
        return result

    # ---- parent side ------------------------------------------------------------
    @staticmethod
    def _spawn(problem, configs, sync_gens, migration_gens, migrants, ctx):
        chans: List[_Chan] = []
        alive = []
        if ctx is not None and ctx.get_start_method() != "fork":
            # pickled once for every island; unpickled inside the child's
            # error handling (_island_process)
            problem = pickle.dumps(problem)
        for cfg in configs:
            if ctx is not None:
                parent_conn, child_conn = ctx.Pipe(duplex=True)
                chan_child = _Chan(conn=child_conn)
                w = ctx.Process(target=_island_process,
                                args=(problem, cfg, sync_gens,
                                      migration_gens, migrants,
                                      chan_child), daemon=True)
                w.start()
                child_conn.close()      # parent keeps only its end
                chans.append(_Chan(conn=parent_conn))
                alive.append(w)
                continue
            to_child: queue.Queue = queue.Queue()
            to_parent: queue.Queue = queue.Queue()
            chan_child = _Chan(inbox=to_child, outbox=to_parent)
            w = threading.Thread(target=_island_worker,
                                 args=(problem, cfg, sync_gens,
                                       migration_gens, migrants,
                                       chan_child), daemon=True)
            chans.append(_Chan(inbox=to_parent, outbox=to_child))
            w.start()
            alive.append(w)
        return chans, alive

    @staticmethod
    def _drive(problem, chans, sync_gens, migrate_every, observer
               ) -> Tuple[GAResult, List[Dict[str, Any]]]:
        n = len(chans)
        # telemetry collector the session attached (repro_torch.obs), or None;
        # records barriers/migrations only — never feeds the stop decision
        col = getattr(problem, "obs", None)

        def recv_all(expect: str):
            msgs = []
            for i, chan in enumerate(chans):
                try:
                    msg = chan.recv()
                except TimeoutError as e:
                    raise BackendError(f"island {i}: {e}") from None
                if msg[0] == "error":
                    raise BackendError(f"island {i} failed: {msg[1]}")
                if msg[0] != expect:
                    raise BackendError(
                        f"island {i}: expected {expect!r}, got {msg[0]!r}")
                msgs.append(msg)
            return msgs

        try:
            stopped = False
            for gen in sync_gens:
                msgs = recv_all("sync")
                best = max(m[3][0] for m in msgs)
                evals = sum(m[3][1] for m in msgs)
                offspring = sum(m[3][2] for m in msgs)
                if observer is not None and observer(gen, best, evals,
                                                    offspring):
                    stopped = True
                migration = (gen + 1) % migrate_every == 0
                if col is not None:
                    col.record_migration(gen, best, n, migration)
                for i, chan in enumerate(chans):
                    # ring: island i receives island (i-1)'s elites; at
                    # observation-only syncs nothing migrates
                    emigrants = msgs[(i - 1) % n][2] if migration else []
                    chan.send(("stop" if stopped else "cont", emigrants))
                if stopped:
                    break
            results = recv_all("done")
        except BackendError:
            # one island died: release the healthy islands blocked (or soon
            # to block) at their sync barrier so they wind down now instead
            # of stalling the join and running until the recv timeout
            for chan in chans:
                try:
                    chan.send(("stop", []))
                except (OSError, ValueError):
                    pass                     # that island's pipe is gone
            raise
        # per-island GAResults; the archipelago's answer is the best across
        # islands (ties break toward the lowest island id, so islands=N is
        # never worse than any single member island at the same seed)
        best_i = max(range(n), key=lambda i: results[i][2])
        _, enc, best_f, history, _evals, _off, _info = results[best_i]
        merged_hist = [max(h) for h in zip(*(m[3] for m in results))]
        return GAResult(
            best_state=problem.decode_genome(enc),
            best_fitness=best_f,
            history=merged_hist,
            # unique-per-island sums: cross-island duplicates are not
            # distinguishable without shipping every key home, so this is
            # an upper bound on globally unique genomes
            evaluations=sum(m[4] for m in results),
            offspring_evaluated=sum(m[5] for m in results)), \
            [m[6] for m in results]
