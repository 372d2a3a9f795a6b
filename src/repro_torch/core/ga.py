"""Genetic algorithm for multilayer scheduling (paper Alg. 1, §III-B).

Faithful to the paper's configuration:

* population ``P = 100`` fusion states, initialized at the layer-by-layer
  schedule (every edge split);
* each generation applies ``C`` mutations — choose an adjacent layer pair and
  *combine* or *separate* it (Fig. 8b) — evaluates the offspring, and adds
  them to the pool;
* fitness ``F = Eval_layerwise / Eval_new`` on the chosen objective (EDP by
  default, "as it provided the most useful information");
* survivors are the Top-``N = 10`` by fitness **plus a few random** pool
  members "to ensure we do not quickly converge to a poor local minimum",
  and the pool is **topped back up to P** with fresh mutants of survivors
  (earlier revisions silently capped the live pool at N + random_survivors,
  making ``population`` dead configuration);
* ``G = 500`` generations.

The selection loop itself is genome-agnostic: :func:`run_ga_problem` runs
Alg. 1 against any :class:`repro_torch.core.problem.SearchProblem` (fusion states,
TPU schedules, ...), and :func:`run_ga` is the fusion-problem entry point —
it delegates to the same loop through
:class:`repro_torch.core.problem.FusionProblem`, making exactly the RNG calls of
earlier revisions so fixed-seed results are bit-for-bit unchanged.  Whole
generations are scored through ``problem.fitness_batch`` (backed by
``Evaluator.fitness_batch`` when available), which dedupes offspring against
the evaluator's group-cost cache before costing only novel groups.

``repro_torch.search`` packages this loop (plus random / hill-climb / exhaustive
alternatives) behind a declarative spec -> session -> artifact facade; new
callers should go through that instead of invoking ``run_ga`` directly.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

from operator import itemgetter

from repro_torch.core.graph import LayerGraph
from repro_torch.core.problem import FusionProblem, SearchProblem

_first = itemgetter(0)


@dataclass(frozen=True)
class GAConfig:
    population: int = 100          # P
    top_n: int = 10                # N
    generations: int = 500         # G
    mutations_per_gen: int = 100   # C (one offspring per mutation)
    random_survivors: int = 10     # "some random scores"
    objective: str = "edp"
    seed: int = 0
    # beyond-paper: uniform crossover between two parents before mutating
    # (0.0 = paper-faithful mutation-only operators)
    crossover_rate: float = 0.0

    @classmethod
    def paper(cls, **kw) -> "GAConfig":
        return cls(**kw)

    @classmethod
    def fast(cls, generations: int = 40, **kw) -> "GAConfig":
        """CPU-friendly setting for tests/benchmarks; same operators."""
        return cls(population=40, top_n=8, generations=generations,
                   mutations_per_gen=40, random_survivors=6, **kw)


@dataclass
class GAResult:
    """Outcome of one search run (any backend, any genome).

    ``best_state`` is whatever genome type the searched problem uses — a
    :class:`repro_torch.core.fusion.FusionState` for the paper's problem, a
    :class:`repro_torch.costmodel.tpu_model.TpuSchedule` for the TPU retarget.
    """

    best_state: object
    best_fitness: float
    history: List[float] = field(default_factory=list)   # best fitness per gen
    evaluations: int = 0              # unique genomes scored
    offspring_evaluated: int = 0      # offspring submitted for scoring

    @property
    def generations_run(self) -> int:
        return len(self.history)


# Observer called once per generation with (generation index, best fitness so
# far, unique evaluations, offspring evaluated); returning True stops the
# search after that generation (budget/patience hooks in repro_torch.search).
GAObserver = Callable[[int, float, int, int], Optional[bool]]

# Migration hook called once per generation with (generation index, pool of
# (fitness, genome) entries) after selection and top-up; returning a list
# replaces the pool (island-model elite exchange in repro.search.island),
# returning None keeps it.  The hook must not consume RNG — per-island
# determinism is what makes island runs reproducible.
GAMigrate = Callable[[int, List[Tuple[float, object]]],
                     Optional[List[Tuple[float, object]]]]


def select_pool(entries: Sequence[Tuple[float, object]], top_n: int,
                random_survivors: int, rng: random.Random,
                key: Callable[[object], Hashable] = lambda s: s
                ) -> List[Tuple[float, object]]:
    """Paper Alg. 1 survivor selection, shared by the fusion and TPU GAs.

    Dedupes ``entries`` by genome ``key`` (keeping the best-ranked copy),
    returns the Top-``top_n`` plus ``random_survivors`` shuffled others.
    Zero-fitness (invalid) genomes are excluded from the random-survivor
    draw: they can never win and only breed more invalid offspring.
    """
    seen = set()
    unique: List[Tuple[float, object]] = []
    # stable descending sort == ascending sort on the negated key, so ties
    # keep their original order either way
    for f, s in sorted(entries, key=_first, reverse=True):
        k = key(s)
        if k in seen:
            continue
        seen.add(k)
        unique.append((f, s))
    top = unique[:top_n]
    rest = [fs for fs in unique[top_n:] if fs[0] > 0.0]
    rng.shuffle(rest)
    return top + rest[:random_survivors]


def run_ga_problem(problem: SearchProblem, config: GAConfig = GAConfig(),
                   observer: Optional[GAObserver] = None,
                   migrate: Optional[GAMigrate] = None) -> GAResult:
    """Run Alg. 1 against any :class:`SearchProblem`.

    ``observer`` (if given) is called after every generation and may return
    True to stop early — this is how ``repro_torch.search`` sessions implement
    evaluation budgets and no-improvement patience without the loop knowing
    about either.  ``migrate`` (if given) may replace the pool at the end of
    each generation — this is the island-model elite-exchange hook
    (``repro.search.island``); with ``migrate=None`` the loop's behavior is
    bit-for-bit that of earlier revisions.
    """
    rng = random.Random(config.seed)
    # bound locals for the per-offspring hot path; getrandbits drives an
    # inlined _randbelow identical to CPython's (same draws as rng.randrange)
    getrandbits = rng.getrandbits
    pkey = problem.key
    pmut = problem.mutate
    pbatch_unique = getattr(problem, "fitness_batch_unique", None)
    fit_cache: Dict[Hashable, float] = {}
    offspring_evaluated = 0

    def score(states: List) -> List[float]:
        """Fitness per genome, via the run-level cache; novel genomes are
        scored in one batch so the evaluator can dedupe shared structure.
        The fresh list is unique by construction, so problems exposing
        ``fitness_batch_unique`` skip their own dedup pass."""
        keys = [pkey(s) for s in states]
        fresh: Dict[Hashable, object] = {}
        for k, s in zip(keys, states):
            if k not in fit_cache and k not in fresh:
                fresh[k] = s
        if fresh:
            vals = list(fresh.values())
            fits = (pbatch_unique(vals) if pbatch_unique is not None
                    else problem.fitness_batch(vals))
            fit_cache.update(zip(fresh, fits))
        return [fit_cache[k] for k in keys]

    # warm-start seeding (repro.serve.warmstart): extra genomes scored into
    # the initial pool alongside the canonical start.  With no seeds (the
    # default) the pool is exactly ``[initial]`` and every subsequent RNG
    # draw is bit-identical to the unseeded loop; seeds widen the first
    # generation's parent-index range, which is why seeding is opt-in.
    init = problem.initial()
    starters: List = [init]
    seen_keys = {pkey(init)}
    for seed_genome in getattr(problem, "seed_genomes", ()) or ():
        k = pkey(seed_genome)
        if k not in seen_keys:
            seen_keys.add(k)
            starters.append(seed_genome)
    pool: List[Tuple[float, object]] = list(zip(score(starters), starters))
    history: List[float] = []

    for gen in range(config.generations):
        offspring: List = []
        npool = len(pool)
        kbits = npool.bit_length()
        for _ in range(config.mutations_per_gen):
            r = getrandbits(kbits)
            while r >= npool:
                r = getrandbits(kbits)
            parent = pool[r][1]
            if config.crossover_rate and rng.random() < config.crossover_rate \
                    and len(pool) > 1:
                other = pool[rng.randrange(len(pool))][1]
                parent = problem.crossover(parent, other, rng)
            offspring.append(pmut(parent, rng))
        fits = score(offspring)
        offspring_evaluated += len(offspring)

        pool = select_pool(pool + list(zip(fits, offspring)),
                           config.top_n, config.random_survivors, rng,
                           key=problem.key)
        # keep the pool topped up to the paper's full P with fresh mutants of
        # survivors (duplicates allowed; next generation dedupes); parents are
        # picked by size-2 tournament over the rank-sorted survivor list, which
        # balances intensification around the elite against survivor diversity
        if len(pool) < config.population:
            need = config.population - len(pool)
            n_surv = len(pool)
            sbits = n_surv.bit_length()
            topup = []
            for _ in range(need):
                i = getrandbits(sbits)
                while i >= n_surv:
                    i = getrandbits(sbits)
                j = getrandbits(sbits)
                while j >= n_surv:
                    j = getrandbits(sbits)
                topup.append(pmut(pool[i if i < j else j][1], rng))
            tfits = score(topup)
            offspring_evaluated += len(topup)
            pool.extend(zip(tfits, topup))
        if migrate is not None:
            migrated = migrate(gen, pool)
            if migrated is not None:
                pool = migrated
        history.append(max(f for f, _ in pool))
        if observer is not None and observer(gen, history[-1], len(fit_cache),
                                             offspring_evaluated):
            break

    best_f, best_s = max(pool, key=lambda fs: fs[0])
    # batch scoring may re-associate float sums (~1 ulp); report the winner's
    # exact single-state fitness so results are comparable across engines
    best_f = problem.fitness(best_s)
    return GAResult(best_state=best_s, best_fitness=best_f,
                    history=history, evaluations=len(fit_cache),
                    offspring_evaluated=offspring_evaluated)


def run_ga(graph: LayerGraph, evaluator, config: GAConfig = GAConfig(),
           observer: Optional[GAObserver] = None) -> GAResult:
    """Run Alg. 1 on the paper's fusion problem.  ``evaluator.fitness(state,
    objective) -> float`` with 0 meaning invalid."""
    problem = FusionProblem(graph, evaluator, config.objective)
    return run_ga_problem(problem, config, observer)
