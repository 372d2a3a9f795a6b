"""Pluggable search strategies over a :class:`~repro_torch.core.problem.SearchProblem`.

Every backend implements one method —

    run(problem, seed=..., observer=..., **config) -> GAResult

— where ``observer(step, best_fitness, evaluations, offspring_evaluated)``
is called as the search progresses and may return True to stop early (the
session layers budgets/patience on top of it).  All backends return the
same :class:`repro_torch.core.ga.GAResult`, so sessions, artifacts, and reports
are strategy-agnostic.

Built-ins:

* ``ga``         — the paper's Alg. 1 (reference implementation:
                   :func:`repro_torch.core.ga.run_ga_problem`);
* ``random``     — uniform random genomes (or random walks when the problem
                   cannot sample uniformly), the paper's natural lower bound;
* ``hill_climb`` — greedy best-improvement over one-mutation (combine /
                   separate) neighborhoods;
* ``exhaustive`` — enumerate the whole space, up to a guard ``limit``
                   (default 2^16 states, the paper's §III-A sizing of
                   VGG-16's space over conv layers; this IR also genomes
                   pool/input edges — vgg16 here has 21 edges, so pass
                   ``limit`` explicitly to exhaust it).

New strategies subclass :class:`SearchBackend` and register with
``@register_backend("name")``.
"""
from __future__ import annotations

import itertools
import random
import time
from typing import Callable, List, Optional

from repro_torch.core.ga import GAConfig, GAResult, run_ga_problem
from repro_torch.core.problem import SearchProblem

from repro_torch.search.registry import register_backend

Observer = Callable[[int, float, int, int], Optional[bool]]

#: default exhaustive-search ceiling, the paper's §III-A sizing of VGG-16's
#: space (2^16 over conv layers; overridable per-run via config limit)
EXHAUSTIVE_LIMIT = 1 << 16

#: batch size for backends that score genomes through ``fitness_batch``
_CHUNK = 128

#: batch size when the problem advertises an array-native batched evaluator
#: (amortizing per-batch engine overhead matters more than history
#: granularity for full enumerations)
_CHUNK_BATCHED = 1024


def _batch_chunk(problem: SearchProblem) -> int:
    """Chunk size for ``fitness_batch`` loops: bigger when the problem's
    evaluator batches through the array-native population engine."""
    ev = getattr(problem, "evaluator", None)
    if getattr(ev, "_pop_mode", "off") != "off":
        return _CHUNK_BATCHED
    return _CHUNK


def _estimate_runtime_s(problem: SearchProblem, size: int,
                        probe: int = 256) -> Optional[float]:
    """Rough full-enumeration runtime from one timed probe batch of random
    genomes; None when the problem cannot sample or scoring fails."""
    sampler = getattr(problem, "random_genome", None)
    if sampler is None:
        return None
    try:
        rng = random.Random(0)
        states = [sampler(rng) for _ in range(min(probe, size))]
        t0 = time.perf_counter()
        problem.fitness_batch(states)
        dt = time.perf_counter() - t0
    except Exception:
        return None
    if dt <= 0 or not states:
        return None
    return size * dt / len(states)


def _fmt_eta(seconds: float) -> str:
    if seconds < 120:
        return f"{seconds:.1f}s"
    if seconds < 7200:
        return f"{seconds / 60:.1f}min"
    return f"{seconds / 3600:.1f}h"


class BackendError(ValueError):
    """A backend cannot run with the given problem/config."""


class SearchBackend:
    """Base class for search strategies; subclasses set ``name`` and
    implement :meth:`run`."""

    name = "backend"

    def run(self, problem: SearchProblem, *, seed: int = 0,
            observer: Optional[Observer] = None, **config) -> GAResult:
        raise NotImplementedError

    @staticmethod
    def _reject_unknown(config, *known):
        unknown = set(config) - set(known)
        if unknown:
            raise BackendError(
                f"unknown backend config keys: {sorted(unknown)}; "
                f"valid: {sorted(known)}")


@register_backend("ga")
class GABackend(SearchBackend):
    """Paper Alg. 1 (§III-B) — the reference backend.

    Config keys mirror :class:`GAConfig` (``population``, ``top_n``,
    ``generations``, ``mutations_per_gen``, ``random_survivors``,
    ``crossover_rate``) plus ``preset`` (``"paper"`` | ``"fast"``); a
    prebuilt ``GAConfig`` can be passed as ``ga_config``.  The objective
    comes from the spec/problem, not from here.
    """

    name = "ga"

    @staticmethod
    def make_config(seed: int = 0, **config) -> GAConfig:
        if "objective" in config:
            raise BackendError(
                "set the objective via SearchSpec.objective "
                "(CLI: --objective), not backend_config")
        cfg = config.pop("ga_config", None)
        if cfg is not None:
            if config:
                raise BackendError(
                    "ga_config is exclusive with other config keys "
                    f"(got {sorted(config)})")
            if isinstance(cfg, GAConfig):
                return cfg
            if not isinstance(cfg, dict):
                raise BackendError(
                    f"ga_config must be a GAConfig or a dict of its "
                    f"fields, got {type(cfg).__name__}")
            # a JSON-round-tripped spec carries the config as a plain dict;
            # its own seed (if any) wins, like a live GAConfig's does
            try:
                return GAConfig(**{"seed": seed, **cfg})
            except TypeError as e:
                raise BackendError(f"bad ga_config: {e}") from None
        preset = config.pop("preset", "paper")
        maker = {"paper": GAConfig.paper, "fast": GAConfig.fast}.get(preset)
        if maker is None:
            raise BackendError(
                f"unknown ga preset {preset!r}; valid: fast, paper")
        try:
            return maker(seed=seed, **config)
        except TypeError as e:
            raise BackendError(f"bad ga config: {e}") from None

    def run(self, problem: SearchProblem, *, seed: int = 0,
            observer: Optional[Observer] = None, **config) -> GAResult:
        return run_ga_problem(problem, self.make_config(seed, **config),
                              observer)


@register_backend("random")
class RandomBackend(SearchBackend):
    """Random sampling (``evaluations`` genomes, default 1000).

    The initial genome is always included, so the result is never worse
    than the layerwise baseline.  ``mode="walk"`` (default) samples random
    walks of ``walk_len`` mutations (default 8) from the initial genome —
    the meaningful no-selection baseline for large fusion spaces, where
    ``mode="uniform"`` (uniform over the whole space, when the problem can
    sample it) almost surely draws invalid states.
    """

    name = "random"

    def run(self, problem: SearchProblem, *, seed: int = 0,
            observer: Optional[Observer] = None, **config) -> GAResult:
        self._reject_unknown(config, "evaluations", "walk_len", "mode")
        evaluations = int(config.get("evaluations", 1000))
        walk_len = int(config.get("walk_len", 8))
        mode = config.get("mode", "walk")
        if mode not in ("walk", "uniform"):
            raise BackendError(f"unknown random mode {mode!r}; "
                               f"valid: walk, uniform")
        rng = random.Random(seed)
        sampler = getattr(problem, "random_genome", None)
        if mode == "uniform" and sampler is None:
            raise BackendError(
                f"problem {problem.name!r} cannot sample uniformly; "
                f"use mode='walk'")

        def sample():
            if mode == "uniform":
                return sampler(rng)
            g = problem.initial()
            for _ in range(walk_len):
                g = problem.mutate(g, rng)
            return g

        best, best_f = problem.initial(), problem.fitness(problem.initial())
        seen = {problem.key(best)}
        history: List[float] = [best_f]
        done, step = 1, 0
        while done < evaluations:
            chunk = [sample() for _ in range(min(_CHUNK, evaluations - done))]
            fits = problem.fitness_batch(chunk)
            done += len(chunk)
            for g, f in zip(chunk, fits):
                seen.add(problem.key(g))
                if f > best_f:
                    best, best_f = g, f
            history.append(best_f)
            step += 1
            if observer is not None and observer(step, best_f, len(seen),
                                                 done):
                break
        return GAResult(best_state=best, best_fitness=best_f, history=history,
                        evaluations=len(seen), offspring_evaluated=done)


@register_backend("hill_climb")
class HillClimbBackend(SearchBackend):
    """Greedy best-improvement search over one-mutation neighborhoods:
    from the layerwise schedule, repeatedly apply the single combine /
    separate that most improves fitness; stop at a local optimum (or after
    ``max_steps``, default 10_000 moves)."""

    name = "hill_climb"

    def run(self, problem: SearchProblem, *, seed: int = 0,
            observer: Optional[Observer] = None, **config) -> GAResult:
        self._reject_unknown(config, "max_steps")
        max_steps = int(config.get("max_steps", 10_000))
        current = problem.initial()
        current_f = problem.fitness(current)
        history: List[float] = [current_f]
        seen = {problem.key(current)}
        done = 1
        for step in range(max_steps):
            moves = list(problem.neighbors(current))
            if not moves:
                break
            fits = problem.fitness_batch(moves)
            done += len(moves)
            for g in moves:
                seen.add(problem.key(g))
            best_i = max(range(len(moves)), key=lambda i: fits[i])
            if fits[best_i] <= current_f:
                break                        # local optimum
            current, current_f = moves[best_i], fits[best_i]
            history.append(current_f)
            if observer is not None and observer(step + 1, current_f,
                                                 len(seen), done):
                break
        return GAResult(best_state=current, best_fitness=current_f,
                        history=history, evaluations=len(seen),
                        offspring_evaluated=done)


def _pareto(rows):
    """Prune ``(delta_vec, mask)`` rows to the Pareto front under
    componentwise ``<=`` minimization (ties keep the lowest mask)."""
    front = []
    for vec, mask in sorted(rows, key=lambda r: (r[0], r[1])):
        if not any(all(fv <= v for fv, v in zip(fvec, vec))
                   for fvec, _ in front):
            front.append((vec, mask))
    return front


#: which summed :class:`ScheduleCost` components each *native* objective
#: reads — mirrors ``repro_torch.costmodel.evaluator.NATIVE_OBJECTIVES``.  Every
#: listed component is additive over fused groups, which is what licenses
#: the per-region composition below: a region's masks only perturb the
#: groups inside it, so total = baseline + sum of per-region deltas.
_OBJECTIVE_COMPONENTS = {
    "edp": ("energy", "cycles"),       # product of two additive components
    "energy": ("energy",),
    "cycles": ("cycles",),
    "dram": ("dram",),
}


@register_backend("exhaustive")
class ExhaustiveBackend(SearchBackend):
    """Enumerate and score the entire genome space (ground truth for small
    graphs).  Refuses spaces larger than ``limit`` (default 2^16, the
    paper's §III-A count of VGG-16's space; raise it explicitly for graphs
    whose IR carries more edges).

    With a :class:`~repro_torch.analysis.spacemap.SpaceMap` on the problem
    (``SearchSpec(spacemap=True)``) and a native objective, the space
    *factorizes*: regions confine every fused group, validity and all cost
    components decompose per region, so each region's ``2^{k_r}`` masks
    are enumerated independently and the winners composed exactly —
    per-region Pareto fronts over the objective's additive cost components
    (for ``edp``, the (energy, cycles) plane; EDP itself is not additive),
    then a dominance-pruned dynamic program across regions.  The ``limit``
    guard then applies to the *largest region*, which is what makes
    VGG-16's raw 2^21 space exactly solvable in a few dozen evaluations."""

    name = "exhaustive"

    def run(self, problem: SearchProblem, *, seed: int = 0,
            observer: Optional[Observer] = None, **config) -> GAResult:
        self._reject_unknown(config, "limit")
        limit = int(config.get("limit", EXHAUSTIVE_LIMIT))
        size = problem.space_size()
        if size is None:
            raise BackendError(
                f"problem {problem.name!r} is not enumerable")
        sm = getattr(problem, "spacemap", None)
        composable = (
            sm is not None and sm.regions
            # non-native objectives (registry metrics) need not be additive
            # over groups, and _CustomObjectiveProblem re-scores through
            # them — composition only holds for the native components
            and getattr(problem, "objective", None) in _OBJECTIVE_COMPONENTS
            and callable(getattr(getattr(problem, "evaluator", None),
                                 "evaluate", None)))
        if composable:
            largest = sm.largest_region_size()
            if largest > limit:
                raise BackendError(
                    f"largest spacemap region holds {largest} states, over "
                    f"the exhaustive limit {limit} (factorized total: "
                    f"{sm.factorized_states()} states across "
                    f"{len(sm.regions)} regions vs {size} flat); pass "
                    f"limit={largest} explicitly (API: backend_config="
                    f"{{\"limit\": {largest}}}; CLI: --backend-config "
                    f"'{{\"limit\": {largest}}}'), or use ga / hill_climb "
                    f"/ random instead")
            return self._run_per_region(problem, sm, observer)
        if size > limit:
            est = _estimate_runtime_s(problem, size)
            eta = (f" (estimated batched runtime for all {size} states: "
                   f"~{_fmt_eta(est)})" if est is not None else "")
            factored = (
                f" (a spacemap factorizes this into "
                f"{sm.factorized_states()} states across {len(sm.regions)} "
                f"regions, but objective "
                f"{getattr(problem, 'objective', None)!r} is not "
                f"group-additive, so per-region composition cannot apply)"
                if sm is not None else "")
            raise BackendError(
                f"space of {size} genomes exceeds the exhaustive limit "
                f"{limit}{factored}; pass limit={size} explicitly (API: "
                f"backend_config={{\"limit\": {size}}}; CLI: "
                f"--backend-config '{{\"limit\": {size}}}') if enumerating "
                f"{size} states is affordable{eta}, or use ga / hill_climb "
                f"/ random instead")
        best, best_f = None, -1.0
        history: List[float] = []
        done, step = 0, 0
        chunk_n = _batch_chunk(problem)
        genomes = iter(problem.enumerate())
        while True:
            chunk = list(itertools.islice(genomes, chunk_n))
            if not chunk:
                break
            fits = problem.fitness_batch(chunk)
            done += len(chunk)
            for g, f in zip(chunk, fits):
                if f > best_f:
                    best, best_f = g, f
            history.append(best_f)
            step += 1
            if observer is not None and observer(step, best_f, done, done):
                break
        if best is None:
            raise BackendError("empty genome space")
        return GAResult(best_state=best, best_fitness=best_f, history=history,
                        evaluations=done, offspring_evaluated=done)

    @staticmethod
    def _run_per_region(problem, sm, observer: Optional[Observer]
                        ) -> GAResult:
        """Exact search by region composition: enumerate each region's
        masks independently, keep its Pareto front of cost-component
        deltas vs the layerwise baseline, and compose fronts across
        regions by a dominance-pruned DP.  Sound because regions confine
        groups (validity is region-local) and every tracked component is
        additive over groups (delta vectors sum)."""
        ev = problem.evaluator
        obj = problem.objective
        comps = _OBJECTIVE_COMPONENTS[obj]

        def components(cost):
            by_name = {"energy": cost.energy_pj, "cycles": cost.cycles,
                       "dram": float(cost.dram_read_words
                                     + cost.dram_write_words)}
            return tuple(by_name[c] for c in comps)

        base_cost = ev.evaluate(problem.initial())
        assert base_cost is not None, "layerwise schedule must be valid"
        base = components(base_cost)

        def metric(delta):
            total = [b + d for b, d in zip(base, delta)]
            if obj == "edp":
                return total[0] * total[1]
            return total[0]

        # composed Pareto front over regions processed so far; the zero
        # delta with mask 0 (every region layerwise) is always present
        acc = [((0.0,) * len(comps), 0)]
        history: List[float] = []
        best_mask = 0
        done = 0
        for step, region in enumerate(sm.regions):
            bits = region.edge_indices
            front = []
            for sub in range(1 << len(bits)):
                mask = 0
                for j, i in enumerate(bits):
                    if (sub >> j) & 1:
                        mask |= 1 << i
                cost = ev.evaluate(problem.decode_genome(mask))
                done += 1
                if cost is None:
                    continue               # illegal grouping in this region
                front.append((tuple(c - b for c, b
                                    in zip(components(cost), base)), mask))
            acc = _pareto([(tuple(x + y for x, y in zip(av, fv)), am | fm)
                           for av, am in acc for fv, fm in front])
            best_mask = min(acc, key=lambda r: (metric(r[0]), r[1]))[1]
            best_f = problem.fitness(problem.decode_genome(best_mask))
            history.append(best_f)
            if observer is not None and observer(step + 1, best_f, done,
                                                 done):
                break
        best_state = problem.decode_genome(best_mask)
        # canonical re-score: the composed winner's fitness comes from the
        # evaluator itself, not from summed deltas (float sum-order ulps)
        best_f = problem.fitness(best_state)
        return GAResult(best_state=best_state, best_fitness=best_f,
                        history=history, evaluations=done,
                        offspring_evaluated=done)
