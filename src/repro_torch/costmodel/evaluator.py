"""Schedule evaluation: layerwise baseline vs fused states (paper Alg. 1 l.5-9).

A :class:`FusionState` is costed group-by-group.  Because a tensor's DRAM
residency is fully determined by its producer's group membership (it goes
off-chip iff some consumer is outside the group), each group's cost depends
*only* on its member set — so group costs are memoized across the entire GA
run, which is what makes the paper's P=100 x G=500 search fast.

Group costing (multi-member groups):
  1. largest output-tile height ``t`` whose line-buffer footprint fits the
     activation buffer (``repro_torch.core.receptive``); no feasible ``t`` =>
     the state is invalid (paper: "Any mapping where intermediate storage
     exceeds capacity is discarded as invalid").
  2. if aggregate group weights exceed the weight buffer, weights re-stream
     from DRAM once per tile pass (paper §IV).
  3. member layers are costed with intra-group edges kept on-chip; compute
     and DRAM time overlap within the group.

Hot-path notes (batched engine): for bitmask genomes the group cache is
keyed by the group's **member node-bitmask** (a Python int — one machine-word
hash instead of a frozenset of strings), member topological order comes from
integer adjacency, and :meth:`Evaluator.fitness_batch` dedupes an entire
offspring generation against the cache before costing only novel groups.
Batches are scored by the array-native
:class:`repro_torch.core.population.PopulationEvaluator` (one ``(P, n_edges)``
matrix per generation; see that module's docstring); the per-state
:meth:`Evaluator._fitness_fast` path remains as the small-batch/no-numpy
fallback and the bit-identity reference — both sum ``base + corrections`` in
ascending group-min-member order, so they agree bit-for-bit (pinned by
``tests/test_population_engine.py``).  Reference states
(``repro_torch.core.fusion_ref``) take the original frozenset-keyed path; both
paths run the same float operations in the same order, so costs agree
bit-for-bit (pinned by ``tests/test_fusion_equivalence.py``).

Cost-backend note: the evaluator owns *memoization and fitness*, not the
numbers — those come from a pluggable :class:`repro_torch.costmodel.base.CostModel`
(default: :class:`repro_torch.costmodel.default.DefaultCostModel`, the paper's
mini-Timeloop mapper; alternatives register via
``repro_torch.search.register_costmodel``).  The group caches store the scalar
``CostBreakdown.totals()`` tuples, so swapping the backend never touches the
batching machinery.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Union

from repro_torch.core.fusion import FusionState, iter_bits
from repro_torch.core.graph import LayerGraph
from repro_torch.costmodel.accelerator import Accelerator
from repro_torch.costmodel.base import (CostBreakdown, CostModel, GroupKey,
                                  GroupTotals)
from repro_torch.costmodel.default import DefaultCostModel
from repro_torch.costmodel.energy import DEFAULT_ENERGY, EnergyModel
from repro_torch.core.population import MIN_BATCH, PopulationEvaluator
from repro_torch.device import DeviceLike, resolve_device

_MISSING = object()

#: objectives the evaluator scores natively (ScheduleCost.metric and the
#: batched fitness hot path); repro_torch.search registers exactly these as
#: built-ins and routes anything else through the generic evaluate() path
NATIVE_OBJECTIVES = ("edp", "energy", "cycles", "dram")


@dataclass(frozen=True)
class ScheduleCost:
    energy_pj: float
    cycles: float
    dram_read_words: int
    dram_write_words: int
    act_write_events: int
    macs: int
    n_groups: int
    clock_hz: float = 200e6      # threaded from Accelerator.clock_mhz

    @property
    def seconds(self) -> float:
        return self.cycles / self.clock_hz

    @property
    def edp(self) -> float:
        return self.energy_pj * self.cycles

    @property
    def energy_j(self) -> float:
        return self.energy_pj * 1e-12

    def metric(self, objective: str) -> float:
        try:
            return {"edp": self.edp, "energy": self.energy_pj,
                    "cycles": self.cycles,
                    "dram": float(self.dram_read_words
                                  + self.dram_write_words),
                    }[objective]
        except KeyError:
            raise ValueError(
                f"unknown objective {objective!r}; ScheduleCost scores "
                f"{', '.join(NATIVE_OBJECTIVES)} natively — register other "
                f"metrics via repro_torch.search.register_objective") from None

    @classmethod
    def from_groups(cls, groups: Sequence["GroupCost"], clock_hz: float
                    ) -> "ScheduleCost":
        """Declarative assembly from per-group totals tuples
        (``CostBreakdown.totals()``), summed in schedule order."""
        e = 0.0
        c = 0.0
        dr = dw = aw = mc = 0
        for g in groups:
            e += g[0]
            c += g[1]
            dr += g[2]
            dw += g[3]
            aw += g[4]
            mc += g[5]
        return cls(
            energy_pj=e, cycles=c, dram_read_words=dr, dram_write_words=dw,
            act_write_events=aw, macs=mc, n_groups=len(groups),
            clock_hz=clock_hz)


# group cost record: (energy_pj, cycles, dram_read, dram_write,
#                     act_write_events, macs) — or None if over-capacity
# (the cached form of CostBreakdown.totals(); GroupKey/GroupTotals live in
# repro_torch.costmodel.base and are re-exported here for compatibility)
GroupCost = GroupTotals


#: what Evaluator accepts as its cost backend: a live CostModel, a factory
#: ``(graph, acc, em) -> CostModel`` (e.g. the class itself), or None for
#: the default model
CostModelLike = Union[CostModel, Callable[..., CostModel], None]


class Evaluator:
    """Memoizing schedule evaluator for one (graph, accelerator, costmodel)
    triple."""

    def __init__(self, graph: LayerGraph, acc: Accelerator,
                 em: EnergyModel = DEFAULT_ENERGY,
                 costmodel: CostModelLike = None, *,
                 device: DeviceLike = None, pop_engine: Optional[str] = None):
        """``device`` runs the population engine's label pass: CUDA (the
        default; raises without a card) launches the ``ga_labels`` kernel,
        ``"cpu"`` its plain PyTorch version.  ``pop_engine="off"`` sends
        every batch down the per-state scalar path (the reference's
        ``REPRO_POP_ENGINE=off``)."""
        if pop_engine not in (None, "off"):
            raise ValueError(f"pop_engine={pop_engine!r}; valid: None, 'off'")
        self.device = resolve_device(device)
        self.graph = graph
        self.acc = acc
        self.em = em
        self.cg = graph.compiled()
        if costmodel is None:
            self.costmodel: CostModel = DefaultCostModel(graph, acc, em)
        elif isinstance(costmodel, CostModel):
            self.costmodel = costmodel
        else:
            self.costmodel = costmodel(graph, acc, em)
        self.clock_hz = self.costmodel.clock_hz
        self._group_cache: Dict[GroupKey, GroupCost] = {}
        # multi-member group mask -> cost delta vs its members' singleton
        # costs (the fast fitness path sums base + these corrections)
        self._corr: Dict[int, GroupCost] = {}
        # layerwise scalar sums + per-objective baseline metrics (lazy)
        self._base: Optional[tuple] = None
        self.evals = 0
        self.group_hits = 0          # group-cost lookups served from cache
        self.group_misses = 0        # novel groups actually costed
        self.batch_states = 0        # states seen by fitness_batch
        self.batch_unique = 0        # ... of which had a novel genome
        self._layerwise: Optional[ScheduleCost] = None
        self._pop: Optional["PopulationEvaluator"] = None
        # the engine's backend, named by the device of its label pass
        self._pop_mode = pop_engine or (
            "cuda" if self.device.type == "cuda" else "torch")

    # ---- public API ----------------------------------------------------------------
    def layerwise(self) -> ScheduleCost:
        if self._layerwise is None:
            self._layerwise = self.evaluate(FusionState.layerwise(self.graph))
            assert self._layerwise is not None
        return self._layerwise

    def evaluate(self, state) -> Optional[ScheduleCost]:
        """Total cost, or None if the state is invalid (unschedulable or
        over-capacity).  Accepts bitmask states (fast path) and reference
        states (frozenset path)."""
        self.evals += 1
        if not state.is_schedulable():
            return None
        if hasattr(state, "group_masks"):
            return self._evaluate_keys(state.group_masks())
        return self._evaluate_keys(state.groups())

    def fitness(self, state, objective: str = "edp") -> float:
        """Paper Alg. 1 line 9: F = Eval_layerwise / Eval_new (0 if invalid)."""
        cost = self.evaluate(state)
        if cost is None:
            return 0.0
        new = cost.metric(objective)
        return self.layerwise().metric(objective) / new if new > 0 else 0.0

    def fitness_batch(self, states: Sequence[FusionState],
                      objective: str = "edp") -> List[float]:
        """Fitness for a whole offspring generation (GA hot path).

        Dedupes the generation by genome against the mask-keyed caches, then
        scores the novel genomes through the array-native population engine
        (:meth:`population`) — one ``(P, n_edges)`` matrix per call — falling
        back to the per-state :meth:`_fitness_fast` path for small batches,
        non-native objectives, or ``pop_engine="off"``.  Both paths sum
        ``base + corrections`` in ascending group-min-member order, so their
        results are bit-for-bit identical; values may differ from
        :meth:`fitness` by float re-association only (~1 ulp), and ``run_ga``
        re-scores its final winner exactly.
        """
        self.batch_states += len(states)
        keys = [s.key() for s in states]
        uniq: Dict[int, float] = {}
        todo: List[FusionState] = []
        for s, k in zip(states, keys):
            if k not in uniq:
                uniq[k] = 0.0
                todo.append(s)
        self.batch_unique += len(uniq)
        if (self._pop_mode != "off" and len(todo) >= MIN_BATCH
                and objective in NATIVE_OBJECTIVES
                and todo[0].cg is self.cg):
            fits = self.population().fitness_masks(
                [s.mask for s in todo], objective)
            for s, f in zip(todo, fits.tolist()):
                uniq[s.mask] = f
        else:
            for s in todo:
                uniq[s.key()] = self._fitness_fast(s, objective)
        return [uniq[k] for k in keys]

    def fitness_batch_unique(self, states: Sequence[FusionState],
                             objective: str = "edp") -> List[float]:
        """:meth:`fitness_batch` for callers that already deduped ``states``
        by genome (the GA loop's run-level cache does) — skips the per-state
        re-keying pass and returns fitness in input order.  Same engine
        routing, bit-identical results."""
        self.batch_states += len(states)
        self.batch_unique += len(states)
        if (self._pop_mode != "off" and len(states) >= MIN_BATCH
                and objective in NATIVE_OBJECTIVES
                and states[0].cg is self.cg):
            return self.population().fitness_masks(
                [s.mask for s in states], objective).tolist()
        return [self._fitness_fast(s, objective) for s in states]

    def population(self) -> "PopulationEvaluator":
        """The batched population engine bound to this evaluator (lazy;
        shares the group-correction caches), its label pass on the
        evaluator's device."""
        if self._pop is None:
            self._ensure_base()
            self._pop = PopulationEvaluator(self, self.device)
        return self._pop

    def _ensure_base(self) -> tuple:
        """Layerwise scalar sums + per-objective baseline metrics (lazy)."""
        if self._base is None:
            lw = self.layerwise()
            self._base = (lw.energy_pj, lw.cycles, lw.dram_read_words,
                          lw.dram_write_words, lw.act_write_events, lw.macs,
                          {obj: lw.metric(obj) for obj in NATIVE_OBJECTIVES})
        return self._base

    def _fitness_fast(self, state: FusionState, objective: str) -> float:
        """Baseline-plus-corrections fitness for bitmask states — the
        canonical scalar path: corrections are applied in ascending order of
        each group's minimum member, which is exactly the summation order the
        batched engine reproduces (``tests/test_population_engine.py`` pins
        the bit-identity)."""
        sched = state._sched                 # inlined is_schedulable (hot path)
        if sched is None:
            sched = state.is_schedulable()
        if not sched:
            return 0.0
        base = self._ensure_base()
        corr = self._corr
        corr_get = corr.get
        hits = 0
        e, c, dr, dw, aw, mc = base[:6]
        mgroups = state._mgroups             # inlined multi_masks (hot path)
        if mgroups is None:
            mgroups = state.multi_masks()
        # canonical order: ascending minimum member (= lowest set bit)
        for gm in sorted(mgroups, key=lambda m: m & -m):
            d = corr_get(gm, _MISSING)
            if d is _MISSING:
                d = self._compute_correction(gm)
                corr[gm] = d
            else:
                hits += 1
            if d is None:
                self.group_hits += hits
                return 0.0                   # over-capacity group: invalid
            e += d[0]
            c += d[1]
            dr += d[2]
            dw += d[3]
            aw += d[4]
            mc += d[5]
        self.group_hits += hits
        if objective == "edp":
            new = e * c
        elif objective == "energy":
            new = e
        elif objective == "cycles":
            new = c
        else:
            new = float(dr + dw)
        return base[6][objective] / new if new > 0 else 0.0

    def _compute_correction(self, gmask: int) -> GroupCost:
        """Cost delta of fusing ``gmask``'s members vs leaving each layerwise."""
        g = self._group_cost(gmask)
        if g is None:
            return None
        e, c, dr, dw, aw, mc = g
        for i in iter_bits(gmask):
            s = self._group_cost(1 << i)
            e -= s[0]
            c -= s[1]
            dr -= s[2]
            dw -= s[3]
            aw -= s[4]
            mc -= s[5]
        return (e, c, dr, dw, aw, mc)

    def _group_cost(self, key: GroupKey) -> GroupCost:
        cached = self._group_cache.get(key, _MISSING)
        if cached is _MISSING:
            bd = self.costmodel.cost_group(key)
            cached = None if bd is None else bd.totals()
            self._group_cache[key] = cached
            self.group_misses += 1
        else:
            self.group_hits += 1
        return cached

    def breakdowns(self, state) -> Optional[List[CostBreakdown]]:
        """Per-group :class:`CostBreakdown` for ``state``'s groups (in
        group order), or None if the state is unschedulable / any group is
        infeasible.  Recomputed through the cost model — this is the
        reporting path (artifacts, ``repro report``), not the GA hot path.
        """
        if not state.is_schedulable():
            return None
        keys = state.group_masks() if hasattr(state, "group_masks") \
            else state.groups()
        out = self.costmodel.batch(keys)
        return None if any(bd is None for bd in out) else out

    def cache_stats(self) -> Dict[str, float]:
        """Cache-effectiveness counters.  ``group_hit_rate`` covers explicit
        group-cost lookups only; ``batch_evals_per_sec`` is the headline
        throughput of the array-native population engine (states scored per
        second of in-engine time; 0.0 when every batch took the scalar
        fallback)."""
        touches = self.group_hits + self.group_misses
        stats = {
            "unique_groups": len(self._group_cache),
            "group_hits": self.group_hits,
            "group_misses": self.group_misses,
            "group_hit_rate": self.group_hits / touches if touches else 0.0,
            "states_evaluated": self.evals,
            "batch_states": self.batch_states,
            "batch_unique": self.batch_unique,
            "pop_backend": "off",
            "pop_batches": 0,
            "batch_time_s": 0.0,
            "batch_evals_per_sec": 0.0,
        }
        if self._pop is not None:
            ps = self._pop.stats()
            stats.update(
                pop_backend=ps["backend"], pop_batches=ps["batches"],
                batch_time_s=ps["batch_time_s"],
                batch_evals_per_sec=ps["batch_evals_per_sec"])
        return stats

    # ---- internals ------------------------------------------------------------------
    def _evaluate_keys(self, keys: Sequence[GroupKey]
                       ) -> Optional[ScheduleCost]:
        totals = []
        for key in keys:
            g = self._group_cost(key)
            if g is None:
                return None
            totals.append(g)
        return ScheduleCost.from_groups(totals, self.clock_hz)
