"""Search-problem protocol: what a genome space must provide to be searched.

The paper's search procedure (Alg. 1) is independent of *what* is being
searched: it needs an initial genome, a mutation operator, and a fitness
function with 0 meaning invalid.  This module pins that contract down as
:class:`SearchProblem` so every search backend in ``repro_torch.search.backends``
(GA, random, hill-climb, exhaustive) runs against fusion states and TPU
schedules — or any future genome — through one interface instead of each
genome growing its own copy of the selection loop.

:class:`FusionProblem` is the paper's problem: edge-bitmask
:class:`repro_torch.core.fusion.FusionState` genomes scored by a memoizing
:class:`repro_torch.costmodel.evaluator.Evaluator`.  Its method bodies make
exactly the RNG calls the pre-refactor ``run_ga`` made, so fixed-seed
results are bit-for-bit unchanged (pinned by ``tests/test_search_api.py``).

A :class:`~repro_torch.analysis.spacemap.SpaceMap` (``SearchSpec(spacemap=
True)``) restricts the genome to the statically undecided bits: mutation,
crossover, uniform sampling, neighborhoods, and enumeration all skip the
provably forced-off genes, so the population engine's ``(P, n_edges)``
matrices never carry a frozen column.  The spacemap path makes *different*
RNG draws than the unrestricted one (shorter index ranges), so it sits
behind the opt-in flag with its own fixed-seed pins
(``tests/test_spacemap.py``); with ``spacemap=None`` every draw below is
bit-identical to the pre-spacemap code.
"""
from __future__ import annotations

import random
from typing import (TYPE_CHECKING, Any, Hashable, Iterable, Iterator, List,
                    Optional, Sequence, Tuple)

from repro_torch.core.fusion import FusionState
from repro_torch.core.graph import LayerGraph

if TYPE_CHECKING:                      # import cycle-free type-only import
    from repro_torch.analysis.spacemap import SpaceMap


class SearchProblem:
    """Genome-space contract consumed by every search backend.

    Subclasses must implement :meth:`initial`, :meth:`mutate`,
    :meth:`fitness`, and :meth:`key`; the remaining methods have generic
    (sometimes unavailable) defaults that specific problems may override
    or extend.
    """

    #: short name used in artifacts/reports
    name: str = "problem"

    #: extra genomes scored into the GA's initial pool alongside
    #: :meth:`initial` (warm-start seeding, ``repro.serve.warmstart``).
    #: Duplicates of the initial genome are dropped.  Empty by default so
    #: every existing fixed-seed trajectory stays bit-identical — a non-empty
    #: tuple widens the first generation's parent pool and therefore its RNG
    #: draw widths, which is why callers must opt in explicitly.
    seed_genomes: Tuple[Any, ...] = ()

    # ---- required surface -----------------------------------------------------
    def initial(self) -> Any:
        """The search's starting genome (the paper's layerwise schedule)."""
        raise NotImplementedError

    def mutate(self, genome: Any, rng: random.Random) -> Any:
        """One random unit mutation (paper Alg. 1 line 4)."""
        raise NotImplementedError

    def fitness(self, genome: Any) -> float:
        """``baseline_metric / genome_metric``; 0.0 means invalid."""
        raise NotImplementedError

    def key(self, genome: Any) -> Hashable:
        """Cheap hashable genome identity for fitness caches."""
        raise NotImplementedError

    # ---- optional surface -----------------------------------------------------
    def fitness_batch(self, genomes: Sequence[Any]) -> List[float]:
        """Score a whole offspring generation; override when the evaluator
        can dedupe shared substructure (see ``Evaluator.fitness_batch``)."""
        return [self.fitness(g) for g in genomes]

    def crossover(self, a: Any, b: Any, rng: random.Random) -> Any:
        """Uniform crossover (beyond-paper); default: no recombination."""
        return a

    def neighbors(self, genome: Any) -> Iterable[Any]:
        """All one-mutation neighbors (hill-climb moves).  Optional."""
        raise NotImplementedError(f"{self.name} does not enumerate neighbors")

    def enumerate(self) -> Iterator[Any]:
        """Every genome in the space (exhaustive search).  Optional."""
        raise NotImplementedError(f"{self.name} is not enumerable")

    def space_size(self) -> Optional[int]:
        """Number of genomes in the space, or None if unbounded/unknown."""
        return None

    def encode_genome(self, genome: Any) -> Any:
        """Compact, picklable wire form of a genome — what multi-process
        backends (``repro.search.island``) ship between workers instead of
        the live object (which may drag a whole graph through pickle).
        Default: the genome itself."""
        return genome

    def decode_genome(self, data: Any) -> Any:
        """Inverse of :meth:`encode_genome`, re-binding the wire form onto
        this problem's live objects."""
        return data


class FusionProblem(SearchProblem):
    """The paper's interlayer-pipelining problem (§III): fusion-state genomes
    over ``graph``, scored by ``evaluator`` on ``objective``.

    ``spacemap`` (optional) freezes the statically forced-off genome bits:
    all operators then draw indices from the surviving ``active`` bits
    only.  Frozen bits stay 0 in every genome the problem produces, so
    downstream consumers (the batched population engine included) never
    see a frozen column set.
    """

    name = "fusion"

    def __init__(self, graph: LayerGraph, evaluator: Any,
                 objective: str = "edp",
                 spacemap: Optional["SpaceMap"] = None):
        self.graph = graph
        self.evaluator = evaluator
        self.objective = objective
        self.spacemap = spacemap
        self.cg = graph.compiled()
        self._mbits: int = int(self.cg.m).bit_length()
        self._batch = getattr(evaluator, "fitness_batch", None)
        self._batch_unique = getattr(evaluator, "fitness_batch_unique", None)
        #: searchable bit positions (all of them without a spacemap)
        self._active: Tuple[int, ...] = tuple(range(self.cg.m)) \
            if spacemap is None else tuple(spacemap.active_indices)
        self._abits: int = len(self._active).bit_length()

    def __getstate__(self):
        """Pickled for a spawned island process: a telemetry collector the
        session attached (``obs``, and with it an open trace file) stays
        behind."""
        state = dict(self.__dict__)
        state.pop("obs", None)
        return state

    def initial(self) -> FusionState:
        return FusionState.layerwise(self.graph)

    def mutate(self, genome: FusionState, rng: random.Random) -> FusionState:
        """One random edge flip.  Returns a *lazy* child (mask only — no
        group maintenance): the batched population engine recomputes all
        per-genome structure array-natively, so eagerly maintaining union-find
        state per offspring (what ``FusionState.mutate`` does when the parent
        is structured) would be pure overhead.  The inlined getrandbits loop
        is CPython's ``_randbelow`` — the same draws ``rng.randrange(m)``
        makes, so fixed-seed runs are unchanged.  With a spacemap the same
        loop draws over the active bits instead (different draw widths —
        hence the separate fixed-seed pins)."""
        m = self.cg.m
        if not m:
            raise ValueError("graph has no edges to mutate")
        grb = rng.getrandbits
        if self.spacemap is None:
            i = grb(self._mbits)
            while i >= m:
                i = grb(self._mbits)
        else:
            k = len(self._active)
            if not k:                      # fully decided: nothing to flip
                return genome
            j = grb(self._abits)
            while j >= k:
                j = grb(self._abits)
            i = self._active[j]
        return FusionState._make(self.graph, genome.cg,
                                 genome.mask ^ (1 << i))

    def prewarm(self) -> None:
        """Materialize everything forked workers should inherit read-only
        via copy-on-write: the compiled graph, the layerwise baseline, and
        the population engine's static tables (``repro.search.island`` calls
        this before spawning)."""
        ev = self.evaluator
        if hasattr(ev, "population"):
            try:
                ev.population()
            except RuntimeError:     # no numpy: scalar path needs no tables
                ev.layerwise()
        elif hasattr(ev, "layerwise"):
            ev.layerwise()

    def fitness(self, genome: FusionState) -> float:
        return float(self.evaluator.fitness(genome, self.objective))

    def fitness_batch(self, genomes: Sequence[FusionState]) -> List[float]:
        if self._batch is not None:
            return list(self._batch(genomes, self.objective))
        return [self.fitness(g) for g in genomes]

    def fitness_batch_unique(self, genomes: Sequence[FusionState]
                             ) -> List[float]:
        """Batch scoring for genome lists already deduped by :meth:`key`
        (the GA loop's per-run cache guarantees this); skips the
        evaluator's own dedup pass.  Subclasses that override
        :meth:`fitness_batch` keep their scoring path: the fast lane only
        engages when batch scoring is the stock evaluator route."""
        if (self._batch_unique is not None
                and type(self).fitness_batch is FusionProblem.fitness_batch):
            return list(self._batch_unique(genomes, self.objective))
        return self.fitness_batch(genomes)

    def key(self, genome: FusionState) -> int:
        return int(genome.mask)          # == genome.key(), one hop cheaper

    def crossover(self, a: FusionState, b: FusionState,
                  rng: random.Random) -> FusionState:
        """Uniform crossover on the fused-edge genome (beyond-paper).
        Spacemap runs draw one coin per *active* bit only — frozen bits
        are 0 in both parents, so the child's frozen bits stay 0 without
        spending draws on them."""
        mask = 0
        if self.spacemap is None:
            for i in range(self.cg.m):
                src = a.mask if rng.random() < 0.5 else b.mask
                mask |= src & (1 << i)
        else:
            for i in self._active:
                src = a.mask if rng.random() < 0.5 else b.mask
                mask |= src & (1 << i)
        return FusionState.from_mask(self.graph, mask)

    def neighbors(self, genome: FusionState) -> Iterator[FusionState]:
        for i in self._active:
            if (genome.mask >> i) & 1:
                yield genome._separate_idx(i)
            else:
                yield genome._combine_idx(i)

    def _scatter(self, sub: int) -> int:
        """Spread a compact active-bit value onto genome bit positions."""
        mask = 0
        for j, i in enumerate(self._active):
            if (sub >> j) & 1:
                mask |= 1 << i
        return mask

    def random_genome(self, rng: random.Random) -> FusionState:
        if self.spacemap is None:
            return FusionState.from_mask(
                self.graph, rng.getrandbits(self.cg.m) if self.cg.m else 0)
        k = len(self._active)
        return FusionState.from_mask(
            self.graph, self._scatter(rng.getrandbits(k)) if k else 0)

    def enumerate(self) -> Iterator[FusionState]:
        if self.spacemap is None:
            for mask in range(1 << self.cg.m):
                yield FusionState.from_mask(self.graph, mask)
            return
        for sub in range(1 << len(self._active)):
            yield FusionState.from_mask(self.graph, self._scatter(sub))

    def space_size(self) -> int:
        return 1 << len(self._active)

    def encode_genome(self, genome: FusionState) -> int:
        return int(genome.mask)

    def decode_genome(self, data: int) -> FusionState:
        return FusionState.from_mask(self.graph, data)
