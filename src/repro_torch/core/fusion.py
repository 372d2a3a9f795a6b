"""Fusion states: the GA genome (paper §III-A, Fig. 8) — incremental engine.

A :class:`FusionState` assigns every edge of the layer graph one of two labels:

* **fused**  — the activation tensor on that edge never leaves the chip;
* **split**  — the tensor is written to DRAM by the producer and read back.

Fused edges induce *fused groups*: weakly-connected components of the graph
restricted to fused edges (paper: "we represent our network as a computation
graph, with the fused layers being subgraphs").  A state is *schedulable* only
if the condensation of the graph by groups is acyclic — otherwise some group
would need outputs of a group that itself depends on it (can arise from fusing
across a skip connection while splitting the body, Fig. 8e).

An activation produced inside a group is DRAM-free only if *every* consumer is
in the same group; if any consumer lives elsewhere the tensor is stored once
to DRAM for those consumers (partial offload, Fig. 8b).

Engine design (this module is the GA's hot path):

* the genome is an **edge-index bitmask** (a Python int over the
  :class:`repro_torch.core.graph.CompiledGraph` edge order), so ``mutate``/``key``/
  ``hash`` are O(1) and fitness caches hash a machine int, not a frozenset of
  string pairs;
* group membership (node bitmasks, kept sorted by lowest member id so the
  public ``groups()`` order matches the reference first-seen order) is
  maintained **incrementally**: ``combine`` merges two components in O(G),
  ``separate`` re-examines only the affected component;
* schedulability is propagated incrementally where theory permits:
  merging groups ``gu -> gv`` of a schedulable state creates a condensation
  cycle iff a ``gu ~> gv`` path of length >= 2 exists (the direct edge becomes
  a self-loop), and splitting a group of a schedulable state into ``A``/``B``
  creates one iff both ``A ~> B`` and ``B ~> A`` exist — both answered by
  early-exit BFS instead of a full Kahn pass per offspring.  States derived
  from unschedulable parents fall back to a full (integer) Kahn check, since
  both operations can heal cycles.

The original dict/frozenset implementation is retained as
``repro_torch.core.fusion_ref.ReferenceFusionState`` and property tests pin the two
engines to bit-for-bit agreement.
"""
from __future__ import annotations

import random
from typing import Dict, FrozenSet, Iterator, List, Optional, Tuple

from repro_torch.core.graph import LayerGraph
from repro_torch.core.toposort import acyclic_indices, topological_sort_edges

Edge = Tuple[str, str]


def iter_bits(mask: int) -> Iterator[int]:
    """Indices of set bits, ascending."""
    while mask:
        b = mask & -mask
        yield b.bit_length() - 1
        mask ^= b


class FusionState:
    """Immutable fusion genome over ``graph`` (bitmask representation)."""

    __slots__ = ("graph", "cg", "mask", "_fused", "_gmasks", "_mgroups",
                 "_gof", "_sched", "_cond", "_groups_str")

    def __init__(self, graph: LayerGraph, fused: FrozenSet[Edge] = frozenset()):
        cg = graph.compiled()
        eid = cg.edge_id
        mask = 0
        bad = []
        for e in fused:
            i = eid.get(e)
            if i is None:
                bad.append(e)
            else:
                mask |= 1 << i
        if bad:
            raise ValueError(f"fused edges not in graph: {sorted(bad)!r}")
        self._init(graph, cg, mask)

    def _init(self, graph, cg, mask, gmasks=None, mgroups=None, gof=None,
              sched=None, cond=None):
        self.graph = graph
        self.cg = cg
        self.mask = mask
        self._fused: Optional[FrozenSet[Edge]] = None
        self._gmasks: Optional[List[int]] = gmasks     # node-bitmask per group
        self._mgroups: Optional[List[int]] = mgroups   # multi-member masks only
        self._gof: Optional[List[int]] = gof           # node id -> group index
        self._sched: Optional[bool] = sched
        self._cond: Optional[List[List[int]]] = cond   # condensation adjacency
        self._groups_str: Optional[List[FrozenSet[str]]] = None

    @classmethod
    def _make(cls, graph, cg, mask, gmasks=None, mgroups=None, gof=None,
              sched=None, cond=None) -> "FusionState":
        s = object.__new__(cls)
        s._init(graph, cg, mask, gmasks, mgroups, gof, sched, cond)
        return s

    # ---- construction helpers -------------------------------------------------
    @classmethod
    def layerwise(cls, graph: LayerGraph) -> "FusionState":
        """The paper's initial population member: every layer on its own."""
        return cls._make(graph, graph.compiled(), 0)

    @classmethod
    def fully_fused(cls, graph: LayerGraph) -> "FusionState":
        cg = graph.compiled()
        return cls._make(graph, cg, (1 << cg.m) - 1)

    @classmethod
    def from_mask(cls, graph: LayerGraph, mask: int) -> "FusionState":
        cg = graph.compiled()
        if mask < 0 or mask >> cg.m:
            raise ValueError(f"mask {mask:#x} outside {cg.m}-edge genome")
        return cls._make(graph, cg, mask)

    # ---- genome views ----------------------------------------------------------
    @property
    def fused(self) -> FrozenSet[Edge]:
        if self._fused is None:
            ep = self.cg.edge_pairs
            self._fused = frozenset(ep[i] for i in iter_bits(self.mask))
        return self._fused

    # ---- genome actions (paper Fig. 8b) ----------------------------------------
    def combine(self, edge: Edge) -> "FusionState":
        i = self.cg.edge_id.get(edge)
        if i is None:
            raise ValueError(f"no such edge {edge!r}")
        return self._combine_idx(i)

    def separate(self, edge: Edge) -> "FusionState":
        i = self.cg.edge_id.get(edge)
        if i is None:                       # reference semantics: set difference
            return self._copy()
        return self._separate_idx(i)

    def mutate(self, rng: random.Random) -> "FusionState":
        """Paper Alg. 1 line 4: choose an adjacent layer pair, flip its state."""
        i = rng.randrange(self.cg.m)
        if (self.mask >> i) & 1:
            return self._separate_idx(i)
        return self._combine_idx(i)

    def _copy(self) -> "FusionState":
        return FusionState._make(self.graph, self.cg, self.mask, self._gmasks,
                                 self._mgroups, self._gof, self._sched,
                                 self._cond)

    def _combine_idx(self, i: int) -> "FusionState":
        bit = 1 << i
        if self.mask & bit:
            return self._copy()
        mask = self.mask | bit
        if self._gmasks is None:            # no parent structure: lazy child
            return FusionState._make(self.graph, self.cg, mask)
        self._ensure_gof()
        cg = self.cg
        gof = self._gof
        gu, gv = gof[cg.eu[i]], gof[cg.ev[i]]
        if gu == gv:                        # intra-group edge: same partition
            child = FusionState._make(self.graph, cg, mask, self._gmasks,
                                      self._mgroups, gof, self._sched,
                                      self._cond)
            return child
        sched = None
        if self._sched is True:
            # merging gu,gv cycles iff a gu ~> gv path of length >= 2 exists
            # (the direct gu->gv edge merges into an ignored self-loop)
            sched = not self._reaches_via_intermediate(gu, gv)
        a, b = (gu, gv) if gu < gv else (gv, gu)
        gmasks = self._gmasks
        ma, mb = gmasks[a], gmasks[b]
        merged = ma | mb
        new_gmasks = list(gmasks)
        new_gmasks[a] = merged
        del new_gmasks[b]
        new_mg = [m for m in self._mgroups if m != ma and m != mb]
        new_mg.append(merged)
        # eager gof remap: cheaper than a lazy rebuild because nearly every
        # offspring ends up re-mutated as a pool member within a generation
        new_gof = [a if g == b else (g - 1 if g > b else g) for g in gof]
        return FusionState._make(self.graph, cg, mask, new_gmasks, new_mg,
                                   new_gof, sched, None)

    def _separate_idx(self, i: int) -> "FusionState":
        bit = 1 << i
        if not (self.mask & bit):
            return self._copy()
        mask = self.mask ^ bit
        if self._gmasks is None:
            return FusionState._make(self.graph, self.cg, mask)
        cg = self.cg
        u, v = cg.eu[i], cg.ev[i]
        reached = self._fused_component(mask, u)
        if (reached >> v) & 1:              # still connected: same partition
            child = FusionState._make(self.graph, cg, mask, self._gmasks,
                                      self._mgroups, self._gof, self._sched,
                                      self._cond)
            return child
        self._ensure_gof()
        gi = self._gof[u]
        comp = self._gmasks[gi]
        piece_a, piece_b = reached, comp ^ reached
        keep, moved = ((piece_a, piece_b)
                       if (piece_a & -piece_a) < (piece_b & -piece_b)
                       else (piece_b, piece_a))
        new_gmasks = list(self._gmasks)
        new_gmasks[gi] = keep
        lb = moved & -moved
        pos = gi + 1
        while pos < len(new_gmasks) and \
                (new_gmasks[pos] & -new_gmasks[pos]) < lb:
            pos += 1
        new_gmasks.insert(pos, moved)
        new_mg = [m for m in self._mgroups if m != comp]
        if keep & (keep - 1):
            new_mg.append(keep)
        if moved & (moved - 1):
            new_mg.append(moved)
        sched = None
        if self._sched is True:
            # Splitting schedulable G into A (producer side, has u) and B
            # (has v) keeps the direct A->B condensation edge (u,v), so a
            # cycle forms iff B still reaches A.  A B ~> A path through any
            # *intermediate* group t would contract (A,B -> G) to a parent
            # condensation cycle G -> t ~> G — impossible, the parent is a
            # DAG — so only a DIRECT B -> A graph edge can close the cycle.
            a_mask, b_mask = reached, comp ^ reached
            succ_ids = cg.succ_ids
            cycle = False
            mb = b_mask
            while mb and not cycle:
                lsb = mb & -mb
                mb ^= lsb
                for w in succ_ids[lsb.bit_length() - 1]:
                    if (a_mask >> w) & 1:
                        cycle = True
                        break
            sched = not cycle
        # remap: old indices >= pos shift up, then nodes of the moved piece
        # are patched to pos (bit-iterating `moved` beats a per-node mask test)
        new_gof = [g + (g >= pos) for g in self._gof]
        mv = moved
        while mv:
            lsb = mv & -mv
            new_gof[lsb.bit_length() - 1] = pos
            mv ^= lsb
        return FusionState._make(self.graph, cg, mask, new_gmasks, new_mg,
                                   new_gof, sched, None)

    # ---- incremental machinery -------------------------------------------------
    def _fused_component(self, mask: int, start: int) -> int:
        """Node bitmask of ``start``'s component under fused edges of ``mask``."""
        inc = self.cg.inc
        seen = 1 << start
        stack = [start]
        while stack:
            x = stack.pop()
            for eidx, other in inc[x]:
                if (mask >> eidx) & 1 and not (seen >> other) & 1:
                    seen |= 1 << other
                    stack.append(other)
        return seen

    def _reaches_via_intermediate(self, gu: int, gv: int) -> bool:
        """Is there a ``gu ~> gv`` condensation path with >= 1 intermediate
        group?  Early-exit BFS over the implicit condensation with a *sound*
        node-id bound.

        Graph edges ascend node ids (builders insert producers first); a
        condensation path can only *descend* inside a multi-member group.  So
        pick the smallest bound ``T`` that starts above ``gv`` and is never
        straddled by a multi-member group (raise it past any group with
        members on both sides, to a fixpoint): neither an edge nor an
        intra-group hop can then cross ``T`` downward, and since ``gv`` lies
        entirely below ``T``, nodes at or above ``T`` can never lead back to
        it — they are safely pruned.
        """
        gmasks = self._gmasks
        T = gmasks[gv].bit_length()
        changed = True
        while changed:
            changed = False
            for m in self._mgroups:
                if (m >> T) and (m & ((1 << T) - 1)):
                    T = m.bit_length()
                    changed = True
        below = (1 << T) - 1
        gof = self._gof
        succ_ids = self.cg.succ_ids
        seen = {gu}
        stack = [gu]
        while stack:
            g = stack.pop()
            members = gmasks[g] & below
            while members:
                lsb = members & -members
                members ^= lsb
                for w in succ_ids[lsb.bit_length() - 1]:
                    t = gof[w]
                    if t == gv:
                        if g == gu:
                            continue        # direct edge: would self-loop
                        return True
                    if t not in seen:
                        seen.add(t)
                        stack.append(t)
        return False

    # ---- derived structure ------------------------------------------------------
    def _ensure_groups(self) -> None:
        if self._gmasks is not None:
            return
        cg = self.cg
        parent = list(range(cg.n))

        def find(x: int) -> int:
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        eu, ev = cg.eu, cg.ev
        for i in iter_bits(self.mask):
            ru, rv = find(eu[i]), find(ev[i])
            if ru != rv:
                parent[ru] = rv
        root_index: Dict[int, int] = {}
        gmasks: List[int] = []
        gof = [0] * cg.n
        for node in range(cg.n):
            r = find(node)
            gi = root_index.get(r)
            if gi is None:
                gi = len(gmasks)
                root_index[r] = gi
                gmasks.append(0)
            gmasks[gi] |= 1 << node
            gof[node] = gi
        self._gmasks = gmasks
        self._mgroups = [m for m in gmasks if m & (m - 1)]
        self._gof = gof

    def _ensure_gof(self) -> None:
        """Node->group map.  Every path that materializes ``_gmasks`` also
        materializes ``_gof`` (scratch builds make both; combine/separate
        remap the parent's eagerly), so this only triggers the from-scratch
        build on states that have computed neither."""
        if self._gof is None:
            self._ensure_groups()

    def group_masks(self) -> List[int]:
        """Node bitmasks per group, sorted by lowest member id (the group-cost
        cache key in :class:`repro_torch.costmodel.evaluator.Evaluator`)."""
        self._ensure_groups()
        assert self._gmasks is not None
        return self._gmasks

    def multi_masks(self) -> List[int]:
        """Node bitmasks of multi-member groups only (singletons cost exactly
        their layerwise baseline, so the fast fitness path skips them)."""
        self._ensure_groups()
        assert self._mgroups is not None
        return self._mgroups

    def groups(self) -> List[FrozenSet[str]]:
        """Weakly-connected components over fused edges, in first-seen order."""
        if self._groups_str is None:
            names = self.cg.names
            self._groups_str = [frozenset(names[i] for i in iter_bits(gm))
                                for gm in self.group_masks()]
        return self._groups_str

    def group_of(self, name: str) -> int:
        self._ensure_gof()
        assert self._gof is not None
        return self._gof[self.cg.id_of[name]]

    def _condensation(self) -> List[List[int]]:
        """Per-group successor lists (parallel edges kept; cheap to build,
        reused by every offspring of this state)."""
        if self._cond is None:
            self._ensure_gof()
            gof = self._gof
            cg = self.cg
            succ: List[List[int]] = [[] for _ in self._gmasks]
            eu, ev = cg.eu, cg.ev
            for i in range(cg.m):
                gu, gv = gof[eu[i]], gof[ev[i]]
                if gu != gv:
                    succ[gu].append(gv)
            self._cond = succ
        return self._cond

    def group_edges(self) -> List[Tuple[int, int]]:
        """Condensation edges (between distinct groups)."""
        self._ensure_gof()
        gof = self._gof
        cg = self.cg
        out = {(gof[cg.eu[i]], gof[cg.ev[i]]) for i in range(cg.m)
               if gof[cg.eu[i]] != gof[cg.ev[i]]}
        return sorted(out)

    def is_schedulable(self) -> bool:
        """Condensation must be a DAG (see module docstring)."""
        if self._sched is None:
            self._sched = acyclic_indices(self._condensation())
        return self._sched

    def group_schedule(self, rng: Optional[random.Random] = None
                       ) -> List[List[str]]:
        """Topologically-ordered groups, each internally topologically sorted
        (paper §III-C).  Raises CycleError on unschedulable states."""
        gs = self.groups()
        group_order = topological_sort_edges(range(len(gs)), self.group_edges(),
                                             rng)
        sched: List[List[str]] = []
        for gi in group_order:
            members = gs[gi]
            inner = topological_sort_edges(
                [n for n in self.graph.names if n in members],
                self.graph.edges, rng)
            sched.append(inner)
        return sched

    # ---- DRAM residency ----------------------------------------------------------
    def tensor_offchip(self, producer: str) -> bool:
        """True iff ``producer``'s output activation must be stored to DRAM:
        it has a consumer outside the producer's group, or no consumer at all
        (a model output)."""
        cg = self.cg
        u = cg.id_of[producer]
        succ = cg.succ_ids[u]
        if not succ:
            return True
        self._ensure_gof()
        gof = self._gof
        g = gof[u]
        return any(gof[w] != g for w in succ)

    def offchip_tensors(self) -> List[str]:
        cg = self.cg
        return [cg.names[u] for u in range(cg.n)
                if cg.out_size[u] and self.tensor_offchip(cg.names[u])]

    # ---- identity -------------------------------------------------------------------
    def key(self) -> int:
        """O(1) genome identity: the fused-edge bitmask."""
        return self.mask

    def __eq__(self, other):
        return isinstance(other, FusionState) and self.mask == other.mask \
            and self.graph is other.graph

    def __hash__(self):
        return hash((id(self.graph), self.mask))

    def __repr__(self):
        return (f"FusionState({self.graph.name}, {bin(self.mask).count('1')}/"
                f"{self.cg.m} edges fused, {len(self.group_masks())} groups)")
