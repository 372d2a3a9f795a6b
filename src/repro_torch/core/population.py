"""Array-native population evaluation: the GA hot loop, vectorized.

The incremental engine (``repro_torch.core.fusion`` + ``Evaluator._fitness_fast``)
scores one genome at a time: per-offspring union-find maintenance, per-group
dict lookups, per-state Kahn checks.  Profiling a MobileNet-v3 run shows most
of the wall time is that per-genome structure maintenance, not the cost model
— every group cost is already cached after the first few generations.

This module scores a whole population at once.  A batch of genomes becomes a
``(P, n_edges)`` bool matrix and every per-genome quantity is computed with a
handful of numpy kernels over :class:`repro_torch.core.graph.CompiledGraph`'s
integer arrays:

* **group labels** — CNN graphs are chains plus a few skip edges, so nodes
  are first labeled by maximal runs of consecutive fused chain edges
  (one ``maximum.accumulate`` for the whole batch), then the few non-adjacent
  fused edges are folded in with a Shiloach–Vishkin style hook-to-min /
  pointer-jump loop.  Labels equal each group's minimum member id, matching
  ``FusionState.group_masks()`` order exactly.
* **group identity** — each multi-member group's member bitmask is recovered
  exactly (no hashing): one ``bincount`` over the flattened labels sums
  per-node powers of two *offset by the group's minimum member*, giving the
  span pattern ``gmask >> label`` — sums of distinct powers spanning at most
  52 bits are exact in float64.  Narrow groups (span <= 52, i.e. essentially
  all of them on real CNNs) pack ``(min_member << 53) | pattern`` into a
  sorted int64 key table; wider groups fall back to reconstructing the exact
  python-int bitmask per slot (graphs beyond 1024 nodes skip the packed path
  entirely).  A table row carries the group's cached cost *correction*
  (group cost minus its members' singleton costs) plus two pure graph-shape
  flags:

  - ``low_exit`` — some edge leaves the group below its maximum member;
  - ``self_bad`` — some exit's strict closure re-enters the group
    (an immediate condensation cycle through this group alone).

* **schedulability** — node ids are topological by construction, so if every
  multi-member group's exit edges land *above* the group's maximum member,
  the condensation is acyclic (around any condensation cycle the per-group
  maximum would have to strictly increase).  A genome is therefore
  schedulable unless some group has ``low_exit``; any group with
  ``self_bad`` proves a cycle outright.  The rare residue — suspect genomes
  whose groups are all individually cycle-free — gets an exact batched
  check: per-group reachability unions over the static strict transitive
  closure, closed by boolean matrix squaring (:meth:`_sched_exact`).
* **fitness** — the layerwise baseline plus each group's correction, summed
  ``base + corrections`` in ascending group-min-member order via one
  ``bincount`` (which accumulates sequentially in input order), bit-for-bit
  identical to the canonical scalar path in ``Evaluator._fitness_fast``.
  Novel groups are costed through the evaluator's cost model only once a
  schedulable genome needs them, exactly like the scalar path.

The port's copy of ``repro/core/population.py``.  The group-label pass runs
on the evaluator's device: on CUDA the hand-written kernel
``csrc/ga_labels.cu`` (backend ``cuda``; one upload of the ``(P, n_edges)``
bits, one launch and one download of the ``(P, n)`` labels per batch), on
the CPU its plain PyTorch version (backend ``torch``).  Everything else
stays the reference's integer/float64 host work, exactly as the
reference's ``jax`` backend leaves it: labels are integers, so either
device gives the reference's bits.  The labels are checked to be a
fixpoint of pointer jumping; the kernel loops to convergence, so a failed
check is a bug and raises (there is no fallback).  ``Evaluator(...,
pop_engine="off")`` forces the per-state scalar path.

Spacemap interaction (``SearchSpec(spacemap=True)``): statically frozen
genes are masked out *upstream*, in :class:`repro_torch.core.problem.
FusionProblem`'s operators — every genome this engine receives simply has
those mask bits permanently 0, so the ``(P, n_edges)`` matrices carry
all-zero columns for frozen edges and no engine change (or conditional) is
needed here.  The chain-run labeling is indifferent to which bits can vary,
and the cost-correction table never sees a group that crosses a frozen
edge because no genome ever fuses one.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.ga_labels.ops import ga_labels, thread_launches
from repro_torch.kernels.ga_labels.ref import LabelTables, label_tables
from repro_torch.obs import clock

_MISSING = object()

#: smallest batch routed through the array engine; below this the per-state
#: canonical path wins on fixed overheads (both paths are bit-identical)
MIN_BATCH = 16

_I64 = np.int64
_U64 = np.uint64


class StaticTables:
    """Per-:class:`CompiledGraph` integer arrays shared by every batch (and,
    under the island backend, by every forked worker via COW)."""

    def __init__(self, cg):
        self.cg = cg
        n, m = cg.n, cg.m
        self.n = n
        self.m = m
        self.W = (n + 63) // 64                   # bitset words per node set
        self.mask_bytes = (m + 7) // 8
        eu = np.asarray(cg.eu, dtype=_I64)
        ev = np.asarray(cg.ev, dtype=_I64)
        self.eu, self.ev = eu, ev
        # direct successors / strict transitive closure, as python ints
        # (flag computation for novel groups) and packed bitset rows
        # (the exact residue check)
        succ_int = [0] * n
        reach_int = [0] * n
        for u in range(n - 1, -1, -1):
            r = 0
            s = 0
            for v in cg.succ_ids[u]:
                s |= 1 << v
                r |= (1 << v) | reach_int[v]
            succ_int[u] = s
            reach_int[u] = r
        self.succ_int = succ_int
        self.reach_int = reach_int
        self.Eb = _pack_rows(succ_int, self.W)    # (n, W) direct successors
        self.Cp = _pack_rows(reach_int, self.W)   # (n, W) strict closure
        self.nodebit = _pack_rows([1 << u for u in range(n)], self.W)
        self.ar_n = np.arange(n, dtype=_I64)
        # span-offset powers of two: exact float64 for offsets <= 52 (the
        # group-key fast path); larger offsets only occur on wide groups,
        # which are routed to the exact python path before these are trusted
        self.pow2 = np.ldexp(1.0, np.minimum(self.ar_n, 1023).astype(np.int32))
        self.bitpos = np.arange(64, dtype=_U64)
        self._grids: Dict[int, tuple] = {}        # per-population-size caches
        self._label_tables: Dict[torch.device, LabelTables] = {}

    def __getstate__(self):
        """Pickled for a spawned island process: the device tables stay
        behind (no CUDA tensor crosses); the child copies its own."""
        state = dict(self.__dict__)
        state["_label_tables"] = {}
        return state

    def label_tables(self, device: torch.device) -> LabelTables:
        """The edge tables of the label pass, int32 on ``device`` (copied
        there once per graph): chain edges (u -> u+1) drive the run
        labeling; the rest ("extra" edges: skips, concat fan-ins) go
        through hook/jump."""
        tb = self._label_tables.get(device)
        if tb is None:
            tb = label_tables(self.eu, self.ev, self.n, device)
            self._label_tables[device] = tb
        return tb

    def grids(self, p: int) -> tuple:
        g = self._grids.get(p)
        if g is None:
            n = self.n
            rowbase = np.repeat(np.arange(p, dtype=_I64) * n, n)
            ar_flat = np.tile(self.ar_n, p)
            if len(self._grids) > 16:             # bound the per-P cache
                self._grids.clear()
            g = (rowbase, ar_flat)
            self._grids[p] = g
        return g

    def group_flags(self, gmask: int) -> tuple:
        """(low_exit, self_bad) for one member bitmask — graph-shape-only
        properties, computed once per distinct group (python bitset math)."""
        succ = self.succ_int
        ex = 0
        mm = gmask
        while mm:
            b = mm & -mm
            ex |= succ[b.bit_length() - 1]
            mm ^= b
        ex &= ~gmask                              # exit targets
        low_exit = bool(ex & ((1 << (gmask.bit_length() - 1)) - 1))
        self_bad = False
        reach = self.reach_int
        mm = ex
        while mm:
            b = mm & -mm
            if reach[b.bit_length() - 1] & gmask:
                self_bad = True
                break
            mm ^= b
        return low_exit, self_bad


def _pack_rows(ints: Sequence[int], w: int) -> np.ndarray:
    out = np.zeros((len(ints), w), dtype=_U64)
    mask = (1 << 64) - 1
    for i, val in enumerate(ints):
        for j in range(w):
            out[i, j] = (val >> (64 * j)) & mask
    return out


class PopulationEvaluator:
    """Batched fitness/schedulability over ``(P, n_edges)`` genome matrices.

    Owned by (and sharing caches with) one
    :class:`repro_torch.costmodel.evaluator.Evaluator`; obtained via
    ``Evaluator.population()``.  Results are bit-for-bit identical to the
    canonical scalar path and to the reference's engine (pinned by
    ``tests/test_torch_ga_engine.py``).  ``device`` runs the label pass:
    CUDA launches ``csrc/ga_labels.cu``, the CPU its plain version.
    """

    def __init__(self, evaluator, device: torch.device):
        self.ev = evaluator
        self.t = StaticTables(evaluator.cg)
        self.device = torch.device(device)
        self.backend = "cuda" if self.device.type == "cuda" else "torch"
        # persistent group table (parallel arrays over row ids)
        self._ikeys = np.empty(0, dtype=_I64)     # sorted span-offset keys
        self._irows = np.empty(0, dtype=_I64)     # ... their row ids
        self._key_dict: Dict[int, int] = {}       # gmask -> row (insert side)
        self._corr_tab = np.empty((0, 6), dtype=np.float64)
        self._tvalid = np.empty(0, dtype=bool)    # correction is not None
        self._costed = np.empty(0, dtype=bool)    # correction computed yet?
        # low_exit / self_bad flags, packed (2**32 * self_bad + low_exit) so
        # one bincount recovers both per-genome any()s exactly: each weight
        # is 0 / 1 / 2**32 / 2**32+1 and per-genome sums stay far below 2**53
        self._lowsb = np.empty(0, dtype=np.float64)
        self._gmasks: List[int] = []              # row id -> member bitmask
        self._pending: List[tuple] = []           # rows awaiting commit
        self.batch_time = 0.0                     # seconds inside the engine
        self.batches = 0
        self.states_scored = 0
        self.residue_checks = 0                   # exact pair-closure runs
        self.label_launches = 0                   # ga_labels kernel launches
        self.label_time = 0.0                     # seconds in the label pass
        self.label_kernel_time = 0.0              # ... of it, in the kernel

    # ---- public API ---------------------------------------------------------------
    def fitness_masks(self, masks: Sequence[int], objective: str = "edp"
                      ) -> np.ndarray:
        """Fitness per genome mask (float64 array), canonical order."""
        t0 = clock.perf_counter()
        out = self._fitness_masks(masks, objective)
        self.batch_time += clock.perf_counter() - t0
        self.batches += 1
        self.states_scored += len(masks)
        return out

    def schedulable_masks(self, masks: Sequence[int]) -> np.ndarray:
        """Batched exact schedulability (bool array)."""
        return self._analyze(masks)[5]

    def group_labels(self, masks: Sequence[int]) -> np.ndarray:
        """(P, n) min-member group label per node (for tests/tools)."""
        return self._labels(self._unpack(masks))[0].reshape(len(masks),
                                                            self.t.n)

    def stats(self) -> Dict[str, float]:
        return {
            "backend": self.backend,
            "batches": self.batches,
            "states_scored": self.states_scored,
            "batch_time_s": self.batch_time,
            "batch_evals_per_sec": (self.states_scored / self.batch_time
                                    if self.batch_time else 0.0),
            "group_table_rows": len(self._gmasks),
            "residue_checks": self.residue_checks,
            "label_launches": self.label_launches,
            "label_time_s": self.label_time,
            "label_kernel_s": self.label_kernel_time,
        }

    # ---- batch pipeline -------------------------------------------------------------
    def _unpack(self, masks: Sequence[int]) -> np.ndarray:
        t = self.t
        nb = t.mask_bytes
        buf = b"".join(mk.to_bytes(nb, "little") for mk in masks)
        raw = np.frombuffer(buf, dtype=np.uint8).reshape(len(masks), nb)
        return np.unpackbits(raw, axis=1, bitorder="little")[:, :t.m]

    def _analyze(self, masks: Sequence[int]) -> tuple:
        """Shared front half: labels, group slots, table rows, and exact
        per-genome schedulability — no cost-model work."""
        t = self.t
        p, n = len(masks), t.n
        bits = self._unpack(masks)
        lf, mx = self._labels(bits)
        rowbase, ar_flat = t.grids(p)
        # one slot per multi-member group: its min member ("label") node
        slot_mask = (lf == ar_flat) & (mx > ar_flat)
        gslots = np.nonzero(slot_mask)[0]         # ascending (genome, label)
        gp = gslots // n
        if gslots.size:
            rows = self._rows_for_slots(lf, mx, gslots)
            flags = np.bincount(gp, weights=self._lowsb.take(rows),
                                minlength=p).astype(_I64)
            unsched = (flags >> np.int64(32)) > 0
            suspect = (flags & np.int64(0xFFFFFFFF)) > 0
            residue = np.nonzero(suspect & ~unsched)[0]
            if residue.size:                      # rare: multi-group cycles
                self.residue_checks += residue.size
                cyc = self._sched_exact(lf.reshape(p, n)[residue],
                                        mx.reshape(p, n)[residue])
                unsched[residue] |= cyc
        else:
            rows = np.empty(0, dtype=_I64)
            unsched = np.zeros(p, dtype=bool)
        return lf, mx, gslots, gp, rows, ~unsched

    def _fitness_masks(self, masks, objective) -> np.ndarray:
        ev = self.ev
        base = ev._ensure_base()
        p = len(masks)
        _, _, gslots, gp, rows, ok = self._analyze(masks)
        # cost-model work only for schedulable genomes' novel groups,
        # mirroring the scalar path's laziness
        if rows.size:
            keep = ok.take(gp)
            need = rows[keep & ~self._costed.take(rows)]
            if need.size:
                self._cost_rows(need)
            gp = gp[keep]
            rows = rows[keep]
            bad = np.bincount(gp, weights=~self._tvalid.take(rows),
                              minlength=p) > 0
        else:
            bad = np.zeros(p, dtype=bool)
        valid = ok & ~bad
        # canonical sums: base first, then corrections ascending by group
        # min member (bincount accumulates sequentially in input order)
        m2 = gp.size
        cat = np.empty(p + m2, dtype=_I64)
        cat[:p] = np.arange(p, dtype=_I64)
        cat[p:] = gp
        corr = self._corr_tab
        w = np.empty(p + m2)

        def comp(c: int) -> np.ndarray:
            w[:p] = base[c]
            w[p:] = corr[rows, c]
            return np.bincount(cat, weights=w, minlength=p)

        if objective == "edp":
            new = comp(0) * comp(1)
        elif objective == "energy":
            new = comp(0)
        elif objective == "cycles":
            new = comp(1)
        elif objective == "dram":
            new = comp(2) + comp(3)
        else:
            raise ValueError(f"unknown objective {objective!r}")
        out = np.zeros(p, dtype=np.float64)
        score = valid & (new > 0)
        out[score] = base[6][objective] / new[score]
        return out

    # ---- labels ---------------------------------------------------------------------
    def _labels(self, bits: np.ndarray):
        """Flat ``(P*n,)`` min-member labels + per-node group max member.

        The label pass on the engine's device (``kernels/ga_labels``): the
        bits up, one launch, the labels down (which waits for the kernel),
        its device time taken by CUDA events.  The labels must be a fixpoint
        of pointer jumping, as the reference's jax path checks
        (``repro/core/population.py:657``), and raise otherwise."""
        t0 = clock.perf_counter()
        p = bits.shape[0]
        tb = self.t.label_tables(self.device)
        x = torch.from_numpy(np.ascontiguousarray(bits)).to(self.device)
        launches = thread_launches()
        if self.device.type == "cuda":
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            lab = ga_labels(x, tb)
            ev1.record()
            lf = lab.cpu().numpy().astype(_I64).ravel()
            self.label_kernel_time += ev0.elapsed_time(ev1) / 1e3
        else:
            lf = ga_labels(x, tb).numpy().astype(_I64).ravel()
        self.label_launches += thread_launches() - launches
        rowbase = self.t.grids(p)[0]
        if not np.array_equal(lf, lf.take(rowbase + lf)):
            raise RuntimeError(
                f"ga_labels on {self.device}: labels are not a fixpoint of "
                f"pointer jumping")
        self.label_time += clock.perf_counter() - t0
        return lf, self._maxmem(lf, p)

    def _maxmem(self, lf: np.ndarray, p: int) -> np.ndarray:
        """Per-node maximum member id of the node's group (flat (P*n,))."""
        t = self.t
        rowbase, ar_flat = t.grids(p)
        mf = np.empty(p * t.n, dtype=_I64)
        mf[rowbase + lf] = ar_flat                # ascending: last write = max
        return mf.take(rowbase + lf)

    # ---- group table ----------------------------------------------------------------
    def _rows_for_slots(self, lf, mx, gslots) -> np.ndarray:
        """Group-table row per slot, inserting flag-only rows for novel
        groups (their costs are deferred until a schedulable genome needs
        them).

        Lookup key: one exact int64 per group — ``(label << 53) | pattern``
        where ``pattern = gmask >> label`` is built by a single bincount of
        span-offset powers of two (exact in float64 while the group span is
        <= 52; wider groups are rare and fall back to an exact per-slot
        python path, as do graphs with > 1024 nodes where the label would
        not fit above bit 53)."""
        t = self.t
        n = t.n
        if n > 1024:
            return self._rows_python(lf, gslots)
        # every node contributes 2^(node - label) to its label's flat slot
        # (singletons land on unread slots); one full-width bincount, then
        # gather the multi-group slots
        rowbase, ar_flat = t.grids(lf.size // n)
        g = gslots.size
        pattern = np.bincount(rowbase + lf, weights=t.pow2.take(ar_flat - lf),
                              minlength=lf.size).take(gslots)
        mn = gslots % n
        wide = (mx.take(gslots) - mn) > 52
        wide_any = bool(wide.any())
        if wide_any:
            pattern = np.where(wide, 1.0, pattern)
        patt_i = pattern.astype(_I64)             # <= 53 bits: exact
        keys = (mn << np.int64(53)) | patt_i
        if wide_any:
            keys[wide] = -1                       # never in the sorted table
        if len(self._ikeys):
            posc = np.minimum(np.searchsorted(self._ikeys, keys),
                              len(self._ikeys) - 1)
            hit = self._ikeys[posc] == keys
            rows = np.where(hit, self._irows.take(posc), np.int64(-1))
        else:
            hit = np.zeros(g, dtype=bool)
            rows = np.full(g, -1, dtype=_I64)
        self.ev.group_hits += int(hit.sum())
        miss = np.nonzero(~hit)[0]
        if miss.size:
            gsl = gslots.take(miss).tolist()
            kl = keys.take(miss).tolist()
            pl = patt_i.take(miss).tolist()
            mnl = mn.take(miss).tolist()
            wl = wide.take(miss).tolist() if wide_any else None
            for jj, ii in enumerate(miss.tolist()):
                if wl is not None and wl[jj]:
                    gmask = self._slot_gmask(lf, gsl[jj])
                    skey = None                   # dict-only: no int64 key
                else:
                    gmask = pl[jj] << mnl[jj]
                    skey = kl[jj]
                r = self._key_dict.get(gmask)
                if r is None:
                    r = self._new_row(gmask, skey)
                else:
                    self.ev.group_hits += 1
                rows[ii] = r
            if self._pending:
                self._commit_rows()
        return rows

    def _rows_python(self, lf, gslots) -> np.ndarray:
        """Exact per-slot path for graphs too wide for int64 keys."""
        rows = np.empty(gslots.size, dtype=_I64)
        for ii, sl in enumerate(gslots.tolist()):
            gmask = self._slot_gmask(lf, sl)
            r = self._key_dict.get(gmask)
            if r is None:
                r = self._new_row(gmask, None)
            else:
                self.ev.group_hits += 1
            rows[ii] = r
        if self._pending:
            self._commit_rows()
        return rows

    def _slot_gmask(self, lf: np.ndarray, slot: int) -> int:
        """Reassemble one group's member bitmask from the flat labels."""
        n = self.t.n
        base = slot - slot % n
        members = np.nonzero(lf[base:base + n] == slot % n)[0]
        gmask = 0
        for u in members.tolist():
            gmask |= 1 << u
        return gmask

    def _new_row(self, gmask: int, skey: Optional[int]) -> int:
        """Insert a flag-only row for a never-seen group (no costing)."""
        low, sb = self.t.group_flags(gmask)
        r = len(self._gmasks) + len(self._pending)
        self._pending.append((skey, low, sb, gmask))
        return r

    def _grow(self, need: int) -> None:
        """Capacity-double the parallel arrays (rows beyond the live count
        stay zero/False until committed, so over-allocation is invisible to
        the ``take``-based readers)."""
        cap = self._tvalid.size
        if need <= cap:
            return
        newcap = max(64, 2 * cap)
        while newcap < need:
            newcap *= 2
        ct = np.zeros((newcap, 6))
        ct[:cap] = self._corr_tab
        self._corr_tab = ct
        for name in ("_tvalid", "_costed", "_lowsb"):
            a = getattr(self, name)
            b = np.zeros(newcap, dtype=a.dtype)
            b[:cap] = a
            setattr(self, name, b)

    def _commit_rows(self) -> None:
        """Append this batch's novel rows to the parallel arrays and merge
        their int64 keys into the sorted lookup arrays."""
        pend = self._pending
        self._pending = []
        self._grow(len(self._gmasks) + len(pend))
        newk = []
        newr = []
        for skey, low, sb, gmask in pend:
            r = len(self._gmasks)
            self._lowsb[r] = low + sb * 4294967296.0
            self._key_dict[gmask] = r
            self._gmasks.append(gmask)
            if skey is not None:
                newk.append(skey)
                newr.append(r)
        if newk:
            nk = np.array(newk, dtype=_I64)
            nr = np.array(newr, dtype=_I64)
            order = np.argsort(nk)
            nk = nk[order]
            pos = np.searchsorted(self._ikeys, nk)
            self._ikeys = np.insert(self._ikeys, pos, nk)
            self._irows = np.insert(self._irows, pos, nr[order])

    def _cost_rows(self, need: np.ndarray) -> None:
        """Run the cost model for not-yet-costed rows (once per group)."""
        ev = self.ev
        for r in sorted(set(need.tolist())):
            gmask = self._gmasks[r]
            d = ev._corr.get(gmask, _MISSING)
            if d is _MISSING:
                d = ev._compute_correction(gmask)
                ev._corr[gmask] = d
            else:
                ev.group_hits += 1
            if d is not None:
                self._corr_tab[r] = d
                self._tvalid[r] = True
            self._costed[r] = True

    # ---- exact residue check ----------------------------------------------------------
    def _sched_exact(self, ls: np.ndarray, ms: np.ndarray) -> np.ndarray:
        """Exact condensation-cycle check for suspect genomes whose groups
        are individually cycle-free: reconstruct reachability between multi
        groups from the static strict closure and close it by boolean matrix
        squaring; a cycle exists iff two groups reach each other (single-group
        cycles were already excluded by the ``self_bad`` flag)."""
        t = self.t
        s, n = ls.shape
        w = t.W
        skey = (ls + np.arange(s, dtype=_I64)[:, None] * n).ravel()
        inst = np.nonzero((ms > ls).ravel())[0]   # multi-member node instances
        node = inst % n
        order = np.argsort(skey.take(inst), kind="stable")
        snode = node.take(order)
        sslot = skey.take(inst).take(order)
        starts = np.nonzero(np.r_[True, sslot[1:] != sslot[:-1]])[0]
        uslot = sslot.take(starts)
        # per-group unions of (closure | members) via one reduceat
        stacked = np.concatenate([t.Cp, t.nodebit], axis=1)
        red = np.bitwise_or.reduceat(stacked[snode], starts, axis=0)
        r0, gm = red[:, :w], red[:, w:]
        g2 = len(uslot)
        usi = uslot // n
        cnt = np.bincount(usi, minlength=s)
        k = int(cnt.max())
        off = np.zeros(s, dtype=_I64)
        np.cumsum(cnt[:-1], out=off[1:])
        rank = np.arange(g2, dtype=_I64) - off.take(usi)
        r0p = np.zeros((s, k, w), dtype=_U64)
        gmp = np.zeros((s, k, w), dtype=_U64)
        r0p[usi, rank] = r0
        gmp[usi, rank] = gm
        h = ((r0p[:, :, None, :] & gmp[:, None, :, :]) != 0).any(-1)
        cyc = np.zeros(s, dtype=bool)
        if k > 1:
            for _ in range(max(1, int(np.ceil(np.log2(k))))):
                hf = h.astype(np.float32)
                nh = h | (np.matmul(hf, hf) > 0)
                if np.array_equal(nh, h):
                    break
                h = nh
            mut = h & h.swapaxes(1, 2)
            mut &= ~np.eye(k, dtype=bool)
            cyc = mut.any(axis=(1, 2))
        return cyc
