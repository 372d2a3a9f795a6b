"""Independent artifact verification (no ``core.fusion``, no evaluator).

The port's copy of ``repro/analysis/verify.py``: every artifact the port
writes, and the reference's of the same kinds.

A :class:`~repro_torch.search.artifact.ScheduleArtifact` asserts: *this genome,
on this graph, forms these groups, is schedulable, fits the machine, and
costs this much*.  Every one of those claims came from the same engine
that searched it.  This module re-checks them from the artifact's bytes
alone — the embedded :class:`~repro_torch.ir.GraphIR` (or a registry rebuild)
plus the edge-bitmask genome — with its own adjacency reconstruction,
its own union-find grouping, its own Kahn condensation check, and its
own line-buffer footprint recurrence.  Deliberately, nothing here
imports ``repro_torch.core.fusion`` or ``repro_torch.costmodel.evaluator``: an
artifact-corrupting bug (or a hand-edited store object) in the engine
path cannot also hide the evidence in the checker path
(``tests/test_torch_verify.py`` pins the no-import rule for this copy).

Checks, in order (each becomes a :class:`Check` row in the report):

==================  =========================================================
graph-source        embedded IR parses / registry workload rebuilds
fingerprint         ``ir1:sha256`` of the canonical IR matches the artifact
                    (legacy ``sha256:`` fingerprints get a distinct message)
edges               ``n_edges`` and genome range match the re-derived edge
                    list (same dedupe + order as ``CompiledGraph``)
fused-edges         the stored edge list is exactly the decoded genome
groups              union-find group count matches ``best.n_groups`` /
                    ``baseline.n_groups``
schedulable         group condensation is acyclic (own Kahn scan)
footprint           every multi-layer group's t=1 line-buffer window fits
                    the machine's activation level
act-writes          per-tensor DRAM write events re-derived from group
                    boundaries match both cost records
cost-consistency    per-group breakdowns cover the derived groups and sum
                    to the claimed ``best`` totals
spacemap            (``spacemap=True`` runs) the stored static-analysis
                    summary matches an independent re-derivation
                    (:mod:`repro_torch.analysis.spacemap`) and the genome sets
                    no provably forced-off gene
store-key           (``--store`` only) the object's content-address matches
bounds              modeled traffic >= Chen-et-al lower bounds
                    (:mod:`repro_torch.analysis.bounds`) — yields the certificate
==================  =========================================================

The surviving artifact carries a :class:`Certificate`: its DRAM traffic,
the schedule-specific lower bound, the schedule-independent graph lower
bound, and the optimality gaps against both — rendered by ``repro
verify`` and ``repro report``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import (TYPE_CHECKING, Any, Dict, List, Optional, Sequence,
                    Tuple)

from repro_torch.analysis.bounds import (TrafficBound, graph_bound,
                                   onchip_words_for, schedule_bound)
from repro_torch.core.graph import Layer, LayerGraph

if TYPE_CHECKING:                    # type-only: keeps the runtime import
    from repro_torch.search.artifact import ScheduleArtifact    # graph light

#: relative tolerance for float totals (energy, cycles): the artifact's
#: ``best`` was summed from the identical per-group tuples in the identical
#: order, so the match is exact in practice; the tolerance only forgives a
#: serializer that round-trips floats through shortest-repr decimal
_REL_TOL = 1e-9


@dataclass(frozen=True)
class Check:
    """One verified claim: name, verdict, human-readable evidence."""

    name: str
    ok: bool
    detail: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "ok": self.ok, "detail": self.detail}


@dataclass(frozen=True)
class Certificate:
    """Optimality-gap certificate: modeled DRAM traffic vs the Chen et al.
    lower bounds (see :mod:`repro_torch.analysis.bounds`)."""

    traffic_words: int            # best.dram_read + best.dram_write
    schedule_lb_words: int        # sum of per-group bounds for THIS grouping
    graph_lb_words: int           # bound no grouping can beat
    onchip_words: int             # S the Hong-Kung term pebbled against
    group_lb_words: Tuple[int, ...] = ()

    @property
    def gap_vs_schedule(self) -> float:
        """Fractional slack above this schedule's own bound (>= 0)."""
        if self.schedule_lb_words <= 0:
            return 0.0
        return self.traffic_words / self.schedule_lb_words - 1.0

    @property
    def gap_vs_graph(self) -> float:
        """Fractional distance from provable optimality: how far the
        winner's traffic sits above what *any* grouping must pay."""
        if self.graph_lb_words <= 0:
            return 0.0
        return self.traffic_words / self.graph_lb_words - 1.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "traffic_words": self.traffic_words,
            "schedule_lb_words": self.schedule_lb_words,
            "graph_lb_words": self.graph_lb_words,
            "onchip_words": self.onchip_words,
            "gap_vs_schedule": self.gap_vs_schedule,
            "gap_vs_graph": self.gap_vs_graph,
            "group_lb_words": list(self.group_lb_words),
        }

    def describe(self) -> str:
        return (f"DRAM traffic {self.traffic_words} words >= schedule LB "
                f"{self.schedule_lb_words} (gap {self.gap_vs_schedule:+.1%})"
                f" >= graph LB {self.graph_lb_words} "
                f"(gap {self.gap_vs_graph:+.1%})")


@dataclass
class VerificationReport:
    """Outcome of :func:`verify_artifact`: the check rows plus, when every
    structural check passed and the cost model has a bound model, the
    lower-bound :class:`Certificate`."""

    checks: List[Check] = field(default_factory=list)
    certificate: Optional[Certificate] = None

    @property
    def ok(self) -> bool:
        return all(c.ok for c in self.checks)

    def failures(self) -> List[Check]:
        return [c for c in self.checks if not c.ok]

    def check(self, name: str) -> Optional[Check]:
        for c in self.checks:
            if c.name == name:
                return c
        return None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "ok": self.ok,
            "checks": [c.to_dict() for c in self.checks],
            "certificate": self.certificate.to_dict()
                           if self.certificate else None,
        }

    def describe(self) -> str:
        lines = []
        for c in self.checks:
            mark = "ok  " if c.ok else "FAIL"
            lines.append(f"  [{mark}] {c.name}"
                         + (f": {c.detail}" if c.detail else ""))
        if self.certificate is not None:
            lines.append(f"  certificate: {self.certificate.describe()}")
        return "\n".join(lines)


# ---- independent structural view ------------------------------------------------


class _GraphView:
    """The verifier's own integer view of the searched graph.

    Rebuilds successor lists from each node's predecessor list (one entry
    per occurrence, consumers in node order) and dedupes parallel edges
    first-occurrence-first — the same construction, re-derived, that fixes
    the genome's bit order in ``repro_torch.core.graph.CompiledGraph``.  All
    grouping/legality math below runs on these arrays only.
    """

    def __init__(self, graph: LayerGraph):
        self.names: Tuple[str, ...] = tuple(graph.layers)
        self.n = len(self.names)
        self.id_of = {nm: i for i, nm in enumerate(self.names)}
        self.layers: Tuple[Layer, ...] = tuple(
            graph.layers[nm] for nm in self.names)
        self.preds: List[List[int]] = [
            [self.id_of[p] for p in graph.preds(nm)] for nm in self.names]
        succs: List[List[int]] = [[] for _ in range(self.n)]
        for v in range(self.n):
            for u in self.preds[v]:
                succs[u].append(v)
        self.succs = succs
        # parallel-edge dedupe, successor-major order (= genome bit order)
        self.edges: List[Tuple[int, int]] = list(dict.fromkeys(
            (u, v) for u in range(self.n) for v in succs[u]))
        self.m = len(self.edges)

    # ---- grouping ---------------------------------------------------------------
    def groups_of(self, mask: int) -> List[List[int]]:
        """Weakly-connected components over the fused edges, by union-find;
        groups ordered by smallest member id, members ascending."""
        parent = list(range(self.n))

        def find(x: int) -> int:
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for i, (u, v) in enumerate(self.edges):
            if (mask >> i) & 1:
                ru, rv = find(u), find(v)
                if ru != rv:
                    parent[max(ru, rv)] = min(ru, rv)
        by_root: Dict[int, List[int]] = {}
        for x in range(self.n):
            by_root.setdefault(find(x), []).append(x)
        return [by_root[r] for r in sorted(by_root)]

    def condensation_acyclic(self, groups: Sequence[Sequence[int]]) -> bool:
        """Own Kahn scan over the group condensation: the fused schedule is
        executable iff no inter-group dependency cycle exists."""
        comp = [0] * self.n
        for gi, members in enumerate(groups):
            for x in members:
                comp[x] = gi
        k = len(groups)
        gsucc: List[List[int]] = [[] for _ in range(k)]
        indeg = [0] * k
        for u in range(self.n):
            for v in self.succs[u]:
                if comp[u] != comp[v]:      # parallel edges inflate both
                    gsucc[comp[u]].append(comp[v])
                    indeg[comp[v]] += 1     # sides symmetrically: exact
        stack = [g for g in range(k) if indeg[g] == 0]
        seen = 0
        while stack:
            g = stack.pop()
            seen += 1
            for h in gsucc[g]:
                indeg[h] -= 1
                if indeg[h] == 0:
                    stack.append(h)
        return seen == k

    # ---- boundary / cost structure ----------------------------------------------
    def costed(self, i: int) -> bool:
        layer = self.layers[i]
        return not (layer.macs == 0 and layer.kind == "input")

    def outputs_offchip(self, i: int, members: Sequence[int]) -> bool:
        mset = set(members)
        succ = self.succs[i]
        return (not succ) or any(v not in mset for v in succ)

    def act_write_events(self, groups: Sequence[Sequence[int]]) -> int:
        events = 0
        for members in groups:
            for i in members:
                if self.costed(i) and self.layers[i].output_size \
                        and self.outputs_offchip(i, members):
                    events += 1
        return events

    # ---- footprint (own line-buffer recurrence) ----------------------------------
    def member_topo(self, members: Sequence[int]) -> List[int]:
        """FIFO-Kahn order of the induced subgraph, seeded ascending — the
        same ready-queue discipline the engine's member ordering uses, so
        the first-consumer staging rule below picks the same consumer."""
        mset = set(members)
        indeg = {i: sum(1 for p in self.preds[i] if p in mset)
                 for i in members}
        ready = [i for i in sorted(members) if indeg[i] == 0]
        order: List[int] = []
        while ready:
            u = ready.pop(0)
            order.append(u)
            for v in self.succs[u]:
                if v in mset:
                    indeg[v] -= 1
                    if indeg[v] == 0:
                        ready.append(v)
        return order

    @staticmethod
    def _rows_in(layer: Layer, rows_out: int) -> int:
        """Input rows needed for ``rows_out`` output rows (receptive-field
        recurrence, re-derived; clamps mirror the full-height limits)."""
        rows_out = min(rows_out, layer.p) if layer.p else rows_out
        if layer.kind in ("conv", "dwconv", "pool"):
            need = (rows_out - 1) * layer.stride[0] \
                + (layer.r - 1) * layer.dilation[0] + 1
            return min(max(need, 1), layer.h) if layer.h else need
        if layer.kind in ("fc", "global_pool"):
            return layer.h if layer.h else 1
        if layer.kind == "upsample":
            return min(max(math.ceil(
                rows_out * max(layer.h, 1) / max(layer.p, 1)), 1),
                max(layer.h, 1))
        return rows_out                     # elementwise glue: row-for-row

    def footprint_words(self, members: Sequence[int], t: int = 1) -> int:
        """Activation words live while streaming ``t`` sink rows: each
        member keeps its backtraced window; external inputs are staged at
        the window of their first in-group consumer."""
        order = self.member_topo(members)
        mset = set(order)
        rows: Dict[int, int] = {}
        for i in reversed(order):
            layer = self.layers[i]
            inner = [v for v in self.succs[i] if v in mset]
            if not inner:
                rows[i] = min(t, layer.p) if layer.p else t
            else:
                need = 1
                for v in inner:
                    need = max(need, self._rows_in(self.layers[v], rows[v]))
                rows[i] = min(need, layer.p) if layer.p else need
        total = 0
        staged = set()
        for i in order:
            layer = self.layers[i]
            if layer.output_size:
                total += layer.m * layer.q \
                    * min(rows[i], layer.p or rows[i])
            for src in self.preds[i]:
                if src in mset or src in staged:
                    continue
                staged.add(src)
                src_l = self.layers[src]
                if not src_l.output_size:
                    continue
                win = self._rows_in(layer, rows[i])
                total += src_l.m * src_l.q * min(win, src_l.p or win)
        return total

    def is_multi(self, members: Sequence[int]) -> bool:
        """Groups the engine tiles (and footprint-checks): more than one
        MAC-carrying member."""
        return len(members) > 1 and \
            sum(1 for i in members if self.layers[i].macs) > 1


# ---- capacity resolution ---------------------------------------------------------


def _act_capacity(costmodel: str, accelerator: str
                  ) -> Tuple[Optional[int], str]:
    """(activation-level words the footprint must fit, provenance) — or
    (None, reason) when this cost backend's capacity rule is unknown."""
    if costmodel == "default":
        from repro_torch.search.registry import RegistryError, build_accelerator
        try:
            acc = build_accelerator(accelerator)
        except RegistryError as e:
            return None, f"unknown accelerator {accelerator!r}: {e}"
        return acc.act_buf_words, \
            f"{accelerator} act_buf ({acc.act_buf_words} words)"
    if costmodel == "tpu":
        from repro_torch.costmodel.tpu_fusion import VMEM_BYTES
        words = int(VMEM_BYTES / 2) // 2
        return words, f"TPU VMEM activation budget ({words} words)"
    return None, f"no capacity rule for costmodel {costmodel!r}"


# ---- the verifier ----------------------------------------------------------------


def _rebuild(artifact: "ScheduleArtifact"
             ) -> Tuple[Optional[LayerGraph], Optional[str], Check]:
    """(graph, recomputed fingerprint, graph-source check).

    Prefers the embedded GraphIR (self-contained artifacts); registry
    workloads rebuild from their spec — the fingerprint check then proves
    the registry still builds the structure the genome indexes."""
    from repro_torch.ir import GraphIR, IRError
    spec = artifact.spec
    if artifact.graph_ir is not None:
        try:
            ir = GraphIR.from_dict(artifact.graph_ir)
            return ir.build(), ir.fingerprint(), \
                Check("graph-source", True, "embedded GraphIR")
        except (IRError, ValueError, KeyError, TypeError) as e:
            return None, None, Check(
                "graph-source", False,
                f"embedded GraphIR does not parse/build: {e}")
    if spec.workload.startswith("ir:"):
        return None, None, Check(
            "graph-source", False,
            f"workload {spec.workload!r} requires an embedded graph_ir "
            f"but the artifact carries none (stripped or legacy writer)")
    from repro_torch.search.registry import RegistryError
    from repro_torch.search.registry import build_workload
    try:
        graph = build_workload(spec.workload, **spec.workload_kwargs)
    except (RegistryError, IRError, ValueError, TypeError,
            FileNotFoundError) as e:
        return None, None, Check(
            "graph-source", False,
            f"cannot rebuild workload {spec.workload!r}: {e}")
    return graph, GraphIR.from_graph(graph).fingerprint(), \
        Check("graph-source", True, f"registry rebuild of {spec.workload!r}")


def _check_fingerprint(artifact: "ScheduleArtifact", fp: str) -> Check:
    from repro_torch.ir import GraphIR
    claimed = artifact.graph_fingerprint
    if claimed == fp:
        return Check("fingerprint", True, fp)
    fmt = GraphIR.FINGERPRINT_FORMAT + ":"
    if not claimed.startswith(fmt):
        return Check(
            "fingerprint", False,
            f"artifact carries a {claimed.split(':', 1)[0]!r}-format "
            f"fingerprint; this build computes {fmt[:-1]!r} — the genome "
            f"cannot be safely re-bound, regenerate the artifact")
    return Check("fingerprint", False,
                 f"claimed {claimed} but the graph hashes to {fp} "
                 f"(IR bytes and genome disagree)")


def _check_cost_consistency(artifact: "ScheduleArtifact", view: _GraphView,
                            groups: List[List[int]]) -> Check:
    bds = artifact.group_breakdowns
    if not bds:
        return Check("cost-consistency", True,
                     "skipped: artifact embeds no per-group breakdowns")
    if len(bds) != len(groups):
        return Check("cost-consistency", False,
                     f"{len(bds)} breakdown rows for "
                     f"{len(groups)} derived groups")
    for gi, (bd, members) in enumerate(zip(bds, groups)):
        want = {view.names[i] for i in members}
        got = set(bd.members)
        if got and got != want:
            return Check(
                "cost-consistency", False,
                f"breakdown row {gi} covers {sorted(got)} but the genome "
                f"derives group {sorted(want)}")
    sums = {
        "dram_read_words": sum(b.dram_read_words for b in bds),
        "dram_write_words": sum(b.dram_write_words for b in bds),
        "act_write_events": sum(b.act_write_events for b in bds),
        "macs": sum(b.macs for b in bds),
    }
    for name, got in sums.items():
        want = getattr(artifact.best, name)
        if got != want:
            return Check("cost-consistency", False,
                         f"breakdowns sum {name}={got} but best claims "
                         f"{want}")
    for name, got in (("energy_pj", sum(b.energy_pj for b in bds)),
                      ("cycles", sum(b.cycles for b in bds))):
        want = getattr(artifact.best, name)
        scale = max(abs(want), abs(got), 1.0)
        if abs(got - want) > _REL_TOL * scale:
            return Check("cost-consistency", False,
                         f"breakdowns sum {name}={got!r} but best claims "
                         f"{want!r}")
    return Check("cost-consistency", True,
                 f"{len(bds)} group breakdowns sum to the claimed totals")


def _check_spacemap(artifact: "ScheduleArtifact", graph: LayerGraph,
                    mask: int) -> Check:
    """Re-derive the static fusion-space analysis and hold the artifact to
    it: the stored summary must match the independent re-derivation and
    the winning genome must not set any provably forced-off gene."""
    # lazy: spacemap imports this module's _GraphView, so a top-level
    # import here would be circular
    from repro_torch.analysis.spacemap import build_spacemap
    claimed = artifact.spacemap
    if claimed is None:
        return Check(
            "spacemap", False,
            "spec ran with spacemap=True but the artifact carries no "
            "spacemap summary (stripped or written by a legacy build)")
    sm = build_spacemap(graph, artifact.spec.costmodel,
                        artifact.spec.accelerator)
    derived = sm.summary()
    if derived != claimed:
        diff = sorted(k for k in set(derived) | set(claimed)
                      if derived.get(k) != claimed.get(k))
        return Check(
            "spacemap", False,
            f"stored spacemap summary disagrees with the re-derived "
            f"analysis on {diff} (e.g. {diff[0]!r}: stored "
            f"{claimed.get(diff[0])!r}, derived {derived.get(diff[0])!r})")
    hot = [i for i in sm.frozen_indices if (mask >> i) & 1]
    if hot:
        return Check(
            "spacemap", False,
            f"genome sets statically forced-off gene bits {hot} — every "
            f"grouping containing those edges exceeds the activation "
            f"capacity, so the claimed schedule cannot be valid")
    return Check(
        "spacemap", True,
        f"{len(sm.frozen_indices)} frozen genes and {len(sm.regions)} "
        f"regions re-derived identically; genome respects the freeze")


def verify_artifact(artifact: "ScheduleArtifact", *,
                    expect_key: Optional[str] = None,
                    obs: Optional[Any] = None
                    ) -> VerificationReport:
    """Re-derive and re-check every claim a :class:`ScheduleArtifact`
    makes (see module docstring for the check list).  ``expect_key``
    additionally pins the artifact to a store object's content address.
    ``obs`` (duck-typed: anything with ``record_certificate``, e.g. a
    :class:`repro_torch.obs.TelemetryCollector`) receives the traffic certificate
    when one is derived — kept duck-typed so this module's import boundary
    (engine-free) needs no new pins."""
    report = VerificationReport()
    checks = report.checks

    graph, fp, src_check = _rebuild(artifact)
    checks.append(src_check)
    if graph is None or fp is None:
        return report
    checks.append(_check_fingerprint(artifact, fp))

    view = _GraphView(graph)
    mask = artifact.genome_mask
    edge_ok = artifact.n_edges == view.m and 0 <= mask < (1 << view.m)
    checks.append(Check(
        "edges", edge_ok,
        f"{view.m} edges re-derived, genome {mask:#x}" if edge_ok else
        f"artifact claims n_edges={artifact.n_edges}, genome {mask:#x}; "
        f"the graph re-derives {view.m} edges "
        f"(genome must lie in [0, 2**{view.m}))"))
    if not edge_ok:
        return report

    decoded = sorted([view.names[u], view.names[v]]
                     for i, (u, v) in enumerate(view.edges)
                     if (mask >> i) & 1)
    stored = sorted(list(e) for e in artifact.fused_edges)
    checks.append(Check(
        "fused-edges", decoded == stored,
        f"{len(decoded)} fused edges match the genome" if decoded == stored
        else f"stored fused_edges disagree with the decoded genome "
             f"(stored {len(stored)}, decoded {len(decoded)}; first "
             f"diff {next((a for a, b in zip(stored, decoded) if a != b), (stored or decoded)[:1])})"))

    groups = view.groups_of(mask)
    n_ok = artifact.best.n_groups == len(groups) \
        and artifact.baseline.n_groups == view.n
    checks.append(Check(
        "groups", n_ok,
        f"{len(groups)} fused groups over {view.n} layers" if n_ok else
        f"derived {len(groups)} groups / {view.n} layers but artifact "
        f"claims best.n_groups={artifact.best.n_groups}, "
        f"baseline.n_groups={artifact.baseline.n_groups}"))

    acyclic = view.condensation_acyclic(groups)
    checks.append(Check(
        "schedulable", acyclic,
        "group condensation is acyclic (Kahn)" if acyclic else
        "group condensation contains a dependency cycle — this genome is "
        "not executable and should never have been packaged"))

    cap, cap_how = _act_capacity(artifact.spec.costmodel,
                                 artifact.spec.accelerator)
    if cap is None:
        checks.append(Check("footprint", True, f"skipped: {cap_how}"))
    else:
        over = []
        for members in groups:
            if not view.is_multi(members):
                continue
            fw = view.footprint_words(members, 1)
            if fw > cap:
                over.append((members, fw))
        checks.append(Check(
            "footprint", not over,
            f"all multi-layer groups fit {cap_how}" if not over else
            f"group {[view.names[i] for i in over[0][0]]} needs "
            f"{over[0][1]} activation words at t=1 but {cap_how} — "
            f"over-capacity groups are invalid mappings"))

    best_aw = view.act_write_events(groups)
    base_aw = view.act_write_events([[i] for i in range(view.n)])
    aw_ok = best_aw == artifact.best.act_write_events \
        and base_aw == artifact.baseline.act_write_events
    checks.append(Check(
        "act-writes", aw_ok,
        f"DRAM act-writes {base_aw} -> {best_aw}" if aw_ok else
        f"re-derived act-writes base={base_aw}, best={best_aw} but "
        f"artifact claims base={artifact.baseline.act_write_events}, "
        f"best={artifact.best.act_write_events}"))

    checks.append(_check_cost_consistency(artifact, view, groups))

    if artifact.spacemap is not None or artifact.spec.spacemap:
        checks.append(_check_spacemap(artifact, graph, mask))

    if expect_key is not None:
        from repro_torch.serve.store import artifact_key
        key = artifact_key(artifact.graph_fingerprint, artifact.spec)
        checks.append(Check(
            "store-key", key == expect_key,
            "content address matches" if key == expect_key else
            f"object stored under {expect_key[:12]}... but its content "
            f"addresses to {key[:12]}..."))

    onchip = None
    if cap is not None:                    # known costmodel semantics only
        from repro_torch.search.registry import RegistryError
        try:
            onchip = onchip_words_for(artifact.spec.costmodel,
                                      artifact.spec.accelerator)
        except RegistryError:
            onchip = None
    if onchip is None:
        checks.append(Check(
            "bounds", True,
            f"skipped: no lower-bound model for costmodel "
            f"{artifact.spec.costmodel!r}"))
        return report
    name_groups = [[view.names[i] for i in g] for g in groups]
    per_group, sched_lb = schedule_bound(graph, name_groups, onchip)
    g_lb: TrafficBound = graph_bound(graph, onchip)
    traffic = artifact.best.dram_read_words + artifact.best.dram_write_words
    cert = Certificate(
        traffic_words=traffic, schedule_lb_words=sched_lb,
        graph_lb_words=g_lb.words, onchip_words=onchip,
        group_lb_words=tuple(b.words for b in per_group))
    report.certificate = cert
    lb_ok = traffic >= sched_lb and traffic >= g_lb.words
    checks.append(Check(
        "bounds", lb_ok,
        cert.describe() if lb_ok else
        f"claimed DRAM traffic {traffic} words is BELOW the provable "
        f"lower bound (schedule LB {sched_lb}, graph LB {g_lb.words}) — "
        f"the reported cost is deflated or the genome was altered"))
    if obs is not None:
        obs.record_certificate(artifact.graph_fingerprint, cert, report.ok)
    return report


def verify_store(root: str, *, obs: Optional[Any] = None
                 ) -> List[Tuple[str, VerificationReport]]:
    """Verify every object in an :class:`~repro_torch.serve.store.ArtifactStore`
    against its own content address.  Unreadable objects yield a report
    whose single failed ``store-object`` check carries the load error."""
    from repro_torch.serve.store import ArtifactStore, StoreError
    store = ArtifactStore(root, create=False)
    out: List[Tuple[str, VerificationReport]] = []
    for key in store.keys():
        try:
            artifact = store.load_key(key)
        except StoreError as e:
            out.append((key, VerificationReport(
                checks=[Check("store-object", False, str(e))])))
            continue
        if artifact is None:               # raced with a concurrent delete
            continue
        out.append((key, verify_artifact(artifact, expect_key=key, obs=obs)))
    return out
