"""Schedule reporting: the text analogue of paper Fig. 9.

Renders a GA-optimized fusion schedule as per-group rows (members, tile
height, buffer occupancy, DRAM traffic, EDP share) so the "adjacent bars
with the same color are fused" figure has a terminal-friendly counterpart.
:func:`breakdown_report` renders the per-group :class:`CostBreakdown`s a
search artifact stores — where energy and cycles go, group by group —
without rebuilding the graph or re-running the cost model.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.core.fusion import FusionState
from repro_torch.core.receptive import (group_footprint_words, max_tile_rows,
                                  receptive_field_hw)
from repro_torch.core.schedule import ScheduleResult
from repro_torch.core.toposort import topological_sort_edges
from repro_torch.costmodel.base import CostBreakdown


def schedule_report(res: ScheduleResult, acc, max_rows: int = 0) -> str:
    """Multi-line report for a :class:`ScheduleResult` on accelerator
    ``acc``."""
    g = res.best_state.graph
    lines = [
        f"workload={res.workload} accelerator={res.accelerator}",
        f"energy x{res.energy_improvement:.3f}  edp x{res.edp_improvement:.3f}"
        f"  dram x{res.dram_improvement:.3f}  groups={res.best.n_groups}"
        f"  act-writes {res.baseline.act_write_events}->"
        f"{res.best.act_write_events}",
        f"{'group':>5} {'n':>3} {'tile':>4} {'buf%':>5} {'RF':>7}  members",
    ]
    sched = res.best_state.group_schedule()
    shown = 0
    for gi, members in enumerate(sched):
        order = topological_sort_edges(
            [n for n in g.names if n in set(members)], g.edges)
        multi = len([n for n in order if g.layers[n].macs]) > 1
        if multi:
            t = max_tile_rows(g, order, acc.act_buf_words)
            occ = group_footprint_words(g, order, max(t, 1)) \
                / acc.act_buf_words * 100
            rf = "x".join(map(str, receptive_field_hw(g, order)))
        else:
            t, occ, rf = 0, 0.0, "-"
        label = ",".join(order[:4]) + ("..." if len(order) > 4 else "")
        lines.append(f"{gi:>5} {len(order):>3} {t:>4} {occ:>4.0f}% {rf:>7}"
                     f"  {label}")
        shown += 1
        if max_rows and shown >= max_rows:
            lines.append(f"  ... ({len(sched) - shown} more groups)")
            break
    return "\n".join(lines)


def breakdown_report(breakdowns: Sequence[CostBreakdown],
                     max_rows: int = 10) -> str:
    """Per-group cost table from stored :class:`CostBreakdown`s (what
    ``repro report`` renders): each group's energy/cycle share, whether
    compute or DRAM binds it, the mapping decisions (tile rows, weight
    passes), and its dominant energy component.

    Groups are shown largest-energy-first; ``max_rows=0`` shows all.
    """
    if not breakdowns:
        return "(artifact stores no per-group cost breakdowns)"
    total_e = sum(bd.energy_pj for bd in breakdowns) or 1.0
    total_c = sum(bd.cycles for bd in breakdowns) or 1.0
    order = sorted(range(len(breakdowns)),
                   key=lambda i: -breakdowns[i].energy_pj)
    lines = [
        f"{'group':>5} {'n':>3} {'energy%':>7} {'cycle%':>6} {'bound':>7} "
        f"{'tile':>4} {'wpass':>5} {'util':>5}  top-term  members",
    ]
    shown = 0
    for i in order:
        bd = breakdowns[i]
        bound = "dram" if bd.dram_cycles >= bd.compute_cycles else "compute"
        top = max(bd.energy_terms, key=bd.energy_terms.get) \
            if bd.energy_terms else "-"
        label = ",".join(bd.members[:3]) \
            + ("..." if len(bd.members) > 3 else "")
        lines.append(
            f"{i:>5} {len(bd.members):>3} {bd.energy_pj / total_e * 100:>6.1f}%"
            f" {bd.cycles / total_c * 100:>5.1f}% {bound:>7} "
            f"{bd.tile_rows:>4} {bd.weight_passes:>5} "
            f"{bd.utilization:>5.2f}  {top:<8}  {label}")
        shown += 1
        if max_rows and shown >= max_rows and shown < len(breakdowns):
            rest = len(breakdowns) - shown
            rest_e = sum(breakdowns[j].energy_pj
                         for j in order[shown:]) / total_e * 100
            lines.append(f"  ... ({rest} more groups, {rest_e:.1f}% of "
                         f"energy; --breakdown shows all)")
            break
    return "\n".join(lines)
