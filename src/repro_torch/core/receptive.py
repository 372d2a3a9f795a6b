"""Receptive-field backtrace and on-chip footprint of fused groups.

Paper §II-B / Fig. 5: executing a fused group tile-by-tile requires, for every
layer in the group, the *receptive field* of the final output tile.  We follow
the caching (not recompute) policy the paper adopts ("previous works have found
that caching is almost always better"), i.e. Alwani-style line buffers
[Fused-layer CNN accelerators, MICRO'16]: while streaming output row-tiles of
``t`` rows, each intermediate feature map keeps a sliding window of
``rows_l(t)`` rows resident on-chip, and every DRAM input word is read exactly
once.

``rows_l`` is obtained by backtracing from the group's sink layers:

    rows_in = (rows_out - 1) * stride_h + (R - 1) * dilation_h + 1

clamped to the full height.  The activation-buffer footprint of the group at
tile height ``t`` is the sum of live windows over all tensors that stay
on-chip, plus the input/output staging tiles.  The scheduler picks the largest
``t`` that fits (paper: "receptive field sizes that maximally use the
activation buffer").
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Set, Tuple

from repro_torch.core.graph import Layer, LayerGraph


def required_input_rows(layer: Layer, rows_out: int) -> int:
    """Rows of ``layer``'s *input* needed to produce ``rows_out`` output rows."""
    rows_out = min(rows_out, layer.p) if layer.p else rows_out
    if layer.kind in ("conv", "dwconv", "pool"):
        need = (rows_out - 1) * layer.stride[0] + (layer.r - 1) * layer.dilation[0] + 1
        return min(max(need, 1), layer.h) if layer.h else need
    if layer.kind in ("fc", "global_pool"):
        return layer.h if layer.h else 1
    if layer.kind == "upsample":
        return min(max(math.ceil(rows_out * max(layer.h, 1) / max(layer.p, 1)), 1),
                   max(layer.h, 1))
    # add / mul / concat / input: elementwise row-for-row
    return rows_out


def backtrace_rows(graph: LayerGraph, members: Sequence[str], t: int
                   ) -> Dict[str, int]:
    """For each member layer, the number of *output* rows that must be live to
    stream ``t`` output rows of the group's sinks.  Members must be given in
    topological order (any)."""
    mset = set(members)
    rows: Dict[str, int] = {}
    # reverse topological scan: consumers before producers
    for name in reversed(list(members)):
        layer = graph.layers[name]
        inner_consumers = [v for v in graph.succs(name) if v in mset]
        if not inner_consumers:                       # sink of the group
            rows[name] = min(t, layer.p) if layer.p else t
        else:
            need = 1
            for cons in inner_consumers:
                need = max(need, required_input_rows(graph.layers[cons], rows[cons]))
            rows[name] = min(need, layer.p) if layer.p else need
    return rows


def group_footprint_words(graph: LayerGraph, members: Sequence[str], t: int,
                          offchip: Optional[Set[str]] = None) -> int:
    """Activation-buffer words needed to stream the group at tile height ``t``.

    Counts, per member tensor, a live window of ``rows`` x width x channels:
    * intermediate tensors fully consumed on-chip keep their sliding window;
    * group inputs (produced outside) keep the window required by their
      in-group consumers (staged from DRAM or a previous group);
    * tensors that also go off-chip (``offchip``) still occupy their window
      while being produced.
    """
    mset = set(members)
    rows = backtrace_rows(graph, members, t)
    total = 0
    staged: Set[str] = set()
    for name in members:
        layer = graph.layers[name]
        if layer.output_size:
            total += layer.m * layer.q * min(rows[name], layer.p or rows[name])
        # stage external inputs of this member
        for src in graph.preds(name):
            if src in mset or src in staged:
                continue
            staged.add(src)
            src_l = graph.layers[src]
            if not src_l.output_size:
                continue
            win = required_input_rows(layer, rows[name])
            total += src_l.m * src_l.q * min(win, src_l.p or win)
    return total


def max_tile_rows(graph: LayerGraph, members: Sequence[str],
                  act_capacity_words: int) -> int:
    """Largest sink tile height whose footprint fits the activation buffer.
    Returns 0 if even t=1 does not fit (group invalid at this capacity)."""
    sink_p = max((graph.layers[n].p or 1) for n in members)
    if group_footprint_words(graph, members, 1) > act_capacity_words:
        return 0
    lo, hi = 1, max(sink_p, 1)
    while lo < hi:                                    # binary search largest feasible
        mid = (lo + hi + 1) // 2
        if group_footprint_words(graph, members, mid) <= act_capacity_words:
            lo = mid
        else:
            hi = mid - 1
    return lo


def _required_input_extent(layer: Layer, out_ext: int, axis: int) -> int:
    """Axis-generic version of :func:`required_input_rows` (0=rows, 1=cols)."""
    full_in = layer.h if axis == 0 else layer.w
    full_out = layer.p if axis == 0 else layer.q
    k = layer.r if axis == 0 else layer.s
    out_ext = min(out_ext, full_out) if full_out else out_ext
    if layer.kind in ("conv", "dwconv", "pool"):
        need = (out_ext - 1) * layer.stride[axis] + (k - 1) * layer.dilation[axis] + 1
        return min(max(need, 1), full_in) if full_in else need
    if layer.kind in ("fc", "global_pool"):
        return full_in if full_in else 1
    if layer.kind == "upsample":
        return min(max(math.ceil(out_ext * max(full_in, 1) / max(full_out, 1)), 1),
                   max(full_in, 1))
    return out_ext


def _backtrace_axis(graph: LayerGraph, members: Sequence[str], t: int,
                    axis: int) -> Dict[str, int]:
    mset = set(members)
    ext: Dict[str, int] = {}
    for name in reversed(list(members)):
        layer = graph.layers[name]
        full_out = layer.p if axis == 0 else layer.q
        inner = [v for v in graph.succs(name) if v in mset]
        if not inner:
            ext[name] = min(t, full_out) if full_out else t
        else:
            need = 1
            for cons in inner:
                need = max(need, _required_input_extent(
                    graph.layers[cons], ext[cons], axis))
            ext[name] = min(need, full_out) if full_out else need
    return ext


def receptive_field_hw(graph: LayerGraph, members: Sequence[str]) -> Tuple[int, int]:
    """(rows, cols) of group-*input* receptive field for a single output pixel
    of the group's sinks — the quantity plotted in paper Fig. 7."""
    mset = set(members)
    rf = [1, 1]
    for axis in (0, 1):
        ext = _backtrace_axis(graph, members, 1, axis)
        for name in members:
            layer = graph.layers[name]
            if layer.kind == "input":
                continue
            if not any(s in mset for s in graph.preds(name)):
                rf[axis] = max(rf[axis], _required_input_extent(
                    layer, ext[name], axis))
    return rf[0], rf[1]
