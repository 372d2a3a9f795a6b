"""Communication (DRAM-traffic) lower bounds for fused schedules (the
port's copy of ``repro/analysis/bounds.py``; the ``tpu`` cost model's
capacity is not ported).

"Communication Lower Bound in Convolution Accelerators" (Chen et al.,
arXiv 1911.05662 / HPCA'20) shows off-chip traffic of a convolution is
bounded below by a red-blue-pebble (Hong-Kung) term ``2 * #MACs /
sqrt(rho * S)`` — ``rho`` the maximal in-window data reuse (R*S for
convolutions, 1 for matmuls), ``S`` the on-chip capacity in words —
combined with a *memory floor*: every operand that crosses the DRAM
boundary moves at least once.  Both terms are computable statically from
the geometry the mapper already holds, which makes them a schedule
*certificate*: for any fused grouping, the modeled DRAM traffic can be
compared against a bound no execution (and no cost model that prices
plausible executions) can beat, giving each artifact an optimality gap
(ROADMAP open item 5(a)).

Two granularities:

* :func:`group_bound` — lower bound for one fused group as the engine
  prices it: the floor counts member weights once, plus the activations
  the group's boundary forces across DRAM (inputs staged from outside,
  outputs consumed outside or by nobody); the Hong-Kung term covers the
  group's aggregate MACs at the group's best window reuse.
* :func:`graph_bound` — schedule-*independent* bound: weights once, model
  sink outputs once, Hong-Kung over the whole graph's MACs.  Any legal
  schedule's traffic is >= this, so ``traffic / graph_bound - 1`` is the
  optimality gap ``repro report`` and ``repro verify`` print.

Soundness notes (why gap >= 0 holds for the in-repo cost models): the
default mapper charges every weight word at least once (re-streams only
add passes), charges a member's full input when any producer is outside
the group, and writes a member's full output when any consumer is outside
— exactly the floor's terms; the TPU roofline's traffic *equals* the
floor per group.  The Hong-Kung term uses the machine's total on-chip
words (a capacity-generous ``S`` can only lower the bound, never break
it).  ``tests/test_analysis_verify.py`` pins gap >= 0 across the
backend/workload/accelerator zoo.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Set, Tuple

from repro_torch.core.graph import Layer, LayerGraph


def window_reuse(layer: Layer) -> int:
    """``rho``: maximal per-word data reuse inside one sliding window.

    Convolutions (dense or depthwise) reuse each input word across the
    R x S filter window; matmuls/elementwise ops have no window reuse.
    """
    if layer.kind in ("conv", "dwconv"):
        return max(layer.r * layer.s, 1)
    return 1


def hk_words(macs: int, reuse: int, onchip_words: int) -> float:
    """The Hong-Kung red-blue-pebble term: ``2 * macs / sqrt(rho * S)``
    words of off-chip traffic (0 when there is no compute or no finite
    capacity to pebble against)."""
    if macs <= 0 or onchip_words <= 0:
        return 0.0
    return 2.0 * macs / math.sqrt(max(reuse, 1) * onchip_words)


def _costed(layer: Layer) -> bool:
    """Whether the cost models charge this node at all (graph ``input``
    placeholders are free: their tensor is charged at the consumer)."""
    return not (layer.macs == 0 and layer.kind == "input")


@dataclass(frozen=True)
class TrafficBound:
    """A DRAM-traffic lower bound: ``max(memory floor, Hong-Kung)``.

    ``floor_words`` decomposes into weights read once plus boundary
    activations moved once; ``hk_words`` is the pebbling term.
    """

    floor_words: int
    hk_words: float
    macs: int
    reuse: int
    onchip_words: int

    @property
    def words(self) -> int:
        return max(self.floor_words, math.ceil(self.hk_words))


def group_bound(graph: LayerGraph, members: Sequence[str],
                onchip_words: int) -> TrafficBound:
    """Lower bound on the DRAM traffic of executing ``members`` as one
    fused group (see module docstring for the floor's terms)."""
    mset: Set[str] = set(members)
    floor = 0
    macs = 0
    reuse = 1
    for name in members:
        layer = graph.layers[name]
        if not _costed(layer):
            continue
        floor += layer.weight_size                     # read >= once
        preds = graph.preds(name)
        if not preds or any(p not in mset for p in preds):
            floor += layer.input_size                  # staged from DRAM
        succs = graph.succs(name)
        if (not succs or any(v not in mset for v in succs)) \
                and layer.output_size:
            floor += layer.output_size                 # stored to DRAM
        macs += layer.macs
        if layer.macs:
            reuse = max(reuse, window_reuse(layer))
    return TrafficBound(floor_words=floor,
                        hk_words=hk_words(macs, reuse, onchip_words),
                        macs=macs, reuse=reuse, onchip_words=onchip_words)


def schedule_bound(graph: LayerGraph, groups: Sequence[Sequence[str]],
                   onchip_words: int
                   ) -> Tuple[List[TrafficBound], int]:
    """Per-group bounds for one concrete grouping, plus their sum — the
    lower bound on this *schedule's* DRAM traffic."""
    per_group = [group_bound(graph, g, onchip_words) for g in groups]
    return per_group, sum(b.words for b in per_group)


def graph_bound(graph: LayerGraph, onchip_words: int) -> TrafficBound:
    """Schedule-independent lower bound: whatever the grouping, weights
    are read at least once, sink outputs are written at least once, and
    the Hong-Kung term covers the total compute."""
    floor = 0
    macs = 0
    reuse = 1
    for name, layer in graph.layers.items():
        if not _costed(layer):
            continue
        floor += layer.weight_size
        if not graph.succs(name) and layer.output_size:
            floor += layer.output_size
        macs += layer.macs
        if layer.macs:
            reuse = max(reuse, window_reuse(layer))
    return TrafficBound(floor_words=floor,
                        hk_words=hk_words(macs, reuse, onchip_words),
                        macs=macs, reuse=reuse, onchip_words=onchip_words)


def onchip_words_for(costmodel: str, accelerator: str) -> Optional[int]:
    """The on-chip capacity ``S`` (words) the bound should pebble against
    for a given cost backend, or None when the backend's DRAM semantics
    are unknown to this module (no certificate is sounder than a wrong
    one).

    * ``default`` — the paper's mini-Timeloop mapper: activation +
      weight SRAM of the named machine (repartition suffixes honored);
    * ``tpu`` — the reference's TPU roofline (its VMEM activation budget):
      not ported, so an artifact of it raises
      :class:`~repro_torch.search.registry.RegistryError` here.
    """
    if costmodel == "default":
        from repro_torch.search.registry import build_accelerator
        acc = build_accelerator(accelerator)
        return acc.act_buf_words + acc.weight_buf_words
    if costmodel == "tpu":
        from repro_torch.search.registry import RegistryError
        raise RegistryError(
            "the tpu cost model is not ported to repro_torch yet (ROADMAP "
            "A2); verify its artifacts with the reference (python -m repro "
            "verify)")
    return None
