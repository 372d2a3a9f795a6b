"""Plain PyTorch group labels of the GA's population engine: the CPU path
and the oracle of the CUDA kernel (counterpart: the reference's
``repro/core/population.py:PopulationEvaluator._labels_np``)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class LabelTables(NamedTuple):
    """A graph's static edge tables, int32 on one device (made once per
    graph): chain edge k is ``chain_nodes[k] -> chain_nodes[k] + 1`` with
    edge id ``chain_eids[k]``; extra (non-chain) edge k is ``xu[k] ->
    xv[k]`` with id ``extra_eids[k]``; ``chain_into[i]`` is the id of the
    chain edge into node i, -1 where there is none (the same chain edges
    by node, as the CUDA kernel's warp variant reads them)."""
    n: int
    m: int
    chain_nodes: torch.Tensor
    chain_eids: torch.Tensor
    extra_eids: torch.Tensor
    xu: torch.Tensor
    xv: torch.Tensor
    chain_into: torch.Tensor


def label_tables(eu, ev, n: int, device) -> LabelTables:
    """The tables of a graph with ``n`` nodes and edges ``eu[i] -> ev[i]``
    (node ids topological, edge ids in the compiled edge order)."""
    eu = np.asarray(eu, dtype=np.int64)
    ev = np.asarray(ev, dtype=np.int64)
    chain = ev == eu + 1

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                               device=device)

    into = np.full(n, -1, dtype=np.int64)
    into[eu[chain] + 1] = np.nonzero(chain)[0]
    return LabelTables(n, len(eu), dev(eu[chain]), dev(np.nonzero(chain)[0]),
                       dev(np.nonzero(~chain)[0]), dev(eu[~chain]),
                       dev(ev[~chain]), dev(into))


def ga_labels_ref(bits: torch.Tensor, t: LabelTables) -> torch.Tensor:
    """bits (P, m) uint8 (0/1) -> (P, n) int64: each node's group label, as
    the reference's numpy engine computes it: runs of fused chain edges by a
    cummax of run starts, then, while a fused extra edge has two labels at
    its ends, hook both to their minimum and jump once; then jump to the
    fixpoint.  (That is each group's minimum member wherever no hook lands
    on a label that is no longer a root; the CUDA kernel follows the same
    rounds, so both give the reference's labels either way.)"""
    p, n = bits.shape[0], t.n
    dev = bits.device
    fused = bits.bool()
    newrun = torch.ones((p, n), dtype=torch.bool, device=dev)
    newrun[:, t.chain_nodes.long() + 1] = ~fused[:, t.chain_eids.long()]
    ar = torch.arange(n, device=dev)
    lab = torch.where(newrun, ar, 0).cummax(dim=1).values
    if t.extra_eids.numel():
        pi, j = torch.nonzero(fused[:, t.extra_eids.long()], as_tuple=True)
        if pi.numel():
            lf = lab.reshape(-1)
            base = pi * n
            iu = base + t.xu.long()[j]
            iv = base + t.xv.long()[j]
            rowbase = torch.arange(p, device=dev).repeat_interleave(n) * n
            while True:
                a = lf[iu]
                b = lf[iv]
                if torch.equal(a, b):
                    break
                mn = torch.minimum(a, b)
                lf = lf.scatter_reduce(0, base + a, mn, "amin")
                lf = lf.scatter_reduce(0, base + b, mn, "amin")
                lf = lf[rowbase + lf]
            lab = lf.view(p, n)
    while True:                               # compress to fixpoint
        nxt = torch.gather(lab, 1, lab)
        if torch.equal(nxt, lab):
            return lab
        lab = nxt
