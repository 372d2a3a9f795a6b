"""Warm-starting searches from the store's nearest cached winner.

The daemon's core cost is GA convergence time; most of its traffic is the
same handful of workloads re-searched under slightly different specs (a
new seed, a different backend budget, ``name@k=v`` parameter sweeps).
When a cache miss is *near* a stored artifact, seeding the GA's initial
population with the cached winner's genome gives the search a head start
— the paper's Alg. 1 keeps its canonical layerwise start, the seed just
joins the first generation's pool (``SearchProblem.seed_genomes``).

Donor ranking, most to least compatible:

1. **same graph fingerprint** — the genome re-binds exactly (the spec
   differs in seed/backend/objective only);
2. **same workload family** — the registry base name before ``@`` params
   matches, with the same accelerator + cost model + objective; the donor
   genome is clipped onto the new graph's edge range (a heuristic: bits
   past the new edge count are dropped, an invalid result just scores 0
   and is selected away).

Everything here is *opt-in per job* (``warm_start=True`` on POST /jobs):
the default path never reads this module, so fixed-seed trajectories,
RNG draw sequences, and store keys stay bit-identical.  Warm-starting
also never changes the job's store key — the spec is untouched; only the
initial population differs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.search.spec import SearchSpec
from repro_torch.serve.store import ArtifactStore, StoreError


@dataclass(frozen=True)
class WarmStartSeed:
    """A donor genome chosen for seeding, with its provenance."""

    donor_key: str          # store key of the donor artifact
    mask: int               # donor winner's genome bitmask
    exact: bool             # same graph fingerprint (mask re-binds exactly)
    best_fitness: float     # donor's recorded fitness (ranking evidence)


def workload_family(workload: str) -> str:
    """The registry base name before inline ``@k=v`` params; ``file:`` /
    ``ir:`` specs have no name family (their fingerprint is the family)."""
    if workload.startswith(("file:", "ir:")):
        return workload
    return workload.split("@", 1)[0]


def adapt_mask(mask: int, n_edges: int) -> int:
    """Clip a donor genome onto a graph with ``n_edges`` fusion edges.
    Bits past the target range are dropped; the result may be invalid on
    the new graph, in which case it scores 0 and is selected away."""
    if n_edges <= 0:
        return 0
    return mask & ((1 << n_edges) - 1)


def find_warm_start(store: ArtifactStore, fingerprint: str,
                    spec: SearchSpec) -> Optional[WarmStartSeed]:
    """Scan the store for the nearest donor artifact (see module
    docstring), or None.  Corrupt objects are skipped, never fatal.  The
    scan is deterministic: candidates are ranked (compatibility, donor
    fitness desc, key asc), so the same store always yields the same
    donor."""
    family = workload_family(spec.workload)
    named = not spec.workload.startswith(("file:", "ir:"))
    ranked: List[Tuple[int, float, str, int]] = []
    for key in store.keys():
        try:
            art = store.load_key(key)
        except StoreError:
            continue                     # GC reports these; seeding skips
        if art is None:
            continue
        if art.graph_fingerprint == fingerprint:
            rank = 0
        elif (named
              and workload_family(art.spec.workload) == family
              and art.spec.accelerator == spec.accelerator
              and art.spec.costmodel == spec.costmodel
              and art.spec.objective == spec.objective):
            rank = 1
        else:
            continue
        ranked.append((rank, -float(art.best_fitness), key,
                       int(art.genome_mask)))
    if not ranked:
        return None
    rank, neg_fit, key, mask = min(ranked)
    return WarmStartSeed(donor_key=key, mask=mask, exact=(rank == 0),
                         best_fitness=-neg_fit)
