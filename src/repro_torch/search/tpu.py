"""The TPU scheduling retarget as a :class:`SearchProblem` (beyond-paper).

The port's copy of ``repro/search/tpu.py``.  The genome
(:class:`repro_torch.costmodel.tpu_model.TpuSchedule`:
remat policy x microbatch count x gradient compression x sharding mode) is
expressed through the shared problem protocol over the analytical roofline
evaluator, so every backend in ``repro_torch.search.backends`` — GA,
random, hill-climb, and (the space is only 60 schedules) exhaustive —
applies unchanged.  Host-only: no kernel runs on this path.

Candidates whose HBM residency exceeds capacity are invalid (fitness 0),
exactly like the paper's activation-buffer capacity check; FSDP sharding is
invalid for MoE configs (expert parallelism needs the model axis).
"""
from __future__ import annotations

import itertools
import random
from typing import Dict, Iterator, List, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.ga import GAConfig
from repro_torch.core.problem import SearchProblem
from repro_torch.core.tpu_ga import TpuGAResult
from repro_torch.costmodel.tpu_model import (MICROBATCH_OPTIONS,
                                             REMAT_OPTIONS,
                                             SHARDING_OPTIONS, TpuCost,
                                             TpuSchedule, estimate)
from repro_torch.roofline.analysis import HW

from repro_torch.search.backends import Observer
from repro_torch.search.registry import BACKENDS


class TpuScheduleProblem(SearchProblem):
    """TPU training-schedule genomes scored by the roofline cost model."""

    name = "tpu_schedule"

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, *,
                 chips: int = 256, data_par: int = 16, model_par: int = 16,
                 hw: HW = HW(), objective: str = "edp",
                 hbm_capacity: Optional[float] = None):
        self.cfg = cfg
        self.shape = shape
        self.chips = chips
        self.data_par = data_par
        self.model_par = model_par
        self.hw = hw
        self.objective = objective
        self.hbm_capacity = hbm_capacity or hw.hbm_bytes
        self._cache: Dict[TpuSchedule, Optional[TpuCost]] = {}
        self.baseline = TpuSchedule()          # paper-faithful start
        # baseline cost is reported unchecked (it may well not fit HBM —
        # that is the point of the search); its *fitness* still goes
        # through the capacity check like everyone else's
        self.baseline_cost = estimate(cfg, shape, self.baseline, chips=chips,
                                      data_par=data_par, model_par=model_par,
                                      hw=hw)

    # ---- cost model ------------------------------------------------------------
    def cost_of(self, s: TpuSchedule) -> Optional[TpuCost]:
        """Memoized cost; None = invalid (over-capacity or unsupported)."""
        if s not in self._cache:
            if s.sharding == "fsdp" and self.cfg.n_experts:
                self._cache[s] = None  # EP needs the model axis (unsupported)
            else:
                c = estimate(self.cfg, self.shape, s, chips=self.chips,
                             data_par=self.data_par,
                             model_par=self.model_par, hw=self.hw)
                self._cache[s] = \
                    None if c.hbm_resident_bytes > self.hbm_capacity else c
        return self._cache[s]

    def _metric(self, c: TpuCost) -> float:
        return c.edp if self.objective == "edp" else c.step_s

    # ---- problem protocol ------------------------------------------------------
    def initial(self) -> TpuSchedule:
        return self.baseline

    def mutate(self, genome: TpuSchedule, rng: random.Random) -> TpuSchedule:
        opts = genome.mutate_options()
        return opts[rng.randrange(len(opts))]

    def fitness(self, genome: TpuSchedule) -> float:
        c = self.cost_of(genome)
        if c is None:
            return 0.0
        return self._metric(self.baseline_cost) / self._metric(c)

    def key(self, genome: TpuSchedule) -> TpuSchedule:
        return genome                          # frozen dataclass: hashable

    def neighbors(self, genome: TpuSchedule) -> List[TpuSchedule]:
        return genome.mutate_options()

    def random_genome(self, rng: random.Random) -> TpuSchedule:
        return TpuSchedule(
            remat=rng.choice(REMAT_OPTIONS),
            microbatches=rng.choice(MICROBATCH_OPTIONS),
            grad_compression=rng.random() < 0.5,
            sharding=rng.choice(SHARDING_OPTIONS))

    def enumerate(self) -> Iterator[TpuSchedule]:
        for remat, mb, gc, sh in itertools.product(
                REMAT_OPTIONS, MICROBATCH_OPTIONS, (False, True),
                SHARDING_OPTIONS):
            yield TpuSchedule(remat, mb, gc, sh)

    def space_size(self) -> int:
        return (len(REMAT_OPTIONS) * len(MICROBATCH_OPTIONS) * 2
                * len(SHARDING_OPTIONS))


def search_tpu_schedule(cfg: ModelConfig, shape: ShapeConfig, *,
                        chips: int = 256, data_par: int = 16,
                        model_par: int = 16, hw: HW = HW(),
                        objective: str = "edp", backend: str = "ga",
                        ga: GAConfig = GAConfig.fast(generations=30),
                        backend_config: Optional[dict] = None,
                        hbm_capacity: Optional[float] = None,
                        observer: Optional[Observer] = None) -> TpuGAResult:
    """Search remat/microbatch/compression/sharding for one (arch x shape)
    cell with any registered backend (``ga`` uses ``ga`` as its config)."""
    problem = TpuScheduleProblem(
        cfg, shape, chips=chips, data_par=data_par, model_par=model_par,
        hw=hw, objective=objective, hbm_capacity=hbm_capacity)
    config = dict(backend_config or {})
    if backend == "ga" and not config:
        # the ga= GAConfig is the default; explicit backend_config keys
        # (preset/generations/... or a caller-built ga_config) win instead
        config["ga_config"] = ga
    result = BACKENDS.get(backend)().run(
        problem, seed=ga.seed, observer=observer, **config)
    best_cost = problem.cost_of(result.best_state)
    assert best_cost is not None, "search returned an invalid best schedule"
    return TpuGAResult(best=result.best_state, best_cost=best_cost,
                       baseline=problem.baseline,
                       baseline_cost=problem.baseline_cost,
                       history=list(result.history),
                       evaluations=len(problem._cache))
