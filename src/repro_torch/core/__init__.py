"""The paper's GA over fusion-edge bitmasks, ported from ``repro.core``:
graphs, fusion states, the search problem, Alg. 1 and the batched
population engine whose group-label pass runs as a CUDA kernel
(``repro_torch/kernels/ga_labels``)."""
from repro_torch.core.fusion import FusionState
from repro_torch.core.ga import GAConfig, GAResult, run_ga, run_ga_problem
from repro_torch.core.graph import CompiledGraph, Layer, LayerGraph
from repro_torch.core.problem import FusionProblem, SearchProblem

__all__ = ["FusionState", "GAConfig", "GAResult", "run_ga", "run_ga_problem",
           "CompiledGraph", "Layer", "LayerGraph", "FusionProblem",
           "SearchProblem"]
