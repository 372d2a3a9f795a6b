"""Hand-written CUDA kernels of the port, one subpackage per kernel.

Each subpackage holds ``ops.py`` (the wrapper: checks, launch, launch count)
and ``ref.py`` (the plain PyTorch version the CPU path and the checks use);
the CUDA sources are in ``repro_torch/csrc``.
"""
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.ga_labels.ops import ga_labels
from repro_torch.kernels.mamba_scan.ops import mamba_scan
from repro_torch.kernels.rglru_scan.ops import rglru_scan
from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm

__all__ = ["flash_attention", "fused_rmsnorm", "ga_labels", "mamba_scan",
           "rglru_scan"]
