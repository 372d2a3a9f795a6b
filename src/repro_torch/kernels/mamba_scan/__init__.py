from repro_torch.kernels.mamba_scan.ops import mamba_scan

__all__ = ["mamba_scan"]
