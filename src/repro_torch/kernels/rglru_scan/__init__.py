from repro_torch.kernels.rglru_scan.ops import rglru_scan

__all__ = ["rglru_scan"]
