from repro_torch.kernels.rglru_scan.ops import rglru_gated, rglru_scan

__all__ = ["rglru_gated", "rglru_scan"]
