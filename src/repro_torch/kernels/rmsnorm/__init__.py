from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm

__all__ = ["fused_rmsnorm"]
