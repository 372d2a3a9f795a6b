"""Plain PyTorch RMSNorm: the CPU path and the oracle of the CUDA kernel
(counterpart: ``repro/kernels/rmsnorm/ref.py``, with the kernel's cast of the
outputs to the input type)."""
from __future__ import annotations

import torch


def rmsnorm_ref(x, w, residual=None, *, eps: float = 1e-6):
    """x: (..., D), w: (D,).  Returns y, or (y, x + residual) when a residual
    is given; y is the norm of the unrounded fp32 sum."""
    s = x.float()
    if residual is not None:
        s = s + residual.float()
    y = s * torch.rsqrt((s * s).mean(-1, keepdim=True) + eps) * w.float()
    if residual is None:
        return y.to(x.dtype)
    return y.to(x.dtype), s.to(x.dtype)
