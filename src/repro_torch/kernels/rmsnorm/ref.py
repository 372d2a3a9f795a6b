"""Plain PyTorch RMSNorm: the CPU path and the oracle of the CUDA kernel
(counterpart: ``repro/kernels/rmsnorm/ref.py``, with the kernel's cast of the
outputs to the input type), and the oracle of its backward kernel."""
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


def rmsnorm_bwd_ref(x, w, dy, *, eps: float = 1e-6):
    """The plain form's backward (the oracle of ``csrc/rmsnorm.cu:
    rmsnorm_bwd``): x, dy (..., D), w (D,) -> (dx like x, dw like w).  With
    rstd = rsqrt(mean(x^2) + eps), xhat = x * rstd and g = dy * w in fp32:
    dx = rstd * (g - xhat * mean(g * xhat)), dw = sum over rows of
    dy * xhat, its fp32 terms summed in fp64 as the kernel sums them (in
    fp32 a sum of 8192 rows rounds beyond fp32's tolerance where terms
    cancel, whatever the order)."""
    xf, dyf = x.float(), dy.float()
    rstd = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    xhat = xf * rstd
    g = dyf * w.float()
    dx = rstd * (g - xhat * (g * xhat).mean(-1, keepdim=True))
    dw = (dyf * xhat).reshape(-1, x.shape[-1]).double().sum(0)
    return dx.to(x.dtype), dw.float().to(w.dtype)
