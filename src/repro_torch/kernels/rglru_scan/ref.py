"""Plain PyTorch RG-LRU scan: the CPU path and the oracle of the CUDA kernel
(counterpart: ``repro/kernels/rglru_scan/ref.py``)."""
from __future__ import annotations

import torch


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, W) -> h (B, S, W) in a's dtype, where
    ``h[t] = a[t] * h[t-1] + b[t]`` from ``h[-1] = 0``, state in fp32."""
    af, bf = a.float(), b.float()
    h = torch.zeros(a.shape[0], a.shape[2], dtype=torch.float32,
                    device=a.device)
    hs = torch.empty_like(af)
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        hs[:, t] = h
    return hs.to(a.dtype)
