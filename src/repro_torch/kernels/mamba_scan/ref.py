"""Plain PyTorch selective scan: the CPU path and the oracle of the CUDA
kernel (counterpart: ``repro/kernels/mamba_scan/ref.py``, which also returns
the final state here)."""
from __future__ import annotations

from typing import Tuple

import torch


def mamba_scan_ref(da: torch.Tensor, dbx: torch.Tensor,
                   c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """da, dbx: (B, S, Di, N); c: (B, S, N) -> (y (B, S, Di) in da's dtype,
    h_last (B, Di, N) fp32), where ``h[t] = da[t] * h[t-1] + dbx[t]`` from
    ``h[-1] = 0`` and ``y[t, d] = sum_n h[t, d, n] * c[t, n]``, all in fp32."""
    B, S, Di, N = da.shape
    daf, dbxf, cf = da.float(), dbx.float(), c.float()
    h = torch.zeros(B, Di, N, dtype=torch.float32, device=da.device)
    y = torch.empty(B, S, Di, dtype=torch.float32, device=da.device)
    for t in range(S):
        h = daf[:, t] * h + dbxf[:, t]
        y[:, t] = (h * cf[:, t, None, :]).sum(-1)
    return y.to(da.dtype), h
