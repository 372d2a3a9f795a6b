"""Plain PyTorch selective scan: the CPU path and the oracle of the CUDA
kernel (counterpart: ``repro/kernels/mamba_scan/ref.py``, which also returns
the final state here)."""
from __future__ import annotations

from typing import Optional, Tuple

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


def mamba_scan_bwd_ref(da: torch.Tensor, dbx: torch.Tensor, c: torch.Tensor,
                       dy: torch.Tensor,
                       dh_last: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients of :func:`mamba_scan_ref` by the explicit reverse
    recurrence, in fp32: (dda, ddbx (B, S, Di, N), dc (B, S, N)) for dy
    (B, S, Di) and dh_last (B, Di, N) (None: zero).

    g[t] = dy[t] (x) c[t] + da[t+1] g[t+1], with dh_last added to g[S-1];
    then dda[t] = g[t] h[t-1], ddbx[t] = g[t] and
    dc[t, n] = sum_d dy[t, d] h[t, d, n], summed in fp64."""
    B, S, Di, N = da.shape
    daf, dbxf, cf, dyf = da.float(), dbx.float(), c.float(), dy.float()
    hs = torch.empty(B, S, Di, N, dtype=torch.float32, device=da.device)
    h = torch.zeros(B, Di, N, dtype=torch.float32, device=da.device)
    for t in range(S):
        h = daf[:, t] * h + dbxf[:, t]
        hs[:, t] = h
    # fp64 sums over Di (8192 terms at falcon-mamba-7b): an fp32 chain of
    # them, cancelling, drifts past fp32's TOL; the kernel sums in a tree
    dc = torch.einsum("bsd,bsdn->bsn", dyf.double(), hs.double()).float()
    ddbx, dda = torch.empty_like(hs), torch.zeros_like(hs)
    carry = (torch.zeros(B, Di, N, dtype=torch.float32, device=da.device)
             if dh_last is None else dh_last.float())
    for t in range(S - 1, -1, -1):
        g = dyf[:, t, :, None] * cf[:, t, None, :] + carry
        ddbx[:, t] = g
        if t:
            dda[:, t] = g * hs[:, t - 1]
        carry = daf[:, t] * g
    return dda, ddbx, dc
