"""Plain PyTorch RG-LRU: the CPU path and the oracle of the CUDA kernels
(counterparts: ``repro/kernels/rglru_scan/ref.py`` for the scan,
``repro/models/rglru.py:rglru_mix`` for the gate arithmetic)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

C = 8.0     # the reference's c in a = exp(c * r * log(a_hat))


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                   h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a, b: (B, S, W) -> h (B, S, W) in a's dtype, where
    ``h[t] = a[t] * h[t-1] + b[t]`` from ``h[-1] = h0`` (B, W) (zero when
    None), state in fp32."""
    af, bf = a.float(), b.float()
    h = (torch.zeros(a.shape[0], a.shape[2], dtype=torch.float32,
                     device=a.device) if h0 is None else h0.float())
    hs = torch.empty_like(af)
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        hs[:, t] = h
    return hs.to(a.dtype)


def rglru_gates_ref(xa: torch.Tensor, xi: torch.Tensor, xc: torch.Tensor,
                    b_a: torch.Tensor, b_i: torch.Tensor,
                    lam: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan's inputs (a, b), each (B, S, W) fp32, from ``xa = xc @ w_a``,
    ``xi = xc @ w_i`` and ``xc``: the reference's arithmetic, eagerly."""
    r = torch.sigmoid(xa.float() + b_a)
    i = torch.sigmoid(xi.float() + b_i)
    log_a_hat = -F.softplus(lam)
    a = torch.exp(C * r * log_a_hat)                        # B,S,W fp32
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * i * xc.float()
    return a, b


def rglru_gated_ref(xa: torch.Tensor, xi: torch.Tensor, xc: torch.Tensor,
                    b_a: torch.Tensor, b_i: torch.Tensor, lam: torch.Tensor,
                    h0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gated recurrence: (h (B, S, W) in xc's dtype, h_last (B, W)
    fp32, the state after the last step, not rounded)."""
    hs = rglru_scan_ref(*rglru_gates_ref(xa, xi, xc, b_a, b_i, lam), h0)
    return hs.to(xc.dtype), hs[:, -1].clone()
