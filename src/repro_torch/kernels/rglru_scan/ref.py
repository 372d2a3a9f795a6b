"""Plain PyTorch RG-LRU: the CPU path and the oracle of the CUDA kernels
(counterparts: ``repro/kernels/rglru_scan/ref.py`` for the scan,
``repro/models/rglru.py:rglru_mix`` for the gate arithmetic)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

C = 8.0     # the reference's c in a = exp(c * r * log(a_hat))
# How far kept states may sit from the plain recurrence's: the RG-LRU's
# fp32 state tolerance (the reference's 2e-5 x 5, tests/test_kernels.py),
# absolute and relative; the kernel folds its tiles in another order and
# takes its sigmoids from the special-function unit.
STATES_TOL = 1e-4


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


def rglru_states_ref(xa: torch.Tensor, xi: torch.Tensor, xc: torch.Tensor,
                     b_a: torch.Tensor, b_i: torch.Tensor, lam: torch.Tensor,
                     h0: Optional[torch.Tensor], every: int) -> torch.Tensor:
    """The fp32 state entering steps 0, every, 2 every, ...: (B, ceil(S /
    every), W), h0 (zero when None) first: what the gated forward keeps for
    its backward."""
    B, S, W = xc.shape
    hs = rglru_scan_ref(*rglru_gates_ref(xa, xi, xc, b_a, b_i, lam), h0)
    first = (torch.zeros(B, W, dtype=torch.float32, device=xc.device)
             if h0 is None else h0.float())
    return torch.cat([first[:, None], hs[:, every - 1:S - 1:every]], 1)


def rglru_gated_bwd_ref(xa: torch.Tensor, xi: torch.Tensor, xc: torch.Tensor,
                        b_a: torch.Tensor, b_i: torch.Tensor,
                        lam: torch.Tensor, h0: Optional[torch.Tensor],
                        dh: torch.Tensor,
                        dh_last: Optional[torch.Tensor] = None,
                        states: Optional[torch.Tensor] = None,
                        every: int = 0) -> Tuple[torch.Tensor, ...]:
    """The gradients of :func:`rglru_gated_ref` by the explicit reverse
    recurrence, in fp32: (dxa, dxi, dxc in xc's dtype; db_a, db_i, dlam
    (W,) fp32, summed over (B, S); dh0 (B, W) fp32, or None when h0 is
    None), for the gradients dh (B, S, W) of h and dh_last (B, W) of h_last
    (None: zero).

    g[t] = dh[t] + a[t+1] g[t+1], with dh_last added to g[S-1]; then
    da[t] = g[t] h[t-1] and db[t] = g[t], and the chain rule through
    ``b = sqrt(max(1 - a^2, 1e-12)) i xc``, ``a = exp(8 r log_a_hat)``, the
    two sigmoids and ``log_a_hat = -softplus(lam)``.  Where the clamp holds,
    nothing flows through the square root (as through ``jnp.maximum``).
    ``states`` (the forward's state entering every ``every``-th step, as the
    kernel reads them): held to this recurrence's own within STATES_TOL, a
    ValueError if they are not; the gradients come from its own."""
    B, S, W = xc.shape
    xcf = xc.float()
    r = torch.sigmoid(xa.float() + b_a)
    i = torch.sigmoid(xi.float() + b_i)
    k = C * -F.softplus(lam)                      # a = exp(k r)
    a = torch.exp(k * r)
    y = 1.0 - a * a
    s = torch.sqrt(torch.clamp(y, min=1e-12))
    b = s * i * xcf
    h_prev = torch.empty_like(a)                  # h[t-1]
    h = (torch.zeros(B, W, dtype=torch.float32, device=xc.device)
         if h0 is None else h0.float())
    for t in range(S):
        h_prev[:, t] = h
        h = a[:, t] * h + b[:, t]
    if states is not None and not torch.allclose(
            states, h_prev[:, ::every], rtol=STATES_TOL, atol=STATES_TOL):
        err = (states - h_prev[:, ::every]).abs().max().item()
        raise ValueError(f"rglru_gated_bwd_ref: the states are not the "
                         f"forward's (max abs difference {err:.3e})")
    g = torch.empty_like(a)
    carry = (torch.zeros(B, W, dtype=torch.float32, device=xc.device)
             if dh_last is None else dh_last.float())
    dhf = dh.float()
    for t in range(S - 1, -1, -1):
        gt = dhf[:, t] + carry
        g[:, t] = gt
        carry = a[:, t] * gt
    d_a = g * h_prev
    ds = g * i * xcf
    dxc = g * s * i
    di = g * s * xcf
    d_a = d_a + torch.where(y > 1e-12, ds * 0.5 / s, 0.0) * (-2.0 * a)
    dkr = d_a * a                                 # d(k r)
    dra = dkr * k * r * (1.0 - r)                 # d(xa + b_a)
    dri = di * i * (1.0 - i)                      # d(xi + b_i)
    dlam = (dkr * r).sum((0, 1)) * C * -torch.sigmoid(lam)
    return (dra.to(xc.dtype), dri.to(xc.dtype), dxc.to(xc.dtype),
            dra.sum((0, 1)), dri.sum((0, 1)), dlam,
            None if h0 is None else carry)
