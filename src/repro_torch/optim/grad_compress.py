"""Error-feedback gradient compression (int8, one scale a tensor).

Counterpart: ``repro/optim/grad_compress.py``.  The reference compresses
before the cross-pod all-reduce and keeps the quantisation residual locally
(error feedback, Seide et al. 2014 / EF-SGD), so the scheme is unbiased over
time.  On one card there is no all-reduce: the port applies the same
quantise -> dequantise with the same residual, so a run's numbers are the
reference's.  ``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch


def ef_state_init(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compress_decompress_ef(grads: Mapping[str, torch.Tensor],
                           ef_state: Mapping[str, torch.Tensor]):
    """Error-feedback int8 quantisation of each gradient.  Returns
    (decompressed grads in each gradient's dtype, new residuals fp32)."""
    deq, new_ef = {}, {}
    for name, g in grads.items():
        g32 = g.float() + ef_state[name]
        q, scale = _quantize(g32)
        d = q.float() * scale
        deq[name] = d.to(g.dtype)
        new_ef[name] = g32 - d
    return deq, new_ef
