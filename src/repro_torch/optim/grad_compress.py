"""Error-feedback gradient compression (int8, one scale a tensor).

Counterpart: ``repro/optim/grad_compress.py``.  The reference compresses
before the cross-pod all-reduce and keeps the quantisation residual locally
(error feedback, Seide et al. 2014 / EF-SGD), so the scheme is unbiased over
time.  On one card there is no all-reduce: the port applies the same
quantise -> dequantise with the same residual, so a run's numbers are the
reference's.  ``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.optim.adamw import _local, mesh_reduce


def ef_state_init(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros_like(p, dtype=torch.float32)
            if isinstance(p, DTensor) else
            torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def _quantize(x: torch.Tensor, amax: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 x and its scale; ``amax``: the largest magnitude of the tensor
    x is a shard of (default: x's own)."""
    amax = x.abs().max() if amax is None else amax
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _like(local: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    if not isinstance(t, DTensor):
        return local
    return DTensor.from_local(local, t.device_mesh, t.placements,
                              run_check=False)


@torch.no_grad()
def compress_decompress_ef(grads: Mapping[str, torch.Tensor],
                           ef_state: Mapping[str, torch.Tensor]):
    """Error-feedback int8 quantisation of each gradient.  Returns
    (decompressed grads in each gradient's dtype, new residuals fp32).  On
    a mesh each rank quantises its shard, with the tensor's scale (its
    largest magnitude over every rank that holds a part of it)."""
    g32 = {n: _local(g).float() + _local(ef_state[n])
           for n, g in grads.items()}
    amax = mesh_reduce({n: x.abs().max() for n, x in g32.items()}, grads,
                       op="max")
    deq, new_ef = {}, {}
    for name, g in grads.items():
        q, scale = _quantize(g32[name], amax[name])
        d = q.float() * scale
        deq[name] = _like(d.to(g.dtype), g)
        new_ef[name] = _like(g32[name] - d, g)
    return deq, new_ef
