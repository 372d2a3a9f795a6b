"""AdamW on dicts of tensors keyed like a model's ``state_dict``, with
dtype-configurable moments.

Counterpart: ``repro/optim/adamw.py``, the same arithmetic: the update is
computed in fp32, gradients are clipped by their global norm, both moments
are bias-corrected with ``b ** step``, weight decay applies to the tensors
whose reference leaf has two or more dims, the moments are stored in
``moment_dtype`` and the params cast back to their own dtype.  Not
``torch.optim.AdamW``: its decay, moment dtype and step bookkeeping differ.

The reference returns new pytrees (its train step donates the old buffers);
here ``adamw_update`` writes the params and the moments in place, under
``torch.no_grad()``, a slice of at most ``CHUNK`` elements at a time, so the
fp32 temporaries of a large embedding stay small (every step of the update
after the global norm is elementwise, so slicing changes no result).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Mapping, Optional

import torch

from repro_torch.models.common import dtype_of

#: elements a slice of a tensor the update reads and writes at once
CHUNK = 1 << 24


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"


def adamw_init(params: Mapping[str, torch.Tensor], cfg: AdamWConfig) -> Dict:
    """``{"mu", "nu"}``: zeros like each param in ``moment_dtype``;
    ``"step"``: an int32 0-d tensor on the params' device."""
    dt = dtype_of(cfg.moment_dtype)
    device = next(iter(params.values())).device if params else None
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"mu": {n: zeros(p) for n, p in params.items()},
            "nu": {n: zeros(p) for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _chunks(t: torch.Tensor) -> Iterator[torch.Tensor]:
    flat = t.view(-1)
    for i in range(0, flat.numel(), CHUNK):
        yield flat[i:i + CHUNK]


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32 (0-d): each
    tensor's norm reduced in fp32 without an fp32 copy, squared, summed."""
    total = torch.zeros(())
    for t in tree.values():
        total = total.to(t.device) + torch.linalg.vector_norm(
            t, dtype=torch.float32).square()
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: Dict,
                 cfg: AdamWConfig, lr_scale=1.0, *,
                 decay: Optional[Mapping[str, bool]] = None):
    """One step; returns (params, state, metrics), ``params`` and the
    moments of ``state`` updated in place and ``state["step"]`` replaced.

    ``decay[name]``: whether weight decay applies to that tensor; default
    ``ndim >= 2``.  The reference's rule is ``ndim >= 2`` on its own
    leaves, which stack a segment's layers on a leading axis, so a model's
    per-layer vectors (norm scales, biases) decay there: the train step
    passes ``repro_torch.convert.decayed(model)``.  Metrics: ``grad_norm``
    (the global norm before clipping, a 0-d tensor: no host sync) and
    ``lr``."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    if cfg.grad_clip > 0:
        clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                           max=1.0)
    else:
        clip = 1.0
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.tensor(b1, dtype=torch.float32,
                            device=stepf.device) ** stepf
    c2 = 1.0 - torch.tensor(b2, dtype=torch.float32,
                            device=stepf.device) ** stepf
    lr = cfg.lr * lr_scale
    for name, p in params.items():
        wd = cfg.weight_decay > 0 and (
            p.ndim >= 2 if decay is None else decay[name])
        for pc, gc, muc, nuc in zip(_chunks(p), _chunks(grads[name]),
                                    _chunks(state["mu"][name]),
                                    _chunks(state["nu"][name])):
            g = gc.float() * clip
            mu32 = b1 * muc.float() + (1 - b1) * g
            nu32 = b2 * nuc.float() + (1 - b2) * g * g
            mhat = mu32 / c1
            nhat = nu32 / c2
            delta = mhat / (torch.sqrt(nhat) + cfg.eps)
            p32 = pc.float()
            if wd:                                  # decay matrices only
                delta = delta + cfg.weight_decay * p32
            pc.copy_(p32 - lr * delta)
            muc.copy_(mu32)
            nuc.copy_(nu32)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
