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

On a mesh the params, grads and moments are DTensors of one placement each
(the train step brings every gradient to its parameter's): the update runs
on the local shards, sliced there, and the global norm counts every
element once (``global_norm``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Mapping, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

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

    def zeros(p):
        if isinstance(p, DTensor):
            return torch.zeros_like(p, dtype=dt)
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"mu": {n: zeros(p) for n, p in params.items()},
            "nu": {n: zeros(p) for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _chunks(t: torch.Tensor) -> Iterator[torch.Tensor]:
    """Slices of t's elements (of a DTensor's local shard)."""
    t = _local(t)
    flat = t.view(-1) if t.is_contiguous() else t.reshape(-1)
    for i in range(0, flat.numel(), CHUNK):
        yield flat[i:i + CHUNK]


def mesh_reduce(values: Dict[str, torch.Tensor],
                like: Mapping[str, torch.Tensor], op: str = "sum"
                ) -> Dict[str, torch.Tensor]:
    """Each 0-d local value of a DTensor ``like[name]`` reduced (``op``:
    sum or max) over the mesh dims that split its tensor, so that every
    element counts once; the values of plain tensors as they are.  One
    collective for the values of each placement."""
    groups: Dict = {}
    for name, val in values.items():
        t = like[name]
        if isinstance(t, DTensor):
            key = (id(t.device_mesh), tuple(t.placements))
            groups.setdefault(key, (t, []))[1].append(name)
    out = dict(values)
    for t, names in groups.values():
        pending = [Partial(op) if p.is_shard() else Replicate()
                   for p in t.placements]
        vec = torch.stack([values[n] for n in names])
        vec = DTensor.from_local(vec, t.device_mesh, pending,
                                 run_check=False).full_tensor()
        out.update(zip(names, vec.unbind(0)))
    return out


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32 (0-d): each
    tensor's norm reduced in fp32 without an fp32 copy, squared, summed in
    the tree's order.  A DTensor's square is summed over the ranks that
    split it (``mesh_reduce``) before it joins the sum."""
    squares = {n: torch.linalg.vector_norm(_local(t), dtype=torch.float32
                                           ).square()
               for n, t in tree.items()}
    squares = mesh_reduce(squares, tree)
    total = torch.zeros(())
    for n, t in tree.items():
        total = total.to(squares[n].device) + squares[n]
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
