"""Activation recompute: the reference's ``_remat_wrap``
(``repro/models/transformer.py``), which wraps the scan body of each
segment, one repeat of the segment's layer pattern, in ``jax.checkpoint``.

- ``"full"``: ``torch.utils.checkpoint.checkpoint`` (non-reentrant, the
  RNG state preserved, recomputed shapes checked) around a group: only the
  group's inputs are kept, and the backward runs its forward again.
- ``"selective"``: the same, with a policy that keeps the results of the
  products without batch dimensions (``aten.mm``, ``aten.addmm``: what
  ``torch.matmul`` of a (B, S, d) activation by a (d, n) weight becomes)
  and recomputes everything else, as
  ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` does.
  Attention's products are batched, so the flash forward is recomputed.
- any other value: the function unchanged, as the reference's.

The MoE experts are the one place where the port computes as 2-D products
what the reference computes as a batched einsum (one ``mm`` per expert on
its compact range of rows, where the reference contracts an (E, cap, d)
slot buffer against (E, d, f) weights with E as the batch dimension).  The
policy follows the reference's program, not the port's layout: products run
inside ``batched_products()`` are recomputed, so ``selective`` keeps the
same tensors that the reference keeps.

Under ``torch.no_grad()`` (serving) nothing is wrapped: the reference's
``jax.checkpoint`` has no effect outside a gradient either.  The kernels'
autograd Functions save their tensors with ``save_for_backward``, so the
recompute hands their backward the recomputed tensors, and every forward
kernel of a wrapped group launches twice a training step.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

POLICIES = ("full", "selective")
_SAVEABLE = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_batched = 0     # > 0 inside batched_products()


@contextlib.contextmanager
def batched_products():
    """Inside: products that the reference computes with a batch dimension,
    which ``selective`` recomputes."""
    global _batched
    _batched += 1
    try:
        yield
    finally:
        _batched -= 1


def _policy(ctx, op, *args, **kwargs):
    if op in _SAVEABLE and not _batched:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(fn: Callable, policy: str) -> Callable:
    """``fn`` under the recompute ``policy`` while autograd records;
    ``fn`` itself for any other policy or under ``torch.no_grad()``."""
    if policy not in POLICIES:
        return fn
    kw = {} if policy == "full" else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _policy)}

    @functools.wraps(fn)
    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return wrapped
