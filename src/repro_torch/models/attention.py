"""Attention for the model path, routed to the flash-attention kernel.

Counterpart: ``repro/models/attention.py:attention``.  Shapes: q
(B, Sq, Hq, D), k/v (B, Skv, Hkv, D) with Hq = Hkv * G (GQA).

Positions: the reference passes position vectors ``q_pos``/``k_pos`` and
marks unwritten cache slots with ``k_pos = -1``.  Queries here are always
consecutive, so ``q_pos`` is one int, ``q_offset``, the position of the
first query.  Keys: in a full causal cache a slot equals its position and
the written slots are a prefix, so ``kv_len`` (the number of written slots)
says everything and the kernel masks every slot at or beyond it, exactly
where the reference's ``k_pos`` is -1.  A rolling (sliding-window) cache
breaks both, and passes the reference's ``k_pos`` itself.

On a mesh (DTensor q, k, v) the kernel runs on each rank's local shard
(``local_map``): the batch split as q's, the heads over ``model`` in ``tp``
mode where the KV heads divide it (each rank's query heads are then the
groups of its KV heads), else whole.  With the sequence over ``model``
(``fsdp`` mode) each rank keeps its queries, K and V are gathered before
the call, and the queries sit at ``q_offset`` plus the rank's first
position; K's and V's gradients from such a call are partial sums.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import local_call, shard_index


def attention(q, k, v, *, q_offset: int = 0, kv_len: Optional[int] = None,
              k_pos: Optional[torch.Tensor] = None, causal: bool = True,
              window: int = 0, chunk: int = 0, softcap: float = 0.0):
    """Softmax attention over the first ``kv_len`` key slots (default: all),
    slot j at position j or ``k_pos[j]``."""
    if softcap:
        raise NotImplementedError(
            "attention logit softcap is not ported yet (a later slice of the "
            "port; see ROADMAP.md)")
    if isinstance(q, DTensor):
        return _on_mesh(q, k, v, q_offset=q_offset, kv_len=kv_len,
                        k_pos=k_pos, causal=causal, window=window,
                        chunk=chunk)
    return flash_attention(q, k, v, causal=causal, window=window, chunk=chunk,
                           q_offset=q_offset, kv_len=kv_len, k_pos=k_pos)


def _on_mesh(q, k, v, *, q_offset, kv_len, k_pos, causal, window, chunk):
    mesh = q.device_mesh
    qp, kp, gp = [], [], []
    for m, (a, b) in enumerate(zip(q.placements, k.placements)):
        if a.is_shard(0):                         # the batch
            qp.append(a), kp.append(a), gp.append(a)
        elif a.is_shard(2) and b.is_shard(2):     # the heads, KV ones too
            qp.append(a), kp.append(b), gp.append(b)
        elif a.is_shard(1) and q.shape[1] > 1:    # the queries' positions
            qp.append(a), kp.append(Replicate()), gp.append(Partial())
        else:
            qp.append(Replicate()), kp.append(Replicate())
            gp.append(Replicate())
    qp, kp, gp = tuple(qp), tuple(kp), tuple(gp)
    first, parts = shard_index(mesh, qp, 1)
    offset = q_offset + first * (q.shape[1] // parts)

    def run(q, k, v, k_pos):
        return flash_attention(q, k, v, causal=causal, window=window,
                               chunk=chunk, q_offset=offset, kv_len=kv_len,
                               k_pos=k_pos)
    rep = (Replicate(),) * mesh.ndim
    return local_call(run, qp, (q, k, v, k_pos),
                      (qp, kp, kp, None if k_pos is None else rep),
                      (qp, gp, gp, None if k_pos is None else rep))
