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
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention


def attention(q, k, v, *, q_offset: int = 0, kv_len: Optional[int] = None,
              k_pos: Optional[torch.Tensor] = None, causal: bool = True,
              window: int = 0, chunk: int = 0, softcap: float = 0.0):
    """Softmax attention over the first ``kv_len`` key slots (default: all),
    slot j at position j or ``k_pos[j]``."""
    if softcap:
        raise NotImplementedError(
            "attention logit softcap is not ported yet (a later slice of the "
            "port; see ROADMAP.md)")
    return flash_attention(q, k, v, causal=causal, window=window, chunk=chunk,
                           q_offset=q_offset, kv_len=kv_len, k_pos=k_pos)
