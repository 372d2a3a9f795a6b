"""Plain PyTorch attention: the CPU path and the oracle of the CUDA kernel
(counterpart: ``repro/kernels/flash_attention/ref.py``, in model layout and
with the kernel's ``kv_len``)."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -2.0 ** 30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  chunk: int = 0, q_offset: int = 0,
                  kv_len: Optional[int] = None,
                  k_pos: Optional[torch.Tensor] = None):
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D).

    Query i sits at position ``q_offset + i``, key slot j at position j or
    ``k_pos[j]``; slots ``j >= kv_len`` and keys at negative positions are
    masked.  Scores, softmax and the product with V are fp32; the result is
    cast to q's dtype.
    """
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    kv_len = Skv if kv_len is None else kv_len
    G = Hq // Hkv
    qf = q.float().transpose(1, 2)                                # B,Hq,Sq,D
    kf = k.float().transpose(1, 2).repeat_interleave(G, dim=1)    # B,Hq,Skv,D
    vf = v.float().transpose(1, 2).repeat_interleave(G, dim=1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) / math.sqrt(D)
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    slot = torch.arange(Skv, device=q.device)
    k_pos = (slot if k_pos is None else k_pos.long())[None, :]
    mask = (slot[None, :] < kv_len) & (k_pos >= 0)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window:
        mask = mask & (k_pos > q_pos - window)
    if chunk:
        mask = mask & (k_pos // chunk == q_pos // chunk)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    out = torch.matmul(torch.softmax(s, dim=-1), vf)
    return out.transpose(1, 2).to(q.dtype)
