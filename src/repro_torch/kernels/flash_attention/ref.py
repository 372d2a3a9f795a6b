"""Plain PyTorch attention: the CPU path and the oracle of the CUDA kernels
(counterpart: ``repro/kernels/flash_attention/ref.py``, in model layout and
with the kernels' ``kv_len``), with each row's log-sum-exp on request; the
oracle of the backward kernel (``attention_bwd_ref``); and, for the tests only, the decode kernels'
tile skipping and their arithmetic in plain PyTorch: the split kernel's
split-then-merge and the warp kernel's per-warp online softmax, merged in
the block, then over the splits."""
from __future__ import annotations

import math
from typing import List, Optional

import torch

NEG_INF = -2.0 ** 30
KV_TILE = 64


def _mask(Sq, Skv, device, *, causal, window, chunk, q_offset, kv_len,
          k_pos):
    """(Sq, Skv) bool: which key slots each query may see."""
    q_pos = q_offset + torch.arange(Sq, device=device)[:, None]
    slot = torch.arange(Skv, device=device)
    k_pos = (slot if k_pos is None else k_pos.long())[None, :]
    mask = (slot[None, :] < kv_len) & (k_pos >= 0)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window:
        mask = mask & (k_pos > q_pos - window)
    if chunk:
        mask = mask & (k_pos // chunk == q_pos // chunk)
    return mask


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  chunk: int = 0, q_offset: int = 0,
                  kv_len: Optional[int] = None,
                  k_pos: Optional[torch.Tensor] = None,
                  return_lse: bool = False):
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D).

    Query i sits at position ``q_offset + i``, key slot j at position j or
    ``k_pos[j]``; slots ``j >= kv_len`` and keys at negative positions are
    masked.  Scores, softmax and the product with V are fp32; the result is
    cast to q's dtype.  With ``return_lse``: (out, lse (B, Hq, Sq) fp32,
    the log-sum-exp of each row's scaled, masked scores).
    """
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    kv_len = Skv if kv_len is None else kv_len
    G = Hq // Hkv
    qf = q.float().transpose(1, 2)                                # B,Hq,Sq,D
    kf = k.float().transpose(1, 2).repeat_interleave(G, dim=1)    # B,Hq,Skv,D
    vf = v.float().transpose(1, 2).repeat_interleave(G, dim=1)
    # in place: llama4's 2 x 8200 prefill has 20 GiB of fp32 scores
    s = torch.matmul(qf, kf.transpose(-1, -2)).div_(math.sqrt(D))
    mask = _mask(Sq, Skv, q.device, causal=causal, window=window,
                 chunk=chunk, q_offset=q_offset, kv_len=kv_len, k_pos=k_pos)
    s.masked_fill_(~mask, NEG_INF)
    lse = torch.logsumexp(s, dim=-1) if return_lse else None
    out = torch.matmul(torch.softmax(s, dim=-1), vf)
    out = out.transpose(1, 2).to(q.dtype)
    return (out, lse) if return_lse else out


def attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                      window: int = 0, chunk: int = 0, o_lo=None):
    """(dq, dk, dv) of the attention the training path runs (queries from
    position 0, every key slot written; causal, window and chunk masks as
    :func:`attention_ref`'s), by the explicit formulas the
    backward kernel computes, in fp32: P = exp(scale * q.k - lse) over the
    visible keys (0 elsewhere), delta = rowsum(dO * O) over the O the
    forward returned (rounded to its dtype; plus ``o_lo``, that rounding's
    residual, where the forward wrote one), dV = P^T dO, dS = P (dO V^T -
    delta), dQ = scale * dS K, dK = scale * dS^T Q, dK and dV summed over
    the G query heads of a kv head.  q, o, do (B, Sq, Hq, D); k, v (B, Skv,
    Hkv, D); lse (B, Hq, Sq) fp32.  Outputs in the inputs' dtype."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qf, of, dof = (t.float().transpose(1, 2) for t in (q, o, do))  # B,Hq,Sq,D
    kf = k.float().transpose(1, 2).repeat_interleave(G, dim=1)     # B,Hq,Skv,D
    vf = v.float().transpose(1, 2).repeat_interleave(G, dim=1)
    mask = _mask(Sq, Skv, q.device, causal=causal, window=window,
                 chunk=chunk, q_offset=0, kv_len=Skv, k_pos=None)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    if o_lo is not None:
        of = of + o_lo.float().transpose(1, 2)
    delta = (dof * of).sum(-1)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    dq = torch.matmul(ds, kf) * scale
    dk = (torch.matmul(ds.transpose(-1, -2), qf) * scale).view(
        B, Hkv, G, Skv, D).sum(2)
    dv = torch.matmul(p.transpose(-1, -2), dof).view(B, Hkv, G, Skv, D).sum(2)
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def decode_tiles(t0: int, t1: int, *, Sq: int, q_offset: int, kv_len: int,
                 causal: bool = True, window: int = 0, chunk: int = 0,
                 k_pos: Optional[torch.Tensor] = None) -> List[int]:
    """The 64-key tiles of [t0, t1) (below kv_len) whose K/V the split
    decode kernel reads: the rule of ``visible`` in csrc/flash_decode.cu.
    Without ``k_pos`` a tile is read if it meets the slots the causal,
    window and chunk bounds of the queries allow; with ``k_pos`` if one of
    its positions is >= 0 and within those bounds."""
    q_first, q_last = q_offset, q_offset + Sq - 1
    t1 = min(t1, -(-kv_len // KV_TILE))
    out = []
    for t in range(t0, t1):
        s0 = t * KV_TILE
        if k_pos is None:
            lo, hi = 0, kv_len
            if causal:
                hi = min(hi, q_last + 1)
            if window:
                lo = max(lo, q_first - window + 1)
            if chunk:
                lo = max(lo, q_first // chunk * chunk)
                hi = min(hi, (q_last // chunk + 1) * chunk)
            seen = s0 < hi and s0 + KV_TILE > lo
        else:
            kp = k_pos[s0:min(s0 + KV_TILE, kv_len)].long()
            ok = kp >= 0
            if causal:
                ok &= kp <= q_last
            if window:
                ok &= kp > q_first - window
            if chunk:
                ok &= (kp // chunk >= q_first // chunk) & (
                    kp // chunk <= q_last // chunk)
            seen = bool(ok.any())
        if seen:
            out.append(t)
    return out


def _merge(ms, ls, accs):
    """The log-sum-exp merge of partials (m, l, acc) in list order: weights
    exp(m_i - max m), returns (max m, sum l w, sum acc w)."""
    m = torch.stack(ms)
    w = torch.exp(m - m.max(0).values)
    return (m.max(0).values, (torch.stack(ls) * w).sum(0),
            (torch.stack(accs) * w[..., None]).sum(0))


def split_decode_ref(q, k, v, *, splits: int, tiles_per_split: int,
                     causal: bool = True, window: int = 0, chunk: int = 0,
                     q_offset: int = 0, kv_len: Optional[int] = None,
                     k_pos: Optional[torch.Tensor] = None):
    """What the split decode kernel computes, in plain fp32 PyTorch: each
    split's partial (m, l, acc) over the tiles it reads (``decode_tiles``),
    with the reference's -2^30 masking, then the merge in split order with
    the log-sum-exp rule: acc_s, l_s weighted by exp(m_s - max m), output
    sum acc / max(sum l, 1e-30) in q's dtype."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    kv_len = Skv if kv_len is None else kv_len
    G = Hq // Hkv
    qf = q.float().transpose(1, 2)                                # B,Hq,Sq,D
    kf = k.float().transpose(1, 2).repeat_interleave(G, dim=1)    # B,Hq,Skv,D
    vf = v.float().transpose(1, 2).repeat_interleave(G, dim=1)
    mask = _mask(Sq, Skv, q.device, causal=causal, window=window,
                 chunk=chunk, q_offset=q_offset, kv_len=kv_len, k_pos=k_pos)
    ms, ls, accs = [], [], []
    for s in range(splits):
        tiles = decode_tiles(s * tiles_per_split, (s + 1) * tiles_per_split,
                             Sq=Sq, q_offset=q_offset, kv_len=kv_len,
                             causal=causal, window=window, chunk=chunk,
                             k_pos=k_pos)
        if not tiles:                       # a split that read nothing
            ms.append(torch.full((B, Hq, Sq), NEG_INF, device=q.device))
            ls.append(torch.zeros(B, Hq, Sq, device=q.device))
            accs.append(torch.zeros(B, Hq, Sq, D, device=q.device))
            continue
        slots = torch.cat([torch.arange(t * KV_TILE,
                                        min((t + 1) * KV_TILE, kv_len))
                           for t in tiles])
        sc = torch.matmul(qf, kf[:, :, slots].transpose(-1, -2)) / math.sqrt(D)
        sc = torch.where(mask[:, slots], sc, torch.full_like(sc, NEG_INF))
        m = sc.max(-1).values
        p = torch.exp(sc - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.matmul(p, vf[:, :, slots]))
    _, l_sum, acc = _merge(ms, ls, accs)
    out = acc / torch.clamp(l_sum, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def warp_decode_ref(q, k, v, *, splits: int, tiles_per_split: int,
                    warps: int, step: int, causal: bool = True,
                    window: int = 0, chunk: int = 0, q_offset: int = 0,
                    kv_len: Optional[int] = None,
                    k_pos: Optional[torch.Tensor] = None):
    """What the warp decode kernel computes, in plain fp32 PyTorch.  In each
    tile a split reads (``decode_tiles``), warp w takes the keys [w * kw,
    (w + 1) * kw) (kw = 64 / warps) below kv_len, ``step`` at a time, and
    keeps its own online softmax per row: m from -2^30, l and acc from 0;
    each step m' = max(m, the step's scores), both rescaled by exp(m - m'),
    plus p = exp(s - m'), a masked score being -2^30.  The block merges its
    warps in warp order with the log-sum-exp rule, then the splits are
    merged in split order the same way; output acc / max(l, 1e-30) in q's
    dtype (one split: the block's own result)."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    kv_len = Skv if kv_len is None else kv_len
    G = Hq // Hkv
    qf = q.float().transpose(1, 2)                                # B,Hq,Sq,D
    kf = k.float().transpose(1, 2).repeat_interleave(G, dim=1)    # B,Hq,Skv,D
    vf = v.float().transpose(1, 2).repeat_interleave(G, dim=1)
    mask = _mask(Sq, Skv, q.device, causal=causal, window=window,
                 chunk=chunk, q_offset=q_offset, kv_len=kv_len, k_pos=k_pos)
    kw = KV_TILE // warps
    scale = 1.0 / math.sqrt(D)
    blocks = []                                 # each split's (m, l, acc)
    for s in range(splits):
        tiles = decode_tiles(s * tiles_per_split, (s + 1) * tiles_per_split,
                             Sq=Sq, q_offset=q_offset, kv_len=kv_len,
                             causal=causal, window=window, chunk=chunk,
                             k_pos=k_pos)
        per_warp = []
        for w in range(warps):
            m = torch.full((B, Hq, Sq), NEG_INF, device=q.device)
            l = torch.zeros(B, Hq, Sq, device=q.device)
            acc = torch.zeros(B, Hq, Sq, D, device=q.device)
            for t in tiles:
                first = t * KV_TILE + w * kw
                for j in range(0, kw, step):
                    end = min(first + j + step, first + kw, kv_len)
                    if end <= first + j:
                        continue
                    slots = torch.arange(first + j, end)
                    sc = torch.matmul(qf, kf[:, :, slots].transpose(-1, -2))
                    sc = torch.where(mask[:, slots], sc * scale,
                                     torch.full_like(sc, NEG_INF))
                    m_new = torch.maximum(m, sc.max(-1).values)
                    corr = torch.exp(m - m_new)
                    p = torch.exp(sc - m_new[..., None])
                    l = l * corr + p.sum(-1)
                    acc = acc * corr[..., None] + torch.matmul(
                        p, vf[:, :, slots])
                    m = m_new
            per_warp.append((m, l, acc))
        blocks.append(_merge(*zip(*per_warp)))
    _, l_sum, acc = _merge(*zip(*blocks))
    out = acc / torch.clamp(l_sum, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)
