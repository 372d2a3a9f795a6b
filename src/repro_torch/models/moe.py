"""Mixture-of-Experts FFN: top-k routing with a capacity bound, dispatched
compactly.

Counterpart: ``repro/models/moe.py`` (``moe_init``, ``moe_apply`` in both
``moe_impl`` forms, ``_aux_loss``, ``moe_ref``).  On one device the
reference's group count is 1, and its ``a2a`` and ``global`` forms keep the
same picks and give one result, so the port runs one path for both.  The
semantics are the reference's:

- the router (d, E) is fp32 in every model: ``softmax(x.float() @
  router)``, top-k, the gates renormalised by ``max(sum, 1e-9)``;
- the capacity is ``ceil(capacity_factor * N * K / E)`` for the N = B x S
  tokens of the call;
- the (token, k) picks are flattened token-major and sorted by expert,
  stably; a pick is kept when its rank within its expert is below the
  capacity, and a dropped pick adds nothing (the residual carries the
  token);
- each expert computes ``silu(x @ w_gate[e]) * (x @ w_up[e]) @ w_down[e]``
  in the param dtype; the gates are cast to x's dtype before the product,
  and a token's K contributions are summed over K in a fixed order (no
  atomics: two calls give the same bits);
- a shared SwiGLU expert (``shared``) is added where ``n_shared_experts``;
- the Switch load-balance loss comes back beside the output.

The dispatch is compact: the kept picks' rows are gathered sorted by
expert, so each expert's rows form one contiguous range, and each expert
runs its three products on its range only.  The reference's (E, cap, d)
slot buffer (``moe_slots_ref``, its literal copy and the plain version)
computes the same, an empty slot contributing nothing; the compact form
holds at most N x K rows whatever the capacity, and reads only the weights
of experts that have rows.  The ranges need the per-expert counts on the
host: one synchronisation a call, counted in ``dispatch.host_syncs``, as
``dispatch.kept`` and ``dispatch.dropped`` count the picks (in the style of
the kernels' launch counters).  The reference computes all of this outside
any Pallas kernel, and so does the port (``torch.matmul``, ``F.silu``).
The experts' products run inside ``remat.batched_products``: the
reference's are batched over E, so a ``selective`` recompute redoes them.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init, param
from repro_torch.models.remat import batched_products


def expert(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """``silu(x @ w_gate) * (x @ w_up) @ w_down``, the weights cast to x's
    dtype (no copy in a model, whose weights are in that dtype already; an
    fp32 pass over bf16 weights casts one expert at a time)."""
    dt = x.dtype
    return (F.silu(x @ w_gate.to(dt)) * (x @ w_up.to(dt))) @ w_down.to(dt)


def route(x2: torch.Tensor, router: torch.Tensor, k: int):
    """(probs (N, E) fp32, gates (N, K) fp32, picks (N, K) int64) of the
    tokens x2 (N, d): softmax of the fp32 logits, top-k, the gates
    renormalised."""
    probs = torch.softmax(x2.float() @ router, dim=-1)
    gate, sel = torch.topk(probs, k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate, sel


def aux_loss(probs: torch.Tensor, sel: torch.Tensor, e: int) -> torch.Tensor:
    """Switch-style load-balance loss: E * sum(fraction of tokens whose
    first pick is each expert * mean router probability of it)."""
    frac_tokens = F.one_hot(sel[:, 0], e).float().mean(0)
    return e * (frac_tokens * probs.mean(0)).sum()


def dispatch(x2: torch.Tensor, gate: torch.Tensor, sel: torch.Tensor,
             w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
             cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed experts' output for the tokens x2 (N, d) and their picks
    ``sel`` (N, K) with gates (N, K), at capacity ``cap``.  Returns (y (N, d)
    in x2's dtype, the kept picks: flat indices token * K + k, sorted by
    expert and within an expert by index)."""
    n, k = sel.shape
    flat = sel.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=w_gate.shape[0])
    per_expert = counts.tolist()          # the call's one host sync
    dispatch.host_syncs += 1
    rows = [min(c, cap) for c in per_expert]
    n_kept = sum(rows)
    if n_kept < flat.numel():
        # rank within its expert; a stable sort on the drop flag puts the
        # kept picks first and keeps their order
        start = torch.cumsum(counts, 0) - counts
        rank = torch.arange(flat.numel(), device=flat.device) \
            - start[flat[order]]
        order = order[torch.argsort((rank >= cap).int(), stable=True)]
    picks = order[:n_kept]
    dispatch.kept += n_kept
    dispatch.dropped += flat.numel() - n_kept
    xs = x2[picks // k]
    out = torch.empty_like(xs)
    a = 0
    with batched_products():      # the reference's einsum over E
        for e, c in enumerate(rows):
            if c:
                out[a:a + c] = expert(xs[a:a + c], w_gate[e], w_up[e],
                                      w_down[e])
                a += c
    contrib = torch.zeros(flat.numel(), x2.shape[1], dtype=x2.dtype,
                          device=x2.device)
    contrib[picks] = out * gate.reshape(-1)[picks].to(x2.dtype)[:, None]
    return contrib.view(n, k, -1).sum(1), picks


dispatch.host_syncs = 0
dispatch.kept = 0
dispatch.dropped = 0


def _experts(e: int, d_in: int, d_out: int, dtype, device,
             generator) -> torch.Tensor:
    """(E, d_in, d_out) expert weights, normal with std 1/sqrt(d_in), drawn
    an expert at a time (llama4's 128 experts in fp32 at once would take
    21 GB beside the bf16 result)."""
    w = torch.empty(e, d_in, d_out, dtype=dtype, device=device)
    for i in range(e):
        w[i] = dense_init(d_in, d_out, dtype, device, generator)
    return w


class SharedExpert(nn.Module):
    """The shared SwiGLU expert, ``n_shared_experts * d_ff`` wide."""

    def __init__(self, d: int, f: int, dtype, device, generator):
        super().__init__()
        self.w_gate = param(dense_init(d, f, dtype, device, generator))
        self.w_up = param(dense_init(d, f, dtype, device, generator))
        self.w_down = param(dense_init(f, d, dtype, device, generator))

    def forward(self, x):
        return expert(x, self.w_gate, self.w_up, self.w_down)


class MoE(nn.Module):
    """The MoE FFN of a layer: ``router`` (d, E) fp32, ``w_gate``/``w_up``
    (E, d, f) and ``w_down`` (E, f, d) in the param dtype, and ``shared``.
    ``capacity_factor`` is read at every call (a check may raise it to
    E / K, where nothing is dropped)."""

    def __init__(self, cfg: ModelConfig, dtype, device, generator):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.n_experts, self.top_k = e, cfg.top_k
        self.capacity_factor = cfg.capacity_factor
        self.router = param(dense_init(d, e, torch.float32, device,
                                       generator))
        self.w_gate = param(_experts(e, d, f, dtype, device, generator))
        self.w_up = param(_experts(e, d, f, dtype, device, generator))
        self.w_down = param(_experts(e, f, d, dtype, device, generator))
        if cfg.n_shared_experts:
            self.shared = SharedExpert(d, cfg.n_shared_experts * f, dtype,
                                       device, generator)

    def capacity(self, n: int) -> int:
        """Slots per expert for a call of n tokens (the reference's
        expression, in its order)."""
        return int(math.ceil(self.capacity_factor * n * self.top_k
                             / self.n_experts))

    def route(self, x2: torch.Tensor):
        return route(x2, self.router, self.top_k)

    def forward(self, x: torch.Tensor):
        """x (B, S, d) -> (y (B, S, d), aux loss (fp32 scalar))."""
        B, S, D = x.shape
        x2 = x.reshape(B * S, D)
        probs, gate, sel = self.route(x2)
        y, _ = dispatch(x2, gate, sel, self.w_gate, self.w_up, self.w_down,
                        self.capacity(B * S))
        if hasattr(self, "shared"):
            y = y + self.shared(x2)
        return y.view(B, S, D), aux_loss(probs, sel, self.n_experts)


def moe_slots_ref(moe: MoE, x: torch.Tensor):
    """The plain version: the reference's ``_moe_apply_a2a`` at one group,
    step for step.  The picks, sorted by expert, are scattered into an
    (E * cap + 1, d) slot buffer whose last row bins the dropped ones; every
    expert runs its products over all its cap slots; the rows are gathered
    back and added onto their tokens (``index_add_``: on CUDA in atomic
    order, so only within rounding of the port's fixed order).  Returns
    (y (B, S, d), aux loss, the kept picks as ``dispatch`` orders them)."""
    B, S, D = x.shape
    E, K = moe.n_experts, moe.top_k
    N, M = B * S, B * S * moe.top_k
    cap = moe.capacity(N)
    xt = x.reshape(N, D)
    probs, gate, sel = moe.route(xt)
    flat_e = sel.reshape(M)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    idx = torch.arange(M, device=x.device)
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=x.device),
                          sorted_e[1:] != sorted_e[:-1]])
    seg_start = torch.cummax(torch.where(is_start, idx, 0), 0).values
    pos = idx - seg_start                                 # rank in expert
    keep = pos < cap
    slot = torch.where(keep, sorted_e * cap + pos, E * cap)
    token = order // K
    upd = torch.where(keep[:, None], xt[token], 0).to(x.dtype)
    buf = torch.zeros(E * cap + 1, D, dtype=x.dtype, device=x.device)
    buf = buf.index_add_(0, slot, upd)[:-1].view(E, cap, D)
    h = F.silu(torch.bmm(buf, moe.w_gate)) * torch.bmm(buf, moe.w_up)
    rows = torch.bmm(h, moe.w_down).reshape(E * cap, D)
    vals = rows[slot.clamp(0, E * cap - 1)]
    gate_sorted = gate.reshape(M)[order]
    contrib = torch.where(keep[:, None], vals, 0) \
        * gate_sorted[:, None].to(x.dtype)
    y = torch.zeros(N, D, dtype=x.dtype, device=x.device)
    y = y.index_add_(0, token, contrib)
    if hasattr(moe, "shared"):
        y = y + moe.shared(xt)
    return y.view(B, S, D), aux_loss(probs, sel, E), order[keep]
