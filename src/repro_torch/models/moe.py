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
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (_axis_size, dense_init, gathered,
                                       local_call, param, pspec, reshape,
                                       shard)
from repro_torch.models.remat import batched_products


def expert(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """``silu(x @ w_gate) * (x @ w_up) @ w_down``, the weights cast to x's
    dtype (no copy in a model, whose weights are in that dtype already; an
    fp32 pass over bf16 weights casts one expert at a time)."""
    dt = x.dtype
    return (F.silu(x @ gathered(w_gate).to(dt))
            * (x @ gathered(w_up).to(dt))) @ gathered(w_down).to(dt)


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


def moe_param_specs(cfg) -> Dict:
    """The reference's ``moe_param_specs``: experts over ``model``, FSDP
    over the batch axes."""
    fsdp = ("pod", "data")
    specs = {
        "router": pspec(None, "model"),
        "w_gate": pspec("model", fsdp, None),
        "w_up": pspec("model", fsdp, None),
        "w_down": pspec("model", None, fsdp),
    }
    if cfg.n_shared_experts:
        specs["shared"] = {
            "w_gate": pspec(fsdp, "model"),
            "w_up": pspec(fsdp, "model"),
            "w_down": pspec("model", fsdp),
        }
    return specs


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
        """x (B, S, d) -> (y (B, S, d), aux loss (fp32 scalar)); on a mesh
        ``moe_on_mesh``."""
        if isinstance(x, DTensor):
            return moe_on_mesh(self, x)
        B, S, D = x.shape
        x2 = x.reshape(B * S, D)
        probs, gate, sel = self.route(x2)
        y, _ = dispatch(x2, gate, sel, self.w_gate, self.w_up, self.w_down,
                        self.capacity(B * S))
        if hasattr(self, "shared"):
            y = y + self.shared(x2)
        return y.view(B, S, D), aux_loss(probs, sel, self.n_experts)


def _slots(xt: torch.Tensor, gate: torch.Tensor, sel: torch.Tensor, e: int,
           cap: int):
    """One group's slot buffer, the reference's ``_moe_apply_a2a`` for a
    group: the picks of the tokens xt (n, d), sorted by expert, scattered
    into (E * cap + 1, d) slots whose last row bins the dropped ones.
    Returns (buf (E, cap, d), slot, keep, token, gate_sorted: (n K,) each,
    in sorted order, and ``order``, the sort)."""
    m = sel.numel()
    flat_e = sel.reshape(m)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    idx = torch.arange(m, device=xt.device)
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=xt.device),
                          sorted_e[1:] != sorted_e[:-1]])
    seg_start = torch.cummax(torch.where(is_start, idx, 0), 0).values
    pos = idx - seg_start                                 # rank in expert
    keep = pos < cap
    slot = torch.where(keep, sorted_e * cap + pos, e * cap)
    token = order // sel.shape[1]
    upd = torch.where(keep[:, None], xt[token], 0).to(xt.dtype)
    buf = torch.zeros(e * cap + 1, xt.shape[1], dtype=xt.dtype,
                      device=xt.device)
    buf = buf.index_add_(0, slot, upd)[:-1].view(e, cap, xt.shape[1])
    return buf, slot, keep, token, gate.reshape(m)[order], order


def _combine(rows: torch.Tensor, slot, keep, token, gate_sorted,
             n: int) -> torch.Tensor:
    """The experts' rows (E * cap, d) gathered back by slot, gated and
    added onto their tokens: (n, d)."""
    vals = rows[slot.clamp(0, rows.shape[0] - 1)]
    contrib = torch.where(keep[:, None], vals, 0) \
        * gate_sorted[:, None].to(rows.dtype)
    y = torch.zeros(n, rows.shape[1], dtype=rows.dtype, device=rows.device)
    return y.index_add_(0, token, contrib)


def moe_slots_ref(moe: MoE, x: torch.Tensor):
    """The plain version: the reference's ``_moe_apply_a2a`` at one group,
    step for step.  The picks, sorted by expert, are scattered into an
    (E * cap + 1, d) slot buffer whose last row bins the dropped ones; every
    expert runs its products over all its cap slots; the rows are gathered
    back and added onto their tokens (``index_add_``: on CUDA in atomic
    order, so only within rounding of the port's fixed order).  Returns
    (y (B, S, d), aux loss, the kept picks as ``dispatch`` orders them)."""
    B, S, D = x.shape
    E = moe.n_experts
    N = B * S
    cap = moe.capacity(N)
    xt = x.reshape(N, D)
    probs, gate, sel = moe.route(xt)
    buf, slot, keep, token, gate_sorted, order = _slots(xt, gate, sel, E,
                                                        cap)
    h = F.silu(torch.bmm(buf, moe.w_gate)) * torch.bmm(buf, moe.w_up)
    rows = torch.bmm(h, moe.w_down).reshape(E * cap, D)
    y = _combine(rows, slot, keep, token, gate_sorted, N)
    if hasattr(moe, "shared"):
        y = y + moe.shared(xt)
    return y.view(B, S, D), aux_loss(probs, sel, E), order[keep]


class MeshRoute(NamedTuple):
    """The routing half of ``moe_on_mesh``: G groups of ``nl`` tokens at
    ``cap`` slots an expert; DTensors split by group over the batch axes
    (``grp``): the slot buffers (G, E, cap, d), and per group in the
    sorted order of its nl K picks: ``slot``, ``keep``, ``token``, the
    gates ``gs`` and ``order`` (the sort: pick ``order[g, i]`` is token
    ``// K``, choice ``% K`` of group g); and per group ``n_first`` and
    ``p_sum`` (G, E), its tokens' first picks of each expert and their
    probabilities' sums."""
    G: int
    nl: int
    cap: int
    grp: tuple
    buf: DTensor
    slot: DTensor
    keep: DTensor
    token: DTensor
    gs: DTensor
    order: DTensor
    n_first: DTensor
    p_sum: DTensor


def route_on_mesh(moe: MoE, x: DTensor) -> MeshRoute:
    """The reference's ``_moe_apply_a2a`` up to its all-to-all: the tokens
    form G groups, G the product of the batch axes (1 where it does not
    divide the tokens), each routed on its own ranks at the group's
    capacity ``ceil(capacity_factor * N/G * K / E)`` into an (E, cap, d)
    slot buffer."""
    B, S, D = x.shape
    E, K = moe.n_experts, moe.top_k
    N = B * S
    G = max(_axis_size("pod") * _axis_size("data"), 1)
    if N % G:
        G = 1
    nl = N // G
    cap = int(math.ceil(moe.capacity_factor * nl * K / E))
    xt = shard(reshape(x, G, nl, D), ("pod", "data"), None, None)
    mesh = xt.device_mesh
    grp = tuple(p if p.is_shard(0) else Replicate() for p in xt.placements)
    rep = (Replicate(),) * mesh.ndim
    part = tuple(Partial() if p.is_shard(0) else Replicate() for p in grp)

    def route_groups(xt, router):
        bufs, rest = [], []
        for g in range(xt.shape[0]):
            probs, gate, sel = route(xt[g], router, K)
            buf, slot, keep, token, gs, order = _slots(xt[g], gate, sel, E,
                                                       cap)
            first = F.one_hot(sel[:, 0], E).float()
            bufs.append(buf)
            rest.append((slot, keep, token, gs, order, first.sum(0),
                         probs.sum(0)))
        return (torch.stack(bufs),) + tuple(torch.stack(r) for r in
                                            zip(*rest))
    out = local_call(route_groups, (grp,) * 8,
                     (xt, moe.router), (grp, rep), (grp, part))
    return MeshRoute(G, nl, cap, grp, *out)


def moe_on_mesh(moe: MoE, x: DTensor):
    """The MoE FFN on a mesh: the reference's ``_moe_apply_a2a``.  After
    ``route_on_mesh`` the slot buffers are resharded group -> expert (the
    experts over ``model``), each rank runs its experts' products, and the
    rows go back expert -> group to be combined.  Static shapes throughout
    (no host sync), so the picks are the reference's on every mesh."""
    B, S, D = x.shape
    E = moe.n_experts
    N = B * S
    r = route_on_mesh(moe, x)
    nl, cap, grp = r.nl, r.cap, r.grp
    buf, slot, keep, token, gs = r.buf, r.slot, r.keep, r.token, r.gs
    # group -> expert reshard: the all-to-all (each rank its E-slice)
    buf = shard(buf, ("pod", "data"), "model", None, None)
    ep = tuple(buf.placements)
    wpl = tuple(Shard(0) if p.is_shard(1) else Replicate() for p in ep)
    wgrad = tuple(Shard(0) if p.is_shard(1) else
                  Partial() if p.is_shard(0) else Replicate() for p in ep)
    def gate_up(buf, wg, wu):
        with batched_products():
            return F.silu(torch.einsum("gecd,edf->gecf", buf, wg)) \
                * torch.einsum("gecd,edf->gecf", buf, wu)
    h = local_call(gate_up, ep, (buf, moe.w_gate, moe.w_up),
                   (ep, wpl, wpl), (ep, wgrad, wgrad))
    h = shard(h, ("pod", "data"), "model", None, None)

    def down(h, wd):
        with batched_products():
            return torch.einsum("gecf,efd->gecd", h, wd)
    out = local_call(down, tuple(h.placements), (h, moe.w_down),
                     (tuple(h.placements), wpl), (tuple(h.placements), wgrad))
    # expert -> group reshard back (the return all-to-all)
    out = shard(out, ("pod", "data"), None, None, None)

    def combine(out, slot, keep, token, gs):
        return torch.stack([
            _combine(out[g].reshape(E * cap, D), slot[g], keep[g], token[g],
                     gs[g], nl) for g in range(out.shape[0])])
    y = reshape(local_call(combine, grp, (out, slot, keep, token, gs),
                           (grp,) * 5, (grp,) * 5), B, S, D)
    if hasattr(moe, "shared"):
        y = y + reshape(moe.shared(reshape(x, N, D)), B, S, D)
    aux = E * ((r.n_first.sum(0) / N) * (r.p_sum.sum(0) / N)).sum()
    return y, aux
