"""Mamba-1 selective-SSM block (falcon-mamba-7b).

Counterpart: ``repro/models/mamba.py`` (``mamba_init``, ``_causal_conv``,
``mamba_mix``): in-projection to (x, z), causal depthwise conv, input-
dependent (dt, B, C), ZOH discretisation ``da = exp(dt * A)``, diagonal
state scan, gated output.  A multi-token call (prefill) runs the scan
through the selective-scan kernel (``kernels/mamba_scan``), which also
returns the final state; a one-token call (decode) is the reference's
elementwise step on the cached state, in plain torch ops.  Training runs
autograd through the scan's backward kernel and ``DiscretiseBx``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.mamba_scan.ops import mamba_scan
from repro_torch.models.common import (BATCH, HEADS, SEQ, channelwise,
                                       dense_init, gathered, param, pspec,
                                       shard)

Cache = Dict[str, torch.Tensor]


def mamba_param_specs(cfg) -> Dict:
    """The reference's ``mamba_param_specs``: the inner channels over
    ``model``."""
    fsdp = ("pod", "data")
    return {
        "in_proj": pspec(fsdp, "model"),
        "conv_w": pspec(None, "model"),
        "conv_b": pspec("model"),
        "x_proj": pspec("model", None),
        "dt_proj": pspec(None, "model"),
        "dt_bias": pspec("model"),
        "a_log": pspec("model", None),
        "d_skip": pspec("model"),
        "out_proj": pspec("model", fsdp),
    }


def _with_history(x: torch.Tensor, history: Optional[torch.Tensor],
                  K: int) -> torch.Tensor:
    """x (B, S, C) behind its K-1 steps of left context: ``history``
    (B, K-1, C) from a decode cache, or zeros."""
    if history is None:
        return F.pad(x, (0, 0, K - 1, 0))
    return torch.cat([history.to(x.dtype), x], 1)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                history: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv along time: x (B, S, C), w (K, C), b (C,).

    The K taps are summed in the reference's order and in x's dtype
    (``F.conv1d`` would sum in another order)."""
    K, S = w.shape[0], x.shape[1]
    xp = _with_history(x, history, K)
    out = xp[:, :S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    return out + b


def conv_history(x: torch.Tensor, history: Optional[torch.Tensor],
                 K: int) -> torch.Tensor:
    """The conv's left context for the next call: the last K-1 steps of the
    input behind its history, a tensor of its own."""
    return _with_history(x, history, K)[:, -(K - 1):].clone(
        memory_format=torch.contiguous_format)


class DiscretiseBx(torch.autograd.Function):
    """``dbx = dt (x) B * xc`` (B, S, Di, N) fp32, in the reference's order
    (``dt[..., None] * B[:, :, None, :]``, then times ``xc[..., None]``).
    Its backward recomputes from dt, B and xc (each (B, S, Di) or (B, S,
    N)): autograd of the eager expression would keep a clone of
    ``dt (x) B``, a fourth (B, S, Di, N) fp32 tensor a layer, for the
    in-place product's gradient."""

    @staticmethod
    def forward(ctx, dt, bmat, xc):
        ctx.save_for_backward(dt, bmat, xc)
        return (dt[..., None] * bmat[:, :, None, :].float()).mul_(
            xc[..., None].float())

    @staticmethod
    def backward(ctx, g):
        dt, bmat, xc = ctx.saved_tensors
        bf, xf = bmat.float(), xc.float()
        # sum_n g B, then the chain rule to dt and xc; sum_d g dt xc to B
        q = torch.einsum("bsdn,bsn->bsd", g, bf)
        d_b = torch.einsum("bsdn,bsd->bsn", g, dt * xf)
        return q * xf, d_b.to(bmat.dtype), (q * dt).to(xc.dtype)


class Mamba(nn.Module):
    """Params and init as the reference's ``mamba_init``: ``dt_bias`` is
    softplus^-1 of a log-uniform dt in [1e-3, 0.1], ``a_log = log(1..N)``;
    ``dt_bias``, ``a_log`` and ``d_skip`` stay fp32."""

    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        d, di, n, r, k = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                          cfg.dt_rank, cfg.ssm_conv)
        self.cfg = cfg
        self.in_proj = param(dense_init(d, 2 * di, dtype, device, generator))
        conv = torch.randn(k, di, device=device, generator=generator)
        self.conv_w = param((conv / math.sqrt(k)).to(dtype))
        self.conv_b = param(torch.zeros(di, dtype=dtype, device=device))
        self.x_proj = param(dense_init(di, r + 2 * n, dtype, device, generator))
        self.dt_proj = param(dense_init(r, di, dtype, device, generator))
        u = torch.rand(di, device=device, generator=generator)
        dt = torch.exp(u * (math.log(0.1) - math.log(0.001))
                       + math.log(0.001))
        self.dt_bias = param(dt + torch.log(-torch.expm1(-dt)))
        self.a_log = param(torch.log(torch.arange(
            1, n + 1, dtype=torch.float32, device=device)).repeat(di, 1))
        self.d_skip = param(torch.ones(di, device=device))
        self.out_proj = param(dense_init(di, d, dtype, device, generator))

    def forward(self, x: torch.Tensor, pos: int = 0,
                cache: Optional[Cache] = None) -> torch.Tensor:
        """x (B, S, d) -> (B, S, d).  A multi-token call starts at position
        0 from a zero state; a one-token call continues from ``cache`` (this
        layer's ``ssm``/``conv``).  Writes the new state into ``cache``."""
        cfg = self.cfg
        B, S, _ = x.shape
        n, r, K = cfg.ssm_state, cfg.dt_rank, cfg.ssm_conv
        if S > 1 and pos:
            raise ValueError("a multi-token call starts at position 0")
        state = hist = None
        if cache is not None and S == 1:
            state, hist = cache["ssm"], cache["conv"]
        xin, z = (x @ gathered(self.in_proj)).chunk(2, dim=-1)
        xin = shard(xin, BATCH, SEQ, HEADS)
        xc = F.silu(channelwise(causal_conv, xin, [
            (xin, True, -1), (self.conv_w, False, -1),
            (self.conv_b, False, -1), (hist, True, -1)], [(3, -1)]))
        dt, bmat, cmat = torch.split(xc @ gathered(self.x_proj), [r, n, n], dim=-1)
        dt = F.softplus((dt @ gathered(self.dt_proj)).float() + self.dt_bias)  # B,S,Di
        a = -torch.exp(self.a_log)                                    # Di,N
        # (B, S, Di, N) fp32 coefficients, in place: 4.3 GB each at 8 x 1024
        # tokens of falcon-mamba-7b (autograd keeps both: da for exp_ and
        # the scan, dbx for the scan)
        da = (dt[..., None] * a).exp_()
        dbx = channelwise(DiscretiseBx.apply, xc, [
            (dt, True, -1), (bmat, True, None), (xc, True, -1)], [(4, 2)])
        if S == 1:
            h0 = torch.zeros_like(da[:, 0]) if state is None else state
            h_last = da[:, 0] * h0 + dbx[:, 0]
            y = (h_last * cmat[:, 0, None, :].float()).sum(-1)[:, None]
        else:
            y, h_last = channelwise(mamba_scan, xc, [
                (da, True, 2), (dbx, True, 2),
                (cmat.float().contiguous(), True, None)], [(3, -1), (3, 1)])
        del da, dbx
        y = (y + self.d_skip * xc.float()).to(x.dtype) * F.silu(z)
        if cache is not None:
            cache["ssm"] = h_last
            cache["conv"] = channelwise(
                lambda xin, hist: conv_history(xin, hist, K), xin,
                [(xin, True, -1), (hist, True, -1)], [(3, -1)]).to(
                    cache["conv"].dtype)
        return y @ gathered(self.out_proj)
